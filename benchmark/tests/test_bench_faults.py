"""The timed path broken underneath a tiny run: ``correct`` comes out
false for each fault a cell can have. (Its one card has no exchange
between chips to leave out.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import cpu_run, tiny

SERVE = ["pointnet-track", "pointnet-offline", "dgcnn-offline"]


def _run(name):
    cell = tiny(name)
    return harness.is_correct(harness.driver(cell).run(cpu_run(cell)))


@pytest.mark.parametrize("name", SERVE)
def test_an_answer_altered_where_it_is_produced(name, monkeypatch):
    """0.01 rad added to every yaw where the answer is made: at decode, or
    with ICP at ICP's result (ICP may pull a decode error back)."""
    import alignnet3d_tpu_torch.api as api

    decode, icp = api.decode_pair_outputs, api.icp_p2point_batch

    def altered(*args, **kwargs):
        pose = decode(*args, **kwargs)
        return pose._replace(angles=pose.angles + 0.01)

    def altered_icp(*args, **kwargs):
        tf, *rest = icp(*args, **kwargs)
        c, s = np.cos(0.01), np.sin(0.01)
        rz = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0],
                       [0, 0, 0, 1]])
        return (rz @ np.asarray(tf), *rest)

    if tiny(name).traffic["refine_icp"]:
        monkeypatch.setattr(api, "icp_p2point_batch", altered_icp)
    else:
        monkeypatch.setattr(api, "decode_pair_outputs", altered)
    assert not _run(name)


@pytest.mark.parametrize("name", SERVE)
def test_half_of_the_batch_left_out(name, monkeypatch):
    import alignnet3d_tpu_torch.api as api

    build = api.build_inference_fn

    def halved(*args, **kwargs):
        forward = build(*args, **kwargs)

        def half(a, b):  # every other pair; each answer serves two
            out = forward(a[::2], b[::2])
            return {k: v.repeat_interleave(2, 0)[:len(a)]
                    for k, v in out.items()}
        return half

    monkeypatch.setattr(api, "build_inference_fn", halved)
    assert not _run(name)


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    step = torch.optim.Adam.step

    def unchanged(self, *args, **kwargs):
        before = [p.detach().clone() for g in self.param_groups
                  for p in g["params"]]
        out = step(self, *args, **kwargs)
        with torch.no_grad():
            for p, old in zip((p for g in self.param_groups
                               for p in g["params"]), before):
                p.copy_(old)
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", unchanged)
    assert not _run("dgcnn-train")


def test_half_of_the_training_batch_left_out(monkeypatch):
    from alignnet3d_tpu_torch.training.trainer import Trainer

    to_device = Trainer._to_device

    def halved(self, batch):
        return to_device(self, [np.asarray(a)[:len(a) // 2] for a in batch])

    monkeypatch.setattr(Trainer, "_to_device", halved)
    assert not _run("dgcnn-train")
