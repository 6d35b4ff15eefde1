"""The whole serving slice: the JAX package's ``Aligner.align`` against the
port's on the CPU, on ragged synthetic LiDAR clouds, in each mode."""

import numpy as np
import pytest

from torch_parity import SPEC, to_numpy_tree, torch_spec, trained_variables

from alignnet3d_tpu.api import Aligner as JaxAligner
from alignnet3d_tpu.data.synthetic import SyntheticBoxScene
from alignnet3d_tpu_torch.api import Aligner
from alignnet3d_tpu_torch.weights import from_flax

MODES = {
    # name: (align kwargs, transforms atol, why)
    "plain": ({}, 1e-4, "f32 forward, summation order only"),
    "resolve_flips": ({"resolve_flips": True}, 1e-4, "as plain"),
    "network_refine": ({"network_refine": True, "refine_gate": (180.0, 1e9)},
                       1e-4, "two forwards, as plain"),
    # 10 iterations carry the forward's 1e-5 gaps through the radius gate
    # and the closed-form update
    "refine_icp": ({"refine_icp": True, "icp_its": 10, "icp_radius": 2.0},
                   1e-3, "forward gaps carried through 10 ICP iterations"),
}


@pytest.fixture(scope="module")
def setup():
    _, variables = trained_variables()
    clouds = []
    seed = 0
    while len(clouds) < 6:  # low resolution keeps the ICP case fast
        scene = SyntheticBoxScene(seed, vres=16, hres=180)
        scene.generate_pointcloud()
        seed += 1
        if min(len(pc) for pc in scene.pointclouds) >= 5:
            clouds.append(scene.pointclouds)
    pcs1 = [c[0] for c in clouds]
    pcs2 = [c[1] for c in clouds]
    assert len({len(p) for p in pcs1 + pcs2}) > 1  # ragged
    return variables, from_flax(to_numpy_tree(variables)), pcs1, pcs2


@pytest.mark.parametrize("mode", list(MODES))
def test_align_matches_jax(setup, mode):
    variables, state, pcs1, pcs2 = setup
    kwargs, atol, _ = MODES[mode]
    # batch 4 over 6 pairs: one full batch and one padded one
    ref = JaxAligner(SPEC, variables, batch_size=4, seed=0).align(
        pcs1, pcs2, **kwargs)
    got = Aligner(torch_spec(SPEC), state, batch_size=4, seed=0,
                  device="cpu").align(pcs1, pcs2, **kwargs)
    assert got.keys() == ref.keys()
    np.testing.assert_allclose(got["transforms"], ref["transforms"], atol=atol)
    np.testing.assert_allclose(got["translations"], ref["translations"],
                               atol=atol)
    np.testing.assert_allclose(got["centers"], ref["centers"], atol=atol)
    dang = np.mod(got["angles"] - ref["angles"] + np.pi, 2 * np.pi) - np.pi
    assert np.max(np.abs(dang)) < atol


def test_resample_draws_like_the_jax_package(setup):
    variables, state, pcs1, _ = setup
    ja = JaxAligner(SPEC, variables, seed=3)
    ta = Aligner(torch_spec(SPEC), state, seed=3, device="cpu")
    for _ in range(2):  # the RNG advances in step across calls
        np.testing.assert_array_equal(ta._resample(pcs1), ja._resample(pcs1))
