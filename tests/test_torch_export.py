"""The port's ``torch.export`` artifacts (``alignnet3d_tpu_torch.export``)
against the JAX package's ``jax.export`` ones, on the CPU: one artifact
serves several batch sizes, loads from bytes in a process that never
imports the model code, moves between devices, and calls the three kernels
as ``torch.library`` custom ops that pass ``opcheck``."""

import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.export.passes import move_to_device_pass

from torch_parity import SPEC, to_numpy_tree, torch_spec, trained_variables

from alignnet3d_tpu.export import export_alignment_model as jax_export
from alignnet3d_tpu.export import load_exported as jax_load
from alignnet3d_tpu.models.alignnet import ModelSpec
from alignnet3d_tpu_torch import export as ex
from alignnet3d_tpu_torch.ops import edge_conv_kernels as ek
from alignnet3d_tpu_torch.ops import knn_kernels as kk
from alignnet3d_tpu_torch.ops import pointnet_kernels as pk
from alignnet3d_tpu_torch.serving import build_inference_fn
from alignnet3d_tpu_torch.weights import from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DGCNN_SPEC = ModelSpec(
    backbone="dgcnn", num_points=64, num_bins=8,
    s1_backbone=(16, 32, 32), s1_mlp=(32,),
    s2_backbone=(16, 32, 32), s2_mlp=(32,),
    embedding=(16, 32, 32), remaining_mlp=(32,),
)
# both packages in float32 on the CPU, held as tests/test_export.py holds
# the JAX artifact to the JAX forward
TOL = 1e-5
# bf16 against the JAX package's bf16 artifact: through three stacked
# stages a flipped bf16 rounding moves the centres by up to a few cm on
# these untrained nets (tests/test_serving.py and test_torch_serving.py
# allow 0.15 for the folded bf16 forward)
BF16_ATOL = 0.15


def _pairs(seed, b, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, 3)).astype(np.float32),
            rng.normal(size=(b, n, 3)).astype(np.float32))


@pytest.fixture(scope="module", params=["pointnet", "dgcnn"])
def model(request):
    spec = SPEC if request.param == "pointnet" else DGCNN_SPEC
    _, variables = trained_variables(spec)
    return spec, variables, from_flax(to_numpy_tree(variables))


@pytest.fixture(scope="module")
def artifacts(model):
    """(spec, f32 port artifact, JAX f32 artifact's loader, state)."""
    spec, variables, state = model
    blob = ex.export_alignment_model(torch_spec(spec), state,
                                     compute_dtype=torch.float32,
                                     device="cpu")
    jax_infer = jax_load(jax_export(spec, variables,
                                    compute_dtype=jnp.float32))
    return spec, blob, jax_infer, state


def test_one_artifact_serves_every_batch_like_the_jax_artifact(artifacts,
                                                              tmp_path):
    spec, blob, jax_infer, _ = artifacts
    path = str(tmp_path / "model.pt2")
    with open(path, "wb") as fh:
        fh.write(blob)
    infer = ex.load_exported(path, device="cpu")
    for batch in (3, 7):  # two batch sizes through ONE artifact
        a, b = _pairs(batch, batch, spec.num_points)
        got, ref = infer(a, b), jax_infer(a, b)
        assert tuple(got) == ex.OUTPUT_KEYS
        for key in ex.OUTPUT_KEYS:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                       rtol=TOL, atol=TOL, err_msg=key)


def test_export_writes_the_bytes_it_returns(tmp_path):
    _, variables = trained_variables(SPEC)
    path = str(tmp_path / "model.pt2")
    blob = ex.export_alignment_model(
        torch_spec(SPEC), from_flax(to_numpy_tree(variables)), path,
        compute_dtype=torch.float32, device="cpu")
    assert isinstance(blob, bytes) and len(blob) > 0
    assert open(path, "rb").read() == blob


def test_exported_is_bit_equal_to_eager(artifacts):
    """The artifact runs the eager forward's code path: the same ops on
    the same weights, bit for bit, at b = 1 (traced at b = 2) and 5."""
    spec, blob, _, state = artifacts
    infer = ex.load_exported(blob, device="cpu")
    eager = build_inference_fn(torch_spec(spec), state, torch.float32,
                               device="cpu")
    for batch in (1, 5):
        a, b = _pairs(10 + batch, batch, spec.num_points)
        got = infer(a, b)
        ref = eager(torch.from_numpy(a), torch.from_numpy(b))
        for key in ex.OUTPUT_KEYS:
            assert torch.equal(got[key], ref[key]), key


def test_bf16_artifact(model):
    """bf16 (the default, as in JAX): bit-equal to the port's eager bf16
    forward, and within BF16_ATOL of the JAX package's bf16 artifact."""
    spec, variables, state = model
    infer = ex.load_exported(
        ex.export_alignment_model(torch_spec(spec), state, device="cpu"),
        device="cpu")
    eager = build_inference_fn(torch_spec(spec), state, torch.bfloat16,
                               device="cpu")
    jax_infer = jax_load(jax_export(spec, variables))
    a, b = _pairs(4, 4, spec.num_points)
    got = infer(a, b)
    ref = eager(torch.from_numpy(a), torch.from_numpy(b))
    for key in ex.OUTPUT_KEYS:
        assert torch.equal(got[key], ref[key]), key
    jax_ref = jax_infer(a, b)
    for key in ("pred_s1_pc1centers", "pred_s2_pc1centers"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(jax_ref[key]),
                                   atol=BF16_ATOL, err_msg=key)


def _devices(graph):
    """Every device the graph's nodes name in their arguments."""
    found = set()
    for node in graph.nodes:
        for arg in (*node.args, *node.kwargs.values()):
            if isinstance(arg, torch.device):
                found.add(arg.type)
    return found


def test_artifact_moves_between_devices(artifacts):
    """An artifact exported on the CPU, moved to the meta device, names no
    other device in its graph and runs there with the right shapes; its
    answers on the CPU do not depend on the move's round trip through
    ``load_exported``'s pass."""
    spec, blob, _, _ = artifacts
    exported = torch.export.load(io.BytesIO(blob))
    assert _devices(exported.graph) <= {"cpu"}
    moved = move_to_device_pass(exported, "meta")
    assert _devices(moved.graph) <= {"meta"}
    out = moved.module()(*(torch.empty((3, spec.num_points, 3),
                                       device="meta") for _ in range(2)))
    assert [o.device.type for o in out] == ["meta"] * len(ex.OUTPUT_KEYS)
    assert [tuple(o.shape) for o in out] == [
        (3, 3)] * 4 + [(3, 2 * spec.num_bins)] * 2 + [(3, 3),
                                                      (3, 2 * spec.num_bins)]
    a, b = _pairs(6, 2, spec.num_points)
    eager = torch.export.load(io.BytesIO(blob)).module()
    got = ex.load_exported(blob, device="cpu")(a, b)
    ref = eager(torch.from_numpy(a), torch.from_numpy(b))
    for key, r in zip(ex.OUTPUT_KEYS, ref):
        assert torch.equal(got[key], r), key


def test_load_from_bytes_without_model_code(tmp_path):
    """A fresh process loads the artifact from a bytearray and serves it
    with ``alignnet3d_tpu_torch.models``, ``.serving`` and ``.checkpoint``
    never imported."""
    _, variables = trained_variables(SPEC)
    path = tmp_path / "model.pt2"
    path.write_bytes(ex.export_alignment_model(
        torch_spec(SPEC), from_flax(to_numpy_tree(variables)),
        compute_dtype=torch.float32, device="cpu"))
    code = f"""
import sys
import numpy as np
from alignnet3d_tpu_torch.export import load_exported
infer = load_exported(bytearray(open({str(path)!r}, "rb").read()), device="cpu")
out = infer(np.zeros((2, {SPEC.num_points}, 3), np.float32),
            np.ones((2, {SPEC.num_points}, 3), np.float32))
assert out["pred_translations"].shape == (2, 3)
assert out["pred_remaining_angle_logits"].shape == (2, {2 * SPEC.num_bins})
loaded = [m for m in ("alignnet3d_tpu_torch.models",
                      "alignnet3d_tpu_torch.serving",
                      "alignnet3d_tpu_torch.checkpoint") if m in sys.modules]
print("loaded:", loaded)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "loaded: []"


def _chain(seed, b, n, dims):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return (t(rng.normal(size=(b, n, dims[0]))),
            [t(rng.normal(size=(dims[i], dims[i + 1])))
             for i in range(len(dims) - 1)],
            [t(rng.normal(size=(dims[i + 1],))) for i in range(len(dims) - 1)])


@pytest.mark.parametrize("bf16", [False, True])
def test_opcheck_fused_pointnet(bf16):
    points, weights, biases = _chain(0, 3, 17, (3, 8, 16))
    torch.library.opcheck(pk._fused_pointnet_op,
                          (points, weights, biases, bf16))


def test_opcheck_knn_points():
    points = _chain(1, 3, 30, (3, 1))[0]
    torch.library.opcheck(kk._knn_points_op, (points, 5))


def test_opcheck_fused_edge_stage():
    points, (w1, w2), (b1, b2) = _chain(2, 3, 30, (6, 8, 16))
    points = points[..., :3].contiguous()
    idx = kk.knn_points_plain(points, 5)
    torch.library.opcheck(ek._fused_edge_stage_op,
                          (points, idx, w1, b1, w2, b2))


def test_the_ops_are_what_the_artifact_calls(artifacts):
    """The exported graph reaches the kernels through the three custom
    ops only: three a forward for the backbone's ops."""
    spec, blob, _, _ = artifacts
    graph = torch.export.load(io.BytesIO(blob)).graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    ours = sorted(t for t in targets if t.startswith("alignnet3d_torch."))
    if spec.backbone == "dgcnn":
        assert ours == ["alignnet3d_torch.fused_edge_stage.default"] * 3 \
            + ["alignnet3d_torch.knn_points.default"] * 3
    else:
        assert ours == ["alignnet3d_torch.fused_pointnet.default"] * 3
