"""The port's BN-folded serving forward against the JAX package's
``build_inference_fn`` and against the port's own unfolded eval model."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import SPEC, to_numpy_tree, torch_spec, trained_variables

from alignnet3d_tpu.serving import build_inference_fn as jax_build
from alignnet3d_tpu_torch.models.alignnet import AlignNet as TorchAlignNet
from alignnet3d_tpu_torch.ops import pointnet_kernels as pk
from alignnet3d_tpu_torch.serving import build_inference_fn
from alignnet3d_tpu_torch.weights import from_flax

# folding BN into the dense weights reorders f32 arithmetic; the JAX
# package holds its own folded path to the unfolded one at this tolerance
# (tests/test_serving.py)
TOL = 2e-4


@pytest.fixture(scope="module")
def setup():
    _, variables = trained_variables()
    state = from_flax(to_numpy_tree(variables))
    rng = np.random.default_rng(1)
    a = rng.normal(size=(8, SPEC.num_points, 3)).astype(np.float32)
    b = rng.normal(size=(8, SPEC.num_points, 3)).astype(np.float32)
    return variables, state, a, b


def test_folded_matches_jax_folded(setup):
    variables, state, a, b = setup
    ref = jax_build(SPEC, variables, compute_dtype=jnp.float32)(
        jnp.asarray(a), jnp.asarray(b))
    got = build_inference_fn(torch_spec(SPEC), state, torch.float32,
                             device="cpu")(torch.from_numpy(a),
                                           torch.from_numpy(b))
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)


def test_folded_matches_unfolded_eval(setup):
    _, state, a, b = setup
    model = TorchAlignNet(torch_spec(SPEC))
    model.load_state_dict(state)
    model.eval()
    A, B = torch.from_numpy(a), torch.from_numpy(b)
    with torch.no_grad():
        ref = model(A, B)
    got = build_inference_fn(torch_spec(SPEC), state, device="cpu")(A, B)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=key)


def test_bf16_folded_matches_jax_bf16(setup):
    """bf16 serving follows the JAX package's roundings; through three
    stacked stages a flipped bf16 rounding moves the centres by up to a
    few cm on this untrained net (tests/test_serving.py allows 0.15)."""
    variables, state, a, b = setup
    ref = jax_build(SPEC, variables, compute_dtype=jnp.bfloat16)(
        jnp.asarray(a), jnp.asarray(b))
    got = build_inference_fn(torch_spec(SPEC), state, torch.bfloat16,
                             device="cpu")(torch.from_numpy(a),
                                           torch.from_numpy(b))
    np.testing.assert_allclose(got["pred_s2_pc1centers"].numpy(),
                               np.asarray(ref["pred_s2_pc1centers"]), atol=0.15)


def test_three_chains_go_through_fused_pointnet(setup, monkeypatch):
    _, state, a, b = setup
    calls = []
    real = pk.fused_pointnet_plain

    def spy(points, weights, biases, compute_dtype):
        calls.append([tuple(w.shape) for w in weights])
        return real(points, weights, biases, compute_dtype)

    monkeypatch.setattr(pk, "fused_pointnet_plain", spy)
    build_inference_fn(torch_spec(SPEC), state, device="cpu")(
        torch.from_numpy(a), torch.from_numpy(b))
    assert calls == [[(3, 16), (16, 32)], [(3, 16), (16, 32)],
                     [(3, 16), (16, 64)]]
