"""The port's int8 serving math (``ops/quant.py``) and
``build_inference_fn(quantize=...)`` against the JAX package: the cases of
tests/test_quant.py on the port, each function held to the JAX one on the
same inputs, and the quantised forward of both scopes held to the JAX
package's.

Tolerances: the weight quantisation is numpy in both packages, so the int8
kernels and scales are equal; the int8 products are exact integers in
both. What differs is the float32 around them (the folded chains, the
centres), which can move a value across a rounding boundary of the
dynamic quantisation: one int8 step of one activation. So the layers are
held to 1e-5 of their norm, and the whole forward to 1e-3 of each output's
norm (a moved step shifts one row's product by ~1/127 of one input's share).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import to_numpy_tree, torch_spec, trained_variables

from alignnet3d_tpu.models.alignnet import ModelSpec
from alignnet3d_tpu.ops import quant as jq
from alignnet3d_tpu.ops.pointnet_kernels import fused_pointnet_xla
from alignnet3d_tpu.serving import build_inference_fn as jax_build
from alignnet3d_tpu_torch.ops import quant
from alignnet3d_tpu_torch.ops.pointnet_kernels import fused_pointnet
from alignnet3d_tpu_torch.serving import build_inference_fn
from alignnet3d_tpu_torch.weights import from_flax

B, N = 4, 64


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def test_weight_roundtrip_error_and_jax_equality():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(128, 256)).astype(np.float32)
    ((wq, scale),) = quant.quantize_weights_int8([torch.from_numpy(w)])
    ((jwq, jscale),) = jq.quantize_weights_int8([w])
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert wq.dtype == torch.int8
    back = wq.numpy().astype(np.float32) * scale.numpy()
    assert np.linalg.norm(back - w) / np.linalg.norm(w) < 0.01


@pytest.mark.parametrize("nonneg", [False, True])
def test_dense_int8_matches_f32_and_jax(nonneg):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 128)).astype(np.float32)
    if nonneg:
        x = np.maximum(x, 0.0)
    w = rng.normal(size=(128, 64)).astype(np.float32)
    q = quant.quantize_weights_int8([torch.from_numpy(w)])[0]
    dense = quant.dense_int8_nonneg if nonneg else quant.dense_int8
    jdense = jq._dense_int8_nonneg if nonneg else jq._dense_int8
    got = dense(torch.from_numpy(x), *q).numpy()
    assert _rel(got, x @ w) < 0.02
    want = np.asarray(jdense(jnp.asarray(x), *jq.quantize_weights_int8([w])[0]))
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("m,k,n", [(5, 3, 64), (17, 64, 128), (300, 12, 20)])
def test_int_mm_pads_exactly(m, k, n):
    rng = np.random.default_rng(m)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
    got = quant.int_mm(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, a.to(torch.int32) @ b.to(torch.int32))


def test_fused_pointnet_int8_close_to_f32_and_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(B, N, 3)).astype(np.float32)
    shapes = ((3, 64), (64, 128), (128, 256))
    ws = [rng.normal(size=s).astype(np.float32) * 0.2 for s in shapes]
    bs = [rng.normal(size=s[1]).astype(np.float32) * 0.1 for s in shapes]
    tw, tb = [torch.from_numpy(w) for w in ws], [torch.from_numpy(b)
                                                  for b in bs]
    ref = fused_pointnet(torch.from_numpy(pts), tw, tb, torch.float32)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(fused_pointnet_xla(
            jnp.asarray(pts), ws, bs, compute_dtype=jnp.float32)),
        rtol=1e-5, atol=1e-5)
    got = quant.fused_pointnet_int8(torch.from_numpy(pts),
                                    quant.quantize_weights_int8(tw), tb)
    assert _rel(got, ref) < 0.05  # 3 chained int8 layers + max-pool
    want = jq.fused_pointnet_int8(jnp.asarray(pts),
                                  jq.quantize_weights_int8(ws), bs)
    assert _rel(got, np.asarray(want)) < 1e-5


SPEC = ModelSpec(
    num_points=N, num_bins=8,
    s1_backbone=(16, 32), s1_mlp=(32,),
    s2_backbone=(16, 32), s2_mlp=(32,),
    embedding=(16, 64), remaining_mlp=(32,),
)


@pytest.fixture(scope="module")
def served():
    _, variables = trained_variables(SPEC)
    rng = np.random.default_rng(5)
    pcs = [rng.normal(size=(B, N, 3)).astype(np.float32) for _ in range(2)]
    return variables, from_flax(to_numpy_tree(variables)), pcs


@pytest.mark.parametrize("scope", ["embedding", "backbones"])
def test_quantized_inference_fn_matches_jax(served, scope):
    variables, state, pcs = served
    tpcs = [torch.from_numpy(p) for p in pcs]
    f32 = build_inference_fn(torch_spec(SPEC), state, device="cpu")(*tpcs)
    got = build_inference_fn(torch_spec(SPEC), state, device="cpu",
                             quantize=scope)(*tpcs)
    want = jax_build(SPEC, variables, compute_dtype=jnp.float32,
                     quantize=scope)(*[jnp.asarray(p) for p in pcs])
    assert got.keys() == f32.keys() == want.keys()
    for key in f32:
        g = got[key].numpy()
        assert np.all(np.isfinite(g))
        # the JAX test's bound against the f32 fold
        assert _rel(g, f32[key].numpy()) < 0.25, key
        assert _rel(g, np.asarray(want[key])) < 1e-3, key


def test_quantize_refuses_bogus_scope_and_dgcnn(served):
    _, state, _ = served
    with pytest.raises(ValueError, match="quantize"):
        build_inference_fn(torch_spec(SPEC), state, device="cpu",
                           quantize="bogus")
    dgcnn = ModelSpec(backbone="dgcnn", num_points=N, num_bins=8,
                      s1_backbone=(16, 32, 32), s1_mlp=(32,),
                      s2_backbone=(16, 32, 32), s2_mlp=(32,),
                      embedding=(16, 32, 32), remaining_mlp=(32,))
    with pytest.raises(ValueError, match="pointnet-only"):
        build_inference_fn(torch_spec(dgcnn), {}, device="cpu",
                           quantize="embedding")


def test_quantize_off_by_default_runs_kernel_1(served, monkeypatch):
    """Unquantised chains go through ``fused_pointnet``: all three by
    default, the s1/s2 ones under 'embedding', none under 'backbones'."""
    from alignnet3d_tpu_torch import serving

    _, state, pcs = served
    calls = []
    real = serving.fused_pointnet
    monkeypatch.setattr(serving, "fused_pointnet",
                        lambda *a: calls.append(1) or real(*a))
    tpcs = [torch.from_numpy(p) for p in pcs]
    for scope, want in ((None, 3), ("embedding", 2), ("backbones", 0)):
        calls.clear()
        build_inference_fn(torch_spec(SPEC), state, device="cpu",
                           quantize=scope)(*tpcs)
        assert len(calls) == want, scope
