"""The port's fused TRAINING edge stage (its plain twin on the CPU) and
``stable_max``/``stable_min`` against the JAX package, at the shapes of
tests/test_edge_train_kernels.py and tests/test_stable_max.py: forward
values, batch statistics, every gradient, and statistics that carry no
gradient. The JAX side runs ``fused_edge_stage_train`` in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alignnet3d_tpu.ops.edge_train_kernels import (
    fused_edge_stage_train as jax_stage,
)
from alignnet3d_tpu.ops.knn import knn, pairwise_distance
from alignnet3d_tpu.ops.stable_max import stable_max as jax_stable_max
from alignnet3d_tpu.ops.stable_max import stable_min as jax_stable_min
from alignnet3d_tpu_torch.ops import edge_train_kernels as et
from alignnet3d_tpu_torch.ops.stable_max import stable_max, stable_min

torch.set_num_threads(1)

KEYS = ("w1", "b1", "g1", "be1", "w2", "b2", "g2", "be2")


def _problem(b=2, n=40, c=3, c1=8, c2=16, k=5, seed=0):
    """The inputs of tests/test_edge_train_kernels.py::_random_problem, as
    numpy arrays."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = np.asarray(knn(pairwise_distance(jnp.asarray(f)), k))
    params = dict(
        w1=rng.normal(size=(2 * c, c1)) * 0.4,
        b1=rng.normal(size=(c1,)) * 0.1,
        g1=1.0 + 0.2 * rng.normal(size=(c1,)),
        be1=0.1 * rng.normal(size=(c1,)),
        w2=rng.normal(size=(c1, c2)) * 0.4,
        b2=rng.normal(size=(c2,)) * 0.1,
        g2=1.0 + 0.2 * rng.normal(size=(c2,)),
        be2=0.1 * rng.normal(size=(c2,)),
    )
    return f, idx, {k_: v.astype(np.float32) for k_, v in params.items()}


def _torch(f, idx, params, grad=False):
    t = lambda a: torch.tensor(a, requires_grad=grad)  # noqa: E731
    return (t(f), torch.from_numpy(idx.astype(np.int64)),
            {k: t(v) for k, v in params.items()})


@pytest.mark.parametrize("n", [40, 128])
def test_forward_values_and_stats_match_jax(n):
    f, idx, params = _problem(n=n)
    want, want_stats = jax_stage(jnp.asarray(f), jnp.asarray(idx),
                                 **params, interpret=True)
    tf, tidx, tp = _torch(f, idx, params)
    got, stats = et.fused_edge_stage_train(tf, tidx, **tp)
    # f32 on both sides; the sums run in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for g, w, name in zip(stats, want_stats, ("mu1", "var1", "mu2", "var2")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("value", [np.nan, np.inf])
def test_non_finite_point_matches_jax(value):
    """One non-finite coordinate in f: BN1's statistics span the batch, so
    the JAX kernel's out is NaN everywhere (jnp.maximum relus) and the
    twin's too (torch.relu), and so are var1, mu2 and var2. mu1 is NaN in
    the same places, except where an infinite V row reaches it: the JAX
    kernel gathers V by a one-hot product (0 * inf = NaN in every row of
    the cloud), the twin by index, which leaves mu1 at +-inf there. The
    CUDA kernel is held to the twin on such inputs in
    tests/test_torch_gpu_kernels.py."""
    f, idx, params = _problem()
    f[1, 7, 2] = value
    want, want_stats = jax_stage(jnp.asarray(f), jnp.asarray(idx),
                                 **params, interpret=True)
    tf, tidx, tp = _torch(f, idx, params)
    got, stats = et.fused_edge_stage_train(tf, tidx, **tp)
    for g, w, name in zip((got, *stats), (want, *want_stats),
                          ("out", "mu1", "var1", "mu2", "var2")):
        g, w = g.numpy(), np.asarray(w)
        if name != "mu1":
            assert np.isnan(g).all() and np.isnan(w).all(), name
            continue
        nan = np.isnan(w)
        gather = nan & ~np.isnan(g)
        assert not (np.isnan(g) & ~nan).any()
        assert np.isinf(g[gather]).all() and (value == np.inf or
                                              not gather.any())
        np.testing.assert_allclose(g[~nan], w[~nan], rtol=1e-5, atol=1e-6)


def test_stats_carry_no_gradient():
    f, idx, params = _problem()
    tf, tidx, tp = _torch(f, idx, params, grad=True)
    out, stats = et.fused_edge_stage_train(tf, tidx, **tp)
    assert not any(s.requires_grad for s in stats)
    g_out = torch.autograd.grad(out.sum(), tf)[0]
    out, stats = et.fused_edge_stage_train(tf, tidx, **tp)
    g_both = torch.autograd.grad(out.sum() + 5.0 * stats[0].sum(), tf,
                                 allow_unused=True)[0]
    torch.testing.assert_close(g_both, g_out, rtol=0, atol=0)


def _grads_jax(f, idx, params, cot):
    def loss(f_, *vals):
        out, _ = jax_stage(f_, jnp.asarray(idx), **dict(zip(KEYS, vals)),
                           interpret=True)
        return jnp.sum(out * cot)

    return jax.grad(loss, argnums=tuple(range(9)))(
        jnp.asarray(f), *[jnp.asarray(params[k]) for k in KEYS])


def _grads_torch(f, idx, params, cot):
    tf, tidx, tp = _torch(f, idx, params, grad=True)
    out, _ = et.fused_edge_stage_train(tf, tidx, **tp)
    return torch.autograd.grad(out, [tf, *[tp[k] for k in KEYS]],
                               torch.from_numpy(cot))


def test_gradients_match_jax():
    f, idx, params = _problem()
    cot = np.random.default_rng(1).normal(size=(2, 40, 16)).astype(np.float32)
    want = _grads_jax(f, idx, params, cot)
    got = _grads_torch(f, idx, params, cot)
    for g, w, name in zip(got, want, ("f",) + KEYS):
        # atol floor: b1's and b2's true gradients are 0 (BN absorbs the
        # pre-BN bias), so both sides are f32 cancellation noise there
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4,
                                   atol=5e-5, err_msg=name)


def test_duplicate_neighbours_route_to_the_first_slot():
    """Slots 1 and 0 name the same neighbour, so the max over k ties
    exactly wherever slot 0 wins: the JAX kernel and the twin both give the
    whole cotangent to slot 0, and every gradient agrees, df included."""
    f, idx, params = _problem(seed=3)
    idx = idx.copy()
    idx[:, :, 1] = idx[:, :, 0]
    cot = np.random.default_rng(4).normal(size=(2, 40, 16)).astype(np.float32)
    want = _grads_jax(f, idx, params, cot)
    got = _grads_torch(f, idx, params, cot)
    for g, w, name in zip(got, want, ("f",) + KEYS):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4,
                                   atol=5e-5, err_msg=name)


@pytest.mark.parametrize("shape,axis", [((4, 7), 1), ((3, 5, 6), 1),
                                         ((2, 9, 4), -1), ((6,), 0)])
def test_stable_max_and_min_match_jax(shape, axis):
    rng = np.random.default_rng(len(shape) + axis)
    x = rng.normal(size=shape).astype(np.float32)
    x[..., 0] = x[..., -1]  # exact ties on the last axis
    cot_shape = np.delete(np.array(shape), axis % len(shape))
    cot = rng.normal(size=tuple(cot_shape)).astype(np.float32)
    for jfn, tfn in ((jax_stable_max, stable_max), (jax_stable_min, stable_min)):
        want, vjp = jax.vjp(lambda a: jfn(a, axis), jnp.asarray(x))
        tx = torch.tensor(x, requires_grad=True)
        got = tfn(tx, axis)
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        got.backward(torch.from_numpy(cot))
        # both route the whole cotangent to the first arg-extremum: exact
        np.testing.assert_array_equal(tx.grad.numpy(),
                                      np.asarray(vjp(jnp.asarray(cot))[0]))
