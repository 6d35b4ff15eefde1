"""Angle codec and z-rotations of the port against the JAX package, on the
cases of tests/test_angle_codec.py and on random inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)

from alignnet3d_tpu.ops import angle_codec as jac
from alignnet3d_tpu.ops import transforms as jtf
from alignnet3d_tpu_torch.ops import angle_codec as tac
from alignnet3d_tpu_torch.ops import transforms as ttf

# float32 angle arithmetic in both packages; the two frameworks' mod
# operations may round their last bit differently
ATOL = 1e-5


def _wrapped(d):
    return np.mod(np.asarray(d) + np.pi, 2 * np.pi) - np.pi


@pytest.mark.parametrize("num_bins", [36, 50])
def test_angle2class_matches_jax(num_bins):
    angles = np.concatenate([
        np.linspace(-np.pi, np.pi, 101),
        np.random.default_rng(0).uniform(-10, 10, 200),
    ]).astype(np.float32)
    jc, jr = jac.angle2class(jnp.asarray(angles), num_bins)
    tc, tr = tac.angle2class(torch.from_numpy(angles), num_bins)
    assert tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL)
    recon = tac.class2angle(tc, tr, num_bins).numpy()
    assert np.max(np.abs(_wrapped(recon - angles))) < ATOL


def test_angle2class_bin_centers():
    num_bins = 36
    apc = 2 * np.pi / num_bins
    cls, res = tac.angle2class(torch.tensor([0.0, apc, 2 * apc]), num_bins)
    assert cls.tolist() == [0, 1, 2]
    assert np.allclose(res.numpy(), 0.0, atol=1e-6)


def test_logits_to_angle_gathers_argmax_residual():
    num_bins = 4
    logits = np.zeros((2, 8), dtype=np.float32)
    logits[0, 1] = 5.0
    logits[0, 4:] = [9.0, 0.25, 9.0, 9.0]
    logits[1, 3] = 5.0
    logits[1, 4:] = [9.0, 9.0, 9.0, -0.5]
    got = tac.logits_to_angle(torch.from_numpy(logits), num_bins, 1.0).numpy()
    ref = np.asarray(jac.logits_to_angle(jnp.asarray(logits), num_bins, 1.0))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    apc = 2 * np.pi / num_bins
    assert got[0] == pytest.approx(apc + 0.25, abs=1e-6)


@pytest.mark.parametrize("scale", [1.0, np.pi / 50])
def test_logits_to_angle_matches_jax(scale):
    num_bins = 50
    logits = np.random.default_rng(1).normal(
        size=(64, 2 * num_bins)).astype(np.float32)
    ref = np.asarray(jac.logits_to_angle(jnp.asarray(logits), num_bins, scale))
    got = tac.logits_to_angle(torch.from_numpy(logits), num_bins, scale).numpy()
    assert np.max(np.abs(_wrapped(got - ref))) < ATOL


@pytest.mark.parametrize("scale", [1.0, np.pi / 50])
def test_np_decoder_is_the_jax_packages(scale):
    logits = np.random.default_rng(2).normal(size=(32, 100)).astype(np.float32)
    np.testing.assert_array_equal(
        tac.class_logits_to_angle_np(logits, 50, scale),
        jac.class_logits_to_angle_np(logits, 50, scale))


def test_np_decoder_default_keeps_reference_unscaled_quirk():
    logits = np.zeros((1, 8), dtype=np.float32)
    logits[0, 0] = 5.0
    logits[0, 4] = 0.8
    assert tac.class_logits_to_angle_np(logits, 4)[0] == pytest.approx(0.8)


def _rigid_inputs(seed=3, b=5, n=17):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32) * 3  # noqa: E731
    return f(b, n, 3), f(b, 3), rng.uniform(-4, 4, b).astype(np.float32), f(b, 3)


def test_rotation_and_rotate_points_match_jax():
    pcs, _, angles, _ = _rigid_inputs()
    np.testing.assert_allclose(
        ttf.rotation_matrix_z(torch.from_numpy(angles)).numpy(),
        np.asarray(jtf.rotation_matrix_z(jnp.asarray(angles))), atol=1e-6)
    np.testing.assert_allclose(
        ttf.rotate_points_z(torch.from_numpy(pcs), torch.from_numpy(angles)).numpy(),
        np.asarray(jtf.rotate_points_z(jnp.asarray(pcs), jnp.asarray(angles))),
        atol=1e-5)


def test_transform_pcs_and_apply_rigid_match_jax():
    pcs, t, a, c = _rigid_inputs()
    T = [torch.from_numpy(x) for x in (pcs, t, a, c)]
    J = [jnp.asarray(x) for x in (pcs, t, a, c)]
    np.testing.assert_allclose(ttf.transform_pcs(*T).numpy(),
                               np.asarray(jtf.transform_pcs(*J)), atol=1e-5)
    np.testing.assert_allclose(ttf.apply_rigid(*T).numpy(),
                               np.asarray(jtf.apply_rigid(*J)), atol=1e-5)
    # partial arguments take the same branches
    np.testing.assert_allclose(
        ttf.transform_pcs(T[0], translations=T[1]).numpy(),
        np.asarray(jtf.transform_pcs(J[0], translations=J[1])), atol=1e-6)
