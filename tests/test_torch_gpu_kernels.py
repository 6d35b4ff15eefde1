"""The port's CUDA kernels against their plain PyTorch twins, on the card.

This file imports no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu_kernels.py

The tests marked ``gpu`` skip on a machine without a Hopper card; the
others check, on any machine, how the wrappers route and refuse tensors.
"""

import numpy as np
import pytest
import torch

from alignnet3d_tpu_torch.ops import nn_kernels as nk
from alignnet3d_tpu_torch.ops import pointnet_kernels as pk

torch.set_num_threads(1)


@pytest.fixture
def sm90():
    """Skip unless a Hopper card is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90); none on this machine")
    if torch.cuda.get_device_capability(0)[0] != 9:
        pytest.skip("needs a Hopper card (sm_90)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _chain(seed, b, n, dims, device="cpu"):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    points = t(rng.normal(size=(b, n, dims[0])))
    weights = [t(rng.normal(size=(dims[i], dims[i + 1])) / np.sqrt(dims[i]))
               for i in range(len(dims) - 1)]
    biases = [t(rng.normal(size=(dims[i + 1],)) * 0.1)
              for i in range(len(dims) - 1)]
    return points, weights, biases


@pytest.mark.gpu
@pytest.mark.parametrize("dims,n", [
    ((3, 64, 128, 1024), 512),   # the embedding chain at serving N
    ((3, 64, 128, 256), 300),    # N not a multiple of the point tile
    ((5, 12, 7, 256, 33), 97),   # four layers, widths not multiples of 4
    ((3, 256, 4096), 64),        # shared memory past the 48 KB default
])
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-4),   # f32 FMAs in another summation order
    (torch.bfloat16, 2e-2),  # one flipped bf16 rounding, carried forward
])
def test_fused_pointnet_matches_twin(sm90, dims, n, dtype, tol):
    points, weights, biases = _chain(0, 6, n, dims, sm90)
    before = pk.fused_pointnet.launches
    got = pk.fused_pointnet(points, weights, biases, dtype)
    torch.cuda.synchronize()
    assert pk.fused_pointnet.launches == before + 1
    ref = pk.fused_pointnet_plain(points, weights, biases, dtype)
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n1,n2,scale", [
    (128, 512, 512, 10.0),    # flip resolution, world-scale clouds
    (4, 700, 4096, 10.0),     # ICP, several destination tiles
    (3, 1, 1, 1.0),           # single points
])
def test_nn_argmin_matches_twin_bit_for_bit(sm90, b, n1, n2, scale):
    rng = np.random.default_rng(1)
    src = torch.from_numpy(
        (rng.normal(size=(b, n1, 3)) * scale).astype(np.float32)).to(sm90)
    dst = torch.from_numpy(
        (rng.normal(size=(b, n2, 3)) * scale).astype(np.float32)).to(sm90)
    mask = torch.from_numpy(rng.random((b, n2)) < 0.8).to(sm90)
    mask[0] = False  # a pair with no valid destination point
    before = nk.nn_argmin.launches
    idx, d2 = nk.nn_argmin(src, dst, mask)
    torch.cuda.synchronize()
    assert nk.nn_argmin.launches == before + 1
    ri, rd = nk.nn_argmin_plain(src, dst, mask)
    assert torch.equal(idx, ri)
    assert torch.equal(d2, rd)


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(sm90):
    points, weights, biases = _chain(2, 2, 16, (3, 8, 16), sm90)
    with pytest.raises(ValueError, match="contiguous"):
        pk.fused_pointnet(points.transpose(0, 1), weights, biases)
    with pytest.raises(ValueError, match="wider"):
        wide = _chain(2, 2, 16, (3, 300, 16), sm90)
        pk.fused_pointnet(*wide)
    src = torch.zeros((2, 4, 3), device=sm90)
    with pytest.raises(ValueError, match="bool"):
        nk.nn_argmin(src, src, torch.ones((2, 4), device=sm90))


def test_other_devices_are_refused():
    """Only a CPU tensor takes the twin; any other device must launch the
    kernel or raise (here: the meta device, which has no kernel)."""
    points, weights, biases = _chain(3, 2, 8, (3, 8), "meta")
    with pytest.raises(ValueError, match="device"):
        pk.fused_pointnet(points, weights, biases)
    src = torch.zeros((1, 4, 3), device="meta")
    with pytest.raises(ValueError, match="device"):
        nk.nn_argmin(src, src, torch.ones((1, 4), dtype=torch.bool,
                                          device="meta"))
