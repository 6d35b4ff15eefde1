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

from alignnet3d_tpu_torch.ops import edge_conv_kernels as ek
from alignnet3d_tpu_torch.ops import knn_kernels as kk
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


def _cloud(seed, b, n, distinct=None, device="cpu"):
    """(b, n, 3) float32 at world scale; with ``distinct``, each cloud is
    ``distinct`` points drawn with replacement (bit-identical duplicates,
    as the serving resampler makes them)."""
    rng = np.random.default_rng(seed)
    if distinct is None:
        pts = rng.normal(size=(b, n, 3)) * 3.0
    else:
        base = rng.normal(size=(b, distinct, 3)) * 3.0
        pts = np.take_along_axis(
            base, rng.integers(0, distinct, (b, n))[..., None], axis=1)
    return torch.from_numpy(pts.astype(np.float32)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,k,distinct", [
    (256, 512, 20, None),   # the serving shape
    (256, 512, 20, 5),      # resampled 5-point clouds: mostly exact ties
    (3, 300, 20, None),     # N not a multiple of the thread block
    (2, 37, 37, None),      # k = N
    (4, 1500, 64, None),    # the largest k; two candidate tiles
    (5, 9, 3, None),        # fewer points than a warp
])
def test_knn_points_matches_twin_bit_for_bit(sm90, b, n, k, distinct):
    pts = _cloud(4, b, n, distinct, sm90)
    before = kk.knn_points.launches
    got = kk.knn_points(pts, k)
    torch.cuda.synchronize()
    assert kk.knn_points.launches == before + 1
    assert torch.equal(got, kk.knn_points_plain(pts, k))


def _edge_inputs(seed, b, n, k, c, c1, c2, device):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    pts = _cloud(seed, b, n)[..., :c].contiguous()
    args = (pts, kk.knn_points_plain(pts, k),
            t(rng.normal(size=(2 * c, c1)) / 2.0),
            t(rng.normal(size=(c1,)) * 0.1),
            t(rng.normal(size=(c1, c2)) / np.sqrt(c1)),
            t(rng.normal(size=(c2,)) * 0.1))
    return tuple(a.to(device) for a in args)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,k,c1,c2", [
    (256, 512, 20, 64, 128),   # the serving shape of every DGCNN stack
    (3, 300, 20, 64, 128),     # N not a multiple of the point strip
    (2, 37, 37, 64, 128),      # k = N
    (2, 97, 5, 13, 200),       # odd widths; C2 over one column pass
])
def test_fused_edge_stage_matches_twin(sm90, b, n, k, c1, c2):
    args = _edge_inputs(5, b, n, k, 3, c1, c2, sm90)
    before = ek.fused_edge_stage.launches
    got = ek.fused_edge_stage(*args)
    torch.cuda.synchronize()
    assert ek.fused_edge_stage.launches == before + 1
    # f32 FMAs summed over C1 in another order than the twin's product
    torch.testing.assert_close(got, ek.fused_edge_stage_plain(*args),
                               rtol=1e-5, atol=1e-5)


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
    with pytest.raises(ValueError, match="device"):
        kk.knn_points(torch.zeros((2, 30, 3), device="meta"), 20)
    args = _edge_inputs(6, 2, 30, 20, 3, 8, 16, "meta")
    with pytest.raises(ValueError, match="device"):
        ek.fused_edge_stage(*args)


def test_cpu_tensors_run_the_twins(monkeypatch):
    pts, args = _cloud(7, 2, 30), _edge_inputs(7, 2, 30, 20, 3, 8, 16, "cpu")
    calls = []
    monkeypatch.setattr(kk, "knn_points_plain",
                        lambda *a: calls.append("knn") or "knn")
    monkeypatch.setattr(ek, "fused_edge_stage_plain",
                        lambda *a: calls.append("edge") or "edge")
    before = (kk.knn_points.launches, ek.fused_edge_stage.launches)
    assert kk.knn_points(pts, 20) == "knn"
    assert ek.fused_edge_stage(*args) == "edge"
    assert calls == ["knn", "edge"]
    assert (kk.knn_points.launches, ek.fused_edge_stage.launches) == before


@pytest.mark.parametrize("case,match", [
    ("float64", "float32"),
    ("not_xyz", r"\(B, N, 3\)"),
    ("strided", "contiguous"),
    ("k_over_n", "k=31"),
    ("k_over_max", "k=65"),
])
def test_knn_points_refuses_what_the_kernel_does_not_take(case, match):
    pts = torch.zeros((2, 30, 3), device="meta")
    k = 20
    if case == "float64":
        pts = pts.double()
    elif case == "not_xyz":
        pts = torch.zeros((2, 30, 4), device="meta")
    elif case == "strided":
        pts = torch.zeros((2, 3, 30), device="meta").transpose(1, 2)
    elif case == "k_over_n":
        k = 31
    else:
        pts, k = torch.zeros((2, 100, 3), device="meta"), 65
    with pytest.raises(ValueError, match=match):
        kk.knn_points(pts, k)


@pytest.mark.parametrize("case,match", [
    ("int32_idx", "int64"),
    ("float64_w2", "float32"),
    ("idx_shape", "does not fit"),
    ("w1_rows", "chain"),
    ("strided_idx", "contiguous"),
    ("smem", "shared memory"),
])
def test_fused_edge_stage_refuses_what_the_kernel_does_not_take(case, match):
    pts, idx, w1, b1, w2, b2 = _edge_inputs(8, 2, 30, 20, 3, 8, 16, "meta")
    if case == "int32_idx":
        idx = idx.int()
    elif case == "float64_w2":
        w2 = w2.double()
    elif case == "idx_shape":
        idx = idx[:, :29].contiguous()
    elif case == "w1_rows":
        w1 = w1[:5]
    elif case == "strided_idx":
        idx = torch.zeros((2, 20, 30), dtype=torch.int64,
                          device="meta").transpose(1, 2)
    else:
        w2 = torch.zeros((8, 8000), device="meta")
        b2 = torch.zeros((8000,), device="meta")
    with pytest.raises(ValueError, match=match):
        ek.fused_edge_stage(pts, idx, w1, b1, w2, b2)
