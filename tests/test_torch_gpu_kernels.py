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
from alignnet3d_tpu_torch.ops import edge_train_kernels as et
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
    ((3, 64, 128, 200), 300),    # last width not a multiple of the column tile
    ((3, 20, 37), 130),          # last layer narrower than one column tile
    ((3, 256, 256, 256, 64), 200),  # too wide for 128 points: 64-point tiles
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


def _prefix_masks(counts, n2, device):
    mask = torch.zeros((len(counts), n2), dtype=torch.bool)
    for i, c in enumerate(counts):
        mask[i, :c] = True
    return mask.to(device)


def _assert_nn_bit_equal(src, dst, mask):
    before = nk.nn_argmin.launches
    idx, d2 = nk.nn_argmin(src, dst, mask)
    torch.cuda.synchronize()
    assert nk.nn_argmin.launches == before + 1
    ri, rd = nk.nn_argmin_plain(src, dst, mask)
    assert torch.equal(idx, ri)
    assert torch.equal(d2, rd)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n1,n2", [
    (6, 1100, 700),    # n1 off the row strips, n2 off the tile and the group
    (6, 2500, 1030),   # several row strips and column chunks
])
def test_nn_argmin_prefix_masks(sm90, b, n1, n2):
    """Ragged prefix masks as ICP pads clouds: a fully masked pair and a
    pair with one valid column among them."""
    rng = np.random.default_rng(2)
    src = torch.from_numpy(
        (rng.normal(size=(b, n1, 3)) * 10).astype(np.float32)).to(sm90)
    dst = torch.from_numpy(
        (rng.normal(size=(b, n2, 3)) * 10).astype(np.float32)).to(sm90)
    counts = [n2, 0, 1, n2 // 3, n2 - 5, 257][:b]
    _assert_nn_bit_equal(src, dst, _prefix_masks(counts, n2, sm90))


@pytest.mark.gpu
def test_nn_argmin_exact_ties_and_coincident_points(sm90):
    """Destination clouds of 7 distinct points (every distance ties), and
    source points on top of destination points, where the unclamped
    distance can round to or below 0 and the clamp decides the index."""
    rng = np.random.default_rng(3)
    b, n1, n2 = 4, 300, 520
    base = rng.normal(size=(b, 7, 3)) * 20
    dst = np.take_along_axis(base, rng.integers(0, 7, (b, n2))[..., None], 1)
    src = rng.normal(size=(b, n1, 3)) * 20
    src[:, ::2] = dst[:, rng.integers(0, n2, n1 // 2)]
    src = torch.from_numpy(src.astype(np.float32)).to(sm90)
    dst = torch.from_numpy(dst.astype(np.float32)).to(sm90)
    _assert_nn_bit_equal(src, dst, _prefix_masks([n2, 400, 9, 1], n2, sm90))


@pytest.mark.gpu
def test_nn_argmin_icp_shape(sm90):
    """128 pairs x 4096 x 4096 with ragged prefix masks (the ICP shape)."""
    rng = np.random.default_rng(4)
    b, n = 128, 4096
    src = torch.from_numpy(
        (rng.normal(size=(b, n, 3)) * 10).astype(np.float32)).to(sm90)
    dst = torch.from_numpy(
        (rng.normal(size=(b, n, 3)) * 10).astype(np.float32)).to(sm90)
    counts = rng.integers(900, n + 1, b)
    counts[:4] = (n, 1, 0, 4095)
    _assert_nn_bit_equal(src, dst, _prefix_masks(counts, n, sm90))


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [8, 64, 256, 1000, 1024])
def test_nn_argmin_every_column_split(sm90, chunk):
    """The kernel under other column splits than the wrapper's: chunks from
    one column group to all columns, their answers merged."""
    rng = np.random.default_rng(5)
    b, n1, n2 = 3, 777, 1000
    src = torch.from_numpy(
        (rng.normal(size=(b, n1, 3)) * 5).astype(np.float32)).to(sm90)
    base = rng.normal(size=(b, 300, 3)) * 5
    dst = np.take_along_axis(base, rng.integers(0, 300, (b, n2))[..., None], 1)
    dst = torch.from_numpy(dst.astype(np.float32)).to(sm90)
    mask = _prefix_masks([n2, 613, 0], n2, sm90)
    idx, d2 = nk.launch(src, dst, mask, chunk)
    ri, rd = nk.nn_argmin_plain(src, dst, mask)
    assert torch.equal(idx, ri)
    assert torch.equal(d2, rd)


@pytest.mark.gpu
@pytest.mark.parametrize("n2", [1000, 37])  # 37: padded to 40 columns
def test_nn_argmin_column_table_matches_twin(sm90, n2):
    """The pre-pass kernel's table and column counts against the tensor
    ops of column_table_plain, bit for bit; holes in the masks."""
    rng = np.random.default_rng(6)
    dst = torch.from_numpy(
        (rng.normal(size=(4, n2, 3)) * 30).astype(np.float32)).to(sm90)
    mask = torch.from_numpy(rng.random((4, n2)) < 0.5).to(sm90)
    mask[1] = False
    mask[2] = False
    mask[2, 0] = True
    table, cols = nk.column_table(dst, mask)
    want_table, want_cols = nk.column_table_plain(dst, mask)
    torch.cuda.synchronize()
    assert torch.equal(table, want_table)
    assert torch.equal(cols, want_cols)


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


def _train_inputs(seed, b, n, k, c1, c2, device, distinct=None):
    """f, idx, the eight parameters and a cotangent of the training stage,
    at the scales of tests/test_edge_train_kernels.py."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    pts = _cloud(seed, b, n, distinct)
    idx = kk.knn_points_plain(pts, k).to(device)
    params = [t(rng.normal(size=(6, c1)) * 0.4),
              t(rng.normal(size=(c1,)) * 0.1),
              t(1.0 + 0.2 * rng.normal(size=(c1,))),
              t(0.1 * rng.normal(size=(c1,))),
              t(rng.normal(size=(c1, c2)) / np.sqrt(c1)),
              t(rng.normal(size=(c2,)) * 0.1),
              t(1.0 + 0.2 * rng.normal(size=(c2,))),
              t(0.1 * rng.normal(size=(c2,)))]
    return pts.to(device), idx, params, t(rng.normal(size=(b, n, c2)))


def _train_grads(fn, f, idx, params, cot):
    f = f.clone().requires_grad_()
    params = [p.clone().requires_grad_() for p in params]
    out, stats = fn(f, idx, *params)
    return out.detach(), stats, torch.autograd.grad(out, [f, *params], cot)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,k,c1,c2,distinct", [
    (2, 40, 5, 8, 16, None),      # the JAX tests' shape
    (3, 320, 20, 64, 128, None),  # several strips, indices above 256
    (2, 513, 20, 64, 128, None),  # N one past a multiple of the block
    (2, 513, 5, 8, 16, None),
    (4, 128, 20, 64, 128, 5),     # 5-point clouds: exact ties everywhere
    (2, 97, 20, 13, 40, None),    # widths off the tiles' multiples
])
def test_fused_edge_stage_train_matches_twin(sm90, b, n, k, c1, c2, distinct):
    f, idx, params, cot = _train_inputs(9, b, n, k, c1, c2, sm90, distinct)
    before = et.fused_edge_stage_train.launches
    out, stats, grads = _train_grads(et.fused_edge_stage_train, f, idx,
                                     params, cot)
    torch.cuda.synchronize()
    assert et.fused_edge_stage_train.launches == before + 10
    r_out, r_stats, r_grads = _train_grads(et.fused_edge_stage_train_plain,
                                           f, idx, params, cot)
    # f32 FMAs and sums in another order than the twin's
    torch.testing.assert_close(out, r_out, rtol=1e-4, atol=1e-5)
    for s, r in zip(stats, r_stats):
        torch.testing.assert_close(s, r, rtol=1e-4, atol=1e-5)
    # b1/b2 relative to be1/be2's gradients (et.grad_errors)
    errs = et.grad_errors(grads, r_grads)
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.gpu
def test_fused_edge_stage_train_backward_repeats(sm90):
    """Everything but dV's atomics is summed in a fixed order: two
    backward passes give bit-equal gradients of b1, the BNs and the
    second layer, and df/dW1, which sum dV, within rounding (the
    atomics land in another order: up to 3.2e-5 relative per element of
    dW1 on an H100)."""
    f, idx, params, cot = _train_inputs(10, 8, 512, 20, 64, 128, sm90)
    _, _, g1 = _train_grads(et.fused_edge_stage_train, f, idx, params, cot)
    _, _, g2 = _train_grads(et.fused_edge_stage_train, f, idx, params, cot)
    for i in (2, 3, 4, 5, 6, 7, 8):
        assert torch.equal(g1[i], g2[i])
    for a, b in zip(g1[:2], g2[:2]):
        assert float((a - b).norm() / b.norm()) <= 1e-5


def test_grad_errors_scales_absorbed_biases_by_their_shift():
    ref = [torch.full((4,), 2.0) for _ in et.GRAD_NAMES]
    ref[2] = torch.zeros(4)          # b1: true gradient 0
    got = [r + 0.1 for r in ref]
    errs = et.grad_errors(got, ref)
    assert list(errs) == list(et.GRAD_NAMES)
    # |0.1 * 1| / |2 * 1| everywhere: b1 relative to be1's norm, not to 0
    assert all(abs(e - 0.05) < 1e-6 for e in errs.values()), errs


def test_fused_edge_stage_train_cpu_runs_the_twin(monkeypatch):
    f, idx, params, _ = _train_inputs(11, 2, 30, 5, 8, 16, "cpu")
    calls = []
    monkeypatch.setattr(et, "fused_edge_stage_train_plain",
                        lambda *a, **kw: calls.append(1) or "plain")
    before = et.fused_edge_stage_train.launches
    assert et.fused_edge_stage_train(f, idx, *params) == "plain"
    assert calls == [1] and et.fused_edge_stage_train.launches == before


@pytest.mark.parametrize("case,match", [
    ("meta", "device"),
    ("int32_idx", "int64"),
    ("float64_f", "float32"),
    ("idx_shape", "does not fit"),
    ("w2_rows", "chain"),
    ("bn_shape", "chain"),
    ("wide", "8192"),
    ("smem", "shared memory"),
])
def test_fused_edge_stage_train_refuses_what_the_kernel_does_not_take(
        case, match):
    f, idx, params, _ = _train_inputs(12, 2, 30, 20, 8, 16, "meta")
    if case == "int32_idx":
        idx = idx.int()
    elif case == "float64_f":
        f = f.double()
    elif case == "idx_shape":
        idx = idx[:, :29].contiguous()
    elif case == "w2_rows":
        params[4] = torch.zeros((9, 16), device="meta")
    elif case == "bn_shape":
        params[6] = torch.zeros((15,), device="meta")
    elif case == "wide":
        c1, c2 = 128, 128
        f, idx, params, _ = _train_inputs(12, 2, 30, 5, c1, c2, "meta")
    elif case == "smem":
        f, idx, params, _ = _train_inputs(12, 2, 700, 600, 8, 16, "meta")
    with pytest.raises(ValueError, match=match):
        et.fused_edge_stage_train(f, idx, *params)
