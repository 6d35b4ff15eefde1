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

NON_FINITE = (float("nan"), float("inf"), float("-inf"))
BIG = 65536  # clouds: one past the 65,535 a grid dimension may hold


def _same(got, ref, rtol=0.0, atol=0.0):
    """NaN in the same places; the rest within the tolerance (equal at
    0), infinities equal."""
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    keep = ~torch.isnan(ref)
    torch.testing.assert_close(got[keep], ref[keep], rtol=rtol, atol=atol)


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
@pytest.mark.parametrize("value", NON_FINITE)
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-4),
    (torch.bfloat16, 2e-2),
])
def test_fused_pointnet_non_finite_point(sm90, value, dtype, tol):
    """One point of cloud 1 holds a non-finite coordinate: the kernel's
    output is NaN (and infinite) where the twin's is, and agrees
    elsewhere. The sums' NaN/inf outcome does not depend on their order."""
    points, weights, biases = _chain(13, 4, 300, (3, 64, 128, 1024), sm90)
    points[1, 17, 0] = value
    got = pk.fused_pointnet(points, weights, biases, dtype)
    ref = pk.fused_pointnet_plain(points, weights, biases, dtype)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(ref[1]).all())
    assert bool(torch.isfinite(ref[[0, 2, 3]]).all())
    _same(got, ref, tol, tol)


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
@pytest.mark.parametrize("value", NON_FINITE + (3e19,))  # 3e19: |p|^2 = inf
@pytest.mark.parametrize("where", ["src", "dst", "dst_masked"])
@pytest.mark.parametrize("n2", [500, 1030])  # one column chunk; three, merged
def test_nn_argmin_non_finite_point(sm90, value, where, n2):
    """A source point, or a valid or masked destination point, with a
    non-finite (or overflowing) coordinate, in two pairs: bit-equal to the
    twin, whose argmin takes the first NaN, masked columns included."""
    rng = np.random.default_rng(14)
    b, n1 = 4, 300
    src = rng.normal(size=(b, n1, 3)) * 10
    dst = rng.normal(size=(b, n2, 3)) * 10
    mask = rng.random((b, n2)) < 0.8
    mask[2] = False  # a pair with no valid destination point
    if where == "src":
        src[1, 5, 1] = src[2, 7, 0] = src[3, n1 - 1, 2] = value
    else:
        for pair in (1, 2):
            for j in (200, n2 - 3):  # in the first and the last chunk
                dst[pair, j, 2] = value
                mask[pair, j] = where == "dst"
    src, dst = (torch.from_numpy(a.astype(np.float32)).to(sm90)
                for a in (src, dst))
    mask = torch.from_numpy(mask).to(sm90)
    idx, d2 = nk.nn_argmin(src, dst, mask)
    ri, rd = nk.nn_argmin_plain(src, dst, mask)
    torch.cuda.synchronize()
    assert torch.equal(idx, ri)
    _same(d2, rd)


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
    (8, 512, 64, 5),        # 5-point clouds, the largest k: queues fill often
    (8, 512, 8, 5),
])
def test_knn_points_matches_twin_bit_for_bit(sm90, b, n, k, distinct):
    pts = _cloud(4, b, n, distinct, sm90)
    before = kk.knn_points.launches
    got = kk.knn_points(pts, k)
    torch.cuda.synchronize()
    assert kk.knn_points.launches == before + 1
    assert torch.equal(got, kk.knn_points_plain(pts, k))


@pytest.mark.gpu
@pytest.mark.parametrize("value", NON_FINITE)
def test_knn_points_non_finite_point(sm90, value):
    """Point 17 of cloud 1 holds a non-finite coordinate: bit-equal to the
    twin on all four clouds. The twin ranks as knn_points_pallas does
    (NaN distances first), so with a NaN point 17 heads every other row
    of its cloud."""
    pts = _cloud(15, 4, 300, None, sm90)
    pts[1, 17, 0] = value
    got = kk.knn_points(pts, 20)
    ref = kk.knn_points_plain(pts, 20)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    if value != value:
        assert bool((got[1, torch.arange(300) != 17, 0] == 17).all())


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
    (2, 1500, 20, 64, 128),    # V too large for shared memory: read from L2
])
def test_fused_edge_stage_matches_twin(sm90, b, n, k, c1, c2):
    args = _edge_inputs(5, b, n, k, 3, c1, c2, sm90)
    before = ek.fused_edge_stage.launches
    got = ek.fused_edge_stage(*args)
    torch.cuda.synchronize()
    assert ek.fused_edge_stage.launches == before + 1
    # 3xTF32 products (f32 accuracy) summed over C1 in another order than
    # the twin's f32 product
    torch.testing.assert_close(got, ek.fused_edge_stage_plain(*args),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("graph", ["finite", "knn_points"])
@pytest.mark.parametrize("value", NON_FINITE)
def test_fused_edge_stage_non_finite_point(sm90, value, graph):
    """Point 17 of cloud 1 holds a non-finite coordinate, over the finite
    points' graph or over kernel 3's graph of the cloud as it is: NaN where
    the twin has NaN, the rest (infinities included) within 1e-5, on all
    four clouds. An infinite point makes infinite activations, where a
    3xTF32 split must not turn inf - inf or inf x 0 into NaN."""
    pts, idx, *weights = _edge_inputs(16, 4, 300, 20, 3, 64, 128, sm90)
    pts[1, 17, 0] = value
    if graph == "knn_points":
        idx = kk.knn_points(pts, 20)
    got = ek.fused_edge_stage(pts, idx, *weights)
    ref = ek.fused_edge_stage_plain(pts, idx, *weights)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(ref[1]).all())
    assert bool(torch.isfinite(ref[[0, 2, 3]]).all())
    _same(got, ref, 1e-5, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("value", (float("inf"), float("-inf")))
def test_fused_edge_stage_tf32_exact_weights_and_an_infinite_point(sm90,
                                                                   value):
    """Every W2 entry a positive multiple of 1/8, exact in TF32, so
    W_small = 0: an infinite activation times W_small would be inf x 0 =
    NaN where the f32 product inf x w is +inf. With W2 > 0 and h1 >= 0 no
    inf - inf arises, so the rows that have the point as a neighbour are
    +inf in the twin."""
    pts, idx, w1, b1, w2, b2 = _edge_inputs(23, 3, 200, 20, 3, 64, 128, sm90)
    w2 = (torch.round(w2.abs() * 8) + 1) / 8
    pts[2, 5, 1] = value
    got = ek.fused_edge_stage(pts, idx, w1, b1, w2, b2)
    ref = ek.fused_edge_stage_plain(pts, idx, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert bool(ref[2].isinf().any())
    _same(got, ref, 1e-5, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
def test_fused_pointnet_op_cuda_impl_matches_twin(sm90, bf16):
    """The custom op called directly (as an exported program calls it):
    its CUDA impl launches the kernel once and agrees with the twin."""
    points, weights, biases = _chain(21, 9, 200, (3, 64, 128, 1024), sm90)
    before = pk.fused_pointnet.launches
    got = torch.ops.alignnet3d_torch.fused_pointnet(points, weights, biases,
                                                    bf16)
    torch.cuda.synchronize()
    assert pk.fused_pointnet.launches == before + 1
    dtype = torch.bfloat16 if bf16 else torch.float32
    tol = 2e-2 if bf16 else 1e-4  # as test_fused_pointnet_matches_twin
    torch.testing.assert_close(
        got, pk.fused_pointnet_plain(points, weights, biases, dtype),
        rtol=tol, atol=tol)


@pytest.mark.gpu
def test_knn_and_edge_stage_ops_cuda_impls_match_twins(sm90):
    pts = _cloud(22, 3, 300, device=sm90)
    before = (kk.knn_points.launches, ek.fused_edge_stage.launches)
    idx = torch.ops.alignnet3d_torch.knn_points(pts, 20)
    args = _edge_inputs(22, 3, 300, 20, 3, 64, 128, sm90)
    got = torch.ops.alignnet3d_torch.fused_edge_stage(pts, idx, *args[2:])
    torch.cuda.synchronize()
    assert (kk.knn_points.launches, ek.fused_edge_stage.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(idx, kk.knn_points_plain(pts, 20))
    _same(got, ek.fused_edge_stage_plain(pts, idx, *args[2:]), 1e-5, 1e-5)


def _small_spec(backbone):
    from alignnet3d_tpu_torch.models.alignnet import ModelSpec

    widths = (16, 32, 32) if backbone == "dgcnn" else (16, 32)
    return ModelSpec(backbone=backbone, num_points=64, num_bins=8,
                     s1_backbone=widths, s1_mlp=(32,), s2_backbone=widths,
                     s2_mlp=(32,), embedding=widths, remaining_mlp=(32,))


@pytest.mark.gpu
@pytest.mark.parametrize("backbone,where", [
    ("pointnet", "cuda"), ("pointnet", "cpu"), ("dgcnn", "cuda"),
    ("dgcnn", "cpu")])
def test_exported_program_launches_the_kernels(sm90, backbone, where):
    """An artifact exported on the card or on the CPU, loaded on the card:
    three launches of each backbone kernel a forward, bit-equal to the
    eager forward at b = 1 and 6."""
    from alignnet3d_tpu_torch.export import (OUTPUT_KEYS,
                                             export_alignment_model,
                                             load_exported)
    from alignnet3d_tpu_torch.serving import build_inference_fn
    from alignnet3d_tpu_torch.weights import init_state_dict

    spec = _small_spec(backbone)
    state = init_state_dict(spec, seed=3)
    infer = load_exported(export_alignment_model(
        spec, state, compute_dtype=torch.float32, device=where), device=sm90)
    eager = build_inference_fn(spec, state, device=sm90)
    kernels = ((kk.knn_points, ek.fused_edge_stage) if backbone == "dgcnn"
               else (pk.fused_pointnet,))
    rng = np.random.default_rng(4)
    for b in (1, 6):
        a, c = (torch.from_numpy(rng.normal(size=(b, 64, 3)).astype(
            np.float32)).to(sm90) for _ in range(2))
        for fn in kernels:
            fn.launches = 0
        got = infer(a, c)
        torch.cuda.synchronize()
        assert [fn.launches for fn in kernels] == [3] * len(kernels)
        ref = eager(a, c)
        for key in OUTPUT_KEYS:
            assert torch.equal(got[key], ref[key]), key


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


@pytest.mark.parametrize("kernel", ["knn_points", "fused_edge_stage",
                                    "fused_edge_stage_train"])
def test_wrappers_refuse_no_batch_for_its_size(kernel):
    """BIG clouds pass every shape check: on the meta device the only
    refusal is the device's, checked last."""
    pts = torch.zeros((BIG, 30, 3), device="meta")
    idx = torch.zeros((BIG, 30, 20), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="device"):
        if kernel == "knn_points":
            kk.knn_points(pts, 20)
        elif kernel == "fused_edge_stage":
            _, _, *weights = _edge_inputs(6, 1, 30, 20, 3, 8, 16, "meta")
            ek.fused_edge_stage(pts, idx, *weights)
        else:
            _, _, params, _ = _train_inputs(6, 1, 30, 20, 8, 16, "meta")
            et.fused_edge_stage_train(pts, idx, *params)


def test_cpu_tensors_run_the_twins(monkeypatch):
    pts, args = _cloud(7, 2, 30), _edge_inputs(7, 2, 30, 20, 3, 8, 16, "cpu")
    calls = []
    # the twins are reached through the custom ops, which return tensors:
    # each stand-in returns a tensor marked with its own value
    monkeypatch.setattr(kk, "knn_points_plain",
                        lambda *a: calls.append("knn") or torch.full((1,), 3))
    monkeypatch.setattr(ek, "fused_edge_stage_plain",
                        lambda *a: calls.append("edge") or torch.full((1,), 4.))
    before = (kk.knn_points.launches, ek.fused_edge_stage.launches)
    assert kk.knn_points(pts, 20).tolist() == [3]
    assert ek.fused_edge_stage(*args).tolist() == [4.0]
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
    ("wide_c1", "C1=65"),
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
    elif case == "smem":
        w2 = torch.zeros((8, 8000), device="meta")
        b2 = torch.zeros((8000,), device="meta")
    else:
        pts, idx, w1, b1, w2, b2 = _edge_inputs(8, 2, 30, 20, 3, 65, 16,
                                                "meta")
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


@pytest.mark.gpu
def test_fused_edge_stage_train_negative_and_zero_g2(sm90):
    """The forward picks the max over k by the sign of g2: the argmax of
    pre2 where g2 > 0, the argmin where g2 < 0, t = 0 where g2 == 0."""
    f, idx, params, cot = _train_inputs(19, 3, 320, 20, 64, 128, sm90)
    g2 = params[6].clone()
    g2[::3] = -g2[::3]
    g2[5] = 0.0
    params[6] = g2
    out, stats, grads = _train_grads(et.fused_edge_stage_train, f, idx,
                                     params, cot)
    r_out, r_stats, r_grads = _train_grads(et.fused_edge_stage_train_plain,
                                           f, idx, params, cot)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, r_out, rtol=1e-4, atol=1e-5)
    for s, r in zip(stats, r_stats):
        torch.testing.assert_close(s, r, rtol=1e-4, atol=1e-5)
    errs = et.grad_errors(grads, r_grads)
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.gpu
@pytest.mark.parametrize("value", NON_FINITE)
def test_fused_edge_stage_train_non_finite_point(sm90, value):
    """One non-finite coordinate in f: the batch statistics carry it to
    every output, so out and the statistics are NaN where the twin's are
    (everywhere), as the Trainer's non-finite guard needs."""
    f, idx, params, _ = _train_inputs(17, 3, 128, 20, 64, 128, sm90)
    f[1, 9, 2] = value
    with torch.no_grad():
        out, stats = et.fused_edge_stage_train(f, idx, *params)
        r_out, r_stats = et.fused_edge_stage_train_plain(f, idx, *params)
    torch.cuda.synchronize()
    assert bool(r_out.isnan().any())
    _same(out, r_out, 1e-4, 1e-5)
    for s, r in zip(stats, r_stats):
        _same(s, r, 1e-4, 1e-5)


@pytest.mark.gpu
def test_fused_edge_stage_train_training_shape(sm90):
    """256 clouds x 512 points, k=20, C1=64, C2=128: out and the statistics
    against the twin, and the call's peak device memory (forward +
    backward: dy1 alone is 671 MB; the twin needs ~10 GB). The gradients
    at this shape are held to float64 by chip_smoke.py."""
    f, idx, params, cot = _train_inputs(20, 256, 512, 20, 64, 128, sm90)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, stats, grads = _train_grads(et.fused_edge_stage_train, f, idx,
                                     params, cot)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    print(f"fused_edge_stage_train at the training shape: peak device "
          f"memory above the inputs {peak / 2**30:.3f} GiB")
    assert peak <= 1.5 * 2**30
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with torch.no_grad():
        r_out, r_stats = et.fused_edge_stage_train_plain(f, idx, *params)
    torch.testing.assert_close(out, r_out, rtol=1e-4, atol=1e-5)
    for s, r in zip(stats, r_stats):
        torch.testing.assert_close(s, r, rtol=1e-4, atol=1e-5)


def _big_case(kernel, device):
    """(wrapper, its twin, inputs) of ``kernel`` at BIG clouds of 32
    points (k=8, narrow widths)."""
    rng = np.random.default_rng(21)
    pts = torch.from_numpy(
        rng.normal(size=(BIG, 32, 3)).astype(np.float32)).to(device)
    if kernel == "fused_pointnet":
        _, ws, bs = _chain(21, 1, 1, (3, 64, 128), device)
        return pk.fused_pointnet, pk.fused_pointnet_plain, (pts, ws, bs)
    if kernel == "nn_argmin":
        dst = torch.roll(pts, 1, dims=0).contiguous()
        mask = torch.from_numpy(rng.random((BIG, 32)) < 0.8).to(device)
        return nk.nn_argmin, nk.nn_argmin_plain, (pts, dst, mask)
    if kernel == "knn_points":
        return kk.knn_points, kk.knn_points_plain, (pts, 8)
    idx = kk.knn_points_plain(pts, 8)
    if kernel == "fused_edge_stage":
        _, _, *weights = _edge_inputs(21, 1, 8, 8, 3, 64, 128, device)
        return ek.fused_edge_stage, ek.fused_edge_stage_plain, (
            pts, idx, *weights)
    _, _, params, _ = _train_inputs(21, 1, 8, 8, 8, 16, device)
    return et.fused_edge_stage_train, et.fused_edge_stage_train_plain, (
        pts, idx, *params)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fused_pointnet", "nn_argmin",
                                    "knn_points", "fused_edge_stage",
                                    "fused_edge_stage_train"])
def test_kernels_take_65536_clouds(sm90, kernel):
    """One call over BIG clouds. Kernels 1-4 run in slices of at most
    65,535 clouds, each held to its twin on the first and last 64 clouds;
    kernel 5 folds the batch into its grid (its statistics are over the
    whole batch) and is held to the twin over all of it."""
    fn, plain, args = _big_case(kernel, sm90)
    before = fn.launches
    with torch.no_grad():
        got = fn(*args)
    torch.cuda.synchronize()
    if kernel == "fused_edge_stage_train":
        assert fn.launches == before + 5  # the forward's launches
        with torch.no_grad():
            ref = plain(*args)
        torch.testing.assert_close(got[0], ref[0], rtol=1e-4, atol=1e-5)
        for s, r in zip(got[1], ref[1]):
            torch.testing.assert_close(s, r, rtol=1e-4, atol=1e-5)
        return
    assert fn.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    for sl in (slice(0, 64), slice(BIG - 64, BIG)):
        part = tuple(a[sl] if isinstance(a, torch.Tensor) and a.shape[0] == BIG
                     else a for a in args)
        ref = plain(*part)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, r in zip(got, ref):
            if g.dtype == torch.int64:
                assert torch.equal(g[sl], r)
            else:
                torch.testing.assert_close(g[sl], r, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_fused_edge_stage_train_backward_at_65536_clouds(sm90):
    """The backward at BIG clouds (its grid holds the batch too): the
    gradients against the twin's over the whole batch, 16.8 M edges (the
    twin's float32 sums over that many edges carry more rounding than the
    kernel's float64 ones, hence 1e-3)."""
    fn, plain, (pts, idx, *params) = _big_case("fused_edge_stage_train", sm90)
    cot = torch.from_numpy(np.random.default_rng(22).normal(
        size=(BIG, 32, 16)).astype(np.float32)).to(sm90)
    _, _, grads = _train_grads(fn, pts, idx, params, cot)
    _, _, r_grads = _train_grads(plain, pts, idx, params, cot)
    errs = et.grad_errors(grads, r_grads)
    assert max(errs.values()) <= 1e-3, errs


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
