"""The constrained point-to-point update of ICP (``icp_update``, kernel 6,
``csrc/icp_update.cu``) and its plain version.

This file imports no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_icp_update.py

On the CPU: ``icp_update_plain`` against a float64 numpy closed form, a
pair without correspondences, padded points, and how the wrappers route and
refuse tensors and what the ICP loop counts. The tests marked ``gpu`` hold
the kernel to its twin on a Hopper card and skip elsewhere.

Tolerances on the card: one update sums the same products in another order
(a fixed tree over 4,096 points against PyTorch's reductions), so R and t
agree to 1e-12 (sums of ~4e4 carry ~1e-11 of rounding, divided by the
weight); the next sweep's float32 points then round the same way but where
the float64 value lies within that gap of a float32 rounding boundary.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from alignnet3d_tpu_torch import tracing
from alignnet3d_tpu_torch.icp import p2point as tp2p
from alignnet3d_tpu_torch.ops import nn_kernels as nk

torch.set_num_threads(1)

NON_FINITE = (float("nan"), float("inf"), float("-inf"))
RADIUS = 0.1                     # the tracker's ICP radius
RADIUS2 = float(np.float32(RADIUS) * np.float32(RADIUS))
ICP_TOL = (0.01, 0.1)            # m, degrees: chip_smoke.py's ICP rule
ICP_AGREE = 0.95                 # share of pairs within ICP_TOL


def _rz(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _box(rng, n):
    """n points on the faces of a 4 x 1.8 x 1.5 m box, 1 cm noise."""
    size = np.array([4.0, 1.8, 1.5])
    face = rng.integers(0, 6, n)
    axis = face % 3
    pts = rng.uniform(-0.5, 0.5, (n, 3)) * size
    pts[np.arange(n), axis] = np.where(face < 3, 0.5, -0.5) * size[axis]
    return pts + rng.normal(0, 0.01, (n, 3))


def _track_pairs(seed, b, n=4096):
    """b pairs as a tracker's ICP sees them: two scans of one box (other
    points), the second moved by a yaw and translation, 1,500-n points a
    cloud (n/2-n below 3,000), zero-padded to n; inits 3 deg / 0.1 m off the truth. numpy
    (src, src_mask, dst, dst_mask, init (b, 4, 4))."""
    rng = np.random.default_rng(seed)
    src = np.zeros((b, n, 3), np.float32)
    dst = np.zeros((b, n, 3), np.float32)
    sm = np.zeros((b, n), bool)
    dm = np.zeros((b, n), bool)
    init = np.tile(np.eye(4), (b, 1, 1))
    for i in range(b):
        n1, n2 = rng.integers(min(1500, n // 2), n + 1, 2)
        centre = np.array([rng.uniform(5, 20), rng.uniform(-5, 5), -1.0])
        yaw, move = rng.uniform(-0.3, 0.3), rng.uniform(-1, 1, 3) * [1, 1, 0]
        src[i, :n1] = _box(rng, n1) + centre
        dst[i, :n2] = (_box(rng, n2) + centre) @ _rz(yaw).T + move
        sm[i, :n1] = True
        dm[i, :n2] = True
        dyaw = np.radians(rng.uniform(-3, 3))
        init[i, :3, :3] = _rz(yaw + dyaw)
        init[i, :3, 3] = move + rng.uniform(-0.1, 0.1, 3) * [1, 1, 0]
    return src, sm, dst, dm, init


def _state(src, sm, dst, dm, init, device):
    """The loop's tensors for one update: src64, src_mask, dst32, dst_mask,
    R, t and the first sweep's points."""
    src64 = torch.from_numpy(src.astype(np.float64)).to(device)
    R = torch.from_numpy(np.ascontiguousarray(init[:, :3, :3])).to(device)
    t = torch.from_numpy(np.ascontiguousarray(init[:, :3, 3])).to(device)
    moved32 = tp2p._moved_by(src64, R, t).to(torch.float32)
    return (src64, torch.from_numpy(sm).to(device),
            torch.from_numpy(dst).to(device), torch.from_numpy(dm).to(device),
            R, t, moved32)


def _one_update(update, src64, sm, dst, idx, d2, R, t, moved32):
    """``update`` on copies of R, t and moved32; returns the copies."""
    R, t, moved32 = R.clone(), t.clone(), moved32.clone()
    update(src64, sm, dst, idx, d2, RADIUS2, R, t, moved32)
    return R, t, moved32


# ---------------------------------------------------------------- the CPU


def _closed_form(p, q, w):
    """float64 numpy: the weighted yaw + translation taking p onto q."""
    wsum = max(w.sum(), 1e-12)
    p_bar = (w[:, None] * p).sum(0) / wsum
    q_bar = (w[:, None] * q).sum(0) / wsum
    a, b = p - p_bar, q - q_bar
    num = (w * (a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0])).sum()
    den = (w * (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1])).sum()
    R = _rz(np.arctan2(num, den))
    return R, q_bar - R @ p_bar


def test_plain_update_solves_a_known_yaw_and_translation():
    """Exact correspondences of a box moved by a known motion, one of them
    outside the radius: the update is the float64 closed form over the
    others, composed onto the start, and recovers the motion."""
    rng = np.random.default_rng(0)
    yaw, move = 0.2, np.array([0.3, -0.2, 0.05])
    p = _box(rng, 200) + [6.0, 2.0, -1.0]
    R0, t0 = _rz(0.05), np.array([0.1, 0.0, 0.0])
    src = np.linalg.solve(R0, (p - t0).T).T       # R0 src + t0 = p
    dst = (p @ _rz(yaw).T + move).astype(np.float32)
    d2 = np.zeros(200, np.float32)
    d2[7] = 1.0                                    # outside the radius
    full = np.ones((1, 200), bool)
    src64, sm, dst32, _, R, t, moved32 = _state(
        src[None], full, dst[None], full,
        np.concatenate([np.c_[R0, t0], [[0, 0, 0, 1]]])[None], "cpu")
    idx = torch.arange(200)[None]
    tp2p.icp_update_plain(src64, sm, dst32, idx, torch.from_numpy(d2)[None],
                          RADIUS2, R, t, moved32)
    w = (d2 < RADIUS2).astype(np.float64)
    moved = src @ R0.T + t0
    R_inc, t_inc = _closed_form(moved, dst.astype(np.float64), w)
    np.testing.assert_allclose(R[0].numpy(), R_inc @ R0, rtol=0, atol=1e-12)
    np.testing.assert_allclose(t[0].numpy(), R_inc @ t0 + t_inc, rtol=0,
                               atol=1e-12)
    # src -> dst is the motion after (R0, t0), up to dst's float32 rounding
    np.testing.assert_allclose(R[0].numpy(), _rz(yaw) @ R0, atol=1e-6)
    np.testing.assert_allclose(t[0].numpy(), _rz(yaw) @ t0 + move,
                               atol=1e-5)
    want = src @ R[0].numpy().T + t[0].numpy()
    np.testing.assert_allclose(moved32[0].numpy(), want, rtol=2 ** -23)


def test_plain_update_without_correspondence_keeps_the_pose():
    """Every distance at or past the radius (and one NaN): R and t stay
    exactly as they were; moved32 is their transform."""
    src, sm, dst, dm, init = _track_pairs(1, 2, n=300)
    src64, sm_t, dst32, _, R, t, moved32 = _state(src, sm, dst, dm, init,
                                                  "cpu")
    R0, t0 = R.clone(), t.clone()
    d2 = torch.full((2, 300), RADIUS2, dtype=torch.float32)
    d2[1, 5] = float("nan")
    idx = torch.zeros((2, 300), dtype=torch.int64)
    tp2p.icp_update_plain(src64, sm_t, dst32, idx, d2, RADIUS2, R, t,
                          moved32)
    assert torch.equal(R, R0) and torch.equal(t, t0)
    assert torch.equal(moved32, tp2p._moved_by(src64, R0, t0).float())


def test_plain_update_never_counts_padded_points():
    """A padded source point that would pass the gate, at any position:
    the pair's update is that of the unpadded pair."""
    src, sm, dst, dm, init = _track_pairs(2, 1, n=400)
    n1 = int(sm[0].sum())
    padded = np.zeros((1, n1 + 50, 3), np.float32)
    padded[0, :n1] = src[0, :n1]
    padded[0, n1:] = 123.0
    pad_mask = np.zeros((1, n1 + 50), bool)
    pad_mask[0, :n1] = True
    rng = np.random.default_rng(3)
    idx = rng.integers(0, int(dm[0].sum()), n1 + 50)
    d2 = np.where(rng.random(n1 + 50) < 0.7, 0.0, 1.0).astype(np.float32)
    got, want = [], []
    for pts, mask, out in ((padded, pad_mask, got),
                           (src[:, :n1], sm[:, :n1], want)):
        m = pts.shape[1]
        src64, sm_t, dst32, _, R, t, moved32 = _state(pts, mask, dst, dm,
                                                      init, "cpu")
        tp2p.icp_update_plain(
            src64, sm_t, dst32, torch.from_numpy(idx[:m])[None],
            torch.from_numpy(d2[:m])[None], RADIUS2, R, t, moved32)
        out += [R, t]
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-12)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-12)


def test_cpu_tensors_run_the_plain_versions(monkeypatch):
    calls = []
    monkeypatch.setattr(tp2p, "icp_update_plain",
                        lambda *a: calls.append("update"))
    x = torch.zeros(1, 4, 3, dtype=torch.float64)
    before = tp2p.icp_update.launches
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        tp2p.icp_update(x, None, None, None, None, RADIUS2, None, None, None)
    assert calls == ["update"]
    assert tp2p.icp_update.launches == before
    assert "icp.fused_steps" not in tracing.snapshot()["counters"]
    tracing.reset()


@pytest.mark.parametrize("fails", [False, True])
def test_a_fused_step_is_counted_where_the_kernel_launches(monkeypatch,
                                                           fails):
    """``icp_update.launches`` and the profiler's ``icp.fused_steps`` count
    each launch that returned, and nothing for one that raised (the launch
    itself stood in for, on the meta device)."""
    def launch(*args):
        if fails:
            raise RuntimeError("icp_update: kernel launch failed")

    monkeypatch.setattr(tp2p, "_launch", launch)
    x = torch.zeros(1, 4, 3, dtype=torch.float64, device="meta")
    before = tp2p.icp_update.launches
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            try:
                tp2p.icp_update(x, None, None, None, None, RADIUS2, None,
                                None, None)
            except RuntimeError:
                pass
    counters = tracing.snapshot()["counters"]
    tracing.reset()
    assert tp2p.icp_update.launches == before + 3 * (not fails)
    assert counters.get("icp.fused_steps", 0) == 3 * (not fails)


def test_other_devices_are_refused():
    src64, sm, dst, _, R, t, moved32 = (
        x.to("meta") for x in _state(*_track_pairs(4, 2, n=64), "cpu"))
    idx = torch.zeros((2, 64), dtype=torch.int64, device="meta")
    d2 = torch.zeros((2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tp2p.icp_update(src64, sm, dst, idx, d2, RADIUS2, R, t, moved32)


@pytest.mark.parametrize("with_constraint", [True, False])
def test_icp_counts_its_steps(with_constraint):
    """Under a profiler every ICP loop adds its iterations to ``icp.steps``;
    on the CPU none is fused (``icp.fused_steps`` counts only the card)."""
    src, sm, dst, dm, init = _track_pairs(5, 2, n=200)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        tp2p.icp_p2point_batch(src, sm, dst, dm, init, radius=RADIUS, its=3,
                               with_constraint=with_constraint, device="cpu")
        tp2p.icp_p2point_batch(src, sm, dst, dm, init, radius=RADIUS, its=0,
                               with_constraint=with_constraint, device="cpu")
    counters = tracing.snapshot()["counters"]
    tracing.reset()
    assert counters["icp.steps"] == 3
    assert "icp.fused_steps" not in counters


# ---------------------------------------------------------------- the card


@pytest.fixture
def sm90():
    """Skip unless a Hopper card is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90); none on this machine")
    if torch.cuda.get_device_capability(0)[0] != 9:
        pytest.skip("needs a Hopper card (sm_90)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ulps(a, b):
    """Distance in float32 units in the last place, elementwise."""
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    # order the bit patterns of negative numbers as their values
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 15, 64])
def test_kernel_matches_twin_one_iteration(sm90, b):
    src64, sm, dst, dm, R, t, moved32 = _state(*_track_pairs(10 + b, b),
                                               sm90)
    idx, d2 = nk.nn_argmin(moved32, dst, dm)
    before = tp2p.icp_update.launches
    got = _one_update(tp2p.icp_update, src64, sm, dst, idx, d2, R, t,
                      moved32)
    torch.cuda.synchronize()
    assert tp2p.icp_update.launches == before + 1
    want = _one_update(tp2p.icp_update_plain, src64, sm, dst, idx, d2, R, t,
                       moved32)
    assert not torch.equal(got[0], R)  # the pose moved
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-12)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-12)
    ulps = _ulps(got[2], want[2])
    assert float((ulps == 0).double().mean()) >= 0.999
    assert int(ulps.max()) <= 1


@pytest.mark.gpu
def test_a_pairs_answer_is_the_same_at_any_batch(sm90):
    """30 iterations: each pair's transform is bit-equal alone (B=1) and
    inside a batch of 64, and from run to run."""
    src, sm, dst, dm, init = _track_pairs(30, 64)
    full = tp2p.icp_p2point_batch(src, sm, dst, dm, init, radius=RADIUS,
                                  its=30, device=sm90)[0]
    again = tp2p.icp_p2point_batch(src, sm, dst, dm, init, radius=RADIUS,
                                   its=30, device=sm90)[0]
    np.testing.assert_array_equal(full, again)
    for i in (0, 17, 63):
        s = slice(i, i + 1)
        alone = tp2p.icp_p2point_batch(src[s], sm[s], dst[s], dm[s], init[s],
                                       radius=RADIUS, its=30, device=sm90)[0]
        np.testing.assert_array_equal(alone[0], full[i])


@pytest.mark.gpu
@pytest.mark.parametrize("value", NON_FINITE)
@pytest.mark.parametrize("where", ["src", "src_padded", "dst"])
def test_non_finite_point_matches_twin(sm90, value, where):
    """One non-finite coordinate in pair 1 (a valid source point, a padded
    source point, or a valid destination point): the kernel's R, t and
    moved32 are non-finite where the twin's are and agree elsewhere."""
    src, sm, dst, dm, init = _track_pairs(40, 4, n=1024)
    if where == "src":
        src[1, 3, 0] = value
    elif where == "src_padded":
        src[1, -1, 1] = value
        sm[1, -1] = False
    else:
        dst[1, 5, 2] = value
    src64, sm_t, dst32, dm_t, R, t, moved32 = _state(src, sm, dst, dm, init,
                                                     sm90)
    idx, d2 = nk.nn_argmin(moved32, dst32, dm_t)
    got = _one_update(tp2p.icp_update, src64, sm_t, dst32, idx, d2, R, t,
                      moved32)
    want = _one_update(tp2p.icp_update_plain, src64, sm_t, dst32, idx, d2, R,
                       t, moved32)
    torch.cuda.synchronize()
    for g, w, atol in zip(got, want, (1e-12, 1e-12, 1e-5)):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(torch.isinf(g), torch.isinf(w))
        fin = torch.isfinite(w)
        torch.testing.assert_close(g[fin], w[fin], rtol=0, atol=atol)
    assert bool(torch.isfinite(want[0][[0, 2, 3]]).all())


@pytest.mark.gpu
def test_launch_counts(sm90):
    """One update launch an iteration, none for a 0-iteration call; the
    sweeps are unchanged (its + 1); under a profiler every iteration is a
    fused step."""
    src, sm, dst, dm, init = _track_pairs(50, 3, n=512)
    for its in (30, 0):
        before = (tp2p.icp_update.launches, nk.nn_argmin.launches)
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            tp2p.icp_p2point_batch(src, sm, dst, dm, init, radius=RADIUS,
                                   its=its, device=sm90)
        counters = tracing.snapshot()["counters"]
        tracing.reset()
        after = (tp2p.icp_update.launches, nk.nn_argmin.launches)
        assert (after[0] - before[0], after[1] - before[1]) == (its, its + 1)
        assert counters.get("icp.fused_steps", 0) == its
        assert counters["icp.steps"] == its


@pytest.mark.gpu
def test_thirty_iterations_agree_with_the_twin(sm90, monkeypatch):
    """30-iteration ICP at the tracker's shape, kernel against twin on the
    card: chip_smoke.py's rule (0.01 m and 0.1 deg on 95% of pairs)."""
    src, sm, dst, dm, init = _track_pairs(60, 64)
    got = tp2p.icp_p2point_batch(src, sm, dst, dm, init, radius=RADIUS,
                                 its=30, device=sm90)[0]
    monkeypatch.setattr(tp2p, "icp_update", tp2p.icp_update_plain)
    want = tp2p.icp_p2point_batch(src, sm, dst, dm, init, radius=RADIUS,
                                  its=30, device=sm90)[0]
    dt = np.linalg.norm(got[:, :3, 3] - want[:, :3, 3], axis=1)
    da = np.degrees(np.abs(np.arctan2(got[:, 1, 0], got[:, 0, 0])
                           - np.arctan2(want[:, 1, 0], want[:, 0, 0])))
    agree = (dt <= ICP_TOL[0]) & (da <= ICP_TOL[1])
    assert agree.mean() >= ICP_AGREE, (dt.max(), da.max())


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernel_does_not_take(sm90):
    src64, sm, dst, dm, R, t, moved32 = _state(*_track_pairs(70, 2, n=64),
                                               sm90)
    idx, d2 = nk.nn_argmin(moved32, dst, dm)
    args = [src64, sm, dst, idx, d2, RADIUS2, R, t, moved32]
    for i, bad, match in (
            (0, src64.float(), "src64 must be"),
            (3, idx.int(), "idx must be"),
            (6, R[:, :2], "R must be"),
            (8, moved32.transpose(0, 1).contiguous().transpose(0, 1),
             "moved32 must be contiguous"),
            (4, d2.cpu(), "one device"),
            (4, d2[:, :-1], "d2 must be")):
        with pytest.raises(ValueError, match=match):
            tp2p.icp_update(*args[:i], bad, *args[i + 1:])
