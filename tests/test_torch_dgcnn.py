"""The port's DGCNN path against the JAX package on the CPU: the backbone
(eval and train mode, with the BN EMA update), the unfolded model, the
BN-folded serving forward, ``Aligner.align`` and the weight bridge.

Every kernel wrapper runs its plain twin here; the kNN graph goes through
``knn_points`` in the port and through ``knn(pairwise_distance(x))`` in
the JAX package on the CPU, which give the same neighbours."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import to_numpy_tree, torch_spec, trained_variables

from alignnet3d_tpu.api import Aligner as JaxAligner
from alignnet3d_tpu.models.alignnet import AlignNet, ModelSpec
from alignnet3d_tpu.models.backbones import DGCNNBackbone as JaxDGCNN
from alignnet3d_tpu.serving import build_inference_fn as jax_build
from alignnet3d_tpu_torch.api import Aligner
from alignnet3d_tpu_torch.data.synthetic import SyntheticBoxScene
from alignnet3d_tpu_torch.models.alignnet import AlignNet as TorchAlignNet
from alignnet3d_tpu_torch.models.backbones import DGCNNBackbone
from alignnet3d_tpu_torch.ops import edge_conv_kernels as ek
from alignnet3d_tpu_torch.ops import knn_kernels as kk
from alignnet3d_tpu_torch.serving import build_inference_fn
from alignnet3d_tpu_torch.weights import from_flax, init_state_dict, to_flax

SPEC = ModelSpec(
    backbone="dgcnn", num_points=64, num_bins=8,
    s1_backbone=(16, 32, 32), s1_mlp=(32,),
    s2_backbone=(16, 32, 32), s2_mlp=(32,),
    embedding=(16, 32, 32), remaining_mlp=(32,),
)
# float32 on the CPU in both packages, so the gaps are summation order;
# folding BN into the weights reorders the arithmetic once more
# (tests/test_serving.py holds the JAX package's own folded path to 2e-4)
TOL = 1e-5
FOLDED_TOL = 1e-4


@pytest.fixture(scope="module")
def trained():
    _, variables = trained_variables(SPEC)
    return variables, from_flax(to_numpy_tree(variables))


def _pairs(seed, b):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, SPEC.num_points, 3)).astype(np.float32),
            rng.normal(size=(b, SPEC.num_points, 3)).astype(np.float32))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def backbone_variables():
    """A flax DGCNNBackbone's variables with BN statistics moved by two
    train-mode passes."""
    model = JaxDGCNN(layer_sizes=(16, 32, 32), knn_impl="xla")
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(4, 64, 3)), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), x, train=False, momentum=0.9)
    for _ in range(2):
        x = jnp.asarray(rng.normal(size=(4, 64, 3)), jnp.float32)
        _, mut = model.apply(variables, x, train=True, momentum=0.5,
                             mutable=["batch_stats"])
        variables = {"params": variables["params"],
                     "batch_stats": mut["batch_stats"]}
    return model, variables


@pytest.mark.parametrize("knn_impl", ["pallas", "xla"])
def test_backbone_eval_matches_flax(backbone_variables, knn_impl):
    model, variables = backbone_variables
    port = DGCNNBackbone(3, (16, 32, 32), knn_impl=knn_impl)
    port.load_state_dict(from_flax(to_numpy_tree(variables)))
    x = np.random.default_rng(6).normal(size=(3, 64, 3)).astype(np.float32)
    ref = model.apply(variables, jnp.asarray(x), train=False, momentum=0.9)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_backbone_train_batch_stats_and_ema_match_flax(backbone_variables):
    model, variables = backbone_variables
    port = DGCNNBackbone(3, (16, 32, 32))
    port.load_state_dict(from_flax(to_numpy_tree(variables)))
    x = np.random.default_rng(7).normal(size=(4, 64, 3)).astype(np.float32)
    ref, mut = model.apply(variables, jnp.asarray(x), train=True,
                           momentum=0.7, mutable=["batch_stats"])
    got = port.train()(torch.from_numpy(x), momentum=0.7)
    # train-mode BN over (B, N, k) normalises by batch statistics of the
    # edges; the outputs carry the summation-order gap of those sums
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    got_stats = to_flax(port.state_dict())["batch_stats"]
    for path, arr in _leaves(to_numpy_tree(mut["batch_stats"])):
        node = got_stats
        for key in path:
            node = node[key]
        np.testing.assert_allclose(node, arr, rtol=TOL, atol=TOL,
                                   err_msg=str(path))


def test_eval_end_points_match_flax(trained):
    variables, state = trained
    port = TorchAlignNet(torch_spec(SPEC))
    port.load_state_dict(state)
    a, b = _pairs(1, 4)
    ref = AlignNet(SPEC).apply(variables, jnp.asarray(a), jnp.asarray(b),
                               train=False)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(a), torch.from_numpy(b))
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)


def test_folded_matches_jax_folded(trained):
    variables, state = trained
    a, b = _pairs(2, 4)
    ref = jax_build(SPEC, variables, compute_dtype=jnp.float32)(
        jnp.asarray(a), jnp.asarray(b))
    got = build_inference_fn(torch_spec(SPEC), state, torch.float32,
                             device="cpu")(torch.from_numpy(a),
                                           torch.from_numpy(b))
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=FOLDED_TOL, atol=FOLDED_TOL,
                                   err_msg=key)


def test_folded_matches_jax_folded_on_a_nan_point(trained):
    """A NaN coordinate in one point of pair 2's first cloud: the same
    answers of that pair are non-finite in both packages (the cloud's
    mean, and so every centred point, is NaN), and the rest agree within
    FOLDED_TOL."""
    variables, state = trained
    a, b = _pairs(4, 4)
    a[2, 11, 1] = np.nan
    ref = jax_build(SPEC, variables, compute_dtype=jnp.float32)(
        jnp.asarray(a), jnp.asarray(b))
    got = build_inference_fn(torch_spec(SPEC), state, torch.float32,
                             device="cpu")(torch.from_numpy(a),
                                           torch.from_numpy(b))
    assert got.keys() == ref.keys()
    finite = []
    for key in ref:
        r, g = np.asarray(ref[key]), got[key].numpy()
        if not np.issubdtype(r.dtype, np.floating):
            continue
        bad = ~np.isfinite(r.reshape(len(r), -1)).all(-1)
        np.testing.assert_array_equal(
            ~np.isfinite(g.reshape(len(g), -1)).all(-1), bad, err_msg=key)
        finite.append(~bad)
        np.testing.assert_allclose(g[~bad], r[~bad], rtol=FOLDED_TOL,
                                   atol=FOLDED_TOL, err_msg=key)
    assert not all(f[2] for f in finite)
    assert all(f[[0, 1, 3]].all() for f in finite)


def test_folded_path_runs_knn_then_the_edge_stage(trained, monkeypatch):
    _, state = trained
    calls = []
    real_knn, real_edge = kk.knn_points_plain, ek.fused_edge_stage_plain

    def knn_spy(points, k):
        calls.append(("knn", k))
        return real_knn(points, k)

    def edge_spy(points, nn_idx, w1, b1, w2, b2):
        calls.append(("edge", tuple(w1.shape), tuple(w2.shape)))
        return real_edge(points, nn_idx, w1, b1, w2, b2)

    monkeypatch.setattr(kk, "knn_points_plain", knn_spy)
    monkeypatch.setattr(ek, "fused_edge_stage_plain", edge_spy)
    a, b = _pairs(3, 2)
    build_inference_fn(torch_spec(SPEC), state, device="cpu")(
        torch.from_numpy(a), torch.from_numpy(b))
    assert calls == [("knn", 20), ("edge", (6, 16), (16, 32))] * 3


def test_folded_needs_three_conv_layers():
    spec = dataclasses.replace(torch_spec(SPEC), s1_backbone=(16, 32))
    with pytest.raises(ValueError, match="3 conv layers"):
        build_inference_fn(spec, init_state_dict(spec, seed=0), device="cpu")


@pytest.fixture(scope="module")
def aligners(trained):
    variables, state = trained
    clouds, seed = [], 0
    while len(clouds) < 6:
        scene = SyntheticBoxScene(seed, vres=16, hres=180)
        scene.generate_pointcloud()
        seed += 1
        if min(len(pc) for pc in scene.pointclouds) >= 5:
            clouds.append(scene.pointclouds)
    # batch 4 over 6 pairs: one full batch and one padded one
    return (JaxAligner(SPEC, variables, batch_size=4),
            Aligner(torch_spec(SPEC), state, batch_size=4, device="cpu"),
            [c[0] for c in clouds], [c[1] for c in clouds])


@pytest.mark.parametrize("mode", ["plain", "resolve_flips"])
def test_align_matches_jax(aligners, mode):
    jax_aligner, aligner, pcs1, pcs2 = aligners
    kwargs = {"resolve_flips": True} if mode == "resolve_flips" else {}
    # the same seed draws the same resampled clouds in both packages
    jax_aligner._rng = np.random.default_rng(0)
    aligner._rng = np.random.default_rng(0)
    ref = jax_aligner.align(pcs1, pcs2, **kwargs)
    got = aligner.align(pcs1, pcs2, **kwargs)
    assert got.keys() == ref.keys()
    # the folded f32 forward against the JAX model, as FOLDED_TOL
    for key in ("transforms", "translations", "centers"):
        np.testing.assert_allclose(got[key], ref[key], atol=FOLDED_TOL,
                                   err_msg=key)
    dang = np.mod(got["angles"] - ref["angles"] + np.pi, 2 * np.pi) - np.pi
    assert np.max(np.abs(dang)) < FOLDED_TOL


def test_weights_round_trip_is_bit_equal(trained):
    variables, state = trained
    ref = to_numpy_tree(variables)
    back = to_flax(state)
    ref_leaves, back_leaves = dict(_leaves(ref)), dict(_leaves(back))
    assert ref_leaves.keys() == back_leaves.keys()
    for path, arr in ref_leaves.items():
        assert back_leaves[path].dtype == arr.dtype, path
        np.testing.assert_array_equal(back_leaves[path], arr,
                                      err_msg=str(path))
    # flax conv1/kernel (2C, C1) is the port's conv1.weight (C1, 2C)
    key = "siamese.transformer1.DGCNNBackbone_0.conv1.weight"
    assert tuple(state[key].shape) == (16, 6)


def test_native_init_builds_the_flax_tree(trained):
    variables, _ = trained
    ref = dict(_leaves(to_numpy_tree(variables)))
    native = dict(_leaves(to_flax(init_state_dict(torch_spec(SPEC), seed=0))))
    assert ref.keys() == native.keys()
    for path, arr in ref.items():
        assert native[path].shape == arr.shape, path
