"""Weight bridge between the flax variables tree and the port's
state_dict, and the port's own seeded init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import SPEC, to_numpy_tree, torch_spec, trained_variables

from alignnet3d_tpu.models.alignnet import AlignNet
from alignnet3d_tpu_torch.models.alignnet import AlignNet as TorchAlignNet
from alignnet3d_tpu_torch.weights import from_flax, init_state_dict, to_flax


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_round_trip_is_bit_equal():
    _, variables = trained_variables()
    ref = to_numpy_tree(variables)
    state = from_flax(ref)
    back = to_flax(state)
    ref_leaves = dict(_leaves(ref))
    back_leaves = dict(_leaves(back))
    assert ref_leaves.keys() == back_leaves.keys()
    for path, arr in ref_leaves.items():
        assert back_leaves[path].dtype == arr.dtype, path
        np.testing.assert_array_equal(back_leaves[path], arr, err_msg=str(path))


def test_state_dict_loads_into_port_model():
    """Every bridged key and shape is one the port's module tree has."""
    _, variables = trained_variables()
    model = TorchAlignNet(torch_spec(SPEC))
    state = from_flax(to_numpy_tree(variables))
    own = model.state_dict()
    assert state.keys() == own.keys()
    for k, v in own.items():
        assert tuple(state[k].shape) == tuple(v.shape), k
    model.load_state_dict(state)


def test_native_init_matches_flax_tree_and_shapes():
    x = jnp.zeros((2, SPEC.num_points, 3))
    ref = to_numpy_tree(AlignNet(SPEC).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        x, x, train=False))
    native = to_flax(init_state_dict(torch_spec(SPEC), seed=0))
    ref_leaves = dict(_leaves(ref))
    nat_leaves = dict(_leaves(native))
    assert ref_leaves.keys() == nat_leaves.keys()
    for path, arr in ref_leaves.items():
        assert nat_leaves[path].shape == arr.shape, path
        assert nat_leaves[path].dtype == np.float32, path
        # zero biases, unit BN scale/var, zero BN mean/bias, as flax inits
        if path[-1] in ("scale", "var"):
            np.testing.assert_array_equal(nat_leaves[path], 1.0)
        elif path[-1] in ("bias", "mean"):
            np.testing.assert_array_equal(nat_leaves[path], 0.0)


@pytest.mark.parametrize("seed", [0, 7])
def test_native_init_is_seeded_xavier_uniform(seed):
    a = init_state_dict(torch_spec(SPEC), seed=seed)
    b = init_state_dict(torch_spec(SPEC), seed=seed)
    c = init_state_dict(torch_spec(SPEC), seed=seed + 1)
    key = "siamese.PointNetBackbone_0.conv2.weight"
    torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    assert not torch.equal(a[key], c[key])
    for k, w in a.items():
        if k.endswith(".weight"):
            fan_out, fan_in = w.shape
            bound = np.sqrt(6.0 / (fan_in + fan_out))
            assert float(w.abs().max()) <= bound, k
            # uniform on [-bound, bound]: the spread reaches most of it
            assert float(w.abs().max()) > 0.5 * bound, k
