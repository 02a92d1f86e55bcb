"""Weight bridge: the reference's ``init_params(PRNGKey(0), cfg)`` pytree
handed over as numpy arrays comes out as the port's tree under the same
paths, bit for bit, and goes back unchanged."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.models import init_params
from repro_torch.weights import from_reference, to_numpy

# tier-1 runs several test processes at once: one torch thread each keeps
# them from oversubscribing the cores (the shapes here are tiny)
torch.set_num_threads(1)


def _flat(tree):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch,dtype", [("llama3_2_1b", "float32"),
                                        ("llama3_2_1b", "bfloat16"),
                                        ("qwen2_5_32b", "float32"),
                                        ("bloom_176b", "float32"),
                                        ("rwkv6_7b", "float32"),
                                        ("rwkv6_7b", "bfloat16"),
                                        ("zamba2_7b", "float32"),
                                        ("zamba2_7b", "bfloat16")])
def test_bridge_round_trip_bit_exact(arch, dtype):
    cfg = get_reduced_config(arch).replace(param_dtype=dtype)
    params, _ = init_params(jax.random.PRNGKey(0), cfg)
    np_tree = jax.tree.map(np.asarray, params)
    ported = from_reference(np_tree, "cpu")
    ref, got = _flat(np_tree), _flat(to_numpy(ported))
    assert ref.keys() == got.keys()
    for path, r in ref.items():
        t = _flat(ported)[path]
        assert tuple(t.shape) == r.shape, path
        if r.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(got[path], r.view(np.uint16))
            # and the values, through f32
            np.testing.assert_array_equal(
                t.float().numpy(), np.asarray(jnp.asarray(r, jnp.float32)))
        else:
            assert str(t.dtype).split(".")[-1] == r.dtype.name, path
            np.testing.assert_array_equal(got[path], r)


def test_bridge_dtype_cast_and_independence():
    """``dtype`` casts floating leaves only; the port owns its memory (a
    write to the bridged tree leaves the numpy tree untouched)."""
    tree = {"w": np.ones((2, 3), np.float32), "idx": np.arange(4)}
    out = from_reference(tree, "cpu", dtype=torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16
    assert out["idx"].dtype == torch.int64
    out["w"].add_(1)
    assert (tree["w"] == 1).all()
