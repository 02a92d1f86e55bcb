"""The port's device-group rules against the JAX reference's
``repro/launch/sharding.py`` and ``repro/launch/mesh.py``.

* ``make_rules`` / ``serving_rules`` equal the reference's, dict for dict,
  for the families of tests/test_sharding_rules.py and the MoE archs, over
  mesh shapes (1,1) .. (1,8) and several ``(n_rows, max_len)``; the
  training and prefill shapes of the full configs too;
* ``cache_axes_for`` and ``guarded_spec`` over every pool leaf (slab and
  paged) and ``pool_tree_shardings`` give the reference's specs;
* the param axes of every block kind (``block_param_axes``) and of
  zamba2's shared block (``shared_param_axes``), and their specs, equal
  the reference's init axes, leaf by leaf; ``group_layout_rules`` keeps
  the reference's rules, the ``head_dim`` fallback included;
* ``freeze_rules`` / ``thaw_rules``, the ``DeviceGroup`` descriptor,
  hypothesis counterparts of the ``guarded_spec`` properties,
  ``shard`` / ``unshard``, and ``group_meshes`` (consecutive disjoint
  slices, raising when too few devices).

The reference's rule functions read only ``mesh.axis_names`` and
``mesh.devices.shape``, so a stand-in object runs them on one JAX device.
"""
import types

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as r_get_config
from repro.configs import get_reduced_config as r_get_reduced_config
from repro.launch import sharding as RSH
from repro.models.model import block_param_axes as r_block_param_axes
from repro.models.model import init_params_shapes as r_init_params_shapes
from repro.serving import kv_cache as RKV
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.launch import mesh as TM
from repro_torch.launch import sharding as TSH
from repro_torch.models import init_params
from repro_torch.models.model import block_param_range
from repro_torch.serving import kv_cache as TKV

SETTINGS = settings(max_examples=20, deadline=None)

FAMILIES = ["llama3_2_1b", "rwkv6_7b", "zamba2_7b", "seamless_m4t_large_v2"]
ARCHS = FAMILIES + ["deepseek_v2_236b", "llama4_scout_17b_a16e",
                    "gemma3_4b"]
MESH_SHAPES = [(1, 1), (1, 2), (2, 2), (2, 4), (4, 2), (1, 8)]
ROWS_LENS = [(4, 44), (6, 64), (8, 33), (3, 16)]


def _mesh(data, model):
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.zeros((data, model), np.int8))


def _spec(p):
    """A reference PartitionSpec as the port's tuple."""
    return tuple(p)


@pytest.mark.parametrize("shape", MESH_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_rules_match_reference(arch, shape):
    mesh = _mesh(*shape)
    for reduced in (True, False):
        rcfg = (r_get_reduced_config if reduced else r_get_config)(arch)
        tcfg = (get_reduced_config if reduced else get_config)(arch)
        for n_rows, max_len in ROWS_LENS:
            assert TSH.serving_rules(tcfg, mesh, n_rows, max_len) == \
                RSH.serving_rules(rcfg, mesh, n_rows, max_len), \
                (arch, shape, reduced, n_rows, max_len)
        for sh in rcfg.shapes():
            tsh = next(s for s in tcfg.shapes() if s.name == sh.name)
            assert TSH.make_rules(tcfg, mesh, tsh) == \
                RSH.make_rules(rcfg, mesh, sh), (arch, shape, sh.name)


def _pool_trees(arch, layout, n_rows, max_len):
    """(reference ShapeDtypeStruct trees, port meta trees) of one pool."""
    rcfg, tcfg = r_get_reduced_config(arch), get_reduced_config(arch)
    kinds = tuple(s.kind for s in TKV.state_specs(tcfg))
    enc = 6 if tcfg.is_enc_dec else 0
    out_r, out_t = [], []
    for kind, lo, hi in TKV.kind_runs(kinds):
        L = hi - lo
        if layout == "paged":
            out_r.append(jax.eval_shape(
                lambda: RKV.new_paged_pool_tree(rcfg, kind, L, n_rows,
                                                max_len, 2, 7, enc)))
            out_t.append(TKV.new_paged_pool_tree(tcfg, kind, L, n_rows, 2,
                                                 7, enc, "meta"))
        else:
            out_r.append(jax.eval_shape(
                lambda: RKV.new_state_pool_tree(rcfg, kind, L, n_rows,
                                                max_len, enc)))
            out_t.append(TKV.new_state_pool_tree(tcfg, kind, L, n_rows,
                                                 max_len, enc, "meta"))
    return rcfg, tcfg, tuple(out_r), tuple(out_t)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("layout", ["slab", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, layout):
    """Every pool leaf's logical axes and guarded spec equal the
    reference's; ``pool_tree_shardings`` returns them in the tree's
    shape."""
    for n_rows, max_len in ROWS_LENS[:2]:
        rcfg, tcfg, rtree, ttree = _pool_trees(arch, layout, n_rows,
                                                max_len)
        r_leaves = dict(_flat(rtree))
        t_leaves = dict(_flat(ttree))
        assert set(r_leaves) == set(t_leaves)
        for shape in MESH_SHAPES:
            mesh = _mesh(*shape)
            rules = RSH.serving_rules(rcfg, mesh, n_rows, max_len)
            specs = TSH.pool_tree_shardings(
                mesh, TSH.serving_rules(tcfg, mesh, n_rows, max_len), ttree)
            rs, ts = dict(rules), dict(rules)
            for path, leaf in r_leaves.items():
                name = path[-1]
                r_ax = RSH.cache_axes_for(name, leaf.ndim, rs)
                t_ax = TSH.cache_axes_for(name, t_leaves[path].dim(), ts)
                assert t_ax == r_ax, (path, shape)
                want = _spec(RSH.guarded_spec(r_ax, leaf.shape, rs, mesh))
                assert TSH.guarded_spec(t_ax, tuple(t_leaves[path].shape),
                                        ts, mesh) == want, (path, shape)
                assert specs[path[0]][path[1]] == want, (path, shape)
            assert rs == ts  # the kv_time_noverlap rule both add
            t_axes = TSH.cache_tree_axes(ttree, dict(rules))
            r_axes = RSH.cache_tree_axes(rtree, dict(rules))
            for path in r_leaves:
                assert t_axes[path[0]][path[1]] == \
                    r_axes[path[0]][path[1]], (path, shape)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "deepseek_v2_236b",
                                  "llama4_scout_17b_a16e", "gemma3_4b"])
def test_decoder_param_axes_and_specs_match_reference(arch):
    """The port's decoder axes equal the reference's init axes leaf by
    leaf, and their guarded specs against the port's leaf shapes equal the
    reference's against its own."""
    rcfg, tcfg = r_get_reduced_config(arch), get_reduced_config(arch)
    r_shapes, _ = r_init_params_shapes(rcfg)
    r_axes = r_block_param_axes(rcfg, "decoder")
    r_stack = r_shapes["segments"]["blocks"]
    params = init_params(tcfg, torch.Generator().manual_seed(0), "meta")
    t_stack = block_param_range(params, tcfg, "decoder", 0, tcfg.n_layers)
    t_axes = TSH.block_param_axes(tcfg, "decoder", t_stack)
    for shape in MESH_SHAPES:
        mesh = _mesh(*shape)
        rules = RSH.serving_rules(rcfg, mesh, 4, 44)
        t_specs = TSH.block_param_shardings(mesh, rules, t_axes, t_stack)
        for parent, sub in t_stack.items():
            for name, leaf in sub.items():
                ax = r_axes[parent][name]
                assert t_axes[parent][name] == ax, (parent, name)
                r_leaf = r_stack[parent][name]
                assert tuple(leaf.shape) == tuple(r_leaf.shape)
                assert t_specs[parent][name] == _spec(RSH.guarded_spec(
                    ax, r_leaf.shape, rules, mesh)), (parent, name, shape)


def test_block_param_axes_refuse_other_kinds():
    """Every block kind has its axes now; a name that is no block kind is
    refused."""
    cfg = get_reduced_config("rwkv6_7b")
    with pytest.raises(ValueError, match="unknown block kind"):
        TSH.block_param_axes(cfg, "conv", {})


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_7b",
                                  "seamless_m4t_large_v2"])
def test_block_param_axes_match_reference_every_kind(arch):
    """The rwkv, mamba, mamba_shared, enc and dec axes (and zamba2's shared
    block's) equal the reference's ``block_param_axes`` / ``param_axes``
    leaf by leaf, and so do their guarded specs on every mesh shape."""
    from repro.models.model import param_axes as r_param_axes

    rcfg, tcfg = r_get_reduced_config(arch), get_reduced_config(arch)
    params = init_params(tcfg, torch.Generator().manual_seed(0), "meta")
    kinds = tuple(s.kind for s in TKV.state_specs(tcfg))
    trees = [(TSH.block_param_axes(tcfg, kind, t), r_block_param_axes(
        rcfg, kind), t) for kind, lo, hi in TKV.kind_runs(kinds)
        for t in [block_param_range(params, tcfg, kind, lo, hi)]]
    if "shared" in params:
        trees.append((TSH.shared_param_axes(tcfg, params["shared"]),
                      r_param_axes(rcfg)["shared"], params["shared"]))
    for shape in MESH_SHAPES:
        mesh = _mesh(*shape)
        rules = RSH.serving_rules(rcfg, mesh, 4, 44)
        for t_axes, r_axes, tree in trees:
            specs = TSH.block_param_shardings(mesh, rules, t_axes, tree)
            for parent, sub in tree.items():
                for name, leaf in sub.items():
                    ax = tuple(r_axes[parent][name])
                    assert t_axes[parent][name] == ax, (parent, name)
                    assert specs[parent][name] == _spec(RSH.guarded_spec(
                        ax, tuple(leaf.shape), rules, mesh)), (parent, name)


@pytest.mark.parametrize("shape", MESH_SHAPES)
@pytest.mark.parametrize("arch", ["llama3_2_1b", "deepseek_v2_236b"])
def test_group_layout_rules_keep_the_reference_rules(arch, shape):
    """The group layout is the reference's serving rules, ``kv_time`` and
    the ``head_dim`` fallback included (it once raised for the latter)."""
    cfg = get_reduced_config(arch)
    rules = TSH.serving_rules(cfg, _mesh(*shape), 4, 44)
    assert TSH.group_layout_rules(rules) == rules
    assert rules == RSH.serving_rules(cfg, _mesh(*shape), 4, 44)
    heads_split = cfg.n_heads % shape[-1] == 0
    assert (rules["head_dim"] is None) == (heads_split or
                                           cfg.head_dim % shape[-1] != 0)


def test_embed_param_axes_match_reference():
    rcfg = r_get_reduced_config("llama4_scout_17b_a16e")
    _, r_axes = r_init_params_shapes(rcfg)
    tcfg = get_reduced_config("llama4_scout_17b_a16e")
    params = init_params(tcfg, torch.Generator().manual_seed(0), "meta")
    assert TSH.embed_param_axes(params["embed"]) == r_axes["embed"]


@SETTINGS
@given(st.sampled_from(ARCHS), st.sampled_from(MESH_SHAPES),
       st.sampled_from([1, 2, 3, 4, 6, 8]), st.sampled_from([8, 16, 33]))
def test_frozen_rules_roundtrip_and_match(arch, shape, n_rows, max_len):
    cfg = get_reduced_config(arch)
    mesh = TM.GroupMesh(np.full(shape, "cpu", dtype=object))
    rules = TSH.serving_rules(cfg, mesh, n_rows, max_len)
    frozen = TSH.freeze_rules(rules)
    assert frozen == RSH.freeze_rules(RSH.serving_rules(
        r_get_reduced_config(arch), _mesh(*shape), n_rows, max_len))
    assert TSH.thaw_rules(frozen) == rules
    assert TSH.frozen_serving_rules(cfg, mesh, n_rows, max_len) == frozen
    assert TSH.freeze_rules(None) is None and TSH.thaw_rules(None) == {}


# ---------------------------------------------------------------------------
# guarded_spec properties (the counterparts of tests/test_sharding_rules.py)
# ---------------------------------------------------------------------------


@SETTINGS
@given(st.integers(1, 64), st.integers(1, 64), st.integers(1, 64),
       st.sampled_from([1, 2, 4, 8]), st.sampled_from([1, 2, 4]))
def test_guarded_spec_divides_never_reuses_and_matches(d0, d1, d2, model,
                                                       data):
    mesh = _mesh(data, model)
    rules = {"a": "model", "b": ("data", "model"), "c": "data"}
    spec = TSH.guarded_spec(("a", "b", "c"), (d0, d1, d2), rules, mesh)
    sizes = {"data": data, "model": model}
    used = []
    for dim, entry in zip((d0, d1, d2), spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        assert dim % int(np.prod([sizes[a] for a in axes])) == 0
        used += list(axes)
    assert len(used) == len(set(used))
    assert spec == _spec(RSH.guarded_spec(("a", "b", "c"), (d0, d1, d2),
                                          rules, mesh))


@SETTINGS
@given(st.sampled_from([3, 5, 7, 11, 13]), st.sampled_from([2, 4, 8]),
       st.sampled_from(["x", "unknown", None]))
def test_guarded_spec_replicates_nondivisible_and_unknown(dim, model, ax):
    mesh = _mesh(2, model)
    assert TSH.guarded_spec((ax,), (dim,), {"x": "model"}, mesh) == (None,)
    assert TSH.guarded_spec(("unknown",), (dim * model,), {"x": "model"},
                            mesh) == (None,)


@SETTINGS
@given(st.sampled_from(MESH_SHAPES), st.integers(1, 3), st.integers(1, 3))
def test_shard_unshard_roundtrip(shape, a, b):
    """Each slot's block has the spec's shape and the blocks put back
    together give the leaf (replicated dims whole on every slot)."""
    data, model = shape
    mesh = TM.GroupMesh(np.full(shape, "cpu", dtype=object))
    x = torch.arange(data * model * a * model * b * 3,
                     dtype=torch.float32).reshape(data * model * a,
                                                  model * b, 3)
    for spec in [("data", "model", None), (("data", "model"), None, None),
                 (None, "model", None), (None, None, None)]:
        parts = TSH.shard(x, spec, mesh)
        assert len(parts) == data * model
        for s, p in enumerate(parts):
            assert p.shape == x[TSH.slot_index(tuple(x.shape), spec, mesh,
                                               s)].shape
        assert torch.equal(TSH.unshard(parts, spec, mesh, x.shape), x)


# ---------------------------------------------------------------------------
# DeviceGroup and group_meshes
# ---------------------------------------------------------------------------


def test_device_group_descriptor():
    solo = TSH.as_device_group(None)
    assert solo.mesh is None and solo.n_chips == 1 and solo.devices == ()
    cfg = get_reduced_config("llama3_2_1b")
    assert solo.frozen_rules_for(cfg, 4, 8) is None
    mesh = TM.GroupMesh(np.full((2, 2), "cpu", dtype=object))
    g = TSH.as_device_group(mesh)
    assert g.mesh is mesh and g.n_chips == 4 and len(g.devices) == 4
    assert g.frozen_rules_for(cfg, 4, 8) == TSH.frozen_serving_rules(
        cfg, mesh, 4, 8)
    assert TSH.as_device_group(g) is g
    override = TSH.DeviceGroup(mesh=mesh,
                               rules={"batch": None, "mlp": "model"})
    assert isinstance(override.rules, tuple)
    assert override.frozen_rules_for(cfg, 4, 8) == override.rules
    assert hash(g) == hash(TSH.DeviceGroup(
        mesh=TM.GroupMesh(np.full((2, 2), "cpu", dtype=object))))


def test_group_meshes_disjoint_consecutive_slices():
    devs = [f"cpu:{i}" for i in range(7)]
    groups = TM.group_meshes({2: (2, 2), 0: None, 1: (1, 2), 3: (1, 1)},
                             devices=devs)
    assert groups[0] is None
    assert [str(d) for d in groups[1].slot_devices()] == devs[0:2]
    assert [str(d) for d in groups[2].slot_devices()] == devs[2:6]
    assert [str(d) for d in groups[3].slot_devices()] == devs[6:7]
    assert groups[2].devices.shape == (2, 2)
    assert TM.mesh_axis_sizes(groups[2]) == {"data": 2, "model": 2}
    assert TM.batch_axes(groups[2]) == ("data",)
    # one device named for every slot: how the CPU tests run a group
    same = TM.group_meshes({0: (2, 4)}, devices=["cpu"] * 8)[0]
    assert same.size == 8 and len(set(same.slot_devices())) == 1
    assert TM.make_mesh_for(4, 2, devices=["cpu"] * 4).devices.shape == \
        (2, 2)


def test_group_meshes_raise_when_too_few_devices():
    with pytest.raises(ValueError, match="need 6 devices, host has 4"):
        TM.group_meshes({0: (1, 2), 1: (2, 2)}, devices=["cpu"] * 4)
    if torch.cuda.device_count() < 2:  # the default list: the cards present
        with pytest.raises(ValueError, match="device groups need"):
            TM.group_meshes({0: (1, 2)})
