"""Logical-axis sharding rules of a device-group server — the serving half
of the reference's ``repro/launch/sharding.py``.

The rule logic is the reference's, copied: ``make_rules`` maps every
logical axis name of a param or cache leaf to a mesh axis (or None =
replicate) from the config, the mesh's axis sizes and the shape kind;
``serving_rules`` is its decode-shaped cell whose batch is a pool's row
count; ``guarded_spec`` turns a leaf's logical axes into a per-dimension
tuple of mesh axes (the counterpart of ``PartitionSpec``: None, an axis
name or a tuple of names) with the reference's divisibility guard.  Only
``mesh.axis_names`` and ``mesh.devices.shape`` are read, so any object
with those two attributes serves.

Where the reference hands a spec to XLA's partitioner, here ``shard``
cuts a slot's block out of a leaf and ``unshard`` puts the blocks back
together.  The pooled steps run the reference's serving rules as they are
(``group_layout_rules``): a slot holds the cache time shard ``kv_time``
gives it where the KV heads do not take the model axis (MLA latents, GQA
caches whose KV heads replicate) — over ``model``, or over ``data`` and
``model`` where the pool rows do not split over ``data`` — and its decode
attention returns the split partials of K1 (``decode_attention_partials``),
merged over the slots holding the other shards in time order.  Where the
query heads do not divide the model axis the rules take the ``head_dim``
fallback: each slot projects its head_dim columns of q/k/v, the model row
gathers them whole (K/V replicate), and each slot's ``wo`` rows give a
partial sum of the output, added over the row.

Training over a group (``training.make_train_step(..., sh=)``) runs the
reference's training rules through ``make_ctx``: a :class:`ShardingCtx`
of the mesh and ``make_rules`` at a train shape, which puts the batch on
``data``, heads / MLP / vocab on ``model`` and ``embed_fsdp`` (ZeRO-3) on
``data``.  ``batch_specs``, ``cache_specs``, ``cache_shardings`` and
``param_shardings`` give each leaf's per-slot spec beside a meta tensor of
its whole shape; ``param_axes`` is the reference's axes tree of a whole
model.  The three layout rules of the activations run as the reference
lays them out, in training and in the group forms of ``prefill`` /
``decode_step`` alike (``models.layers.GroupCtx.at_seq`` takes the
guard's outcome on the activations' shapes): ``seq_act`` keeps each
slot's sequence block of the residual stream between blocks (an
all-gather over the model row before a mixer or an FFN, a reduce-scatter
after the row-split output projection); ``attn_seq_q`` has each slot
attend its block of the query rows over the whole K/V; the ``head_dim``
fallback splits the attention weights' head_dim over ``model``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec


def _div(a: int, b: int) -> bool:
    return b > 0 and a > 0 and a % b == 0


def make_rules(cfg: ModelConfig, mesh, shape: ShapeSpec) -> Dict[str, object]:
    """The reference's ``make_rules``: logical axis -> mesh axis (or None)
    for one (config, mesh, shape) cell."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    model = sizes.get("model", 1)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    n_data = int(np.prod([sizes[a] for a in data_axes])) if data_axes else 1
    is_train = shape.kind == "train"

    gb = shape.global_batch
    if _div(gb, n_data):
        batch = data_axes if len(data_axes) > 1 else data_axes[0]
    elif _div(gb, sizes.get("data", 1)):
        batch = "data"
    else:
        batch = None

    # expert-rich archs: padded pure EP over (data, model); small-E archs:
    # experts over the data axes with TP'd expert FFNs
    from repro_torch.models.moe import expert_alloc

    E = cfg.n_experts
    if E and expert_alloc(E) != E:
        experts = ("data", "model")
    elif _div(E, n_data):
        experts = data_axes if len(data_axes) > 1 else data_axes[0]
    elif _div(E, sizes.get("data", 1)):
        experts = "data"
    elif _div(E, model):
        experts = "model"
    else:
        experts = None

    def model_if(n):
        return "model" if _div(n, model) else None

    stash_bytes = (gb / max(1, n_data)) * shape.seq_len * cfg.d_model * 2 \
        * cfg.n_layers
    seq_act = (model_if(shape.seq_len)
               if (is_train and stash_bytes > 8e9) else None)
    if cfg.n_experts >= 64 and shape.kind == "prefill":
        seq_act = model_if(shape.seq_len)

    rules: Dict[str, object] = {
        "batch": batch,
        "seq": None,
        "seq_act": seq_act,
        "heads_act": model_if(cfg.n_heads),
        "attn_seq_q": (None if _div(cfg.n_heads, model)
                       else model_if(shape.seq_len)),
        "kv_heads_act": model_if(cfg.n_kv_heads),
        "mlp_act": "model",
        "expert_mlp_act": model_if(cfg.d_ff_expert),
        "inner_act": model_if(cfg.d_inner),
        "embed_fsdp": ((data_axes if len(data_axes) > 1 else data_axes[0])
                       if (is_train and data_axes) else None),
        "vocab": model_if(cfg.padded_vocab),
        "heads": model_if(cfg.n_heads),
        "kv_heads": model_if(cfg.n_kv_heads),
        "head_dim": (None if _div(cfg.n_heads, model)
                     else model_if(cfg.head_dim)),
        "qk_dim": None,
        "mlp": "model",
        "experts": experts,
        "expert_mlp": (None if experts == ("data", "model")
                       else model_if(cfg.d_ff_expert)),
        "qlora": None,
        "kvlora": None,
        "inner": model_if(cfg.d_inner),
        "ssm_heads": model_if(cfg.ssm_heads),
        "ssm_dim": None,
        "state_nosplit": None,
        "heads_x_dim": model_if(cfg.d_model if cfg.family == "ssm" else 0),
        "mix": None,
        "lora": None,
        "conv": None,
        "frame": None,
        "embed_nosplit": None,
        "inner_nosplit": None,
        "experts_nosplit": None,
        "layers": None,
    }
    if _div(gb, n_data):
        rules["kv_time"] = "model" if _div(shape.seq_len, model) else None
    else:
        full = tuple(data_axes) + ("model",)
        n_full = n_data * model
        if _div(shape.seq_len, n_full):
            rules["kv_time"] = full
        elif _div(shape.seq_len, model):
            rules["kv_time"] = "model"
        else:
            rules["kv_time"] = None
    if not _div(cfg.d_ff, model):
        rules["mlp"] = None
        rules["mlp_act"] = None
    return rules


def cache_axes_for(name: str, ndim: int, rules: Optional[Dict] = None):
    """Logical axes of a cache leaf, by name (and ndim for zamba2's mega
    segment).  When KV heads shard over "model" the time axis drops
    "model" (a spec uses each mesh axis once)."""
    rules = rules if rules is not None else {}
    time_ax = "kv_time"
    if rules.get("kv_heads_act") == "model":
        kv_time = rules.get("kv_time")
        axes = kv_time if isinstance(kv_time, tuple) else (kv_time,)
        remaining = tuple(a for a in axes if a not in (None, "model"))
        time_ax = ("kv_time_noverlap" if remaining else None)
        rules.setdefault("kv_time_noverlap", remaining or None)
    if name in ("k", "v"):  # (layers, B, T, Kv, hd)
        return (None, "batch", time_ax, "kv_heads_act", None)
    if name in ("ck", "cv"):  # cross-attention KV (encoder length)
        return (None, "batch", time_ax, "kv_heads_act", None)
    if name in ("latent", "krope"):  # (layers, B, T, r)
        return (None, "batch", "kv_time", None)
    if name == "wkv":  # (layers, B, h, hd, hd)
        return (None, "batch", "ssm_heads_act", None, None)
    if name in ("shift_tm", "shift_cm"):  # (layers, B, d)
        return (None, "batch", None)
    if name == "ssm":  # (layers[, per], B, h, p, n)
        if ndim == 6:
            return (None, None, "batch", "ssm_heads_act", None, None)
        return (None, "batch", "ssm_heads_act", None, None)
    if name == "conv":  # (layers[, per], B, w-1, conv_dim)
        if ndim == 5:
            return (None, None, "batch", None, None)
        return (None, "batch", None, None)
    return (None,) * ndim


def _map_named(fn, tree, name=None):
    """Map ``fn(name, leaf)`` over a nested dict / tuple / list tree; a
    leaf's name is its innermost dict key."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_named(fn, v, name) for v in tree)
    if tree is None:
        return None
    return fn(name, tree)


def cache_tree_axes(tree, rules=None):
    """A cache tree's logical-axes tuples, by leaf name."""
    return _map_named(lambda n, x: cache_axes_for(n, x.dim(), rules), tree)


class ShardingCtx:
    """A mesh and its rules (logical axis -> mesh axes): the counterpart of
    the reference's ``ShardingCtx``.  ``mesh`` None is the solo twin
    (``NULL_SH``); ``cfg`` is the config the rules were made for;
    ``stand_in``: a group step runs slot 0's body for every slot
    (``models.layers.GroupCtx``; the dry run's count)."""

    def __init__(self, mesh=None, rules: Optional[Dict[str, object]] = None,
                 cfg: Optional[ModelConfig] = None, stand_in: bool = False):
        self.mesh = mesh
        self.rules = dict(rules or {})
        self.cfg = cfg
        self.stand_in = stand_in

    def spec(self, axes, shape) -> tuple:
        """The per-dimension mesh axes of a leaf of ``shape`` whose logical
        axes are ``axes`` (:func:`guarded_spec`; all None solo)."""
        if self.mesh is None:
            return (None,) * len(shape)
        return guarded_spec(axes, tuple(shape), self.rules, self.mesh)


NULL_SH = ShardingCtx()


def make_ctx(cfg: ModelConfig, mesh, shape: ShapeSpec,
             stand_in: bool = False) -> ShardingCtx:
    """The reference's ``make_ctx``: the mesh and ``make_rules`` of (cfg,
    mesh, shape)."""
    return ShardingCtx(mesh, make_rules(cfg, mesh, shape), cfg, stand_in)


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, sh: ShardingCtx):
    """{name: (meta tensor of the whole batch leaf, its per-slot spec)} of
    a train / prefill batch: tokens (B, S), and the frames of an enc-dec
    stack, rows over the ``batch`` rule."""
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": _meta((B, S), torch.int32)}
    if cfg.is_enc_dec:
        out = {"frames": _meta((B, S, cfg.frame_dim), torch.float32),
               "tokens": out["tokens"]}
    return {k: (x, sh.spec(("batch",) + (None,) * (x.dim() - 1), x.shape))
            for k, x in out.items()}


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, sh: ShardingCtx,
                enc_len: Optional[int] = None):
    """The decode cache tree of a cell as (meta tensor, per-slot spec)
    pairs, by leaf name (:func:`cache_axes_for`)."""
    from repro_torch.models.model import init_decode_caches

    caches = init_decode_caches(cfg, shape.global_batch, shape.seq_len,
                                enc_len=enc_len, device="meta")
    specs = cache_shardings(cfg, sh, caches)
    return _zip_trees(caches, specs)


def cache_shardings(cfg: ModelConfig, sh: ShardingCtx, cache_shape_tree):
    """Per-slot spec tree of a cache tree (tensors or meta tensors), by
    leaf name under ``sh``'s rules."""
    rules = dict(sh.rules)  # cache_axes_for may add kv_time_noverlap
    return _map_named(lambda n, x: guarded_spec(
        cache_axes_for(n, x.dim(), rules), tuple(x.shape), rules, sh.mesh),
        cache_shape_tree)


def _zip_trees(a, b):
    if isinstance(a, dict):
        return {k: _zip_trees(a[k], b[k]) for k in a}
    return (a, b)


def param_axes(cfg: ModelConfig, params):
    """Logical-axes tree of a whole model's params (the reference's
    ``init_params(...)[1]``): the embedding's, each segment's stacked
    blocks' (a zamba2 mega segment's leaves carry two stacked axes) and
    zamba2's shared block's."""
    from repro_torch.models.model import stack_plan

    out = {"embed": embed_param_axes(params["embed"]), "segments": {}}
    for seg in stack_plan(cfg):
        tree = params["segments"][seg.name]
        if seg.kind == "mega":
            axes = block_param_axes(cfg, "mamba", tree["mamba"])
            out["segments"][seg.name] = {"mamba": {
                par: {n: ("layers",) + a for n, a in sub.items()}
                for par, sub in axes.items()}}
        else:
            kind = {"mamba": "mamba", "rwkv": "rwkv", "enc": "enc",
                    "dec": "dec", "lead": "lead"}.get(seg.kind, "decoder")
            out["segments"][seg.name] = block_param_axes(cfg, kind, tree)
    if "shared" in params:
        out["shared"] = shared_param_axes(cfg, params["shared"])
    return out


def param_shardings(cfg: ModelConfig, sh: ShardingCtx, axes_tree,
                    params=None):
    """Per-slot spec tree of a whole model's params: each leaf's logical
    axes (``axes_tree``, :func:`param_axes`) through :func:`guarded_spec`
    against its shape (``params``: tensors or meta tensors; default the
    config's params on the meta device)."""
    from repro_torch.models.model import init_params

    if params is None:
        params = init_params(cfg, None, "meta")
    return _map_axes(lambda ax, x: sh.spec(ax, x.shape), axes_tree, params)


def shard_params(cfg: ModelConfig, sh: ShardingCtx, params):
    """Per-slot trees of a whole model's ``params`` under ``sh``'s rules:
    each leaf's block (:func:`shard`, on its slot's device) by its spec
    (:func:`param_shardings` of :func:`param_axes`); slot 0's alone under
    ``sh.stand_in``."""
    specs = param_shardings(cfg, sh, param_axes(cfg, params), params)
    out = [{} for _ in slot_devices(sh)]

    def put(dsts, tree, spec):
        for k, v in tree.items():
            if isinstance(v, dict):
                put([d.setdefault(k, {}) for d in dsts], v, spec[k])
            else:
                for d, blk in zip(dsts, shard(v, spec[k], sh.mesh,
                                              sh.stand_in)):
                    d[k] = blk

    put(out, params, specs)
    return out


def _map_axes(fn, axes_tree, tree):
    if isinstance(tree, dict):
        return {k: _map_axes(fn, axes_tree[k], v) for k, v in tree.items()}
    return fn(axes_tree, tree)


def fsdp_dim(axes, spec) -> Optional[int]:
    """The dim of a leaf that ``embed_fsdp`` splits (None where the rules or
    the guard keep it whole)."""
    for d, (a, e) in enumerate(zip(axes, spec)):
        if a == "embed_fsdp" and e is not None:
            return d
    return None


def replica_slots(mesh, spec, slot: int):
    """The slots holding the same block of a leaf as ``slot`` under
    ``spec`` (those that agree with it on every mesh axis the spec uses),
    in slot order."""
    used = set()
    for e in spec:
        if e is not None:
            used.update(e if isinstance(e, tuple) else (e,))
    shape = mesh.devices.shape
    me = np.unravel_index(int(slot), shape)
    grid = np.indices(shape).reshape(len(shape), -1)
    ok = np.ones(grid.shape[1], dtype=bool)
    for k, a in enumerate(mesh.axis_names):
        if a in used:
            ok &= grid[k] == me[k]
    return [int(t) for t in np.flatnonzero(ok)]


# ---------------------------------------------------------------------------
# Serving-path rules: a geo server as a TP/EP device group
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceGroup:
    """One server's TP/EP device group: a mesh and its frozen serving
    rules (the reference's).  ``mesh=None`` is the solo twin; ``rules=None``
    derives :func:`serving_rules` from the server's (n_rows, max_len).
    Hashable."""

    mesh: object = None
    rules: object = None

    def __post_init__(self):
        if self.mesh is not None and not (hasattr(self.mesh, "devices")
                                          and hasattr(self.mesh,
                                                      "axis_names")):
            raise TypeError(f"a device group's mesh is a GroupMesh "
                            f"(launch.mesh), not "
                            f"{type(self.mesh).__name__}")
        if self.rules is not None and not isinstance(self.rules, tuple):
            object.__setattr__(self, "rules", freeze_rules(dict(self.rules)))

    @property
    def devices(self) -> tuple:
        """The group's slot devices (empty for the solo twin)."""
        if self.mesh is None:
            return ()
        return tuple(self.mesh.devices.reshape(-1))

    @property
    def n_chips(self) -> int:
        """Slot count the τ roofline divides by (1 for the solo twin)."""
        return int(self.mesh.devices.size) if self.mesh is not None else 1

    def frozen_rules_for(self, cfg: ModelConfig, n_rows: int, max_len: int):
        if self.mesh is None:
            return None
        if self.rules is not None:
            return self.rules
        return frozen_serving_rules(cfg, self.mesh, int(n_rows),
                                    int(max_len))


def as_device_group(group) -> DeviceGroup:
    """``None`` | mesh | :class:`DeviceGroup` -> DeviceGroup (``TypeError``
    for anything else)."""
    if group is None:
        return DeviceGroup()
    if isinstance(group, DeviceGroup):
        return group
    return DeviceGroup(mesh=group)


@functools.lru_cache(maxsize=None)
def frozen_serving_rules(cfg: ModelConfig, mesh, n_rows: int, max_len: int):
    """Frozen :func:`serving_rules`, cached per (cfg, mesh, n_rows,
    max_len)."""
    return freeze_rules(serving_rules(cfg, mesh, n_rows, max_len))


def serving_rules(cfg: ModelConfig, mesh, n_rows: int,
                  max_len: int) -> Dict[str, object]:
    """Rules of the serving hot path: a decode cell whose batch is the
    pool's row count; no sequence-activation sharding."""
    shape = ShapeSpec("serving_decode", max(1, int(max_len)),
                      max(1, int(n_rows)), "decode")
    rules = make_rules(cfg, mesh, shape)
    rules["seq_act"] = None
    rules["attn_seq_q"] = None
    return rules


def freeze_rules(rules: Optional[Dict[str, object]]):
    """Canonical hashable form of a rules dict."""
    if rules is None:
        return None
    return tuple(sorted(rules.items()))


def thaw_rules(frozen) -> Dict[str, object]:
    return {} if frozen is None else dict(frozen)


def group_layout_rules(rules: Dict[str, object]) -> Dict[str, object]:
    """The layout the port's group steps run: the reference's serving
    ``rules`` unchanged, the ``head_dim`` fallback included (each slot
    projects its head_dim columns; ``models.attention``)."""
    return dict(rules)


def guarded_spec(axes, shape, rules: Dict[str, object], mesh) -> tuple:
    """Per-dimension mesh axes of one leaf: logical axes -> mesh axes, any
    dim whose mesh extent does not divide it replicated, a mesh axis never
    used twice."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    used = set()
    spec = []
    for dim, logical in zip(shape, axes):
        mesh_ax = rules.get(logical) if logical else None
        if mesh_ax is None:
            spec.append(None)
            continue
        ax_tuple = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
        ax_tuple = tuple(a for a in ax_tuple
                         if a is not None and a not in used)
        extent = int(np.prod([sizes.get(a, 1) for a in ax_tuple])) \
            if ax_tuple else 1
        if not ax_tuple or not _div(int(dim), extent):
            spec.append(None)
            continue
        used.update(ax_tuple)
        spec.append(ax_tuple if len(ax_tuple) > 1 else ax_tuple[0])
    return tuple(spec)


def pool_tree_shardings(mesh, rules: Dict[str, object], pool_trees):
    """Spec tree of a CachePool's state trees (slab or paged): per-leaf
    logical axes (:func:`cache_axes_for`) through :func:`guarded_spec`."""
    rules = dict(rules)  # cache_axes_for may add the kv_time_noverlap rule

    def one(name, leaf):
        axes = cache_axes_for(name, leaf.dim(), rules)
        return guarded_spec(axes, tuple(leaf.shape), rules, mesh)

    return _map_named(one, pool_trees)


# logical axes of a decoder block's leaves (the reference's init axes),
# keyed by (parent, leaf); stacked leaves prepend the "layers" axis
_DECODER_AXES = {
    ("ln1", "scale"): ("embed_nosplit",),
    ("ln1", "bias"): ("embed_nosplit",),
    ("ln2", "scale"): ("embed_nosplit",),
    ("ln2", "bias"): ("embed_nosplit",),
    ("post_ln1", "scale"): ("embed_nosplit",),
    ("post_ln2", "scale"): ("embed_nosplit",),
    # GQA
    ("attn", "wq"): ("embed_fsdp", "heads", "head_dim"),
    ("attn", "wk"): ("embed_fsdp", "kv_heads", "head_dim"),
    ("attn", "wv"): ("embed_fsdp", "kv_heads", "head_dim"),
    ("attn", "bq"): ("heads", "head_dim"),
    ("attn", "bk"): ("kv_heads", "head_dim"),
    ("attn", "bv"): ("kv_heads", "head_dim"),
    ("attn", "k_norm"): ("head_dim",),
    # MLA ("attn", "wo") and ("attn", "q_norm") differ by attention kind
    ("attn", "wdq"): ("embed_fsdp", "qlora"),
    ("attn", "wuq"): ("qlora", "heads", "qk_dim"),
    ("attn", "wdkv"): ("embed_fsdp", "kvlora"),
    ("attn", "kv_norm"): ("kvlora",),
    ("attn", "wuk"): ("kvlora", "heads", "qk_dim"),
    ("attn", "wuv"): ("kvlora", "heads", "qk_dim"),
    # dense MLP
    ("ffn", "wi"): ("embed_fsdp", "mlp"),
    # MoE
    ("ffn", "router"): ("embed_nosplit", "experts_nosplit"),
    ("ffn", "swg"): ("embed_fsdp", "mlp"),
    ("ffn", "swu"): ("embed_fsdp", "mlp"),
    ("ffn", "swo"): ("mlp", "embed_fsdp"),
}


# RWKV6 time mix / channel mix and Mamba2 mixer leaves (the reference's
# ``models/ssm.py`` init axes)
_RWKV_TM_AXES = {
    "mu_x": ("embed_nosplit",), "mu": ("mix", "embed_nosplit"),
    "mix_A": ("embed_nosplit", "lora"),
    "mix_B": ("mix", "lora", "embed_nosplit"),
    "wr": ("embed_fsdp", "heads_x_dim"), "wk": ("embed_fsdp", "heads_x_dim"),
    "wv": ("embed_fsdp", "heads_x_dim"), "wg": ("embed_fsdp", "heads_x_dim"),
    "w0": ("embed_nosplit",), "w_A": ("embed_nosplit", "lora"),
    "w_B": ("lora", "embed_nosplit"), "u": ("ssm_heads", "ssm_dim"),
    "out_norm": ("embed_nosplit",), "wo": ("heads_x_dim", "embed_fsdp"),
}
_RWKV_CM_AXES = {
    "mu_k": ("embed_nosplit",), "mu_r": ("embed_nosplit",),
    "wk": ("embed_fsdp", "mlp"), "wv": ("mlp", "embed_fsdp"),
    "wr": ("embed_fsdp", "embed_nosplit"),
}
_MAMBA_AXES = {
    "wz": ("embed_fsdp", "inner"), "wx": ("embed_fsdp", "inner"),
    "wB": ("embed_fsdp", "state_nosplit"),
    "wC": ("embed_fsdp", "state_nosplit"),
    "wdt": ("embed_fsdp", "ssm_heads"), "conv_w": ("conv", "inner_nosplit"),
    "conv_b": ("inner_nosplit",), "dt_bias": ("ssm_heads",),
    "A_log": ("ssm_heads",), "D": ("ssm_heads",),
    "norm": ("inner_nosplit",), "out_proj": ("inner", "embed_fsdp"),
}
# the parents of the other block kinds that are a decoder's in another name
_AS_DECODER = {"self_attn": "attn", "cross_attn": "attn", "ln_cross": "ln1",
               "ln": "ln1"}


def _decoder_leaf_axes(cfg: ModelConfig, parent: str, name: str):
    parent = _AS_DECODER.get(parent, parent)
    if parent == "attn" and name == "wo":
        return (("heads", "qk_dim", "embed_fsdp") if cfg.attn_kind == "mla"
                else ("heads", "head_dim", "embed_fsdp"))
    if parent == "attn" and name == "q_norm":
        return ("qlora",) if cfg.attn_kind == "mla" else ("head_dim",)
    if parent == "ffn" and name in ("wg", "wu", "wo"):
        if cfg.is_moe:
            return (("experts", "expert_mlp", "embed_nosplit") if name == "wo"
                    else ("experts", "embed_nosplit", "expert_mlp"))
        return (("mlp", "embed_fsdp") if name == "wo"
                else ("embed_fsdp", "mlp"))
    return _DECODER_AXES[(parent, name)]


def _leaf_axes(cfg: ModelConfig, parent: str, name: str):
    if parent == "tm":
        return _RWKV_TM_AXES[name]
    if parent == "cm":
        return _RWKV_CM_AXES[name]
    if parent == "mixer":
        return _MAMBA_AXES[name]
    return _decoder_leaf_axes(cfg, parent, name)


BLOCK_KINDS = ("decoder", "lead", "rwkv", "mamba", "mamba_shared", "enc",
               "dec")


def block_param_axes(cfg: ModelConfig, kind: str, tree):
    """Logical-axes tree of a server's stacked params of one kind (the
    reference's ``models.model.block_param_axes``): every leaf's init axes
    with the stacked ``layers`` axis first."""
    if kind not in BLOCK_KINDS:
        raise ValueError(f"unknown block kind {kind!r}; supported: "
                         + ", ".join(BLOCK_KINDS))
    if kind == "lead":  # a leading dense decoder block
        cfg = cfg.lead_config()
    return {parent: {name: ("layers",) + _leaf_axes(cfg, parent, name)
                     for name in sub}
            for parent, sub in tree.items()}


def shared_param_axes(cfg: ModelConfig, tree):
    """Logical axes of zamba2's parameter-shared attention block (one set
    of params, no layers axis): a GQA attention and an MLP at width
    2 * d_model, as the reference's ``init_zamba_shared``."""
    return {parent: {name: _decoder_leaf_axes(cfg, parent, name)
                     for name in sub}
            for parent, sub in tree.items()}


def block_param_shardings(mesh, rules: Dict[str, object], axes_tree,
                          param_tree):
    """Spec tree of a server's stacked block params: the axes tree through
    :func:`guarded_spec` against the leaf shapes."""
    return {parent: {name: guarded_spec(axes_tree[parent][name],
                                        tuple(x.shape), rules, mesh)
                     for name, x in sub.items()}
            for parent, sub in param_tree.items()}


def embed_param_axes(tree):
    """Logical axes of the embedding tree (token table, untied head, final
    norm) — the reference's ``init_embedding`` axes."""
    table = {"tok": ("vocab", "embed_nosplit"), "head": ("embed_fsdp", "vocab"),
             "frame_proj": ("frame", "embed_nosplit")}
    return {k: (table[k] if k in table
                else {n: ("embed_nosplit",) for n in v})
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Slot blocks of a leaf
# ---------------------------------------------------------------------------


def _coords(mesh, slot: int) -> Dict[str, int]:
    idx = np.unravel_index(int(slot), mesh.devices.shape)
    return dict(zip(mesh.axis_names, (int(i) for i in idx)))


def _block(entry, coords, sizes):
    """(block index, block count) of one spec entry at a slot."""
    axes = entry if isinstance(entry, tuple) else (entry,)
    b, n = 0, 1
    for a in axes:
        b = b * sizes[a] + coords[a]
        n *= sizes[a]
    return b, n


def slot_index(x_shape, spec, mesh, slot: int):
    """The index (a tuple of slices) of slot ``slot``'s block of a leaf of
    shape ``x_shape`` under ``spec``."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    coords = _coords(mesh, slot)
    idx = []
    for d, dim in enumerate(x_shape):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            idx.append(slice(None))
            continue
        b, n = _block(entry, coords, sizes)
        w = dim // n
        idx.append(slice(b * w, (b + 1) * w))
    return tuple(idx)


def slot_devices(sh: ShardingCtx):
    """The devices of the slots a group step of ``sh`` runs: every slot's,
    or slot 0's alone under ``sh.stand_in``."""
    devs = sh.mesh.slot_devices()
    return devs[:1] if sh.stand_in else devs


def shard(x: torch.Tensor, spec, mesh, stand_in: bool = False):
    """Per-slot blocks of ``x`` under ``spec``: slot ``s``'s block on its
    device (slot 0's alone with ``stand_in``).  A block on the device
    ``x`` already lives on is a view of ``x`` (slots that share a device
    share a replicated leaf); on another device it is a copy."""
    out = []
    for s, dev in enumerate(mesh.slot_devices()[:1] if stand_in
                            else mesh.slot_devices()):
        out.append(x[slot_index(tuple(x.shape), spec, mesh, s)].to(dev))
    return out


def unshard(parts, spec, mesh, shape) -> torch.Tensor:
    """The inverse of :func:`shard`: the whole leaf of ``shape`` from its
    per-slot blocks (replicas must agree; the last slot's copy wins), on
    slot 0's device."""
    dev = parts[0].device
    full = parts[0].new_empty(tuple(shape))
    for s, p in enumerate(parts):
        full[slot_index(tuple(shape), spec, mesh, s)] = p.to(dev)
    return full


__all__ = [
    "DeviceGroup", "NULL_SH", "ShardingCtx", "as_device_group",
    "batch_specs", "block_param_axes", "block_param_shardings",
    "cache_axes_for", "cache_shardings", "cache_specs", "cache_tree_axes",
    "embed_param_axes",
    "freeze_rules", "frozen_serving_rules", "fsdp_dim",
    "group_layout_rules", "guarded_spec", "make_ctx", "make_rules",
    "param_axes", "param_shardings", "pool_tree_shardings",
    "replica_slots", "serving_rules", "shard", "shard_params",
    "shared_param_axes", "slot_devices", "slot_index", "thaw_rules",
    "unshard",
]
