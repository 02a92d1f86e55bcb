"""Foundational layers: param init helpers, norms, RoPE/ALiBi, embedding,
LM head and MLP — the counterparts of the reference's
``repro/models/layers.py``, as plain functions on tensors.

``params`` is a nested dict of tensors under the reference's tree paths.
Where the reference threads a ``ShardingCtx`` through every function and
lets XLA partition the program, a device-group server here runs the same
functions on each slot's shard and joins the slots with the explicit
collectives of :class:`GroupCtx` (``NULL`` for a solo server): partial
sums added in slot order, vocab shards concatenated; under ``seq_act``
the residual stream holds each slot's sequence block, gathered before a
mixer or an FFN (:func:`gather_seq`) and reduce-scattered after
(:func:`reduce_out`); :meth:`GroupCtx.exchange` moves a tensor from one
split over the model row to another (the ``head_dim`` columns of the
attention <-> its query rows).
"""
from __future__ import annotations

import contextlib
import contextvars
import copy
import functools
import itertools
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.costs import collective_ops

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name ("bfloat16", "float32")."""
    return _DTYPES[name]


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


# ---------------------------------------------------------------------------
# Param creation (torch twin of the reference's init, drawn from a
# torch.Generator: same tree, shapes, dtypes and scales, other values)
# ---------------------------------------------------------------------------


# a leaf above this many elements is drawn in f32 slices of at most
# _DRAW_SLICE elements and cast slice by slice, so its f32 draw never sits
# whole beside the cast copy (deepseek's stacked experts: 32 GB in f32)
_DRAW_WHOLE = 1 << 31
_DRAW_SLICE = 1 << 28


class ParamBuilder:
    """Collects named leaves drawn from one ``torch.Generator``.

    ``dense`` draws a truncated normal on [-2, 2] times ``scale`` (default
    1/sqrt(fan_in)) in f32 on the generator's device, then casts and moves
    the leaf to ``device`` — the reference's ``dense_init`` (leaves above
    ``_DRAW_WHOLE`` elements slice by slice); without a generator
    (``gen`` None, e.g. on the meta device) it draws on ``device``.
    ``lead`` prepends stacked dims (the layer axis of a segment) to every
    leaf; the fan-in stays the per-layer one, as the reference's vmapped
    init."""

    def __init__(self, gen: torch.Generator, device, lead=()):
        self.gen = gen
        self.device = torch.device(device)
        self.lead = tuple(lead)
        self.params: Dict[str, object] = {}

    def dense(self, name, shape: Sequence[int], dtype, scale=None):
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
        scale = scale if scale is not None else 1.0 / math.sqrt(max(1, fan_in))
        full = self.lead + tuple(shape)
        if self.device.type == "meta":  # shapes only: nothing to draw
            self.params[name] = torch.empty(full, dtype=dtype,
                                            device=self.device)
            return
        if math.prod(full) <= _DRAW_WHOLE:
            self.params[name] = self._draw(full, scale).to(
                device=self.device, dtype=dtype)
            return
        out = torch.empty(full, dtype=dtype, device=self.device)
        rows = out.view(-1, full[-1])
        step = max(1, _DRAW_SLICE // full[-1])
        for i in range(0, rows.shape[0], step):
            n = min(step, rows.shape[0] - i)
            rows[i:i + n] = self._draw((n, full[-1]), scale).to(
                device=self.device, dtype=dtype)
        self.params[name] = out

    def _draw(self, shape, scale):
        dev = self.device if self.gen is None else self.gen.device
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=self.gen)
        return w.mul_(scale)

    def zeros(self, name, shape, dtype):
        self.params[name] = torch.zeros(self.lead + tuple(shape), dtype=dtype,
                                        device=self.device)

    def ones(self, name, shape, dtype):
        self.params[name] = torch.ones(self.lead + tuple(shape), dtype=dtype,
                                       device=self.device)

    def const(self, name, value: torch.Tensor):
        """A fixed f32 leaf (the reference's ``pb.const``), repeated over
        the stacked lead dims."""
        value = value.to(device=self.device, dtype=torch.float32)
        self.params[name] = value.expand(self.lead + tuple(value.shape)) \
            .clone()

    def sub(self, name, init_fn, *args, **kw):
        self.params[name] = init_fn(self, *args, **kw)

    def child(self) -> "ParamBuilder":
        return ParamBuilder(self.gen, self.device, self.lead)


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------


def init_norm(pb: ParamBuilder, cfg: ModelConfig, width: Optional[int] = None):
    d = width or cfg.d_model
    c = pb.child()
    if cfg.norm_kind in ("rmsnorm", "layernorm"):
        c.ones("scale", (d,), torch.float32)
    if cfg.norm_kind == "layernorm":
        c.zeros("bias", (d,), torch.float32)
    return c.params


def apply_norm(params, cfg: ModelConfig, x):
    """Normalisation with f32 statistics but element ops in x.dtype (the
    reference's choice: no full-width f32 copy of the residual stream)."""
    d = x.shape[-1]
    if cfg.norm_kind == "rmsnorm":
        xf = x.float()
        inv = torch.rsqrt((xf * xf).sum(-1) / d + cfg.norm_eps)
        return x * inv[..., None].to(x.dtype) * params["scale"].to(x.dtype)
    mean = x.float().sum(-1) / d
    centered = x - mean[..., None].to(x.dtype)
    cf = centered.float()
    var = (cf * cf).sum(-1) / d
    out = centered * torch.rsqrt(var + cfg.norm_eps)[..., None].to(x.dtype)
    if cfg.norm_kind == "layernorm":
        out = out * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)
    return out


def rms_norm_simple(x, scale, eps=1e-6):
    xf = x.float()
    inv = torch.rsqrt((xf * xf).sum(-1) / x.shape[-1] + eps)
    return x * inv[..., None].to(x.dtype) * scale.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary / ALiBi positions
# ---------------------------------------------------------------------------


def rope_angles(positions, dim: int, theta: float):
    """cos/sin tables (f32) for ``positions`` (any shape — (S,) for a
    shared arange, (B, S) for per-row positions), rotating ``dim`` dims."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / torch.pow(float(theta), exps)  # f32 pow, no host tensor
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def yarn_correction_range(dim: int, theta: float, original: int,
                          beta_fast: float, beta_slow: float):
    """YaRN's (low, high) rope dims: ``floor(d(beta_fast))`` and
    ``ceil(d(beta_slow))``, clamped into [0, dim - 1], with ``d(r) = dim
    ln(original / (2 pi r)) / (2 ln theta)`` the dim that turns ``r``
    times over the original context."""
    def d(r):
        return dim * math.log(original / (r * 2 * math.pi)) / \
            (2 * math.log(theta))
    return (max(math.floor(d(beta_fast)), 0),
            min(math.ceil(d(beta_slow)), dim - 1))


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN's attention factor ``0.1 mscale ln(scale) + 1`` (1 for
    ``scale <= 1``)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


@functools.lru_cache(maxsize=None)
def _yarn_inv_freq(dim: int, theta: float, factor: float, original: int,
                   beta_fast: float, beta_slow: float, device: str):
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / torch.pow(float(theta), exps)
    inter = 1.0 / (factor * torch.pow(float(theta), exps))
    low, high = yarn_correction_range(dim, theta, original, beta_fast,
                                      beta_slow)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    m = 1.0 - ramp  # 1: the extrapolated (original) frequency
    return (inter * (1 - m) + extra * m).to(device)


def yarn_inv_freq(dim: int, theta: float, factor: float, original: int,
                  beta_fast: float, beta_slow: float, device=None):
    """YaRN's rope frequencies: ``inter (1 - m) + extra m`` per rotated
    pair ``i``, ``extra = theta^(-2i/dim)``, ``inter = extra / factor``,
    ``m = 1 - clamp((i - low) / (high - low), 0, 1)``
    (:func:`yarn_correction_range`).  (dim/2,) f32, built once per
    device."""
    return _yarn_inv_freq(dim, float(theta), float(factor), int(original),
                          float(beta_fast), float(beta_slow),
                          str(torch.device(device or "cpu")))


def cfg_rope_angles(cfg: ModelConfig, positions, dim: int):
    """cos/sin tables of ``dim`` rope dims under the config: plain RoPE at
    ``rope_theta``, or with ``yarn_factor`` set YaRN's frequencies, the
    tables times ``mscale(factor, yarn_mscale) / mscale(factor,
    yarn_mscale_all_dim)``."""
    if not cfg.yarn_factor:
        return rope_angles(positions, dim, cfg.rope_theta)
    freqs = yarn_inv_freq(dim, cfg.rope_theta, cfg.yarn_factor,
                          cfg.yarn_original_max_pos, cfg.yarn_beta_fast,
                          cfg.yarn_beta_slow, positions.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    m = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale) / \
        yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
    if m == 1.0:
        return torch.cos(ang), torch.sin(ang)
    return torch.cos(ang) * m, torch.sin(ang) * m


def apply_rope(x, cos, sin):
    """x: (..., S, H, D); cos/sin: (..., S, D/2) broadcast over heads.
    Tables in f32, rotation in x.dtype."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


@functools.lru_cache(maxsize=None)
def _alibi_slopes(n_heads: int, device: str):
    return torch.as_tensor(_alibi_numpy(n_heads), device=device)


def alibi_slopes(n_heads: int, device=None):
    """Standard ALiBi geometric slopes (BLOOM), (H,) f32 — built once per
    device, so the attention calls copy nothing from the host."""
    return _alibi_slopes(n_heads, str(torch.device(device or "cpu")))


def _alibi_numpy(n_heads: int):
    p = 2 ** int(np.floor(np.log2(n_heads)))
    base = 2.0 ** (-8.0 / p)
    slopes = base ** np.arange(1, p + 1)
    if p < n_heads:
        extra_base = 2.0 ** (-4.0 / p)
        extra = extra_base ** np.arange(1, 2 * (n_heads - p) + 1, 2)
        slopes = np.concatenate([slopes, extra])
    return slopes.astype(np.float32)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def init_embedding(pb: ParamBuilder, cfg: ModelConfig):
    c = pb.child()
    dt = param_dtype(cfg)
    c.dense("tok", (cfg.padded_vocab, cfg.d_model), dt, scale=1.0)
    if cfg.frontend == "frames":
        c.dense("frame_proj", (cfg.frame_dim, cfg.d_model), dt)
    if not cfg.tie_embeddings:
        c.dense("head", (cfg.d_model, cfg.padded_vocab), dt)
    c.sub("final_norm", init_norm, cfg)
    return c.params


def embed_tokens(params, cfg: ModelConfig, tokens):
    return F.embedding(tokens, params["tok"])


def embed_frames(params, cfg: ModelConfig, frames):
    """Encoder input: precomputed frames (B, S_enc, frame_dim), cast to the
    param dtype, through ``frame_proj`` (the speech front end is a stub, as
    in the reference)."""
    return frames.to(param_dtype(cfg)) @ params["frame_proj"]


def vocab_pad_bias(cfg: ModelConfig, device=None):
    """Additive bias masking padded vocab columns (finite -1e30)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return None
    idx = torch.arange(cfg.padded_vocab, device=device)
    return torch.where(idx < cfg.vocab_size, 0.0, -1e30).to(torch.float32)


def lm_head(params, cfg: ModelConfig, h, vocab_chunk: Optional[int] = None):
    """Logits of ``h``.  ``vocab_chunk``: the weight is cast to ``h``'s
    dtype that many vocabulary columns at a time (a whole cast copy of
    BLOOM's tied 250880-column table in f32 takes 13.4 GiB)."""
    h = apply_norm(params["final_norm"], cfg, h)
    w = params["tok"].t() if cfg.tie_embeddings else params["head"]
    if vocab_chunk is None:
        logits = torch.matmul(h, w.to(h.dtype))
    else:
        logits = torch.cat([torch.matmul(h, w[:, i:i + vocab_chunk]
                                         .to(h.dtype))
                            for i in range(0, w.shape[1], vocab_chunk)],
                           dim=-1)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    pad = vocab_pad_bias(cfg, h.device)
    if pad is not None:
        logits = logits + pad.to(logits.dtype)
    return logits


# ---------------------------------------------------------------------------
# Gated / plain MLP
# ---------------------------------------------------------------------------


def init_mlp(pb: ParamBuilder, cfg: ModelConfig, width: Optional[int] = None,
             d_ff: Optional[int] = None):
    d = width or cfg.d_model
    f = d_ff or cfg.d_ff
    c = pb.child()
    dt = param_dtype(cfg)
    if cfg.norm_kind == "layernorm":  # plain gelu MLP
        c.dense("wi", (d, f), dt)
        c.dense("wo", (f, cfg.d_model), dt)
    else:  # gated silu (SwiGLU)
        c.dense("wg", (d, f), dt)
        c.dense("wu", (d, f), dt)
        c.dense("wo", (f, cfg.d_model), dt)
    return c.params


def apply_mlp(params, cfg: ModelConfig, x):
    if "wi" in params:
        h = F.gelu(x @ params["wi"].to(x.dtype), approximate="tanh")
        return h @ params["wo"].to(x.dtype)
    g = F.silu(x @ params["wg"].to(x.dtype))
    u = x @ params["wu"].to(x.dtype)
    return (g * u) @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# Device groups: one slot's view of its group, and the slot collectives
# ---------------------------------------------------------------------------


class GroupCtx:
    """One slot of a device group (``launch.mesh.GroupMesh``): its device
    and its mesh coordinates — the counterpart of the reference's
    ``ShardingCtx``.  ``NULL`` is the solo server's.  A mesh is ``(data,
    model)`` or, over several pods, ``(pod, data, model)``; ``i`` and ``j``
    are the slot's data and model index (0 on an axis the mesh lacks).

    The group's slots run in lockstep in one process, so a collective
    takes the peers' tensors as a list in slot order and returns this
    slot's result on its own device: copies are ``non_blocking`` and
    nothing reads a value on the host.  Inside :func:`count_collectives`
    each call adds its per-slot wire bytes by the ring model of the
    reference's ``parse_collectives``.

    ``stand_in``: the group runs this one slot's body for every slot (the
    dry run's count at 256 / 512 slots): the per-slot lists hold its
    tensors alone, and they stand in for every peer's in a collective
    (:meth:`peers`).  Every slot of a cell has the same shard shapes, so
    the collectives move what they would.

    ``seq`` and ``q_rows``: the slot's (block index, block count) of the
    positions of a full-sequence pass — of the residual stream under
    ``seq_act`` (Megatron-SP) and of the attention queries under
    ``attn_seq_q`` — (0, 1) where the rule or the guard keeps them whole
    (:meth:`at_seq` sets them for one pass; both rules name ``model``, so
    the blocks lie along the model row)."""

    seq = (0, 1)
    q_rows = (0, 1)

    def __init__(self, mesh=None, slot: int = 0, rules=None,
                 whole_time=(), stand_in: bool = False):
        self.mesh = mesh
        self.slot = int(slot)
        self.rules = dict(rules or {})
        self.stand_in = bool(stand_in)
        # cache leaves whose time axis a step holds whole whatever the rules
        # say (the paged steps' scratch of gathered whole pages)
        self.whole_time = frozenset(whole_time)
        if mesh is None:
            self.sizes, self.coords = {}, {}
            self.device = None
        else:
            shape = mesh.devices.shape
            idx = np.unravel_index(self.slot, shape)
            self.sizes = dict(zip(mesh.axis_names, (int(n) for n in shape)))
            self.coords = dict(zip(mesh.axis_names, (int(k) for k in idx)))
            self.device = mesh.devices[idx]
        self.n_data = self.sizes.get("data", 1)
        self.n_model = self.sizes.get("model", 1)
        self.i = self.coords.get("data", 0)
        self.j = self.coords.get("model", 0)

    def at_seq(self, n_rows: int, S: int) -> "GroupCtx":
        """This slot for a pass over ``n_rows`` (the global batch) x ``S``
        positions: a copy whose ``seq`` / ``q_rows`` are its blocks under
        the ``seq_act`` / ``attn_seq_q`` rules after the reference's
        divisibility guard on the activations' shapes ((B, S, d) and (B,
        S, H, hd)), so a rule the guard drops (S = 1, or S not divisible
        by the model extent) falls away as it does there."""
        if self.mesh is None:
            return self
        from repro_torch.launch.sharding import guarded_spec

        out = copy.copy(self)
        for attr, axes in (("seq", ("batch", "seq_act", None)),
                           ("q_rows", ("batch", "attn_seq_q", None, None))):
            entry = guarded_spec(axes, (n_rows, S) + (1,) * (len(axes) - 2),
                                 self.rules, self.mesh)[1]
            if entry not in (None, "model"):
                raise ValueError(f"a sequence split over {entry!r}: the "
                                 "rules put it on 'model'")
            setattr(out, attr, (0, 1) if entry is None
                    else (self.j, self.n_model))
        return out

    def peers(self, parts, slots) -> list:
        """The entries of the per-slot list ``parts`` of ``slots`` — on a
        stand-in slot, its own entry for each."""
        if self.stand_in:
            return [parts[0]] * len(slots)
        return [parts[s] for s in slots]

    def _axes(self, logical: str, rules=None):
        ax = (self.rules if rules is None else rules).get(logical)
        return () if ax is None else ax if isinstance(ax, tuple) else (ax,)

    def block(self, logical: str, rules=None):
        """(block index, block count) of this slot along the mesh axes the
        rule of ``logical`` names ((0, 1) when it replicates)."""
        b, n = 0, 1
        for a in self._axes(logical, rules):
            b, n = b * self.sizes[a] + self.coords[a], n * self.sizes[a]
        return b, n

    def line(self, axes) -> List[int]:
        """The slots that share this slot's coordinates on every mesh axis
        but ``axes``, ordered by their block index along ``axes`` (in
        that order): the peers a leaf split over ``axes`` is gathered
        from, one per block."""
        key = (id(self.mesh), tuple(axes), self.slot)
        hit = _LINES.get(key)
        if hit is None or hit[0] is not self.mesh:
            names = self.mesh.axis_names
            shape = self.mesh.devices.shape
            ranges = [range(shape[k]) if a in axes else [self.coords[a]]
                      for k, a in enumerate(names)]
            pos = {a: k for k, a in enumerate(names)}
            coords = sorted(
                itertools.product(*ranges),
                key=lambda c: tuple(c[pos[a]] for a in axes))
            hit = _LINES[key] = (self.mesh, [
                int(np.ravel_multi_index(c, shape)) for c in coords])
        return hit[1]

    def _time_rule(self, name: str):
        """(rules, logical axis) of the time axis of cache leaf ``name``:
        the reference's ``cache_axes_for`` under this slot's rules."""
        from repro_torch.launch.sharding import cache_axes_for

        rules = dict(self.rules)
        return rules, cache_axes_for(name, 5, rules)[2]

    def time_block(self, name: str):
        """(block index, block count) of this slot along the time axis of
        the cache leaf ``name`` ((0, 1): the slot holds the whole axis) —
        over ``model``; where the rows do not split over the batch axes,
        over them and ``model``, or over them beside KV heads over
        ``model``."""
        if name in self.whole_time:
            return 0, 1
        rules, ax = self._time_rule(name)
        return (0, 1) if ax is None else self.block(ax, rules)

    def time_row(self, name: str) -> List[int]:
        """The slots whose time shards of leaf ``name`` make up the whole
        axis with this slot's, in time order: those that share this slot's
        coordinates on the mesh axes the time axis is not split over."""
        if self.time_block(name)[1] == 1:
            return [self.slot]
        rules, ax = self._time_rule(name)
        return self.line(self._axes(ax, rules))

    def slot_at(self, **coords) -> int:
        """The slot at this slot's coordinates with ``coords`` replaced."""
        if self.mesh is None:
            return 0
        c = dict(self.coords, **coords)
        return int(np.ravel_multi_index(
            tuple(c[a] for a in self.mesh.axis_names),
            self.mesh.devices.shape))

    def model_row(self) -> List[int]:
        """Slots of this slot's model row, (.., i, 0) .. (.., i, M-1)."""
        return [self.slot] if self.mesh is None else self.line(("model",))

    def row_block(self):
        """(index, count) of this slot's block of the batch rows: the
        ``batch`` rule's (data, or pod and data; (0, 1) when the rows
        replicate)."""
        return self.block("batch")

    def row_column(self) -> List[int]:
        """The slots at this slot's model index (and pod, where the rows
        replicate over it) holding each row block, in row order."""
        if self.mesh is None:
            return [self.slot]
        return self.line(self._axes("batch"))

    def to_here(self, x):
        return x if self.device is None else x.to(self.device,
                                                  non_blocking=True)

    def all_reduce_sum(self, parts, scatter: bool = False):
        """Sum of partials in slot order — a model row's, or the gradients
        of the slots holding one block of a leaf (the data-parallel sum) —
        added left to right on this slot's device.  ``scatter``: the
        reduce-scatter whose block this slot then keeps (its wire bytes:
        (g-1)/g of the summed leaf)."""
        if scatter:
            _record("reduce-scatter", parts[0], len(parts), gathered=True,
                    nbytes=_nbytes(parts[0]) / len(parts))
        else:
            _record("all-reduce", parts[0], len(parts))
        with collective_ops():
            out = self.to_here(parts[0])
            for p in parts[1:]:
                out = out + self.to_here(p)
        return out

    def reduce_scatter(self, parts, dim: int = 1):
        """This slot's block (its model index's of ``len(parts)`` along
        ``dim``) of the sum of a model row's partials ``parts`` (in row
        order), added in slot order on this slot's device — the
        all-reduce's sum, cut to the block the slot keeps.  Its wire bytes
        by the ring model, (g-1)/g of the summed leaf, are half the
        all-reduce's; the all-gather of the blocks makes up the rest."""
        g = len(parts)
        _record("reduce-scatter", parts[0], g, gathered=True,
                nbytes=_nbytes(parts[0]) / g)
        w = parts[0].shape[dim] // g
        with collective_ops():
            blocks = [self.to_here(p.narrow(dim, self.j * w, w))
                      for p in parts]
            out = blocks[0]
            for b in blocks[1:]:
                out = out + b
        return out

    def exchange(self, parts, src: Optional[int], dst: Optional[int]):
        """A model row's tensor (``parts``, in row order) moved from a
        split along dim ``src`` (slot j holding block j; None: whole on
        every slot) to a split along dim ``dst`` (None: whole): this
        slot's block — its own slice where ``src`` is None, an all-gather
        where ``dst`` is None, else the all-to-all whose piece from each
        peer is that peer's block of this slot's ``dst`` rows (the
        ``head_dim`` columns <-> query rows of the attention)."""
        g = len(parts)
        mine = parts[self.j] if g > 1 else parts[0]
        if src is None:
            x = self.to_here(mine)
            return x if dst is None else x.narrow(
                dst, self.j * (x.shape[dst] // g), x.shape[dst] // g)
        if dst is None:
            return self.all_gather(parts, dim=src)
        w = parts[0].shape[dst] // g
        pieces = [p.narrow(dst, self.j * w, w) for p in parts]
        if g > 1:
            _record("all-to-all", pieces[0], g, point=True,
                    nbytes=(g - 1) * _nbytes(pieces[0]))
        with collective_ops():
            return torch.cat([self.to_here(p) for p in pieces], dim=src)

    def gather_blocks(self, parts, idxs, shape):
        """A leaf of ``shape`` put together on this slot from its blocks
        ``parts`` (one a block, at the indices ``idxs``) — an all-gather of
        a leaf split over several mesh axes."""
        if len(parts) > 1:
            _record("all-gather", parts[0], len(parts), gathered=True,
                    nbytes=sum(_nbytes(p) for p in parts) / len(parts))
        with collective_ops():
            out = self.to_here(parts[0]).new_empty(tuple(shape))
            for p, idx in zip(parts, idxs):
                out[idx] = self.to_here(p)
        return out

    def all_gather(self, parts, dim: int = -1):
        """A row's shards (``parts`` in row order: the model row's, or a
        ``time_row``'s) concatenated along ``dim`` on this slot's device."""
        if len(parts) == 1:
            return self.to_here(parts[0])
        _record("all-gather", parts[0], len(parts), gathered=True,
                nbytes=sum(_nbytes(p) for p in parts) / len(parts))
        with collective_ops():
            return torch.cat([self.to_here(p) for p in parts], dim=dim)

    def merge_partials(self, parts, lo: int, hi: int, dtype,
                       kernel: bool = True):
        """K1's merge over a time row: ``parts`` its slots' split partials
        (m, l, acc; ``decode_attention_partials``) over every query head,
        in time order; this slot's heads [lo, hi) of each moved here and
        merged in that order and split order -> (B,1,hi-lo, Dv) of
        ``dtype``, by the combine kernel (``kernel``) or its plain version.
        Each peer sends its partials of these heads."""
        from repro_torch.kernels import merge_partials, merge_partials_ref

        mine = [tuple(self.to_here(x[:, :, lo:hi]) for x in p)
                for p in parts]
        if len(parts) > 1:
            _record("merge", mine[0][0], len(parts), point=True,
                    nbytes=(len(parts) - 1) * sum(_nbytes(x)
                                                  for x in mine[0]))
        if kernel:
            return merge_partials(mine, dtype)
        return merge_partials_ref(*(torch.cat([p[i] for p in mine])
                                    for i in range(3)), dtype)

    def receive(self, x, src: int, kind: str = "all-to-all", nbytes=None):
        """A point-to-point move of ``x`` from slot ``src`` to this slot
        (the sends of an all-to-all; ``kind`` names them in the count); a
        slot's own data moves nothing.  ``nbytes``: what the send puts on
        the wire where that is less than ``x`` (a 0-d device tensor where
        it depends on the data: :class:`CollectiveCount`)."""
        if src != self.slot:
            _record(kind, x, 2, point=True, nbytes=nbytes)
        return self.to_here(x)

    def send(self, x, dst: int, kind: str):
        """A point-to-point move of ``x`` from this slot to slot ``dst``
        (counted as ``kind``), on ``dst``'s device."""
        if dst == self.slot:
            return x
        _record(kind, x, 2, point=True)
        dev = self.mesh.devices.reshape(-1)[dst]
        return x.to(dev, non_blocking=True)


NULL = GroupCtx()
# GroupCtx.line by (id of the mesh, axes, slot): (the mesh, the slots)
_LINES: Dict = {}


def group_ctxs(mesh, rules=None, whole_time=(),
               stand_in: bool = False) -> List[GroupCtx]:
    """The ctx of every slot of ``mesh``, in slot order; ``stand_in``: slot
    0's alone, standing in for every slot (``GroupCtx``)."""
    if stand_in:
        return [GroupCtx(mesh, 0, rules, whole_time, True)]
    return [GroupCtx(mesh, s, rules, whole_time)
            for s in range(int(mesh.devices.size))]


def row_heads(ctxs) -> List[int]:
    """One slot per block of the batch rows, in row order: the slots at
    index 0 on every mesh axis the ``batch`` rule does not name (sums over
    the rows take each row once)."""
    c0 = ctxs[0]
    every = [GroupCtx(c0.mesh, s, c0.rules)
             for s in range(int(c0.mesh.devices.size))] \
        if c0.stand_in else ctxs
    return [c.slot for c in every
            if all(k == 0 for a, k in c.coords.items()
                   if a not in c._axes("batch"))]


def reduce_model(ctxs, parts):
    """Per slot: the sum of its model row's partials (the all-reduce after
    a row-split product)."""
    return [c.all_reduce_sum(c.peers(parts, c.model_row())) for c in ctxs]


def gather_model(ctxs, parts, dim: int = -1):
    """Per slot: its model row's shards concatenated along ``dim``."""
    return [c.all_gather(c.peers(parts, c.model_row()), dim) for c in ctxs]


def seq_ctxs(ctxs, n_rows: int, S: int):
    """The slots for a full-sequence pass over ``n_rows`` x ``S``
    (:meth:`GroupCtx.at_seq`)."""
    return [c.at_seq(n_rows, S) for c in ctxs]


def seq_block(c: GroupCtx, x, dim: int = 1):
    """The slot's ``seq`` block of a whole sequence ``x`` (``x`` itself
    when the pass keeps it whole)."""
    b, n = c.seq
    if n == 1:
        return x
    w = x.shape[dim] // n
    return x.narrow(dim, b * w, w)


def gather_seq(ctxs, xs, dim: int = 1):
    """Per slot: the whole sequence of its ``seq`` blocks ``xs``, gathered
    over the model row in position order (``xs`` where it is whole) —
    the Megatron-SP all-gather before a mixer or an FFN."""
    if ctxs[0].seq[1] == 1:
        return xs
    return gather_model(ctxs, xs, dim)


def reduce_out(ctxs, parts, partial: bool):
    """A block half's output onto the residual stream: the model row's
    partial sums (``partial``) added in slot order — all-reduced, or
    reduce-scattered onto the slots' ``seq`` blocks under ``seq_act`` —
    or each slot's whole output (cut to its ``seq`` block)."""
    if not partial:
        return [seq_block(c, p) for c, p in zip(ctxs, parts)]
    if ctxs[0].seq[1] > 1:
        return [c.reduce_scatter(c.peers(parts, c.model_row()))
                for c in ctxs]
    return reduce_model(ctxs, parts)


def last_position(ctxs, hs):
    """Per slot: the last position (B, 1, d) of the sequence whose ``seq``
    blocks are ``hs`` — broadcast from the model row's last slot under
    ``seq_act`` (its g - 1 sends, a (g-1)/g share on each slot)."""
    if ctxs[0].seq[1] == 1:
        return [h[:, -1:] for h in hs]
    out = []
    for c in ctxs:
        row = c.model_row()
        x = c.peers(hs, row)[-1][:, -1:]
        _record("broadcast", x, len(row), point=True,
                nbytes=(len(row) - 1) / len(row) * _nbytes(x))
        out.append(c.to_here(x))
    return out


def exchange_model(ctxs, parts, src: Optional[int], dst: Optional[int]):
    """Per slot: :meth:`GroupCtx.exchange` over its model row."""
    return [c.exchange(c.peers(parts, c.model_row()), src, dst)
            for c in ctxs]


def gather_time(ctxs, shards, n: int, name: str = "k"):
    """Per slot: positions [0, n) of a cache leaf named ``name`` (time on
    dim 1) whose slots hold time shards — each shard's part of [0, n)
    gathered over the slot's ``time_row`` in time order (a slot holding
    the whole axis reads its own)."""
    outs = []
    for c in ctxs:
        row = c.time_row(name)
        w = c.peers(shards, [c.slot])[0].shape[1]
        outs.append(c.all_gather(
            [x[:, :max(0, min(w, n - i * w))]
             for i, x in enumerate(c.peers(shards, row))], dim=1))
    return outs


_COLLECTIVES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_collectives", default=None)


class CollectiveCount:
    """Collectives recorded inside :func:`count_collectives`: ``wire`` —
    the bytes every slot's calls put on the wire, summed over slots —
    by kind, and ``calls``.  A send whose size depends on the data (the
    MoE's kept rows) records a 0-d device tensor, which ``by_kind`` reads
    on the host when it is asked for, after the step: nothing syncs
    inside it."""

    def __init__(self):
        self._by_kind: Dict[str, float] = {}
        self._pending: List = []
        self.calls = 0

    def add(self, kind: str, wire) -> None:
        if torch.is_tensor(wire):
            self._pending.append((kind, wire))
        else:
            self._by_kind[kind] = self._by_kind.get(kind, 0.0) + wire
        self.calls += 1

    @property
    def by_kind(self) -> Dict[str, float]:
        if self._pending:
            kinds, ws = zip(*self._pending)
            self._pending = []
            dev = ws[0].device
            vals = torch.stack([w.to(dev).double() for w in ws]).tolist()
            for kind, v in zip(kinds, vals):
                self._by_kind[kind] = self._by_kind.get(kind, 0.0) + v
        return self._by_kind

    @property
    def wire(self) -> float:
        return sum(self.by_kind.values())


# the counts open in this process, innermost last: autograd runs a CUDA
# backward (and the forward a checkpoint recomputes in it) on its own
# device thread, where the context variable is unset
_OPEN_COUNTS: List[CollectiveCount] = []


@contextlib.contextmanager
def count_collectives():
    rec = CollectiveCount()
    token = _COLLECTIVES.set(rec)
    _OPEN_COUNTS.append(rec)
    try:
        yield rec
    finally:
        _OPEN_COUNTS.remove(rec)
        _COLLECTIVES.reset(token)


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def _record(kind: str, x, g: int, gathered: bool = False,
            point: bool = False, nbytes: Optional[float] = None):
    """Wire bytes of one slot's share of a collective over ``g`` slots of
    operands like ``x`` (``nbytes`` of each when given — for a
    point-to-point send, a 0-d device tensor too; the reference's ring
    factors: all-reduce 2(g-1)/g N, all-gather (g-1)/g N_out; a
    point-to-point send N)."""
    rec = _COLLECTIVES.get()
    if rec is None and _OPEN_COUNTS:
        rec = _OPEN_COUNTS[-1]
    if rec is None or g <= 1:
        return
    n = _nbytes(x) if nbytes is None else nbytes
    if point:
        wire = n if torch.is_tensor(n) else float(n)
    elif gathered:
        wire = (g - 1) / g * n * g
    else:
        wire = 2.0 * (g - 1) / g * n
    rec.add(kind, wire)


def _vocab_lo(ctx: GroupCtx, local: int, cfg: ModelConfig) -> int:
    return ctx.j * local if local < cfg.padded_vocab else 0


def embed_tokens_group(ps, cfg: ModelConfig, ctxs, tokens):
    """Vocab-parallel lookup: each slot looks up the ids of its vocab
    shard (zero rows elsewhere) and the model row sums them — exactly the
    one table row each id has (reduce-scattered onto the slots' ``seq``
    blocks under ``seq_act``).  ``ps``: per-slot embedding trees;
    ``tokens``: per-slot id tensors.  Returns per-slot (.., d)."""
    parts = []
    for p, c, tok in zip(ps, ctxs, tokens):
        table = p["tok"]
        lo = _vocab_lo(c, table.shape[0], cfg)
        local = tok - lo
        ok = (local >= 0) & (local < table.shape[0])
        rows = F.embedding(local.clamp(0, table.shape[0] - 1), table)
        parts.append(torch.where(ok[..., None], rows, rows.new_zeros(())))
    return reduce_out(ctxs, parts, ps[0]["tok"].shape[0] != cfg.padded_vocab)


def _shard_logits(p, cfg: ModelConfig, c: GroupCtx, h):
    """One slot's logits of its vocab shard (softcap and pad mask applied
    there) and the shard's first vocabulary index."""
    h = apply_norm(p["final_norm"], cfg, h)
    w = p["tok"].t() if cfg.tie_embeddings else p["head"]
    logits = torch.matmul(h, w.to(h.dtype))
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    n = logits.shape[-1]
    lo = _vocab_lo(c, n, cfg)
    pad = vocab_pad_bias(cfg, h.device)
    if pad is not None:
        logits = logits + pad[lo:lo + n].to(logits.dtype)
    return logits, lo


def lm_head_group(ps, cfg: ModelConfig, ctxs, hs):
    """LM head on vocab shards: each slot's logits of its shard (softcap
    and pad mask applied there), gathered over the model row into the
    full vocabulary on every slot."""
    parts = [_shard_logits(p, cfg, c, h)[0]
             for p, c, h in zip(ps, ctxs, hs)]
    if parts[0].shape[-1] == cfg.padded_vocab:
        return parts
    return gather_model(ctxs, parts, dim=-1)


def lm_head_xent_group(ps, cfg: ModelConfig, ctxs, hs, labels):
    """The training use of the vocab-parallel LM head: per slot, the f32
    logsumexp of each position's logits and the logit of its label
    (``labels``, per-slot ids like ``hs``' positions).  Each slot's logits
    are its vocab shard's (softcap and pad mask applied there); the
    logsumexp joins the model row's shard logsumexps (an all-gather of one
    value a position) and the gold logit is the row's sum (the one shard
    holding the label gives it).  Returns (per-slot lse, per-slot gold)."""
    lses, golds = [], []
    for p, c, h, y in zip(ps, ctxs, hs, labels):
        logits, lo = _shard_logits(p, cfg, c, h)
        logits = logits.float()
        n = logits.shape[-1]
        lses.append(torch.logsumexp(logits, dim=-1))
        local = y.long() - lo
        ok = (local >= 0) & (local < n)
        gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])
        golds.append(torch.where(ok, gold[..., 0], 0.0))
    if n == cfg.padded_vocab:
        return lses, golds
    rows = gather_model(ctxs, [x[..., None] for x in lses], dim=-1)
    return ([torch.logsumexp(r, dim=-1) for r in rows],
            reduce_model(ctxs, golds))


def mlp_group(ps, cfg: ModelConfig, ctxs, xs):
    """The MLP on column/row splits: each slot's ``wi``/``wg``/``wu``
    columns and ``wo`` rows give a partial sum, which the model row adds
    (:func:`reduce_out`); a replicated MLP (``d_ff`` not divisible) is
    whole on each slot."""
    parts = [apply_mlp(p, cfg, x) for p, x in zip(ps, xs)]
    return reduce_out(ctxs, parts, ps[0]["wo"].shape[0] != cfg.d_ff)
