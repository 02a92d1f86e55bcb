"""Serving state pools for the geo engine — the slab layout and the
decoder, RWKV6 and Mamba2/zamba2 block kinds of the reference's
``repro/serving/kv_cache.py``.

* ``StateSpec`` names what one BPRR block needs from the serving layer;
  ``state_specs(cfg)`` derives the per-block tuple.
* ``CachePool`` is the continuous-batching layout of ONE server: one
  stacked state tree per run of same-kind hosted blocks, leaves
  ``(run_layers, n_rows, ...)`` on the device (K/V ``(.., max_len, Kv,
  hd)``, recurrent states whole), plus the row and block-slot bookkeeping
  of eq. (5): a server hosting ``m`` blocks has ⌊(M_j − s_m·m_j)/s_c⌋
  block-slots and a session routed through ``k`` of its blocks holds ``k``
  of them from admission to retirement.
* The pooled steps (``make_pool_prefill_step``, ``make_pool_decode_step``,
  ``make_pool_round_step``) run one server's hosted layers over ALL
  ``n_rows`` rows with fixed shapes; ``layer_active`` masks which rows run
  which layer.  Where the reference vmaps a batch-1 block over the rows and
  scans the layers, here the rows are a real batch (one scan-kernel launch
  covers every row's heads) with a per-row position vector, and a Python
  loop walks the layers.  Where the reference donates the pool to a jitted
  step, here the steps write the pool IN PLACE (only on active rows: K/V
  at their positions, recurrent state whole) and return just the hidden
  rows.  Because the shapes never depend on which rows hold sessions, a
  session's results are bit-identical whether it runs alone or among
  neighbours.

The paged layout (``PagePool``, ROADMAP A8) and the MLA, MoE and
encoder-decoder kinds (ROADMAP A9) are later slices of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.layers import param_dtype
from repro_torch.models.model import (LENGTH_KEYS, recurrent_state,
                                      layer_params)

# ---------------------------------------------------------------------------
# StateSpec: the per-block serving-state contract
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StateSpec:
    """What one BPRR block needs from the serving layer (see the
    reference): ``recurrent`` state, ``needs_emb0``, ``cross``-KV, and
    whether it does ``decode_active`` work."""

    kind: str
    recurrent: bool = False
    needs_emb0: bool = False
    cross: bool = False
    decode_active: bool = True


_STATE_SPECS: Dict[str, StateSpec] = {
    "decoder": StateSpec("decoder"),
    "rwkv": StateSpec("rwkv", recurrent=True),
    "mamba": StateSpec("mamba", recurrent=True),
    "mamba_shared": StateSpec("mamba_shared", recurrent=True,
                              needs_emb0=True),
}
_LATER_KINDS = ("enc", "dec")

SUPPORTED_KINDS: Tuple[str, ...] = tuple(sorted(_STATE_SPECS))


def state_spec_for(kind: str) -> StateSpec:
    """The :class:`StateSpec` of one block kind."""
    if kind in _STATE_SPECS:
        return _STATE_SPECS[kind]
    if kind in _LATER_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is a later slice of the port (ROADMAP A9)")
    raise ValueError(f"no serving StateSpec for block kind {kind!r}; "
                     "supported kinds: " + ", ".join(SUPPORTED_KINDS))


def state_specs(cfg: ModelConfig) -> Tuple[StateSpec, ...]:
    """Per-block StateSpec tuple (length ``cfg.n_layers``) for a config."""
    return tuple(state_spec_for(k) for k in B.stack_block_kinds(cfg))


def kind_runs(kinds: Sequence[str]) -> Tuple[Tuple[str, int, int], ...]:
    """Maximal contiguous same-kind runs: ((kind, lo, hi), ...)."""
    runs: List[Tuple[str, int, int]] = []
    for i, k in enumerate(kinds):
        if runs and runs[-1][0] == k:
            runs[-1] = (k, runs[-1][1], i + 1)
        else:
            runs.append((k, i, i + 1))
    return tuple(runs)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def _check_kind(kind: str):
    state_spec_for(kind)


def _state_tree(cfg: ModelConfig, kind: str, lead: Tuple[int, ...],
                max_len: int, device):
    """Zero serving state of one block kind with ``lead`` dims prepended:
    K/V (.., max_len, Kv, hd) for ``decoder``; f32 recurrent state for
    ``rwkv`` / ``mamba``; both for ``mamba_shared``."""
    _check_kind(kind)
    kv = lead + (max_len, cfg.n_kv_heads, cfg.head_dim)
    attn = {"k": torch.zeros(kv, dtype=param_dtype(cfg), device=device),
            "v": torch.zeros(kv, dtype=param_dtype(cfg), device=device)}
    if kind == "decoder":
        return attn
    tree = recurrent_state(cfg, "rwkv" if kind == "rwkv" else "mamba",
                            lead, device)
    if kind == "mamba_shared":
        tree.update(attn)
    return tree


def new_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    device="cuda"):
    """One per-(server, session, layer) cache: leaves (batch, ...)."""
    return _state_tree(cfg, kind, (batch,), max_len, device)


def new_state_pool_tree(cfg: ModelConfig, kind: str, n_layers: int,
                        n_rows: int, max_len: int, device="cuda"):
    """Stacked per-kind serving state: leaves (n_layers, n_rows, ...)."""
    return _state_tree(cfg, kind, (n_layers, n_rows), max_len, device)


def new_cache_pool_tree(cfg: ModelConfig, kind: str, n_layers: int,
                        n_rows: int, max_len: int, device="cuda"):
    """Alias of ``new_state_pool_tree`` (the reference keeps both names)."""
    return new_state_pool_tree(cfg, kind, n_layers, n_rows, max_len, device)


class CachePool:
    """Row + block-slot bookkeeping around the stacked state trees of ONE
    server (slab layout: every row owns a fixed ``max_len`` stripe).

    * ``self.tree[r]`` is the state of ``self.runs[r]``,
    * ``n_rows`` physical rows (the batch extent of the pooled steps),
    * ``cap_slots`` block-slots per eq. (5)."""

    def __init__(self, cfg: ModelConfig, kinds: Sequence[str], n_rows: int,
                 max_len: int, cap_slots: int, layout: str = "slab",
                 device="cuda"):
        if layout != "slab":
            raise NotImplementedError(
                f"cache layout {layout!r}: paged pools are a later slice of "
                "the port (ROADMAP A8)")
        self.cfg = cfg
        self.kinds = tuple(kinds)
        self.runs = kind_runs(self.kinds)
        self.n_layers = len(self.kinds)
        self.n_rows = n_rows
        self.max_len = max_len
        self.cap_slots = int(cap_slots)
        self.device = torch.device(device)
        self.tree: Tuple[Dict, ...] = tuple(
            new_state_pool_tree(cfg, kind, hi - lo, n_rows, max_len, device)
            for kind, lo, hi in self.runs)
        self._free: List[int] = list(range(n_rows))
        self.rows: Dict[int, int] = {}  # sid -> row
        self.blocks: Dict[int, int] = {}  # sid -> k block-slots held
        self.slots_used = 0

    # -- admission ----------------------------------------------------------
    def fits(self, sid: int, k_blocks: int) -> bool:
        """No-overbooking check (re-entry of a failover chain charges the
        additional blocks but needs no new row)."""
        if sid in self.rows:
            return self.slots_used + k_blocks <= self.cap_slots
        return bool(self._free) and (self.slots_used + k_blocks
                                     <= self.cap_slots)

    def alloc(self, sid: int, k_blocks: int) -> int:
        """Claim one row + ``k_blocks`` slots; raises if over budget."""
        if self.slots_used + k_blocks > self.cap_slots:
            raise RuntimeError(
                f"block-slot overbooking: {self.slots_used}+{k_blocks} > "
                f"{self.cap_slots}")
        if sid in self.rows:  # re-entry: charge the extra blocks
            self.blocks[sid] += int(k_blocks)
            self.slots_used += int(k_blocks)
            return self.rows[sid]
        if not self._free:
            raise RuntimeError("cache pool rows exhausted")
        row = self._free.pop()
        self.rows[sid] = row
        self.blocks[sid] = int(k_blocks)
        self.slots_used += int(k_blocks)
        return row

    def release(self, sid: int):
        row = self.rows.pop(sid, None)
        if row is None:
            return
        self.slots_used -= self.blocks.pop(sid, 0)
        self._free.append(row)
        # stale row contents are never observable: a new occupant's prefill
        # overwrites [:prompt_len] of K/V and the recurrent state whole, and
        # decode attention masks kv_pos > pos

    def usage(self) -> Tuple[int, int]:
        """(used, capacity) block-slots."""
        return self.slots_used, self.cap_slots

    def n_sessions(self) -> int:
        return len(self.rows)

    # -- prefill writes -----------------------------------------------------
    def write_prefill_range(self, lo_rel: int, hi_rel: int, row: int,
                            entries: List[Dict], length: int):
        """Insert single-session per-layer cache entries (batch dim 1, one
        per layer in [lo_rel, hi_rel)) into the pool row: K/V at
        [:length], recurrent state whole."""
        assert len(entries) == hi_rel - lo_rel
        for r, (kind, rlo, rhi) in enumerate(self.runs):
            lo, hi = max(lo_rel, rlo), min(hi_rel, rhi)
            if lo >= hi:
                continue
            sub = entries[lo - lo_rel: hi - lo_rel]
            t = self.tree[r]
            for key in t:
                stacked = torch.stack([e[key][0] for e in sub]).to(
                    t[key].dtype)
                if key in LENGTH_KEYS:
                    t[key][lo - rlo:hi - rlo, row, :length] = \
                        stacked[:, :length]
                else:  # recurrent state: whole overwrite
                    t[key][lo - rlo:hi - rlo, row] = stacked


# ---------------------------------------------------------------------------
# Prompt-length bucketing (batched prefill)
# ---------------------------------------------------------------------------


def default_prefill_buckets(max_prompt_len: int, base: int = 8
                            ) -> Tuple[int, ...]:
    """Power-of-two bucket lengths up to ``max_prompt_len`` (inclusive)."""
    max_prompt_len = int(max_prompt_len)
    assert max_prompt_len >= 1
    out: List[int] = []
    b = base
    while b < max_prompt_len:
        out.append(b)
        b *= 2
    out.append(max_prompt_len)
    return tuple(out)


def bucket_for(buckets: Sequence[int], length: int,
               specs: Optional[Sequence[StateSpec]] = None) -> Optional[int]:
    """Smallest bucket >= ``length``; None when the prompt overflows every
    bucket (the engine then chunks it).  Stacks with recurrent state use
    the exact prompt length."""
    if specs is not None and any(s.recurrent for s in specs):
        return int(length)
    for b in sorted(buckets):
        if b >= length:
            return int(b)
    return None


# ---------------------------------------------------------------------------
# Pooled steps (one server's hosted layers over all rows)
# ---------------------------------------------------------------------------


def _masked_ranged_write(leaf, chunk, active, lo: int, span: int):
    """In place: ``leaf[:, lo:lo+span] = chunk`` on active rows."""
    old = leaf[:, lo:lo + span]
    msk = active.reshape((-1,) + (1,) * (chunk.dim() - 1))
    old.copy_(torch.where(msk, chunk.to(old.dtype), old))


def _masked_state_write(cache, state, active):
    """In place: overwrite each recurrent state leaf WHOLE on active rows
    (the reference's ``_mask_tree``); leaves are (n_rows, ...)."""
    for key, new in state.items():
        leaf = cache[key]
        msk = active.reshape((-1,) + (1,) * (leaf.dim() - 1))
        leaf.copy_(torch.where(msk, new.to(leaf.dtype), leaf))


def make_pool_prefill_step(cfg: ModelConfig, kinds: Tuple[str, ...],
                           backend: str = "kernel"):
    """THE multi-session prefill step of a hosted block range.

    step(run_params, shared_params, pool_trees, h, emb0, layer_active,
         layer_ids, offset) -> h

    * ``run_params``: per-run stacked block params (axis 0 = run layers);
      ``shared_params``: zamba2's parameter-shared attention block (None
      otherwise),
    * ``pool_trees``: per-run state trees (``CachePool.tree``), written in
      place on active rows: the chunk's K/V at [offset, offset + T), the
      recurrent state whole,
    * ``h``: (n_rows, T, d) right-padded hidden rows; ``emb0``: (n_rows, T,
      d) original embeddings for shared-attention blocks (None otherwise),
    * ``layer_active``: (n_layers, n_rows) bool tensor; ``layer_ids``:
      absolute layer indices (python ints, for per-layer windows),
    * ``offset``: chunk start; attention rows attend over their pool cache
      [0, offset) plus the chunk (chunked prefill).  Recurrent kinds (rwkv,
      mamba, mamba_shared) need ``offset == 0`` and ``T`` equal to the true
      prompt length: their state is order-sensitive, so the engine groups
      them by exact length and never pads or chunks them.
    """
    runs = kind_runs(kinds)
    for kind, _, _ in runs:
        _check_kind(kind)

    def step(run_params, shared_params, pool_trees, h, emb0, layer_active,
             layer_ids, offset):
        T = h.shape[1]
        positions = offset + torch.arange(T, device=h.device)
        for r, (kind, lo, hi) in enumerate(runs):
            if _STATE_SPECS[kind].recurrent and offset != 0:
                raise ValueError(
                    f"recurrent-state kind {kind!r} cannot resume prefill "
                    "at a nonzero chunk offset")
            for i in range(hi - lo):
                act = layer_active[lo + i]
                p = layer_params(run_params[r], i)
                c = layer_params(pool_trees[r], i)
                if kind == "decoder":
                    prefix = None if offset == 0 else (
                        c["k"][:, :offset], c["v"][:, :offset])
                    h2, chunk, _ = B.decoder_block_full(
                        p, cfg, h, positions, layer_ids[lo + i],
                        prefix_kv=prefix, backend=backend)
                    for key in chunk:
                        _masked_ranged_write(c[key], chunk[key], act,
                                             offset, T)
                elif kind == "rwkv":
                    h2, st = B.rwkv_block_full(p, cfg, h, backend=backend)
                    _masked_state_write(c, st, act)
                else:  # mamba, mamba_shared
                    h2, st = B.mamba_block_full(p, cfg, h, backend=backend)
                    _masked_state_write(c, st, act)
                    if kind == "mamba_shared":
                        h2, kv = B.zamba_shared_full(
                            shared_params, cfg, h2, emb0, positions,
                            backend=backend)
                        for key in kv:
                            _masked_ranged_write(c[key], kv[key], act, 0, T)
                h = torch.where(act[:, None, None], h2, h)
        return h

    return step


def make_pool_decode_step(cfg: ModelConfig, kinds: Tuple[str, ...],
                          backend: str = "kernel"):
    """THE pooled decode step of a hosted block range.

    step(run_params, shared_params, pool_trees, h, pos, emb0, layer_active,
         layer_ids) -> h

    ``h``: (n_rows, 1, d); ``pos``: (n_rows,) integer tensor — each row's
    cache write/attend position; ``emb0``: (n_rows, 1, d) current-token
    embeddings for shared-attention blocks (None otherwise).  Each active
    row's new K/V is written into the pool in place and its recurrent
    state overwritten whole; inactive rows keep their hidden state and
    state.  The recurrent steps are elementwise: no kernel."""
    runs = kind_runs(kinds)
    for kind, _, _ in runs:
        _check_kind(kind)

    def step(run_params, shared_params, pool_trees, h, pos, emb0,
             layer_active, layer_ids):
        for r, (kind, lo, hi) in enumerate(runs):
            for i in range(hi - lo):
                act = layer_active[lo + i]
                p = layer_params(run_params[r], i)
                c = layer_params(pool_trees[r], i)
                if kind == "decoder":
                    h2, _ = B.decoder_block_decode(
                        p, cfg, h, c, pos, layer_ids[lo + i], active=act,
                        backend=backend)
                elif kind == "rwkv":
                    h2, st = B.rwkv_block_decode(p, cfg, h, c)
                    _masked_state_write(c, st, act)
                else:  # mamba, mamba_shared
                    h2, st = B.mamba_block_decode(
                        p, cfg, h, {"ssm": c["ssm"], "conv": c["conv"]})
                    if kind == "mamba_shared":
                        h2, _ = B.zamba_shared_decode(
                            shared_params, cfg, h2, emb0, c, pos,
                            active=act, backend=backend)
                    _masked_state_write(c, st, act)
                h = torch.where(act[:, None, None], h2, h)
        return h

    return step


def make_pool_round_step(cfg: ModelConfig, kinds: Tuple[str, ...],
                         backend: str = "kernel"):
    """THE fused per-(hop, server) dispatch of a device-resident decode
    round: gather the hop's rows out of the round buffers, run the pooled
    decode step, scatter the results back — no host round trip.

    hop(run_params, shared_params, pool_trees, h_round, pos_round,
        emb0_round, slot_of_row, row_of_slot, layer_active, layer_ids)
        -> h_round

    * ``h_round``: (W, 1, d) round-resident hidden states (W fixed),
    * ``pos_round``: (W,) per-slot cache position; ``emb0_round``: (W, 1,
      d) round-start embeddings for shared-attention stacks (else None),
    * ``slot_of_row``: (n_rows,) — the round slot feeding each pool row
      (-1: not in the hop; a clipped placeholder ``layer_active`` masks),
    * ``row_of_slot``: (W,) — the pool row each slot takes its result from
      (-1 keeps the slot's hidden state)."""
    step = make_pool_decode_step(cfg, kinds, backend)

    def hop(run_params, shared_params, pool_trees, h_round, pos_round,
            emb0_round, slot_of_row, row_of_slot, layer_active, layer_ids):
        W = h_round.shape[0]
        n_rows = slot_of_row.shape[0]
        src = slot_of_row.clamp(0, W - 1)
        emb0 = None if emb0_round is None else emb0_round[src]
        h_out = step(run_params, shared_params, pool_trees, h_round[src],
                     pos_round[src], emb0, layer_active, layer_ids)
        back = h_out[row_of_slot.clamp(0, n_rows - 1)]
        keep = (row_of_slot >= 0)[:, None, None]
        return torch.where(keep, back, h_round)

    return hop
