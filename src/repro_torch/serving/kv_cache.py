"""Serving state pools for the geo engine — the slab and paged layouts and
the decoder (GQA K/V or MLA latents), RWKV6, Mamba2/zamba2 and
encoder-decoder block kinds of the reference's
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

* ``layout="paged"`` (the reference's paged twin): the time axis of every
  self-KV leaf is carved into ``page_size``-token pages held in shared
  physical page arrays ``(layers, n_pages + 1, page_size, Kv, hd)``; a
  :class:`PagePool` free list plus one page table ``(n_rows, max_pages)``
  per server maps row time-slices to physical pages (page 0 is the trash
  page of unassigned entries).  Admission books only the pages a prompt
  needs against ``cap_units = cap_slots × max_pages`` page-units (a
  session through ``k`` blocks holding ``p`` pages charges ``k·p``);
  recurrent and cross-KV leaves stay row-resident.  The paged steps
  gather each row's pages into slab-shaped scratch, run the unchanged
  slab step on it and scatter the written pages back, so paged results
  equal slab results.

An MLA layer's cache is ONE ``(.., max_len, lora + rope)`` buffer whose
``latent`` and ``krope`` leaves are views (``attention.mla_cache_views``):
absorbed decode reads it as K1's keys and its latent columns as the
values, through strides.  The paged layout keeps that buffer whole in its
page arrays and scratch.  MoE layers route each pool row alone
(``moe_rows``), as the reference's vmapped rows do.

Device-group servers (``launch.mesh.GroupMesh`` + the serving rules of
``launch.sharding``): the pool is a tree per slot under the reference's
specs (``group_pool_specs``) — rows over ``data``; KV heads over
``model``, or where they replicate (and for MLA latents) the time axis;
recurrent states whole on every model slot — and the pooled steps built
with ``mesh=`` run their per-slot body on every slot in lockstep
(``blocks.<kind>_*_group``, which a solo server runs on its one ``NULL``
slot), staging a slot's rows onto its device and gathering the results
back onto the caller's.  A slot holding a time shard writes the part of
each prefill chunk (and the decode token) whose positions it owns and
reads a prefix gathered over its model row.  The paged twins gather and
scatter each slot's own rows; the page arrays split their page axis over
``data`` where the rules and the guard say so (the reference's layout), so
a row's page may live on another data slot: the slot reads it from its
holder and writes it back there (point-to-point moves, counted as
"page-read" / "page-write"), while the ``PagePool`` allocator stays
global.  Where the within-page offsets shard over ``model`` the slots'
offset shards are gathered into whole pages (an all-gather, counted)
before the unchanged step, each slot writing its own offsets back.
``_ep_row_grid`` is the reference's gate that sends a padded MoE through
the pure-EP all-to-all.

Encoder-decoder stacks: ``enc`` blocks hold no state and do no decode
work (the decode steps skip their runs); ``dec`` blocks hold self K/V and
the cross K/V ``ck``/``cv`` at ``enc_len`` (the engine's ``max_enc_len``)
positions per row, written once at the first prefill chunk, and their
decode masks each row's cross attention to its own encoder length.  The
prefill step runs one ``phase``: "enc" (encoder runs only, exact length)
or "dec" (the rest, with the rows' encoder outputs ``enc_rows``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import (cache_axes_for, pool_tree_shardings,
                                         thaw_rules)
from repro_torch.models import blocks as B
from repro_torch.models.attention import mla_cache_views, mla_keys
from repro_torch.models.layers import (NULL, gather_time,
                                       group_ctxs, param_dtype)
from repro_torch.models.model import (LENGTH_KEYS, layer_params,
                                      recurrent_state, slot_zeros,
                                      tree_nbytes)


def to_device(a, device) -> torch.Tensor:
    """A host array as a tensor on ``device`` without a host sync: on the
    card it is staged through its own pinned buffer and copied
    asynchronously on the current stream (a plain ``torch.as_tensor(...,
    device="cuda")`` blocks until the stream drains)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


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
    "lead": StateSpec("lead"),
    "rwkv": StateSpec("rwkv", recurrent=True),
    "mamba": StateSpec("mamba", recurrent=True),
    "mamba_shared": StateSpec("mamba_shared", recurrent=True,
                              needs_emb0=True),
    "enc": StateSpec("enc", decode_active=False),
    "dec": StateSpec("dec", cross=True),
}

SUPPORTED_KINDS: Tuple[str, ...] = tuple(sorted(_STATE_SPECS))


def state_spec_for(kind: str) -> StateSpec:
    """The :class:`StateSpec` of one block kind."""
    if kind in _STATE_SPECS:
        return _STATE_SPECS[kind]
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


# encoder cross-K/V leaves of ``dec`` blocks: written once, at [0, enc_len)
CROSS_KEYS = frozenset({"ck", "cv"})


def _check_kind(kind: str):
    state_spec_for(kind)


def _state_tree(cfg: ModelConfig, kind: str, lead: Tuple[int, ...],
                max_len: int, device, enc_len: int = 0):
    """Zero serving state of one block kind with ``lead`` dims prepended:
    K/V (.., max_len, Kv, hd) for ``decoder`` (MLA: the latent and krope
    views of one (.., max_len, lora + rope) buffer); f32 recurrent state
    for ``rwkv`` / ``mamba``; both for ``mamba_shared``; none for ``enc``;
    K/V and the cross K/V ``ck``/``cv`` (.., enc_len, Kv, hd) for
    ``dec``."""
    _check_kind(kind)
    if kind == "enc":
        return {}
    kind = B.resolve_kind(cfg, kind)[1]
    if kind == "decoder" and cfg.attn_kind == "mla":
        lora = cfg.kv_lora_rank
        return mla_cache_views(torch.zeros(
            lead + (max_len, lora + cfg.rope_head_dim),
            dtype=param_dtype(cfg), device=device), lora)
    kv = lead + (max_len, cfg.n_kv_heads, cfg.head_dim)
    attn = {"k": torch.zeros(kv, dtype=param_dtype(cfg), device=device),
            "v": torch.zeros(kv, dtype=param_dtype(cfg), device=device)}
    if kind == "decoder":
        return attn
    if kind == "dec":
        ckv = lead + (enc_len, cfg.n_kv_heads, cfg.head_dim)
        return dict(attn, **{key: torch.zeros(ckv, dtype=param_dtype(cfg),
                                              device=device)
                             for key in ("ck", "cv")})
    tree = recurrent_state(cfg, "rwkv" if kind == "rwkv" else "mamba",
                            lead, device)
    if kind == "mamba_shared":
        tree.update(attn)
    return tree


def new_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    enc_len: int = 0, device="cuda"):
    """One per-(server, session, layer) cache: leaves (batch, ...)."""
    return _state_tree(cfg, kind, (batch,), max_len, device, enc_len)


def new_state_pool_tree(cfg: ModelConfig, kind: str, n_layers: int,
                        n_rows: int, max_len: int, enc_len: int = 0,
                        device="cuda"):
    """Stacked per-kind serving state: leaves (n_layers, n_rows, ...)."""
    return _state_tree(cfg, kind, (n_layers, n_rows), max_len, device,
                       enc_len)


def new_cache_pool_tree(cfg: ModelConfig, kind: str, n_layers: int,
                        n_rows: int, max_len: int, device="cuda"):
    """Alias of ``new_state_pool_tree`` (the reference keeps both names)."""
    return new_state_pool_tree(cfg, kind, n_layers, n_rows, max_len,
                               device=device)


# ---------------------------------------------------------------------------
# Paged layout: free-list page allocator + paged state trees
# ---------------------------------------------------------------------------

TRASH_PAGE = 0  # physical page id 0: write target of every unassigned entry


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache positions (0 for 0)."""
    n_tokens = int(n_tokens)
    assert n_tokens >= 0
    return -(-n_tokens // int(page_size))


class PagePool:
    """Deterministic free-list page allocator (the reference's).

    Physical pages are numbered ``1..n_pages``; id ``TRASH_PAGE == 0`` is
    the write target of unassigned page-table entries, so the gather and
    scatter never branch on validity.  ``table`` is the host page table
    ``(n_rows, max_pages_per_row)``: row ``r``'s time-slice ``[i*page,
    (i+1)*page)`` lives in physical page ``table[r, i]`` (0 = unassigned).
    Rows grow monotonically (``grow_to``) and free wholesale
    (``free_row``).  The free list is LIFO and every operation is a pure
    function of the call sequence, so the same sequence reproduces the
    same tables; ``version`` counts the table's changes."""

    def __init__(self, n_pages: int, n_rows: int, max_pages_per_row: int):
        self.n_pages = int(n_pages)
        self.n_rows = int(n_rows)
        self.max_pages_per_row = int(max_pages_per_row)
        assert self.n_pages >= 0 and self.n_rows >= 1
        assert self.max_pages_per_row >= 1
        self.table = np.zeros((self.n_rows, self.max_pages_per_row),
                              np.int32)
        self.count = np.zeros((self.n_rows,), np.int32)
        # LIFO free list; initialized so the first pops hand out 1, 2, 3...
        self._free: List[int] = list(range(self.n_pages, 0, -1))
        self.version = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return int(self.count.sum())

    def pages_of(self, row: int) -> List[int]:
        """The live page ids of ``row`` in table order."""
        return [int(self.table[row, i])
                for i in range(int(self.count[row]))]

    def can_grow(self, row: int, n_pages: int) -> bool:
        return n_pages - int(self.count[row]) <= len(self._free)

    def grow_to(self, row: int, n_pages: int) -> List[int]:
        """Extend ``row`` to ``n_pages`` pages (no-op when already there);
        returns the newly assigned page ids.  Raises on free-list
        exhaustion — callers check ``can_grow``."""
        have = int(self.count[row])
        if n_pages <= have:
            return []
        if n_pages > self.max_pages_per_row:
            raise RuntimeError(
                f"row {row}: {n_pages} pages exceed the per-row table "
                f"width {self.max_pages_per_row}")
        if n_pages - have > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: row {row} needs {n_pages - have} "
                f"pages, {len(self._free)} free")
        fresh = []
        for i in range(have, n_pages):
            pid = self._free.pop()
            self.table[row, i] = pid
            fresh.append(pid)
        self.count[row] = n_pages
        self.version += 1
        return fresh

    def free_row(self, row: int) -> List[int]:
        """Return every page of ``row`` to the free list (reverse order, so
        alloc→free→alloc round-trips reproduce the same page ids).
        Returns the freed page ids."""
        freed = []
        for i in reversed(range(int(self.count[row]))):
            pid = int(self.table[row, i])
            self._free.append(pid)
            freed.append(pid)
            self.table[row, i] = 0
        self.count[row] = 0
        self.version += 1
        return freed

    def check_invariants(self):
        """Allocator invariants: entries beyond ``count[r]`` are 0, entries
        below are in ``[1, n_pages]``; no page is referenced twice; live ∪
        free partitions ``{1..n_pages}``."""
        live: List[int] = []
        for r in range(self.n_rows):
            c = int(self.count[r])
            assert 0 <= c <= self.max_pages_per_row
            assert (self.table[r, c:] == 0).all(), f"row {r}: stale entries"
            ids = self.table[r, :c].tolist()
            assert all(1 <= p <= self.n_pages for p in ids), \
                f"row {r}: out-of-range page id"
            live.extend(ids)
        assert len(live) == len(set(live)), "double-booked page"
        free = self._free
        assert len(free) == len(set(free)), "duplicate free-list entry"
        assert not set(live) & set(free), "page both live and free"
        assert len(live) + len(free) == self.n_pages, "page leak"


def new_paged_pool_tree(cfg: ModelConfig, kind: str, n_layers: int,
                        n_rows: int, page_size: int, n_phys: int,
                        enc_len: int = 0, device="cuda"):
    """Paged-layout state tree: self-KV leaves become shared physical page
    arrays ``(n_layers, n_phys, page_size, Kv, hd)`` (``n_phys`` includes
    the trash page) addressed through the pool's page table (MLA: one
    ``(.., page_size, lora + rope)`` array, viewed as latent and krope);
    every other leaf (recurrent state, cross K/V at ``enc_len``) keeps its
    row-resident ``(n_layers, n_rows, ...)`` layout."""
    tree = _state_tree(cfg, kind, (n_layers, n_rows), page_size, device,
                       enc_len)
    for names, leaf in _length_leaves(tree):
        tree.update(_as_leaves(tree, names, leaf.new_zeros(
            (n_layers, n_phys) + leaf.shape[2:])))
    return tree


def _length_leaves(tree):
    """The time-axis buffers of a state tree as (leaf names, tensor): the
    MLA pair as its one joint buffer (a view), K and V each alone."""
    out = []
    if "latent" in tree:
        out.append((("latent", "krope"),
                    mla_keys(tree["latent"], tree["krope"])))
    out.extend(((key,), tree[key]) for key in ("k", "v") if key in tree)
    return out


def decode_step_bytes(tree, max_len: int) -> Tuple[int, int]:
    """(read, written) bytes of one pooled decode step over a slab-shaped
    state tree, every row active at the last position: every leaf is read
    whole (MLA's latent and krope views as their one joint buffer); a
    self-attention cache gets one token a row, a recurrent state is
    rewritten whole, cross K/V are only read."""
    length = _length_leaves(tree)
    named = {n for names, _ in length for n in names}
    rest = {k: x for k, x in tree.items() if k not in named}
    read = sum(tree_nbytes(x) for _, x in length) + tree_nbytes(rest)
    written = sum(tree_nbytes(x) // max_len for _, x in length) \
        + sum(tree_nbytes(x) for k, x in rest.items() if k not in CROSS_KEYS)
    return read, written


def _as_leaves(tree, names, buf):
    """Leaves named ``names`` over ``buf``, split like ``tree``'s (the
    inverse of :func:`_length_leaves`)."""
    if names == ("latent", "krope"):
        return mla_cache_views(buf, tree["latent"].shape[-1])
    return {names[0]: buf}


class CachePool:
    """Row + block-slot bookkeeping around the stacked state trees of ONE
    server.

    * ``self.tree[r]`` is the state of ``self.runs[r]``,
    * ``n_rows`` physical rows (the batch extent of the pooled steps),
    * ``cap_slots`` block-slots per eq. (5).

    ``layout="slab"``: every row owns a fixed ``max_len`` stripe (and an
    ``enc_len`` stripe of cross K/V on ``dec`` runs).
    ``layout="paged"``: self-KV lives in ``page_size``-token pages; the
    budget is ``cap_units = cap_slots × max_pages`` page-units, a session
    through ``k`` blocks holding ``p`` pages charges ``k·p``, and the page
    arrays hold the same byte budget (``cap_units / n_layers`` pages,
    clamped to what the rows could ever reference).

    ``group=(mesh, layout_rules)``: a device-group server's pool — the
    trees live per slot in ``slot_trees`` (``group_pool_specs``) and
    ``tree`` is None; the bookkeeping is the same."""

    def __init__(self, cfg: ModelConfig, kinds: Sequence[str], n_rows: int,
                 max_len: int, cap_slots: int, enc_len: int = 0,
                 layout: str = "slab", page_size: int = 0, device="cuda",
                 group=None):
        if layout not in ("slab", "paged"):
            raise ValueError(f"cache layout {layout!r}: 'slab' or 'paged'")
        self.cfg = cfg
        self.kinds = tuple(kinds)
        self.runs = kind_runs(self.kinds)
        self.n_layers = len(self.kinds)
        self.n_rows = n_rows
        self.max_len = max_len
        self.enc_len = int(enc_len)
        self.cap_slots = int(cap_slots)
        self.layout = layout
        self.device = torch.device(device)
        if layout == "paged":
            page_size = int(page_size)
            if page_size < 1 or max_len % page_size != 0:
                raise ValueError(
                    f"page_size {page_size} must be >= 1 and divide "
                    f"max_len {max_len} (keeps the paged time axis "
                    "identical to the slab one)")
            self.page_size = page_size
            self.max_pages = max_len // page_size
            self.cap_units = self.cap_slots * self.max_pages
            n_phys = max(1, min(self.cap_units // max(1, self.n_layers),
                                n_rows * self.max_pages))
            self.pages = PagePool(n_phys, n_rows, self.max_pages)
            self.units_used = 0
            self.sid_pages: Dict[int, int] = {}  # sid -> pages held
            self.tree: Tuple[Dict, ...] = tuple(
                new_paged_pool_tree(cfg, kind, hi - lo, n_rows, page_size,
                                    n_phys + 1, self.enc_len,
                                    "meta" if group else device)
                for kind, lo, hi in self.runs)
            self._table_dev: Optional[Tuple[int, torch.Tensor]] = None
        else:
            self.page_size = 0
            self.tree = tuple(
                new_state_pool_tree(cfg, kind, hi - lo, n_rows, max_len,
                                    self.enc_len,
                                    "meta" if group else device)
                for kind, lo, hi in self.runs)
        self.slot_trees = self.slot_specs = None
        if group is not None:
            mesh, rules = group
            paged = layout == "paged"
            self.slot_specs = tuple(group_pool_specs(mesh, rules, t, paged)
                                    for t in self.tree)
            self.slot_trees = tuple(
                tuple(slot_zeros(t, sp, mesh, s, dev)
                      for t, sp in zip(self.tree, self.slot_specs))
                for s, dev in enumerate(mesh.slot_devices()))
            self.tree = None
        self._free: List[int] = list(range(n_rows))
        self.rows: Dict[int, int] = {}  # sid -> row
        self.blocks: Dict[int, int] = {}  # sid -> k block-slots held
        self.slots_used = 0

    # -- admission ----------------------------------------------------------
    def pages_needed(self, n_tokens: int) -> int:
        """Pages covering ``n_tokens`` cache positions (paged layout)."""
        return pages_for(n_tokens, self.page_size)

    def fits(self, sid: int, k_blocks: int, n_pages: int = 0,
             worst_pages: Optional[int] = None) -> bool:
        """No-overbooking check (re-entry of a failover chain charges the
        additional blocks but needs no new row).  Paged layout: ``n_pages``
        is the page count to book now (the resident count on re-entry) and
        ``worst_pages`` asserts solo-completability — the fully grown
        session must fit this server ALONE, so a preempted session can
        always eventually resume."""
        if self.layout == "paged":
            p = self.sid_pages.get(sid, 0) if sid in self.rows \
                else int(n_pages)
            k_total = self.blocks.get(sid, 0) + k_blocks
            if worst_pages is not None:
                if (k_total * int(worst_pages) > self.cap_units
                        or int(worst_pages) > min(self.pages.n_pages,
                                                  self.max_pages)):
                    return False
            if sid in self.rows:
                return self.units_used + k_blocks * p <= self.cap_units
            return (bool(self._free)
                    and self.units_used + k_blocks * p <= self.cap_units
                    and p <= self.pages.free_pages)
        if sid in self.rows:
            return self.slots_used + k_blocks <= self.cap_slots
        return bool(self._free) and (self.slots_used + k_blocks
                                     <= self.cap_slots)

    def alloc(self, sid: int, k_blocks: int, n_pages: int = 0) -> int:
        """Claim one row + ``k_blocks`` slots (slab) or one row +
        ``n_pages`` pages charged at ``k_blocks × n_pages`` page-units
        (paged); raises if over budget."""
        if self.layout == "paged":
            p = self.sid_pages[sid] if sid in self.rows else int(n_pages)
            if self.units_used + k_blocks * p > self.cap_units:
                raise RuntimeError(
                    f"page-unit overbooking: {self.units_used}+"
                    f"{k_blocks}*{p} > {self.cap_units}")
            if sid in self.rows:  # re-entry: charge the extra blocks
                self.blocks[sid] += int(k_blocks)
                self.units_used += int(k_blocks) * p
                return self.rows[sid]
            if not self._free:
                raise RuntimeError("cache pool rows exhausted")
            row = self._free.pop()
            self.pages.grow_to(row, p)
            self.rows[sid] = row
            self.blocks[sid] = int(k_blocks)
            self.sid_pages[sid] = p
            self.units_used += int(k_blocks) * p
            return row
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

    # -- page growth (paged layout) -----------------------------------------
    def can_grow(self, sid: int, n_pages: int) -> bool:
        """True iff ``sid`` can be extended to ``n_pages`` total pages
        within both the page-unit budget and the physical free list."""
        assert self.layout == "paged"
        extra = int(n_pages) - self.sid_pages[sid]
        if extra <= 0:
            return True
        return (self.units_used + self.blocks[sid] * extra <= self.cap_units
                and self.pages.can_grow(self.rows[sid], int(n_pages)))

    def grow_pages(self, sid: int, n_pages: int):
        """Extend ``sid`` to ``n_pages`` total pages (decode growth);
        raises on overbooking — callers check ``can_grow`` first."""
        assert self.layout == "paged"
        extra = int(n_pages) - self.sid_pages[sid]
        if extra <= 0:
            return
        if self.units_used + self.blocks[sid] * extra > self.cap_units:
            raise RuntimeError(
                f"page-unit overbooking on grow: {self.units_used}+"
                f"{self.blocks[sid]}*{extra} > {self.cap_units}")
        self.pages.grow_to(self.rows[sid], int(n_pages))
        self.sid_pages[sid] = int(n_pages)
        self.units_used += self.blocks[sid] * extra

    def release(self, sid: int):
        row = self.rows.pop(sid, None)
        if row is None:
            return
        if self.layout == "paged":
            self.units_used -= self.blocks.pop(sid, 0) * \
                self.sid_pages.pop(sid, 0)
            self.pages.free_row(row)
        else:
            self.slots_used -= self.blocks.pop(sid, 0)
        self._free.append(row)
        # stale row contents are never observable: a new occupant's prefill
        # overwrites [:prompt_len] of K/V, [:enc_len] of cross K/V and the
        # recurrent state whole, decode attention masks kv_pos > pos and
        # cross attention kv_pos >= enc_len.  Freed pages re-enter the
        # free list with stale contents under the same invariant: a row
        # reads a page only at masked-in positions it has written itself

    def usage(self) -> Tuple[int, int]:
        """(used, capacity): block-slots (slab) or page-units (paged)."""
        if self.layout == "paged":
            return self.units_used, self.cap_units
        return self.slots_used, self.cap_slots

    def page_table(self) -> torch.Tensor:
        """The device copy of the page table (int64), uploaded again only
        after the table changed — each upload through its own pinned
        buffer, so no step reads a table a later upload overwrites."""
        v = self.pages.version
        if self._table_dev is None or self._table_dev[0] != v:
            self._table_dev = (v, to_device(
                self.pages.table.astype(np.int64), self.device))
        return self._table_dev[1]

    def n_sessions(self) -> int:
        return len(self.rows)

    # -- prefill writes -----------------------------------------------------
    def write_prefill_range(self, lo_rel: int, hi_rel: int, row: int,
                            entries: List[Dict], length: int):
        """Insert single-session per-layer cache entries (batch dim 1, one
        per layer in [lo_rel, hi_rel)) into the pool row: K/V at
        [:length] (paged: page by page into the row's pages), cross K/V at
        their own (encoder) length, recurrent state whole."""
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
                if key in LENGTH_KEYS and self.layout == "paged":
                    pg = self.page_size
                    for pi in range(self.pages_needed(length)):
                        ppid = int(self.pages.table[row, pi])
                        a, b = pi * pg, min(length, (pi + 1) * pg)
                        t[key][lo - rlo:hi - rlo, ppid, :b - a] = \
                            stacked[:, a:b]
                elif key in LENGTH_KEYS:
                    t[key][lo - rlo:hi - rlo, row, :length] = \
                        stacked[:, :length]
                elif key in CROSS_KEYS:
                    t[key][lo - rlo:hi - rlo, row, :stacked.shape[1]] = \
                        stacked
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


def _masked_ranged_write(leaf, chunk, active, lo: int, span: int,
                         t0: int = 0):
    """In place: ``leaf[:, lo:lo+span] = chunk`` on active rows.  ``leaf``
    is the time shard whose first position is ``t0``: only the part of
    [lo, lo + span) it holds is written."""
    a, b = max(lo, t0), min(lo + span, t0 + leaf.shape[1])
    if a >= b:
        return
    old = leaf[:, a - t0:b - t0]
    msk = active.reshape((-1,) + (1,) * (chunk.dim() - 1))
    old.copy_(torch.where(msk, chunk[:, a - lo:b - lo].to(old.dtype), old))


def _write_chunks(ctxs, caches, chunks, actives, lo: int, span: int):
    """Each slot's chunk entries (leaf name -> (B, span, ...)) written into
    its cache leaves at [lo, lo + span), each slot the positions of its
    time shard."""
    for c, cache, chunk, a in zip(ctxs, caches, chunks, actives):
        for key, x in chunk.items():
            b, _ = c.time_block(key)
            _masked_ranged_write(cache[key], x, a, lo, span,
                                 b * cache[key].shape[1])


def _prefixes(ctxs, caches, keys, n: int):
    """Per slot: the tuple of its leaves ``keys`` at positions [0, n),
    gathered from the model row's time shards."""
    per_key = [gather_time(ctxs, [c[k] for c in caches], n, k)
               for k in keys]
    return [tuple(pk[s] for pk in per_key) for s in range(len(ctxs))]


def _masked_state_write(cache, state, active):
    """In place: overwrite each recurrent state leaf WHOLE on active rows
    (the reference's ``_mask_tree``); leaves are (n_rows, ...)."""
    for key, new in state.items():
        leaf = cache[key]
        msk = active.reshape((-1,) + (1,) * (leaf.dim() - 1))
        leaf.copy_(torch.where(msk, new.to(leaf.dtype), leaf))


def _slot_ctxs(mesh, rules, whole_time=()):
    """The slots a pooled step runs on: a group's ctxs in slot order, or
    the solo server's one ``NULL`` slot."""
    if mesh is None:
        return [NULL]
    return group_ctxs(mesh, rules, whole_time)


def _row_split(ctxs, mesh, rules, n_rows: int):
    """(rows split over ``data``, each slot's row slice)."""
    split = mesh is not None and rows_split(rules, mesh, n_rows)
    return split, _row_slices(ctxs, n_rows, split)


def _to_slots(ctxs, x, sl, dim: int = 0):
    """Each slot's rows of ``x`` (rows on ``dim``) on its device; None
    stays None."""
    if x is None:
        return None
    idx = (slice(None),) * dim
    return [c.to_here(x[idx + (r,)]) for c, r in zip(ctxs, sl)]


def _public(mesh, body):
    """A step's public form: per-slot lists of run params, shared params
    and state trees on a group, the server's own on a solo one (its one
    slot)."""
    if mesh is not None:
        return body

    def step(run_params, shared_params, pool_trees, *rest, **kw):
        return body([run_params], [shared_params], [pool_trees], *rest,
                    **kw)

    return step


def _prefill_layer(cfg: ModelConfig, kind: str, ctxs, ps, cs, shared, hs,
                   acts, poss, emb0s, encs, offset: int, layer_id: int,
                   backend: str, split: bool):
    """One prefill layer of any block kind on the slots; writes its state
    into the layer's pool leaves ``cs`` on active rows."""
    T = hs[0].shape[1]
    cfg, kind = B.resolve_kind(cfg, kind)
    if kind == "enc":
        return B.encoder_block_full_group(ps, cfg, ctxs, hs, poss, backend)
    if kind == "decoder":
        keys = ("latent", "krope") if cfg.attn_kind == "mla" else ("k", "v")
        prefixes = None if offset == 0 else _prefixes(ctxs, cs, keys, offset)
        h2s, chunks = B.decoder_block_full_group(
            ps, cfg, ctxs, hs, poss, layer_id, prefixes, backend, split)
        _write_chunks(ctxs, cs, chunks, acts, offset, T)
        return h2s
    if kind == "dec":
        n_enc = encs[0].shape[1]
        prefixes = enc_kvs = None
        if offset:  # cross K/V are chunk-independent
            prefixes = _prefixes(ctxs, cs, ("k", "v"), offset)
            enc_kvs = _prefixes(ctxs, cs, ("ck", "cv"), n_enc)
        h2s, chunks = B.cross_decoder_block_full_group(
            ps, cfg, ctxs, hs, poss, encs, prefixes, enc_kvs, backend)
        _write_chunks(ctxs, cs, [{k: ch[k] for k in ("k", "v")}
                                 for ch in chunks], acts, offset, T)
        if not offset:
            _write_chunks(ctxs, cs, [{k: ch[k] for k in ("ck", "cv")}
                                     for ch in chunks], acts, 0, n_enc)
        return h2s
    if kind == "rwkv":
        h2s, states = B.rwkv_block_full_group(ps, cfg, ctxs, hs, backend)
    else:  # mamba, mamba_shared
        h2s, states = B.mamba_block_full_group(ps, cfg, ctxs, hs, backend)
    for c, st, a in zip(cs, states, acts):
        _masked_state_write(c, st, a)
    if kind == "mamba_shared":
        h2s, kvs = B.zamba_shared_full_group(shared, cfg, ctxs, h2s, emb0s,
                                             poss, backend)
        _write_chunks(ctxs, cs, kvs, acts, 0, T)
    return h2s


def _prefill_body(cfg: ModelConfig, kinds: Tuple[str, ...], backend: str,
                  mesh, rules, whole_time=()):
    runs = kind_runs(kinds)
    for kind, _, _ in runs:
        _check_kind(kind)
    ctxs = _slot_ctxs(mesh, rules, whole_time)

    def step(slot_params, slot_shared, slot_pools, h, emb0, layer_active,
             layer_ids, offset, enc_rows=None, phase="all"):
        T = h.shape[1]
        split, sl = _row_split(ctxs, mesh, rules, h.shape[0])
        hs = _to_slots(ctxs, h, sl)
        acts = _to_slots(ctxs, layer_active, sl, dim=1)
        emb0s = _to_slots(ctxs, emb0, sl)
        encs = _to_slots(ctxs, enc_rows, sl)
        poss = [offset + torch.arange(T, device=x.device) for x in hs]
        for r, (kind, lo, hi) in enumerate(runs):
            if (phase == "enc" and kind != "enc") or \
                    (phase == "dec" and kind == "enc"):
                continue
            if _STATE_SPECS[kind].recurrent and offset != 0:
                raise ValueError(
                    f"recurrent-state kind {kind!r} cannot resume prefill "
                    "at a nonzero chunk offset")
            for i in range(hi - lo):
                act = [a[lo + i] for a in acts]
                h2s = _prefill_layer(
                    cfg, kind, ctxs,
                    [layer_params(sp[r], i) for sp in slot_params],
                    [layer_params(tr[r], i) for tr in slot_pools],
                    slot_shared, hs, act, poss, emb0s, encs, offset,
                    layer_ids[lo + i], backend, split)
                hs = [torch.where(a[:, None, None], x2, x)
                      for a, x2, x in zip(act, h2s, hs)]
        return _gather_rows(ctxs, hs, split, h.device)

    return step


def make_pool_prefill_step(cfg: ModelConfig, kinds: Tuple[str, ...],
                           backend: str = "kernel", mesh=None, rules=None):
    """THE multi-session prefill step of a hosted block range.

    step(run_params, shared_params, pool_trees, h, emb0, layer_active,
         layer_ids, offset, enc_rows=None, phase="all") -> h

    * ``run_params``: per-run stacked block params (axis 0 = run layers);
      ``shared_params``: zamba2's parameter-shared attention block (None
      otherwise),
    * ``pool_trees``: per-run state trees (``CachePool.tree``), written in
      place on active rows: the chunk's K/V at [offset, offset + T), the
      recurrent state whole.  They may be one row's views
      (``pool_row_view``), ``h`` then that row alone,
    * ``h``: (n_rows, T, d) right-padded hidden rows; ``emb0``: (n_rows, T,
      d) original embeddings for shared-attention blocks (None otherwise),
    * ``layer_active``: (n_layers, n_rows) bool tensor; ``layer_ids``:
      absolute layer indices (python ints, for per-layer windows),
    * ``offset``: chunk start; attention rows attend over their pool cache
      [0, offset) plus the chunk (chunked prefill).  Recurrent kinds (rwkv,
      mamba, mamba_shared) need ``offset == 0`` and ``T`` equal to the true
      prompt length: their state is order-sensitive, so the engine groups
      them by exact length and never pads or chunks them,
    * ``phase``: "all" (single-phase stacks), "enc" (only encoder runs;
      ``h`` carries the frame embeddings, exact length, non-causal; it
      reads and writes no pool state, so its rows need not be the
      pool's: the engine passes one session's row) or
      "dec" (every other run; ``h`` carries the token chunk),
    * ``enc_rows``: (n_rows, S_enc, d) encoder outputs of the rows for
      ``dec`` runs; their cross K/V are projected at ``offset == 0`` and
      written at [0, S_enc), and read back from the pool at later offsets.

    On a device group (``mesh``; ``rules``: its layout rules) the same
    contract with per-slot params and state trees (``run_params[s][run]``,
    ``pool_trees[s][run]``); ``h`` and the masks stay on the caller's
    device and the result is returned there.
    """
    return _public(mesh, _prefill_body(cfg, kinds, backend, mesh, rules))


def _decode_layer(cfg: ModelConfig, kind: str, ctxs, ps, cs, shared, hs,
                  acts, poss, emb0s, enc_lens, layer_id: int, backend: str,
                  split: bool, moe_ep: bool):
    """One decode layer of any block kind on the slots: attention caches
    written in place, recurrent states overwritten whole on active rows."""
    cfg, kind = B.resolve_kind(cfg, kind)
    if kind == "decoder":
        return B.decoder_block_decode_group(ps, cfg, ctxs, hs, cs, poss,
                                            layer_id, acts, backend, split,
                                            moe_ep)
    if kind == "dec":
        return B.cross_decoder_block_decode_group(ps, cfg, ctxs, hs, cs, poss,
                                                  enc_lens, acts, backend)
    if kind == "rwkv":
        h2s, states = B.rwkv_block_decode_group(ps, cfg, ctxs, hs, cs)
    else:  # mamba, mamba_shared
        h2s, states = B.mamba_block_decode_group(
            ps, cfg, ctxs, hs, [{"ssm": c["ssm"], "conv": c["conv"]}
                                for c in cs])
        if kind == "mamba_shared":
            h2s = B.zamba_shared_decode_group(shared, cfg, ctxs, h2s, emb0s,
                                              cs, poss, acts, backend)
    for c, st, a in zip(cs, states, acts):
        _masked_state_write(c, st, a)
    return h2s


def _decode_body(cfg: ModelConfig, kinds: Tuple[str, ...], backend: str,
                 mesh, rules, moe_ep: bool, whole_time=()):
    runs = kind_runs(kinds)
    for kind, _, _ in runs:
        _check_kind(kind)
    ctxs = _slot_ctxs(mesh, rules, whole_time)

    def step(slot_params, slot_shared, slot_pools, h, pos, emb0,
             layer_active, layer_ids, enc_len=None):
        split, sl = _row_split(ctxs, mesh, rules, h.shape[0])
        hs = _to_slots(ctxs, h, sl)
        poss = _to_slots(ctxs, pos, sl)
        acts = _to_slots(ctxs, layer_active, sl, dim=1)
        emb0s = _to_slots(ctxs, emb0, sl)
        enc_lens = _to_slots(ctxs, enc_len, sl)
        for r, (kind, lo, hi) in enumerate(runs):
            if kind == "enc":
                continue
            if kind == "dec" and enc_len is None:
                raise ValueError("dec blocks decode with a per-row enc_len")
            for i in range(hi - lo):
                act = [a[lo + i] for a in acts]
                h2s = _decode_layer(
                    cfg, kind, ctxs,
                    [layer_params(sp[r], i) for sp in slot_params],
                    [layer_params(tr[r], i) for tr in slot_pools],
                    slot_shared, hs, act, poss, emb0s, enc_lens,
                    layer_ids[lo + i], backend, split, moe_ep)
                hs = [torch.where(a[:, None, None], x2, x)
                      for a, x2, x in zip(act, h2s, hs)]
        return _gather_rows(ctxs, hs, split, h.device)

    return step


def make_pool_decode_step(cfg: ModelConfig, kinds: Tuple[str, ...],
                          backend: str = "kernel", mesh=None, rules=None,
                          moe_ep: bool = False):
    """THE pooled decode step of a hosted block range.

    step(run_params, shared_params, pool_trees, h, pos, emb0, layer_active,
         layer_ids, enc_len=None) -> h

    ``h``: (n_rows, 1, d); ``pos``: (n_rows,) integer tensor — each row's
    cache write/attend position; ``emb0``: (n_rows, 1, d) current-token
    embeddings for shared-attention blocks (None otherwise); ``enc_len``:
    (n_rows,) integer tensor — each row's encoder length, the cross
    attention mask of ``dec`` blocks.  Each active row's new K/V is
    written into the pool in place and its recurrent state overwritten
    whole; inactive rows keep their hidden state and state.  Encoder runs
    are skipped: they do no decode work.  The recurrent steps are
    elementwise: no kernel.

    On a device group, per-slot params and state trees as in
    :func:`make_pool_prefill_step`; ``moe_ep`` routes the MoE through the
    pure-EP all-to-all (``_ep_row_grid``)."""
    return _public(mesh, _decode_body(cfg, kinds, backend, mesh, rules,
                                      moe_ep))


def make_pool_round_step(cfg: ModelConfig, kinds: Tuple[str, ...],
                         backend: str = "kernel", mesh=None, rules=None,
                         moe_ep: bool = False):
    """THE fused per-(hop, server) dispatch of a device-resident decode
    round: gather the hop's rows out of the round buffers, run the pooled
    decode step, scatter the results back — no host round trip.

    hop(run_params, shared_params, pool_trees, h_round, pos_round,
        emb0_round, slot_of_row, row_of_slot, layer_active, layer_ids,
        encl_round=None) -> h_round

    * ``h_round``: (W, 1, d) round-resident hidden states (W fixed),
    * ``pos_round`` / ``encl_round``: (W,) per-slot cache position and
      encoder length (enc-dec stacks; else None); ``emb0_round``: (W, 1,
      d) round-start embeddings for shared-attention stacks (else None),
    * ``slot_of_row``: (n_rows,) — the round slot feeding each pool row
      (-1: not in the hop; a clipped placeholder ``layer_active`` masks),
    * ``row_of_slot``: (W,) — the pool row each slot takes its result from
      (-1 keeps the slot's hidden state).

    On a device group the round buffers stay on the caller's device and
    the hop's rows are staged to the slots."""
    step = make_pool_decode_step(cfg, kinds, backend, mesh, rules, moe_ep)

    def hop(run_params, shared_params, pool_trees, h_round, pos_round,
            emb0_round, slot_of_row, row_of_slot, layer_active, layer_ids,
            encl_round=None):
        return _round_hop(
            lambda h, pos, emb0, enc_len: step(
                run_params, shared_params, pool_trees, h, pos, emb0,
                layer_active, layer_ids, enc_len),
            h_round, pos_round, emb0_round, slot_of_row, row_of_slot,
            encl_round)

    return hop


def _round_hop(step, h_round, pos_round, emb0_round, slot_of_row,
               row_of_slot, encl_round=None):
    """Gather a hop's rows out of the round buffers, run ``step(h, pos,
    emb0, enc_len)`` over them, scatter the results back."""
    W = h_round.shape[0]
    n_rows = slot_of_row.shape[0]
    src = slot_of_row.clamp(0, W - 1)
    emb0 = None if emb0_round is None else emb0_round[src]
    enc_len = None if encl_round is None else encl_round[src]
    h_out = step(h_round[src], pos_round[src], emb0, enc_len)
    back = h_out[row_of_slot.clamp(0, n_rows - 1)]
    keep = (row_of_slot >= 0)[:, None, None]
    return torch.where(keep, back, h_round)


# ---------------------------------------------------------------------------
# Paged steps: gather pages -> run the slab step -> scatter back
# ---------------------------------------------------------------------------
#
# The paged entry points reimplement no block math.  They gather each
# row's pages into scratch whose self-KV leaves have the exact contiguous
# (layers, n_rows, max_len, Kv, hd) slab shape, run the UNCHANGED slab step
# on it (which writes the scratch and the row-resident leaves in place),
# and scatter the written pages back into the physical page arrays.  Paged
# results equal slab results: positions inside a session's pages hold the
# same values either way, and positions outside (trash-page garbage where
# the slab holds stale rows) are read only through the causal masks, whose
# probabilities are exactly zero in both layouts (K1 reads only [lo, hi);
# K2 masks with a finite -1e30 and zeroed probabilities).


# A slot's page arrays may hold only its block of each page's offsets (the
# reference's ``kv_time`` on the offset axis, where the page size divides
# its extent): the gather then joins the time row's offset blocks into
# whole pages (``GroupCtx.time_row``, an all-gather, counted), the step runs
# on whole-time scratch (``PAGED_WHOLE``), and each slot writes back only
# its own offsets.  Every slot of such a row computes the same K/V (the KV
# heads replicate wherever time shards), so each holds the whole written
# page.

PAGED_WHOLE = LENGTH_KEYS


def page_blocks(mesh, specs) -> int:
    """Data blocks the page arrays of a group pool split their page axis
    into (1: whole on every slot), from the pool's specs
    (``group_pool_specs``)."""
    if mesh is None:
        return 1
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    for tree in specs:
        for key in _LENGTH_KEYS:
            if key in tree:
                e = tree[key][1]
                axes = () if e is None else e if isinstance(e, tuple) \
                    else (e,)
                return int(np.prod([sizes[a] for a in axes]))
    return 1


def _holders(ctx, pids, n_local: int, n_blocks: int):
    """Per data block ``d`` of the page axis: (the slot holding it, mask of
    the ``pids`` it holds, their local ids there); one block of every page
    on this slot itself when the axis is whole."""
    if n_blocks == 1:
        return [(ctx.slot, None, pids)]
    block = torch.div(pids, n_local, rounding_mode="floor")
    return [(ctx.slot_at(data=d), block == d, pids - d * n_local)
            for d in range(n_blocks)]


def _read_pages(ctx, Xs, pt, n_blocks: int):
    """This slot's rows' pages ``Xs[holder][:, pt]`` (``pt`` its rows of
    the page table, global page ids): each data block's pages read on its
    holder and moved here, the rows' own pages selected (a page of
    another data slot is a counted "page-read")."""
    out = None
    n_local = Xs[ctx.slot].shape[1]
    for src, mask, local in _holders(ctx, pt, n_local, n_blocks):
        X = Xs[src]
        idx = local.clamp(0, n_local - 1).to(X.device, non_blocking=True)
        part = ctx.receive(X[:, idx], src, "page-read")
        if mask is None:
            return part
        m = mask.reshape((1,) + tuple(mask.shape) + (1,) * (part.dim() - 3))
        out = part if out is None else torch.where(m, part, out)
    return out


def _write_pages(ctx, Xs, pids, vals, n_blocks: int):
    """In place: page ``pids[e]`` (global ids, (E,)) of the arrays ``Xs``
    (per slot) takes ``vals[:, e]``, on the slot that holds it.  A holder
    receives every entry, the others redirected to one of its own entries
    (same page, same value) or, with none, to its local page 0 with that
    page's own value, so no page is written twice with different values
    (the trash page aside).  A move to another data slot is a counted
    "page-write"."""
    n_local = Xs[ctx.slot].shape[1]
    for dst, mask, local in _holders(ctx, pids, n_local, n_blocks):
        X = Xs[dst]
        if mask is None:
            X[:, local] = vals
            continue
        first = torch.argmax(mask.to(torch.int32))[None]
        any_ = mask.any()
        fb_idx = torch.where(any_, local.gather(0, first), 0)
        own = ctx.receive(X[:, :1], dst, "page-read")
        fb_val = torch.where(any_, vals.index_select(1, first), own)
        m = mask.reshape((1, -1) + (1,) * (vals.dim() - 2))
        idx = torch.where(mask, local, fb_idx)
        src = torch.where(m, vals, fb_val)
        src = ctx.send(src, dst, "page-write")
        X[:, idx.to(X.device, non_blocking=True)] = src


def _gather_paged(ctxs, runs, slot_pools, pts, page_size: int,
                  n_blocks: int = 1):
    """Per slot, slab-shaped scratch: self-KV leaves (L, n_phys, page, ...)
    -> (L, n_rows, max_pages*page, ...) by one indexed gather per leaf and
    page holder (``n_blocks`` > 1: the page axis split over ``data``, each
    page read from its holder) and the row's offset blocks joined into
    whole pages; row-resident leaves pass through (the step writes them in
    place)."""
    scratch = [[dict(tr[r]) for r in range(len(runs))] for tr in slot_pools]
    for r in range(len(runs)):
        leaves = [_length_leaves(tr[r]) for tr in slot_pools]
        for li, (names, X) in enumerate(leaves[0]):
            Xs = [lv[li][1] for lv in leaves]
            parts = [_read_pages(c, Xs, pt, n_blocks)
                     for c, pt in zip(ctxs, pts)]
            if X.shape[2] != page_size:  # offset blocks over a time row
                parts = [c.all_gather([parts[s] for s in c.time_row(
                    names[0])], dim=3) for c in ctxs]
            for sc, part in zip(scratch, parts):
                L, n_rows, max_pages = part.shape[:3]
                sc[r].update(_as_leaves(sc[r], names, part.reshape(
                    (L, n_rows, max_pages * page_size) + part.shape[4:])))
    return [tuple(sc) for sc in scratch]


def _scatter_paged(ctx, runs, pool_trees, scratch, page_table,
                   page_size: int, pos=None, slot_pools=None,
                   n_blocks: int = 1):
    """Fold one slot's scratch writes back into the physical page arrays
    (its own offset block of each page where the offsets shard):
    ``pool_trees`` its own, or with ``slot_pools`` (every slot's, in slot
    order) and ``n_blocks`` > 1 each page's holder's.

    ``pos is None`` (prefill): every table entry writes its page back —
    rows the step masked out write their own gathered values.  ``pos``
    (n_rows,) (decode): only the page holding each row's write position
    goes back (page index ``pos // page_size`` and page id computed on the
    device).  Unassigned entries all target the trash page 0, whose
    contents are unspecified but never read at a masked-in position; no
    real page is written twice in one call (rows own disjoint pages)."""
    n_rows, max_pages = page_table.shape
    pools = dict(enumerate(slot_pools)) if slot_pools is not None else \
        {ctx.slot: pool_trees}
    for r in range(len(runs)):
        for li, (names, S) in enumerate(_length_leaves(scratch[r])):
            Xs = {s: _length_leaves(tr[r])[li][1] for s, tr in pools.items()}
            X = Xs[ctx.slot]
            # X (L, n_phys or its block, page / blocks, ...); S the
            # slab-shaped scratch
            S = S.view((X.shape[0], n_rows, max_pages, page_size)
                       + X.shape[3:])
            w = X.shape[2]
            if w != page_size:
                b, _ = ctx.time_block(names[0])
                S = S[:, :, :, b * w:(b + 1) * w]
            if pos is None:
                pids, vals = page_table.reshape(-1), S.flatten(1, 2)
            else:
                pidx = torch.clamp(pos // page_size, 0, max_pages - 1)
                pids = page_table.gather(1, pidx[:, None])[:, 0]
                rows = torch.arange(n_rows, device=pidx.device)
                vals = S[:, rows, pidx]
            _write_pages(ctx, Xs, pids, vals, n_blocks)


def _slot_pages(ctxs, mesh, rules, page_table):
    """Each slot's rows of the page table, on its device, and their
    slices."""
    _, sl = _row_split(ctxs, mesh, rules, page_table.shape[0])
    return [c.to_here(page_table[r]) for c, r in zip(ctxs, sl)], sl


def make_paged_decode_step(cfg: ModelConfig, kinds: Tuple[str, ...],
                           backend: str = "kernel", page_size: int = 16,
                           mesh=None, rules=None, moe_ep: bool = False,
                           n_blocks: int = 1):
    """Paged twin of :func:`make_pool_decode_step`: the same contract with
    the device page table ``(n_rows, max_pages)`` inserted after the pool
    trees.  Each slot gathers its rows' pages into its scratch and
    scatters them back — from and to the data slot holding each page
    where the page axis splits into ``n_blocks`` (``page_blocks``)."""
    body = _decode_body(cfg, kinds, backend, mesh, rules, moe_ep,
                        PAGED_WHOLE)
    runs = kind_runs(kinds)
    ctxs = _slot_ctxs(mesh, rules)

    def step(slot_params, slot_shared, slot_pools, page_table, h, pos,
             emb0, layer_active, layer_ids, enc_len=None):
        pts, sl = _slot_pages(ctxs, mesh, rules, page_table)
        scratch = _gather_paged(ctxs, runs, slot_pools, pts, page_size,
                                n_blocks)
        h = body(slot_params, slot_shared, scratch, h, pos, emb0,
                 layer_active, layer_ids, enc_len)
        for c, tr, sc, pt, r in zip(ctxs, slot_pools, scratch, pts, sl):
            _scatter_paged(c, runs, tr, sc, pt, page_size, c.to_here(pos[r]),
                           list(slot_pools), n_blocks)
        return h

    return _public(mesh, step)


def make_paged_prefill_step(cfg: ModelConfig, kinds: Tuple[str, ...],
                            backend: str = "kernel", page_size: int = 16,
                            mesh=None, rules=None, n_blocks: int = 1):
    """Paged twin of :func:`make_pool_prefill_step` (page table inserted
    after the pool trees; ``n_blocks`` as in
    :func:`make_paged_decode_step`).  The encoder phase touches no pool
    state, so it gathers and scatters no pages."""
    body = _prefill_body(cfg, kinds, backend, mesh, rules, PAGED_WHOLE)
    runs = kind_runs(kinds)
    ctxs = _slot_ctxs(mesh, rules)

    def step(slot_params, slot_shared, slot_pools, page_table, h, emb0,
             layer_active, layer_ids, offset, enc_rows=None, phase="all"):
        if phase == "enc":
            return body(slot_params, slot_shared, slot_pools, h, emb0,
                        layer_active, layer_ids, offset, enc_rows, phase)
        pts, _ = _slot_pages(ctxs, mesh, rules, page_table)
        scratch = _gather_paged(ctxs, runs, slot_pools, pts, page_size,
                                n_blocks)
        h = body(slot_params, slot_shared, scratch, h, emb0, layer_active,
                 layer_ids, offset, enc_rows, phase)
        for c, tr, sc, pt in zip(ctxs, slot_pools, scratch, pts):
            _scatter_paged(c, runs, tr, sc, pt, page_size,
                           slot_pools=list(slot_pools), n_blocks=n_blocks)
        return h

    return _public(mesh, step)


def make_paged_round_step(cfg: ModelConfig, kinds: Tuple[str, ...],
                          backend: str = "kernel", page_size: int = 16,
                          mesh=None, rules=None, moe_ep: bool = False,
                          n_blocks: int = 1):
    """Paged twin of :func:`make_pool_round_step`: the fused hop with the
    page gather/scatter around the same decode step.  Rows outside the hop
    take a placeholder position; the page it selects is the row's own (a
    write of its own gathered values) or the trash page."""
    step = make_paged_decode_step(cfg, kinds, backend, page_size, mesh,
                                  rules, moe_ep, n_blocks)

    def hop(run_params, shared_params, pool_trees, page_table, h_round,
            pos_round, emb0_round, slot_of_row, row_of_slot, layer_active,
            layer_ids, encl_round=None):
        return _round_hop(
            lambda h, pos, emb0, enc_len: step(
                run_params, shared_params, pool_trees, page_table, h, pos,
                emb0, layer_active, layer_ids, enc_len),
            h_round, pos_round, emb0_round, slot_of_row, row_of_slot,
            encl_round)

    return hop


# ---------------------------------------------------------------------------
# Device groups: slot pools, the EP gate and the row split
# ---------------------------------------------------------------------------


_LENGTH_KEYS = ("k", "v", "latent", "krope")
_TIME_KEYS = frozenset(_LENGTH_KEYS) | CROSS_KEYS


def group_pool_specs(mesh, rules: Dict, tree, paged: bool):
    """Per-leaf specs of a group pool's state tree: the reference's
    ``pool_tree_shardings`` under the serving rules (rows over ``data``,
    KV heads or the time axis over ``model``; the page arrays' page axis
    over ``data`` where ``n_phys + 1`` pages divide it, and a row's page
    read from and written to its holder: ``page_blocks``).
    ``NotImplementedError`` where the rules shard a time axis the guard
    keeps whole (a length that does not divide the model extent) outside
    the page arrays: the steps read a slot's time shard from the rules."""
    specs = pool_tree_shardings(mesh, rules, tree)
    for key, sp in specs.items():
        if key not in _TIME_KEYS or (paged and key in _LENGTH_KEYS):
            continue
        r = dict(rules)
        ax = r.get(cache_axes_for(key, 5, r)[2])
        if "model" in (ax if isinstance(ax, tuple) else (ax,)) and \
                sp[2] is None and mesh.devices.shape[1] > 1:
            raise NotImplementedError(
                f"the rules shard the time axis of {key!r} "
                f"({tree[key].shape[2]} positions) over a model extent that "
                "does not divide it: not emulated (ROADMAP A10(b))")
    return specs


def _ep_row_grid(cfg: ModelConfig, mesh, frozen_rules, p_stack,
                 n_rows: int) -> Optional[Tuple[int, int]]:
    """(B, S) grid of the decode rows that sends a decoder run's MoE
    through the pure-EP all-to-all (``moe._apply_moe_ep``), or None for
    the per-row path — the reference's gate: a group, PADDED expert
    weights, the (data, model) extents dividing the (n_data, n_rows /
    n_data) token grid, a batch rule, and at most 8 tokens a slot (no
    expert can then overflow the minimum capacity, so the mixture is the
    per-row one)."""
    if mesh is None or not cfg.is_moe:
        return None
    ffn = p_stack.get("ffn") if isinstance(p_stack, dict) else None
    if not isinstance(ffn, dict) or "wg" not in ffn:
        return None
    E_alloc = int(ffn["wg"].shape[1])  # (run_layers, E_alloc, d, f)
    if E_alloc == cfg.n_experts:
        return None
    if thaw_rules(frozen_rules).get("batch") is None:
        return None
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    model = sizes.get("model", 1)
    n_data = int(np.prod([sizes[a] for a in ("pod", "data") if a in sizes]))
    n_ep = n_data * model
    if (n_rows % n_data or (n_rows // n_data) % model or E_alloc % n_ep
            or n_rows > 8 * n_ep):
        return None
    return n_data, n_rows // n_data


def rows_split(rules: Dict, mesh, n_rows: int) -> bool:
    """True when a group's pool rows shard over ``data`` (the batch rule
    and the divisibility guard)."""
    n_data = mesh.devices.shape[0]
    return (n_data > 1 and rules.get("batch") is not None
            and n_rows % n_data == 0)


def pool_row_view(trees, row: int, paged: bool):
    """One pool row of a server's per-run state trees, as views: each
    leaf's row axis (the one after the layer axis) cut to ``row:row+1``;
    on the paged layout the page arrays stay whole, their pages addressed
    through that row of the page table.  A pooled step called on these
    views over a batch of one row writes that pool row alone, in place."""
    return tuple({k: x if paged and k in _LENGTH_KEYS else x[:, row:row + 1]
                  for k, x in tree.items()} for tree in trees)


def _row_slices(ctxs, n_rows: int, split: bool):
    if not split:
        return [slice(None)] * len(ctxs)
    w = n_rows // ctxs[0].n_data
    return [slice(c.i * w, (c.i + 1) * w) for c in ctxs]


def _gather_rows(ctxs, hs, split: bool, device):
    """The group's output rows on ``device``: each row block from its
    data index's model-0 slot."""
    if not split:
        return hs[0].to(device, non_blocking=True)
    return torch.cat([hs[c.slot].to(device, non_blocking=True)
                      for c in ctxs if c.j == 0], dim=0)
