"""Geo-distributed serving engine with continuous batching across sessions
— the counterpart of the reference's ``repro/serving/engine.py`` for
decoders (dense or MoE, GQA or MLA), RWKV6, zamba2 hybrids and
encoder-decoder stacks on the slab and paged layouts.

Executes real block-level forward passes according to a BPRR placement
with client-centric (hub-spoke) communication and client-side input
caches, while a virtual clock accounts time with the validated performance
models (eq. (1)).  The clock, admission, routing and failover decisions are
the reference's line for line (they depend only on ``repro_torch.core``,
a copy of the reference's numpy core), so they come out bit-identical.

Each server keeps ONE stacked cache pool (``kv_cache.CachePool``) whose
rows are per-session slots; the pooled steps run all rows with fixed
shapes and write the pool in place.  ``cache_layout="paged"`` books
``page_size``-token pages instead of worst-case rows: sessions grow page
by page while decoding, and under page pressure the engine preempts a
victim (its pages freed, its client-side hop histories kept) and resumes
it later through the failover-replay machinery, billed on the virtual
clock.  A decode round (``decode_mode=
"fused"``) keeps the hidden states on the device from the batched embed to
the round tail: one embed, one gather+step+scatter per (hop, server), one
lm_head+sample tail, and ONE host sync — the token readback.  Prefill rows
are staged in device tensors, never through host memory.  Stacks with
recurrent state (RWKV6, Mamba2) prefill in groups of one exact prompt
length, in one shot; hybrid stacks thread the original embedding
(``emb0``) to their shared-attention blocks in prefill, decode and replay.
Encoder-decoder sessions carry their encoder ``frames``: a group's first
prefill round runs the encoder blocks once per session at the exact
encoder length (groups are keyed by it), the decoder chunks then attend
to the encoder output ``enc_out`` (a device tensor kept on the session,
as the client's cache for failover replay), and decode rounds skip
encoder-only hops.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; ``backend="kernel"`` sends attention on CUDA tensors to
the hand-written kernels.  Sessions sample greedily or by seeded
temperature / top-k (``sampling.SamplingSpec``).  Each server's τ can be
calibrated from the H100 roofline of its pooled decode step
(``calibrate_taus``).

A server can be a TP/EP device group (``device_groups={sid: GroupMesh |
DeviceGroup | None}``, or ``mesh=`` for one group on every server): its
params and pool live per slot under the reference's serving rules
(``launch.sharding``) and its pooled steps run the per-slot body on every
slot (the ``kv_cache`` steps built with ``mesh=``).  Under ``mesh=`` the client's
embedding and LM head run on the group too, vocab-parallel.  The
virtual clock keeps the problem's τ; ``calibrate_taus`` prices each group
per slot, its collectives included.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.perf_model import (Placement, Problem, Route,
                                         with_server_taus)
from repro_torch.core.placement import petals_bp
from repro_torch.core.routing import petals_route, shortest_path_route
from repro_torch.kernels.runtime import count_meta_calls, resolve_backend
from repro_torch.launch.costs import CostSummary, tau_from_step_cost
from repro_torch.launch.sharding import (DeviceGroup, as_device_group,
                                         block_param_axes,
                                         block_param_shardings,
                                         embed_param_axes, freeze_rules,
                                         group_layout_rules, guarded_spec,
                                         serving_rules, shard,
                                         shared_param_axes, thaw_rules)
from repro_torch.models import blocks as B
from repro_torch.models.layers import (count_collectives, embed_frames,
                                       embed_tokens, embed_tokens_group,
                                       group_ctxs, lm_head, lm_head_group,
                                       param_dtype)
from repro_torch.models.model import (block_param_range, layer_params,
                                      tree_map, tree_nbytes)
from repro_torch.serving.faults import (FailureDetector, FaultPlan,
                                        NoCapacityError, recovery_replay_cost)
from repro_torch.serving.kv_cache import (CachePool, _ep_row_grid,
                                          bucket_for, decode_step_bytes,
                                          default_prefill_buckets, kind_runs,
                                          make_paged_decode_step,
                                          make_paged_prefill_step,
                                          make_paged_round_step,
                                          make_pool_decode_step,
                                          make_pool_prefill_step,
                                          make_pool_round_step,
                                          new_state_pool_tree, page_blocks,
                                          pages_for, pool_row_view,
                                          rows_split, state_specs, to_device)
from repro_torch.serving.sampling import (SamplingSpec, make_round_tail,
                                          sample_rows)
from repro_torch.serving.trace import NULL as NULL_TRACER


@dataclass
class EngineSession:
    """Client-side state for one session: its route, token buffer, per-hop
    input history (the failover replay cache), and the virtual-clock
    accounting (prefill / per-token / end times per eq. (1)).  Enc-dec
    sessions also carry their encoder input ``frames`` (S_enc, frame_dim),
    its length and, once prefilled, the encoder output ``enc_out`` (1,
    S_enc, d) on the device, from which failover replay rebuilds the
    cross K/V."""

    sid: int
    client: int
    route: Route
    prompt_len: int
    n_new: int
    arrival: float = 0.0
    start: float = 0.0
    pos: int = 0  # next cache write position
    tokens: List[int] = field(default_factory=list)  # prompt + generated
    n_generated: int = 0
    # admitted | prefilling | active | preempted | failed | done —
    # "preempted": evicted from every route server (page pressure, or a
    # capacity-starved failover deferral); resumed by replay
    state: str = "admitted"
    fail_reason: Optional[str] = None
    n_preemptions: int = 0
    n_detections: int = 0
    n_retries: int = 0
    n_replays: int = 0
    detect_time: float = 0.0
    backoff_time: float = 0.0
    replay_time: float = 0.0
    n_defer_resumes: int = 0
    # per-hop input history: entry 0 is the prompt record (a {"enc", "dec"}
    # dict on enc-dec stacks), then one record per decoded token — a
    # (1, 1, d) tensor on the host-staged paths or a lazy ((members, 1, d)
    # hop gather, index) tuple on the fused path
    hop_inputs: List[List] = field(default_factory=list)
    sampling: SamplingSpec = field(default_factory=SamplingSpec)
    frames: Optional[np.ndarray] = None  # encoder input (enc-dec only)
    enc_len: int = 0
    enc_out: Optional[torch.Tensor] = None  # encoder output, on the device
    virtual_time: float = 0.0
    prefill_time: float = 0.0
    per_token_time: float = 0.0
    end: float = float("inf")
    # logits behind tokens[-1]: a (V,) tensor or a lazy ((W, V), slot)
    _logits_box: Optional[object] = None
    _h: Optional[torch.Tensor] = None  # transient per-round hidden state
    # transient original embedding of the tokens in flight (hybrid stacks)
    _emb0: Optional[torch.Tensor] = None

    @property
    def last_logits(self) -> Optional[torch.Tensor]:
        box = self._logits_box
        if isinstance(box, tuple):  # lazy (rows, slot) from a fused round
            rows, g = box
            box = rows[g]
            self._logits_box = box
        return box

    @last_logits.setter
    def last_logits(self, value):
        self._logits_box = value

    @property
    def recovery_time(self) -> float:
        return self.detect_time + self.backoff_time + self.replay_time


def _shard_tree(tree, specs, mesh):
    """Per slot: the slot's blocks of a {parent: {leaf}} params tree under
    its spec tree."""
    per = {parent: {name: shard(x, specs[parent][name], mesh)
                    for name, x in sub.items()}
           for parent, sub in tree.items()}
    return [{parent: {name: v[s] for name, v in sub.items()}
             for parent, sub in per.items()} for s in range(mesh.size)]


class BlockServer:
    """One 'server': views of the params of its block range + a stacked
    session pool.  Pooled compute entry points: :meth:`decode_rows`,
    :meth:`prefill_rows` and the fused :meth:`round_rows`."""

    def __init__(self, sid: int, cfg: ModelConfig, params, a: int, m: int,
                 *, n_rows: int, max_len: int, cap_slots: int,
                 enc_len: int = 0, slowdown: float = 1.0,
                 backend: str = "kernel",
                 cache_layout: str = "slab", page_size: int = 0,
                 device="cuda", group=None):
        self.sid = sid
        self.backend = backend
        self.cfg = cfg
        self.device = torch.device(device)
        self.a, self.m = int(a), int(m)
        self.specs = state_specs(cfg)[self.a: self.a + self.m]
        self.kinds = tuple(s.kind for s in self.specs)
        self.runs = kind_runs(self.kinds)
        # hosted MoE layers (an MoE config's ``decoder`` blocks; its
        # ``lead`` blocks are dense), for the hops' ``moe_*`` counts
        self.n_moe = self.kinds.count("decoder") if cfg.is_moe else 0
        self.n_enc = cfg.n_enc_layers
        self.shared = params.get("shared")  # zamba2's shared attention
        # per-run stacked block params: views, so replicas share storage
        self.run_params = tuple(
            block_param_range(params, cfg, kind, self.a + lo, self.a + hi)
            for kind, lo, hi in self.runs)
        self.layer_ids = tuple(range(self.a, self.a + self.m))
        self.cache_layout = cache_layout
        # an optional TP/EP device group: params and pool per slot, the
        # steps run the per-slot body on every slot
        self.group = as_device_group(group)
        self.mesh = self.group.mesh
        self.n_chips = self.group.n_chips
        self.mesh_rules = None
        layout = None
        if self.mesh is not None:
            self.mesh_rules = thaw_rules(
                self.group.frozen_rules_for(cfg, n_rows, max_len))
            layout = group_layout_rules(self.mesh_rules)
        self.pool = CachePool(cfg, self.kinds, n_rows, max_len, cap_slots,
                              enc_len=enc_len, layout=cache_layout,
                              page_size=page_size, device=self.device,
                              group=None if layout is None
                              else (self.mesh, layout))
        self.alive = True
        self.crashed = False
        self.suspected = False
        self.slowdown = slowdown
        self._step_cost: Optional[CostSummary] = None
        self._step_params = self.run_params
        self._step_shared = self.shared
        self.moe_ep = False
        if self.mesh is not None:
            layout = self._shard_params(layout)
        group = dict(mesh=self.mesh, rules=layout)
        # a group whose pool rows shard over ``data`` holds each row on one
        # slot: no step there runs on one row's views of the slot trees
        self.row_calls = self.mesh is None or not rows_split(
            layout, self.mesh, n_rows)
        if cache_layout == "paged":
            group["n_blocks"] = page_blocks(self.mesh, self.pool.slot_specs)
            self._step = make_paged_decode_step(
                cfg, self.kinds, backend, page_size, **group,
                moe_ep=self.moe_ep)
            self._round_step = make_paged_round_step(
                cfg, self.kinds, backend, page_size, **group,
                moe_ep=self.moe_ep)
            self._prefill_pool = make_paged_prefill_step(
                cfg, self.kinds, backend, page_size, **group)
        else:
            self._step = make_pool_decode_step(cfg, self.kinds, backend,
                                               **group, moe_ep=self.moe_ep)
            self._round_step = make_pool_round_step(
                cfg, self.kinds, backend, **group, moe_ep=self.moe_ep)
            self._prefill_pool = make_pool_prefill_step(cfg, self.kinds,
                                                        backend, **group)

    def _shard_params(self, layout):
        """Shard the run params per slot (``block_param_shardings`` under
        the group layout); returns the layout the steps run under.  A
        padded MoE that takes the pure-EP all-to-all (``_ep_row_grid``)
        keeps each expert whole on one slot, its experts over (data,
        model)."""
        cfg, mesh = self.cfg, self.mesh
        frozen = freeze_rules(self.mesh_rules)
        self.moe_ep = any(
            _ep_row_grid(cfg, mesh, frozen, p, self.pool.n_rows) is not None
            for p in self.run_params)
        if self.moe_ep:
            layout = dict(layout, experts=("data", "model"), expert_mlp=None)
        self.param_specs = tuple(
            block_param_shardings(mesh, layout,
                                  block_param_axes(cfg, kind, p), p)
            for p, (kind, _, _) in zip(self.run_params, self.runs))
        slots = [[] for _ in range(mesh.size)]
        for p, specs in zip(self.run_params, self.param_specs):
            for s, sp in enumerate(_shard_tree(p, specs, mesh)):
                slots[s].append(sp)
        self.slot_params = tuple(tuple(sp) for sp in slots)
        self._step_params = self.slot_params
        if self.shared is not None and "mamba_shared" in self.kinds:
            specs = block_param_shardings(
                mesh, layout, shared_param_axes(cfg, self.shared),
                self.shared)
            self._step_shared = _shard_tree(self.shared, specs, mesh)
        else:
            self._step_shared = [None] * mesh.size
        self.layout_rules = layout
        return layout

    # -- session admission bookkeeping --------------------------------------
    def fits(self, sid: int, k_blocks: int, n_pages: int = 0,
             worst_pages: Optional[int] = None) -> bool:
        return self.pool.fits(sid, k_blocks, n_pages, worst_pages)

    def admit(self, sid: int, k_blocks: int, n_pages: int = 0) -> int:
        return self.pool.alloc(sid, k_blocks, n_pages)

    def evict(self, sid: int):
        self.pool.release(sid)

    def n_sessions(self) -> int:
        return self.pool.n_sessions()

    def _mask(self, mask: np.ndarray) -> torch.Tensor:
        return to_device(mask, self.device)

    def _layer_mask(self, lo: int, hi: int, n_rows: int, rows
                    ) -> torch.Tensor:
        """The device (m, n_rows) layer mask: blocks [lo, hi) on
        ``rows``."""
        mask = np.zeros((self.m, n_rows), bool)
        mask[lo - self.a: hi - self.a, rows] = True
        return self._mask(mask)

    def _pools(self, row: Optional[int] = None) -> tuple:
        """The pool operands of a step: the state trees, and the device
        page table on the paged layout; with ``row``, that pool row's
        views of them (``pool_row_view``)."""
        paged = self.cache_layout == "paged"
        tree = self.pool.tree if self.mesh is None else self.pool.slot_trees
        if row is not None:
            tree = pool_row_view(tree, row, paged) if self.mesh is None \
                else tuple(pool_row_view(t, row, paged) for t in tree)
        if paged:
            table = self.pool.page_table()
            return tree, table if row is None else table[row:row + 1]
        return (tree,)

    # -- compute ------------------------------------------------------------
    def _layer_params(self, l_rel: int):
        for r, (kind, lo, hi) in enumerate(self.runs):
            if lo <= l_rel < hi:
                return layer_params(self.run_params[r], l_rel - lo)
        raise IndexError(l_rel)

    def prefill_range(self, sid: int, h, lo: int, hi: int, positions,
                      emb0=None, enc_h=None):
        """Prefill blocks [lo, hi) for one session (serial reference path);
        fills its pool row.  ``emb0``: the original embedding that
        shared-attention blocks take; ``enc_h``: the encoder output that
        cross-attention blocks take."""
        assert self.alive, f"server {self.sid} is dead"
        row = self.pool.rows[sid]
        S = h.shape[1]
        if self.mesh is not None:
            # a group prefills through its pooled step, on the row alone
            N = self.pool.n_rows
            h_rows = h.new_zeros((N,) + tuple(h.shape[1:]))
            h_rows[row] = h[0]
            return self.prefill_rows(
                h_rows, self._layer_mask(lo, hi, N, row))[row][None]
        entries = []
        for l in range(lo, hi):
            cfg, kind = B.resolve_kind(self.cfg, self.kinds[l - self.a])
            p = self._layer_params(l - self.a)
            if kind == "decoder":
                h, cache, _ = B.decoder_block_full(
                    p, cfg, h, positions, l, backend=self.backend)
            elif kind == "enc":
                h = B.encoder_block_full(p, self.cfg, h, positions,
                                         backend=self.backend)
                cache = {}
            elif kind == "dec":
                h, cache = B.cross_decoder_block_full(
                    p, self.cfg, h, positions, enc_h, backend=self.backend)
            elif kind == "rwkv":
                h, cache = B.rwkv_block_full(p, self.cfg, h,
                                             backend=self.backend)
            else:  # mamba, mamba_shared
                h, cache = B.mamba_block_full(p, self.cfg, h,
                                              backend=self.backend)
                if kind == "mamba_shared":
                    h, kv = B.zamba_shared_full(
                        self.shared, self.cfg, h, emb0, positions,
                        backend=self.backend)
                    cache = dict(cache, **kv)
            entries.append(cache)
        self.pool.write_prefill_range(lo - self.a, hi - self.a, row,
                                      entries, S)
        return h

    def prefill_rows(self, h_rows, layer_active, offset: int = 0,
                     phase: str = "all", emb0_rows=None, enc_rows=None,
                     row: Optional[int] = None):
        """THE batched prefill: one pooled call prefills a (padded) prompt
        chunk starting at ``offset`` for every masked row, writing the
        chunk's state into the pool.  ``phase``: encoder vs decoder runs of
        enc-dec stacks (``make_pool_prefill_step``); ``emb0_rows``: the
        rows' original embeddings (hybrid stacks); ``enc_rows``: the rows'
        encoder outputs (enc-dec stacks).  ``row`` (servers with
        ``row_calls``): the call runs over that one pool row, every
        ``*_rows`` operand and the mask's row axis holding it alone."""
        assert self.alive, f"server {self.sid} is dead"
        return self._prefill_pool(self._step_params, self._step_shared,
                                  *self._pools(row), h_rows, emb0_rows,
                                  layer_active, self.layer_ids, offset,
                                  enc_rows, phase)

    def decode_rows(self, h_rows, pos_rows, layer_active, emb0_rows=None,
                    enc_len_rows=None):
        """THE batched step: one pooled call decodes all masked rows
        (``enc_len_rows``: the rows' encoder lengths, enc-dec stacks)."""
        assert self.alive, f"server {self.sid} is dead"
        return self._step(self._step_params, self._step_shared,
                          *self._pools(),
                          h_rows, pos_rows, emb0_rows, layer_active,
                          self.layer_ids, enc_len_rows)

    def round_rows(self, h_round, pos_round, slot_of_row, row_of_slot,
                   layer_active, emb0_round=None, encl_round=None):
        """The fused device-resident hop: gather this server's rows out of
        the round buffers, decode them, scatter the results back."""
        assert self.alive, f"server {self.sid} is dead"
        return self._round_step(self._step_params, self._step_shared,
                                *self._pools(), h_round, pos_round,
                                emb0_round, slot_of_row, row_of_slot,
                                layer_active, self.layer_ids, encl_round)

    def decode_range(self, sid: int, h, lo: int, hi: int, pos: int,
                     emb0=None, enc_len: int = 0):
        """Single-session decode of blocks [lo, hi) via the pooled step
        (the same program as the batched path — bit-for-bit identical).
        Encoder blocks in the range are skipped (no decode work)."""
        lo = max(lo, self.n_enc)
        if lo >= hi:
            return h
        row = self.pool.rows[sid]
        N = self.pool.n_rows
        h_rows = h.new_zeros((N,) + tuple(h.shape[1:]))
        h_rows[row] = h[0]
        emb0_rows = None
        if emb0 is not None:
            emb0_rows = emb0.new_zeros((N,) + tuple(emb0.shape[1:]))
            emb0_rows[row] = emb0[0]
        pos_np = np.zeros((N,), np.int64)
        pos_np[row] = pos
        encl_rows = None
        if "dec" in self.kinds:
            encl = np.zeros((N,), np.int64)
            encl[row] = enc_len
            encl_rows = self._mask(encl)
        h_out = self.decode_rows(h_rows, self._mask(pos_np),
                                 self._layer_mask(lo, hi, N, row),
                                 emb0_rows, encl_rows)
        return h_out[row][None]

    def decode_step_cost(self) -> CostSummary:
        """CostSummary of THE pooled decode step this server runs in a
        round: every pool row active at the last cache position
        (``max_seq_len``; cross attention over ``max_enc_len``), slab or
        paged as the server is.  Cached: the step's shapes are fixed.

        ``flops``: every product the step makes — the hosted decoding
        layers' matmuls, counted by ``FlopCounterMode`` over the step run
        on meta tensors, plus attention's score and P·V products, which
        the K1 wrapper adds from its ``cost`` (``count_meta_calls``).  The
        meta run reads no data and launches nothing, so the count is the
        same wherever the server lives.
        ``bytes_accessed``: each operand read once and each output written
        once — the hosted decoding layers' parameters, the pool leaves the
        step reads (paged: every row's pages, as the slab rows, and the
        page table), the token each row writes into each self-attention
        cache and the recurrent states it rewrites, h in and out, and the
        row vectors (positions, layer mask; encoder lengths and ``emb0``
        where the stack takes them)."""
        if self._step_cost is None:
            self._step_cost = self._count_decode_step()
        return self._step_cost

    def _count_decode_step(self) -> CostSummary:
        from torch.utils.flop_counter import FlopCounterMode

        if self.mesh is not None:
            return self._count_group_step()
        cfg, N = self.cfg, self.pool.n_rows
        T, enc_len = self.pool.max_len, self.pool.enc_len
        act = param_dtype(cfg)
        runs = [r for r, (kind, _, _) in enumerate(self.runs)
                if kind != "enc"]

        def meta(tree):
            return tree_map(lambda x: torch.empty_like(x, device="meta"),
                            tree)

        pools = tuple(new_state_pool_tree(cfg, kind, hi - lo, N, T, enc_len,
                                          "meta")
                      for kind, lo, hi in self.runs)
        shared = self.shared if "mamba_shared" in self.kinds else None
        h = torch.empty((N, 1, cfg.d_model), dtype=act, device="meta")
        rows = {"pos": torch.empty((N,), dtype=torch.long, device="meta"),
                "mask": torch.empty((self.m, N), dtype=torch.bool,
                                    device="meta")}
        if shared is not None:
            rows["emb0"] = h
        if "dec" in self.kinds:
            rows["enc_len"] = rows["pos"]
        step = make_pool_decode_step(cfg, self.kinds, "kernel")
        with torch.no_grad(), FlopCounterMode(display=False) as products, \
                count_meta_calls(T - 1, enc_len) as attention:
            step(tuple(meta(p) for p in self.run_params),
                 None if shared is None else meta(shared), pools, h,
                 rows["pos"], rows.get("emb0"), rows["mask"],
                 self.layer_ids, rows.get("enc_len"))
        params = sum(tree_nbytes(self.run_params[r]) for r in runs) \
            + tree_nbytes(shared)
        pool = [decode_step_bytes(pools[r], T) for r in runs]
        nbytes = params + sum(read + written for read, written in pool) \
            + 2 * tree_nbytes(h) + tree_nbytes(rows)
        if self.cache_layout == "paged":
            nbytes += N * self.pool.max_pages * 8  # the int64 page table
        return CostSummary(
            flops=products.get_total_flops() + attention.cost.flops,
            bytes_accessed=nbytes)

    def _count_group_step(self) -> CostSummary:
        """Per-slot cost of a group's pooled decode step: the group step run
        on meta slots (each slot's time shard where the rules give one; a
        paged server's paged step, its page reads and writes across data
        slots included) under ``FlopCounterMode``, K1's ``cost`` (its
        partials and their merge on time shards) and the slot collectives'
        count; flops and wire bytes are the group's over its slot count
        (the slots do like work), bytes those of one slot's shard of the
        params and pool (paged: every row's pages, as the slab rows, and
        the page table) and its rows."""
        from torch.utils.flop_counter import FlopCounterMode

        from repro_torch.launch.mesh import GroupMesh
        from repro_torch.models.model import slot_zeros
        from repro_torch.serving.kv_cache import (group_pool_specs,
                                                  new_paged_pool_tree)

        cfg, N = self.cfg, self.pool.n_rows
        T, enc_len = self.pool.max_len, self.pool.enc_len
        n = self.mesh.size
        meta_mesh = GroupMesh(np.full(self.mesh.devices.shape,
                                      torch.device("meta"), dtype=object))
        layout = self.layout_rules
        full = tuple(new_state_pool_tree(cfg, kind, hi - lo, N, T, enc_len,
                                         "meta")
                     for kind, lo, hi in self.runs)
        specs = tuple(group_pool_specs(meta_mesh, layout, t, False)
                      for t in full)
        pools = tuple(tuple(slot_zeros(t, sp, meta_mesh, s, "meta")
                            for t, sp in zip(full, specs))
                      for s in range(n))

        def meta(tree):
            return None if tree is None else tree_map(
                lambda x: torch.empty_like(x, device="meta"), tree)

        params = tuple(tuple(meta(p) for p in sp) for sp in self.slot_params)
        shared = [meta(p) for p in self._step_shared]
        act = param_dtype(cfg)
        h = torch.empty((N, 1, cfg.d_model), dtype=act, device="meta")
        pos = torch.empty((N,), dtype=torch.long, device="meta")
        mask = torch.empty((self.m, N), dtype=torch.bool, device="meta")
        emb0 = h if shared[0] is not None else None
        enc = pos if "dec" in self.kinds else None
        lead = (params, shared, pools)
        paged = self.cache_layout == "paged"
        if paged:
            pool = self.pool
            ptrees = tuple(new_paged_pool_tree(
                cfg, kind, hi - lo, N, pool.page_size, pool.pages.n_pages + 1,
                enc_len, "meta") for kind, lo, hi in self.runs)
            pspecs = tuple(group_pool_specs(meta_mesh, layout, t, True)
                           for t in ptrees)
            lead = (params, shared, tuple(
                tuple(slot_zeros(t, sp, meta_mesh, s, "meta")
                      for t, sp in zip(ptrees, pspecs)) for s in range(n)),
                torch.empty((N, pool.max_pages), dtype=torch.long,
                            device="meta"))
            step = make_paged_decode_step(
                cfg, self.kinds, "kernel", pool.page_size, meta_mesh, layout,
                self.moe_ep, page_blocks(meta_mesh, pspecs))
        else:
            step = make_pool_decode_step(cfg, self.kinds, "kernel",
                                         meta_mesh, layout, self.moe_ep)
        with torch.no_grad(), FlopCounterMode(display=False) as products, \
                count_meta_calls(T - 1, enc_len) as attention, \
                count_collectives() as coll:
            step(*lead, h, pos, emb0, mask, self.layer_ids, enc)
        rows = N // self.mesh.devices.shape[0] \
            if rows_split(layout, meta_mesh, N) else N
        runs = [r for r, (kind, _, _) in enumerate(self.runs)
                if kind != "enc"]
        pool = [decode_step_bytes(pools[0][r], T) for r in runs]
        row_bytes = (2 + (emb0 is not None)) * cfg.d_model * h.element_size()
        nbytes = sum(tree_nbytes(self.slot_params[0][r]) for r in runs) \
            + tree_nbytes(self._step_shared[0]) \
            + sum(read + written for read, written in pool) \
            + rows * (row_bytes + 8 * (1 + (enc is not None)) + self.m)
        if paged:
            nbytes += rows * self.pool.max_pages * 8  # the int64 page table
        return CostSummary(
            flops=(products.get_total_flops() + attention.cost.flops) / n,
            bytes_accessed=nbytes, coll_wire_bytes=coll.wire / n,
            coll_count=int(round(coll.calls / n)),
            coll_by_kind={k: v / n for k, v in coll.by_kind.items()})


@dataclass
class _PrefillGroup:
    """Co-admitted sessions sharing one route, one prompt-length bucket and
    (enc-dec) one encoder length, prefilled together in chunk rounds
    (``bucket is None``: a chunked group of prompts longer than the
    largest bucket)."""

    route: Route
    bucket: Optional[int]
    members: List[EngineSession]
    enc_len: int = 0  # shared encoder length (enc-dec groups)
    offset: int = 0  # tokens prefilled so far (next chunk start)
    # per-sid per-hop activation chunks, stitched into the client-side
    # failover cache (EngineSession.hop_inputs) at completion
    hop_chunks: Dict[int, List[List[torch.Tensor]]] = field(
        default_factory=dict)
    # per-sid per-hop encoder-phase inputs (enc-dec groups)
    enc_inputs: Dict[int, List[Optional[torch.Tensor]]] = field(
        default_factory=dict)


class GeoServingSystem:
    """Client-centric distributed inference with online BPRR and
    continuous batching across sessions (see the reference's docstring).

    ``prefill_mode``: "batched" (bucket groups) or "serial" (one session
    per call, exact length — the bit-for-bit reference of the batched
    path's token streams).  ``prefill_buckets``: prompt-length buckets
    (default powers of two up to ``max_seq_len``).  ``max_enc_len``: the
    cross-K/V capacity of enc-dec pools (default ``max_seq_len``).
    ``decode_mode``:
    "fused" (device-resident rounds, one host sync) or "serial" (per-session
    embed/lm_head, host-staged hops).  ``backend``: "kernel" (hand-written
    CUDA kernels on CUDA tensors, plain PyTorch on CPU tensors) or "plain".
    ``device``: where pools and round buffers live ("cuda" by default);
    ``params`` must already be there.  ``fault_plan`` / ``detector``:
    deterministic fault injection on the virtual clock and the timeout /
    backoff policy that prices failure detection.
    ``cache_layout``: "slab" books worst-case fixed-width rows at
    admission; "paged" books the prompt's ``page_size``-token pages
    (page-granular eq. (5)/(20) accounting), grows sessions page by page
    and preempts under page pressure — token streams equal the slab
    layout's, and the virtual clock differs by exactly the billed resume
    replay.  ``page_size`` must divide ``max_seq_len`` (default: its
    largest divisor <= 16).

    ``device_groups``: {server id: ``GroupMesh`` | ``DeviceGroup`` | None}
    — each server a TP/EP group of device slots (None or missing: solo);
    ``mesh`` (+ ``mesh_rules``, a rules dict or frozen tuple overriding
    ``serving_rules``): one group on every server, and the client's
    embedding and LM head vocab-parallel on it.  Not both.  Groups take
    every block kind under the reference's serving rules, cache time
    shards included, and the ``head_dim`` fallback where the query heads
    do not divide the model axis: each slot projects its head_dim columns
    of q / k / v, gathered whole over the model row, attends every head
    and adds its ``wo`` rows' partial sum over the row
    (``models.attention``).
    """

    def __init__(self, cfg: ModelConfig, params, problem: Problem,
                 algorithm: str = "proposed", R: Optional[int] = None,
                 max_new_tokens: int = 64, max_sessions: int = 8,
                 max_seq_len: Optional[int] = None,
                 prefill_mode: str = "batched",
                 prefill_buckets: Optional[Tuple[int, ...]] = None,
                 max_enc_len: Optional[int] = None,
                 decode_mode: str = "fused",
                 backend: str = "kernel",
                 cache_layout: str = "slab",
                 page_size: Optional[int] = None,
                 mesh=None, mesh_rules=None, device_groups=None,
                 fault_plan: Optional[FaultPlan] = None,
                 detector: Optional[FailureDetector] = None,
                 device="cuda"):
        assert problem.L == cfg.n_layers
        assert prefill_mode in ("batched", "serial"), prefill_mode
        assert decode_mode in ("fused", "serial"), decode_mode
        assert cache_layout in ("slab", "paged"), cache_layout
        if device_groups is not None and mesh is not None:
            raise ValueError(
                "pass either device_groups= or the global mesh= sugar, "
                "not both")
        if mesh_rules is not None and not isinstance(mesh_rules, tuple):
            mesh_rules = freeze_rules(dict(mesh_rules))
        self.mesh = mesh
        self.mesh_rules = mesh_rules
        if device_groups is not None:
            self.device_groups = {int(j): as_device_group(g)
                                  for j, g in device_groups.items()}
        elif mesh is not None:
            g = DeviceGroup(mesh=mesh, rules=mesh_rules)
            self.device_groups = {j: g for j in range(problem.n_servers)}
        else:
            self.device_groups = {}
        self.backend = resolve_backend(backend)
        self.device = torch.device(device)
        self.cfg = cfg
        self.params = params
        self.problem = problem
        self.algorithm = algorithm
        self.max_new_tokens = max_new_tokens
        self.max_sessions = int(max_sessions)
        self.max_seq_len = int(
            max_seq_len if max_seq_len is not None
            else problem.workload.l_in + max_new_tokens + 32)
        self.cache_layout = cache_layout
        if cache_layout == "paged":
            if page_size is None:  # largest divisor of max_seq_len <= 16
                page_size = next(p for p in range(min(16, self.max_seq_len),
                                                  0, -1)
                                 if self.max_seq_len % p == 0)
            page_size = int(page_size)
            if page_size < 1 or self.max_seq_len % page_size != 0:
                raise ValueError(
                    f"page_size {page_size} must divide max_seq_len "
                    f"{self.max_seq_len}")
        else:
            page_size = 0
        self.page_size = page_size
        # FIFO resume queue (page-pressure preemptions and failover
        # deferrals)
        self._preempt_order: List[int] = []
        self.prefill_mode = prefill_mode
        self.specs = state_specs(cfg)
        self._recurrent = any(s.recurrent for s in self.specs)
        self._needs_emb0 = any(s.needs_emb0 for s in self.specs)
        self._n_enc = int(cfg.n_enc_layers)
        self._is_enc_dec = cfg.is_enc_dec
        self.max_enc_len = int(max_enc_len) if max_enc_len is not None \
            else self.max_seq_len
        if prefill_buckets is None:
            prefill_buckets = default_prefill_buckets(self.max_seq_len)
        self.prefill_buckets = tuple(sorted(
            {min(int(b), self.max_seq_len) for b in prefill_buckets}))
        assert self.prefill_buckets, "prefill_buckets must be non-empty"
        self._prefill_groups: List[_PrefillGroup] = []
        if algorithm == "proposed":
            from repro_torch.core.placement import auto_R, cg_bp
            self.R = R if R is not None else auto_R(problem, 0.1, 60.0)
            self.placement, _ = cg_bp(problem, self.R)
        else:
            self.R = R
            self.placement = petals_bp(problem)
        self.servers: Dict[int, BlockServer] = {}
        self._build_servers()
        self.sessions: Dict[int, EngineSession] = {}
        self._sid = 0
        self.decode_mode = decode_mode
        # under mesh= the client's embedding and LM head are vocab-parallel
        # on the group (model slots split the vocabulary)
        self._client = None if mesh is None else \
            self._client_group(mesh, mesh_rules)
        self._round_tail = make_round_tail(
            cfg, head=None if self._client is None else self._lm_head)
        # fixed round width: the round buffers span W slots whatever the
        # round's membership, so per-session results are bit-identical solo
        # or grouped (grown if a round ever exceeds it)
        self._round_width = max(1, self.max_sessions)
        # per-round dispatch accounting (the perf contract: ONE embed, ONE
        # lm_head+sample tail, one fused dispatch per (hop, server), ONE
        # host sync per round)
        self.round_stats = {"rounds": 0, "embed_dispatches": 0,
                            "tail_dispatches": 0, "hop_dispatches": 0,
                            "preemptions": 0, "resumes": 0,
                            "detections": 0, "retries": 0, "replays": 0,
                            "rejoins": 0, "dispatch_errors": 0,
                            "detect_s": 0.0, "backoff_s": 0.0,
                            "replay_s": 0.0}
        self.fault_plan = fault_plan
        self.detector = detector if detector is not None else \
            FailureDetector()
        self._fault_cursor = 0
        self._dispatch_faults: set = set()
        self._base_taus = [float(s.tau) for s in problem.servers]
        # spans and work counts of the rounds (``serving.trace``): off
        # unless a caller installs a ``Tracer``
        self.tracer = NULL_TRACER

    # ------------------------------------------------------------------
    def _client_group(self, mesh, mesh_rules):
        """(slot ctxs, per-slot embedding trees) of the client on ``mesh``:
        the table's and the head's vocab axis over ``model``."""
        rules = thaw_rules(mesh_rules) if mesh_rules is not None else \
            serving_rules(self.cfg, mesh, self.max_sessions,
                          self.max_seq_len)
        emb = self.params["embed"]
        axes = embed_param_axes(emb)

        def split(x, ax):
            return shard(x, guarded_spec(ax, tuple(x.shape), rules, mesh),
                         mesh)

        per = {k: ({n: split(x, axes[k][n]) for n, x in v.items()}
                   if isinstance(v, dict) else split(v, axes[k]))
               for k, v in emb.items()}
        slots = [{k: ({n: x[s] for n, x in v.items()}
                      if isinstance(v, dict) else v[s])
                  for k, v in per.items()} for s in range(mesh.size)]
        return group_ctxs(mesh, rules), slots

    def _embed(self, tokens) -> torch.Tensor:
        """Embed a host token array (B, S) on the engine's device."""
        tok = to_device(np.asarray(tokens, np.int64), self.device)
        if self._client is not None:
            ctxs, ps = self._client
            return embed_tokens_group(ps, self.cfg, ctxs, [
                c.to_here(tok) for c in ctxs])[0].to(self.device)
        return embed_tokens(self.params["embed"], self.cfg, tok)

    def _embed_frames(self, frames) -> torch.Tensor:
        """Embed one session's host frames (S_enc, frame_dim) as (1,
        S_enc, d) on the engine's device."""
        fr = to_device(np.asarray(frames, np.float32)[None], self.device)
        return embed_frames(self.params["embed"], self.cfg, fr)

    def _lm_head(self, h) -> torch.Tensor:
        if self._client is not None:
            ctxs, ps = self._client
            return lm_head_group(ps, self.cfg, ctxs, [
                c.to_here(h) for c in ctxs])[0].to(self.device)
        return lm_head(self.params["embed"], self.cfg, h)

    def _cap_slots(self, j: int, m: int) -> int:
        spec = self.problem.servers[j]
        cap = int(np.floor(
            (spec.mem_bytes - self.problem.s_m * m) / self.problem.s_c))
        return max(cap, 0)

    def _build_servers(self):
        for j in range(self.problem.n_servers):
            a, m = int(self.placement.a[j]), int(self.placement.m[j])
            if m <= 0:
                continue
            if j in self.servers:
                continue  # keep live objects (running sessions hold caches)
            cap = self._cap_slots(j, m)
            # pool arrays need >= 1 row for fixed shapes, but the
            # block-slot budget stays honest: cap == 0 admits nothing.
            # Paged layout: rows are cheap (the self-KV bytes live in the
            # shared page arrays), so every session the engine could host
            # gets a row and the page-unit budget bounds co-residency
            if self.cache_layout == "paged":
                n_rows = max(1, self.max_sessions)
            else:
                n_rows = max(1, min(self.max_sessions, cap))
            self.servers[j] = BlockServer(
                j, self.cfg, self.params, a, m, n_rows=n_rows,
                max_len=self.max_seq_len, cap_slots=cap,
                enc_len=self.max_enc_len if self._is_enc_dec else 0,
                backend=self.backend, cache_layout=self.cache_layout,
                page_size=self.page_size, device=self.device,
                group=self.device_groups.get(j))

    def alive_placement(self) -> Placement:
        a = np.array(self.placement.a)
        m = np.array(self.placement.m)
        for j in range(len(m)):
            if j in self.servers and not self.servers[j].alive:
                m[j] = 0
            if j not in self.servers:
                m[j] = 0
        return Placement(a=a, m=m)

    # ------------------------------------------------------------------
    # τ calibration from each server's pooled step
    # ------------------------------------------------------------------
    def calibrate_taus(self) -> Dict[int, float]:
        """Per-server τ (per-block per-token decode seconds, eq. (1)): the
        H100 roofline of each server's pooled decode step
        (``BlockServer.decode_step_cost``, ``launch.costs``) over its
        hosted blocks × pool rows.  A group's step is priced per slot, its
        collectives over NVLink, so groups of different sizes give
        different τ."""
        return {j: tau_from_step_cost(srv.decode_step_cost(), srv.n_chips,
                                      srv.m, srv.pool.n_rows)
                for j, srv in self.servers.items()}

    def calibrated_problem(self) -> Problem:
        """A copy of ``self.problem`` whose server τs come from
        :meth:`calibrate_taus` — feed it back into placement / the
        simulator.  The live engine's virtual clock keeps the original
        problem."""
        return with_server_taus(self.problem, self.calibrate_taus())

    # ------------------------------------------------------------------
    # Session lifecycle (continuous batching API)
    # ------------------------------------------------------------------
    def create_session(self, tokens: np.ndarray, client: int, route: Route,
                       n_new: int, arrival: float = 0.0,
                       frames: Optional[np.ndarray] = None,
                       sampling: Optional[SamplingSpec] = None) -> int:
        """Register an admitted session (no compute, no slots yet).
        ``frames``: (S_enc, frame_dim) encoder input — required for enc-dec
        stacks, refused otherwise.  Raises ``ValueError`` when a hop's
        blocks are not hosted by its server (a check the reference does
        not make: its layer masks would skip the missing blocks without a
        word)."""
        e = 0
        for hop, (j, k) in enumerate(zip(route.servers, route.blocks)):
            srv = self.servers.get(int(j))
            if srv is None or not (srv.a <= e and e + k <= srv.a + srv.m):
                hosted = "none" if srv is None else \
                    f"[{srv.a}, {srv.a + srv.m})"
                raise ValueError(
                    f"route hop {hop}: server {int(j)} does not host blocks "
                    f"[{e}, {e + k}) (it hosts {hosted})")
            e += k
        S = len(tokens)
        if S + n_new > self.max_seq_len:
            raise ValueError(
                f"prompt {S} + n_new {n_new} exceeds max_seq_len "
                f"{self.max_seq_len}; raise max_seq_len at engine build")
        enc_len = 0
        if self._is_enc_dec:
            if frames is None:
                raise ValueError(
                    "enc-dec stacks need encoder `frames` per session")
            frames = np.asarray(frames)
            if frames.ndim != 2 or frames.shape[1] != self.cfg.frame_dim:
                raise ValueError(
                    f"frames must be (S_enc, {self.cfg.frame_dim}); got "
                    f"{frames.shape}")
            enc_len = int(frames.shape[0])
            if enc_len > self.max_enc_len:
                raise ValueError(
                    f"encoder input {enc_len} exceeds max_enc_len "
                    f"{self.max_enc_len}; raise max_enc_len at engine build")
        elif frames is not None:
            raise ValueError("`frames` is only meaningful for enc-dec stacks")
        sid = self._sid
        self._sid += 1
        self.sessions[sid] = EngineSession(
            sid=sid, client=client, route=route, prompt_len=S, n_new=n_new,
            arrival=arrival, tokens=[int(t) for t in np.asarray(tokens)],
            hop_inputs=[[] for _ in route.servers],
            sampling=sampling if sampling is not None else SamplingSpec(),
            frames=frames, enc_len=enc_len)
        return sid

    def _prompt_pages(self, sess: EngineSession) -> int:
        """Pages booked at admission: enough for the prompt (paged)."""
        return pages_for(sess.prompt_len, self.page_size)

    def _worst_pages(self, sess: EngineSession) -> int:
        """Fully grown page count — the solo-completability bound admission
        asserts so preempted sessions can always eventually resume."""
        return pages_for(sess.prompt_len + sess.n_new, self.page_size)

    def fits_session(self, sid: int) -> bool:
        """True iff every route server has a free row AND block-slots
        (slab) / prompt pages plus solo-completability headroom (paged)."""
        sess = self.sessions[sid]
        p, w = 0, None
        if self.cache_layout == "paged":
            p, w = self._prompt_pages(sess), self._worst_pages(sess)
        return all(self.servers[j].alive
                   and self.servers[j].fits(sid, k, p, w)
                   for j, k in zip(sess.route.servers, sess.route.blocks))

    def try_admit_session(self, sid: int, now: float = 0.0) -> bool:
        """Claim slots and run the prefill to completion."""
        ok = self.try_admit_sessions([sid], now=now)
        if ok:
            self.drain_prefill()
        return bool(ok)

    def try_admit_sessions(self, sids: List[int], now: float = 0.0
                           ) -> List[int]:
        """Claim slots for every session that fits (FIFO per client) and
        coalesce the admitted ones into bucket groups for batched prefill.
        Returns the admitted sids."""
        with self.tracer.span("admit"):
            admitted: List[EngineSession] = []
            failed_clients: set = set()
            for sid in sids:
                sess = self.sessions[sid]
                faulted = [j for j in sess.route.servers
                           if j in self._dispatch_faults]
                if faulted:
                    self._dispatch_faults.difference_update(faulted)
                    self.round_stats["dispatch_errors"] += 1
                    failed_clients.add(sess.client)
                    continue
                if sess.client in failed_clients or \
                        not self.fits_session(sid):
                    failed_clients.add(sess.client)
                    continue
                n_pages = (self._prompt_pages(sess)
                           if self.cache_layout == "paged" else 0)
                for j, k in zip(sess.route.servers, sess.route.blocks):
                    self.servers[j].admit(sid, k, n_pages=n_pages)
                sess.start = now
                admitted.append(sess)
            if not admitted:
                return []
            if self.prefill_mode == "serial":
                for sess in admitted:
                    self._prefill_serial(sess)
                    self._finalize_prefill(sess, sess._h[:, -1:])
                return [s.sid for s in admitted]
            # groups by (route, bucket, encoder length): the encoder pass
            # runs at the exact encoder length
            groups: Dict[Tuple[Route, Optional[int], int],
                         List[EngineSession]] = {}
            for sess in admitted:
                sess.state = "prefilling"
                b = bucket_for(self.prefill_buckets, sess.prompt_len,
                               self.specs)
                groups.setdefault((sess.route, b, sess.enc_len),
                                  []).append(sess)
            for (route, b, enc_len), members in groups.items():
                self._prefill_groups.append(_PrefillGroup(
                    route=route, bucket=b, members=members, enc_len=enc_len,
                    hop_chunks={s.sid: [[] for _ in route.servers]
                                for s in members},
                    enc_inputs={s.sid: [None] * len(route.servers)
                                for s in members}))
            return [s.sid for s in admitted]

    # -- batched prefill ------------------------------------------------
    def has_pending_prefill(self) -> bool:
        return bool(self._prefill_groups)

    def prefill_round(self) -> List[int]:
        """Advance every pending bucket group by ONE chunk round (all hops).
        Returns the sids whose prompt completed (they emit a token).

        Spans (``self.tracer``): ``prefill_round`` > per group ``group``
        > ``embed``; per hop ``hop`` (the counts ``work_run`` /
        ``work_live``) > ``stage``, a ``step`` per call (a member each, on
        servers with ``row_calls``); per finished session ``finalize`` >
        ``readback``."""
        tr = self.tracer
        done: List[int] = []
        still: List[_PrefillGroup] = []
        with tr.span("prefill_round"):
            for g in self._prefill_groups:
                with tr.span("group"):
                    done.extend(self._prefill_group_round(g))
                if any(s.state == "prefilling" and s.prompt_len > g.offset
                       for s in g.members):
                    still.append(g)
        self._prefill_groups = still
        return done

    def drain_prefill(self):
        while self._prefill_groups:
            self.prefill_round()

    def _prefill_plan(self, prompt_len: int) -> List[Tuple[int, int, int]]:
        """Deterministic chunk plan [(offset, span, t_pad), ...] — a
        function of the prompt length only."""
        if self._recurrent:
            return [(0, prompt_len, prompt_len)]
        b = bucket_for(self.prefill_buckets, prompt_len)
        if b is not None:
            return [(0, prompt_len, min(b, self.max_seq_len))]
        chunk_unit = max(self.prefill_buckets)
        plan: List[Tuple[int, int, int]] = []
        off = 0
        while off < prompt_len:
            t_pad = min(chunk_unit, self.max_seq_len - off)
            plan.append((off, min(prompt_len - off, t_pad), t_pad))
            off += t_pad
        return plan

    def _enc_hop(self, srv: BlockServer, h, lo: int, hi: int):
        """One session's encoder activations (1, S_enc, d) through encoder
        blocks [lo, hi) of ``srv``: a pooled call on a batch of that one
        row.  Encoder blocks hold no pool state, so the pass needs no pool
        row and no padding rows, and a session's encoder output does not
        depend on the sessions prefilled beside it."""
        return srv.prefill_rows(h, srv._layer_mask(lo, hi, 1, 0), offset=0,
                                phase="enc")

    def _prefill_enc_phase(self, g: _PrefillGroup,
                           active: List[EngineSession]):
        """The exact-length pass over the encoder blocks of a group's route
        (enc-dec stacks; once, before the first decoder chunk), one session
        at a time.  Leaves each member's encoder output on ``enc_out``."""
        for s in active:
            h = self._embed_frames(s.frames)
            e = 0
            for hop, (j, k) in enumerate(zip(g.route.servers,
                                             g.route.blocks)):
                if e >= self._n_enc:
                    break
                g.enc_inputs[s.sid][hop] = h
                h = self._enc_hop(self.servers[j], h, e,
                                  min(e + k, self._n_enc))
                e += k
            s.enc_out = h

    def _prefill_group_round(self, g: _PrefillGroup) -> List[int]:
        """One chunk round for one bucket group: embed the (padded) chunk of
        every member, run the pooled prefill per hop (``_prefill_hop``),
        account the virtual clock, finalize completed members.  Enc-dec
        groups run their encoder phase first, at offset 0; encoder-only
        hops are traversed, and billed, only then."""
        active = [s for s in g.members
                  if s.state == "prefilling" and s.prompt_len > g.offset]
        if not active:
            return []
        lost = [j for j in g.route.servers
                if j not in self.servers or not self.servers[j].alive
                or self.servers[j].crashed
                or any(s.sid not in self.servers[j].pool.rows
                       for s in active)]
        if lost:
            for j in lost:
                srv = self.servers.get(j)
                if srv is not None and srv.alive and srv.crashed:
                    self._detect_crash(j, [
                        (s, self._expected_hop_prefill(s, j))
                        for s in active])
            for s in active:
                self._abort_session(s, reason="server_lost_mid_prefill")
            return []
        ref_len = max(s.prompt_len for s in active)
        t_pad = next(tp for off, _, tp in self._prefill_plan(ref_len)
                     if off == g.offset)
        spans = {s.sid: min(s.prompt_len - g.offset, t_pad) for s in active}
        if self._is_enc_dec and g.offset == 0:
            self._prefill_enc_phase(g, active)
        tr = self.tracer
        with tr.span("embed"):
            for s in active:
                chunk = s.tokens[g.offset: g.offset + spans[s.sid]]
                chunk = chunk + [0] * (t_pad - len(chunk))
                s._h = self._embed([chunk])
                if self._needs_emb0:
                    s._emb0 = s._h
        e = 0
        phase = "dec" if self._is_enc_dec else "all"
        for hop, (j, k) in enumerate(zip(g.route.servers, g.route.blocks)):
            srv = self.servers[j]
            lo, hi = max(e, self._n_enc), e + k
            if lo < hi:  # the hop hosts decoder-phase blocks
                with tr.span("hop"):
                    for s in active:
                        # client-side failover cache: the UNPADDED chunk
                        # entering this hop (stitched to the full prompt
                        # at completion)
                        g.hop_chunks[s.sid][hop].append(
                            s._h[:, : spans[s.sid]])
                    n_rows = self._prefill_hop(srv, active, lo, hi,
                                               g.offset, phase)
                    if tr.on:
                        # (layer, row, position) work: the calls run every
                        # hosted layer of their rows over the padded chunk;
                        # a member's masked layers over its live positions
                        # are what its prompt needs
                        tr.count("work_run", srv.m * n_rows * t_pad)
                        tr.count("work_live", (hi - lo) * sum(
                            spans[s.sid] for s in active))
                        if srv.n_moe:
                            self._count_moe(srv.n_moe * n_rows * t_pad)
            # eq. (1): the group's chunk travels the hop as ONE message;
            # each session is charged its own weighted k·τ^I (unchunked
            # groups bill the nominal l_in, chunked ones the actual span).
            # Encoder-only hops are traversed once (the encoder phase, at
            # offset 0), so later chunk rounds do not bill them again
            if lo < hi or g.offset == 0:
                for s in active:
                    tau = self.problem.servers[j].tau_prefill(
                        self.problem.workload.l_in if g.bucket is not None
                        else spans[s.sid])
                    s.prefill_time += (
                        self.problem.rtt_prefill[s.client, j]
                        + self.problem.llm.tau_weight(e, e + k)
                        * tau * srv.slowdown)
            e += k
        g.offset += t_pad
        done: List[int] = []
        for s in active:
            if s.prompt_len <= g.offset:
                for hop in range(len(g.route.servers)):
                    parts = g.hop_chunks[s.sid][hop]
                    stitched = (None if not parts
                                else parts[0] if len(parts) == 1
                                else torch.cat(parts, dim=1))
                    if self._is_enc_dec:
                        stitched = {"enc": g.enc_inputs[s.sid][hop],
                                    "dec": stitched}
                    s.hop_inputs[hop].append(stitched)
                with tr.span("finalize"):
                    self._finalize_prefill(s, s._h[:, spans[s.sid] - 1:
                                                   spans[s.sid]])
                done.append(s.sid)
        return done

    def _prefill_hop(self, srv: BlockServer, active: List[EngineSession],
                     lo: int, hi: int, offset: int, phase: str) -> int:
        """One hop of a group's chunk round: blocks [lo, hi) of ``srv`` over
        the members' ``_h`` (each (1, t_pad, d)), replaced by the hop's
        output.  Returns the pool rows the calls ran, all calls together.

        Where a pool row can be stepped alone (``srv.row_calls``: a solo
        server, or a group whose rows do not shard over ``data``), each
        member runs its own call over a batch of one row, its pool row: a
        refill runs no row that holds no prompt, and a session's numbers
        are a function of its own chunk and bucket whatever group it
        shares.  A group whose rows shard over ``data`` holds each row on
        one slot, so it keeps one call over every pool row, the members
        staged into a zero ``(N, t_pad, d)`` buffer.  The layout chooses
        the path; no option does."""
        tr = self.tracer
        if srv.row_calls:
            with tr.span("stage"):
                mask = srv._layer_mask(lo, hi, 1, 0)
            for s in active:
                with tr.span("step"):
                    s._h = srv.prefill_rows(
                        s._h, mask, offset=offset, phase=phase,
                        emb0_rows=s._emb0, enc_rows=s.enc_out,
                        row=srv.pool.rows[s.sid])
            return len(active)
        N = srv.pool.n_rows
        rows = [srv.pool.rows[s.sid] for s in active]
        with tr.span("stage"):
            h_buf = active[0]._h.new_zeros((N,) + active[0]._h.shape[1:])
            emb0_buf = h_buf.new_zeros(h_buf.shape) \
                if self._needs_emb0 else None
            enc_buf = None
            if self._is_enc_dec:
                enc_buf = active[0].enc_out.new_zeros(
                    (N,) + tuple(active[0].enc_out.shape[1:]))
            for s, row in zip(active, rows):
                h_buf[row] = s._h[0]
                if emb0_buf is not None:
                    emb0_buf[row] = s._emb0[0]
                if enc_buf is not None:
                    enc_buf[row] = s.enc_out[0]
            mask = srv._layer_mask(lo, hi, N, rows)
        with tr.span("step"):
            h_out = srv.prefill_rows(h_buf, mask, offset=offset,
                                     phase=phase, emb0_rows=emb0_buf,
                                     enc_rows=enc_buf)
        for s, row in zip(active, rows):
            s._h = h_out[row][None]
        return N

    def _prefill_serial(self, sess: EngineSession):
        """One-session-per-call exact-length prefill (the reference path of
        the bucketed one): per-layer block calls, eq. (1) accounting.
        Enc-dec sessions run their encoder blocks first."""
        enc_recs: List[Optional[torch.Tensor]] = \
            [None] * len(sess.route.servers)
        if self._is_enc_dec:
            eh = self._embed_frames(sess.frames)
            enc_pos = torch.arange(sess.enc_len, device=self.device)
            e = 0
            for hop, (j, k) in enumerate(zip(sess.route.servers,
                                             sess.route.blocks)):
                if e >= self._n_enc:
                    break
                enc_recs[hop] = eh
                eh = self.servers[j].prefill_range(
                    sess.sid, eh, e, min(e + k, self._n_enc), enc_pos)
                e += k
            sess.enc_out = eh
        h = self._embed([sess.tokens[: sess.prompt_len]])
        emb0 = h if self._needs_emb0 else None
        positions = torch.arange(sess.prompt_len, device=self.device)
        e = 0
        for hop, (j, k) in enumerate(zip(sess.route.servers,
                                         sess.route.blocks)):
            srv = self.servers[j]
            lo, hi = max(e, self._n_enc), e + k
            sess.hop_inputs[hop].append(
                {"enc": enc_recs[hop], "dec": h if lo < hi else None}
                if self._is_enc_dec else h)
            if lo < hi:
                h = srv.prefill_range(sess.sid, h, lo, hi, positions,
                                      emb0=emb0, enc_h=sess.enc_out)
            sess.prefill_time += (
                self.problem.rtt_prefill[sess.client, j]
                + self.problem.llm.tau_weight(e, e + k)
                * self.problem.servers[j].tau_prefill(
                    self.problem.workload.l_in) * srv.slowdown)
            e += k
        sess._h = h

    def _finalize_prefill(self, sess: EngineSession, h_last):
        """Prefill done: close the virtual-clock accounting and emit the
        first generated token from the prompt's last-position logits."""
        sess.pos = sess.prompt_len
        sess.virtual_time += sess.prefill_time
        sess.per_token_time = self._route_per_token(sess)
        sess.state = "active"
        sess.end = (sess.start + sess.prefill_time
                    + max(sess.n_new - 1, 0) * sess.per_token_time)
        sess.last_logits = self._lm_head(h_last)[0, 0]
        sess.tokens.append(self._sample_tokens([sess])[0])
        sess.n_generated = 1
        sess._h = None
        sess._emb0 = None

    def _sample_tokens(self, sessions: List[EngineSession]) -> List[int]:
        """One sampler call for a round's sessions: per-row (temperature,
        top_k, seed, token index) inputs; session ``s`` draws the key for
        token index ``s.n_generated``."""
        logits = torch.stack([s.last_logits for s in sessions])
        temps, topks = zip(*(s.sampling.row_params() for s in sessions))
        toks = sample_rows(
            logits, np.asarray(temps, np.float32),
            np.asarray(topks, np.int64),
            np.asarray([s.sampling.seed for s in sessions], np.int64),
            np.asarray([s.n_generated for s in sessions], np.int64))
        with self.tracer.span("readback"):  # the host sync
            return [int(t) for t in toks.tolist()]

    def _route_per_token(self, sess: EngineSession) -> float:
        t = 0.0
        e = 0
        for j, k in zip(sess.route.servers, sess.route.blocks):
            t += (self.problem.rtt_token[sess.client, j]
                  + self.problem.llm.tau_weight(e, e + k)
                  * self.problem.servers[j].tau
                  * self.servers[j].slowdown)
            e += k
        return t

    # ------------------------------------------------------------------
    # Timeout-based failure detection
    # ------------------------------------------------------------------
    def _expected_hop_decode(self, sess: EngineSession, hop: int) -> float:
        j = sess.route.servers[hop]
        e_lo, e_hi = self._hop_span(sess, hop)
        return (self.problem.rtt_token[sess.client, j]
                + self.problem.llm.tau_weight(e_lo, e_hi)
                * self.problem.servers[j].tau * self.servers[j].slowdown)

    def _expected_hop_prefill(self, sess: EngineSession, j: int) -> float:
        e = 0
        for jj, k in zip(sess.route.servers, sess.route.blocks):
            if jj == j:
                return (self.problem.rtt_prefill[sess.client, j]
                        + self.problem.llm.tau_weight(e, e + k)
                        * self.problem.servers[j].tau_prefill(
                            self.problem.workload.l_in)
                        * self.servers[j].slowdown)
            e += k
        return float(self.problem.rtt_prefill[sess.client, j])

    def _detect_crash(self, j: int, affected):
        """Declare crashed server ``j`` dead by timeout, billing every
        affected session the missed deadline plus the backoff probes."""
        srv = self.servers[j]
        backoff = self.detector.backoff_time()
        for sess, expected in affected:
            detect = self.detector.detect_time(expected)
            sess.detect_time += detect
            sess.backoff_time += backoff
            sess.virtual_time += detect + backoff
            sess.n_detections += 1
            sess.n_retries += self.detector.max_probes
            self.round_stats["detections"] += 1
            self.round_stats["retries"] += self.detector.max_probes
            self.round_stats["detect_s"] += detect
            self.round_stats["backoff_s"] += backoff
        srv.alive = False
        srv.suspected = True

    def _hop_needs_failover(self, sess: EngineSession, hop: int) -> bool:
        j = sess.route.servers[hop]
        srv = self.servers.get(j)
        return (srv is None or not srv.alive
                or sess.sid not in srv.pool.rows)

    def decode_round(self, sids: Optional[List[int]] = None) -> Dict[int, int]:
        """One continuous-batching round: every listed active session (all
        unfinished active sessions when ``sids`` is None) advances one token
        through its route.  Returns {sid: new_token}.

        Preempted sessions are resumed (FIFO) when they fit again.  The
        paged layout first grows every member's pages to cover its write
        position, preempting victims under page pressure.

        Spans (``self.tracer``): ``decode_round`` > ``prep`` (faults,
        resume, the group, the fused round's host buffers and embed); per
        (hop, server) ``hop`` (the counts ``work_run`` / ``work_live``) >
        ``stage``, ``step``; ``tail``, ``readback`` (the round's one host
        sync), ``emit``."""
        tr = self.tracer
        with tr.span("decode_round"):
            with tr.span("prep"):
                group = self._decode_group(sids)
                fused = self._round_inputs(group) \
                    if group and self.decode_mode == "fused" else None
            if not group:
                return {}
            if fused is None:
                return self._decode_round_serial(group)
            return self._decode_round_fused(group, *fused)

    def _decode_group(self, sids: Optional[List[int]]
                      ) -> List[EngineSession]:
        """The sessions a decode round advances (see ``decode_round``),
        after the round's faults, resumes and page growth."""
        explicit = sids is not None
        if self.fault_plan is not None:
            clock = [s.virtual_time + s.start
                     for s in self.sessions.values()
                     if s.state in ("active", "preempted")]
            if clock:
                self.apply_faults(min(clock))
        self._resume_preempted()
        if sids is None:
            sids = [s.sid for s in self.sessions.values()
                    if s.state == "active" and s.n_generated < s.n_new]
        group = [self.sessions[sid] for sid in sids
                 if self.sessions[sid].state == "active"]
        if self.cache_layout == "paged":
            group = self._ensure_page_capacity(group)
        if not group and not explicit and any(
                s.state == "preempted" and s.n_generated < s.n_new
                for s in self.sessions.values()):
            # nothing resident could decode but swapped-out sessions owe
            # tokens: force-resume the queue head (evicting finished but
            # unretired holders); admission's solo-fit bound guarantees
            # the oldest preempted session eventually fits
            self._resume_preempted(force=True)
            group = [s for s in self.sessions.values()
                     if s.state == "active" and s.n_generated < s.n_new]
            if self.cache_layout == "paged":
                group = self._ensure_page_capacity(group)
            if not group:
                self._abort_stuck_head()
        return group

    # ------------------------------------------------------------------
    # Preemption (page pressure, capacity-starved failover deferral),
    # page growth and resume
    # ------------------------------------------------------------------
    def _pick_victim(self, j: int, protect: set,
                     finished_only: bool = False) -> Optional[int]:
        """A session to preempt on server ``j``: finished-but-unretired
        sessions first, then the latest-admitted active one (the earliest
        always survives, so every round makes progress).  Mid-prefill
        sessions are never victims."""
        cands = []
        for sid in self.servers[j].pool.rows:
            if sid in protect:
                continue
            s = self.sessions.get(sid)
            if s is None or s.state != "active":
                continue
            finished = s.n_generated >= s.n_new
            if finished_only and not finished:
                continue
            cands.append((0 if finished else 1, -sid, sid))
        return min(cands)[2] if cands else None

    def preempt_session(self, sid: int):
        """Swap a session out: free its rows / pages on every route server;
        its client-side hop histories are the replay cache for the resume
        (billed on the virtual clock by ``_try_resume``)."""
        sess = self.sessions[sid]
        assert sess.state == "active", sess.state
        sess.last_logits  # materialize a lazy fused-round logits box
        sess.state = "preempted"
        sess.n_preemptions += 1
        sess._h = None
        sess._emb0 = None
        for j in set(sess.route.servers):
            if j in self.servers:
                self.servers[j].evict(sid)
        self._preempt_order.append(sid)
        self.round_stats["preemptions"] += 1

    def _grow_session(self, sess: EngineSession, need: int,
                      protect: set) -> bool:
        """Grow ``sess`` to ``need`` pages on every route server,
        preempting victims under pressure.  False when even preempting
        every candidate cannot make room (partial growth is harmless: the
        pages stay booked)."""
        for j in sess.route.servers:
            srv = self.servers.get(j)
            if srv is None or not srv.alive or sess.sid not in srv.pool.rows:
                continue  # dead / not-yet-resident hop: _failover re-books
            pool = srv.pool
            while not pool.can_grow(sess.sid, need):
                victim = self._pick_victim(j, protect)
                if victim is None:
                    return False
                self.preempt_session(victim)
            pool.grow_pages(sess.sid, need)
        return True

    def _ensure_page_capacity(self, group: List[EngineSession]
                              ) -> List[EngineSession]:
        """Before a decode round: every member needs pages covering its
        write position.  Members grow oldest first; one that cannot fit
        even after evicting every victim preempts ITSELF.  Returns the
        surviving group in the caller's order."""
        kept: List[EngineSession] = []
        for sess in sorted(group, key=lambda s: s.sid):
            if sess.state != "active":  # preempted as a victim just now
                continue
            need = pages_for(sess.pos + 1, self.page_size)
            if self._grow_session(sess, need,
                                  protect={s.sid for s in kept}
                                  | {sess.sid}):
                kept.append(sess)
            else:
                self.preempt_session(sess.sid)
        order = {s.sid: i for i, s in enumerate(group)}
        return sorted(kept, key=lambda s: order[s.sid])

    def _resume_preempted(self, force: bool = False):
        while self._preempt_order:
            sid = self._preempt_order[0]
            sess = self.sessions.get(sid)
            if (sess is None or sess.state != "preempted"
                    or sess.n_generated >= sess.n_new):
                self._preempt_order.pop(0)
                continue
            if not self._try_resume(sess, evict_finished=force):
                return
            self._preempt_order.pop(0)
            force = False

    def _try_resume(self, sess: EngineSession,
                    evict_finished: bool = False) -> bool:
        """Re-admit a preempted session on its route's ALIVE servers and
        replay its client-side history (billed on the virtual clock).  The
        paged layout books pages covering the replayed positions."""
        paged = self.cache_layout == "paged"
        need = pages_for(max(sess.pos, 1), self.page_size) if paged else 0
        worst = self._worst_pages(sess) if paged else None
        e = 0
        hops = []
        for hop, (j, k) in enumerate(zip(sess.route.servers,
                                         sess.route.blocks)):
            lo, hi = e, e + k
            e += k
            if j in self.servers and self.servers[j].alive:
                hops.append((hop, j, lo, hi))
        if not hops:
            sess.state = "active"
            self.round_stats["resumes"] += 1
            return True
        for _, j, lo, hi in hops:
            while not self.servers[j].fits(sess.sid, hi - lo, need, worst):
                if not evict_finished:
                    return False
                victim = self._pick_victim(j, protect={sess.sid},
                                           finished_only=True)
                if victim is None:
                    return False
                self.preempt_session(victim)
        for _, j, lo, hi in hops:
            self.servers[j].admit(sess.sid, hi - lo, n_pages=need)
        self._replay_session(sess)
        cost = 0.0
        for hop, j, lo, hi in hops:
            n_tok = max(len(sess.hop_inputs[hop]) - 1, 0) \
                if self._decodes(lo, hi) else 0
            cost += recovery_replay_cost(
                self.problem, sess.client, [(j, lo, hi)], n_tok,
                slowdown_of=lambda jj: self.servers[jj].slowdown)
        sess.replay_time += cost
        sess.virtual_time += cost
        sess.n_replays += 1
        sess.end = (sess.start + sess.virtual_time
                    + max(sess.n_new - sess.n_generated, 0)
                    * sess.per_token_time)
        self.round_stats["replays"] += 1
        self.round_stats["replay_s"] += cost
        sess.state = "active"
        self.round_stats["resumes"] += 1
        return True

    def _replay_session(self, sess: EngineSession):
        """Rebuild a preempted session's caches on its alive route servers
        from the client-side hop histories (hops replay independently)."""
        S = sess.prompt_len
        e = 0
        for hop, (j, k) in enumerate(zip(sess.route.servers,
                                         sess.route.blocks)):
            e_lo, e_hi = e, e + k
            e += k
            if j not in self.servers or not self.servers[j].alive:
                continue
            rec = sess.hop_inputs[hop][0]
            if self._is_enc_dec:
                self._replay_prefill_encdec(sess, j, e_lo, e_hi,
                                            rec["enc"], rec["dec"])
            else:
                self._replay_prefill_range(sess, j, e_lo, e_hi, rec)
            if not self._decodes(e_lo, e_hi):
                continue  # encoder-only hop: no decode records
            for t_idx, h_tok in enumerate(sess.hop_inputs[hop][1:]):
                self.servers[j].decode_range(
                    sess.sid, self._hop_record(h_tok), e_lo, e_hi,
                    S + t_idx, emb0=self._token_emb0(sess, S + t_idx),
                    enc_len=sess.enc_len)

    # ------------------------------------------------------------------
    # Decode rounds
    # ------------------------------------------------------------------
    def _decode_round_serial(self, group: List[EngineSession]
                             ) -> Dict[int, int]:
        """Per-session embed / lm_head dispatches and host-staged row
        buffers between hops (``_traverse``) — the reference path of the
        fused round (identical tokens and clock)."""
        for sess in group:
            sess._h = self._embed([[sess.tokens[-1]]])
            sess._emb0 = sess._h
        self._traverse(group)
        emit = [s for s in group if s.state == "active"]
        for sess in emit:
            sess.pos += 1
            sess.last_logits = self._lm_head(sess._h)[0, 0]
        out: Dict[int, int] = {}
        if emit:
            for sess, nxt in zip(emit, self._sample_tokens(emit)):
                sess.tokens.append(nxt)
                sess.n_generated += 1
                sess.virtual_time += sess.per_token_time
                sess._h = None
                sess._emb0 = None
                out[sess.sid] = nxt
        return out

    def _round_inputs(self, group: List[EngineSession]) -> tuple:
        """The fused round's inputs over fixed-width (W, ...) buffers:
        (slot of each sid, embedded tokens (W, 1, d), positions, original
        embeddings, encoder lengths), staged without a host sync."""
        if len(group) > self._round_width:
            self._round_width = len(group)
        W = self._round_width
        slot = {s.sid: i for i, s in enumerate(group)}
        tok_buf = np.zeros((W, 1), np.int64)
        pos_buf = np.zeros((W,), np.int64)
        encl_buf = np.zeros((W,), np.int64)
        for i, s in enumerate(group):
            tok_buf[i, 0] = s.tokens[-1]
            pos_buf[i] = s.pos
            encl_buf[i] = s.enc_len
        h_round = self._embed(tok_buf)
        self.round_stats["embed_dispatches"] += 1
        emb0_round = h_round if self._needs_emb0 else None
        encl_round = to_device(encl_buf, self.device) \
            if self._is_enc_dec else None
        return (slot, h_round, to_device(pos_buf, self.device), emb0_round,
                encl_round)

    def _decode_round_fused(self, group: List[EngineSession],
                            slot: Dict[int, int], h_round, pos_round,
                            emb0_round, encl_round) -> Dict[int, int]:
        """Device-resident round over fixed-width (W, ...) buffers
        (``_round_inputs``): the ONLY host sync is the final batched token
        readback."""
        tr = self.tracer
        W = self._round_width
        h_round = self._traverse_fused(group, slot, h_round, pos_round,
                                       emb0_round, encl_round)
        emit = [s for s in group if s.state == "active"]
        out: Dict[int, int] = {}
        if emit:
            with tr.span("tail"):
                temps = np.zeros((W,), np.float32)
                topks = np.zeros((W,), np.int64)
                seeds = np.zeros((W,), np.int64)  # the full [0, 2**32) range
                tindex = np.zeros((W,), np.int64)
                for s in emit:
                    g = slot[s.sid]
                    temps[g], topks[g] = s.sampling.row_params()
                    seeds[g] = s.sampling.seed
                    tindex[g] = s.n_generated
                toks_dev, logits_rows = self._round_tail(
                    self.params["embed"], h_round, temps, topks, seeds,
                    tindex)
                self.round_stats["tail_dispatches"] += 1
            with tr.span("readback"):
                toks = toks_dev.cpu().numpy()  # THE one host sync of the round
            with tr.span("emit"):
                for s in emit:
                    g = slot[s.sid]
                    s.pos += 1
                    s._logits_box = (logits_rows, g)  # lazy: sliced on read
                    nxt = int(toks[g])
                    s.tokens.append(nxt)
                    s.n_generated += 1
                    s.virtual_time += s.per_token_time
                    out[s.sid] = nxt
        self.round_stats["rounds"] += 1
        return out

    def _count_moe(self, n: int) -> None:
        """Count on the open ``hop`` span the tokens its calls put through
        MoE layers (hosted MoE layers x rows x positions, padding
        included) and their routed (token, expert) pairs, from sizes."""
        self.tracer.count("moe_tokens", n)
        self.tracer.count("moe_pairs", n * self.cfg.moe_top_k)

    def _hop_span(self, sess: EngineSession, hop: int) -> Tuple[int, int]:
        e_lo = sum(sess.route.blocks[:hop])
        return e_lo, e_lo + sess.route.blocks[hop]

    def _decodes(self, lo: int, hi: int) -> bool:
        """True iff blocks [lo, hi) do decode work: any block but an
        encoder block."""
        return max(lo, self._n_enc) < hi

    def _traverse_core(self, group: List[EngineSession], process_group):
        """THE decode traversal skeleton shared by the host-staged and
        device-resident paths: advance every session through its route,
        batching per (hop, server), with timeout detection and failover
        before each hop.  Hops hosting only encoder blocks are skipped:
        they do no decode work (and need no failover)."""
        progress = {s.sid: 0 for s in group}

        def skip_enc_hops(s):
            while (s.state == "active"
                   and progress[s.sid] < len(s.route.servers)):
                if self._decodes(*self._hop_span(s, progress[s.sid])):
                    return
                progress[s.sid] += 1

        while True:
            for s in group:
                skip_enc_hops(s)
            pending = [s for s in group
                       if s.state == "active"
                       and progress[s.sid] < len(s.route.servers)]
            if not pending:
                return
            crashed_now = sorted({
                s.route.servers[progress[s.sid]] for s in pending
                if (srv := self.servers.get(
                    s.route.servers[progress[s.sid]])) is not None
                and srv.alive and srv.crashed})
            for j in crashed_now:
                self._detect_crash(j, [
                    (s, self._expected_hop_decode(s, progress[s.sid]))
                    for s in pending
                    if s.route.servers[progress[s.sid]] == j])
            for s in pending:
                hop = progress[s.sid]
                while self._hop_needs_failover(s, hop):
                    try:
                        self._failover(s, hop)
                    except NoCapacityError:
                        if len(group) == 1:
                            raise
                        self._defer_session(s)
                        break
                    except RuntimeError:
                        if len(group) == 1:
                            raise
                        self._abort_session(s, reason="no_route")
                        break
            pending = [s for s in pending if s.state == "active"]
            groups: Dict[int, List[EngineSession]] = {}
            for s in pending:
                groups.setdefault(s.route.servers[progress[s.sid]],
                                  []).append(s)
            for j, members in groups.items():
                process_group(self.servers[j], members, progress)
                for s in members:
                    progress[s.sid] += 1

    def _traverse(self, group: List[EngineSession]):
        """Host-staged traversal (``decode_mode="serial"`` and the legacy
        per-session ``decode``): per-session hidden states are copied into
        (N, ...) row buffers before every hop."""

        def process_group(srv, members, progress):
            N = srv.pool.n_rows
            h_buf = members[0]._h.new_zeros((N,) + tuple(
                members[0]._h.shape[1:]))
            emb0_buf = h_buf.new_zeros(h_buf.shape) if self._needs_emb0 \
                else None
            pos_buf = np.zeros((N,), np.int64)
            encl_buf = np.zeros((N,), np.int64)
            mask = np.zeros((srv.m, N), bool)
            rows = {}
            for s in members:
                hop = progress[s.sid]
                row = srv.pool.rows[s.sid]
                e_lo, e_hi = self._hop_span(s, hop)
                s.hop_inputs[hop].append(s._h)
                h_buf[row] = s._h[0]
                if emb0_buf is not None:
                    emb0_buf[row] = s._emb0[0]
                pos_buf[row] = s.pos
                encl_buf[row] = s.enc_len
                mask[max(e_lo, self._n_enc) - srv.a: e_hi - srv.a,
                     row] = True
                rows[s.sid] = row
            h_out = srv.decode_rows(
                h_buf, srv._mask(pos_buf), srv._mask(mask), emb0_buf,
                srv._mask(encl_buf) if self._is_enc_dec else None)
            for s in members:
                s._h = h_out[rows[s.sid]][None]

        self._traverse_core(group, process_group)

    def _traverse_fused(self, group: List[EngineSession],
                        slot: Dict[int, int], h_round, pos_round,
                        emb0_round=None, encl_round=None):
        """Device-resident traversal: ``h_round`` (W, 1, d) flows hop to hop
        through the fused gather+step+scatter (``BlockServer.round_rows``);
        only small index/mask vectors cross to the device, never
        activations back."""

        tr = self.tracer

        def process_group(srv, members, progress):
            nonlocal h_round
            with tr.span("hop"):
                with tr.span("stage"):
                    N = srv.pool.n_rows
                    W = h_round.shape[0]
                    slot_of_row = np.full((N,), -1, np.int64)
                    row_of_slot = np.full((W,), -1, np.int64)
                    mask = np.zeros((srv.m, N), bool)
                    gidx = []
                    for s in members:
                        hop = progress[s.sid]
                        row = srv.pool.rows[s.sid]
                        e_lo, e_hi = self._hop_span(s, hop)
                        slot_of_row[row] = slot[s.sid]
                        row_of_slot[slot[s.sid]] = row
                        mask[max(e_lo, self._n_enc) - srv.a: e_hi - srv.a,
                             row] = True
                        gidx.append(slot[s.sid])
                    # client-side failover cache: ONE device gather of the
                    # hop's member rows; each member keeps a lazy (buffer,
                    # index) record
                    h_in = h_round[srv._mask(np.asarray(gidx, np.int64))]
                    for i, s in enumerate(members):
                        s.hop_inputs[progress[s.sid]].append((h_in, i))
                    slot_dev, row_dev, mask_dev = (
                        srv._mask(slot_of_row), srv._mask(row_of_slot),
                        srv._mask(mask))
                if tr.on:
                    # (layer, row) work: the step runs every hosted layer
                    # of every pool row; the members' masked layers are
                    # live
                    tr.count("work_run", mask.size)
                    tr.count("work_live", int(mask.sum()))
                    if srv.n_moe:
                        self._count_moe(srv.n_moe * N)
                with tr.span("step"):
                    h_round = srv.round_rows(
                        h_round, pos_round, slot_dev, row_dev, mask_dev,
                        emb0_round, encl_round)
                self.round_stats["hop_dispatches"] += 1

        self._traverse_core(group, process_group)
        return h_round

    def _abort_session(self, sess: EngineSession, reason: str = "no_route"):
        """Mark a session unservable and free its slots."""
        sess.state = "failed"
        if sess.fail_reason is None:
            sess.fail_reason = reason
        sess._h = None
        sess._emb0 = None
        for j in set(sess.route.servers):
            if j in self.servers:
                self.servers[j].evict(sess.sid)

    def _defer_session(self, sess: EngineSession):
        """Capacity-starved failover: park the session in the resume queue
        (its in-flight round's partial hop records stripped first), failing
        it after a bounded number of bounces."""
        if sess.n_defer_resumes >= 8:
            self._abort_session(sess, reason="no_capacity")
            return
        sess.n_defer_resumes += 1
        dec_hops = [hop for hop in range(len(sess.route.blocks))
                    if self._decodes(*self._hop_span(sess, hop))]
        if dec_hops:
            n = min(len(sess.hop_inputs[hop]) for hop in dec_hops)
            for hop in dec_hops:
                del sess.hop_inputs[hop][n:]
        self.preempt_session(sess.sid)

    def _abort_stuck_head(self):
        while self._preempt_order:
            sid = self._preempt_order[0]
            sess = self.sessions.get(sid)
            if (sess is None or sess.state != "preempted"
                    or sess.n_generated >= sess.n_new):
                self._preempt_order.pop(0)
                continue
            self._preempt_order.pop(0)
            self._abort_session(sess, reason="no_capacity")
            return

    def retire_session(self, sid: int) -> Optional[EngineSession]:
        """Free the session's rows/block-slots on every server; returns the
        session record (metrics live on it)."""
        sess = self.sessions.pop(sid, None)
        if sess is None:
            return None
        if sess.state == "prefilling":
            for g in self._prefill_groups:
                g.members = [s for s in g.members if s.sid != sid]
            self._prefill_groups = [g for g in self._prefill_groups
                                    if g.members]
        if sess.state != "failed":
            sess.state = "done"
        for j in set(sess.route.servers):
            if j in self.servers:
                self.servers[j].evict(sid)
        return sess

    def concurrency(self) -> int:
        return sum(1 for s in self.sessions.values()
                   if s.state in ("active", "prefilling"))

    def slot_usage(self) -> Dict[int, Tuple[int, int]]:
        """{server: (used, capacity)} in the layout's eq. (5) unit:
        block-slots (slab) or page-units (paged)."""
        return {j: srv.pool.usage() for j, srv in self.servers.items()}

    # ------------------------------------------------------------------
    # Legacy single-session API (implemented on the pooled machinery)
    # ------------------------------------------------------------------
    def submit(self, tokens: np.ndarray, client: int = 0, now: float = 0.0,
               frames: Optional[np.ndarray] = None,
               sampling: Optional[SamplingSpec] = None
               ) -> Tuple[int, torch.Tensor]:
        """Start a session immediately (prefill).  Returns (sid, logits)."""
        alive = self.alive_placement()
        if self.algorithm == "proposed":
            route, _ = shortest_path_route(self.problem, alive, client)
        else:
            route = petals_route(self.problem, alive, client)
        if route is None:
            raise RuntimeError("no feasible route")
        sid = self.create_session(tokens, client, route,
                                  n_new=self.max_new_tokens, arrival=now,
                                  frames=frames, sampling=sampling)
        if not self.try_admit_session(sid, now=now):
            self.sessions.pop(sid)
            raise RuntimeError("no free cache slots for immediate admission")
        return sid, self.sessions[sid].last_logits[None]

    def decode(self, sid: int, token: int) -> torch.Tensor:
        """One decode step through the session's chain for a caller-chosen
        token (replaces a provisional sampled tail)."""
        sess = self.sessions[sid]
        if len(sess.tokens) == sess.pos + 1:
            sess.tokens[-1] = int(token)
        else:
            sess.tokens.append(int(token))
        sess.n_generated = len(sess.tokens) - sess.prompt_len
        if self.cache_layout == "paged":
            # legacy single-session semantics: growth failure propagates
            if not self._grow_session(sess,
                                      pages_for(sess.pos + 1,
                                                self.page_size),
                                      protect={sess.sid}):
                raise RuntimeError(
                    f"session {sid}: no page capacity for decode")
        sess._h = self._embed([[int(token)]])
        sess._emb0 = sess._h
        self._traverse([sess])
        sess.pos += 1
        sess.virtual_time += self._route_per_token(sess)
        logits = self._lm_head(sess._h)
        sess.last_logits = logits[0, 0]
        sess._h = None
        sess._emb0 = None
        return logits[:, 0]

    def finish(self, sid: int):
        self.retire_session(sid)

    # ------------------------------------------------------------------
    # Fault tolerance
    # ------------------------------------------------------------------
    def kill_server(self, j: int):
        """ORACLE fail-stop: flip the server dead with instant, free
        detection.  Unknown or already-dead ids raise."""
        srv = self.servers.get(j)
        if srv is None or not srv.alive:
            alive = sorted(jj for jj, s in self.servers.items() if s.alive)
            raise ValueError(
                f"kill_server({j}): "
                + ("server is already dead" if srv is not None
                   else "no such server")
                + f"; alive servers: {alive}")
        srv.alive = False
        srv.crashed = False
        srv.suspected = True

    def inject_crash(self, j: int):
        """Timeout-detected crash: the server goes silent; the next dispatch
        that misses its deadline detects the loss and bills it."""
        srv = self.servers.get(j)
        if srv is None or not srv.alive:
            alive = sorted(jj for jj, s in self.servers.items() if s.alive)
            raise ValueError(
                f"inject_crash({j}): unknown or already-dead server; "
                f"alive servers: {alive}")
        srv.crashed = True

    def rejoin_server(self, j: int):
        """A crashed server returns with an EMPTY pool."""
        srv = self.servers.get(j)
        if srv is None:
            raise ValueError(f"rejoin_server({j}): no such server; known "
                             f"servers: {sorted(self.servers)}")
        for sid in list(srv.pool.rows):
            srv.evict(sid)
        srv.alive = True
        srv.crashed = False
        self.round_stats["rejoins"] += 1

    def suspected_servers(self) -> List[int]:
        return sorted(j for j, srv in self.servers.items() if srv.suspected)

    def apply_faults(self, now: float) -> List:
        """Apply every FaultPlan event due by virtual time ``now``."""
        if self.fault_plan is None:
            return []
        due, self._fault_cursor = self.fault_plan.due(self._fault_cursor,
                                                      now)
        for ev in due:
            srv = self.servers.get(ev.server)
            if ev.kind == "crash":
                if srv is not None and srv.alive and not srv.crashed:
                    srv.crashed = True
            elif ev.kind == "rejoin":
                if srv is not None:
                    self.rejoin_server(ev.server)
            elif ev.kind == "straggler_start":
                self.set_slowdown(ev.server, ev.factor)
            elif ev.kind == "straggler_end":
                self.set_slowdown(ev.server, 1.0)
            elif ev.kind == "dispatch_error":
                self._dispatch_faults.add(ev.server)
        return due

    def join_server(self, spec, rtt_token_col, rtt_prefill_col):
        """Elastic scale-out: add a server and re-run placement (Alg. 2)."""
        servers = list(self.problem.servers) + [
            dataclasses.replace(spec, sid=self.problem.n_servers)]
        rtt_t = np.concatenate(
            [self.problem.rtt_token, np.asarray(rtt_token_col).reshape(-1, 1)],
            axis=1)
        rtt_p = np.concatenate(
            [self.problem.rtt_prefill,
             np.asarray(rtt_prefill_col).reshape(-1, 1)], axis=1)
        self.problem = Problem(self.problem.llm, servers,
                               self.problem.n_clients, rtt_t, rtt_p,
                               self.problem.workload)
        self._base_taus.append(float(spec.tau))
        if self.algorithm == "proposed":
            from repro_torch.core.placement import cg_bp
            self.placement, _ = cg_bp(self.problem, self.R)
        else:
            self.placement = petals_bp(self.problem)
        self._build_servers()

    def _subchain(self, lo: int, hi: int, client: int
                  ) -> Optional[Tuple[int, ...]]:
        """Min-cost chain of ALIVE servers covering exactly blocks [lo, hi)."""
        alive = self.alive_placement()
        a = np.clip(alive.a, lo, hi)
        end = np.clip(alive.a + alive.m, lo, hi)
        m = np.maximum(end - a, 0)
        m[alive.m <= 0] = 0
        sub = Placement(a=a - lo, m=m)
        subproblem = dataclasses.replace(self.problem)
        kw = dict(n_blocks=hi - lo)
        if self.problem.llm.block_tau is not None:
            kw["block_tau"] = self.problem.llm.block_tau[lo:hi]
        subproblem.llm = dataclasses.replace(self.problem.llm, **kw)
        route, _ = shortest_path_route(subproblem, sub, client)
        return route.servers if route is not None else None

    def _replay_prefill_range(self, sess: EngineSession, j: int, lo: int,
                              hi: int, h_full):
        """Failover replay of one hop's prompt prefill.  Batched mode
        follows the session's deterministic chunk plan through the SAME
        pooled programs that built the original caches (padded positions
        are causally masked out of every valid one), so the rebuilt caches
        are bit-identical; serial mode replays exact-length."""
        srv = self.servers[j]
        emb0_full = None
        if self._needs_emb0:
            emb0_full = self._embed([sess.tokens[: sess.prompt_len]])
        if self.prefill_mode == "serial":
            return srv.prefill_range(
                sess.sid, h_full, lo, hi,
                torch.arange(h_full.shape[1], device=self.device),
                emb0=emb0_full)
        return self._replay_chunked(sess, srv, lo, hi, h_full, "all",
                                    emb0_full=emb0_full)

    def _replay_chunked(self, sess: EngineSession, srv: BlockServer,
                        lo: int, hi: int, h_full, phase: str,
                        enc_out=None, emb0_full=None):
        """Replay blocks [lo, hi) of one session's prompt through the
        pooled prefill programs, following its chunk plan — the one loop
        the single-phase and enc-dec replays share.  Each call has the
        shape of the group round's (``_prefill_hop``): the session's pool
        row alone where the server steps one row, else every pool row."""
        row = srv.pool.rows[sess.sid]
        one = srv.row_calls
        N, r = (1, 0) if one else (srv.pool.n_rows, row)
        d = h_full.shape[-1]
        mask = srv._layer_mask(lo, hi, N, r)
        enc_rows = enc_out
        if enc_out is not None and not one:
            enc_rows = enc_out.new_zeros((N,) + tuple(enc_out.shape[1:]))
            enc_rows[r] = enc_out[0]
        outs = []
        for off, span, t_pad in self._prefill_plan(h_full.shape[1]):
            h_buf = h_full.new_zeros((N, t_pad, d))
            h_buf[r, :span] = h_full[0, off: off + span]
            emb0_rows = None
            if emb0_full is not None:  # recurrent plan: one exact chunk
                emb0_rows = h_buf.new_zeros(h_buf.shape)
                emb0_rows[r] = emb0_full[0, off: off + t_pad]
            h_out = srv.prefill_rows(h_buf, mask, offset=off, phase=phase,
                                     emb0_rows=emb0_rows, enc_rows=enc_rows,
                                     row=row if one else None)
            outs.append(h_out[r][None, :span])
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

    def _replay_prefill_encdec(self, sess: EngineSession, j: int, lo: int,
                               hi: int, hs_enc, hs_dec):
        """Failover replay of one hop of an enc-dec route: the encoder
        sub-range replays the frame activations at their exact length (the
        blocks hold no state; this threads the activations on so later hop
        histories stay exact), the decoder sub-range replays the prompt by
        its chunk plan, rebuilding self K/V and cross K/V from the
        session's ``enc_out``.  Returns the two sub-ranges' outputs."""
        srv = self.servers[j]
        n_enc = self._n_enc
        if lo < n_enc and hs_enc is not None:
            elo, ehi = lo, min(hi, n_enc)
            if self.prefill_mode == "serial":
                hs_enc = srv.prefill_range(
                    sess.sid, hs_enc, elo, ehi,
                    torch.arange(hs_enc.shape[1], device=self.device))
            else:
                hs_enc = self._enc_hop(srv, hs_enc, elo, ehi)
        if hi > n_enc and hs_dec is not None:
            dlo = max(lo, n_enc)
            if self.prefill_mode == "serial":
                hs_dec = srv.prefill_range(
                    sess.sid, hs_dec, dlo, hi,
                    torch.arange(hs_dec.shape[1], device=self.device),
                    enc_h=sess.enc_out)
            else:
                hs_dec = self._replay_chunked(sess, srv, dlo, hi, hs_dec,
                                              "dec", enc_out=sess.enc_out)
        return hs_enc, hs_dec

    def _token_emb0(self, sess: EngineSession, pos: int):
        """The original embedding of the token decoded at ``pos`` (hybrid
        stacks; None otherwise) — what a replayed decode step needs."""
        if not self._needs_emb0:
            return None
        return self._embed([[sess.tokens[pos]]])

    @staticmethod
    def _hop_record(rec):
        """Materialize one decode-token hop record (lazy on the fused
        path)."""
        if isinstance(rec, tuple):
            buf, g = rec
            return buf[g][None]
        return rec

    def _failover(self, sess: EngineSession, hop: int):
        """Replace the lost server at ``hop`` by a chain of alive servers
        and replay the client-side cached inputs to rebuild their caches
        (billed on the virtual clock)."""
        dead_j = sess.route.servers[hop]
        e_lo = sum(sess.route.blocks[:hop])
        e_hi = e_lo + sess.route.blocks[hop]
        chain = self._subchain(e_lo, e_hi, sess.client)
        if chain is None:
            raise RuntimeError(
                f"no surviving servers cover blocks [{e_lo},{e_hi})")
        inputs = sess.hop_inputs[hop]
        rec = inputs[0]
        new_servers = list(sess.route.servers)
        new_blocks = list(sess.route.blocks)
        repl_routes = []
        e = e_lo
        alive = self.alive_placement()
        for j in chain:
            k = int(min(alive.a[j] + alive.m[j], e_hi) - e)
            repl_routes.append((j, e, e + k))
            e += k
        # paged layout: the replacement hops book pages covering everything
        # the replay and the in-flight round write ([0, pos])
        n_pages, worst = 0, None
        if self.cache_layout == "paged":
            n_pages = pages_for(min(sess.pos + 1, self.max_seq_len),
                                self.page_size)
            worst = self._worst_pages(sess)
        for j, lo, hi2 in repl_routes:
            if not self.servers[j].fits(sess.sid, hi2 - lo, n_pages, worst):
                raise NoCapacityError(
                    f"failover target {j} has no free cache slots")
        for j, lo, hi2 in repl_routes:
            self.servers[j].admit(sess.sid, hi2 - lo, n_pages=n_pages)
        # replay, recording each replacement hop's OWN input history so a
        # later failure of any replacement hop replays correct activations
        new_histories: List[List] = [[] for _ in repl_routes]
        if self._is_enc_dec:
            hs_enc, hs_dec = rec["enc"], rec["dec"]
            for i, (j, lo, hi2) in enumerate(repl_routes):
                new_histories[i].append(
                    {"enc": hs_enc if lo < self._n_enc else None,
                     "dec": hs_dec if hi2 > self._n_enc else None})
                hs_enc, hs_dec = self._replay_prefill_encdec(
                    sess, j, lo, hi2, hs_enc, hs_dec)
        else:
            hs = rec
            for i, (j, lo, hi2) in enumerate(repl_routes):
                new_histories[i].append(hs)
                hs = self._replay_prefill_range(sess, j, lo, hi2, hs)
        # replay each decoded token (encoder-only replacement hops do no
        # decode work; an encoder-only dead hop recorded no decode inputs)
        S = sess.prompt_len
        for t_idx, h_tok in enumerate(inputs[1:]):
            hh = self._hop_record(h_tok)
            emb0 = self._token_emb0(sess, S + t_idx)
            for i, (j, lo, hi2) in enumerate(repl_routes):
                if hi2 <= self._n_enc:
                    continue
                new_histories[i].append(hh)
                hh = self.servers[j].decode_range(sess.sid, hh, lo, hi2,
                                                  S + t_idx, emb0=emb0,
                                                  enc_len=sess.enc_len)
        new_servers[hop: hop + 1] = [j for j, _, _ in repl_routes]
        new_blocks[hop: hop + 1] = [hi2 - lo for _, lo, hi2 in repl_routes]
        sess.hop_inputs[hop: hop + 1] = new_histories
        sess.route = Route(servers=tuple(new_servers),
                           blocks=tuple(new_blocks))
        if dead_j in self.servers and \
                dead_j not in {j for j, _, _ in repl_routes}:
            self.servers[dead_j].evict(sess.sid)
        n_replay_tok = len(inputs) - 1
        cost = recovery_replay_cost(
            self.problem, sess.client, repl_routes, n_replay_tok,
            slowdown_of=lambda jj: self.servers[jj].slowdown)
        sess.replay_time += cost
        sess.virtual_time += cost
        sess.n_replays += 1
        self.round_stats["replays"] += 1
        self.round_stats["replay_s"] += cost
        sess.per_token_time = self._route_per_token(sess)
        sess.end = (sess.start + sess.virtual_time
                    + max(sess.n_new - sess.n_generated, 0)
                    * sess.per_token_time)

    # ------------------------------------------------------------------
    def set_slowdown(self, j: int, factor: float):
        """Straggler injection: server j runs ``factor``x its calibrated
        speed (absolute over the construction-time tau)."""
        servers = list(self.problem.servers)
        servers[j] = dataclasses.replace(servers[j],
                                         tau=self._base_taus[j] * factor)
        self.problem = dataclasses.replace(self.problem)
        self.problem.servers = servers
        for sess in self.sessions.values():
            if (sess.state in ("active", "preempted")
                    and j in sess.route.servers):
                sess.per_token_time = self._route_per_token(sess)
                sess.end = (sess.start + sess.virtual_time
                            + max(sess.n_new - sess.n_generated, 0)
                            * sess.per_token_time)


def generate(system: GeoServingSystem, tokens: np.ndarray, n_new: int,
             client: int = 0) -> Tuple[np.ndarray, float]:
    """End-to-end greedy generation.  Returns (tokens, virtual_time)."""
    sid, logits = system.submit(tokens, client)
    out = list(np.asarray(tokens))
    for _ in range(n_new):
        nxt = int(torch.argmax(logits[-1] if logits.dim() > 1 else logits))
        out.append(nxt)
        logits = system.decode(sid, nxt)
    vt = system.sessions[sid].virtual_time
    system.finish(sid)
    return np.asarray(out), vt
