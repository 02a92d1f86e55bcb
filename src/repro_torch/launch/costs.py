"""Roofline pricing of the port's steps and kernel calls on one H100.

The framework-free half of the reference's ``repro/launch/costs.py``:
``CostSummary`` (flops, bytes, collective bytes), ``roofline_terms`` and
``tau_from_step_cost`` with the reference's arithmetic, over this card's
published rates instead of the TPU's.  A ``CostSummary`` here comes from
shapes (``BlockServer.decode_step_cost``, the kernel wrappers' ``cost``),
not from a compiler's cost analysis.  A device group's step counts its
slot collectives as it runs on meta tensors
(``models.layers.count_collectives``): each call's wire bytes by the ring
model of the reference's ``parse_collectives`` (all-reduce 2(g-1)/g N,
all-gather (g-1)/g N_out, a point-to-point send N), priced over
``NVLINK_BW``.

The dry run (``launch.dryrun``) prices a whole step run on meta tensors
with :class:`StepCount`, the counterpart of the reference's readers of a
compiled XLA artifact (``summarize_compiled``, ``memory_summary``): the
aten ops' flops by ``FlopCounterMode``'s formulas, the bytes each op
moves and the live bytes the step allocates.  These are the port's own
counts of its eager step, not XLA's HLO figures.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

# NVIDIA's H100 SXM data sheet, dense rates (no sparsity) at the 700 W
# power limit: HBM3 bytes/s; flop/s of the bf16 and TF32 tensor cores and
# of f32 on the CUDA cores
HBM_BW = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12}
PEAK_FLOPS_BF16 = PEAK_FLOPS["bfloat16"]
# the same data sheet's HBM3 capacity, 80 GB
HBM_BYTES = 80e9
# the same data sheet's NVLink 4 rate, 900 GB/s per GPU counting both
# directions: 450e9 B/s is what one direction of a ring step sees
NVLINK_BW = 450e9


@dataclass
class CostSummary:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    coll_wire_bytes: float = 0.0
    coll_count: int = 0
    coll_by_kind: Dict[str, float] = field(default_factory=dict)

    def scaled_add(self, other: "CostSummary", k: float):
        self.flops += k * other.flops
        self.bytes_accessed += k * other.bytes_accessed
        self.coll_wire_bytes += k * other.coll_wire_bytes
        self.coll_count += int(k * other.coll_count)
        for kk, v in other.coll_by_kind.items():
            self.coll_by_kind[kk] = self.coll_by_kind.get(kk, 0.0) + k * v

    def to_dict(self):
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "coll_wire_bytes": self.coll_wire_bytes,
                "coll_count": self.coll_count,
                "coll_by_kind": dict(self.coll_by_kind)}


def tau_from_step_cost(cost: CostSummary, n_chips: int, m_blocks: int,
                       n_rows: int) -> float:
    """Per-block per-token decode τ (s) from one pooled decode step's cost.

    The step advances every pool row one token through all ``m_blocks``
    hosted blocks, so the roofline bound of ONE step amortises over
    ``m_blocks x n_rows`` (block, token) pairs — exactly the τ the paper's
    eq. (1) multiplies back up."""
    terms = roofline_terms(cost, n_chips)
    return terms["bound_s"] / max(1, int(m_blocks) * int(n_rows))


def roofline_terms(cost: CostSummary, n_chips: int,
                   dtype: str = "bfloat16",
                   mem_floor_bytes: float = 0.0) -> Dict:
    """The least time of ``cost`` on one card: flops over the peak of
    ``dtype`` (the bf16 tensor cores by default, as the reference prices
    every step), bytes over the HBM rate, collective wire bytes over
    NVLink; the largest bounds.  ``cost`` is per card (a group's per
    slot), so ``n_chips`` does not scale it (the reference's
    convention).  ``memory_s_floor`` prices ``mem_floor_bytes``, the
    bytes a step must touch at least (the dry run's analytic floor).
    The reference's ``memory_s_tpu_est`` halves XLA:CPU's bytes, which
    its CPU backend counts with bf16 upcast to f32; the port counts its
    own ops in their own dtypes, so it has no counterpart."""
    compute_s = cost.flops / PEAK_FLOPS[dtype]
    memory_s = cost.bytes_accessed / HBM_BW
    memory_s_floor = mem_floor_bytes / HBM_BW
    collective_s = cost.coll_wire_bytes / NVLINK_BW
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)), key=lambda t: t[1])[0]
    total = max(compute_s, memory_s, collective_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "memory_s_floor": memory_s_floor,
        "collective_s": collective_s,
        "dominant": dominant,
        "bound_s": total,
        "compute_fraction_of_bound": (compute_s / total) if total > 0 else 0.0,
    }


def bound_ms(cost: CostSummary, dtype: str) -> Tuple[float, str]:
    """A kernel call's least time in ms and what bounds it ("bytes" or
    "operations"), its flops priced at the peak of ``dtype``."""
    t = roofline_terms(cost, 1, dtype)
    return (t["bound_s"] * 1e3,
            "bytes" if t["memory_s"] >= t["compute_s"] else "operations")


# ---------------------------------------------------------------------------
# Counting a step run on meta tensors
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# ops FlopCounterMode leaves to the tensor's own sizes policy
_METADATA = frozenset({
    _aten.sym_is_contiguous.default, _aten.is_contiguous.default,
    _aten.is_contiguous.memory_format, _aten.is_strides_like_format.default,
    _aten.is_non_overlapping_and_dense.default, _aten.size.default,
    _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default,
    _aten.storage_offset.default, _aten.sym_storage_offset.default,
    _aten.numel.default, _aten.sym_numel.default, _aten.dim.default,
    torch.ops.prim.layout.default})
# in-place scatters: the argument (by position) whose values they write;
# the rest of the destination is neither read nor written
_SCATTERS = {_aten.index_put_.default: 2, _aten._index_put_impl_.default: 2,
             _aten.index_copy_.default: 3, _aten.scatter_.src: 3,
             _aten.scatter_add_.default: 3}
# gathers: they read of their source (the first argument) only what they
# return
_GATHERS = frozenset({_aten.index.Tensor, _aten.embedding.default,
                      _aten.index_select.default, _aten.gather.default})
# ops whose output holds no data yet, or shares its input's (``_unsafe_view``
# is a view the schema does not mark as one): they move no bytes
_NO_DATA = frozenset({_aten.empty.memory_format, _aten.empty_strided.default,
                      _aten.new_empty.default, _aten.empty_like.default,
                      _aten.new_empty_strided.default,
                      _aten._unsafe_view.default})


# depth of the slot collectives running (``models.layers.GroupCtx``): the
# ops inside one emulate its peers' part on this slot's device
_COLLECTIVE = [0]


@contextlib.contextmanager
def collective_ops():
    """The ops inside run a slot collective (the sums and copies that stand
    for its peers' part): :class:`StepCount` reports their bytes apart,
    as ``collective_bytes``."""
    _COLLECTIVE[0] += 1
    try:
        yield
    finally:
        _COLLECTIVE[0] -= 1


# the weight at which the counts add (``counted_at``)
_WEIGHT = [1.0]


@contextlib.contextmanager
def counted_at(weight: float):
    """The counts made inside — :class:`StepCount`'s flops, bytes and
    live bytes (a storage made here counts at ``weight`` while it lives),
    the kernels' meta costs (``kernels.runtime.count_meta_calls``) — add
    at ``weight``: a slot standing in for its group runs each variant of
    a computation whose work differs by slot (the causal span of a block
    of query rows, a time shard under a window) at 1/n, so that it counts
    the slots' mean."""
    old = _WEIGHT[0]
    _WEIGHT[0] = old * weight
    try:
        yield
    finally:
        _WEIGHT[0] = old


def count_weight() -> float:
    """The weight counts add at here (:func:`counted_at`; 1 outside)."""
    return _WEIGHT[0]


def set_count_weight(weight, scale: float = 1.0) -> float:
    """Set the weight counts add at to ``weight`` (None: the current one)
    times ``scale``, outside :func:`counted_at` — a stand-in's backward,
    which runs after the forward's ``counted_at`` has ended
    (``attention._slots_mean``); returns the old weight."""
    old = _WEIGHT[0]
    _WEIGHT[0] = (old if weight is None else weight) * scale
    return old


def _nbytes(t) -> int:
    """Bytes of the distinct elements of ``t``: a broadcast dim (stride 0,
    an ``expand``) is read once."""
    n = t.element_size()
    for d, st in zip(t.shape, t.stride()):
        if st:
            n *= d
    return n


def _desc(a):
    """A hashable stand-in for an op argument: a tensor by its shape,
    strides, dtype and device."""
    if isinstance(a, torch.Tensor):
        return (a.shape, a.stride(), a.dtype, a.device)
    if isinstance(a, (list, tuple)):
        return tuple(_desc(x) for x in a)
    if isinstance(a, dict):
        return tuple(sorted((k, _desc(v)) for k, v in a.items()))
    return a


def _tensors(xs, out):
    """The tensors of ``xs`` (an op's arguments or results: tensors,
    scalars and lists of them), appended to ``out``."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _tensors(x, out)
    return out


class _OpInfo:
    """What :class:`StepCount` needs of an op's schema, once per op."""

    def __init__(self, func, registry):
        schema = func._schema
        self.aliases = [r.alias_info for r in schema.returns]
        self.view = any(a is not None and not a.is_write
                        for a in self.aliases)
        self.fresh = all(a is None for a in self.aliases)
        self.written = [i for i, a in enumerate(schema.arguments)
                        if a.alias_info is not None and a.alias_info.is_write]
        self.flops = registry.get(func._overloadpacket)
        self.decomposes = self.flops is None and \
            func is not torch.ops.prim.device.default and \
            torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
        self.no_data = func in _NO_DATA


class StepCount(TorchDispatchMode):
    """One step's count, taken as the step runs (on meta tensors in the dry
    run; on any device otherwise):

    * ``flops`` — the aten ops' flops by ``FlopCounterMode``'s registry and
      its rule (an op without a formula is decomposed where it can be), so
      a meta run counts what ``FlopCounterMode`` counts of the same step on
      the card.  The hand-written kernels' calls add their ``cost`` through
      ``kernels.runtime.count_meta_calls``, not here;
    * ``bytes_accessed`` — each op's tensor inputs read once (a broadcast
      dim once) and its outputs written once; an op whose outputs alias an
      input (views, reshapes, expands, slices) moves nothing, nor does an
      allocation of an empty tensor; an argument an op writes in place
      counts as written only, and a scatter into it (``index_put_``,
      ``index_copy_``, ``scatter_``) as the values it writes; a gather
      (``index``, ``embedding``, ``index_select``, ``gather``) reads of its
      source what it returns;
    * ``collective_bytes`` — the part of ``bytes_accessed`` that the slot
      collectives' own ops move (:func:`collective_ops`): a group on one
      device sums a row's partials on every slot, (g - 1) adds of the
      whole operand, where a ring all-reduce reads and writes it about
      twice;
    * ``live`` / ``peak`` — the bytes of the storages the step allocated
      that are still alive (each at the weight it was made at,
      :func:`counted_at`), and their maximum: a storage counts from the
      op that makes it until Python frees it.  Tensors that exist before
      the block (the step's arguments) are not counted.

    On meta tensors an op's result depends only on its arguments' shapes,
    strides and dtypes, so the mode keeps the result's layout per such key
    and makes later calls' results with ``torch.empty_strided``: a group's
    slots run the same ops, and the first slot pays for the meta kernels
    (many of which are Python decompositions)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collective_bytes = 0
        self.live = 0
        self.peak = 0
        self._memo: Dict = {}
        self._ops: Dict = {}
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry

    def _free(self, n: int):
        self.live -= n

    def _track(self, outs, ins):
        seen = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if id(st) in seen:
                continue
            seen.add(id(st))
            n = st.nbytes()
            if _WEIGHT[0] != 1.0:
                n *= _WEIGHT[0]
            self.live += n
            weakref.finalize(st, self._free, n)
        if self.live > self.peak:
            self.peak = self.live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        info = self._ops.get(func)
        if info is None:
            info = self._ops[func] = _OpInfo(func, self._registry)
        if info.decomposes:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        if info.view:
            return func(*args, **kwargs)  # a view: nothing moves
        ins = _tensors(args, [])
        if kwargs:
            _tensors(kwargs.values(), ins)
        out = self._run(func, args, kwargs, ins, info)
        outs = _tensors((out,), [])
        if not info.no_data:
            mutated = {id(args[i]) for i in info.written if i < len(args)}
            read = 0
            if func in _GATHERS:
                mutated.add(id(args[0]))
                read = sum(_nbytes(t) for t in outs)
            src = _SCATTERS.get(func)
            moved = read + sum(
                _nbytes(t) for t in ins if id(t) not in mutated) + (
                sum(_nbytes(t) for t in outs) if src is None
                else _nbytes(args[src]))
            if _WEIGHT[0] != 1.0:
                moved *= _WEIGHT[0]
            self.bytes_accessed += moved
            if _COLLECTIVE[0]:
                self.collective_bytes += moved
        if info.flops is not None:
            flops = info.flops(*args, **kwargs, out_val=out)
            self.flops += flops if _WEIGHT[0] == 1.0 else flops * _WEIGHT[0]
        if info.fresh:
            self._track(outs, ins)
        return out

    def _run(self, func, args, kwargs, ins, info):
        """``func(*args, **kwargs)``, from the memo for meta arguments."""
        if not ins or any(t.device.type != "meta" for t in ins) or \
                any(i >= len(args) for i in info.written):
            return func(*args, **kwargs)
        key = (func, _desc(args), _desc(kwargs) if kwargs else None)
        hit = self._memo.get(key)
        if hit is None:
            out = func(*args, **kwargs)
            flat, spec = tree_flatten(out)
            if all(isinstance(t, torch.Tensor) for t in flat):
                aliases = info.aliases + [None] * len(flat)
                self._memo[key] = (spec, [
                    None if a is not None else
                    (t.shape, t.stride(), t.dtype, t.device)
                    for t, a in zip(flat, aliases)])
            return out
        spec, layouts = hit
        mutated = [args[i] for i in info.written]
        return tree_unflatten([
            mutated.pop(0) if lay is None else torch.empty_strided(
                lay[0], lay[1], dtype=lay[2], device=lay[3])
            for lay in layouts], spec)
