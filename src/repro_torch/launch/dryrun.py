"""Multi-pod dry run: every (arch x shape x production mesh) cell of the
reference's ``repro/launch/dryrun.py``, counted per slot.

The reference lowers and compiles each cell's jitted step over 256 / 512
fake XLA devices and reads the compiled artifact.  The port lowers
nothing: it runs the cell's step itself — its own group code, eagerly —
on the slots of ``launch.mesh.make_production_mesh`` (16 x 16, or
2 x 16 x 16 over pods), every slot on the meta device, so nothing is
allocated and no card is needed.  A cell's step is the one the reference
lowers for its shape:

* train: ``make_train_step(cfg, opt, hp, sh)`` with remat and AdamW or
  Adafactor by ``make_optimizer_for``, on the slots' shards of the params,
  optimizer state and batch;
* prefill: ``models.prefill(..., ctxs=)`` with ``cache_len = seq_len``;
* decode: ``models.decode_step(..., ctxs=)`` at ``pos = seq_len - 1`` on
  each slot's shard of the cell's ``cache_specs``.

It is counted as it runs (``launch.costs.StepCount``: the aten ops'
flops by ``FlopCounterMode``'s formulas, their bytes and the live bytes;
``kernels.runtime.count_meta_calls``: K1–K4's ``cost``;
``models.layers.count_collectives``: the slot collectives' wire bytes by
the reference's ring model) and priced at the H100 SXM data sheet's rates
(``launch.costs``).  Every count is per slot: the group's total over its
slot count (the slots do like work; every slot of a cell has the same
shard shapes under ``guarded_spec``).  These are roofline bounds of the
port's eager step, not a time on a device.

The reference's scan correction has no counterpart: the port's stack is
an eager loop that counts every layer, so ``corrected_cost`` is the whole
step's count and equals ``raw_cost``.  ``segments`` still gives each
segment's ``n`` and one layer's cost (forward, and backward for train,
the remat's recompute included), counted on the segment's first layer;
``--no-corrections`` skips it.  The memory summary has the reference's
keys, taken from the meta run (:func:`memory_summary`), and a cell fits
where its peak is under the card's 80 GB (``costs.HBM_BYTES``).

Every production cell counts, the reference's three activation layout
rules included: ``seq_act`` (the train cells whose remat stash passes
8e9 bytes, DeepSeek-V2's prefill: each slot holds its sequence block of
the residual stream), ``attn_seq_q`` and the ``head_dim`` fallback (query
heads that do not divide the model axis of 16: Qwen2.5-32B and
Llama-4-Scout's 40, Gemma-3-4B's 8).  A cell that fails is recorded
under FAILURES and the CLI exits 1, as the reference's does.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_2_1b \\
        --shape decode_32k --mesh single --out experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES_BY_NAME, ModelConfig,
                                 ShapeSpec, get_config)
from repro_torch.kernels.runtime import count_meta_calls
from repro_torch.launch import costs as C
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import (ShardingCtx, batch_specs,
                                         cache_specs, make_ctx,
                                         param_shardings, shard,
                                         shard_params, slot_devices,
                                         slot_index)
from repro_torch.models.layers import (count_collectives, group_ctxs,
                                       param_dtype, seq_ctxs)
from repro_torch.models.model import (_call, _decode_layer_group,
                                      _full_layer_group, _slot_layers,
                                      decode_step, init_params_shapes,
                                      layer_params, prefill,
                                      slot_decode_caches, stack_plan,
                                      tree_nbytes)
from repro_torch.training.optimizer import tree_leaves, tree_map
from repro_torch.training.train_step import (GroupLayout, TrainHParams,
                                             make_optimizer_for,
                                             make_train_step)


# ---------------------------------------------------------------------------
# Spec plumbing
# ---------------------------------------------------------------------------


def input_specs(arch: str, shape_name: str, mesh) -> Dict:
    """Meta stand-ins for every model input of a cell, each whole leaf
    beside its per-slot spec: params (and their axes and specs), the
    train / prefill batch, the decode caches (cross caches at
    ``seq_len``) and tokens.  The group steps run slot 0's body for every
    slot (every slot's shards are alike under ``guarded_spec``)."""
    return cell_specs(get_config(arch), SHAPES_BY_NAME[shape_name], mesh)


def cell_specs(cfg: ModelConfig, shape: ShapeSpec, mesh,
               stand_in: bool = True,
               rules: Optional[Dict] = None) -> Dict:
    """:func:`input_specs` of any (config, shape, mesh) cell; ``stand_in``:
    its group steps run slot 0's body for every slot
    (``models.layers.GroupCtx``); ``rules``: the rules the cell runs
    under, in place of its own (e.g. a production cell's, at a batch cut
    to fit a card)."""
    sh = make_ctx(cfg, mesh, shape, stand_in) if rules is None else \
        ShardingCtx(mesh, rules, cfg, stand_in)
    out: Dict = {"cfg": cfg, "shape": shape, "sh": sh}
    params, axes = init_params_shapes(cfg)
    out["params"] = params
    out["param_axes"] = axes
    out["param_shardings"] = param_shardings(cfg, sh, axes, params)
    if shape.kind in ("train", "prefill"):
        out["batch"] = batch_specs(cfg, shape, sh)
    if shape.kind == "decode":
        out["caches"] = cache_specs(cfg, shape, sh, enc_len=shape.seq_len)
        tokens = torch.empty((shape.global_batch,), dtype=torch.int32,
                             device="meta")
        out["tokens"] = (tokens, sh.spec(("batch",), tokens.shape))
    return out


def _slot_batches(spec, mesh):
    """Per-slot dicts of each slot's block of the batch leaves (slot 0's
    alone under a stand-in ``sh``)."""
    stand_in = spec["sh"].stand_in
    out = [{} for _ in slot_devices(spec["sh"])]
    for name, (x, sp) in spec["batch"].items():
        for d, blk in zip(out, shard(x, sp, mesh, stand_in)):
            d[name] = blk
    return out


def _opt_shardings(opt, param_shardings_tree, opt_shapes):
    """Optimizer-state specs: AdamW's m / v shard as the params;
    Adafactor's state is whole on every slot, as the port's group step
    keeps it (its factored moments are means over a whole leaf; the
    reference replicates it too)."""
    if opt.name == "adamw":
        return {"m": param_shardings_tree, "v": param_shardings_tree}
    return tree_map(lambda x: (None,) * x.dim(), opt_shapes)


def _model_flops_per_device(cfg: ModelConfig, shape: ShapeSpec,
                            n_chips: int) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * tokens
    else:
        total = 2.0 * n_active * shape.global_batch
    return total / n_chips


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------


class _Count:
    """One counted run: the aten ops, the kernel calls and the slot
    collectives, per slot of an ``n``-slot group."""

    def __init__(self, n: int, pos: int, kv_len: int):
        self.n, self.pos, self.kv_len = n, pos, kv_len

    def __enter__(self):
        self._ops = C.StepCount()
        self._kernels = count_meta_calls(self.pos, self.kv_len)
        self._coll = count_collectives()
        self.kernels = self._kernels.__enter__()
        self.coll = self._coll.__enter__()
        self.ops = self._ops.__enter__()
        return self

    def __exit__(self, *exc):
        self._ops.__exit__(*exc)
        self._coll.__exit__(*exc)
        self._kernels.__exit__(*exc)

    def cost(self) -> C.CostSummary:
        n = self.n
        k = self.kernels.cost
        return C.CostSummary(
            flops=(self.ops.flops + k.flops) / n,
            bytes_accessed=(self.ops.bytes_accessed + k.bytes_accessed) / n,
            coll_wire_bytes=self.coll.wire / n,
            coll_count=int(round(self.coll.calls / n)),
            coll_by_kind={kk: v / n for kk, v in self.coll.by_kind.items()})


def memory_summary(arguments: float, outputs: float, fresh_outputs: float,
                   aliased: float, live_peak: float) -> Dict:
    """The reference's ``memory_summary`` keys for one slot of a meta run:
    ``argument_size_in_bytes`` (the slot's params, optimizer state, step,
    batch, caches and tokens), ``output_size_in_bytes`` (what the step
    returns on the slot), ``alias_size_in_bytes`` (the arguments it updates
    in place: a decode step's caches, a train step's state),
    ``temp_size_in_bytes`` (the peak of the live bytes the step allocates,
    less the outputs it allocates fresh) and ``peak_hbm_bytes`` = arguments
    + outputs + temp - alias, as the reference's.  ``live_peak`` is a
    slot's: the dry run runs slot 0 alone standing in for every slot, so
    it is that slot's own peak, as on a card of its own; a slot loop runs
    every slot in lockstep on one meta device, and a slot's share is the
    lockstep total over the slot count (the caller's), which the slots'
    interleaving makes smaller than a slot's own.  Eager code has no
    generated code."""
    temp = max(0.0, live_peak - fresh_outputs)
    out = {"argument_size_in_bytes": int(arguments),
           "output_size_in_bytes": int(outputs),
           "temp_size_in_bytes": int(temp),
           "alias_size_in_bytes": int(aliased),
           "generated_code_size_in_bytes": 0}
    out["peak_hbm_bytes"] = (out["argument_size_in_bytes"]
                             + out["output_size_in_bytes"]
                             + out["temp_size_in_bytes"]
                             - out["alias_size_in_bytes"])
    return out


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)) \
        if isinstance(x, dict) else x.numel() * x.element_size()


def _slot_bytes(tree, specs, mesh) -> int:
    """Bytes of slot 0's blocks of a tree of whole leaves under their
    per-slot specs (every slot's are alike)."""
    if isinstance(tree, dict):
        return sum(_slot_bytes(v, specs[k], mesh) for k, v in tree.items())
    idx = slot_index(tuple(tree.shape), specs, mesh, 0)
    n = 1
    for sl, d in zip(idx, tree.shape):
        n *= len(range(*sl.indices(d)))
    return n * tree.element_size()


def _pairs_bytes(pairs, mesh) -> int:
    """Slot bytes of a tree of (whole meta leaf, per-slot spec) pairs."""
    if isinstance(pairs, dict):
        return sum(_pairs_bytes(v, mesh) for v in pairs.values())
    return _slot_bytes(pairs[0], pairs[1], mesh)


def count_cell(spec: Dict, mesh, with_corrections: bool = True) -> Dict:
    """Run one cell's step (``spec``: :func:`input_specs`) on the meta
    slots of ``mesh`` and count it, per slot: {"cost": CostSummary,
    "aten_flops", "collective_bytes" (the part of the cost's bytes the
    slot collectives' own ops move), "kernel_cost", "memory",
    "live_peak" (the peak of the live bytes the step allocated),
    "segments", "seconds"}."""
    cfg, shape, sh = spec["cfg"], spec["shape"], spec["sh"]
    ctxs = group_ctxs(mesh, sh.rules, stand_in=sh.stand_in)
    n = len(ctxs)  # the slots run: every slot, or slot 0 standing in
    S, Bsz = shape.seq_len, shape.global_batch
    params = _slot_bytes(spec["params"], spec["param_shardings"], mesh)
    t0 = time.time()
    count = _Count(n, S - 1, S)
    if shape.kind == "train":
        hp = TrainHParams(remat=True, grad_accum=1)
        opt = make_optimizer_for(cfg, hp)
        step = make_train_step(cfg, opt, hp, sh)
        lay = GroupLayout(cfg, sh)
        state = lay.init_state(spec["params"], opt)
        batches = _slot_batches(spec, mesh)
        # the optimizer's state of the whole params (f32, whatever the
        # params' dtype), each leaf's slot share by its spec
        whole = opt.init(spec["params"])
        aliased = params + _nbytes(state["step"][0]) + _slot_bytes(
            whole, _opt_shardings(opt, spec["param_shardings"], whole),
            mesh)
        args = aliased + _pairs_bytes(spec["batch"], mesh)
        with count:
            state, metrics = step(state, batches)
        fresh = sum(_nbytes(v) for v in metrics.values())
        outputs = aliased + fresh
        layer_in = (lay.gather_fsdp(state["params"]), None, batches)
    elif shape.kind == "prefill":
        ps = shard_params(cfg, sh, spec["params"])
        batches = _slot_batches(spec, mesh)
        args = params + _pairs_bytes(spec["batch"], mesh)
        with count:
            logits, caches = prefill(ps, cfg, batches, cache_len=S,
                                     backend="kernel", ctxs=ctxs)
        fresh = outputs = _nbytes(logits[0]) + tree_nbytes(caches[0])
        aliased = 0
        del logits, caches
        layer_in = (ps, None, batches)
    else:
        ps = shard_params(cfg, sh, spec["params"])
        caches = [slot_decode_caches(cfg, c, Bsz, S, S, "meta")
                  for c in ctxs]
        toks = shard(*spec["tokens"], mesh, sh.stand_in)
        aliased = _pairs_bytes(spec["caches"], mesh)
        args = params + aliased + _pairs_bytes(spec["tokens"], mesh)
        with count:
            logits, caches = decode_step(ps, cfg, caches, toks, S - 1,
                                         backend="kernel", ctxs=ctxs)
        fresh = _nbytes(logits[0])
        outputs = fresh + aliased
        del logits
        layer_in = (ps, caches, Bsz // ctxs[0].row_block()[1])
    live_peak = count.ops.peak / n
    out = {"cost": count.cost(), "aten_flops": count.ops.flops / n,
           "collective_bytes": count.ops.collective_bytes / n,
           "kernel_cost": C.CostSummary(
               flops=count.kernels.cost.flops / n,
               bytes_accessed=count.kernels.cost.bytes_accessed / n),
           "memory": memory_summary(args, outputs, fresh, aliased,
                                    live_peak),
           "live_peak": live_peak, "segments": {}}
    if with_corrections:
        out["segments"] = _segment_costs(cfg, shape, ctxs, *layer_in)
    out["seconds"] = time.time() - t0
    return out


def _segment_costs(cfg: ModelConfig, shape: ShapeSpec, ctxs, ps, caches,
                   extra) -> Dict:
    """Per segment: its ``n`` and one layer's per-slot cost, counted on its
    first layer with per-slot inputs of the cell's shapes (``fwd``, and
    ``bwd`` for train: the gradient of the remat'd layer, its recompute
    included).  The encoder does no decode-time work."""
    n = len(ctxs)
    S = shape.seq_len
    act = param_dtype(cfg)
    train = shape.kind == "train"
    out = {}
    for seg in stack_plan(cfg):
        if shape.kind == "decode" and seg.kind == "enc":
            continue
        pl = _slot_layers([p["segments"] for p in ps], seg.name, seg.n)[0]
        shared = [p.get("shared") for p in ps]
        if shape.kind == "decode":
            rows = extra
            hs = [torch.empty((rows, 1, cfg.d_model), dtype=act,
                              device="meta") for _ in ctxs]
            poss = [torch.full((rows,), S - 1, device="meta")
                    for _ in ctxs]
            cl = [layer_params(c[seg.name], 0) for c in caches]
            with _Count(n, S - 1, S) as fwd:
                _decode_layer_group(cfg, seg, pl, cl, ctxs, hs, poss, 0,
                                    "kernel", shared, hs)
            out[seg.name] = {"n": seg.n, "fwd": fwd.cost().to_dict()}
            continue
        rows = extra[0]["tokens"].shape[0]
        # the layer's input: each slot's sequence block under seq_act
        sctxs = seq_ctxs(ctxs, rows * ctxs[0].row_block()[1], S)
        hs = [torch.empty((rows, S // sctxs[0].seq[1], cfg.d_model),
                          dtype=act, device="meta") for _ in ctxs]
        encs = [torch.empty((rows, S, cfg.d_model), dtype=act,
                            device="meta") for _ in ctxs]
        poss = [torch.arange(S, device="meta") for _ in ctxs]
        backend = "plain" if train else "kernel"

        def layer(pl, hs):
            return _full_layer_group(cfg, seg, pl, sctxs, hs, poss, 0,
                                     backend, shared, hs, encs)[0]

        with torch.no_grad(), _Count(n, S - 1, S) as fwd:
            layer(pl, hs)
        out[seg.name] = {"n": seg.n, "fwd": fwd.cost().to_dict()}
        if train:
            live = [tree_map(lambda x: x.detach().requires_grad_(True), p)
                    for p in pl]
            hs = [h.requires_grad_(True) for h in hs]
            with torch.enable_grad():
                ys = _call(True, layer, live, hs)
                with _Count(n, S - 1, S) as bwd:
                    torch.autograd.grad(
                        ys, hs + [x for t in live for x in tree_leaves(t)],
                        [torch.empty_like(y) for y in ys],
                        allow_unused=True)
            out[seg.name]["bwd"] = bwd.cost().to_dict()
    return out


# ---------------------------------------------------------------------------
# Cell lowering
# ---------------------------------------------------------------------------


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               with_corrections: bool = True) -> Dict:
    """One cell's artifact.  The port lowers nothing: it runs the cell's
    step on meta slots and counts it (the module docstring); the keys are
    the reference's, with ``count_seconds`` for ``compile_seconds`` and
    ``fits_hbm_80g`` for its 16 GB fits."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = int(mesh.devices.size)
    spec = input_specs(arch, shape_name, mesh)
    counted = count_cell(spec, mesh, with_corrections)
    mem = counted["memory"]
    raw = counted["cost"]
    corrected = C.CostSummary()
    corrected.scaled_add(raw, 1.0)

    # analytic HBM-traffic floor: everything the step necessarily touches
    # once per slot (params + opt state + caches = args; outputs), plus the
    # remat stash (written fwd, read bwd) for training
    stash = 0.0
    if shape.kind == "train":
        n_data = n_chips // 16  # data axes product (model axis is 16)
        stash = (shape.global_batch / n_data) * shape.seq_len \
            * cfg.d_model * 2 * cfg.n_layers
        if spec["sh"].rules.get("seq_act") is not None:
            stash /= 16
    mem_floor = (mem["argument_size_in_bytes"]
                 + mem["output_size_in_bytes"] + 2.0 * stash)
    terms = C.roofline_terms(corrected, n_chips, mem_floor_bytes=mem_floor)
    model_flops = _model_flops_per_device(cfg, shape, n_chips)
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "count_seconds": round(counted["seconds"], 2),
        "memory": mem,
        "raw_cost": raw.to_dict(),
        "corrected_cost": corrected.to_dict(),
        "aten_flops": counted["aten_flops"],
        "collective_bytes": counted["collective_bytes"],
        "kernel_cost": counted["kernel_cost"].to_dict(),
        "segments": counted["segments"],
        "roofline": terms,
        "model_flops_per_device": model_flops,
        "useful_flops_ratio": (model_flops / corrected.flops
                               if corrected.flops else 0.0),
        "fits_hbm_80g": bool(mem["peak_hbm_bytes"] < C.HBM_BYTES),
    }
    gc.collect()
    return result


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def runnable_cells():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in cfg.shapes():
            yield arch, shape.name
        for shape_name, reason in cfg.skip_reasons().items():
            yield arch, f"SKIP:{shape_name}:{reason}"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--no-corrections", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()

    if args.list:
        for arch, shape in runnable_cells():
            print(f"{arch},{shape}")
        return

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    meshes = args.mesh.split(",")
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([s.name for s in cfg.shapes()] if args.shape == "all"
                  else [s for s in args.shape.split(",")
                        if s in {x.name for x in cfg.shapes()}])
        for shape_name in shapes:
            for mesh_kind in meshes:
                multi = mesh_kind == "multi"
                tag = f"{arch}__{shape_name}__{'multi' if multi else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"skip (exists) {tag}")
                    continue
                print(f"=== {tag} ===", flush=True)
                try:
                    res = lower_cell(arch, shape_name, multi,
                                     with_corrections=not args.no_corrections)
                    with open(path, "w") as f:
                        json.dump(res, f, indent=1)
                    r = res["roofline"]
                    peak = res["memory"]["peak_hbm_bytes"] / 1e9
                    print(f"  ok count={res['count_seconds']}s "
                          f"peak_hbm={peak:.2f}GB "
                          f"compute={r['compute_s']*1e3:.2f}ms "
                          f"memory={r['memory_s']*1e3:.2f}ms "
                          f"coll={r['collective_s']*1e3:.2f}ms "
                          f"dominant={r['dominant']} "
                          f"useful={res['useful_flops_ratio']:.3f}",
                          flush=True)
                except Exception as e:  # noqa: BLE001
                    failures.append((tag, repr(e)))
                    print(f"  FAIL {e}", flush=True)
                    traceback.print_exc()
                gc.collect()
    if failures:
        print("\nFAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err}")
        raise SystemExit(1)
    print("\nall requested cells counted OK")


if __name__ == "__main__":
    main()
