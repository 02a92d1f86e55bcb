#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):

1. device  — the card's name and power limit; build the five CUDA kernel
             sources from ``src/repro_torch/kernels/csrc`` with nvcc for
             sm_90a (one nvcc per source, in parallel); the build seconds,
             ptxas registers and spills of each K1 / K2 / K3 / K4
             instantiation, and the TF32 tensor-core instructions
             (HMMA.1688.F32.TF32) in the scans' SASS.
2. serve   — three full-width models in bf16 (random weights from a seed),
             one after the other, each served through the port's
             GeoServingSystem + ContinuousBatchingScheduler on 5 virtual
             servers (CG-BP placement split over >= 2 of them, WS-RR
             routing), 8 Poisson requests of 32-128 prompt tokens and 32
             new tokens: Llama-3.2-1B (K1 decode and K2 flash attention),
             RWKV6-7B (K3 WKV6 in prefill), Zamba2-7B (K4 SSD in prefill,
             K2/K1 at head dim 224 in its shared attention).  Each path's
             kernel counters are zeroed just before its run and read just
             after; each kernel must have run, and every decode round must
             make exactly one host sync.
3. kernels — K1-K4 against their plain PyTorch versions on the card: a
             feature sweep (attention in bf16 and f32 up to head dim 224,
             K1's split-KV edges — long caches, windows across splits,
             empty splits, fully masked rows, one split — K2 at every
             (Dk, Dv) pair, misaligned bf16 views that must raise; the
             chunked scans in f32 with ragged S, S = 1, carried state, S at
             Q - 1, Q, Q + 1 and 4Q + 3 of each kernel's chunk Q, K3 decays
             down to lw = -60, walked and parallel chunks, bit-identical
             repeats, zero-pad state invariance and misaligned views that
             must raise), and the paths' own captured inputs and one long
             shape each, timed (kernel, plain, one PyTorch SDPA call where
             one exists, and the bound), with K1's split plan, the K2
             design and the scans' chunk plan (Q, launches a call) that
             served each row.
4. parity  — Llama-3.2-1B in f32: engine greedy streams equal the
             monolithic prefill/decode_step streams; first-step logits
             agree with a monolithic forward on the plain attention; a
             kill_server drill leaves the stream unchanged.  Reduced
             RWKV6 and zamba2 in f32: the engine on the kernels gives the
             monolithic streams on the plain versions, through the
             scheduler and through a kill_server drill.

The last lines are the kernels JSON, the nvidia-smi name/power line, and
the result JSON.  Without a CUDA device, or outside the repository, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (dense): HBM bytes/s; bf16 and TF32
# tensor-core, and f32 (non-tensor-core) flop/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-5}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------


def device_ms(torch, fn, arg_sets, reps=30):
    """Mean device time of ``fn(*args)`` in ms.  The stream is first held
    busy so the host enqueues every launch ahead of the device (no launch
    gaps in the window), and the launches cycle through ``arg_sets`` whose
    total size exceeds the 50 MB L2, so each launch finds its inputs cold
    as the serving path does."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def copies(torch, tensors, min_bytes=64 << 20):
    """Enough copies of an input set to exceed the L2 cache in total."""
    size = sum(t.numel() * t.element_size() for t in tensors
               if torch.is_tensor(t))
    n = max(2, math.ceil(min_bytes / max(size, 1)))
    return [[t.clone() if torch.is_tensor(t) else t for t in tensors]
            for _ in range(n)]


# ---------------------------------------------------------------------------
# kernel bounds (least time for the same work: bytes or operations)
# ---------------------------------------------------------------------------


def _bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def decode_bound(q, k, v, pos, window=None, kv_len=None):
    """Bytes/flops this decode call needs: the query, each K/V row the
    mask reaches (data dependent: per row from pos), the output."""
    B, _, H, Dk = q.shape
    T, Kv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    es = q.element_size()
    pos_l = [int(p) for p in pos.tolist()]
    kvl = [T] * B if kv_len is None else [int(x) for x in kv_len.tolist()]
    rows = 0
    for p, kl in zip(pos_l, kvl):
        hi = min(p + 1, kl, T)
        lo = 0 if window is None else max(0, p - window + 1)
        rows += max(hi - lo, 0)
    nbytes = (B * H * Dk + B * H * Dv) * es + rows * Kv * (Dk + Dv) * es \
        + 4 * B
    flops = 2 * rows * H * (Dk + Dv)
    return _bound(nbytes, flops, str(q.dtype).split(".")[-1])


def prefill_bound(q, k, v, q_start=0):
    """Bytes/flops of a causal prefill call: q, k, v read once, out written
    once; score and P.V flops over the causally valid pairs."""
    B, Sq, H, Dk = q.shape
    Skv, Dv = k.shape[1], v.shape[-1]
    es = q.element_size()
    pairs = sum(min(q_start + i + 1, Skv) for i in range(Sq))
    nbytes = (q.numel() + k.numel() + v.numel() + B * Sq * H * Dv) * es
    flops = 2 * B * H * pairs * (Dk + Dv)
    return _bound(nbytes, flops, str(q.dtype).split(".")[-1])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def kernel_label(mangled: str) -> str:
    """``ssd_chunk_kernel<64, 64, 2>`` from a mangled kernel name (the
    mangled name where c++filt is missing)."""
    import re

    try:
        name = subprocess.run(["c++filt", mangled], capture_output=True,
                              text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return mangled
    name = re.sub(r"^void |\(anonymous namespace\)::|repro::", "", name)
    return name.split("(")[0]


def tf32_mma_count(lib) -> str:
    """HMMA.1688.F32.TF32 instructions in a built library's SASS."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        return f"not measured (cuobjdump: {e})"
    return f"{sass.count('HMMA.1688.F32.TF32')} HMMA.1688.F32.TF32"


def phase_build():
    from repro_torch.kernels import runtime

    t0 = time.perf_counter()
    runtime.build_all()
    total = time.perf_counter() - t0
    log(f"[build] nvcc {' '.join(runtime.NVCC_FLAGS[:2])} from "
        f"{runtime.CSRC.relative_to(ROOT)}: {total:.1f} s wall "
        f"(one nvcc per source, in parallel)")
    for name, (sec, report) in runtime.BUILD_LOG.items():
        regs = sorted({int(line.split("Used ")[1].split()[0])
                       for line in report.splitlines() if "Used " in line})
        # ptxas names each kernel ("Compiling entry function '<mangled>'")
        # and then reports its stack frame and spills, then its registers
        spills, per_kernel, entry, spill = [], [], "", ""
        for line in report.splitlines():
            if "entry function" in line:
                entry = kernel_label(line.split("'")[1])
            elif "spill" in line:
                spill = line.strip()
                if not spill.startswith("0 "):
                    spills.append(f"{entry}: {spill}")
            elif "Used " in line:
                per_kernel.append(f"{entry}: {line.split('Used ')[1]}; "
                                  f"{spill}")
        log(f"[build]   csrc/{name}.cu: {sec:.1f} s, registers/thread "
            f"{regs}, spilling kernels {len(spills)}")
        for line in spills:
            log(f"[build]     spills {line}")
        if name != "flash_attention":
            for line in per_kernel:
                log(f"[build]     {line}")
        if name in ("wkv6", "ssd"):
            log(f"[build]     csrc/{name}.cu SASS: "
                f"{tf32_mma_count(runtime.library_path(name))}")
    for name in runtime.KERNEL_SOURCES:
        if not runtime.library_path(name).exists():
            raise RuntimeError(f"kernel library {name} was not built")


def poisson_arrivals(n, rate, seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    return np.cumsum(rng.exponential(1.0 / rate, n))


def serve_problem(C, name, n_layers):
    """examples/geo_serve.py's 5-server cluster with memory scaled by depth
    (x L/16 from 16 layers up), so CG-BP covers every block with the stack
    split over at least two servers and 8 rows per server."""
    import numpy as np

    scale = max(1.0, n_layers / 16)
    llm = C.LLMSpec(name, n_layers, block_bytes=50.0,
                    cache_bytes_per_token=0.25)
    mem = tuple(scale * m for m in (1600.0, 1600.0, 700.0, 700.0, 700.0))
    tau = (0.004, 0.004, 0.02, 0.02, 0.02)
    servers = [C.ServerSpec(j, m, t) for j, (m, t) in enumerate(zip(mem,
                                                                    tau))]
    rtt = np.array([[0.01, 0.01, 0.03, 0.03, 0.03]])  # examples/geo_serve.py
    return C.Problem(llm, servers, 1, rtt, 3 * rtt,
                     workload=C.Workload(128, 32))


# the kernels each served stack's path must launch (wrapper name -> the
# model module attribute the path calls it through)
PATH_KERNELS = {
    "llama3_2_1b": ("decode_attention", "flash_attention"),
    "rwkv6_7b": ("wkv6",),
    "zamba2_7b": ("ssd", "decode_attention", "flash_attention"),
}


def phase_serve(torch, arch, captured):
    """Serve one full-width model in bf16 (random weights from a seed)
    through GeoServingSystem + ContinuousBatchingScheduler: 8 Poisson
    requests, prompts of 32-128 tokens (several distinct lengths), 32 new
    tokens each.  The path's kernel counters are zeroed just before the
    scheduler run and read just after; every kernel of the path must have
    launched, every decode round must make exactly one host sync, and every
    stream must be complete.  One real call of each kernel is kept for the
    kernel phase (``captured[(arch, name)]``).  Returns the launches."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import init_params
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.serving import (ContinuousBatchingScheduler,
                                     GeoServingSystem)

    cfg = get_config(arch)
    tag = f"[serve {arch}]"
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.2f} B params in {cfg.param_dtype}; random init "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    problem = serve_problem(C, cfg.name, cfg.n_layers)

    def build():
        return GeoServingSystem(cfg, params, problem, algorithm="proposed",
                                R=4, max_new_tokens=32, max_sessions=8)

    # warm-up: one request through a throwaway engine (cuBLAS handles,
    # kernel libraries loaded); not part of the measured run
    warm = build()
    ws = ContinuousBatchingScheduler(warm, R=4)
    ws.submit(0, np.arange(2, 50), 0.0, n_new=4)
    ws.run()
    del warm, ws

    system = build()
    caps = {j: srv.pool.n_rows for j, srv in system.servers.items()}
    spans = sorted((int(a), int(a + m)) for a, m in zip(system.placement.a,
                                                         system.placement.m)
                   if m > 0)
    log(f"{tag} placement a={system.placement.a.tolist()} "
        f"m={system.placement.m.tolist()}; rows per server {caps}; "
        f"max_seq_len {system.max_seq_len}")
    covered = set()
    for a, b in spans:
        covered.update(range(a, b))
    if covered != set(range(cfg.n_layers)) or \
            max(b - a for a, b in spans) >= cfg.n_layers:
        raise RuntimeError(f"placement {spans} does not split the "
                           f"{cfg.n_layers} blocks over >= 2 servers")
    if min(caps.values()) < 8:
        raise RuntimeError(f"expected >= 8 rows per server, got {caps}")

    walls = {"prefill": [], "decode": []}
    syncs = {"prefill": [], "decode": []}

    def timed(kind, fn):
        """Wall time of one round (ended by a synchronize) and the host
        syncs it made, counted by PyTorch's sync debug mode."""
        def run(*a, **kw):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                t = time.perf_counter()
                try:
                    out = fn(*a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                walls[kind].append(time.perf_counter() - t)
            syncs[kind].append(sum("synchroniz" in str(w.message)
                                   for w in caught))
            return out
        return run

    system.prefill_round = timed("prefill", system.prefill_round)
    system.decode_round = timed("decode", system.decode_round)

    # keep one real call of each kernel from the main path (a decode step
    # well into the run; the longest prefill / scan call) for the kernel
    # phase; copies are taken only on those calls
    real = {"decode_attention": attn_mod.decode_attention,
            "flash_attention": attn_mod.flash_attention,
            "wkv6": ssm_mod.wkv6, "ssd": ssm_mod.ssd}
    n_decode = [0]

    def keep_decode(q, ck, cv, pos, **kw):
        n_decode[0] += 1
        if n_decode[0] == 200:
            captured[(arch, "decode_attention")] = (
                (q.clone(), ck.clone(), cv.clone(), pos.clone()), kw)
        return real["decode_attention"](q, ck, cv, pos, **kw)

    def keep_longest(name):
        def keep(*args, **kw):
            key = (arch, name)
            if key not in captured or \
                    args[0].shape[1] > captured[key][0][0].shape[1]:
                captured[key] = (tuple(a.clone() if torch.is_tensor(a)
                                       else a for a in args), kw)
            return real[name](*args, **kw)
        return keep

    attn_mod.decode_attention = keep_decode
    attn_mod.flash_attention = keep_longest("flash_attention")
    ssm_mod.wkv6, ssm_mod.ssd = keep_longest("wkv6"), keep_longest("ssd")
    sched = ContinuousBatchingScheduler(system, R=4)
    rng = np.random.RandomState(0)
    arrivals = poisson_arrivals(8, rate=2.0, seed=1)
    lens = rng.randint(32, 129, 8)
    if cfg.family in ("ssm", "hybrid"):
        lens[1::3] = lens[0]  # equal lengths form exact-length groups
    for rid, (t, n) in enumerate(zip(arrivals, lens)):
        sched.submit(rid, rng.randint(2, cfg.vocab_size, int(n)), float(t),
                     n_new=32)
    kern = {name: getattr(K, name) for name in PATH_KERNELS[arch]}
    for fn in kern.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        served = sched.run()
        torch.cuda.synchronize()
    finally:
        attn_mod.decode_attention = real["decode_attention"]
        attn_mod.flash_attention = real["flash_attention"]
        ssm_mod.wkv6, ssm_mod.ssd = real["wkv6"], real["ssd"]
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kern.items()}

    ok = [s for s in served if not s.dropped]
    n_gen = sum(len(s.tokens) - int(n) for s, n in zip(served, lens))
    log(f"{tag} served {len(ok)}/8 requests, prompts "
        f"{sorted(lens.tolist())} tokens, {n_gen} generated tokens")
    for s in served:
        log(f"{tag}   req {s.rid}: arrival {s.arrival:.3f} start "
            f"{s.start:.3f} wait {s.wait:.4f} first-token "
            f"{s.first_token:.4f} per-token {s.per_token:.4f} (virtual s) "
            f"deferrals {s.n_deferrals}")
    log(f"{tag} kernel launches in the run: {launches}")
    log(f"{tag} round_stats {system.round_stats}")
    rs = system.round_stats
    for kind, w in walls.items():
        if w:
            log(f"{tag} {kind} rounds: {len(w)}, wall per round mean "
                f"{1e3 * sum(w) / len(w):.2f} ms, median "
                f"{1e3 * sorted(w)[len(w) // 2]:.2f} ms, max "
                f"{1e3 * max(w):.2f} ms; host syncs per round "
                f"{min(syncs[kind])}..{max(syncs[kind])}")
    log(f"{tag} run wall {wall:.3f} s, {n_gen / wall:.1f} generated "
        f"tokens/s (host clock around the whole scheduler run)")
    if len(ok) != 8:
        raise RuntimeError(f"served {len(ok)}/8")
    if any(len(s.tokens) != int(n) + 32 for s, n in zip(served, lens)):
        raise RuntimeError("a request did not get its 32 tokens")
    if any(not (0 <= int(t) < cfg.vocab_size) for s in served
           for t in s.tokens):
        raise RuntimeError("token outside the vocabulary")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the path never launched: "
                           f"{launches}")
    if rs["embed_dispatches"] != rs["rounds"] or \
            rs["tail_dispatches"] != rs["rounds"]:
        raise RuntimeError("a decode round did not take exactly one embed "
                           "and one tail dispatch")
    if set(syncs["decode"]) != {1}:
        seen = sorted(set(syncs["decode"]))
        raise RuntimeError(f"decode rounds made {seen} host syncs; the "
                           "token readback is the only one")
    # the engine's wrapped round methods close over it (a reference
    # cycle): collect it, so the model is gone before the next one loads
    del system, sched, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{tag} freed: device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def scan_bound(kind, args):
    """Bytes/flops of one K3 (``wkv6``) or K4 (``ssd``) call: every input
    read once, out and state written once; the recurrence's flops (two FMAs
    per state element per token) over the TF32 tensor-core peak, the
    fastest unit an f32 scan can use (its products run there as 3xTF32)."""
    if kind == "wkv6":
        r, k, v, lw, u = args[:5]
        state = args[5] if len(args) > 5 else None
        B, S, H, hd = r.shape
        n_state = B * H * hd * hd
        nbytes = 4 * (5 * B * S * H * hd + H * hd + n_state
                      + (0 if state is None else n_state))
        flops = 4 * B * S * H * hd * hd
    else:
        x, bm, cm, dt, A, D = args[:6]
        state = args[6] if len(args) > 6 else None
        B, S, H, p = x.shape
        n = bm.shape[-1]
        n_state = B * H * p * n
        nbytes = 4 * (2 * B * S * H * p + 2 * B * S * n + B * S * H + 2 * H
                      + n_state + (0 if state is None else n_state))
        flops = 4 * B * S * H * p * n
    return _bound(nbytes, flops, "tfloat32")


def scan_ok(got, want):
    """K3/K4 tolerance, f32: |kernel - plain| <= 1e-4 + 1e-3 |plain| (the
    reference's kernel-vs-oracle tolerance: kernel and plain version chunk
    the sequence differently and the kernels' products run as 3xTF32 — the
    same sums, associated differently)."""
    return bool(((got - want).abs() <= 1e-4 + 1e-3 * want.abs()).all())


def phase_kernels(torch, captured, launches):
    import torch.nn.functional as F

    from repro_torch.kernels import (DESIGNS, HEAD_DIM_PAIRS, HEAD_DIMS,
                                     attention_ref, decode_attention,
                                     decode_attention_ref, decode_plan,
                                     flash_attention, ssd, ssd_chunked,
                                     ssd_plan, wkv6, wkv6_chunked, wkv6_plan)

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def rn(*shape, dt=torch.float32, scale=0.5):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dt)

    # -- attention feature sweep, kernel vs plain, bf16 and f32 ------------
    worst = {"decode_attention": 0.0, "flash_attention": 0.0}
    n_cases = 0
    splits = set()
    pairs = [(a, b) for a in HEAD_DIMS for b in HEAD_DIMS] + \
        list(HEAD_DIM_PAIRS)
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[str(dt).split(".")[-1]]
        for (B, H, Kv, Dk, Dv, T, pos, win, kvl, causal, alibi) in [
            (8, 32, 8, 64, 64, 192, [5, 40, 77, 191, 0, 100, 150, 63],
             None, None, True, False),
            (2, 4, 2, 16, 16, 96, [90, 50], 4, None, True, False),
            (2, 4, 2, 16, 16, 96, [90, 50], 24, None, True, True),
            (3, 4, 2, 16, 16, 40, [0, 0, 0], None, [5, 17, 40], False,
             False),
            (1, 8, 1, 24, 16, 200, [63], None, None, True, False),
            (2, 4, 2, 128, 128, 65, [64, 64], None, None, True, False),
            (2, 4, 2, 128, 64, 300, [299, 10], 100, None, True, True),
            (2, 8, 2, 64, 32, 129, [128, 128], None, None, True, False),
            (3, 4, 4, 224, 224, 90, [89, 0, 41], None, None, True, False),
            # split-KV edges: a long cache with rows at split and tile
            # edges; a window across splits; kv_len leaving most splits
            # empty (one row fully masked); a window beyond kv_len (no
            # reachable key); G = 1 at D = 224; B * Kv >= 264 (one split)
            (5, 32, 8, 64, 64, 4096, [0, 63, 64, 2047, 4095], None, None,
             True, False),
            (2, 32, 8, 64, 64, 4096, [3000, 1100], 1500, None, True, False),
            (3, 8, 4, 64, 64, 4096, [0, 0, 0], None, [100, 5, 0], False,
             False),
            (2, 8, 2, 64, 64, 512, [300, 40], 50, [200, 512], True, False),
            (2, 4, 4, 224, 224, 1024, [1023, 517], None, None, True, False),
            (33, 16, 8, 64, 64, 100, list(range(0, 99, 3)), None, None,
             True, False),
        ]:
            q = rn(B, 1, H, Dk, dt=dt)
            k, v = rn(B, T, Kv, Dk, dt=dt), rn(B, T, Kv, Dv, dt=dt)
            p = torch.tensor(pos, device=dev)
            sl = torch.linspace(0.05, 0.5, H, device=dev) if alibi else None
            kl = torch.tensor(kvl, device=dev) if kvl else None
            kw = dict(window=win, slopes=sl, kv_len=kl, causal=causal)
            got = decode_attention(q, k, v, p, **kw)
            e = _err(got, decode_attention_ref(q, k, v, p, **kw))
            torch.cuda.synchronize()
            if kvl and 0 in kvl and not bool((got[kvl.index(0)] == 0).all()):
                raise RuntimeError("K1: a fully masked row is not zero")
            splits.add(decode_plan(B, Kv, T, Dk, Dv, q.element_size())[1])
            if not e <= tol:
                raise RuntimeError(f"K1 {dt} {(B, H, Kv, Dk, Dv, T)} "
                                   f"win {win} err {e} > {tol}")
            worst["decode_attention"] = max(worst["decode_attention"], e)
            n_cases += 1
        for (B, S, Skv, H, Kv, Dk, Dv, win, q_start, causal, alibi) in [
            (8, 128, 128, 32, 8, 64, 64, None, 0, True, False),
            (2, 100, 100, 4, 2, 16, 16, None, 0, True, False),
            (2, 80, 80, 2, 2, 16, 16, 24, 0, True, True),
            (1, 96, 96, 2, 2, 16, 16, 4, 0, True, False),
            (2, 16, 48, 4, 2, 16, 16, None, 32, True, False),
            (2, 7, 19, 4, 2, 32, 16, None, 0, False, False),
            (1, 130, 130, 4, 2, 128, 128, None, 0, True, False),
            (1, 70, 200, 4, 1, 64, 128, 50, 130, True, True),
            (2, 64, 192, 32, 8, 64, 64, None, 128, True, False),
            (2, 70, 70, 4, 4, 224, 224, None, 0, True, False),
            (2, 100, 300, 4, 2, 64, 64, None, 0, False, False),
            (1, 200, 200, 8, 2, 128, 128, 70, 0, True, True),
        ] + [(2, 70, 70, 4, 2, a, b, None, 0, True, False)
             for a, b in pairs]:
            q = rn(B, S, H, Dk, dt=dt)
            k, v = rn(B, Skv, Kv, Dk, dt=dt), rn(B, Skv, Kv, Dv, dt=dt)
            sl = torch.linspace(0.05, 0.5, H, device=dev) if alibi else None
            kw = dict(causal=causal, window=win, slopes=sl, q_start=q_start)
            e = _err(flash_attention(q, k, v, **kw),
                     attention_ref(q, k, v, **kw))
            torch.cuda.synchronize()
            if not e <= tol:
                raise RuntimeError(f"K2 {dt} {(B, S, Skv, H, Kv, Dk, Dv)} "
                                   f"win {win} q_start {q_start} err {e} > "
                                   f"{tol}")
            worst["flash_attention"] = max(worst["flash_attention"], e)
            n_cases += 1
    # the 16-byte copies need aligned rows: a view one element off raises
    off = rn(2, 64, 2, 72, dt=torch.bfloat16)[..., 1:65]
    for name, call in (("K1", lambda: decode_attention(
            rn(2, 1, 4, 64, dt=torch.bfloat16), off, off,
            torch.tensor([3, 5], device=dev))),
                       ("K2", lambda: flash_attention(off, off, off))):
        try:
            call()
        except ValueError:
            continue
        raise RuntimeError(f"{name} took a misaligned bf16 view")
    log(f"[kernels] attention sweep: {n_cases} cases within tolerance "
        f"(bf16 {TOL['bfloat16']}, f32 {TOL['float32']} abs), head dims up "
        f"to 224, K2 at all {len(pairs)} (Dk, Dv) pairs; K1 split-kv with "
        f"n_split in {sorted(splits)}; K2 designs {DESIGNS[torch.bfloat16]} "
        f"(bf16), {DESIGNS[torch.float32]} (f32); misaligned bf16 views "
        f"raise ValueError; worst {worst}")

    # -- scan sweep (K3 WKV6, K4 SSD), kernel vs plain, f32 ----------------
    def wkv_args(B, S, H, hd, state, deep=False):
        lw = torch.clamp(-torch.exp(rn(B, S, H, hd, scale=1.0) * 0.5 - 1),
                         -5.0, -1e-4)
        if deep:  # decays down to lw = -60 on some channels, -1e-4 on others
            lw = -60.0 * torch.rand(B, S, H, hd, generator=gen, device=dev)
            lw[..., :8], lw[..., 8:16] = -60.0, -1e-4
        return (rn(B, S, H, hd, scale=0.4), rn(B, S, H, hd, scale=0.4),
                rn(B, S, H, hd, scale=0.4), lw, rn(H, hd, scale=0.3)) + \
            ((rn(B, H, hd, hd, scale=0.3),) if state else ())

    def ssd_args(B, S, H, p, n, state):
        dt = torch.rand(B, S, H, generator=gen, device=dev) * 0.5 + 0.1
        A = -torch.rand(H, generator=gen, device=dev) - 0.2
        return (rn(B, S, H, p, scale=0.4), rn(B, S, n, scale=0.4),
                rn(B, S, n, scale=0.4), dt, A, rn(H, scale=1.0)) + \
            ((rn(B, H, p, n, scale=0.3),) if state else ())

    def pad_zeros(args, n_seq):
        """The call with 7 zero tokens appended to its sequence operands."""
        return tuple(torch.cat([a, torch.zeros_like(a[:, :7])], 1)
                     if i < n_seq else a for i, a in enumerate(args))

    Qw, Qs = wkv6_plan(1, 1, 1, 64).chunk, ssd_plan(1, 1, 1, 64, 64).chunk
    scan_worst = {"wkv6": 0.0, "ssd": 0.0}
    n_cases = 0
    for kind, fn, plain, n_seq, cases in [
        ("wkv6", wkv6, wkv6_chunked, 4,
         [wkv_args(2, 37, 64, 64, False),   # S not a multiple of a chunk
          wkv_args(4, 1, 64, 64, True),     # one token, carried state
          wkv_args(2, 130, 8, 64, True),
          wkv_args(1, 50, 4, 128, False),
          wkv_args(3, 21, 4, 16, True),
          # the chunk edges Q - 1, Q, Q + 1, 4Q + 3 (parallel chunks), the
          # same walked by a block per (row, head), deep decays
          wkv_args(2, Qw - 1, 8, 64, True), wkv_args(2, Qw, 8, 64, False),
          wkv_args(2, Qw + 1, 8, 32, True),
          wkv_args(1, 4 * Qw + 3, 8, 64, True),
          wkv_args(5, 4 * Qw + 3, 64, 64, True),
          wkv_args(2, 130, 8, 64, True, deep=True),
          wkv_args(8, 115, 64, 64, False, deep=True)]),
        ("ssd", ssd, ssd_chunked, 4,
         [ssd_args(2, 45, 112, 64, 64, False),
          ssd_args(4, 1, 112, 64, 64, True),
          ssd_args(2, 300, 8, 64, 64, True),  # more than one plain chunk
          ssd_args(1, 40, 4, 32, 128, False),
          ssd_args(3, 21, 4, 16, 16, True),
          ssd_args(2, Qs - 1, 8, 64, 64, True),
          ssd_args(2, Qs, 8, 64, 64, False),
          ssd_args(2, Qs + 1, 8, 32, 128, True),
          ssd_args(1, 4 * Qs + 3, 112, 64, 64, True),
          ssd_args(1, 4 * Qs + 3, 18, 16, 16, False),
          ssd_args(2, 200, 4, 64, 32, True)]),
    ]:
        for args in cases:
            y, st = fn(*args)
            ry, rst = plain(*args)
            y2, st2 = fn(*args)
            _, st_pad = fn(*pad_zeros(args, n_seq))
            torch.cuda.synchronize()
            shape = f"{kind} {tuple(args[0].shape)} state " \
                f"{len(args) > (5 if kind == 'wkv6' else 6)}"
            if not (scan_ok(y, ry) and scan_ok(st, rst)):
                raise RuntimeError(f"{shape}: out err {_err(y, ry)}, state "
                                   f"err {_err(st, rst)}")
            if not (bool(torch.isfinite(y).all())
                    and bool(torch.isfinite(st).all())):
                raise RuntimeError(f"{shape}: not finite")
            if not (torch.equal(y, y2) and torch.equal(st, st2)):
                raise RuntimeError(f"{shape}: two calls differ")
            if not scan_ok(st_pad, st):
                raise RuntimeError(f"{shape}: trailing zero tokens moved "
                                   f"the state by {_err(st_pad, st)}")
            scan_worst[kind] = max(scan_worst[kind], _err(y, ry),
                                   _err(st, rst))
            n_cases += 1
    # the 16-byte copies need aligned rows: a view one element off raises
    off = rn(2, 20, 3, 65)[..., 1:]
    bc = rn(2, 20, 65)[..., 1:]
    for name, call in (
            ("K3", lambda: wkv6(off, off, off, off, rn(3, 64))),
            ("K4", lambda: ssd(off, bc, bc, rn(2, 20, 3).abs(), -rn(3).abs(),
                               rn(3)))):
        try:
            call()
        except ValueError:
            continue
        raise RuntimeError(f"{name} took a misaligned view")
    log(f"[kernels] scan sweep: {n_cases} cases within |kernel - plain| <= "
        f"1e-4 + 1e-3 |plain| (f32), chunks Q = {Qw} (K3) and {Qs} (K4), "
        f"finite at lw = -60, bit-identical on a second call, state "
        f"unchanged by trailing zero tokens; misaligned views raise "
        f"ValueError; worst abs {scan_worst}")

    # -- the paths' own inputs and one long shape: error + timing ----------
    def sdpa_decode(q, k, v, pos):
        T = k.shape[1]
        mask = (torch.arange(T, device=dev)[None, :]
                <= pos[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True).transpose(1, 2)

    def sdpa_prefill(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    def attention_rows(arch, suffix):
        (q, k, v, pos), kw = captured[(arch, "decode_attention")]
        if kw.get("window") is not None or kw.get("slopes") is not None:
            raise RuntimeError("unexpected masking features on the path")
        (qf, kf, vf), kwf = captured[(arch, "flash_attention")]
        q_start = kwf.get("q_start", 0)
        return [
            ("decode_attention" + suffix, "path", (q, k, v, pos),
             decode_attention, decode_attention_ref, sdpa_decode,
             decode_bound(q, k, v, pos), TOL["bfloat16"]),
            ("flash_attention" + suffix, "path", (qf, kf, vf),
             lambda *a: flash_attention(*a, q_start=q_start),
             lambda *a: attention_ref(*a, q_start=q_start),
             sdpa_prefill if q_start == 0 else None,
             prefill_bound(qf, kf, vf, q_start), TOL["bfloat16"]),
        ]

    Tl, Sl = 4096, 2048
    long_dec = (rn(8, 1, 32, 64, dt=torch.bfloat16),
                rn(8, Tl, 8, 64, dt=torch.bfloat16),
                rn(8, Tl, 8, 64, dt=torch.bfloat16),
                torch.full((8,), Tl - 1, device=dev, dtype=torch.long))
    long_pre = (rn(1, Sl, 32, 64, dt=torch.bfloat16),
                rn(1, Sl, 8, 64, dt=torch.bfloat16),
                rn(1, Sl, 8, 64, dt=torch.bfloat16))
    long_wkv = wkv_args(1, Sl, 64, 64, False)
    long_ssd = ssd_args(1, Sl, 112, 64, 64, False)
    plan = attention_rows("llama3_2_1b", "") + [
        ("decode_attention", f"long T={Tl}", long_dec, decode_attention,
         decode_attention_ref, sdpa_decode, decode_bound(*long_dec),
         TOL["bfloat16"]),
        ("flash_attention", f"long S={Sl}", long_pre, flash_attention,
         attention_ref, sdpa_prefill, prefill_bound(*long_pre),
         TOL["bfloat16"]),
    ] + attention_rows("zamba2_7b", "_d224")
    for kind, fn, plain, long_args in (("wkv6", wkv6, wkv6_chunked,
                                        long_wkv),
                                       ("ssd", ssd, ssd_chunked, long_ssd)):
        arch = "rwkv6_7b" if kind == "wkv6" else "zamba2_7b"
        path_args, _ = captured[(arch, kind)]
        for shape_name, args in (("path", path_args),
                                 (f"long S={Sl}", long_args)):
            plan.append((kind, shape_name, args,
                         lambda *a, fn=fn: fn(*a)[0],
                         lambda *a, plain=plain: plain(*a)[0], None,
                         scan_bound(kind, args), None))
    rows = {}
    for name, shape_name, args, kern, plain, lib, bound, tol in plan:
        got, want = kern(*args), plain(*args)
        err = _err(got, want)
        ok = err <= tol if tol is not None else scan_ok(got, want)
        lib_err = None if lib is None else _err(lib(*args), want)
        del got, want
        sets = copies(torch, list(args))
        ms = device_ms(torch, kern, sets)
        plain_ms = device_ms(torch, plain, sets, reps=10)
        lib_ms = None if lib is None else device_ms(torch, lib, sets)
        del sets
        shapes = " ".join(f"{tuple(a.shape)}" for a in args[:3])
        design = ""
        if name.startswith("decode_attention"):
            B, T, Kv = args[1].shape[:3]
            tile, n_split, chunk = decode_plan(
                B, Kv, T, args[1].shape[-1], args[2].shape[-1],
                args[0].element_size())
            design = (f" [split-kv: n_split {n_split}, chunk {chunk}, tile "
                      f"{tile}]")
        elif name.startswith("flash_attention"):
            design = f" [{DESIGNS[args[0].dtype]}]"
        elif name == "wkv6":
            B, S, H, hd = args[0].shape
            plan = wkv6_plan(B, S, H, hd, n_sm)
            design = (f" [chunk Q={plan.chunk}, {plan.n_chunks} chunks, "
                      f"{'walked' if plan.walk else 'in parallel'}, "
                      f"{plan.launches} launch(es)/call]")
        elif name == "ssd":
            B, S, H, p = args[0].shape
            plan = ssd_plan(B, S, H, p, args[1].shape[-1], n_sm)
            design = (f" [chunk Q={plan.chunk}, {plan.n_chunks} chunks, "
                      f"{plan.heads_per_block} heads/block, "
                      f"{plan.launches} launch(es)/call]")
        log(f"[kernels] {name} @ {shape_name}{design} {shapes} "
            f"{args[0].dtype}: "
            f"max|kernel-plain| {err:.3g}, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} "
            f"(library err {lib_err}), bound {bound[0]:.4f} ms "
            f"({bound[1]})")
        if not ok:
            raise RuntimeError(f"{name} @ {shape_name}: err {err}")
        rows[(name, shape_name)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                        lib_ms=lib_ms, bound=bound)
    out = []
    csrc = "src/repro_torch/kernels/csrc/"
    for name, path, source, replaces in [
        ("decode_attention", "llama3_2_1b", "decode_attention.cu",
         "src/repro/kernels/decode_attention/decode_attention.py:111"),
        ("flash_attention", "llama3_2_1b", "flash_attention_sm90.cu",
         "src/repro/kernels/flash_attention/flash_attention.py:105"),
        ("decode_attention_d224", "zamba2_7b", "decode_attention.cu",
         "src/repro/kernels/decode_attention/decode_attention.py:111"),
        ("flash_attention_d224", "zamba2_7b", "flash_attention_sm90.cu",
         "src/repro/kernels/flash_attention/flash_attention.py:105"),
        ("wkv6", "rwkv6_7b", "wkv6.cu", "src/repro/kernels/wkv6/wkv6.py:70"),
        ("ssd", "zamba2_7b", "ssd.cu", "src/repro/kernels/ssd/ssd.py:76"),
    ]:
        r = rows[(name, "path")]
        out.append({"name": name, "route": "cuda", "source": csrc + source,
                    "replaces": replaces,
                    "launches": launches[path][name.replace("_d224", "")],
                    "max_abs_err": r["err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                    "bound_by": r["bound"][1], "library_ms": r["lib_ms"],
                    "path": path})
    return out


def phase_parity(torch):
    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import (ContinuousBatchingScheduler,
                                     GeoServingSystem)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama3_2_1b").replace(param_dtype="float32",
                                            act_dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    llm = C.LLMSpec("llama3.2-1b", 16, block_bytes=50.0,
                    cache_bytes_per_token=0.25)
    tau = (0.004, 0.004, 0.02, 0.02, 0.02)
    servers = [C.ServerSpec(j, 1200.0, t) for j, t in enumerate(tau)]
    rtt = np.array([[0.01, 0.01, 0.03, 0.03, 0.03]])
    problem = C.Problem(llm, servers, 1, rtt, 3 * rtt,
                        workload=C.Workload(64, 16))

    def mono(toks, n_new, backend="kernel"):
        t = torch.as_tensor(np.asarray(toks), device="cuda")[None]
        logits, caches = prefill(params, cfg, {"tokens": t},
                                 cache_len=len(toks) + n_new + 4,
                                 backend=backend)
        first = logits[0].clone()
        seq = [int(torch.argmax(logits[0]))]
        pos = len(toks)
        for _ in range(n_new - 1):
            lg, caches = decode_step(
                params, cfg, caches,
                torch.tensor([seq[-1]], device="cuda"), pos, backend=backend)
            seq.append(int(torch.argmax(lg[0])))
            pos += 1
        return seq, first

    rng = np.random.RandomState(3)
    system = GeoServingSystem(cfg, params, problem, algorithm="proposed",
                              R=2, max_new_tokens=16, max_sessions=8)
    sched = ContinuousBatchingScheduler(system, R=2)
    prompts = [rng.randint(2, cfg.vocab_size, n) for n in (24, 41, 60)]
    for rid, (t, p) in enumerate(zip(poisson_arrivals(3, 2.0, 2), prompts)):
        sched.submit(rid, p, float(t), n_new=12)
    served = sched.run()
    for s, p in zip(served, prompts):
        ref, _ = mono(p, 12)
        got = [int(x) for x in s.tokens[len(p):]]
        if got != ref:
            raise RuntimeError(f"f32 engine stream {got} != monolithic "
                               f"{ref}")
    log(f"[parity] f32: {len(served)} scheduler streams equal the "
        "monolithic prefill/decode_step streams (kernel attention)")

    toks = rng.randint(2, cfg.vocab_size, 37)
    ref, first_plain = mono(toks, 10, backend="plain")
    ref_k, _ = mono(toks, 10)
    if ref_k != ref:
        raise RuntimeError("monolithic streams differ between the kernel "
                           "and the plain attention")
    system = GeoServingSystem(cfg, params, problem, algorithm="proposed",
                              R=2, max_new_tokens=16, max_sessions=8)
    sid, logits = system.submit(toks)
    lg = logits[0]
    if not bool(torch.isfinite(lg).all()) or lg.shape != (cfg.padded_vocab,):
        raise RuntimeError(f"bad first-step logits {tuple(lg.shape)}")
    scale = first_plain.abs().max().item()
    d = (lg - first_plain).abs().max().item()
    # tolerance: the engine runs the prompt padded to its bucket through
    # the pooled step (8 rows) with the CUDA kernels; the monolithic oracle
    # runs it unpadded, one row, on the plain attention.  Both are f32
    # (TF32 off), but the GEMMs see other shapes and sum in other orders
    # across 16 layers: allow 1e-4 of the logit scale
    log(f"[parity] first-step logits vs monolithic plain-attention forward: "
        f"max|diff| {d:.3g} at logit scale {scale:.3g} (tolerance "
        f"{1e-4 * scale:.3g} = 1e-4 x scale)")
    if d > 1e-4 * scale:
        raise RuntimeError("first-step logits disagree")
    seq = [int(torch.argmax(lg))]
    victim = None
    for step in range(9):
        if step == 3:
            victim = system.sessions[sid].route.servers[0]
            system.kill_server(victim)
        lg = system.decode(sid, seq[-1])
        seq.append(int(torch.argmax(lg[0])))
    route = system.sessions[sid].route
    log(f"[parity] kill_server({victim}) after 3 decode steps: route now "
        f"{route.servers}, replays {system.round_stats['replays']}; stream "
        f"{'equal' if seq == ref else 'DIFFERENT'} to the monolithic one")
    if seq != ref or victim in route.servers:
        raise RuntimeError(f"failover stream {seq} != {ref}")


def phase_parity_family(torch, arch):
    """Reduced ``arch`` in f32 on the card: the engine on the kernels (the
    scan kernel in prefill, the attention kernels for zamba2) gives the
    greedy streams of the port's monolithic prefill/decode_step on the
    plain versions, through the scheduler and through a kill_server
    drill whose replay overwrites the recurrent state whole."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import (ContinuousBatchingScheduler,
                                     GeoServingSystem)

    cfg = get_reduced_config(arch)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    L = cfg.n_layers
    llm = C.LLMSpec("toy", L, block_bytes=100.0, cache_bytes_per_token=1.0)
    servers = [C.ServerSpec(j, mem_bytes=1000.0, tau=0.01 * (j + 1),
                            tau_prefill_base=0.002,
                            tau_prefill_per_token=0.0005) for j in range(4)]
    rtt = np.full((1, 4), 0.02)
    problem = C.Problem(llm, servers, 1, rtt, rtt * 3,
                        workload=C.Workload(4, 8))

    def mono(toks, n_new):
        t = torch.as_tensor(np.asarray(toks), device="cuda")[None]
        logits, caches = prefill(params, cfg, {"tokens": t},
                                 cache_len=len(toks) + n_new + 4,
                                 backend="plain")
        seq = [int(torch.argmax(logits[0]))]
        for i in range(n_new - 1):
            lg, caches = decode_step(
                params, cfg, caches, torch.tensor([seq[-1]], device="cuda"),
                len(toks) + i, backend="plain")
            seq.append(int(torch.argmax(lg[0])))
        return seq

    def build():
        return GeoServingSystem(cfg, params, problem, algorithm="proposed",
                                R=2, max_new_tokens=16, max_sessions=8)

    rng = np.random.RandomState(5)
    prompts = [rng.randint(2, cfg.vocab_size, n) for n in (9, 14, 9, 20)]
    sched = ContinuousBatchingScheduler(build(), R=2)
    for rid, (t, p) in enumerate(zip(poisson_arrivals(4, 4.0, 2), prompts)):
        sched.submit(rid, p, float(t), n_new=10)
    served = sched.run()
    for s, p in zip(served, prompts):
        got, ref = [int(x) for x in s.tokens[len(p):]], mono(p, 10)
        if got != ref:
            raise RuntimeError(f"{arch} f32 engine stream {got} != plain "
                               f"monolithic {ref}")
    system = build()
    toks = prompts[1]
    ref = mono(toks, 10)
    sid, logits = system.submit(toks)
    seq = [int(torch.argmax(logits[0]))]
    for step in range(9):
        if step == 3:
            victim = system.sessions[sid].route.servers[0]
            system.kill_server(victim)
        seq.append(int(torch.argmax(system.decode(sid, seq[-1])[0])))
    route = system.sessions[sid].route
    log(f"[parity {arch}] f32: {len(served)} scheduler streams equal the "
        f"plain monolithic streams; kill_server({victim}) after 3 decode "
        f"steps: route now {route.servers}, replays "
        f"{system.round_stats['replays']}; stream "
        f"{'equal' if seq == ref else 'DIFFERENT'}")
    if seq != ref or victim in route.servers:
        raise RuntimeError(f"{arch} failover stream {seq} != {ref}")


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    log(f"[device] {smi}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    phase_build()
    captured = {}
    launches = {arch: phase_serve(torch, arch, captured)
                for arch in PATH_KERNELS}
    kernels = phase_kernels(torch, captured, launches)
    phase_parity(torch)
    for arch in ("rwkv6_7b", "zamba2_7b"):
        phase_parity_family(torch, arch)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
