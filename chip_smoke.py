#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):

1. device  — the card's name and power limit; build the five CUDA kernel
             sources from ``src/repro_torch/kernels/csrc`` with nvcc for
             sm_90a (one nvcc per source, in parallel); the build seconds,
             ptxas registers and spills of each K1 / K2 / K3 / K4
             instantiation (a tensor-core K2 instantiation that spills
             fails the phase), and the TF32 tensor-core instructions
             (HMMA.1688.F32.TF32) in the scans' SASS.
   train   — (before the serve phases, on an empty card)
             ``python -m repro_torch.launch.train`` at full width and all
             16 layers of Llama-3.2-1B in f32 with TF32 off, AdamW with
             remat, 10 steps of (B 8, S 128), then one at (B 1, S 2048):
             the step time by CUDA events (median of steps 3-10),
             tokens/s, the peak memory, the step's flops by
             FlopCounterMode against the f32 bound; the loss must be
             finite and fall, and no step may make a host sync.  Every
             architecture reduced in f32: one step on the card == the
             step on the CPU (loss, each gradient leaf, the params).
             Checkpoint save / restore / resume on the card; K1-K4 raise
             on inputs that require grad (no backward); int8_allreduce on
             a one-rank NCCL group == gloo on the CPU, bit for bit.
   train group — the same model and shape over device groups (1, 2) and
             (2, 2) of slots on the card(s) present, the reference's
             training rules at the cell's shape (batch and embed_fsdp over
             data, heads / MLP / vocab over model), against the solo step
             from the same weights and batches: the first gradient leaf
             by leaf, the loss of each of 2 AdamW steps, every param after
             them, replicas bit-equal across slots, no host sync a step;
             step times, tokens/s, peak memory and one step's slot
             collectives by kind printed.
2. serve   — ten full-width models in bf16 (random weights from a seed),
             one after the other, each served through the port's
             GeoServingSystem + ContinuousBatchingScheduler on 5 virtual
             servers (CG-BP placement split over >= 2 of them, WS-RR
             routing), 8 Poisson requests of 32-128 prompt tokens and 32
             new tokens: Llama-3.2-1B (K1 decode and K2 flash attention),
             RWKV6-7B (K3 WKV6 in prefill), Zamba2-7B (K4 SSD in prefill,
             K2/K1 at head dim 224 in its shared attention), DeepSeek-V2
             cut to 4 layers (MLA: K2 at (192, 128) with Kv = H in
             prefill, K1 absorbed at G = 128 in head groups in decode; MoE
             160 experts top-6 + 2 shared, per-row capacity; the drop
             fraction is printed) and Gemma-3-4B at full depth with one
             more prompt of 1280 tokens (head dim 256; its local layers'
             window of 1024 masks in K2, on the prompt's second chunk at
             q_start 1024, and in K1), and SeamlessM4T-large-v2 at full
             width and all 48 blocks (24 encoder, 24 decoder; requests
             with 256 or 512 frames and one of 1000, prompts of 4-16
             tokens, max_enc_len 1024): K2 non-causal over the frames
             and in cross prefill, K1 cross decode with a per-row
             kv_len, the prefill groups keyed by (bucket, encoder
             length); and the dense stacks only these serves run:
             BLOOM-176B cut to 11 of 70 layers (the paper's model: MHA at
             112 heads with ALiBi in K1 and K2, LayerNorm with a bias, the
             GELU MLP), Qwen2.5-32B (QKV bias, K1 at G = 5), OLMo-1B (the
             non-parametric norm) and Chameleon-34B (QK-norm, G = 8) at
             full depth.  Every path's bf16 first-step logits beside an
             f32 twin on the plain versions, cast one layer at a time
             (ROADMAP C5): held within 2.5% of the f32 logit scale with
             the greedy token equal on the dense paths, printed on RWKV6,
             Zamba2 and DeepSeek-V2; the peak device memory of each phase
             without MoE held under DENSE_PEAK_GIB.  Each path's kernel
             counters are zeroed just before its run and read just after;
             each kernel must have run, and every decode round must make
             exactly one host sync.
   paged   — Llama-3.2-1B, DeepSeek-V2, SeamlessM4T and BLOOM again on paged
             pools (page size 16; MLA latents paged as one joint buffer;
             cross K/V row-resident), the same
             requests: K1 and K2 launched, the greedy streams equal the
             slab run's, one host sync in every decode round that neither
             preempts nor resumes; round walls and tokens/s beside the
             slab run's.
   oversub — the reference's oversubscription scenario at full width: one
             server hosting all 16 layers with memory for 2 worst-case
             sessions, 10 sessions, page size 2, 30 new tokens.  The slab
             layout must refuse part of the cohort; the paged layout must
             admit and complete all 10 with >= 1 preemption and resume,
             with the streams of an uncontended run.
   sampling — threefry keys, bits and uniforms equal on CUDA and CPU;
             Llama-3.2-1B serving greedy, temperature 0.7 and top-k 40
             sessions (and one near-uniform top-k 40 row, so that some
             draw leaves the argmax): the same seeds twice, fused and
             serial rounds give the same streams, the greedy sessions
             those of an all-greedy run, one host sync per fused round;
             the round tail's device time and host wall.
3. kernels — K1-K4 against their plain PyTorch versions on the card: a
             feature sweep (attention in bf16 and f32 up to head dim 576,
             K1's split-KV edges — long caches, windows across splits,
             empty splits, fully masked rows, one split — K1's head groups
             (MLA G = 128, G = 16 with ALiBi), K2 at every (Dk, Dv) pair
             of each dtype, misaligned bf16 views that must raise; the
             chunked scans in f32 with ragged S, S = 1, carried state, S at
             Q - 1, Q, Q + 1 and 4Q + 3 of each kernel's chunk Q, K3 decays
             down to lw = -60, walked and parallel chunks, bit-identical
             repeats, zero-pad state invariance and misaligned views that
             must raise), and the paths' own captured inputs and one long
             shape each (seamless: its cross decode, encoder and cross
             prefill calls), timed (kernel, plain, one PyTorch SDPA call where
             one exists, and the bound), with K1's head groups and split
             plan, the K2 design and the scans' chunk plan (Q, launches a
             call) that served each row.
4. parity  — Llama-3.2-1B in f32: engine greedy streams equal the
             monolithic prefill/decode_step streams; first-step logits
             agree with a monolithic forward on the plain attention; a
             kill_server drill leaves the stream unchanged.  Reduced
             RWKV6 and zamba2 in f32: the engine on the kernels gives the
             monolithic streams on the plain versions, through the
             scheduler and through a kill_server drill.  Reduced
             DeepSeek-V2 and Llama-4-Scout in f32: the engine on the
             kernels gives the engine-on-plain streams (scheduler and
             kill_server drill); the monolithic ones where nothing was
             dropped.  Reduced SeamlessM4T in f32 with routes of an
             encoder-only and a decoder hop: the engine on the kernels
             gives the plain monolithic streams, through the scheduler
             and through a kill_server drill of the decoder hop.
5. perf model — (a) on the full-width Llama-3.2-1B serve cluster in bf16,
             each server's τ from the H100 roofline of its pooled decode
             step (``calibrate_taus``; every row at max_seq_len - 1),
             printed beside the step's device time by CUDA events, paced
             by the host's launches and queued ahead of the device, and
             their ratios to the roofline; the step count on the card
             equals the CPU's for a reduced f32 system; the calibrated
             problem through CG-BP and the port's simulator.  (a') the
             same τ readings on the BLOOM-176B serve cluster (11 layers),
             beside the simulator's A100 profile τ (0.011 s, PETALS).
             (b) the
             reference's engine-vs-simulator cross-validation
             (benchmarks/engine_validation.py ``cross_validate``) with
             Llama-3.2-1B at full width, cut to 8 layers: R = 1, 4, 8,
             engine == simulator and == BENCH_engine.json's ``xval.R*``
             within 1e-12 relative, one host sync per decode round.  (c)
             ``torch_shortest_paths`` on the card == the numpy DP on the
             serve cluster and three seeded problems with waiting; the
             BPRR MILP == brute force on a toy problem.
6. groups  — device-group (TP/EP) servers, every slot named on the cards
             present (one card: all slots on it, the count of distinct
             cards printed).  (a) full-width Llama-3.2-1B in bf16 on the
             serve cluster with servers 0-2 as {solo, (1, 2), (2, 2)}
             against the all-solo run: K1 and K2 on every slot, 1 host
             sync a decode round, first-step greedy tokens equal and
             logits within 2.5% of the solo scale, equal whole streams
             and round walls printed.  (b) reduced Llama-3.2-1B /
             DeepSeek-V2 on (2, 4) (slots holding time shards of the
             cache: K1 partials merged over the row), Llama-4-Scout on
             (4, 2), and RWKV6, zamba2 and SeamlessM4T on (2, 4), in f32,
             fused/serial x slab/paged: streams, virtual clocks and
             round_stats == the card's solo runs, logits within the
             reference's LOGIT_TOL (zamba2: atol 1e-4).  (b') reduced
             Llama, DeepSeek-V2, zamba2 and SeamlessM4T paged (page 4) on
             (2, 2) with servers whose page arrays split over data: slot
             pool bytes == the reference layout's, cross-slot page reads
             and writes counted, streams == solo.  (c)
             full-width Llama-4-Scout cut to 13 layers, solo and then
             every server on a (4, 2) group (client embedding and head
             vocab-parallel), 12 new tokens a request: memory after each
             run, the MoE drop fraction, the bf16 first steps printed;
             the same at 2 layers in f32 with the first steps held.  (d) the hetero fleet of benchmarks/engine_validation.py
             (reduced Llama, 8 layers): == its all-solo twin, calibrated
             τ not constant at H100 rates, CG-BP placing differently on
             the calibrated problem.  (e)-(h) the block families at
             full width in bf16 on the serve cluster, each against its
             all-solo run: (e) RWKV6-7B, (f) Zamba2-7B, (g)
             SeamlessM4T-large-v2 on {solo, (1, 2), (2, 2)}, (h)
             DeepSeek-V2 at 4 layers with every server a (1, 2) group
             (half the latent's time axis a slot): 8/8 requests, 1 host
             sync a decode round, K3 / K4 / K1 / K2 / K1 partials + merge
             on every slot (the slots' launches adding up to the
             counters' totals), the per-slot pool bytes of the slab and
             paged layouts (paged == the reference layout's, held);
             first steps held to C5 (SeamlessM4T) or printed, then held
             in f32 (RWKV6, Zamba2 whole; DeepSeek-V2 at 2 layers) within
             GROUP_F32_BOUND.  Kernel rows at the slot shapes (K1 / K2,
             K1 partials and merge, K3 / K4 on head slices) join the
             kernels JSON.

7. dryrun  — the port's dry run (``launch.dryrun``) against the card:
             full-width Llama-3.2-1B in bf16 on a (2, 2) group of slots on
             the card at three cells cut to fit it (decode seq 4096 x
             batch 8; one row at seq 8192, whose cache time axis shards
             over data; prefill seq 2048 x batch 4), each counted first on
             a (2, 2) mesh of meta slots (slot loop and stand-in, equal):
             FlopCounterMode's flops of the card's call and slot 0's
             allocated argument bytes equal the meta prediction; the
             predicted live peak beside torch.cuda.max_memory_allocated
             and their ratio, and the count's seconds, printed; the
             group's logits held to the solo model's within C5_FRACTION,
             greedy equal; K1, K1 partials + merge and K2 launched and
             held against their plain versions (kernel rows
             ``*_slot2x2_dryrun``).

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

TOL = {"bfloat16": 2e-2, "float32": 1e-5}


def bf16_ulp_ok(got, want):
    """The enc-dec kernel rows' bound: |kernel - plain| <= 2e-2 + 2^-7
    |plain| per element, the bf16 tolerance plus one bf16 ulp of the
    element.  The seamless encoder's outputs, and so the cross attention's,
    reach 32-128, where one ulp is 0.25-0.5; every other bf16 row is held
    to the absolute 2e-2."""
    want = want.float()
    return bool(((got.float() - want).abs()
                 <= TOL["bfloat16"] + 2.0 ** -7 * want.abs()).all())


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
    return [clone_args(torch, tensors) for _ in range(n)]


# ---------------------------------------------------------------------------
# kernel bounds (least time for the same work: bytes or operations)
# ---------------------------------------------------------------------------


def kernel_bound(cost, dtype):
    """(ms, "bytes" or "operations"): the least time of a kernel call's
    ``cost`` (its wrapper's ``*_cost``: each input read once, each output
    written once; the work these inputs need) on the H100's published
    peaks (``launch.costs``), its flops at the rate of ``dtype``."""
    from repro_torch.launch.costs import bound_ms

    return bound_ms(cost, str(dtype).split(".")[-1])


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
        if name == "flash_attention_sm90" and spills:
            raise RuntimeError("a tensor-core K2 instantiation spills to "
                               "local memory")
    for name in runtime.KERNEL_SOURCES:
        if not runtime.library_path(name).exists():
            raise RuntimeError(f"kernel library {name} was not built")


def poisson_arrivals(n, rate, seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    return np.cumsum(rng.exponential(1.0 / rate, n))


def serve_problem(C, name, n_layers):
    """examples/geo_serve.py's 5-server cluster with memory scaled by depth
    (x L/16 from 8 layers up), so CG-BP covers every block with the stack
    split over at least two servers and 8 rows per server.  A stack cut
    below 8 layers (DeepSeek-V2 at 4) would fit whole on every server at
    x 1, and at x L/16 leave blocks uncovered: it takes 0.3 of the memory
    and half the cache bytes per token, where CG-BP places [0,3) [1,4)
    [0,1) [3,4) [1,2) with >= 8 rows on each server."""
    import numpy as np

    scale, cache = n_layers / 16, 0.25
    if n_layers < 8:
        scale, cache = 0.3, 0.125
    llm = C.LLMSpec(name, n_layers, block_bytes=50.0,
                    cache_bytes_per_token=cache)
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
    "deepseek_v2_236b": ("decode_attention", "flash_attention"),
    "gemma3_4b": ("decode_attention", "flash_attention"),
    "seamless_m4t_large_v2": ("decode_attention", "flash_attention"),
    "bloom_176b": ("decode_attention", "flash_attention"),
    "qwen2_5_32b": ("decode_attention", "flash_attention"),
    "olmo_1b": ("decode_attention", "flash_attention"),
    "chameleon_34b": ("decode_attention", "flash_attention"),
}
# served configurations cut in depth, and the extra prompt of a serve.
# DeepSeek-V2's 60 layers of ~6.24 B params each do not fit the card: 4
# of them and the embedding and head take ~52 GB.  That count holds 256
# expert slots a layer, the reference's EP layout (``moe.expert_alloc``
# pads 160 experts to 256); the published options' dropless layer holds
# the 160 unpadded (3.97 B a layer; bench/configs/deepseekv2-l8.json).
# A BLOOM-176B layer holds 2.466 B params (4.59 GiB in bf16) and
# its tied embedding 3.60 B (6.70 GiB); 11 layers are 30.72 B params, 57.2
# GiB.  The phase adds ~11.1 GiB to the params at its peak (the C5 twin's
# f32 layer, 9.19 GiB, and a 16384-column f32 slice of the head; 10 layers
# peaked at 63.7 GiB on an H100 80GB HBM3), so 11 layers reach ~68.4 GiB
# and 12 ~72.9, past DENSE_PEAK_GIB; 8 layers would leave CG-BP 7 rows on
# three servers.  Qwen2.5-32B (61.0 GiB) and Chameleon-34B (63.9 GiB)
# serve at full depth (phase peaks ~64 / ~68 GiB).
# gemma3's 1280 tokens reach past its 1024-token window, so the local
# layers mask in K2 (the prompt's second chunk, q_start 1024) and in K1
SERVE_DEPTH = {"deepseek_v2_236b": 4, "bloom_176b": 11}
LONG_PROMPT = {"gemma3_4b": 1280}
# gemma3 prefills in chunks of at most 1024 tokens (the buckets stop there)
PREFILL_CAP = {"gemma3_4b": 1024}
# the enc-dec serve: decoder caches of 256 positions, cross caches of 1024
# (max_enc_len); requests carry 256 or 512 frames (5 or 10 s of speech at
# 50 frames/s), and one more carries 1000 (20 s); prompts of 4-16 tokens
ENC_DEC_LENS = dict(max_seq_len=256, max_enc_len=1024)
ENC_LENS, LONG_FRAMES = (256, 512), 1000
# the peak device memory a serve phase of a stack without MoE may reach
# (init, warm-up, the scheduler run, the pooled-step timing and the C5
# twin), under the card's ~79 GiB
DENSE_PEAK_GIB = 72.0
# ROADMAP C5's bound on a first step's bf16 logits against an f32 twin:
# max|diff| within this fraction of the f32 logit scale, the greedy token
# equal.  Held by bf16_vs_f32 on the dense paths below; printed only on
# RWKV6 and Zamba2 (C2: f32 recurrences) and on DeepSeek-V2 (a bf16
# rounding that flips a routing choice moves logits past any bound)
C5_FRACTION = 0.025
C5_HELD = ("llama3_2_1b", "gemma3_4b", "seamless_m4t_large_v2",
           "bloom_176b", "qwen2_5_32b", "olmo_1b", "chameleon_34b")


def phase_serve(torch, arch, captured, layout="slab", slab=None):
    """Serve one full-width model in bf16 (random weights from a seed)
    through GeoServingSystem + ContinuousBatchingScheduler: 8 Poisson
    requests, prompts of 32-128 tokens (several distinct lengths), 32 new
    tokens each (gemma3: and one prompt of 1280 tokens; DeepSeek-V2 cut
    to 4 layers).  The path's kernel counters are zeroed just before the
    scheduler run and read just after; every kernel of the path must have
    launched, every decode round must make exactly one host sync, and every
    stream must be complete.  On the slab layout real calls of each kernel
    are kept for the kernel phase (``captured[(arch, name)]``).  The
    enc-dec stack (seamless) serves requests with frames (256 or 512, and
    one of 1000) and prompts of 4-16 tokens; its prefill groups, keyed by
    (bucket, encoder length), are printed, its attention calls are counted
    apart (causal self attention, non-causal encoder and cross prefill,
    cross decode with a per-row kv_len; each must have run).  On the slab
    layout the first-step logits in bf16 are read against an f32 twin on
    the plain versions (``bf16_vs_f32``; held on the C5_HELD paths), and
    the phase's peak device memory is held under DENSE_PEAK_GIB on stacks
    without MoE.
    ``layout="paged"`` serves the same requests on page-size-16 pools: the
    greedy streams must equal the slab run's (``slab``), and the one-sync
    rule holds in every round that preempts or resumes nothing.  Returns
    the launches, the streams and the round walls."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import blocks as blocks_mod
    from repro_torch.models import init_params
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.serving import (ContinuousBatchingScheduler,
                                     GeoServingSystem)
    from repro_torch.serving.kv_cache import default_prefill_buckets

    cfg = get_config(arch)
    if arch in SERVE_DEPTH:
        cfg = cfg.replace(n_layers=SERVE_DEPTH[arch])
    tag = f"[serve {arch}]" if layout == "slab" else f"[paged {arch}]"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers"
        + (f" (of {get_config(arch).n_layers})" if arch in SERVE_DEPTH
           else "")
        + f", d_model {cfg.d_model}, {n_params / 1e9:.2f} B params in "
        f"{cfg.param_dtype}; random init {time.perf_counter() - t0:.1f} s; "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
        f"(init peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB)")
    problem = serve_problem(C, cfg.name, cfg.n_layers)
    long_len = LONG_PROMPT.get(arch, 0)
    kw = {}
    if long_len:
        kw["max_seq_len"] = long_len + 64
    if arch in PREFILL_CAP:
        kw["prefill_buckets"] = default_prefill_buckets(PREFILL_CAP[arch])
    if cfg.is_enc_dec:
        kw.update(ENC_DEC_LENS)

    def build():
        return GeoServingSystem(cfg, params, problem, algorithm="proposed",
                                R=4, max_new_tokens=32, max_sessions=8,
                                cache_layout=layout,
                                page_size=16 if layout == "paged" else None,
                                **kw)

    # warm-up: one request through a throwaway engine (cuBLAS handles,
    # kernel libraries loaded); not part of the measured run
    warm = build()
    ws = ContinuousBatchingScheduler(warm, R=4)
    ws.submit(0, np.arange(2, 50), 0.0, n_new=4,
              frames=(np.zeros((64, cfg.frame_dim), np.float32)
                      if cfg.is_enc_dec else None))
    ws.run()
    del warm, ws

    system = build()
    caps = {j: srv.pool.n_rows for j, srv in system.servers.items()}
    spans = sorted((int(a), int(a + m)) for a, m in zip(system.placement.a,
                                                         system.placement.m)
                   if m > 0)
    log(f"{tag} placement a={system.placement.a.tolist()} "
        f"m={system.placement.m.tolist()}; rows per server {caps}; "
        f"max_seq_len {system.max_seq_len}"
        + (f", max_enc_len {system.max_enc_len}" if cfg.is_enc_dec else "")
        + f"; {layout} layout"
        + ("" if layout == "slab" else
           f", page size {system.page_size}, physical pages per server "
           f"{ {j: v.pool.pages.n_pages for j, v in system.servers.items()} }"
           ))
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
    swaps = {"prefill": [], "decode": []}  # preemptions + resumes a round
    rs = system.round_stats

    def timed(kind, fn):
        """Wall time of one round (ended by a synchronize) and the host
        syncs it made, counted by PyTorch's sync debug mode."""
        def run(*a, **kw):
            swapped = rs["preemptions"] + rs["resumes"]
            t = time.perf_counter()
            out, n = count_syncs(torch, fn, *a, **kw)
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t)
            syncs[kind].append(n)
            swaps[kind].append(rs["preemptions"] + rs["resumes"] - swapped)
            return out
        return run

    system.prefill_round = timed("prefill", system.prefill_round)
    system.decode_round = timed("decode", system.decode_round)
    groups = []  # (bucket, encoder length, members) of each prefill group

    def admitting(admit):
        def run(*a, **kw):
            n = len(system._prefill_groups)
            out = admit(*a, **kw)
            groups.extend((g.bucket, g.enc_len, len(g.members))
                          for g in system._prefill_groups[n:])
            return out
        return run

    system.try_admit_sessions = admitting(system.try_admit_sessions)

    # keep real calls of each kernel from the main path for the kernel
    # phase (slab layout); copies are taken only on those calls (no tensor
    # is read here: a host read would add a sync to the round).  Attention
    # calls are counted by kind: self (causal), cross (non-causal; K1 with
    # a per-row kv_len) and, for K2, enc (non-causal, inside an encoder
    # block — flagged by the block's wrapper, not told by shapes)
    real = {"decode_attention": attn_mod.decode_attention,
            "flash_attention": attn_mod.flash_attention,
            "wkv6": ssm_mod.wkv6, "ssd": ssm_mod.ssd,
            "apply_moe": moe_mod.apply_moe,
            "encoder_block_full_group": blocks_mod.encoder_block_full_group}
    keep = layout == "slab"
    calls = {"decode_attention_self": 0, "decode_attention_cross": 0,
             "flash_attention_self": 0, "flash_attention_enc": 0,
             "flash_attention_cross": 0}
    in_encoder = [False]
    windowed = []  # the last windowed decode calls (gemma3's local layers)

    def keep_decode(q, ck, cv, pos, **kw):
        kind = "self" if kw.get("causal", True) else "cross"
        calls["decode_attention_" + kind] += 1
        if kind == "cross" and keep:
            # the round where the 1000-frame session is 16 tokens in
            long = next((x for x in system.sessions.values()
                         if x.enc_len == LONG_FRAMES), None)
            if long is not None and long.n_generated == 16:
                captured[(arch, "decode_attention_cross")] = (
                    clone_args(torch, (q, ck, cv, pos)), kw)
        elif keep and not cfg.is_enc_dec and \
                calls["decode_attention_self"] == 200:
            captured[(arch, "decode_attention")] = (
                clone_args(torch, (q, ck, cv, pos)), kw)
        # gemma3: the windowed calls of one decode round while the long
        # prompt's session is 16 tokens in (its row past the window)
        long = system.sessions.get(long_sid[0])
        if keep and long is not None and kw.get("window") is not None and \
                long.n_generated == 16:
            windowed.append((clone_args(torch, (q, ck, cv, pos)), kw))
            del windowed[:-4]
        return real["decode_attention"](q, ck, cv, pos, **kw)

    def keep_longest(name):
        def run(*args, **kw):
            key = (arch, name)
            if key not in captured or \
                    args[0].shape[1] > captured[key][0][0].shape[1]:
                captured[key] = (clone_args(torch, args), kw)
            return real[name](*args, **kw)
        return run

    def keep_flash(q, k, v, **kw):
        kind = "self" if kw.get("causal", True) else \
            "enc" if in_encoder[0] else "cross"
        calls["flash_attention_" + kind] += 1
        key = (arch, "flash_attention" if kind == "self"
               else "flash_attention_" + kind)
        if long_len:
            # gemma3: the long prompt's second chunk on a local layer
            # (window and q_start both in play)
            take = kw.get("q_start", 0) > 0 and \
                kw.get("window") is not None and key not in captured
        else:  # the call over the most keys (enc-dec: the non-causal ones)
            take = not (kind == "self" and cfg.is_enc_dec) and (
                key not in captured
                or k.shape[1] > captured[key][0][1].shape[1])
        if keep and take:
            captured[key] = (clone_args(torch, (q, k, v)), kw)
        return real["flash_attention"](q, k, v, **kw)

    def flag_encoder(*a, **kw):
        in_encoder[0] = True
        try:
            return real["encoder_block_full_group"](*a, **kw)
        finally:
            in_encoder[0] = False

    moe_count = {"prefill": [0, 0], "decode": [0, 0]}  # [dropped, routed]

    def count_moe(params_, cfg_, x, per_row=False, **kw):
        out, aux = real["apply_moe"](params_, cfg_, x, per_row=per_row,
                                     **kw)
        n = x.shape[1] * cfg_.moe_top_k  # (token, choice) pairs of a row
        c = moe_count["decode" if x.shape[1] == 1 else "prefill"]
        c[0] = c[0] + (aux["moe_drop_frac"] * n).sum()
        c[1] += n * (x.shape[0] if per_row else 1)
        return out, aux

    attn_mod.decode_attention = keep_decode
    attn_mod.flash_attention = keep_flash
    blocks_mod.encoder_block_full_group = flag_encoder
    if keep:
        ssm_mod.wkv6, ssm_mod.ssd = keep_longest("wkv6"), keep_longest("ssd")
    if cfg.is_moe:
        moe_mod.apply_moe = count_moe
    sched = ContinuousBatchingScheduler(system, R=4)
    rng = np.random.RandomState(0)
    arrivals = poisson_arrivals(8, rate=2.0, seed=1)
    lens = rng.randint(4, 17, 8) if cfg.is_enc_dec else \
        rng.randint(32, 129, 8)
    if cfg.family in ("ssm", "hybrid"):
        lens[1::3] = lens[0]  # equal lengths form exact-length groups
    prompts = [rng.randint(2, cfg.vocab_size, int(n)) for n in lens]
    if long_len:  # one long prompt, arriving with the first request
        arrivals = np.append(arrivals, arrivals[0])
        prompts.append(rng.randint(2, cfg.vocab_size, long_len))
    frames = [None] * len(prompts)
    if cfg.is_enc_dec:  # one 1000-frame request, with the first request
        enc_lens = [int(e) for e in rng.choice(ENC_LENS, 8)] + [LONG_FRAMES]
        arrivals = np.append(arrivals, arrivals[0])
        prompts.append(rng.randint(2, cfg.vocab_size, 12))
        frames = [rng.randn(e, cfg.frame_dim).astype(np.float32)
                  for e in enc_lens]
    lens = [len(p) for p in prompts]
    n_req = len(prompts)
    for rid, (t, p, f) in enumerate(zip(arrivals, prompts, frames)):
        sched.submit(rid, p, float(t), n_new=32, frames=f)
    long_sid = [None]
    if long_len:  # the engine session of the long prompt, once created
        system.create_session = tracking(system.create_session, long_len,
                                         long_sid)
    kern = {name: getattr(K, name) for name in PATH_KERNELS[arch]}
    for fn in kern.values():
        fn.launches = 0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()  # init, warm-up, build
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        served = sched.run()
        torch.cuda.synchronize()
    finally:
        attn_mod.decode_attention = real["decode_attention"]
        attn_mod.flash_attention = real["flash_attention"]
        ssm_mod.wkv6, ssm_mod.ssd = real["wkv6"], real["ssd"]
        moe_mod.apply_moe = real["apply_moe"]
        blocks_mod.encoder_block_full_group = \
            real["encoder_block_full_group"]
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kern.items()}
    if windowed:  # the captured call that reaches furthest past the window
        captured[(arch, "decode_attention")] = max(
            windowed, key=lambda c: int(c[0][3].max()))

    ok = [s for s in served if not s.dropped]
    n_gen = sum(len(s.tokens) - int(n) for s, n in zip(served, lens))
    log(f"{tag} served {len(ok)}/{n_req} requests, prompts "
        f"{sorted(lens)} tokens, {n_gen} generated tokens; device memory "
        f"peak in the run {torch.cuda.max_memory_allocated() / 2**30:.1f} "
        "GiB")
    for s in served:
        log(f"{tag}   req {s.rid}: arrival {s.arrival:.3f} start "
            f"{s.start:.3f} wait {s.wait:.4f} first-token "
            f"{s.first_token:.4f} per-token {s.per_token:.4f} (virtual s) "
            f"deferrals {s.n_deferrals}")
    log(f"{tag} kernel launches in the run: {launches}")
    if cfg.is_enc_dec:
        log(f"{tag} prefill groups (bucket, encoder length, sessions): "
            f"{groups}")
        log(f"{tag} attention calls by kind: {calls} (K1 self = causal "
            "decode, K1 cross = non-causal with a per-row kv_len; K2 self "
            "= causal decoder prefill, K2 enc = non-causal encoder, K2 "
            "cross = non-causal cross prefill)")
        if min(calls.values()) <= 0:
            raise RuntimeError(f"an enc-dec attention kind never ran: "
                               f"{calls}")
        if sum(calls[k] for k in calls if k.startswith("decode")) != \
                launches["decode_attention"] or \
                sum(calls[k] for k in calls if k.startswith("flash")) != \
                launches["flash_attention"]:
            raise RuntimeError("attention calls and kernel launches differ")
        launches.update(calls)
    if cfg.is_moe:
        fr = {k: (float(d) / r if r else 0.0) for k, (d, r) in
              moe_count.items()}
        log(f"{tag} MoE drop fraction over every (token, choice) pair the "
            f"pooled rows routed (padding and idle rows included): prefill "
            f"{fr['prefill']:.4f} of {moe_count['prefill'][1]}, decode "
            f"{fr['decode']:.4f} of {moe_count['decode'][1]} (per-row "
            "capacity; a decode row keeps all its choices)")
        if fr["decode"] != 0.0:
            raise RuntimeError("a decode row dropped a routed choice")
    log(f"{tag} round_stats {system.round_stats}")
    record = {"launches": launches,
              "streams": [list(map(int, s.tokens)) for s in served],
              "tok_s": n_gen / wall,
              "step_ms": pooled_step_ms(torch, system)}
    # server 0, or on the enc-dec stack the server hosting the most
    # decoder blocks (an encoder block does no decode work)
    j = step_server(system)
    srv = system.servers[j]
    n_dec = sum(k != "enc" for k in srv.kinds)
    beside = "" if slab is None else \
        f" (slab: {slab['step_ms']:.3f} ms)"
    log(f"{tag} one pooled decode step of server {j} ({n_dec} decoding "
        f"layers, all {srv.pool.n_rows} rows at position 120"
        + (f", encoder length {STEP_ENC_LEN}" if cfg.is_enc_dec else "")
        + f"), host wall ended by a synchronize: "
        f"{record['step_ms']:.3f} ms{beside}")
    for kind, w in walls.items():
        if w:
            record[kind + "_ms"] = 1e3 * sum(w) / len(w)
            beside = "" if slab is None or kind + "_ms" not in slab else \
                f" (slab run: mean {slab[kind + '_ms']:.2f} ms)"
            log(f"{tag} {kind} rounds: {len(w)}, wall per round mean "
                f"{record[kind + '_ms']:.2f} ms{beside}, median "
                f"{1e3 * sorted(w)[len(w) // 2]:.2f} ms, max "
                f"{1e3 * max(w):.2f} ms; host syncs per round "
                f"{min(syncs[kind])}..{max(syncs[kind])}")
    beside = "" if slab is None else f" (slab run: {slab['tok_s']:.1f})"
    log(f"{tag} run wall {wall:.3f} s, {n_gen / wall:.1f} generated "
        f"tokens/s{beside} (host clock around the whole scheduler run)")
    swapped = [(n, x) for n, x in zip(syncs["decode"], swaps["decode"]) if x]
    if swapped:
        log(f"{tag} decode rounds that preempted or resumed: "
            f"{len(swapped)}, host syncs in them "
            f"{sorted(n for n, _ in swapped)}")
    if len(ok) != n_req:
        raise RuntimeError(f"served {len(ok)}/{n_req}")
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
    plain_rounds = {n for n, x in zip(syncs["decode"], swaps["decode"])
                    if not x}
    if plain_rounds != {1}:
        raise RuntimeError(f"decode rounds made {sorted(plain_rounds)} host "
                           "syncs; the token readback is the only one")
    if long_len and layout == "slab" and not windowed:
        raise RuntimeError("no windowed decode call ran beside the long "
                           "prompt")
    if layout == "slab":
        record["c5"] = bf16_vs_f32(torch, cfg, params, prompts[-1],
                                   frames[-1] if cfg.is_enc_dec else None,
                                   held=arch in C5_HELD)
    peak = max(peak, torch.cuda.max_memory_allocated()) / 2**30
    log(f"{tag} peak device memory of the phase {peak:.1f} GiB (init, "
        "warm-up, run, pooled-step timing"
        + (", C5 twin" if layout == "slab" else "")
        + ("); MoE: not held" if cfg.is_moe else
           f"; bound {DENSE_PEAK_GIB} GiB)"))
    if not cfg.is_moe and peak > DENSE_PEAK_GIB:
        raise RuntimeError(f"{tag} peaked at {peak:.1f} GiB")
    if slab is not None:
        same = sum(a == b for a, b in zip(record["streams"], slab["streams"]))
        log(f"{tag} greedy streams equal to the slab run's: {same}/{n_req}")
        if same != n_req:
            raise RuntimeError("paged streams differ from the slab streams")
    # the engine's wrapped round methods close over it (a reference
    # cycle): collect it, so the model is gone before the next one loads.
    # ``srv`` holds the server's param views: drop it too, or the whole
    # model stays allocated until the phase returns
    del system, sched, params, srv
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{tag} freed: device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    return record


def bf16_vs_f32(torch, cfg, params, toks, frames, held):
    """ROADMAP C5 on a served path: the monolithic first-step logits of one
    request in bf16 on the kernels against the same weights in f32 on the
    plain versions (TF32 off).  The f32 twin casts one layer at a time
    (``upcast_prefill_logits``: each layer's leaves cast as it runs, the
    embedding rows gathered and then cast, the LM head cast 16384
    vocabulary columns at a time), so no f32 copy of the model exists.
    On Llama-3.2-1B the twin is held against ``prefill`` on the whole tree
    cast up front: equal bit for bit with its LM head cast whole, within
    1e-6 of the logit scale with the head in chunks.  Prints the max
    absolute and relative differences and whether the greedy tokens
    agree.  ``held``: a dense path, whose relative difference must be
    within C5_FRACTION with the greedy token equal; elsewhere the reading
    is printed.  Fails on non-finite logits.  ``frames``: the request's
    frames, or None for a decoder-only stack.  Returns the numbers."""
    from repro_torch.models import prefill, upcast_prefill_logits
    from repro_torch.models.model import tree_map

    batch = {"tokens": torch.as_tensor(toks, device="cuda")[None]}
    if frames is not None:
        batch["frames"] = torch.as_tensor(frames, device="cuda")[None]
    lb = prefill(params, cfg, batch)[0][0].float()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lf = upcast_prefill_logits(params, cfg, batch)[0]
        if cfg.name == "llama3.2-1b":
            whole = prefill(tree_map(lambda x: x.float(), params),
                            cfg.replace(param_dtype="float32",
                                        act_dtype="float32"),
                            batch, backend="plain")[0][0]
            same = torch.equal(upcast_prefill_logits(
                params, cfg, batch, vocab_chunk=None)[0], whole)
            apart = (lf - whole).abs().max().item()
            log(f"[c5 {cfg.name}] the f32 twin one layer at a time against "
                f"the whole tree cast up front: equal bit for bit with the "
                f"head whole {same}; max|diff| {apart:.3g} with the head in "
                f"chunks (bound 1e-6 x the scale "
                f"{whole.abs().max().item():.4g})")
            if not same or apart > 1e-6 * whole.abs().max().item():
                raise RuntimeError("the layer-by-layer f32 twin is not the "
                                   "whole-tree upcast's function")
            del whole
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()
    live = slice(0, cfg.vocab_size)  # padded columns hold -1e30 in both
    d = (lb[live] - lf[live]).abs().max().item()
    scale = lf[live].abs().max().item()
    out = {"max_abs": d, "max_rel": d / scale, "logit_scale": scale,
           "greedy_equal": int(lb.argmax()) == int(lf.argmax()),
           "finite": bool(torch.isfinite(lb).all())}
    log(f"[c5 {cfg.name}] first-step logits of the {len(toks)}-token"
        + ("" if frames is None else f", {len(frames)}-frame")
        + f" request, {cfg.n_layers} blocks at d_model "
        f"{cfg.d_model}: bf16 on the kernels vs f32 on the plain versions "
        f"(same weights): max|diff| "
        f"{d:.4g} at logit scale {scale:.4g} (relative {d / scale:.3g}); "
        f"greedy token {'equal' if out['greedy_equal'] else 'DIFFERENT'} "
        f"({int(lb.argmax())} vs {int(lf.argmax())}); "
        + (f"held to {C5_FRACTION}" if held else "printed, not held"))
    if not out["finite"]:
        raise RuntimeError("non-finite bf16 logits")
    if held and not (out["max_rel"] <= C5_FRACTION and out["greedy_equal"]):
        raise RuntimeError(f"[c5 {cfg.name}] bf16 first step {d / scale:.4g} "
                           f"of the f32 scale (bound {C5_FRACTION}), greedy "
                           f"token equal {out['greedy_equal']}")
    return out


def tracking(create, length, box):
    """``create_session`` that records in ``box[0]`` the sid of the session
    whose prompt has ``length`` tokens."""
    def create_tracked(tokens, *a, **kw):
        sid = create(tokens, *a, **kw)
        if len(tokens) == length:
            box[0] = sid
        return sid
    return create_tracked


def clone_args(torch, args):
    """Clones of a kernel call's tensor arguments.  Values that are a
    column view of the keys' buffer (absorbed MLA decode: the latent
    columns of the joint cache) stay a view of the cloned keys, so the
    kernel reads the captured call's exact layout."""
    out = [a.clone() if torch.is_tensor(a) else a for a in args]
    if len(args) > 2 and torch.is_tensor(args[2]) and \
            args[2].data_ptr() == args[1].data_ptr() and \
            args[2].stride() == args[1].stride():
        out[2] = out[1][..., :args[2].shape[-1]]
    return out


STEP_ENC_LEN = 512


def step_server(system) -> int:
    """The server whose pooled step ``pooled_step_ms`` times: 0, or the
    one hosting the most decoder blocks of an enc-dec stack."""
    if not system._is_enc_dec:
        return 0
    return max(system.servers, key=lambda j: sum(
        k == "dec" for k in system.servers[j].kinds))


def step_inputs(system, srv, pos):
    """Operands of one pooled decode step on ``srv`` with every row active
    at position ``pos`` (enc-dec: encoder length ``STEP_ENC_LEN``)."""
    import numpy as np

    from repro_torch.serving.kv_cache import to_device

    N = srv.pool.n_rows
    h = system._embed(np.full((N, 1), 5))
    pos = to_device(np.full((N,), pos, np.int64), system.device)
    mask = srv._mask(np.ones((srv.m, N), bool))
    emb0 = h if system._needs_emb0 else None
    encl = to_device(np.full((N,), STEP_ENC_LEN, np.int64), system.device) \
        if system._is_enc_dec else None
    return h, pos, mask, emb0, encl


def pooled_step_ms(torch, system, reps=20):
    """Host wall of one pooled decode step on ``step_server`` with every
    row active at position 120 (enc-dec: encoder length 512; each step
    ended by a synchronize): the cost of a step on the layout, apart from
    the routes the scheduler chose."""
    srv = system.servers[step_server(system)]
    args = step_inputs(system, srv, 120)
    for _ in range(3):
        srv.decode_rows(*args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        srv.decode_rows(*args)
        torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def scan_ok(got, want):
    """K3/K4 tolerance, f32: |kernel - plain| <= 1e-4 + 1e-3 |plain| (the
    reference's kernel-vs-oracle tolerance: kernel and plain version chunk
    the sequence differently and the kernels' products run as 3xTF32 — the
    same sums, associated differently)."""
    return bool(((got - want).abs() <= 1e-4 + 1e-3 * want.abs()).all())


def phase_kernels(torch, captured, launches):
    import torch.nn.functional as F

    from repro_torch.kernels import (DESIGNS, HEAD_DIM_PAIRS,
                                     HEAD_DIM_PAIRS_F32, HEAD_DIMS,
                                     attention_ref, decode_attention,
                                     decode_attention_cost,
                                     decode_attention_ref, decode_plan,
                                     flash_attention, flash_attention_cost,
                                     head_group, ssd, ssd_chunked, ssd_cost,
                                     ssd_plan, wkv6, wkv6_chunked, wkv6_cost,
                                     wkv6_plan)

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
    square = [(a, b) for a in HEAD_DIMS for b in HEAD_DIMS]
    pair_sets = {torch.bfloat16: square + list(HEAD_DIM_PAIRS),
                 torch.float32: square + list(HEAD_DIM_PAIRS_F32)}
    for dt in (torch.float32, torch.bfloat16):
        pairs = pair_sets[dt]
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
            # cross decode at G = 1 over a max_enc_len cache of 1024
            (4, 16, 16, 64, 64, 1024, [3, 0, 17, 5], None,
             [1, 256, 1000, 1024], False, False),
            (2, 8, 2, 64, 64, 512, [300, 40], 50, [200, 512], True, False),
            (2, 4, 4, 224, 224, 1024, [1023, 517], None, None, True, False),
            (33, 16, 8, 64, 64, 100, list(range(0, 99, 3)), None, None,
             True, False),
            # head groups: absorbed MLA (one kv head, G = 128 as 32 groups
            # of 4; reduced G = 4 at 40/32); G = 16 as 2 groups of 8 with
            # ALiBi; gemma3's D = 256 with window 1024 past T = 1024
            (3, 128, 1, 576, 512, 300, [299, 17, 128], None, None, True,
             False),
            (2, 4, 1, 40, 32, 70, [69, 33], None, None, True, False),
            (2, 16, 1, 64, 64, 130, [129, 40], 50, None, True, True),
            (2, 8, 4, 256, 256, 1344, [1300, 600], 1024, None, True, False),
            # BLOOM's MHA with ALiBi: G = 1 over 8 x 112 (row, kv-head)
            # pairs at D = 128 (one split)
            (8, 112, 112, 128, 128, 192, [191, 0, 64, 100, 150, 17, 120, 77],
             None, None, True, True),
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
            g = head_group(H // Kv, Dv)
            splits.add(decode_plan(B * (H // Kv // g), Kv, T, Dk, Dv,
                                   q.element_size())[1])
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
            # BLOOM's MHA with ALiBi at 112 heads, and a chunk at q_start 64
            (2, 128, 128, 112, 112, 128, 128, None, 0, True, True),
            (1, 64, 128, 112, 112, 128, 128, None, 64, True, True),
            # the enc-dec shapes: non-causal over 1000 frames (no multiple
            # of a tile), cross prefill of 8 and 13 queries
            (2, 1000, 1000, 16, 16, 64, 64, None, 0, False, False),
            (2, 8, 1000, 16, 16, 64, 64, None, 0, False, False),
            (2, 13, 77, 16, 16, 64, 64, None, 0, False, False),
            # gemma3's long prompt: its second chunk at q_start 1024 with
            # window 1024 (bf16 only: f32 has no 256 instantiation)
        ] + ([(1, 320, 1344, 8, 4, 256, 256, 1024, 1024, True, False),
              (2, 100, 100, 8, 8, 192, 128, None, 0, True, False)]
             if dt == torch.bfloat16 else
             [(2, 37, 37, 4, 4, 24, 16, None, 0, True, False)]) + [
            (2, 70, 70, 4, 2, a, b, None, 0, True, False)
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
    def sdpa_decode(q, k, v, pos, window=None, scale=None):
        T = k.shape[1]
        diff = pos[:, None] - torch.arange(T, device=dev)[None, :]
        ok = diff >= 0
        if window is not None:
            ok = ok & (diff < window)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=ok[:, None, None, :], scale=scale,
            enable_gqa=True).transpose(1, 2)

    def alibi_bias(slopes, q_pos, T, dtype):
        """ALiBi as SDPA's float ``attn_mask`` (rows, H, S, T) in the
        query dtype: slope x -|q - k| on the causally valid keys, -inf
        elsewhere; ``q_pos`` (rows, S)."""
        diff = q_pos[..., None] - torch.arange(T, device=dev)
        bias = slopes[:, None, None] * -diff.abs()[:, None].float()
        return torch.where(diff[:, None] >= 0, bias,
                           float("-inf")).to(dtype)

    def sdpa_biased(bias):
        """One SDPA call with a float mask built once, outside the timed
        call (a server would keep it for the round)."""
        def run(q, k, v, *_):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=bias, enable_gqa=True).transpose(1, 2)
        return run

    def sdpa_prefill(q, k, v, q_start=0, window=None):
        if not q_start and window is None:
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True).transpose(1, 2)
        diff = (q_start + torch.arange(q.shape[1], device=dev))[:, None] \
            - torch.arange(k.shape[1], device=dev)[None, :]
        ok = (diff >= 0) & (diff < (window or k.shape[1] + q.shape[1]))
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=ok, enable_gqa=True).transpose(1, 2)

    def attention_rows(arch, suffix):
        """The path's captured K1 and K2 calls, with their own masking
        (window, q_start, ALiBi slopes) and scale.  With slopes, SDPA takes
        the ALiBi bias as a float mask."""
        (q, k, v, pos), kw = captured[(arch, "decode_attention")]
        if kw.get("kv_len") is not None:
            raise RuntimeError("unexpected masking features on the path")
        win, scale, sl = kw.get("window"), kw.get("scale"), kw.get("slopes")
        (qf, kf, vf), kwf = captured[(arch, "flash_attention")]
        q_start, fwin = kwf.get("q_start", 0), kwf.get("window")
        fsl = kwf.get("slopes")
        if (sl is None) != (fsl is None) or \
                (sl is not None and (win is not None or fwin is not None)):
            raise RuntimeError("unexpected masking features on the path")
        dec_lib = (lambda *a: sdpa_decode(*a, window=win, scale=scale)) \
            if sl is None else sdpa_biased(alibi_bias(
                sl, pos[:, None], k.shape[1], q.dtype))
        pre_lib = (lambda *a: sdpa_prefill(*a, q_start=q_start,
                                            window=fwin)) \
            if fsl is None else sdpa_biased(alibi_bias(
                fsl, q_start + torch.arange(qf.shape[1], device=dev)[None],
                kf.shape[1], qf.dtype))
        return [
            ("decode_attention" + suffix, "path", (q, k, v, pos),
             lambda *a: decode_attention(*a, window=win, scale=scale,
                                         slopes=sl),
             lambda *a: decode_attention_ref(*a, window=win, scale=scale,
                                             slopes=sl),
             dec_lib,
             kernel_bound(decode_attention_cost(q, k, v, pos, window=win,
                                                slopes=sl),
                          q.dtype), TOL["bfloat16"]),
            ("flash_attention" + suffix, "path", (qf, kf, vf),
             lambda *a: flash_attention(*a, q_start=q_start, window=fwin,
                                        slopes=fsl),
             lambda *a: attention_ref(*a, q_start=q_start, window=fwin,
                                      slopes=fsl),
             pre_lib,
             kernel_bound(flash_attention_cost(qf, kf, vf, q_start, fwin,
                                               slopes=fsl),
                          qf.dtype), TOL["bfloat16"]),
        ]

    def sdpa_cross_decode(q, k, v, pos, kv_len):
        ok = torch.arange(k.shape[1], device=dev)[None, :] < kv_len[:, None]
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=ok[:, None, None, :], enable_gqa=True).transpose(1, 2)

    def sdpa_noncausal(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            enable_gqa=True).transpose(1, 2)

    def encdec_rows(arch):
        """The enc-dec path's non-causal calls: K1 cross decode over the
        max_enc_len cache with its per-row kv_len, K2 over the longest
        encoder input, K2 cross prefill of a prompt chunk over it."""
        (q, k, v, pos), kw = captured[(arch, "decode_attention_cross")]
        kvl = kw["kv_len"]
        if kw.get("causal", True) or kw.get("window") is not None:
            raise RuntimeError("the cross decode call is not non-causal")
        rows = [("decode_attention_cross", "path", (q, k, v, pos, kvl),
                 lambda q, k, v, p, n: decode_attention(
                     q, k, v, p, kv_len=n, causal=False),
                 lambda q, k, v, p, n: decode_attention_ref(
                     q, k, v, p, kv_len=n, causal=False),
                 sdpa_cross_decode,
                 kernel_bound(decode_attention_cost(
                     q, k, v, pos, kv_len=kvl, causal=False), q.dtype),
                 bf16_ulp_ok)]
        for name in ("flash_attention_enc", "flash_attention_cross"):
            args, kw = captured[(arch, name)]
            if kw.get("causal", True):
                raise RuntimeError(f"{name}: the call is not non-causal")
            rows.append((name, "path", tuple(args),
                         lambda *a: flash_attention(*a, causal=False),
                         lambda *a: attention_ref(*a, causal=False),
                         sdpa_noncausal,
                         kernel_bound(flash_attention_cost(
                             *args, causal=False), args[0].dtype),
                         bf16_ulp_ok))
        return rows

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
         decode_attention_ref, sdpa_decode,
         kernel_bound(decode_attention_cost(*long_dec), torch.bfloat16),
         TOL["bfloat16"]),
        ("flash_attention", f"long S={Sl}", long_pre, flash_attention,
         attention_ref, sdpa_prefill,
         kernel_bound(flash_attention_cost(*long_pre), torch.bfloat16),
         TOL["bfloat16"]),
    ] + attention_rows("zamba2_7b", "_d224") + \
        attention_rows("deepseek_v2_236b", "_mla") + \
        attention_rows("gemma3_4b", "_d256") + \
        encdec_rows("seamless_m4t_large_v2") + \
        attention_rows("bloom_176b", "_alibi") + \
        attention_rows("qwen2_5_32b", "_g5")[:1]
    for kind, fn, plain, cost, long_args in (
            ("wkv6", wkv6, wkv6_chunked, wkv6_cost, long_wkv),
            ("ssd", ssd, ssd_chunked, ssd_cost, long_ssd)):
        arch = "rwkv6_7b" if kind == "wkv6" else "zamba2_7b"
        path_args, _ = captured[(arch, kind)]
        for shape_name, args in (("path", path_args),
                                 (f"long S={Sl}", long_args)):
            plan.append((kind, shape_name, args,
                         lambda *a, fn=fn: fn(*a)[0],
                         lambda *a, plain=plain: plain(*a)[0], None,
                         kernel_bound(cost(*args), "tfloat32"), None))
    rows = {}
    for name, shape_name, args, kern, plain, lib, bound, tol in plan:
        got, want = kern(*args), plain(*args)
        err = _err(got, want)
        scale = want.float().abs().max().item()
        if tol is None:
            ok, tol_s = scan_ok(got, want), "scan"
        elif callable(tol):
            ok, tol_s = tol(got, want), "2e-2 + 2^-7 |plain| per element"
        else:
            ok, tol_s = err <= tol, f"{tol:.3g}"
        lib_err = None
        if lib is not None:
            try:
                lib_err = _err(lib(*args), want)
            except RuntimeError as e:  # no SDPA backend takes the shape
                log(f"[kernels] {name} @ {shape_name}: SDPA refused the "
                    f"call ({str(e).splitlines()[0][:100]}); library_ms null")
                lib = None
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
            G, Dv = args[0].shape[2] // Kv, args[2].shape[-1]
            g = head_group(G, Dv)
            tile, n_split, chunk = decode_plan(
                B * (G // g), Kv, T, args[1].shape[-1], Dv,
                args[0].element_size())
            design = (f" [split-kv: {G // g} head group(s) of {g}, n_split "
                      f"{n_split}, chunk {chunk}, tile {tile}; "
                      f"{1 if n_split == 1 else 2} CUDA launch(es)/call]")
            if name == "decode_attention_cross":
                design += f" kv_len {args[4].tolist()}"
        elif name.startswith("flash_attention"):
            design = f" [{DESIGNS[args[0].dtype]}; 1 CUDA launch/call]"
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
            f"max|kernel-plain| {err:.3g} (output scale {scale:.3g}, "
            f"tolerance {tol_s}), "
            f"kernel {ms:.4f} ms, plain "
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
        ("decode_attention_mla", "deepseek_v2_236b", "decode_attention.cu",
         "src/repro/kernels/decode_attention/decode_attention.py:111"),
        ("flash_attention_mla", "deepseek_v2_236b",
         "flash_attention_sm90.cu",
         "src/repro/kernels/flash_attention/flash_attention.py:105"),
        ("decode_attention_d256", "gemma3_4b", "decode_attention.cu",
         "src/repro/kernels/decode_attention/decode_attention.py:111"),
        ("flash_attention_d256", "gemma3_4b", "flash_attention_sm90.cu",
         "src/repro/kernels/flash_attention/flash_attention.py:105"),
        ("decode_attention_cross", "seamless_m4t_large_v2",
         "decode_attention.cu",
         "src/repro/kernels/decode_attention/decode_attention.py:111"),
        ("flash_attention_enc", "seamless_m4t_large_v2",
         "flash_attention_sm90.cu",
         "src/repro/kernels/flash_attention/flash_attention.py:105"),
        ("flash_attention_cross", "seamless_m4t_large_v2",
         "flash_attention_sm90.cu",
         "src/repro/kernels/flash_attention/flash_attention.py:105"),
        ("decode_attention_alibi", "bloom_176b", "decode_attention.cu",
         "src/repro/kernels/decode_attention/decode_attention.py:111"),
        ("flash_attention_alibi", "bloom_176b", "flash_attention_sm90.cu",
         "src/repro/kernels/flash_attention/flash_attention.py:105"),
        ("decode_attention_g5", "qwen2_5_32b", "decode_attention.cu",
         "src/repro/kernels/decode_attention/decode_attention.py:111"),
        ("wkv6", "rwkv6_7b", "wkv6.cu", "src/repro/kernels/wkv6/wkv6.py:70"),
        ("ssd", "zamba2_7b", "ssd.cu", "src/repro/kernels/ssd/ssd.py:76"),
    ]:
        r = rows[(name, "path")]
        base = next(k for k in ("decode_attention", "flash_attention",
                                "wkv6", "ssd") if name.startswith(k))
        out.append({"name": name, "route": "cuda", "source": csrc + source,
                    "replaces": replaces,
                    "launches": launches[path].get(name,
                                                   launches[path][base]),
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


def phase_parity_family(torch, arch, n_servers=4, mem=1000.0,
                        enc_lens=None, victim_hop=0):
    """Reduced ``arch`` in f32 on the card: the engine on the kernels (the
    scan kernel in prefill, the attention kernels for zamba2 and seamless)
    gives the greedy streams of the port's monolithic prefill/decode_step
    on the plain versions, through the scheduler and through a kill_server
    drill of the route's hop ``victim_hop``, whose replay rebuilds that
    hop's state (the recurrent state whole; seamless: self and cross K/V,
    the cross K/V from the session's encoder output).  ``enc_lens``: the
    four requests' encoder lengths (enc-dec stacks; frames from a seed,
    lengths that group apart), whose path must launch K1 and K2."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import (ContinuousBatchingScheduler,
                                     GeoServingSystem)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_reduced_config(arch)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    llm = C.LLMSpec("toy", cfg.n_layers, block_bytes=100.0,
                    cache_bytes_per_token=1.0)
    servers = [C.ServerSpec(j, mem_bytes=mem, tau=0.01 * (j + 1),
                            tau_prefill_base=0.002,
                            tau_prefill_per_token=0.0005)
               for j in range(n_servers)]
    rtt = np.full((1, n_servers), 0.02)
    problem = C.Problem(llm, servers, 1, rtt, rtt * 3,
                        workload=C.Workload(4, 8))

    def mono(toks, frames, n_new):
        batch = {"tokens": torch.as_tensor(np.asarray(toks),
                                           device="cuda")[None]}
        if frames is not None:
            batch["frames"] = torch.as_tensor(frames, device="cuda")[None]
        logits, caches = prefill(params, cfg, batch,
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
    jobs = []
    for i, n in enumerate((9, 14, 9, 20)):
        p = rng.randint(2, cfg.vocab_size, n)
        jobs.append((p, None if enc_lens is None else
                     rng.randn(enc_lens[i], cfg.frame_dim).astype(
                         np.float32)))
    n1, n2 = decode_attention.launches, flash_attention.launches
    sched = ContinuousBatchingScheduler(build(), R=2)
    for rid, (t, (p, f)) in enumerate(zip(poisson_arrivals(4, 4.0, 2),
                                          jobs)):
        sched.submit(rid, p, float(t), n_new=10, frames=f)
    served = sched.run()
    for s, (p, f) in zip(served, jobs):
        got, ref = [int(x) for x in s.tokens[len(p):]], mono(p, f, 10)
        if got != ref:
            raise RuntimeError(f"{arch} f32 engine stream {got} != plain "
                               f"monolithic {ref}")
    system = build()
    toks, frames = jobs[3]
    ref = mono(toks, frames, 10)
    sid, logits = system.submit(toks, frames=frames)
    route = system.sessions[sid].route
    seq = [int(torch.argmax(logits[0]))]
    for step in range(9):
        if step == 3:
            victim = system.sessions[sid].route.servers[victim_hop]
            system.kill_server(victim)
        seq.append(int(torch.argmax(system.decode(sid, seq[-1])[0])))
    k1, k2 = decode_attention.launches - n1, flash_attention.launches - n2
    new = system.sessions[sid].route
    log(f"[parity {arch}] f32 (K1 {k1}, K2 {k2} launches): {len(served)} "
        f"scheduler streams equal the plain monolithic streams; route "
        f"{route.servers} x {route.blocks}, kill_server({victim}) after 3 "
        f"decode steps: route now {new.servers} x {new.blocks}, replays "
        f"{system.round_stats['replays']}; stream "
        f"{'equal' if seq == ref else 'DIFFERENT'}")
    if seq != ref or victim in new.servers:
        raise RuntimeError(f"{arch} failover stream {seq} != {ref}")
    if enc_lens is not None and (min(k1, k2) <= 0 or
                                 system.round_stats["replays"] < 1):
        raise RuntimeError(f"{arch}: no replay, or an attention kernel did "
                           "not run")


def phase_parity_moe(torch, arch):
    """Reduced ``arch`` (MoE; DeepSeek-V2 with MLA) in f32 on the card:
    the engine on the kernels (K1 absorbed MLA decode at G = 4, 40/32 and
    K2 at (24, 16) for DeepSeek; GQA K1/K2 for Llama-4-Scout) gives the
    greedy streams of the same engine on the plain versions, through the
    scheduler and through a kill_server drill.  The engine's padded
    prefill buckets give each row its own MoE capacity, unlike a
    whole-prompt monolithic call, so the monolithic streams are required
    only when no routed choice was dropped."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving import (ContinuousBatchingScheduler,
                                     GeoServingSystem)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    rng = np.random.RandomState(5)
    prompts = [rng.randint(2, cfg.vocab_size, n) for n in (9, 14, 9, 20)]
    real_moe = moe_mod.apply_moe
    dropped = [0.0, 0]  # (token, choice) pairs dropped, routed

    def count_moe(p, c, x, per_row=False, **kw):
        out, aux = real_moe(p, c, x, per_row=per_row, **kw)
        n = x.shape[1] * c.moe_top_k * (1 if per_row else x.shape[0])
        dropped[0] += float((aux["moe_drop_frac"] * n).sum())
        dropped[1] += n * (x.shape[0] if per_row else 1)
        return out, aux

    def run(backend):
        system = GeoServingSystem(cfg, params, problem, algorithm="proposed",
                                  R=2, max_new_tokens=16, max_sessions=8,
                                  backend=backend)
        sched = ContinuousBatchingScheduler(system, R=2)
        for rid, (t, p) in enumerate(zip(poisson_arrivals(4, 4.0, 2),
                                         prompts)):
            sched.submit(rid, p, float(t), n_new=10)
        streams = [[int(x) for x in s.tokens] for s in sched.run()]
        system = GeoServingSystem(cfg, params, problem, algorithm="proposed",
                                  R=2, max_new_tokens=16, max_sessions=8,
                                  backend=backend)
        sid, logits = system.submit(prompts[1])
        seq = [int(torch.argmax(logits[0]))]
        victim = None
        for step in range(9):
            if step == 3:
                victim = system.sessions[sid].route.servers[0]
                system.kill_server(victim)
            seq.append(int(torch.argmax(system.decode(sid, seq[-1])[0])))
        if victim in system.sessions[sid].route.servers:
            raise RuntimeError(f"{arch}: the route still uses the killed "
                               "server")
        return streams, seq, victim, system.round_stats["replays"]

    n1, n2 = decode_attention.launches, flash_attention.launches
    moe_mod.apply_moe = count_moe
    try:
        kern = run("kernel")
        k1, k2 = decode_attention.launches - n1, flash_attention.launches - n2
        plain = run("plain")
    finally:
        moe_mod.apply_moe = real_moe
    log(f"[parity {arch}] f32: kernel engine (K1 {k1}, K2 {k2} launches) "
        f"vs plain engine: {sum(a == b for a, b in zip(kern[0], plain[0]))}"
        f"/{len(prompts)} scheduler streams equal; kill_server({kern[2]}) "
        f"after 3 decode steps, replays {kern[3]}: drill stream "
        f"{'equal' if kern[1] == plain[1] else 'DIFFERENT'}; MoE drop "
        f"fraction over the (token, choice) pairs of both runs' pool rows "
        f"{dropped[0] / max(dropped[1], 1):.4f}")
    if kern[:2] != plain[:2] or min(k1, k2) <= 0:
        raise RuntimeError(f"{arch}: the kernel engine differs from the "
                           "plain engine, or a kernel did not run")
    if dropped[0] == 0.0:
        for p, got in zip(prompts, kern[0]):
            t = torch.as_tensor(p, device="cuda")[None]
            logits, caches = prefill(params, cfg, {"tokens": t},
                                     cache_len=len(p) + 14, backend="plain")
            seq = [int(torch.argmax(logits[0]))]
            for i in range(9):
                lg, caches = decode_step(
                    params, cfg, caches,
                    torch.tensor([seq[-1]], device="cuda"), len(p) + i,
                    backend="plain")
                seq.append(int(torch.argmax(lg[0])))
            if got[len(p):] != seq:
                raise RuntimeError(f"{arch}: engine stream differs from the "
                                   "monolithic one with no drops")
        log(f"[parity {arch}] no routed choice dropped: the streams equal "
            "the plain monolithic prefill/decode_step streams")


def _llama_bf16(torch, tag):
    """Full-width Llama-3.2-1B in bf16, random weights from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config("llama3_2_1b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {cfg.param_dtype}, random weights")
    return cfg, params


def count_syncs(torch, fn, *a, **kw):
    """(result, host syncs made by ``fn``), by PyTorch's sync debug mode."""
    out, sites = sync_sites(torch, fn, *a, **kw)
    return out, len(sites)


def sync_sites(torch, fn, *a, **kw):
    """(result, the file:line of each host sync ``fn`` made), by PyTorch's
    sync debug mode (its one-time notice that the mode is a prototype,
    which mentions synchronizing operations too, is not a sync)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if "called a synchronizing" in str(w.message)]


# the launcher at full width in f32; --lr 3e-4 is the train step's own
# default (TrainHParams).  At the launcher's 1e-3 the loss of this init
# (a tied embedding at std 1: logits at std ~sqrt(2048)) swings upward over
# 10 steps (PERF.md §6, training)
TRAIN_ARGV = ["--arch", "llama3_2_1b", "--steps", "10", "--device", "cuda",
              "--dtype", "float32", "--lr", "3e-4"]
# a reduced card step vs the CPU step: gradients at max|d| <= atol + rtol
# max|cpu| a leaf; params at TRAIN_PARAM_ATOL beyond what AdamW's first
# update makes of the two gradients (``train_step_diff``).  zamba2
# (ROADMAP C2): its f32 gradients are ill-conditioned; at these weights
# the card's and the CPU's differ by 2.6e-3 of a leaf's scale, and each
# sits up to 1.9e-3 off a float64 evaluation (scripts/f64_grads.py)
TRAIN_LR = 5e-3
TRAIN_GRAD_TOL = {"zamba2_7b": (1e-4, 5e-3)}
TRAIN_PARAM_ATOL = {"zamba2_7b": 1e-4}
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"


def phase_train(torch):
    """[train] (1) ``python -m repro_torch.launch.train`` at full width and
    all 16 layers of Llama-3.2-1B in f32 (TF32 off), AdamW with remat, 10
    steps of (B 8, S 128), each step timed by CUDA events and run under
    sync debug mode; then one step at (B 1, S 2048) and one more at (B 8,
    S 128) under ``FlopCounterMode``.  Prints the median step time of steps
    3-10, tokens/s, the peak memory, the step's flops against the f32
    bound, and the memory before and after.  Fails on a non-finite loss,
    a loss after step 10 not below step 1's, or any host sync inside a
    step.  (2) For every architecture, reduced in f32: one step on the
    card == the same step on the CPU (loss rtol 1e-5, params atol 5e-5;
    zamba2 1e-4, ROADMAP C2).  (3) Checkpoints on the card (reduced
    llama): save, restore and resume give the same next step.  (4) K1-K4
    refuse inputs that require grad.  (5) ``int8_allreduce`` on a one-rank
    NCCL group == a gloo group on the CPU, bit for bit."""
    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.data import make_batches, shard_batch
    from repro_torch.launch import costs
    from repro_torch.launch import train as launch
    from repro_torch.training.optimizer import tree_leaves

    tag = "[train]"
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{tag} device memory at the start "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        torch.cuda.reset_peak_memory_stats()
        events, syncs = [], []

        def timed(step_fn, state, batch):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out, sites = sync_sites(torch, step_fn, state, batch)
            ev[1].record()
            events.append(ev)
            syncs.append(sites)
            return out

        t0 = time.perf_counter()
        run = launch.run(launch.parse_args(TRAIN_ARGV), step_hook=timed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        args = launch.parse_args(TRAIN_ARGV)
        cfg = run.cfg
        n_params = sum(x.numel() for x in tree_leaves(run.state["params"]))
        losses = [float(m["loss"]) for m in run.metrics]
        ms = [a.elapsed_time(b) for a, b in events]
        step_ms = float(np.median(ms[2:10]))
        tokens = args.batch * args.seq
        log(f"{tag} {cfg.name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {n_params / 1e9:.3f} B params in "
            f"{cfg.param_dtype}; AdamW, remat; B {args.batch} S {args.seq}; "
            f"{len(losses)} steps in {wall:.1f} s (first step included)")
        log(f"{tag} losses {[round(x, 4) for x in losses]}")
        log(f"{tag} step ms by CUDA events {[round(x, 2) for x in ms]}; "
            f"median of steps 3-10 {step_ms:.2f} ms, {tokens / step_ms * 1e3:.0f} "
            f"tokens/s; host syncs inside each step {[len(x) for x in syncs]}"
            f"; peak memory {peak / 2**30:.2f} GiB "
            f"({peak / 1e9:.2f} GB)")
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError("non-finite training loss")
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"loss after step 10 ({losses[-1]}) not below "
                               f"step 1's ({losses[0]})")
        if any(syncs):
            raise RuntimeError(f"host syncs inside a train step: {syncs}")

        # attention at length: one step at (B 1, S 2048)
        long = shard_batch(next(make_batches(cfg, 1, 2048, seed=0,
                                             start_step=10)), device="cuda")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.reset_peak_memory_stats()
        ev[0].record()
        state, m = run.step_fn(run.state, long)
        ev[1].record()
        torch.cuda.synchronize()
        long_loss = float(m["loss"])
        log(f"{tag} one step at B 1, S 2048: {ev[0].elapsed_time(ev[1]):.2f}"
            f" ms, loss {long_loss:.4f}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not math.isfinite(long_loss):
            raise RuntimeError("non-finite loss at S 2048")

        # the step's flops, counted over one real step
        batch = shard_batch(next(make_batches(cfg, args.batch, args.seq,
                                              seed=0, start_step=11)),
                            device="cuda")
        with FlopCounterMode(display=False) as counter:
            state, m = run.step_fn(state, batch)
        torch.cuda.synchronize()
        flops = counter.get_total_flops()
        dtype = ("tfloat32" if torch.backends.cuda.matmul.allow_tf32
                 else "float32")
        bound = flops / costs.PEAK_FLOPS[dtype] * 1e3
        n_layer = n_params - cfg.padded_vocab * cfg.d_model
        predicted = (6 * n_params + 2 * n_layer) * tokens
        log(f"{tag} step flops {flops / 1e12:.3f} TFLOP (FlopCounterMode; "
            f"6 N T + 2 N_layers T = {predicted / 1e12:.3f}); "
            f"torch.backends.cuda.matmul.allow_tf32 "
            f"{torch.backends.cuda.matmul.allow_tf32}: the GEMMs run in "
            f"{dtype} at {costs.PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s, "
            f"bound {bound:.2f} ms; median step {step_ms:.2f} ms = "
            f"{step_ms / bound:.2f}x the bound "
            f"({flops / step_ms / 1e9:.1f} TFLOP/s)")
        del run, state, m, batch, long
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{tag} freed: device memory "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

        train_card_vs_cpu(torch)
        train_checkpoint(torch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    grad_guard(torch)
    allreduce_nccl_vs_gloo(torch)


# [train group]: full-width Llama-3.2-1B in f32 on groups of slots of the
# card against the solo step, AdamW at the [train] phase's lr, the
# [train] phase's shape (B 8, S 128).  The rules are make_rules at that
# cell's shape: at train_4k's (256 x 4096) the remat stash crosses 8e9
# bytes and sets seq_act, which the slot step does not emulate.  Held: the
# first step's gradient, reduced over the slots and put back together,
# leaf by leaf within atol + rtol * max|solo leaf| (TRAIN_GROUP_GRAD_TOL,
# the CPU tests' bound); each step's loss within TRAIN_GROUP_LOSS_RTOL of
# the solo step's; every param leaf after TRAIN_GROUP_STEPS steps within
# atol + rtol * max|leaf| (TRAIN_GROUP_PARAM_TOL).  AdamW's update
# g / (|g| + eps) is sign-like: an element whose gradient is near zero
# carries a relative error near 1 (f32 sums in another order) and its
# update differs by up to ~lr / 4 a step; at this lr (3e-4) and leaf
# scale (~0.044 for the 2048-wide projections) two steps reach ~1% of the
# leaf's max (on an H100 80GB HBM3 at 700 W, attn.wv read 1.13x a 1e-3
# bound after two steps)
TRAIN_GROUP_SHAPES = ((1, 2), (2, 2))
TRAIN_GROUP_STEPS = 2
TRAIN_GROUP_LOSS_RTOL = 1e-5
TRAIN_GROUP_GRAD_TOL = (1e-5, 2e-4)
TRAIN_GROUP_PARAM_TOL = (1e-5, 1e-2)


def stash_bytes(fn):
    """``fn()`` with the training step's remat stash recorded: (its result,
    {slot: bytes}) — each slot's block inputs that the layers' checkpoints
    keep for the backward pass (``models.model._call``'s tensor list)."""
    from repro_torch.models import model as model_mod

    real, per = model_mod.checkpoint, {}

    def record(f, *args, **kw):
        for s, x in enumerate(args[3]):
            per[s] = per.get(s, 0) + x.numel() * x.element_size()
        return real(f, *args, **kw)

    model_mod.checkpoint = record
    try:
        return fn(), per
    finally:
        model_mod.checkpoint = real


def _worst_leaf(got, want, tol):
    """(the worst leaf's max|d| over atol + rtol max|want leaf|, its
    path) of (path, tensor) pairs ``got`` against ``want`` by path."""
    atol, rtol = tol
    worst, where = 0.0, None
    for path, x in got:
        w = want[path]
        ratio = float((x - w).abs().max()) / (
            atol + rtol * float(w.abs().max()))
        if ratio > worst:
            worst, where = ratio, ".".join(path)
    return worst, where


def phase_train_group(torch):
    """[train group] Full-width Llama-3.2-1B, all 16 layers, f32 (TF32
    off), AdamW with remat: TRAIN_GROUP_STEPS steps of (B 8, S 128) solo,
    then the same from the same weights and batches over each group of
    TRAIN_GROUP_SHAPES, every slot on the card(s) present
    (``make_train_step(..., sh=make_ctx(...))``: embed_fsdp and the batch
    over data, heads / MLP / vocab over model), twice: under the rules of
    a cell of the run's own (B 8, S 128), and under those of ``train_4k``,
    whose remat stash passes 8e9 bytes, so ``make_rules`` sets
    ``seq_act``: each slot then holds its sequence block of the residual
    stream.  Prints each run's step times by CUDA events, tokens/s, peak
    memory and, over one step, its slot collectives by kind (calls, wire
    bytes), and each slot's remat stash bytes; fails unless each step's
    loss is the solo step's within TRAIN_GROUP_LOSS_RTOL, the first
    step's gradient leaves are the solo gradient's within
    TRAIN_GROUP_GRAD_TOL, every param leaf after the last step is within
    TRAIN_GROUP_PARAM_TOL, the copies of every replicated block are
    bit-equal across slots, no step makes a host sync, and a ``seq_act``
    slot's stash is 1/M of the other run's."""
    import numpy as np

    from repro_torch.configs import SHAPES_BY_NAME, ShapeSpec, get_config
    from repro_torch.data import make_batches, shard_batch
    from repro_torch.launch.mesh import GroupMesh
    from repro_torch.launch.sharding import make_ctx
    from repro_torch.models import init_params, train_loss
    from repro_torch.models.layers import count_collectives
    from repro_torch.training import (TrainHParams, init_train_state,
                                      make_optimizer_for, make_train_step)
    from repro_torch.training.optimizer import (tree_items, tree_leaves,
                                                tree_map)
    from repro_torch.training.train_step import GroupLayout

    tag = "[train group]"
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    args = dict(zip(TRAIN_ARGV[::2], TRAIN_ARGV[1::2]))
    B, S, lr = 8, 128, float(args["--lr"])
    cfg = get_config("llama3_2_1b").replace(param_dtype="float32",
                                            act_dtype="float32")
    host = [next(make_batches(cfg, B, S, seed=0, start_step=i))
            for i in range(TRAIN_GROUP_STEPS)]
    hp = TrainHParams(learning_rate=lr)
    opt = make_optimizer_for(cfg, hp)
    cell = ShapeSpec("train_cell", S, B, "train")
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False

    def weights():
        return init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(0), "cuda")

    def drive(label, state, step, batches):
        torch.cuda.reset_peak_memory_stats()
        losses, ms, syncs, coll = [], [], [], None
        for i, batch in enumerate(batches):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            with count_collectives() as rec:
                ev[0].record()
                (state, m), sites = sync_sites(torch, step, state, batch)
                ev[1].record()
            torch.cuda.synchronize()
            losses.append(float(m["loss"]))
            ms.append(ev[0].elapsed_time(ev[1]))
            syncs.append(len(sites))
            coll = rec
        peak = torch.cuda.max_memory_allocated() / 2**30
        kinds = {k: round(v) for k, v in sorted(coll.by_kind.items())}
        log(f"{tag} {label}: losses {losses}; step ms by CUDA events "
            f"{[round(x, 2) for x in ms]} (last: {B * S / ms[-1] * 1e3:.0f} "
            f"tokens/s); peak memory {peak:.2f} GiB; host syncs inside each "
            f"step {syncs}; collectives of one step: {coll.calls} calls, "
            f"wire bytes {kinds} (all slots, {coll.wire:.4g} in all)")
        if any(syncs):
            raise RuntimeError(f"{tag} {label}: host syncs inside a step")
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"{tag} {label}: non-finite loss")
        return state, losses, (ms, peak, kinds)

    try:
        live = tree_map(lambda x: x.requires_grad_(True), weights())
        loss, _ = train_loss(live, cfg, shard_batch(host[0], device="cuda"))
        solo_grads = dict(zip([p for p, _ in tree_items(live)],
                              torch.autograd.grad(loss, tree_leaves(live))))
        del live, loss
        state = init_train_state(None, cfg, opt, params=weights(),
                                 device="cuda")
        n_params = sum(x.numel() for x in tree_leaves(state["params"]))
        log(f"{tag} {cfg.name}: {cfg.n_layers} layers, {n_params / 1e9:.3f}"
            f" B params in f32, AdamW lr {lr}, remat; B {B} S {S}, "
            f"{TRAIN_GROUP_STEPS} steps a run")
        state, solo_losses, _ = drive(
            "solo", state, make_train_step(cfg, opt, hp),
            [shard_batch(h, device="cuda") for h in host])
        solo = dict(tree_items(state["params"]))
        del state
        gc.collect()
        torch.cuda.empty_cache()
        runs = [(shape, rules) for shape in TRAIN_GROUP_SHAPES
                for rules in (cell, SHAPES_BY_NAME["train_4k"])]
        seen = {}
        for shape, rules in runs:
            devs = np.empty(shape[0] * shape[1], dtype=object)
            devs[:] = slot_devices(torch, devs.size)
            mesh = GroupMesh(devs.reshape(shape))
            sh = make_ctx(cfg, mesh, rules)
            lay = GroupLayout(cfg, sh)
            label = f"{shape} group, {rules.name} rules (seq_act " \
                f"{sh.rules['seq_act']})"
            batches = [shard_batch(h, mesh, sh, device="cuda") for h in host]
            (_, _, grads), stash = stash_bytes(lambda: lay.loss_and_grads(
                lay.shard(weights()), batches[0]))
            g_worst, g_leaf = _worst_leaf(
                tree_items(lay.unshard(lay.reduce_grads(grads))), solo_grads,
                TRAIN_GROUP_GRAD_TOL)
            del grads
            gc.collect()
            torch.cuda.empty_cache()
            state = init_train_state(None, cfg, opt, params=weights(),
                                     device="cuda", sh=sh)
            gc.collect()
            torch.cuda.empty_cache()
            state, losses, stats = drive(
                label, state, make_train_step(cfg, opt, hp, sh), batches)
            seen[(shape, rules.name)] = (stats, stash)
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                          solo_losses))
            worst, where = _worst_leaf(
                tree_items(lay.unshard(state["params"])), solo,
                TRAIN_GROUP_PARAM_TOL)
            flat = [tree_leaves(t) for t in state["params"]]
            copies = sum(1 for leaf in lay.leaves
                         for s, o in enumerate(leaf["owners"]) if o != s)
            equal = all(torch.equal(flat[s][k], flat[o][k])
                        for k, leaf in enumerate(lay.leaves)
                        for s, o in enumerate(leaf["owners"]) if o != s)
            log(f"{tag} {label} against solo: loss rel diff {rel:.3g}"
                f" (bound {TRAIN_GROUP_LOSS_RTOL}); first gradient: worst "
                f"leaf {g_leaf} at {g_worst:.3g} of its bound "
                f"{TRAIN_GROUP_GRAD_TOL} (atol, rtol max|leaf|); params "
                f"after {TRAIN_GROUP_STEPS} steps: worst leaf {where} at "
                f"{worst:.3g} of its bound {TRAIN_GROUP_PARAM_TOL}; "
                f"{copies} replicated block copies bit-equal across slots: "
                f"{equal}")
            if rel > TRAIN_GROUP_LOSS_RTOL or worst > 1.0 or g_worst > 1.0 \
                    or not equal:
                raise RuntimeError(f"{tag} {label}: the group step is not "
                                   "the solo step")
            del state, flat, batches
            gc.collect()
            torch.cuda.empty_cache()
            if rules.name != "train_4k":
                continue
            (ms0, peak0, kinds0), stash0 = seen[(shape, cell.name)]
            (ms1, peak1, kinds1), stash1 = seen[(shape, rules.name)]
            ratio = {s: stash1[s] / stash0[s] for s in stash0}
            log(f"{tag} {shape} seq_act beside without: step ms (last) "
                f"{ms1[-1]:.2f} vs {ms0[-1]:.2f}; peak memory {peak1:.2f} "
                f"vs {peak0:.2f} GiB; remat stash bytes per slot "
                f"{stash1} vs {stash0} (ratio {sorted(set(ratio.values()))}"
                f", expected 1/{shape[1]}); collectives of one step "
                f"{kinds1} vs {kinds0}")
            if sh.rules["seq_act"] != "model" or any(
                    abs(r * shape[1] - 1.0) > 1e-12 for r in ratio.values()):
                raise RuntimeError(f"{tag} {shape}: the seq_act stash is "
                                   f"not 1/{shape[1]} of the other run's")
        del solo, solo_grads
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{tag} phase {time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")


def _train_setup(cfg, device, params):
    from repro_torch.training import (TrainHParams, init_train_state,
                                      make_optimizer_for, make_train_step)

    hp = TrainHParams(learning_rate=TRAIN_LR)
    opt = make_optimizer_for(cfg, hp)
    return (init_train_state(None, cfg, opt, params=params, device=device),
            make_train_step(cfg, opt, hp))


def _adamw_first_update(g, norm):
    """AdamW's first update of a param with gradient ``g`` (bias-corrected
    m / sqrt(v) = g / |g|), the gradients clipped to the global norm 1 as
    the step clips them (``norm``: their norm), weight decay left out."""
    gc = g * min(1.0, 1.0 / max(norm, 1e-12))
    return TRAIN_LR * gc / (gc.abs() + 1e-8)


def train_step_diff(torch, arch):
    """One reduced f32 train step of ``arch`` on the card and on the CPU
    from the same weights and batch.  Returns (loss rel diff, worst grad
    leaf's max|d| over its bound, params beyond their bound, worst param
    max|d|, elements, param atol).  A param's bound is the atol plus 1.1x
    the difference AdamW's first update, lr g / (|g| + 1e-8), makes of the
    two gradients: where |g| nears eps that update turns f32 noise of the
    gradient into up to 2 lr (Adafactor: the atol alone)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.data import make_batches, shard_batch
    from repro_torch.models import init_params, train_loss
    from repro_torch.models.model import tree_map
    from repro_torch.training.optimizer import tree_leaves

    cfg = get_reduced_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    host = next(make_batches(cfg, 2, 32, seed=0))
    out = {}
    for dev in ("cpu", "cuda"):
        batch = shard_batch(host, device=dev)
        live = tree_map(lambda x: x.to(dev, copy=True).requires_grad_(True),
                        params)
        loss, _ = train_loss(live, cfg, batch)
        grads = torch.autograd.grad(loss, tree_leaves(live),
                                    allow_unused=True, materialize_grads=True)
        state, step = _train_setup(
            cfg, dev, tree_map(lambda x: x.to(dev, copy=True), params))
        state, metrics = step(state, batch)
        grads = [g.detach().cpu() for g in grads]
        norm = math.sqrt(sum(float((g * g).sum()) for g in grads))
        out[dev] = (float(metrics["loss"]), float(loss.detach()), grads,
                    [x.cpu() for x in tree_leaves(state["params"])], norm)
    (lc, lc0, gc, pc, nc), (lg, lg0, gg, pg, ng) = out["cpu"], out["cuda"]
    g_atol, g_rtol = TRAIN_GRAD_TOL.get(arch, (1e-5, 2e-4))
    atol = TRAIN_PARAM_ATOL.get(arch, 5e-5)
    g_worst = max(float((a - b).abs().max())
                  / (g_atol + g_rtol * float(b.abs().max()))
                  for a, b in zip(gg, gc) if b.numel())
    beyond = n = 0
    p_worst = 0.0
    for a, b, ga, gb in zip(pg, pc, gg, gc):
        d = (a - b).abs()
        bound = atol
        if cfg.optimizer == "adamw":
            bound = atol + 1.1 * (_adamw_first_update(ga, ng)
                                  - _adamw_first_update(gb, nc)).abs()
        beyond += int((d > bound).sum())
        p_worst = max(p_worst, float(d.max()))
        n += d.numel()
    rel = max(abs(lg - lc) / abs(lc), abs(lg0 - lc0) / abs(lc0))
    return rel, g_worst, beyond, p_worst, n, atol


def train_card_vs_cpu(torch):
    """For every architecture, reduced in f32: one train step on the card
    against the same step on the CPU (``train_step_diff``)."""
    from repro_torch.configs import ARCH_IDS, get_reduced_config

    for arch in ARCH_IDS:
        rel, g_worst, beyond, p_worst, n, atol = train_step_diff(torch, arch)
        log(f"[train {arch}] reduced f32 step, card vs CPU "
            f"({get_reduced_config(arch).optimizer}): loss rel diff "
            f"{rel:.2e} (bound 1e-5); worst grad leaf at {g_worst:.3f} of its"
            f" bound; params max|diff| {p_worst:.3g}, {beyond} of {n} beyond "
            f"atol {atol:g} + AdamW's first-update difference")
        if not (rel <= 1e-5 and g_worst <= 1.0 and beyond == 0):
            raise RuntimeError(f"{arch}: the card's train step differs from "
                               "the CPU's")


def train_checkpoint(torch):
    """Save, restore and resume on the card (reduced llama, f32): the
    restored state equals the saved one, and the next step from it equals
    the next step from the live state (atol 1e-7, the reference's resume
    bound in tests/test_training.py)."""
    import shutil

    from repro_torch.configs import get_reduced_config
    from repro_torch.data import make_batches, shard_batch
    from repro_torch.models import init_params
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import tree_leaves

    cfg = get_reduced_config("llama3_2_1b")
    state, step = _train_setup(cfg, "cuda", init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"))
    feed = make_batches(cfg, 2, 32, seed=2)
    b1, b2 = (shard_batch(next(feed), device="cuda") for _ in range(2))
    state, _ = step(state, b1)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        checkpoint.save(str(CKPT_DIR), 1, state)
        restored, n = checkpoint.restore(str(CKPT_DIR), state)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(state),
                                                  tree_leaves(restored)))
    resumed, _ = step(restored, b2)
    direct, _ = step(state, b2)
    err = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(direct),
                                                         tree_leaves(resumed)))
    log(f"[train ckpt] reduced llama on the card: restored step {n}, leaves "
        f"{'equal' if same else 'DIFFERENT'}; next step from the restored "
        f"state vs the live one: max|diff| {err:.3g} (bound 1e-7)")
    if n != 1 or not same or not err <= 1e-7:
        raise RuntimeError("checkpoint resume differs on the card")


def grad_guard(torch):
    """K1-K4 on CUDA inputs that require grad raise (no backward) and
    launch nothing."""
    from repro_torch import kernels as K

    g = torch.Generator(device="cuda").manual_seed(0)

    def t(*shape):
        return torch.randn(shape, generator=g, device="cuda") \
            .requires_grad_(True)

    calls = {
        "decode_attention": lambda: K.decode_attention(
            t(2, 1, 4, 16), t(2, 8, 2, 16), t(2, 8, 2, 16), 3),
        "flash_attention": lambda: K.flash_attention(
            t(2, 8, 4, 16), t(2, 8, 2, 16), t(2, 8, 2, 16)),
        "wkv6": lambda: K.wkv6(t(2, 8, 2, 64), t(2, 8, 2, 64),
                               t(2, 8, 2, 64), t(2, 8, 2, 64), t(2, 64)),
        "ssd": lambda: K.ssd(t(2, 8, 2, 64), t(2, 8, 64), t(2, 8, 64),
                             t(2, 8, 2), t(2), t(2)),
    }
    for name, call in calls.items():
        fn = getattr(K, name)
        before = fn.launches
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            log(f"[train guard] {name} on CUDA inputs requiring grad raises: "
                f"{str(e)[:60]}...")
        else:
            raise RuntimeError(f"{name} accepted inputs that require grad")
        if fn.launches != before:
            raise RuntimeError(f"{name} launched under autograd")


def allreduce_nccl_vs_gloo(torch):
    """``int8_allreduce`` on a one-rank NCCL group (the card) against the
    same call on a gloo group (the CPU): equal bit for bit."""
    import socket

    import torch.distributed as dist

    from repro_torch.training import int8_allreduce

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        gloo = dist.new_group([0], backend="gloo")
        x = torch.randn((61, 7, 8), generator=torch.Generator()
                        .manual_seed(0))
        card = int8_allreduce(x.cuda()).cpu()
        host = int8_allreduce(x, group=gloo)
    finally:
        dist.destroy_process_group()
    equal = torch.equal(card, host)
    log(f"[train allreduce] int8_allreduce on a one-rank NCCL group vs gloo "
        f"on the CPU, {tuple(x.shape)} f32: "
        f"{'bit-equal' if equal else 'DIFFERENT'} (max|x - out| "
        f"{float((card - x).abs().max()):.3g})")
    if not equal:
        raise RuntimeError("int8_allreduce differs between NCCL and gloo")


def phase_oversub(torch):
    """The reference's ``oversub`` scenario (benchmarks/engine_validation.py
    ``oversubscription_scenario``) at full width: one server hosting all
    16 layers of Llama-3.2-1B with cache memory for exactly 2 worst-case
    sessions, 10 sessions of 4 prompt tokens and 30 new tokens.  The slab
    layout must refuse part of the cohort; the paged layout (page size 2)
    must admit all 10 and complete them, preempting and resuming under
    page pressure, with the greedy streams of an uncontended run."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.serving import GeoServingSystem

    tag = "[oversub]"
    cfg, params = _llama_bf16(torch, tag)
    n_sessions, slab_cap, n_new, L = 10, 2, 30, cfg.n_layers
    lw = C.Workload(4, n_new)
    s_c = 0.5 * lw.total_tokens

    def problem(cap):
        llm = C.LLMSpec("paged", L, 50.0, cache_bytes_per_token=0.5)
        servers = [C.ServerSpec(0, 50.0 * L + s_c * cap * L, 0.004,
                                tau_prefill_base=0.002,
                                tau_prefill_per_token=0.0005)]
        rtt = np.array([[0.01]])
        return C.Problem(llm, servers, 1, rtt, 3 * rtt, workload=lw)

    def cohort(layout, cap, page_size=None):
        system = GeoServingSystem(
            cfg, params, problem(cap), algorithm="proposed", R=slab_cap,
            max_new_tokens=n_new, max_sessions=n_sessions,
            cache_layout=layout, page_size=page_size)
        rng = np.random.default_rng(0)
        sids = []
        for _ in range(n_sessions):
            route, _ = C.shortest_path_route(system.problem,
                                             system.alive_placement(), 0)
            sids.append(system.create_session(
                rng.integers(2, cfg.vocab_size, size=lw.l_in), 0, route,
                n_new))
        return system, sids, system.try_admit_sessions(sids)

    _, _, slab_admitted = cohort("slab", slab_cap)
    paged, sids, admitted = cohort("paged", slab_cap, page_size=2)
    pool = paged.servers[0].pool
    log(f"{tag} slab admitted {len(slab_admitted)}/{n_sessions}; paged "
        f"admitted {len(admitted)}/{n_sessions} (page size 2, "
        f"{pool.pages.n_pages} physical pages, {pool.cap_units} page-units)")
    if len(slab_admitted) >= n_sessions or len(admitted) != n_sessions:
        raise RuntimeError("the cohort must oversubscribe the slab budget "
                           "and fit the paged one")
    paged.drain_prefill()
    rounds, syncs, t0 = 0, [], time.perf_counter()
    while any(paged.sessions[s].n_generated < n_new for s in sids):
        rs = paged.round_stats
        before = rs["preemptions"] + rs["resumes"]
        _, n = count_syncs(torch, paged.decode_round)
        syncs.append((n, rs["preemptions"] + rs["resumes"] - before))
        rounds += 1
        if rounds > 2000:
            raise RuntimeError("the oversubscribed cohort did not converge")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = sum(paged.sessions[s].n_generated >= n_new for s in sids)
    rs = paged.round_stats
    swap = sorted(n for n, x in syncs if x)
    log(f"{tag} completed {done}/{n_sessions} in {rounds} decode rounds, "
        f"{wall:.2f} s; preemptions {rs['preemptions']}, resumes "
        f"{rs['resumes']}, replays {rs['replays']}; host syncs in the "
        f"{len(swap)} rounds that preempted or resumed: {swap}; in the "
        f"others {sorted({n for n, x in syncs if not x})}")
    if done != n_sessions or rs["preemptions"] < 1 or rs["resumes"] < 1:
        raise RuntimeError("paged oversub: not all completed, or no "
                           "preemption and resume")
    if {n for n, x in syncs if not x} != {1}:
        raise RuntimeError("a decode round without a swap made more than "
                           "the token readback's host sync")
    # the uncontended reference: the same cohort with memory for all 10
    big, big_sids, big_adm = cohort("slab", n_sessions)
    if len(big_adm) != n_sessions:
        raise RuntimeError("the uncontended run must admit everything")
    big.drain_prefill()
    while any(big.sessions[s].n_generated < n_new for s in big_sids):
        big.decode_round()
    same = sum(list(paged.sessions[a].tokens) == list(big.sessions[b].tokens)
               for a, b in zip(sids, big_sids))
    log(f"{tag} streams equal to an uncontended slab run: "
        f"{same}/{n_sessions}")
    if same != n_sessions:
        raise RuntimeError("preempted streams differ from the uncontended "
                           "ones")
    return {"slab_admitted": len(slab_admitted),
            "paged_admitted": len(admitted), "completed": done,
            "preemptions": rs["preemptions"], "resumes": rs["resumes"]}


def phase_sampling(torch, serve_arrivals):
    """Seeded sampling on the card.  threefry keys, bits and uniforms for
    seeds (0, 1, 2**31, 2**32-1) x token indices equal the CPU's; then
    full-width Llama-3.2-1B serves greedy, temperature (T 0.7) and top-k
    (k 40, T 0.7) sessions, and one hot top-k row (T 100), through the
    scheduler (at least one sampled stream must leave the greedy one, or
    the checks would not see the draws): the same seeds twice give
    the same streams, fused and serial rounds give the same streams, the
    greedy sessions' streams equal an all-greedy run's, and every fused
    decode round makes one host sync.  The round tail's time is printed."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.serving import (ContinuousBatchingScheduler,
                                     GeoServingSystem, SamplingSpec, prng)
    from repro_torch.serving.sampling import _key_for_row

    tag = "[sampling]"
    grid = [0, 1, 2 ** 31, 2 ** 32 - 1]
    seeds = torch.tensor(grid).repeat_interleave(len(grid))
    index = torch.tensor(grid).repeat(len(grid))
    keys = [_key_for_row(seeds.to(d), index.to(d)) for d in ("cpu", "cuda")]
    bits = [prng.random_bits(k, 128256).cpu() for k in keys]
    unif = [prng.uniform(k, 128256, prng.F32_TINY).cpu().view(torch.int32)
            for k in keys]
    ok = (torch.equal(keys[0], keys[1].cpu()) and torch.equal(*bits)
          and torch.equal(*unif))
    log(f"{tag} threefry keys, bits and uniforms for {len(seeds)} (seed, "
        f"index) rows x 128256: CUDA {'==' if ok else '!='} CPU")
    if not ok:
        raise RuntimeError("threefry differs between CUDA and the CPU")

    cfg, params = _llama_bf16(torch, tag)
    problem = serve_problem(C, cfg.name, cfg.n_layers)
    rng = np.random.RandomState(0)
    lens = rng.randint(32, 129, 8)
    prompts = [rng.randint(2, cfg.vocab_size, int(n)) for n in lens]
    # temperature 0.7 and top-k 40 (at 0.7) beside greedy rows, and one
    # hot row (top-k 40 at temperature 100, near uniform over the top 40)
    # whose draws leave the argmax: the random model's bf16 logits are
    # peaked (first-step top-2 gaps of 2-15 logits, printed below), so the
    # 0.7 rows mostly draw the argmax
    mixed = [SamplingSpec(), SamplingSpec("temperature", temperature=0.7,
                                          seed=11),
             SamplingSpec("top_k", temperature=0.7, top_k=40,
                          seed=2 ** 32 - 1),
             SamplingSpec(), SamplingSpec("temperature", temperature=0.7,
                                          seed=2 ** 31),
             SamplingSpec("top_k", temperature=0.7, top_k=40, seed=7),
             SamplingSpec(), SamplingSpec("top_k", temperature=100.0,
                                          top_k=40, seed=0)]

    def serve(specs, mode="fused"):
        system = GeoServingSystem(cfg, params, problem, algorithm="proposed",
                                  R=4, max_new_tokens=32, max_sessions=8,
                                  decode_mode=mode)
        syncs = []
        run = system.decode_round

        def counted(*a, **kw):
            out, n = count_syncs(torch, run, *a, **kw)
            syncs.append(n)
            return out

        system.decode_round = counted
        sched = ContinuousBatchingScheduler(system, R=4)
        for rid, (t, p, sp) in enumerate(zip(serve_arrivals, prompts,
                                             specs)):
            sched.submit(rid, p, float(t), n_new=32, sampling=sp)
        t0 = time.perf_counter()
        out = [list(map(int, s.tokens)) for s in sched.run()]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tail = system._round_tail
        del system.decode_round, system, sched
        return out, syncs, wall, tail

    # how peaked the random model's next-token logits are: the gap between
    # the two largest logits of each prompt's first step
    probe = GeoServingSystem(cfg, params, problem, algorithm="proposed",
                             R=4, max_new_tokens=32, max_sessions=8)
    gaps = []
    for p in prompts[:4]:
        sid, lg = probe.submit(p)
        top = torch.topk(lg[0].float(), 2).values
        gaps.append(float(top[0] - top[1]))
        probe.finish(sid)
    del probe
    log(f"{tag} first-step top-2 logit gaps of 4 prompts: "
        f"{[round(x, 3) for x in gaps]}")

    a, syncs_a, wall_a, tail = serve(mixed)
    b, _, _, _ = serve(mixed)
    s, syncs_s, wall_s, _ = serve(mixed, "serial")
    g, _, wall_g, _ = serve([SamplingSpec()] * 8)
    greedy = [i for i, sp in enumerate(mixed) if sp.kind == "greedy"]
    drawn = [i for i, sp in enumerate(mixed) if sp.kind != "greedy"]
    n_diff = sum(a[i] != g[i] for i in drawn)
    log(f"{tag} 8 requests (3 greedy, 2 temperature 0.7, 2 top-k 40 at "
        f"0.7, 1 top-k 40 at 100): "
        f"repeat {'==' if a == b else '!='}, fused "
        f"{'==' if a == s else '!='} serial, greedy sessions "
        f"{'==' if all(a[i] == g[i] for i in greedy) else '!='} the "
        f"all-greedy run; {n_diff}/{len(drawn)} sampled streams differ "
        f"from greedy; fused decode rounds {len(syncs_a)}, host syncs per "
        f"round {sorted(set(syncs_a))}; run walls fused {wall_a:.3f} s, "
        f"serial {wall_s:.3f} s, all-greedy {wall_g:.3f} s")
    if a != b or a != s or any(a[i] != g[i] for i in greedy):
        raise RuntimeError("sampled streams are not reproducible")
    if n_diff == 0:
        raise RuntimeError("no sampled stream left the greedy one: the "
                           "checks above would not see the draws")
    if set(syncs_a) != {1}:
        raise RuntimeError(f"fused sampled rounds made {sorted(set(syncs_a))}"
                           " host syncs")

    # the round tail alone at W = 8, V = 128256: device time (CUDA events)
    # and host wall (enqueue + synchronize), all-greedy against mixed
    W = 8
    gen = torch.Generator(device="cuda").manual_seed(3)
    h = (torch.randn(W, 1, cfg.d_model, generator=gen, device="cuda")
         ).to(torch.bfloat16)
    rows = {"greedy": [SamplingSpec()] * W, "mixed": mixed}
    for name, specs in rows.items():
        temps = np.asarray([sp.row_params()[0] for sp in specs], np.float32)
        topks = np.asarray([sp.row_params()[1] for sp in specs], np.int64)
        sd = np.asarray([sp.seed for sp in specs], np.int64)
        ti = np.arange(W, dtype=np.int64)
        args = (params["embed"], h, temps, topks, sd, ti)
        ms = device_ms(torch, tail, [args])
        t0 = time.perf_counter()
        for _ in range(10):
            tail(*args)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 100
        log(f"{tag} round tail (lm_head + sampler), W {W} x V "
            f"{cfg.vocab_size}, {name} rows: device {ms:.4f} ms, host wall "
            f"{host:.3f} ms a call")
    del params
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the performance model: τ calibration, engine against simulator, routing
# ---------------------------------------------------------------------------


def step_device_ms(torch, srv, args, reps=10):
    """(paced, queued) device ms of one pooled decode step by CUDA events.
    Paced: events around ``reps`` back-to-back steps, the device following
    the host as it issues the step's launches (what a round pays).  Queued:
    the median of ``reps`` single steps, each issued while the stream is
    held busy, so the events time the device's work alone; None where the
    host could not issue a step within the sleep (a step's launches beyond
    the launch queue's depth would block the host)."""
    for _ in range(2):
        srv.decode_rows(*args)
    torch.cuda.synchronize()
    busy, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    start.record()
    for _ in range(reps):
        srv.decode_rows(*args)
    end.record()
    torch.cuda.synchronize()
    paced = start.elapsed_time(end) / reps
    queued = []
    for _ in range(reps):
        busy.record()
        torch.cuda._sleep(1 << 27)
        start.record()
        t = time.perf_counter()
        srv.decode_rows(*args)
        issued_ms = (time.perf_counter() - t) * 1e3
        end.record()
        torch.cuda.synchronize()
        if busy.elapsed_time(start) <= issued_ms:
            return paced, None
        queued.append(start.elapsed_time(end))
    return paced, sorted(queued)[reps // 2]


def tau_rows(torch, tag, system, taus):
    """Print and return each server's roofline τ (``taus``, from
    ``calibrate_taus``) beside its pooled decode step's device time by
    CUDA events, paced and queued (``step_device_ms``), every row active at
    position max_seq_len - 1."""
    from repro_torch.launch.costs import roofline_terms

    pos = system.max_seq_len - 1
    log(f"{tag} τ from the roofline of each server's pooled decode step "
        f"(every row active at position {pos} = max_seq_len - 1, "
        f"{system.cfg.param_dtype}; flops at 989 TFLOP/s, bytes at 3.35 "
        "TB/s), beside the step's device time by CUDA events: paced (the "
        "device follows the host's launches) and queued (launches issued "
        "ahead behind a busy stream)")
    rows = {}
    for j, srv in system.servers.items():
        N, cost = srv.pool.n_rows, srv.decode_step_cost()
        terms = roofline_terms(cost, 1)
        paced, queued = step_device_ms(torch, srv,
                                       step_inputs(system, srv, pos))
        per = srv.m * N
        rows[j] = r = dict(m=srv.m, N=N, flops=cost.flops,
                           bytes=cost.bytes_accessed, tau=taus[j],
                           tau_paced=paced * 1e-3 / per,
                           tau_queued=None if queued is None
                           else queued * 1e-3 / per)
        alone = "not measured (the host could not issue the step ahead)" \
            if queued is None else \
            (f"{queued:.4f} ms, τ {r['tau_queued']:.4g} s "
             f"({r['tau_queued'] / r['tau']:.1f}x)")
        log(f"{tag}   server {j}: m {srv.m}, N {N}, flops {cost.flops:.6g}, "
            f"bytes {cost.bytes_accessed:.6g} ({terms['dominant']}-bound); "
            f"roofline step {terms['bound_s'] * 1e3:.4f} ms, τ "
            f"{r['tau']:.4g} s; measured step paced {paced:.4f} ms, τ "
            f"{r['tau_paced']:.4g} s ({r['tau_paced'] / r['tau']:.1f}x the "
            f"roofline); queued {alone}")
    return rows


def phase_tau_bloom(torch):
    """[perf model] (a'): the paper's own model on the card — BLOOM-176B at
    full width, SERVE_DEPTH layers, on the serve cluster: each server's
    roofline τ per (block, token) and its pooled step's device time,
    printed beside the simulator's A100 profile τ (``sim/cluster.py``: an
    NF4 BLOOM block on an A100 under PETALS, fit to the paper's Table 8).
    A reading; it changes no decision."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import GeoServingSystem
    from repro_torch.sim.cluster import A100

    tag = "[perf model bloom]"
    cfg = get_config("bloom_176b").replace(
        n_layers=SERVE_DEPTH["bloom_176b"])
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    system = GeoServingSystem(cfg, params,
                              serve_problem(C, cfg.name, cfg.n_layers),
                              algorithm="proposed", R=4, max_new_tokens=32,
                              max_sessions=8)
    taus = system.calibrate_taus()
    rows = tau_rows(torch, tag, system, taus)
    def taus_of(key):
        return [None if r[key] is None else float(f"{r[key]:.4g}")
                for r in rows.values()]

    log(f"{tag} {cfg.name} at {cfg.n_layers} layers, τ per (block, token) "
        f"by server: roofline {taus_of('tau')} s, measured paced "
        f"{taus_of('tau_paced')} s, queued {taus_of('tau_queued')} s; the "
        f"simulator's A100 profile τ {A100['tau']} s (an NF4 block under "
        "PETALS, from the paper; not an H100 number)")
    if not all(np.isfinite(t) and t > 0 for t in taus.values()):
        raise RuntimeError(f"calibrated τ not finite and positive: {taus}")
    del system, params
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_tau(torch):
    """[perf model] (a): τ from the H100 roofline of each server's pooled
    decode step on the full-width Llama-3.2-1B serve cluster, beside the
    step's measured device time; the count on the card equals the CPU's;
    the calibrated problem through CG-BP and the simulator."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import init_params
    from repro_torch.serving import GeoServingSystem
    from repro_torch.sim import SimConfig, poisson_requests, simulate

    tag = "[perf model]"
    cfg, params = _llama_bf16(torch, tag)
    problem = serve_problem(C, cfg.name, cfg.n_layers)
    spec_tau = problem.tau().tolist()
    system = GeoServingSystem(cfg, params, problem, algorithm="proposed",
                              R=4, max_new_tokens=32, max_sessions=8)
    taus = system.calibrate_taus()
    cal = system.calibrated_problem()
    rows = tau_rows(torch, tag, system, taus)
    if not all(np.isfinite(t) and t > 0 for t in taus.values()):
        raise RuntimeError(f"calibrated τ not finite and positive: {taus}")
    if system.problem.tau().tolist() != spec_tau or \
            cal.tau().tolist() != [taus[s.sid] for s in cal.servers]:
        raise RuntimeError("calibration changed the live problem, or the "
                           "calibrated problem lost a τ")
    del system, params
    gc.collect()
    torch.cuda.empty_cache()

    # the count on the card equals the CPU's for one reduced f32 system
    rcfg = get_reduced_config("llama3_2_1b")
    rprob = serve_problem(C, rcfg.name, rcfg.n_layers)
    counts = {}
    for dev in ("cuda", "cpu"):
        p = init_params(rcfg, torch.Generator(device=dev).manual_seed(0),
                        dev)
        s = GeoServingSystem(rcfg, p, rprob, algorithm="proposed", R=4,
                             max_new_tokens=32, max_sessions=8, device=dev)
        counts[dev] = (s.placement.a.tolist(), s.placement.m.tolist(),
                       {j: v.decode_step_cost().to_dict()
                        for j, v in s.servers.items()})
    per_server = {j: (c["flops"], c["bytes_accessed"])
                  for j, c in counts["cuda"][2].items()}
    log(f"{tag} reduced {rcfg.name} in {rcfg.param_dtype}, placement "
        f"a={counts['cpu'][0]} m={counts['cpu'][1]}: decode_step_cost "
        f"(flops, bytes) on the card {per_server} "
        f"{'==' if counts['cuda'] == counts['cpu'] else '!='} on the CPU")
    if counts["cuda"] != counts["cpu"]:
        raise RuntimeError(f"step counts differ: {counts}")

    # the calibrated problem through CG-BP and the simulator
    reqs = poisson_requests(8, 2.0, seed=1)
    for name, prob in (("spec'd τ", problem), ("the card's τ", cal)):
        pl, info = C.cg_bp(prob, 4)
        sim = simulate(prob, SimConfig("proposed", n_requests=len(reqs),
                                       rate=2.0, seed=1, R=4),
                       requests=reqs)
        log(f"{tag} {name}: CG-BP (R=4) a={pl.a.tolist()} "
            f"m={pl.m.tolist()}; simulate('proposed', 8 Poisson requests "
            f"at 2/s): first-token {sim.first_token:.6g} s, per-token "
            f"{sim.per_token_all:.6g} s, wait {sim.wait:.6g} s")
    return rows


# the reference's engine-vs-simulator cross-validation
# (benchmarks/engine_validation.py:126-186 cross_validate) on its problem
# (:59-78 _concurrency_problem): 5 servers, L = 8, Workload(8, 12), 10
# Poisson requests at rate 1.0 from seed 0, at R in XVAL_R
XVAL_R = (1, 4, 8)


def xval_problem(C):
    import numpy as np

    llm = C.LLMSpec("xval", 8, block_bytes=50.0, cache_bytes_per_token=0.5)
    fast = dict(tau_prefill_base=0.002, tau_prefill_per_token=0.0005)
    slow = dict(tau_prefill_base=0.004, tau_prefill_per_token=0.001)
    servers = [C.ServerSpec(j, 500.0, 0.004, **fast) for j in (0, 1)] + \
        [C.ServerSpec(j, 260.0, 0.020, **slow) for j in (2, 3, 4)]
    rtt = np.array([[0.01, 0.01, 0.03, 0.03, 0.03]])
    return C.Problem(llm, servers, 1, rtt, 3 * rtt,
                     workload=C.Workload(8, 12))


def phase_xval(torch):
    """[perf model] (b): the port's engine (Llama-3.2-1B at full width in
    bf16, cut to 8 layers, on the card) against the port's simulator on
    the same trace; the engine's times against BENCH_engine.json's
    xval.R* rows (the reference's), within 1e-12 relative; one host sync
    per decode round."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import (ContinuousBatchingScheduler,
                                     GeoServingSystem)
    from repro_torch.sim import (SimConfig, poisson_requests, prompts_for,
                                 simulate)

    tag = "[perf model]"
    bench = json.loads((ROOT / "BENCH_engine.json").read_text())["scenarios"]
    cfg = get_config("llama3_2_1b").replace(n_layers=8)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    problem = xval_problem(C)
    lw = problem.workload
    requests = poisson_requests(10, 1.0, seed=0)
    prompts = prompts_for(requests, lw.l_in, cfg.vocab_size, seed=0)
    log(f"{tag} engine vs simulator: {cfg.name} at d_model {cfg.d_model}, "
        f"{cfg.n_layers} of {get_config('llama3_2_1b').n_layers} layers, "
        f"{cfg.param_dtype}; 10 Poisson requests at 1/s, seed 0")
    # warm-up: one request through a throwaway engine (cuBLAS handles,
    # kernel libraries loaded), as the serve phases do
    warm = GeoServingSystem(cfg, params, problem, algorithm="proposed", R=1,
                            max_new_tokens=lw.l_out)
    ws = ContinuousBatchingScheduler(warm, R=1)
    ws.submit(0, prompts[0], 0.0, n_new=4)
    ws.run()
    del warm, ws
    out = {}
    for R in XVAL_R:
        sim = simulate(problem, SimConfig("proposed", n_requests=len(requests),
                                          rate=1.0, seed=0, R=R),
                       requests=requests)
        system = GeoServingSystem(cfg, params, problem, algorithm="proposed",
                                  R=R, max_new_tokens=lw.l_out,
                                  max_sessions=max(8, R))
        syncs, sites = [], {}
        decode_round = system.decode_round

        def counted(*a, **kw):
            res, where = sync_sites(torch, decode_round, *a, **kw)
            if len(where) != 1:
                sites[len(syncs)] = where
            syncs.append(len(where))
            return res

        system.decode_round = counted
        sched = ContinuousBatchingScheduler(system, R=R, arrival_rate=1.0)
        for req, toks in zip(requests, prompts):
            sched.submit(req.rid, toks, req.arrival, n_new=lw.l_out,
                         client=req.client)
        served = [r for r in sched.run() if not r.dropped]
        torch.cuda.synchronize()
        eng = {"first_token": float(np.mean([r.first_token for r in served])),
               "per_token": float(np.mean([r.per_token for r in served]))}
        simm = {"first_token": sim.first_token,
                "per_token": sim.per_token_all}
        err = {k: abs(eng[k] - simm[k]) / max(simm[k], 1e-12) for k in eng}
        ref = bench[f"xval.R{R}"]
        off = {k: abs(eng[k] - ref[k + "_eng"]) / abs(ref[k + "_eng"])
               for k in eng}
        out[R] = dict(eng=eng, sim=simm, err=err, bench_rel=off)
        log(f"{tag}   xval.R{R}: served {len(served)}/{len(requests)}, max "
            f"concurrency {sched.max_concurrency} (reference "
            f"{ref['max_concurrency']:g}); first-token eng "
            f"{eng['first_token']!r} sim {simm['first_token']!r} err "
            f"{err['first_token']:.3g}; per-token eng {eng['per_token']!r} "
            f"sim {simm['per_token']!r} err {err['per_token']:.3g}; vs "
            f"BENCH_engine.json {off['first_token']:.3g} / "
            f"{off['per_token']:.3g} relative; {len(syncs)} decode rounds, "
            f"host syncs per round {sorted(set(syncs))}"
            + "".join(f"; round {i}: syncs at {w}" for i, w in sites.items()))
        if len(served) != len(requests):
            raise RuntimeError(f"xval.R{R}: served {len(served)}")
        if max(err.values()) > 1e-12 or max(off.values()) > 1e-12:
            raise RuntimeError(f"xval.R{R}: engine {eng} vs simulator {simm}"
                               f" / BENCH_engine.json {ref}")
        if set(syncs) != {1}:
            raise RuntimeError(f"xval.R{R}: decode rounds made "
                               f"{sorted(set(syncs))} host syncs")
        del system, sched
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_routing(torch):
    """[perf model] (c): ``torch_shortest_paths`` on the card against the
    numpy DP on the serve cluster and three seeded random problems (with
    WS-RR waiting); the joint BPRR MILP against brute force on a toy
    problem (scipy's HiGHS on the card's machine)."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.core.milp import brute_force_bprr, solve_bprr_milp

    tag = "[perf model]"
    serve = serve_problem(C, "llama3.2-1b", 16)
    cases = [("serve cluster", serve, C.cg_bp(serve, 4)[0], None, 1.0)]
    seed = 0
    while len(cases) < 4:
        rng = np.random.default_rng(seed)
        n, L = 6, 6
        llm = C.LLMSpec("t", L, block_bytes=4.0, cache_bytes_per_token=0.25)
        servers = [C.ServerSpec(j, float(4 * rng.integers(2, 6)),
                                float(0.05 + 0.3 * rng.random()))
                   for j in range(n)]
        rtt = 0.02 + 0.3 * rng.random((3, n))
        prob = C.Problem(llm, servers, 3, rtt, 4 * rtt,
                         workload=C.Workload(2, 4))
        pl, info = C.cg_bp(prob, 2)
        if info.feasible:
            cases.append((f"random seed {seed}", prob, pl,
                          0.05 * rng.random((n + 1, n)),
                          float(prob.workload.l_out)))
        seed += 1
    for name, prob, pl, wait, lw in cases:
        dist, choice = C.torch_shortest_paths(prob, pl, waiting=wait,
                                              l_max_weight=lw)
        if dist.device.type != "cuda":
            raise RuntimeError("torch_shortest_paths left the card")
        dist, choice = dist.cpu().numpy(), choice.cpu().numpy()
        want = [C.shortest_path_route(prob, pl, c, waiting=wait,
                                      l_max_weight=lw)
                for c in range(prob.n_clients)]
        rel = max(abs(d - w[1]) / abs(w[1]) for d, w in zip(dist, want))
        same = [int(ch) == w[0].servers[-1] for ch, w in zip(choice, want)]
        log(f"{tag} torch_shortest_paths on the card, {name} ({prob.n_clients}"
            f" clients, {prob.n_servers} servers"
            + (", WS-RR waiting" if wait is not None else "")
            + f"): terminal servers {choice.tolist()} equal the numpy DP's "
            f"{sum(same)}/{len(same)}, dist max relative difference {rel:.3g}")
        if not all(same) or rel > 1e-12:
            raise RuntimeError(f"{name}: device DP differs from the numpy DP")
    # the toy problem of tests/test_core_bprr.py:106-120
    rng = np.random.default_rng(3)
    llm = C.LLMSpec("t", 3, block_bytes=4.0, cache_bytes_per_token=1.0)
    servers = [C.ServerSpec(j, float(14 + 4 * rng.random()),
                            float(0.1 + 0.2 * rng.random()))
               for j in range(3)]
    rtt = 0.05 + 0.2 * rng.random((2, 3))
    prob = C.Problem(llm, servers, 2, rtt, rtt * 5,
                     workload=C.Workload(2, 1))
    t = time.perf_counter()
    res = solve_bprr_milp(prob, [0, 1])
    bf, _ = brute_force_bprr(prob, [0, 1])
    log(f"{tag} BPRR MILP (13) with scipy's HiGHS: status {res.status}, "
        f"objective {res.objective!r}, brute force {bf!r} (|diff| "
        f"{abs(res.objective - bf):.3g}), placement a={res.placement.a} "
        f"m={res.placement.m}; {time.perf_counter() - t:.1f} s")
    if res.status != 0 or abs(res.objective - bf) > 1e-6:
        raise RuntimeError("the MILP misses the brute-force optimum")


# ---------------------------------------------------------------------------
# device groups
# ---------------------------------------------------------------------------

# benchmarks/engine_validation.py:455's heterogeneous shapes on servers 0-2
# of the Llama serve cluster (3 and 4 solo)
GROUP_SHAPES = {0: None, 1: (1, 2), 2: (2, 2)}
K1_K2 = ("decode_attention", "flash_attention")
# the (4, 2) group of the full-width Llama-4-Scout serve, cut to 13 of its
# 48 layers (~2.2 B params, 4.1 GiB in bf16, a layer: 16 experts of 3 x
# 5120 x 8192 and a shared one; with the untied embedding and head, 30.7 B
# params, 57.2 GiB): the deepest cut whose phase peaks under
# SCOUT_PEAK_GIB (14 layers take 61.3 GiB of params alone); the slots
# share the card, so replicated leaves are one tensor.  Its serves take
# FAMILY_NEW_TOKENS a request (its f32 twin's: its first steps), which
# keeps the whole script within its time beside phases (e)-(h)
SCOUT_DEPTH = 13
SCOUT_MESH = (4, 2)
SCOUT_PEAK_GIB = 60.0
# the f32 twin of that serve, at 2 layers (the embedding and head, 8.3 GB,
# and 17.6 GB of layers)
SCOUT_F32_DEPTH = 2
# the reduced f32 parity matrix of tests/test_sharded_serving.py, and its
# logits tolerance between two runs of one arithmetic
GROUP_PARITY = [("llama3_2_1b", (2, 4)), ("deepseek_v2_236b", (2, 4)),
                ("llama4_scout_17b_a16e", (4, 2)), ("rwkv6_7b", (2, 4)),
                ("zamba2_7b", (2, 4)), ("seamless_m4t_large_v2", (2, 4))]
LOGIT_TOL = dict(atol=5e-6, rtol=1e-4)
# zamba2 at ROADMAP C2's atol: its recurrences amplify f32 rounding
FAMILY_TOL = {"zamba2_7b": dict(atol=1e-4, rtol=1e-4)}
# (e)-(h): the block families on the serve cluster in bf16 at full width,
# each against its all-solo run — (phase, arch, groups: "hetero" = servers
# 0-2 as {solo, (1, 2), (2, 2)}, "mesh" = every server a (1, 2) group with
# the client's embedding and head vocab-parallel on it; the kernels the
# group path must launch on every slot; the slot calls kept as kernel rows)
FAMILY_PHASES = (
    ("e", "rwkv6_7b", "hetero", ("wkv6",), ("wkv6",)),
    ("f", "zamba2_7b", "hetero", ("ssd", "decode_attention",
                                  "flash_attention"),
     ("ssd", "decode_attention", "flash_attention")),
    ("g", "seamless_m4t_large_v2", "hetero",
     ("decode_attention", "flash_attention"),
     ("decode_attention_cross", "flash_attention_enc",
      "flash_attention_cross")),
    ("h", "deepseek_v2_236b", "mesh",
     ("decode_attention_partials", "merge_partials", "flash_attention"),
     ("decode_attention_partials", "merge_partials", "flash_attention")),
    # Gemma-3-4B's 8 query heads on a (1, 16) group: the head_dim
    # fallback (each slot projects 16 of the 256 head_dim columns), KV
    # heads whole and the cache's time axis over the 16 slots
    ("i", "gemma3_4b", "mesh16",
     ("decode_attention_partials", "merge_partials", "flash_attention"),
     ("decode_attention_partials", "merge_partials", "flash_attention")),
)
FAMILY_SUFFIX = {"rwkv6_7b": "_rwkv6", "zamba2_7b": "_zamba2",
                 "seamless_m4t_large_v2": "_seamless",
                 "deepseek_v2_236b": "_deepseek", "gemma3_4b": "_gemma3"}
# family phases cut in depth (Gemma-3-4B on its (1, 16) group: 6 of 34
# layers, five local and one global, keeps the 16 slots' eager loop
# within the script's time)
GROUP_DEPTH = {"gemma3_4b": 6}
# the f32 twins that hold a family group's first steps (bf16 drift is
# printed only, ROADMAP C5; SeamlessM4T's is held as well): full width,
# the deepest stack that fits the card beside its pools (RWKV6-7B,
# Zamba2-7B and SeamlessM4T whole, 6-29 GiB in f32;
# DeepSeek-V2 at 2 layers, 13.52 B params, 50.4 GiB), held within
# GROUP_F32_BOUND of the solo f32 logit scale with the greedy tokens equal
GROUP_F32_DEPTH = {"rwkv6_7b": None, "zamba2_7b": None,
                   "seamless_m4t_large_v2": None, "deepseek_v2_236b": 2,
                   "gemma3_4b": 6}
GROUP_F32_BOUND = 1e-3
# new tokens a request of the family phases' bf16 serves (a dozen decode
# rounds and more: the round walls and the one-sync rule read them)
FAMILY_NEW_TOKENS = 12
# their pools' length: the serve phases' (prompts up to 128 tokens, 32 new,
# 32 spare): DeepSeek-V2's slots hold 96 of its 192 latent positions
FAMILY_MAX_LEN = 192
# DeepSeek-V2's and Gemma-3-4B's f32 twins run on the plain versions: K2
# has no f32 instantiation at MLA's (192, 128) or at (256, 256) (its f32
# pairs are the reduced stacks'); the kernels at the slot shapes are held
# by the kernel rows
GROUP_F32_BACKEND = {"deepseek_v2_236b": "plain", "gemma3_4b": "plain"}


def slot_devices(torch, n):
    """``n`` slot devices over the cards present, round robin (one card:
    every slot on it)."""
    k = torch.cuda.device_count()
    return [torch.device("cuda", i % k) for i in range(n)]


# the kernel wrappers a group path may launch, by the module that calls
# them (decode attention's partials and their merge on time-sharded slots)
GROUP_SITES = (("decode_attention", "attention"),
               ("decode_attention_partials", "attention"),
               ("merge_partials", "kernels"), ("flash_attention", "attention"),
               ("wkv6", "ssm"), ("ssd", "ssm"))


# the wrappers of prefill calls: a group serve keeps the call over the
# longest sequence (of decode calls, the 100th)
PREFILL_KINDS = ("flash_attention", "wkv6", "ssd")


def _group_frames(cfg, rng, n):
    """Frames of the enc-dec requests of a group serve (phase_serve's
    encoder lengths; None for a decoder-only stack)."""
    if not cfg.is_enc_dec:
        return [None] * n
    return [rng.randn(int(e), cfg.frame_dim).astype("float32")
            for e in rng.choice(ENC_LENS, n)]


def group_serve(torch, tag, cfg, params, problem, keep=None, kernels=(),
                n_new=32, warm=True, **kw):
    """Serve phase_serve's 8 Poisson requests (prompts 32-128, or 4-16
    with 256 / 512 frames on an enc-dec stack; ``n_new`` new tokens)
    through GeoServingSystem(**kw) + the scheduler.  Counts each kernel's
    launches on each group slot — the rise of the wrapper's own launch
    counter across each call, a group block calling each kernel once a
    slot in slot order; the per-slot launches must add up to the counter's
    total —, the host syncs and wall of each decode round, the MoE drop
    fraction, and keeps each request's first-step greedy token and logits.
    ``kernels``: the path's kernels, each of which must launch, and on
    every slot of every group.  ``keep``: {(kernel, mesh shape): None} to
    fill with one captured slot-0 call each."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch import kernels as K
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import blocks as blocks_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.serving import (ContinuousBatchingScheduler,
                                     GeoServingSystem)

    if cfg.is_enc_dec:
        kw = dict(ENC_DEC_LENS, **kw)

    def build():
        return GeoServingSystem(cfg, params, problem, algorithm="proposed",
                                R=4, max_new_tokens=n_new, max_sessions=8,
                                **kw)

    if warm:
        ws = ContinuousBatchingScheduler(build(), R=4)
        ws.submit(0, np.arange(2, 50), 0.0, n_new=4,
                  frames=_group_frames(cfg, np.random.RandomState(9), 1)[0])
        ws.run()
        del ws
    system = build()
    shapes = {j: (None if s.mesh is None else s.mesh.devices.shape)
              for j, s in system.servers.items()}
    cards = {str(d) for s in system.servers.values() if s.mesh is not None
             for d in s.mesh.slot_devices()}
    log(f"{tag} placement a={system.placement.a.tolist()} "
        f"m={system.placement.m.tolist()}; groups {shapes}; the slots span "
        f"{len(cards)} distinct card(s) {sorted(cards)}")
    walls, syncs, first = [], [], {}
    real_round, real_fin = system.decode_round, system._finalize_prefill

    def decode_round(*a, **k):
        t = time.perf_counter()
        out, n = count_syncs(torch, real_round, *a, **k)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        syncs.append(n)
        return out

    def finalize(sess, h_last):
        real_fin(sess, h_last)
        # the vocabulary's columns (the padded ones hold -1e30)
        first[tuple(sess.tokens[:sess.prompt_len])] = (
            sess.tokens[-1],
            sess.last_logits.float()[..., :cfg.vocab_size].clone())

    system.decode_round, system._finalize_prefill = decode_round, finalize
    mods = {"attention": attn_mod, "ssm": ssm_mod, "kernels": K}
    real = {name: getattr(mods[m], name) for name, m in GROUP_SITES}
    # the wrappers whose counters count (taken before any is patched)
    wrappers = {name: getattr(K, name) for name, _ in GROUP_SITES}
    blocks = {n: getattr(blocks_mod, n) for n in dir(blocks_mod)
              if n.endswith("_group") and not n.startswith("_")}
    real_dispatch = moe_mod._sort_dispatch
    cur = [None]  # [mesh shape, slot count, {kernel: calls}] in a group block
    slot_launches, seen = {}, {}
    moe = {"decode": [0, 0], "prefill": [0, 0]}  # [kept, choices]

    def in_group(fn):
        def run(ps, cfg_, ctxs, *a, **k):
            mesh = ctxs[0].mesh  # None: a solo server's block
            outer = cur[0]
            if mesh is not None:
                cur[0] = [tuple(mesh.devices.shape), len(ctxs), {}]
            try:
                return fn(ps, cfg_, ctxs, *a, **k)
            finally:
                cur[0] = outer
        return run

    def counted(name):
        wrapper = wrappers[name]

        def run(*a, **k):
            shape, slot = None, 0
            if cur[0] is not None:
                shape, n, calls = cur[0]
                slot = calls.get(name, 0) % n
                calls[name] = calls.get(name, 0) + 1
            key = (name, shape, slot)
            seen[key] = seen.get(key, 0) + 1
            kind = capture_kind(name, a, k)
            if keep is not None and (kind, shape) in keep and slot == 0:
                have = keep[(kind, shape)]
                if have is None or (name in PREFILL_KINDS and
                                    a[0].shape[1] > have[0][0].shape[1]) \
                        or (name not in PREFILL_KINDS and seen[key] == 100):
                    keep[(kind, shape)] = (clone_call(torch, a), k)
            n0 = wrapper.launches
            out = real[name](*a, **k)
            slot_launches[key] = slot_launches.get(key, 0) \
                + wrapper.launches - n0
            return out
        return run

    def dispatch(xf, top_w, top_e, E_slots, C_, rows=1):
        out = real_dispatch(xf, top_w, top_e, E_slots, C_, rows)
        c = moe["decode" if xf.shape[0] == rows else "prefill"]
        c[0] = c[0] + out[4].sum()
        c[1] += top_e.numel()
        return out

    def restore():
        for name, m in GROUP_SITES:
            setattr(mods[m], name, real[name])
        for n, fn in blocks.items():
            setattr(blocks_mod, n, fn)
        moe_mod._sort_dispatch = real_dispatch

    for name, m in GROUP_SITES:
        setattr(mods[m], name, counted(name))
    for n, fn in blocks.items():
        setattr(blocks_mod, n, in_group(fn))
    moe_mod._sort_dispatch = dispatch
    sched = ContinuousBatchingScheduler(system, R=4)
    rng = np.random.RandomState(0)
    arrivals = poisson_arrivals(8, rate=2.0, seed=1)
    lens = rng.randint(4, 17, 8) if cfg.is_enc_dec else \
        rng.randint(32, 129, 8)
    if cfg.family in ("ssm", "hybrid"):
        lens[1::3] = lens[0]  # equal lengths form exact-length groups
    prompts = [rng.randint(2, cfg.vocab_size, int(n)) for n in lens]
    frames = _group_frames(cfg, rng, 8)
    for rid, (t, p, f) in enumerate(zip(arrivals, prompts, frames)):
        sched.submit(rid, p, float(t), n_new=n_new, frames=f)
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        served = sched.run()
        torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()
                if fn.launches or name in kernels}
    n_gen = sum(len(s.tokens) - len(p) for s, p in zip(served, prompts))
    log(f"{tag} served {sum(not s.dropped for s in served)}/8, {n_gen} "
        f"generated tokens in {wall:.3f} s ({n_gen / wall:.1f} tokens/s, "
        f"host clock); decode rounds {len(walls)}, wall per round mean "
        f"{1e3 * sum(walls) / max(1, len(walls)):.2f} ms; host syncs per "
        f"decode round {sorted(set(syncs))}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; kernel "
        f"launches {launches}")
    for name, total in launches.items():
        per_slot = sum(v for (n, _, _), v in slot_launches.items()
                       if n == name)
        if per_slot != total:
            raise RuntimeError(f"{tag}: {name} launches per slot add up to "
                               f"{per_slot}, the counter to {total}")
    groups = sorted({sh for _, sh, _ in slot_launches if sh is not None})
    if keep is not None and not {sh for _, sh in keep} <= set(groups):
        raise RuntimeError(f"{tag}: the groups {sorted(keep)} did not all "
                           f"run (ran: {groups})")
    for sh in groups:
        per = {name: [slot_launches.get((name, sh, s), 0)
                      for s in range(sh[0] * sh[1])] for name in launches}
        log(f"{tag} group {sh}: launches per slot {per} (the wrappers' "
            "counters; they add up to the run's totals)")
        if any(min(per[name]) <= 0 for name in kernels):
            raise RuntimeError(f"a slot of group {sh} launched no "
                               f"{[n for n in kernels if min(per[n]) <= 0]}")
    if cfg.is_moe:
        fr = {k: 1.0 - float(kept) / n for k, (kept, n) in moe.items() if n}
        log(f"{tag} MoE drop fraction over the routed (token, choice) "
            f"pairs: {fr}")
        if fr.get("decode", 0.0) != 0.0:
            raise RuntimeError("a decode row dropped a routed choice")
    else:
        fr = {}
    if any(s.dropped or len(s.tokens) != len(p) + n_new
           for s, p in zip(served, prompts)):
        raise RuntimeError(f"a request was not served its {n_new} tokens")
    if any(launches[name] <= 0 for name in kernels):
        raise RuntimeError(f"a kernel of the path never launched: "
                           f"{launches}")
    if walls and set(syncs) != {1}:
        raise RuntimeError(f"decode rounds made {sorted(set(syncs))} host "
                           "syncs; the token readback is the only one")
    record = {"streams": [list(map(int, s.tokens)) for s in served],
              "first": [first[tuple(int(t) for t in p)] for p in prompts],
              "prompts": [tuple(int(t) for t in p) for p in prompts],
              "round_ms": 1e3 * sum(walls) / max(1, len(walls)),
              "tok_s": n_gen / wall, "slot_launches": slot_launches,
              "moe_drop": fr, "peak": torch.cuda.max_memory_allocated(),
              "system": system}
    del sched
    return record


def clone_call(torch, args):
    """``clone_args`` of a kernel call, the merge's list of (m, l, acc)
    partials cloned tensor by tensor."""
    if args and isinstance(args[0], list):
        return [[tuple(x.clone() for x in p) for p in args[0]]] + \
            list(args[1:])
    return clone_args(torch, args)


def _greedy_agrees(t_s, l_s, t_g, l_g) -> bool:
    """The two runs' greedy tokens agree up to an exact tie: equal, or one
    run's token attains the other run's maximum logit (bf16 logits one
    ulp apart in one run may be equal in the other, and argmax then takes
    the lower index)."""
    l_s, l_g = l_s.reshape(-1), l_g.reshape(-1)
    return t_s == t_g or bool(l_g[t_s] == l_g.max()) or \
        bool(l_s[t_g] == l_s.max())


def compare_first_steps(tag, solo, group, strict=True, bound=None):
    """First-step greedy tokens equal (up to an exact tie of the logits,
    ``_greedy_agrees``) and logits within ``bound`` (default C5_FRACTION)
    of the solo logit scale; whole streams equal counted (TP partial sums
    round differently in bf16).  ``strict=False`` prints the agreement
    only."""
    bound = C5_FRACTION if bound is None else bound
    diffs = [float((l_g - l_s).abs().max()) / float(l_s.abs().max())
             for (_, l_s), (_, l_g) in zip(solo["first"], group["first"])]
    toks = sum(_greedy_agrees(*a, *b)
               for a, b in zip(solo["first"], group["first"]))
    same = sum(a == b for a, b in zip(solo["streams"], group["streams"]))
    for i, ((t_s, l_s), (t_g, l_g)) in enumerate(zip(solo["first"],
                                                     group["first"])):
        if t_s != t_g:  # how near the solo run's top two sat
            top = l_s.reshape(-1).topk(2).values
            scale = float(l_s.abs().max())
            log(f"{tag} request {i}: greedy token {t_s} solo, {t_g} group; "
                f"the solo top-2 margin {float(top[0] - top[1]) / scale:.3g}"
                f" of the scale, the group's logits of the two tokens "
                f"{float(l_g.reshape(-1)[t_s]):.4f} / "
                f"{float(l_g.reshape(-1)[t_g]):.4f}; "
                + ("an exact tie" if _greedy_agrees(t_s, l_s, t_g, l_g)
                   else "not a tie"))
    log(f"{tag} first-step greedy tokens equal to the solo run's (up to "
        f"an exact tie) {toks}/8; first-step logits max|group - solo| / solo scale "
        f"{max(diffs):.4g} (bound {bound}; per request "
        f"{[float(f'{d:.3g}') for d in diffs]}); whole streams equal "
        f"{same}/8; "
        f"decode round mean {group['round_ms']:.2f} ms vs solo "
        f"{solo['round_ms']:.2f} ms (slots share the card: no speedup "
        "claimed)")
    if strict and (toks != 8 or max(diffs) > bound):
        raise RuntimeError(f"{tag}: first-step tokens {toks}/8 equal, "
                           f"logits {max(diffs):.4f} of the solo scale")


def drive_reduced(torch, system, C, lengths=(4, 6, 5), n_new=4,
                  spread=False):
    """tests/test_torch_groups.py's drive: (streams, clocks, logits per
    round, round_stats).  ``spread``: session i on server i alone (every
    server hosting every block), so every server's step runs."""
    import numpy as np

    rng = np.random.RandomState(0)
    sids = []
    for i, n in enumerate(lengths):
        route, _ = C.shortest_path_route(system.problem,
                                         system.alive_placement(), 0)
        if spread:
            route = C.Route(servers=(i % len(system.servers),),
                            blocks=(system.cfg.n_layers,))
        prompt = rng.randint(2, system.cfg.vocab_size, n)
        kw = {} if not system.cfg.is_enc_dec else {"frames": rng.randn(
            n + 3, system.cfg.frame_dim).astype(np.float32)}
        sids.append(system.create_session(prompt, 0, route, n_new, **kw))
    assert system.try_admit_sessions(sids) == sids
    system.drain_prefill()
    hist = [[system.sessions[s].last_logits.clone() for s in sids]]
    while any(system.sessions[s].n_generated < n_new for s in sids):
        todo = [s for s in sids if system.sessions[s].n_generated < n_new]
        system.decode_round(todo)
        hist.append([system.sessions[s].last_logits.clone() for s in sids])
    return ([list(system.sessions[s].tokens) for s in sids],
            [float(system.sessions[s].virtual_time) for s in sids], hist,
            dict(system.round_stats))


def group_parity(torch):
    """(b): reduced f32 group runs == the card's solo runs."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.mesh import GroupMesh
    from repro_torch.models import init_params
    from repro_torch.serving import GeoServingSystem

    def problem(cfg):
        llm = C.LLMSpec("toy", cfg.n_layers, block_bytes=100.0,
                        cache_bytes_per_token=1.0)
        servers = [C.ServerSpec(j, 1000.0, 0.01 * (j + 1), 0.002, 0.0005)
                   for j in range(2)]
        rtt = np.full((1, 2), 0.02)
        return C.Problem(llm, servers, 1, rtt, 3 * rtt,
                         workload=C.Workload(4, 4))

    for arch, shape in GROUP_PARITY:
        cfg = get_reduced_config(arch)
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), "cuda")
        devs = np.empty(shape[0] * shape[1], dtype=object)
        devs[:] = slot_devices(torch, devs.size)
        mesh = GroupMesh(devs.reshape(shape))
        worst = 0.0
        for mode in ("fused", "serial"):
            for layout in ("slab", "paged"):
                kw = dict(algorithm="proposed", R=2, max_new_tokens=4,
                          max_sessions=4, decode_mode=mode,
                          cache_layout=layout,
                          page_size=2 if layout == "paged" else None)
                want = drive_reduced(torch, GeoServingSystem(
                    cfg, params, problem(cfg), **kw), C)
                got = drive_reduced(torch, GeoServingSystem(
                    cfg, params, problem(cfg), mesh=mesh, **kw), C)
                if got[0] != want[0] or got[1] != want[1] or \
                        got[3] != want[3]:
                    raise RuntimeError(f"[groups] {arch} {shape} {mode} "
                                       f"{layout}: streams, clocks or "
                                       "round_stats differ from solo")
                for hg, hw in zip(got[2], want[2]):
                    for a, b in zip(hg, hw):
                        if not torch.allclose(a, b, **FAMILY_TOL.get(
                                arch, LOGIT_TOL)):
                            raise RuntimeError(
                                f"[groups] {arch} {shape} {mode} {layout}"
                                ": logits beyond LOGIT_TOL")
                        worst = max(worst, float((a - b).abs().max()))
        log(f"[groups] (b) {arch} on a {shape} group in f32, fused/serial "
            f"x slab/paged: streams, virtual clocks and round_stats == the "
            f"card's solo runs; logits max|diff| {worst:.3g} "
            f"({FAMILY_TOL.get(arch, LOGIT_TOL)})")
    split_page_parity(torch, drive_reduced)


# reduced stacks whose paged servers split their page axis over data on a
# (2, 2) group: server memory -> 35 pages + the trash page (zamba2: 37 + 1)
SPLIT_PAGES = (("llama3_2_1b", 260.0), ("deepseek_v2_236b", 260.0),
               ("zamba2_7b", 520.0), ("seamless_m4t_large_v2", 260.0))


def split_page_parity(torch, drive):
    """(b') reduced f32 paged runs (page 4) whose page arrays split over
    ``data`` on a (2, 2) group, fused rounds on the kernels: each group
    server's slot page arrays, their bytes beside the reference layout's
    (``pool_tree_shardings``) and the pages-whole layout's, the counted
    cross-slot page reads and writes; streams, clocks and round_stats ==
    the card's solo run, logits within LOGIT_TOL (zamba2 at C2's)."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.mesh import GroupMesh
    from repro_torch.launch.sharding import pool_tree_shardings
    from repro_torch.models import init_params
    from repro_torch.models.layers import count_collectives
    from repro_torch.models.model import slot_zeros, tree_nbytes
    from repro_torch.serving import GeoServingSystem
    from repro_torch.serving.kv_cache import (new_paged_pool_tree,
                                              page_blocks)

    for arch, mem in SPLIT_PAGES:
        cfg = get_reduced_config(arch)
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), "cuda")
        llm = C.LLMSpec("toy", cfg.n_layers, block_bytes=100.0,
                        cache_bytes_per_token=1.0)
        servers = [C.ServerSpec(j, mem, 0.01 * (j + 1), 0.002, 0.0005)
                   for j in range(2)]
        rtt = np.full((1, 2), 0.02)
        problem = C.Problem(llm, servers, 1, rtt, 3 * rtt,
                            workload=C.Workload(4, 4))
        devs = np.empty(4, dtype=object)
        devs[:] = slot_devices(torch, 4)
        mesh = GroupMesh(devs.reshape(2, 2))
        kw = dict(algorithm="proposed", R=2, max_new_tokens=4,
                  max_sessions=4, cache_layout="paged", page_size=4)
        want = drive(torch, GeoServingSystem(cfg, params, problem, **kw), C)
        system = GeoServingSystem(cfg, params, problem, mesh=mesh, **kw)
        with count_collectives() as coll:
            got = drive(torch, system, C)
        if got[0] != want[0] or got[1] != want[1] or got[3] != want[3]:
            raise RuntimeError(f"[groups] (b') {arch}: streams, clocks or "
                               "round_stats differ from solo")
        tol = FAMILY_TOL.get(arch, LOGIT_TOL)
        for hg, hw in zip(got[2], want[2]):
            for a, b in zip(hg, hw):
                if not torch.allclose(a, b, **tol):
                    raise RuntimeError(f"[groups] (b') {arch}: logits "
                                       "beyond the tolerance")
        split = 0
        for j, srv in system.servers.items():
            pool, blocks = srv.pool, page_blocks(srv.mesh,
                                                 srv.pool.slot_specs)
            split += blocks > 1
            ref = sum(tree_nbytes(slot_zeros(
                t, pool_tree_shardings(srv.mesh, srv.layout_rules, t),
                srv.mesh, 0, "meta"))
                for t in (new_paged_pool_tree(
                    cfg, kind, hi - lo, pool.n_rows, pool.page_size,
                    pool.pages.n_pages + 1, pool.enc_len, "meta")
                    for kind, lo, hi in srv.runs))
            got_bytes = sum(tree_nbytes(t) for t in pool.slot_trees[0])
            log(f"[groups] (b') {arch} server {j} on (2, 2): "
                f"{pool.pages.n_pages + 1} pages in {blocks} data block(s); "
                f"slot 0 pool bytes {got_bytes}, the reference layout's "
                f"{ref}")
            if got_bytes != ref:
                raise RuntimeError(f"[groups] (b') {arch} server {j}: slot "
                                   "pool bytes differ from the reference "
                                   "layout's")
        log(f"[groups] (b') {arch}: paged page axis over data on {split} "
            f"server(s); streams, clocks and round_stats == solo; page "
            f"reads / writes across slots "
            f"{coll.by_kind.get('page-read', 0):.4g} / "
            f"{coll.by_kind.get('page-write', 0):.4g} wire bytes")
        if not split or not coll.by_kind.get("page-read"):
            raise RuntimeError(f"[groups] (b') {arch}: no page axis split "
                               "or no cross-slot page read")


def group_taus(torch):
    """(d): the hetero fleet of benchmarks/engine_validation.py
    ``hetero_validation`` (reduced Llama at 8 layers, f32) against its
    all-solo twin, the calibrated τ vector at H100 rates, and CG-BP on the
    calibrated vs the uniform problem."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.mesh import group_meshes
    from repro_torch.models import init_params
    from repro_torch.serving import GeoServingSystem

    L, n_sessions, lw = 8, 6, C.Workload(4, 8)
    llm = C.LLMSpec("hetero", L, block_bytes=50.0,
                    cache_bytes_per_token=0.5)
    servers = [C.ServerSpec(j, 2000.0, 0.01 * (j + 1), 0.002, 0.0005)
               for j in range(3)]
    rtt = np.full((1, 3), 0.01)
    problem = C.Problem(llm, servers, 1, rtt, 3 * rtt, workload=lw)
    cfg = get_reduced_config("llama3_2_1b").replace(n_layers=L)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    groups = group_meshes(GROUP_SHAPES, devices=slot_devices(torch, 6))
    out = {}
    for tag, dg in (("twin", None), ("hetero", groups)):
        system = GeoServingSystem(cfg, params, problem, algorithm="proposed",
                                  R=3, max_new_tokens=lw.l_out,
                                  max_sessions=n_sessions, device_groups=dg)
        out[tag] = drive_reduced(torch, system, C, (4,) * n_sessions,
                                 lw.l_out, spread=True)
    if out["hetero"][:2] != out["twin"][:2]:
        raise RuntimeError("[groups] hetero fleet streams or clocks differ "
                           "from the all-solo twin")
    chips = [system.servers[j].n_chips for j in sorted(system.servers)]
    taus = system.calibrate_taus()
    vec = [taus[j] for j in sorted(taus)]
    coll = [system.servers[j].decode_step_cost().coll_wire_bytes
            for j in sorted(system.servers)]
    spread = max(vec) / min(vec)
    log(f"[groups] (d) hetero fleet {chips} slots == all-solo twin "
        f"(token_parity 1); calibrated τ {[f'{t:.4g}' for t in vec]} s "
        f"(H100 rates; collective wire bytes a slot {coll}), spread "
        f"{spread:.3f}")
    if not spread > 1.0 or chips != [1, 2, 4] or coll[0] != 0 or \
            min(coll[1:]) <= 0:
        raise RuntimeError("[groups] calibrated τ is constant or the "
                           "collective count is wrong")
    tau_ref = 0.01
    mean = sum(vec) / len(vec)
    scaled = {j: tau_ref * taus[j] / mean for j in taus}
    tight = [C.ServerSpec(j, m, tau_ref, 0.002, 0.0005)
             for j, m in enumerate((290.0, 180.0, 350.0))]
    skew = np.array([[0.002, 0.004, 0.006]])
    base = C.Problem(llm, tight, 1, skew, 3 * skew, workload=lw)
    cal = C.with_server_taus(base, scaled)
    pl_cal, _ = C.cg_bp(cal, 1)
    pl_uni, _ = C.cg_bp(base, 1)
    _, cost_cal = C.shortest_path_route(cal, pl_cal, 0)
    _, cost_uni = C.shortest_path_route(cal, pl_uni, 0)
    differs = int(not (np.array_equal(pl_cal.m, pl_uni.m)
                       and np.array_equal(pl_cal.a, pl_uni.a)))
    log(f"[groups] (d) CG-BP calibrated a={pl_cal.a.tolist()} "
        f"m={pl_cal.m.tolist()} vs uniform a={pl_uni.a.tolist()} "
        f"m={pl_uni.m.tolist()}: placement_differs {differs}; route cost "
        f"under calibrated τ {cost_cal:.6f} vs {cost_uni:.6f} s")
    if not differs or cost_cal > cost_uni * (1 + 1e-9):
        raise RuntimeError("[groups] the calibrated τ did not change the "
                           "placement for the better")


_K1 = ("decode_attention.cu",
       "src/repro/kernels/decode_attention/decode_attention.py:111")
_K2 = ("flash_attention_sm90.cu",
       "src/repro/kernels/flash_attention/flash_attention.py:105")
SLOT_SOURCES = {"decode_attention": _K1, "decode_attention_cross": _K1,
                "decode_attention_partials": _K1, "merge_partials": _K1,
                "flash_attention": _K2, "flash_attention_enc": _K2,
                "flash_attention_cross": _K2,
                "wkv6": ("wkv6.cu", "src/repro/kernels/wkv6/wkv6.py:70"),
                "ssd": ("ssd.cu", "src/repro/kernels/ssd/ssd.py:76")}


def capture_kind(name, args, kw):
    """The kernel-row kind of a captured call: K1 self or cross (non-causal
    with a per-row kv_len), K2 causal, encoder (non-causal, Sq = Skv) or
    cross (non-causal, Sq != Skv); the other wrappers by name."""
    if name == "decode_attention" and kw.get("causal", True) is False:
        return "decode_attention_cross"
    if name == "flash_attention" and kw.get("causal", True) is False:
        return "flash_attention_" + (
            "enc" if args[0].shape[1] == args[1].shape[1] else "cross")
    return name


def _slot_row(torch, kind, args, kw):
    """(args, kernel, plain, library or None, cost, dtype, tolerance) of a
    captured slot call, each callable on ``args``."""
    import torch.nn.functional as F

    from repro_torch import kernels as K
    from repro_torch.kernels.decode_attention.ops import _plan

    def sdpa(q, k, v, mask=None, causal=False):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=causal,
            enable_gqa=True).transpose(1, 2)

    dtype = args[1] if kind == "merge_partials" else args[0].dtype
    tol = TOL["bfloat16"] if dtype == torch.bfloat16 else TOL["float32"]
    if kind in ("wkv6", "ssd"):
        kern = getattr(K, kind)
        plain = K.wkv6_chunked if kind == "wkv6" else K.ssd_chunked
        cost = (K.wkv6_cost if kind == "wkv6" else K.ssd_cost)(*args)
        return (args, lambda *a: kern(*a)[0], lambda *a: plain(*a)[0], None,
                cost, "tfloat32", "scan")
    if kind == "merge_partials":
        parts = args[0]
        cat = tuple(torch.cat([p[i] for p in parts]) for i in range(3))
        S, B, H, Dv = cat[2].shape
        return (cat, lambda m, l, a: K.merge_partials([(m, l, a)], dtype),
                lambda m, l, a: K.merge_partials_ref(m, l, a, dtype), None,
                K.merge_cost(S, B * H, Dv, 2 if dtype == torch.bfloat16
                             else 4), dtype, tol)
    if kind == "decode_attention_partials":  # (m, l, acc) of each split
        chunk, n_split = _plan(*args[:3])[1][2], _plan(*args[:3])[1][1]
        return (args, lambda *a: K.decode_attention_partials(*a, **kw),
                lambda *a: K.decode_attention_partials_ref(*a, chunk=chunk,
                                                           **kw), None,
                K.decode_attention_cost(*args, n_split=n_split, **{
                    k: v for k, v in kw.items() if k != "scale"}),
                args[0].dtype, tol)
    if kind.startswith("decode_attention"):
        cross = kind.endswith("cross")
        kvl = kw.get("kv_len")
        pos = args[3]

        def lib(q, k, v, p):
            t = torch.arange(k.shape[1], device=q.device)[None, :]
            ok = t < kvl[:, None] if cross else t <= p[:, None]
            return sdpa(q, k, v, ok[:, None, None, :])

        return (args, lambda *a: K.decode_attention(*a, **kw),
                lambda *a: K.decode_attention_ref(*a, **kw),
                None if kw.get("window") is not None or
                kw.get("slopes") is not None else lib,
                K.decode_attention_cost(*args, **{
                    k: v for k, v in kw.items() if k != "scale"}),
                args[0].dtype, bf16_ulp_ok if cross else tol)
    causal = kw.get("causal", True)
    lib = None if kw.get("slopes") is not None else \
        (lambda q, k, v: sdpa(q, k, v, causal=causal))
    if causal and lib is not None and (kw.get("window") is not None
                                       or kw.get("q_start", 0)):
        # a window or a chunk offset: the keys each query takes, as a
        # boolean mask built once (outside the timed calls)
        q0, Sq, Skv = kw.get("q_start", 0), args[0].shape[1], \
            args[1].shape[1]
        dev = args[0].device
        diff = (q0 + torch.arange(Sq, device=dev))[:, None] \
            - torch.arange(Skv, device=dev)[None, :]
        win = kw.get("window")
        ok = (diff >= 0) & (diff < (q0 + Sq if win is None else win))
        lib = lambda q, k, v: sdpa(q, k, v, ok[None, None])  # noqa: E731
    return (args, lambda *a: K.flash_attention(*a, **kw),
            lambda *a: K.attention_ref(*a, **kw), lib,
            K.flash_attention_cost(*args, **{
                k: v for k, v in kw.items() if k != "scale"}),
            args[0].dtype, tol if causal else bf16_ulp_ok)


def slot_kernel_rows(torch, keep, launches, tag="[groups]",
                     suffix=FAMILY_SUFFIX, where="on slot 0 in the serve"):
    """Kernel rows at the slot shapes the group serves gave each kernel:
    error against the plain version, device times of the kernel, the plain
    version and one PyTorch call that computes the same function where
    there is one (SDPA; none for the partials, their merge or the scans),
    the bound; launches are slot 0's in its serve run, by the wrapper's
    counter (``where`` says whose).  K1's partials are held merged (a
    split's output)."""
    from repro_torch import kernels as K

    rows = []
    for (kind, shape, path), got in sorted(keep.items(), key=str):
        if got is None:
            raise RuntimeError(f"no {kind} call captured on {shape} ({path})")
        args, kern, plain, lib, cost, dt, tol = _slot_row(torch, kind,
                                                          *got)
        args = tuple(args)
        want = plain(*args)
        out = kern(*args)
        if isinstance(out, tuple):  # K1's partials: held merged
            out, want = (K.merge_partials_ref(*x, dtype=args[0].dtype)
                         for x in (out, want))
        err = _err(out, want)
        ok = scan_ok(out, want) if tol == "scan" else tol(out, want) \
            if callable(tol) else err <= tol
        bound = kernel_bound(cost, dt)
        sets = copies(torch, list(args))
        ms = device_ms(torch, kern, sets)
        plain_ms = device_ms(torch, plain, sets, reps=10)
        lib_ms = None if lib is None else device_ms(torch, lib, sets)
        del sets, out, want
        row_name = f"{kind}_slot" + "x".join(map(str, shape)) \
            + suffix.get(path, "")
        n = launches[(path, kind, shape)]
        log(f"{tag} {row_name} ({path}) "
            f"{' '.join(str(tuple(a.shape)) for a in args[:3])} "
            f"{args[0].dtype}: max|kernel-plain| {err:.3g} (tolerance "
            f"{tol if isinstance(tol, (str, float)) else 'bf16 per element'}"
            f"), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{bound[0]:.4f} ms ({bound[1]}); {n} launches {where}")
        if not ok:
            raise RuntimeError(f"{row_name}: err {err}")
        source, replaces = SLOT_SOURCES[kind]
        rows.append({"name": row_name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/" + source,
                     "replaces": replaces, "launches": n,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": lib_ms, "path": path})
    return rows


PAGE_SIZE = 16  # the paged serves' page size


def slot_pool_bytes(system):
    """{server: bytes of one slot's pool} of each group server: slab (the
    reference's layout, time shards included), slab with the time axis
    kept whole on each slot (the port's earlier layout), the solo
    pool; and the paged pool at PAGE_SIZE as the port lays it out
    (``group_pool_specs``), as the reference's rules put it
    (``pool_tree_shardings``: the page axis over ``data`` where the
    pages divide it) and with the page axis whole on each slot (the
    port's layout before).  Fails where the port's paged layout is not
    the reference's.  Shapes only (meta tensors)."""
    from repro_torch.launch.sharding import pool_tree_shardings
    from repro_torch.models.model import slot_zeros, tree_nbytes
    from repro_torch.serving.kv_cache import (group_pool_specs,
                                              new_paged_pool_tree,
                                              new_state_pool_tree)

    def slot0(trees, specs_of, mesh):
        return sum(tree_nbytes(slot_zeros(t, specs_of(t), mesh, 0, "meta"))
                   for t in trees)

    out = {}
    for j, srv in system.servers.items():
        if srv.mesh is None:
            continue
        pool, mesh, rules = srv.pool, srv.mesh, srv.layout_rules
        runs = [(kind, hi - lo) for kind, lo, hi in srv.runs]
        slab = [new_state_pool_tree(srv.cfg, kind, n, pool.n_rows,
                                    pool.max_len, pool.enc_len, "meta")
                for kind, n in runs]
        max_pages = pool.max_len // PAGE_SIZE
        n_phys = max(1, min(pool.cap_slots * max_pages // max(1, srv.m),
                            pool.n_rows * max_pages))
        paged = [new_paged_pool_tree(srv.cfg, kind, n, pool.n_rows,
                                     PAGE_SIZE, n_phys + 1, pool.enc_len,
                                     "meta") for kind, n in runs]
        whole = dict(rules, kv_time=None)

        def pages_whole(t):
            return {k: (sp[:1] + (None,) + sp[2:]
                        if k in ("k", "v", "latent", "krope") else sp)
                    for k, sp in group_pool_specs(mesh, rules, t,
                                                  True).items()}

        out[j] = {
            "slab": slot0(slab, lambda t: group_pool_specs(
                mesh, rules, t, False), mesh),
            "slab, time whole": slot0(slab, lambda t: group_pool_specs(
                mesh, whole, t, False), mesh),
            "solo": sum(tree_nbytes(t) for t in slab),
            "paged": slot0(paged, lambda t: group_pool_specs(
                mesh, rules, t, True), mesh),
            "paged, reference layout": slot0(
                paged, lambda t: pool_tree_shardings(mesh, rules, t), mesh),
            "paged, pages whole": slot0(paged, pages_whole, mesh)}
        if out[j]["paged"] != out[j]["paged, reference layout"]:
            raise RuntimeError(f"server {j}: the paged pool a slot is not "
                               f"the reference layout's ({out[j]})")
    return out


def log_pool_bytes(tag, system):
    shapes = {j: s.mesh.devices.shape for j, s in system.servers.items()
              if s.mesh is not None}
    for j, nbytes in slot_pool_bytes(system).items():
        log(f"{tag} server {j} {shapes[j]}: pool bytes a slot {nbytes}")


def group_family(torch, phase, arch, groups, kernels, kinds, keep,
                 launches):
    """(e)-(i): one block family at full width (GROUP_DEPTH: cut in
    depth) in bf16 on the serve cluster, all solo and then on its groups
    (``groups``: "hetero", or "mesh" / "mesh16": a (1, 2) / (1, 16) group
    on every server, FAMILY_PHASES): 8/8 requests, 1 host sync a decode round, the
    path's kernels on every slot, each slot's launches adding up to the
    counters' totals, the per-slot pool bytes of both layouts; the first
    steps held to the C5 bound (seamless) or printed, then held in f32 at
    GROUP_F32_DEPTH within GROUP_F32_BOUND.  Fills ``keep`` with one
    slot-0 call of each of ``kinds``."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import GroupMesh, group_meshes
    from repro_torch.models import init_params

    tag = f"[groups] ({phase}) {arch}"
    base = get_config(arch)
    cfg = base.replace(n_layers=GROUP_DEPTH.get(
        arch, SERVE_DEPTH.get(arch, base.n_layers)))

    def group_kw():
        if groups in ("mesh", "mesh16"):
            shape = (1, 16) if groups == "mesh16" else (1, 2)
            devs = np.empty(shape[1], dtype=object)
            devs[:] = slot_devices(torch, shape[1])
            return dict(mesh=GroupMesh(devs.reshape(shape))), [shape]
        return dict(device_groups=group_meshes(
            {**GROUP_SHAPES, 3: None, 4: None},
            devices=slot_devices(torch, 6))), [(1, 2), (2, 2)]

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    log(f"{tag}: {cfg.n_layers} of {base.n_layers} layers, "
        f"{sum(x.numel() for x in _leaves(params)) / 1e9:.2f} B params in "
        f"bf16, device memory {torch.cuda.memory_allocated() / 2**30:.1f} "
        "GiB")
    problem = serve_problem(C, cfg.name, cfg.n_layers)
    t0 = time.perf_counter()
    # the script's earlier phases have loaded the kernels and warmed the
    # card: no warm-up serve; FAMILY_NEW_TOKENS a request, in pools of the
    # serve phases' length (the enc-dec stack: ENC_DEC_LENS)
    pools = {} if cfg.is_enc_dec else {"max_seq_len": FAMILY_MAX_LEN}
    solo = group_serve(torch, tag + " solo", cfg, params, problem,
                       kernels=PATH_KERNELS[arch], n_new=FAMILY_NEW_TOKENS,
                       warm=False, **pools)
    del solo["system"]
    kw, shapes = group_kw()
    want = {(kind, shapes[0]): None for kind in kinds}
    grp = group_serve(torch, tag + " groups", cfg, params, problem,
                      keep=want, kernels=kernels, n_new=FAMILY_NEW_TOKENS,
                      warm=False, **pools, **kw)
    log_pool_bytes(tag, grp["system"])
    if arch == "deepseek_v2_236b":
        srv = next(iter(grp["system"].servers.values()))
        lat = srv.pool.slot_trees[0][0]["latent"]
        log(f"{tag} a slot's latent {tuple(lat.shape)}: "
            f"{lat.shape[2]} of {srv.pool.max_len} positions")
        if lat.shape[2] * 2 != srv.pool.max_len:
            raise RuntimeError(f"{tag}: the slot latent is not half the "
                               "time axis")
        del srv, lat  # the server holds the model's param views
    del grp["system"]
    compare_first_steps(tag + " bf16", solo, grp,
                        strict=arch == "seamless_m4t_large_v2")
    for (kind, shape), got in want.items():
        keep[(kind, shape, arch)] = got
        wrapper = kind.split("_cross")[0].split("_enc")[0]
        launches[(arch, kind, shape)] = grp["slot_launches"][
            (wrapper, shape, 0)]
    del grp, solo, params
    gc.collect()
    torch.cuda.empty_cache()
    if arch not in GROUP_F32_DEPTH:
        return
    depth = GROUP_F32_DEPTH[arch] or base.n_layers
    cfg = base.replace(n_layers=depth, param_dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    problem = serve_problem(C, cfg.name, cfg.n_layers)
    log(f"{tag} f32 twin: {depth} layers, "
        f"{sum(x.numel() for x in _leaves(params)) / 1e9:.2f} B params, "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    backend = GROUP_F32_BACKEND.get(arch, "kernel")
    kernel = backend == "kernel"
    log(f"{tag} f32 twin on backend {backend!r}")
    solo = group_serve(torch, tag + " f32 solo", cfg, params, problem,
                       kernels=PATH_KERNELS[arch] if kernel else (),
                       n_new=2, warm=False, backend=backend, **pools)
    del solo["system"]
    kw, _ = group_kw()
    grp = group_serve(torch, tag + " f32 groups", cfg, params, problem,
                      kernels=kernels if kernel else (), n_new=2,
                      warm=False, backend=backend, **pools, **kw)
    del grp["system"]
    compare_first_steps(tag + " f32", solo, grp, bound=GROUP_F32_BOUND)
    del grp, solo, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{tag} freed: device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB; the phase "
        f"{time.perf_counter() - t0:.1f} s")


def phase_groups(torch):
    """Device-group servers on the card; returns the slot-shape kernel
    rows.  (a) full-width Llama-3.2-1B, bf16, on the serve cluster with
    groups {0: solo, 1: (1, 2), 2: (2, 2)} against the all-solo run; (b)
    the reduced f32 parity matrix; (c) full-width Llama-4-Scout cut to
    SCOUT_DEPTH layers, solo and then every server on a (4, 2) group
    (``mesh=``: the client's embedding and head vocab-parallel on it), in
    bf16 (first steps printed) and in f32 at SCOUT_F32_DEPTH layers (first
    steps held); (d) the hetero fleet's calibrated τ and its placement."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import GroupMesh, group_meshes
    from repro_torch.models import init_params

    t0 = time.perf_counter()
    keep = {}
    launches = {}  # (path, kernel, shape) -> launches on slot 0
    # (a)
    cfg = get_config("llama3_2_1b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    problem = serve_problem(C, cfg.name, cfg.n_layers)
    solo = group_serve(torch, "[groups] (a) solo", cfg, params, problem,
                       kernels=PATH_KERNELS["llama3_2_1b"])
    del solo["system"]
    want = {("decode_attention", (1, 2)): None,
            ("decode_attention", (2, 2)): None,
            ("flash_attention", (1, 2)): None,
            ("flash_attention", (2, 2)): None}
    groups = group_meshes({**GROUP_SHAPES, 3: None, 4: None},
                          devices=slot_devices(torch, 6))
    grp = group_serve(torch, "[groups] (a) groups", cfg, params, problem,
                      keep=want, kernels=PATH_KERNELS["llama3_2_1b"],
                      device_groups=groups)
    log_pool_bytes("[groups] (a)", grp["system"])
    compare_first_steps("[groups] (a)", solo, grp)
    for (name, shape), got in want.items():
        keep[(name, shape, "llama3_2_1b")] = got
        launches[("llama3_2_1b", name, shape)] = grp["slot_launches"][
            (name, shape, 0)]
    del grp, solo, params, groups
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[groups] (a) freed: device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    log(f"[groups] (a) {time.perf_counter() - t0:.1f} s into the phase")
    # (b)
    group_parity(torch)
    log(f"[groups] (b) {time.perf_counter() - t0:.1f} s into the phase")
    # (c)
    base = get_config("llama4_scout_17b_a16e").replace(n_layers=SCOUT_DEPTH)
    params = init_params(base, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    n_params = sum(x.numel() for x in _leaves(params))
    log(f"[groups] (c) {base.name}: {SCOUT_DEPTH} of "
        f"{get_config('llama4_scout_17b_a16e').n_layers} layers, "
        f"{n_params / 1e9:.2f} B params in bf16, device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    devs = np.empty(SCOUT_MESH[0] * SCOUT_MESH[1], dtype=object)
    devs[:] = slot_devices(torch, devs.size)
    mesh = GroupMesh(devs.reshape(SCOUT_MESH))
    problem = serve_problem(C, base.name, base.n_layers)
    # the kernels are loaded and the card warm: no warm-up serves
    short = dict(n_new=FAMILY_NEW_TOKENS, max_seq_len=FAMILY_MAX_LEN,
                 warm=False)
    solo = group_serve(torch, "[groups] (c) solo", base, params, problem,
                       kernels=K1_K2, **short)
    del solo["system"]
    gc.collect()
    torch.cuda.empty_cache()
    want = {("decode_attention", SCOUT_MESH): None,
            ("flash_attention", SCOUT_MESH): None}
    grp = group_serve(torch, "[groups] (c) (4, 2) group", base, params,
                      problem, keep=want, kernels=K1_K2, mesh=mesh, **short)
    log_pool_bytes("[groups] (c)", grp["system"])
    peak = max(solo["peak"], grp["peak"])
    # printed, not held: the partial sums' bf16 rounding moves some
    # prompt tokens' top-1 expert (a different expert, not a rounding
    # error), and a request whose last token moves leaves the bound at any
    # capacity factor (scripts/group_moe_routing.py); held in f32 below
    compare_first_steps("[groups] (c) bf16", solo, grp, strict=False)
    for (name, shape), got in want.items():
        keep[(name, shape, "llama4_scout_17b_a16e")] = got
        launches[("llama4_scout_17b_a16e", name, shape)] = \
            grp["slot_launches"][(name, shape, 0)]
    del grp, solo
    gc.collect()
    torch.cuda.empty_cache()
    peak /= 2**30
    log(f"[groups] (c) peak device memory of its serves {peak:.1f} GiB "
        f"(bound {SCOUT_PEAK_GIB} GiB)")
    if peak > SCOUT_PEAK_GIB:
        raise RuntimeError(f"[groups] (c) peaked at {peak:.1f} GiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[groups] (c) freed: device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    cfg = base.replace(n_layers=SCOUT_F32_DEPTH, param_dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    problem = serve_problem(C, cfg.name, cfg.n_layers)
    first = dict(short, n_new=2)
    solo = group_serve(torch, "[groups] (c) f32 solo", cfg, params, problem,
                       kernels=K1_K2, **first)
    del solo["system"]
    grp = group_serve(torch, "[groups] (c) f32 (4, 2) group", cfg, params,
                      problem, keep={("decode_attention", SCOUT_MESH): None},
                      kernels=K1_K2, mesh=mesh, **first)
    compare_first_steps("[groups] (c) f32", solo, grp)
    del grp, solo, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[groups] (c) {time.perf_counter() - t0:.1f} s into the phase")
    # (d)
    group_taus(torch)
    # (e)-(h)
    for phase, arch, groups, kernels, kinds in FAMILY_PHASES:
        group_family(torch, phase, arch, groups, kernels, kinds, keep,
                     launches)
    rows = slot_kernel_rows(torch, keep, launches)
    log(f"[groups] phase {time.perf_counter() - t0:.1f} s")
    return rows


# [dryrun]: full-width Llama-3.2-1B in bf16 on a (2, 2) group of slots on
# the card, at cells cut from the dry run's shapes to fit one card: a
# decode cell (rows over data, KV heads over model: K1), a long cell of
# one row (the cache's time axis over data: K1 partials merged over the
# slots) and a prefill cell (K2); then full-width Gemma-3-4B in bf16 (cut
# to DRYRUN_DEPTH layers) on a (1, 16) group, whose 8 query heads take the
# head_dim fallback: a prefill of one 2048-token row (attn_seq_q: K2 on
# each slot's 128 query rows at q_start 128 j) and a decode cell of 16
# rows at 4096 (K1 partials over 256-position time shards, window 1024,
# merged over the 16 slots); the meta count of each against the card.
# (arch, mesh, name, seq, rows, kind)
DRYRUN_CELLS = (("llama3_2_1b", (2, 2), "decode_4k", 4096, 8, "decode"),
                ("llama3_2_1b", (2, 2), "long_8k", 8192, 1, "decode"),
                ("llama3_2_1b", (2, 2), "prefill_2k", 2048, 4, "prefill"),
                ("gemma3_4b", (1, 16), "gemma_prefill_2k", 2048, 1,
                 "prefill"),
                ("gemma3_4b", (1, 16), "gemma_decode_4k", 4096, 16,
                 "decode"))
DRYRUN_KINDS = {"decode_4k": ("decode_attention",),
                "long_8k": ("decode_attention_partials", "merge_partials"),
                "prefill_2k": ("flash_attention",),
                "gemma_prefill_2k": ("flash_attention",),
                "gemma_decode_4k": ("decode_attention_partials",
                                    "merge_partials")}
# Gemma-3-4B at 6 of its 34 layers: five local (window 1024) and a global;
# DeepSeek-V2 and Llama-4-Scout at 1 layer for the train cells
DRYRUN_DEPTH = {"gemma3_4b": 6, "deepseek_v2_236b": 1,
                "llama4_scout_17b_a16e": 1}
# [dryrun] train cells: full width in bf16, cut to DRYRUN_DEPTH, the
# config's own optimizer, on (2, 2) slots at B 4 x S 256 (arch, name, the
# production shape whose rules the cell runs under at the full depth, or
# None for the cell's own): DeepSeek-V2 with Adafactor (its padded MoE
# takes pure EP: 64 experts a slot), Llama-4-Scout with AdamW (its
# unpadded MoE sends each expert holder its kept rows), also under
# train_4k's rules, which set seq_act (each slot routes its own block of
# the positions).  Each against an f32 twin: the same group shape and
# rules at the config's reduced width against the solo step from the
# same weights and batch (TRAIN_GROUP_* bounds); DeepSeek's twin pads
# its experts (EP_MIN_EXPERTS / EP_PAD_GROUP lowered to the reduced
# config, capacity factor 8 so that local and global capacities drop
# nothing) so that it takes the same pure-EP path.
DRYRUN_TRAIN = (("deepseek_v2_236b", "deepseek_train", None),
                ("llama4_scout_17b_a16e", "scout_train", None),
                ("llama4_scout_17b_a16e", "scout_train_4k_rules",
                 "train_4k"))
DRYRUN_TRAIN_MESH = (2, 2)
DRYRUN_TRAIN_BATCH = (4, 256)
TWIN_BATCH = (4, 64)
TWIN_EP = {"deepseek_v2_236b": dict(EP_MIN_EXPERTS=8, EP_PAD_GROUP=16)}
TWIN_CAPACITY = {"deepseek_v2_236b": 8.0}
# a train cell whose remat stash passes 8e9 bytes at the reduced width, so
# that make_rules sets seq_act there too (the CPU tests' cell)
TWIN_SEQ_ACT = (1 << 20, 64)


def _holds_pos(k, v, pos, t0):
    """True when the time shard ``k`` (first position ``t0``) holds the
    largest of the rows' positions ``pos``."""
    p = int(pos.max())
    return t0 <= p < t0 + k.shape[1]


def _rows_of(torch, ctxs, parts):
    """The batch rows of per-slot outputs put back in row order: each row
    block from its first slot (``layers.row_heads``)."""
    from repro_torch.models.layers import row_heads

    return torch.cat([parts[s] for s in row_heads(ctxs)])


def phase_dryrun(torch):
    """[dryrun] The port's dry run (``launch.dryrun``) held against the
    card: full-width Llama-3.2-1B in bf16 on a (2, 2) group of cuda slots
    on the card and Gemma-3-4B on a (1, 16) group (DRYRUN_CELLS), each
    cell's step counted on a mesh of meta slots of its shape (``count_cell``: every slot's body, and slot 0 standing in
    for all) and then run on the card with the same weights' shards.
    Held exactly: FlopCounterMode's flops of the card's call == the meta
    count's aten flops, and the allocated shard bytes of slot 0's
    arguments == the predicted ``argument_size_in_bytes``; the stand-in
    count (flops, bytes, wire bytes) == the full slot loop's.  Printed:
    the slot loop's predicted live peak of the step (the four slots in
    lockstep, as on the card) beside torch.cuda.max_memory_allocated over
    the call, their ratio, the stand-in's peak of one slot alone, and the
    meta count's seconds.  The
    group's logits against the solo model's on the same prompt (the
    decode cells after a prefill of seq_len - 1 tokens): within
    C5_FRACTION of the solo scale, greedy tokens equal.  K1, K1's partials
    and merge, and K2 launch in the measured calls (their counters zeroed
    just before) and are held against their plain versions at the slot
    shapes, on calls captured from a second, unmeasured run; returns
    their kernel rows."""
    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import kernels as K
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.dryrun import cell_specs, count_cell
    from repro_torch.launch.sharding import make_ctx, shard, shard_params
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import init_params
    from repro_torch.models.layers import group_ctxs
    from repro_torch.models.model import decode_step, prefill, tree_nbytes

    tag = "[dryrun]"
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    mods = {"attention": attn_mod, "kernels": K}
    sites = [(n, m) for n, m in GROUP_SITES if m in mods]
    real = {n: getattr(mods[m], n) for n, m in sites}
    wrappers = {n: getattr(K, n) for n, _ in sites}
    keep, launches = {}, {}
    cap = {}

    def capture(name):
        """Keep one call of each kind: the first — K2's at its largest
        q_start (a slot's query rows), K1's partials over the time shard
        that holds the position (a shard the window masks whole has no
        merged output to hold)."""
        def run(*a, **k):
            kind = capture_kind(name, a, k)
            later = kind in cap and (
                k.get("q_start", 0) > cap[kind][1].get("q_start", 0)
                if name == "flash_attention" else
                name == "decode_attention_partials"
                and not _holds_pos(*cap[kind][0][1:4],
                                   cap[kind][1].get("t0", 0))
                and _holds_pos(*a[1:4], k.get("t0", 0)))
            if kind not in cap or later:
                cap[kind] = (clone_call(torch, a), k)
            return real[name](*a, **k)
        return run

    def measured(fn):
        """fn() under FlopCounterMode with the kernel counters zeroed:
        (out, flops, peak bytes over the call, launches by wrapper); then
        fn() once more, outside the measurement, with its kernel calls
        captured (a decode step writes the same token again)."""
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            out = fn()
        torch.cuda.synchronize()
        got = (out, fc.get_total_flops(),
               torch.cuda.max_memory_allocated() - base,
               {n: w.launches for n, w in wrappers.items()})
        cap.clear()
        for n, m in sites:
            setattr(mods[m], n, capture(n))
        try:
            with torch.no_grad():
                fn()
        finally:
            for n, m in sites:
                setattr(mods[m], n, real[n])
        return got

    rng = np.random.RandomState(0)
    params = None
    for arch, mesh_shape, name, seq, rows, kind in DRYRUN_CELLS:
        if params is None or cfg.name != get_config(arch).name:
            params = None
            gc.collect()
            torch.cuda.empty_cache()
            base = get_config(arch)
            cfg = base.replace(n_layers=DRYRUN_DEPTH.get(arch,
                                                         base.n_layers))
            params = init_params(
                cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
            log(f"{tag} {arch}: {cfg.n_layers} of {base.n_layers} layers, "
                f"{sum(x.numel() for x in _leaves(params)) / 1e9:.2f} B "
                f"params in bf16")
        mesh = _group_mesh(torch, mesh_shape)
        meta = _group_mesh(torch, mesh_shape, torch.device("meta"))
        shape = ShapeSpec(name, seq, rows, kind)
        c0 = time.perf_counter()
        pred = count_cell(cell_specs(cfg, shape, meta, stand_in=False),
                          meta, with_corrections=False)
        full_s = time.perf_counter() - c0
        c0 = time.perf_counter()
        stand = count_cell(cell_specs(cfg, shape, meta), meta,
                           with_corrections=False)
        stand_s = time.perf_counter() - c0
        if stand["cost"].to_dict() != pred["cost"].to_dict() or \
                stand["memory"]["argument_size_in_bytes"] != \
                pred["memory"]["argument_size_in_bytes"]:
            raise RuntimeError(f"{tag} {name}: the stand-in count "
                               f"{stand['cost'].to_dict()} is not the slot "
                               f"loop's {pred['cost'].to_dict()}")
        sh = make_ctx(cfg, mesh, shape)
        ctxs = group_ctxs(mesh, sh.rules)
        ps = shard_params(cfg, sh, params)
        n_prompt = seq - 1 if kind == "decode" else seq
        prompt = torch.as_tensor(rng.randint(2, cfg.vocab_size,
                                             (rows, n_prompt)),
                                 dtype=torch.int32, device="cuda")
        bspec = sh.spec(("batch", None), tuple(prompt.shape))
        batches = [{"tokens": t} for t in shard(prompt, bspec, mesh)]
        if kind == "prefill":
            args = tree_nbytes(ps[0]) + tree_nbytes(batches[0])
            out, flops, peak, ran = measured(lambda: prefill(
                ps, cfg, batches, cache_len=seq, ctxs=ctxs))
            logits = out[0]
            solo, _ = prefill(params, cfg, {"tokens": prompt},
                              cache_len=seq)
        else:
            nxt = torch.as_tensor(rng.randint(2, cfg.vocab_size, rows),
                                  dtype=torch.int32, device="cuda")
            with torch.no_grad():
                _, caches = prefill(ps, cfg, batches, cache_len=seq,
                                    ctxs=ctxs)
            toks = shard(nxt, sh.spec(("batch",), (rows,)), mesh)
            args = tree_nbytes(ps[0]) + tree_nbytes(caches[0]) \
                + tree_nbytes(toks[0])
            out, flops, peak, ran = measured(lambda: decode_step(
                ps, cfg, caches, toks, seq - 1, ctxs=ctxs))
            logits = out[0]
            del caches, out
            with torch.no_grad():
                _, sc = prefill(params, cfg, {"tokens": prompt},
                                cache_len=seq)
                solo, _ = decode_step(params, cfg, sc, nxt, seq - 1)
            del sc
        grp = _rows_of(torch, ctxs, logits).float()
        solo = solo.float()
        rel = float((grp - solo).abs().max()) / float(solo.abs().max())
        same = int((grp.argmax(-1) == solo.argmax(-1)).sum())
        want_flops = round(pred["aten_flops"] * len(ctxs))
        live = pred["live_peak"] * len(ctxs)
        mem = pred["memory"]
        log(f"{tag} {name} ({arch}, seq {seq}, batch {rows}, {kind}) on "
            f"{mesh_shape} slots (rules: seq_act {sh.rules['seq_act']}, "
            f"attn_seq_q {sh.rules['attn_seq_q']}, head_dim "
            f"{sh.rules['head_dim']}, kv_time {sh.rules['kv_time']}): "
            f"flops FlopCounterMode {flops} vs meta "
            f"count {want_flops}; slot 0's argument bytes allocated {args} "
            f"vs predicted {mem['argument_size_in_bytes']}; the step's "
            f"peak allocation over the call {peak} B vs the predicted live "
            f"peak {live:.0f} B over the slots (ratio card / predicted "
            f"{peak / max(live, 1):.4f}); one slot alone "
            f"{stand['live_peak']:.0f} B; predicted per-slot peak_hbm "
            f"{mem['peak_hbm_bytes']} B; meta count {full_s:.2f} s (slot "
            f"loop), {stand_s:.2f} s (stand-in); group vs solo logits "
            f"max|diff| / solo scale {rel:.4g} (bound {C5_FRACTION}), "
            f"greedy equal {same}/{rows}; launches {ran}")
        if flops != want_flops:
            raise RuntimeError(f"{tag} {name}: flops {flops} != meta "
                               f"{want_flops}")
        if args != mem["argument_size_in_bytes"]:
            raise RuntimeError(f"{tag} {name}: argument bytes {args} != "
                               f"{mem['argument_size_in_bytes']}")
        if rel > C5_FRACTION or same != rows:
            raise RuntimeError(f"{tag} {name}: group vs solo {rel:.4g}, "
                               f"greedy {same}/{rows}")
        for k in DRYRUN_KINDS[name]:
            if ran[k] <= 0 or k not in cap:
                raise RuntimeError(f"{tag} {name}: {k} never launched "
                                   f"({ran})")
            keep[(k, mesh_shape, "dryrun")] = cap[k]
            launches[("dryrun", k, mesh_shape)] = ran[k]
            opts = {a: b for a, b in cap[k][1].items()
                    if a in ("q_start", "t0", "window")}
            log(f"{tag} {name} {k}: the kernel row's call {opts}")
        del logits, grp, solo, ps, batches
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for arch, name, rules in DRYRUN_TRAIN:
        dryrun_train_cell(torch, tag, arch, name, rules, wrappers)
        train_twin(torch, tag, arch, name, rules)
    rows = slot_kernel_rows(torch, keep, launches, tag=tag,
                            suffix={"dryrun": "_dryrun"},
                            where="in the measured calls (all slots)")
    log(f"{tag} phase {time.perf_counter() - t0:.1f} s")
    return rows


def _group_mesh(torch, shape, device=None):
    import numpy as np

    from repro_torch.launch.mesh import GroupMesh

    devs = np.empty(shape[0] * shape[1], dtype=object)
    devs[:] = [device] * devs.size if device is not None else \
        slot_devices(torch, devs.size)
    return GroupMesh(devs.reshape(shape))


def dryrun_train_cell(torch, tag, arch, name, rules_of, wrappers):
    """One [dryrun] train cell (DRYRUN_TRAIN): the config at DRYRUN_DEPTH
    layers in bf16 on DRYRUN_TRAIN_MESH cuda slots, one training step
    (``make_train_step(..., sh)``, remat, ``make_optimizer_for``) at
    DRYRUN_TRAIN_BATCH, counted first on meta slots of the mesh's shape
    (``count_cell``: the slot loop, and slot 0 standing in).  Held
    exactly: FlopCounterMode's flops of the card's step == the meta
    count's aten flops; slot 0's argument bytes (its params' shards,
    optimizer state, step and batch) == the predicted
    ``argument_size_in_bytes``; the stand-in's flops, argument bytes and
    wire bytes of every kind but the all-reduce == the slot loop's (the
    loss and the MoE's aux terms are summed once a group, on slot 0,
    whose scalar ops a stand-in counts whole: its bytes and all-reduce
    differ by those, printed).  No kernel launches (training runs the
    plain versions).  Printed: the card's peak allocation over the step
    beside the predicted live peak of the slot loop and their ratio; a
    second step's time by CUDA events, its slot collectives by kind with
    their wire bytes and its host syncs (the unpadded MoE reads its sends'
    sizes once a layer pass)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import SHAPES_BY_NAME, ShapeSpec, get_config
    from repro_torch.data import make_batches, shard_batch
    from repro_torch.launch.dryrun import cell_specs, count_cell
    from repro_torch.launch.sharding import ShardingCtx, make_ctx
    from repro_torch.models import init_params
    from repro_torch.models.layers import count_collectives
    from repro_torch.models.model import tree_nbytes
    from repro_torch.training import (TrainHParams, init_train_state,
                                      make_optimizer_for, make_train_step)

    gc.collect()
    torch.cuda.empty_cache()
    base = get_config(arch)
    cfg = base.replace(n_layers=DRYRUN_DEPTH[arch])
    rows, seq = DRYRUN_TRAIN_BATCH
    shape = ShapeSpec(name, seq, rows, "train")
    meta = _group_mesh(torch, DRYRUN_TRAIN_MESH, torch.device("meta"))
    rules = None if rules_of is None else make_ctx(
        base, meta, SHAPES_BY_NAME[rules_of]).rules
    c0 = time.perf_counter()
    pred = count_cell(cell_specs(cfg, shape, meta, stand_in=False,
                                 rules=rules), meta, with_corrections=False)
    full_s = time.perf_counter() - c0
    c0 = time.perf_counter()
    stand = count_cell(cell_specs(cfg, shape, meta, rules=rules), meta,
                       with_corrections=False)
    stand_s = time.perf_counter() - c0
    a, b = pred["cost"].to_dict(), stand["cost"].to_dict()
    kinds = {k: (a["coll_by_kind"].get(k), b["coll_by_kind"].get(k))
             for k in set(a["coll_by_kind"]) | set(b["coll_by_kind"])}
    log(f"{tag} {name}: stand-in vs slot loop: flops {b['flops']} / "
        f"{a['flops']}, argument bytes "
        f"{stand['memory']['argument_size_in_bytes']} / "
        f"{pred['memory']['argument_size_in_bytes']}, bytes "
        f"{b['bytes_accessed']:.6g} / {a['bytes_accessed']:.6g}, wire "
        f"bytes by kind {kinds}")
    if a["flops"] != b["flops"] or any(
            x != y for k, (x, y) in kinds.items() if k != "all-reduce") or \
            stand["memory"]["argument_size_in_bytes"] != \
            pred["memory"]["argument_size_in_bytes"]:
        raise RuntimeError(f"{tag} {name}: the stand-in count is not the "
                           "slot loop's")
    mesh = _group_mesh(torch, DRYRUN_TRAIN_MESH)
    sh = make_ctx(cfg, mesh, shape) if rules is None else \
        ShardingCtx(mesh, rules, cfg)
    hp = TrainHParams()
    opt = make_optimizer_for(cfg, hp)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    n_params = sum(x.numel() for x in _leaves(params))
    state = init_train_state(None, cfg, opt, params=params, device="cuda",
                             sh=sh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    batches = shard_batch(next(make_batches(cfg, rows, seq, seed=0)), mesh,
                          sh, device="cuda")
    args = (tree_nbytes(state["params"][0]) + tree_nbytes(state["opt"][0])
            + tree_nbytes(batches[0]) + state["step"][0].numel()
            * state["step"][0].element_size())
    step = make_train_step(cfg, opt, hp, sh)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        state, m = step(state, batches)
    torch.cuda.synchronize()
    flops = fc.get_total_flops()
    peak = torch.cuda.max_memory_allocated() - base_mem
    ran = {n: w.launches for n, w in wrappers.items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with count_collectives() as coll:
        ev[0].record()
        (state, m2), sites = sync_sites(torch, step, state, batches)
        ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1])
    losses = [float(m["loss"]), float(m2["loss"])]
    want_flops = round(pred["aten_flops"] * len(state["params"]))
    live = pred["live_peak"] * len(state["params"])
    mem = pred["memory"]
    moe = {k: float(v) for k, v in m.items() if k.startswith("moe")}
    log(f"{tag} {name} ({arch}, {cfg.n_layers} of {base.n_layers} layers, "
        f"{n_params / 1e9:.3f} B params in bf16, {opt.name}, batch {rows} x "
        f"{seq}) on {DRYRUN_TRAIN_MESH} slots (rules: seq_act "
        f"{sh.rules['seq_act']}, experts {sh.rules['experts']}, expert_mlp "
        f"{sh.rules['expert_mlp']}): flops FlopCounterMode {flops} vs meta "
        f"count {want_flops}; slot 0's argument bytes allocated {args} vs "
        f"predicted {mem['argument_size_in_bytes']}; the step's peak "
        f"allocation {peak} B vs the predicted live peak {live:.0f} B over "
        f"the slots (ratio card / predicted {peak / max(live, 1):.4f}); one "
        f"slot alone {stand['live_peak']:.0f} B; predicted per-slot "
        f"peak_hbm {mem['peak_hbm_bytes']} B; meta count {full_s:.2f} s "
        f"(slot loop), {stand_s:.2f} s (stand-in); losses {losses}; MoE "
        f"{moe}; second step {ms:.2f} ms by CUDA events, host syncs "
        f"{len(sites)} ({sorted(set(sites))}), collectives {coll.calls} "
        f"calls, wire bytes "
        f"{ {k: round(v) for k, v in sorted(coll.by_kind.items())} } (all "
        f"slots, {coll.wire:.6g} in all); kernel launches {ran}")
    if flops != want_flops:
        raise RuntimeError(f"{tag} {name}: flops {flops} != meta "
                           f"{want_flops}")
    if args != mem["argument_size_in_bytes"]:
        raise RuntimeError(f"{tag} {name}: argument bytes {args} != "
                           f"{mem['argument_size_in_bytes']}")
    if any(ran.values()):
        raise RuntimeError(f"{tag} {name}: a kernel launched in training "
                           f"({ran})")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{tag} {name}: non-finite loss {losses}")
    del state, batches, step
    gc.collect()
    torch.cuda.empty_cache()


def train_twin(torch, tag, arch, name, rules_of):
    """The f32 twin of a [dryrun] train cell: the config's reduced width in
    f32 (TF32 off), its own optimizer, on DRYRUN_TRAIN_MESH cuda slots
    under the cell's kind of rules (its own; or, for a train_4k cell, a
    cell whose remat stash sets seq_act, TWIN_SEQ_ACT), one step at
    TWIN_BATCH against the solo step from the same weights and batch.
    Held: the loss within TRAIN_GROUP_LOSS_RTOL, the first gradient's
    leaves within TRAIN_GROUP_GRAD_TOL, the params after the step within
    TRAIN_GROUP_PARAM_TOL, every replicated block of the params and the
    optimizer state bit-equal across the slots that hold it, and the MoE
    taking the cell's path (pure EP where the cell's experts are
    padded)."""
    from repro_torch.configs import ShapeSpec, get_reduced_config
    from repro_torch.data import make_batches, shard_batch
    from repro_torch.launch.sharding import make_ctx
    from repro_torch.models import init_params, train_loss
    from repro_torch.models import moe as moe_mod
    from repro_torch.training import (TrainHParams, init_train_state,
                                      make_optimizer_for, make_train_step)
    from repro_torch.training.optimizer import (tree_items, tree_leaves,
                                                tree_map)
    from repro_torch.training.train_step import GroupLayout

    rows, seq = TWIN_BATCH
    cfg = get_reduced_config(arch)
    if arch in TWIN_CAPACITY:
        cfg = cfg.replace(capacity_factor=TWIN_CAPACITY[arch])
    saved = {k: getattr(moe_mod, k) for k in TWIN_EP.get(arch, {})}
    for k, v in TWIN_EP.get(arch, {}).items():
        setattr(moe_mod, k, v)
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    ep = []
    real_ep = moe_mod._apply_moe_ep

    def spy(*a, **k):
        ep.append(1)
        return real_ep(*a, **k)

    try:
        mesh = _group_mesh(torch, DRYRUN_TRAIN_MESH)
        spec = ShapeSpec("twin", seq, rows, "train") if rules_of is None \
            else ShapeSpec("train_seq_act", *TWIN_SEQ_ACT, "train")
        sh = make_ctx(cfg, mesh, spec)
        hp = TrainHParams(learning_rate=3e-4)
        opt = make_optimizer_for(cfg, hp)

        def weights():
            return init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(0), "cuda")

        host = next(make_batches(cfg, rows, seq, seed=0))
        live = tree_map(lambda x: x.requires_grad_(True), weights())
        loss, _ = train_loss(live, cfg, shard_batch(host, device="cuda"))
        solo_grads = dict(zip([p for p, _ in tree_items(live)],
                              torch.autograd.grad(loss, tree_leaves(live))))
        del live
        solo = init_train_state(None, cfg, opt, params=weights(),
                                device="cuda")
        solo, solo_m = make_train_step(cfg, opt, hp)(
            solo, shard_batch(host, device="cuda"))
        lay = GroupLayout(cfg, sh)
        batches = shard_batch(host, mesh, sh, device="cuda")
        moe_mod._apply_moe_ep = spy
        _, _, grads = lay.loss_and_grads(lay.shard(weights()), batches)
        g_worst, g_leaf = _worst_leaf(
            tree_items(lay.unshard(lay.reduce_grads(grads))), solo_grads,
            TRAIN_GROUP_GRAD_TOL)
        state = init_train_state(None, cfg, opt, params=weights(),
                                 device="cuda", sh=sh)
        state, m = make_train_step(cfg, opt, hp, sh)(state, batches)
        moe_mod._apply_moe_ep = real_ep
        rel = abs(float(m["loss"]) - float(solo_m["loss"])) / abs(
            float(solo_m["loss"]))
        worst, where = _worst_leaf(tree_items(lay.unshard(state["params"])),
                                   dict(tree_items(solo["params"])),
                                   TRAIN_GROUP_PARAM_TOL)
        flat = [tree_leaves(t) for t in state["params"]]
        equal = all(torch.equal(flat[s][k], flat[o][k])
                    for k, leaf in enumerate(lay.leaves)
                    for s, o in enumerate(leaf["owners"]) if o != s)
        if opt.replicated_state:
            opts = [tree_leaves(o) for o in state["opt"]]
            equal = equal and all(torch.equal(x, y) for o in opts[1:]
                                  for x, y in zip(o, opts[0]))
        else:
            for which in ("m", "v"):
                trees = [tree_leaves(o[which]) for o in state["opt"]]
                equal = equal and all(
                    torch.equal(trees[s][k], trees[o][k])
                    for k, leaf in enumerate(lay.leaves)
                    for s, o in enumerate(leaf["owners"]) if o != s)
        padded = moe_mod.expert_alloc(cfg.n_experts) != cfg.n_experts
        moe = {k: (float(m[k]), float(solo_m[k])) for k in m
               if k.startswith("moe")}
        log(f"{tag} {name} f32 twin ({cfg.name}, {opt.name}, batch {rows} "
            f"x {seq}, rules seq_act {sh.rules['seq_act']}, experts "
            f"{sh.rules['experts']}, pure EP {bool(ep)}): loss rel diff "
            f"{rel:.3g} (bound {TRAIN_GROUP_LOSS_RTOL}); first gradient: "
            f"worst leaf {g_leaf} at {g_worst:.3g} of its bound "
            f"{TRAIN_GROUP_GRAD_TOL}; params after the step: worst leaf "
            f"{where} at {worst:.3g} of its bound {TRAIN_GROUP_PARAM_TOL}; "
            f"replicas (params and optimizer state) bit-equal: {equal}; "
            f"MoE group / solo {moe}")
        if rel > TRAIN_GROUP_LOSS_RTOL or worst > 1.0 or g_worst > 1.0 \
                or not equal or bool(ep) != padded or \
                (sh.rules["seq_act"] is not None) != (rules_of is not None):
            raise RuntimeError(f"{tag} {name}: the f32 twin's group step "
                               "is not the solo step")
    finally:
        moe_mod._apply_moe_ep = real_ep
        for k, v in saved.items():
            setattr(moe_mod, k, v)
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    gc.collect()
    torch.cuda.empty_cache()


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
    phase_train(torch)
    phase_train_group(torch)
    captured = {}
    serve, paged = {}, {}
    for arch in PATH_KERNELS:
        serve[arch] = phase_serve(torch, arch, captured)
        log(f"[memory] after [serve {arch}]: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        if arch in ("llama3_2_1b", "deepseek_v2_236b",
                    "seamless_m4t_large_v2", "bloom_176b"):
            paged[arch] = phase_serve(torch, arch, captured, layout="paged",
                                      slab=serve[arch])
            log(f"[memory] after [paged {arch}]: "
                f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    phase_oversub(torch)
    phase_sampling(torch, poisson_arrivals(8, rate=2.0, seed=1))
    launches = {arch: r["launches"] for arch, r in serve.items()}
    kernels = phase_kernels(torch, captured, launches)
    for row in kernels:
        if row["path"] in paged:
            base = row["name"].split("_attention")[0] + "_attention"
            run = paged[row["path"]]["launches"]
            row["launches_paged"] = run.get(row["name"], run[base])
    phase_parity(torch)
    for arch in ("rwkv6_7b", "zamba2_7b"):
        phase_parity_family(torch, arch)
    for arch in ("deepseek_v2_236b", "llama4_scout_17b_a16e"):
        phase_parity_moe(torch, arch)
    # seamless: 6 servers of 2 blocks each (routes of an encoder-only hop
    # and a decoder hop, every block on 3 servers); kill the last hop,
    # which hosts decoder blocks (an encoder-only hop does no decode work)
    phase_parity_family(torch, "seamless_m4t_large_v2", n_servers=6,
                        mem=300.0, enc_lens=(5, 13, 5, 40), victim_hop=-1)
    phase_tau(torch)
    phase_tau_bloom(torch)
    phase_xval(torch)
    phase_routing(torch)
    kernels += phase_groups(torch)
    kernels += phase_dryrun(torch)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
