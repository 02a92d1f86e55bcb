#!/usr/bin/env python3
"""Where a full-width training step's time goes on the card: Llama-3.2-1B
at all 16 layers, AdamW with remat, (B 8, S 128), through the port's
train step (``repro_torch.training``), random weights from seed 0.

    python3 scripts/train_profile.py

For each of f32 with TF32 off (the reference's arithmetic), f32 with
TF32 matmuls and bf16 params: the median step time by CUDA events over 5
steps after 2 warm-up steps, then one step under ``torch.profiler``:
device time summed by kind (GEMMs, the optimizer's and the clip's
elementwise passes, other elementwise kernels, reductions, copies), the
top kernels, and the device's idle share of the step's wall.  Prints the
card's name and power limit.  Needs a CUDA device.
"""
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

KINDS = (("gemm", ("gemm", "sgemm", "cutlass", "xmma", "ampere", "sm90",
                   "cublas", "nvjet")),
         ("reduce", ("reduce", "norm")),
         ("copy", ("copy", "memcpy", "memset", "fill")),
         ("elementwise", ("elementwise", "vectorized", "unrolled")))


def kind(name: str) -> str:
    low = name.lower()
    for k, keys in KINDS:
        if any(x in low for x in keys):
            return k
    return "other"


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import make_batches, shard_batch
    from repro_torch.training import (TrainHParams, init_train_state,
                                      make_optimizer_for, make_train_step)

    if not torch.cuda.is_available():
        print("train_profile.py: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[profile] {smi}; torch {torch.__version__}", flush=True)
    for label, dtype, tf32 in (("f32", "float32", False),
                               ("f32+tf32", "float32", True),
                               ("bf16", "bfloat16", False)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        cfg = get_config("llama3_2_1b").replace(param_dtype=dtype,
                                                act_dtype=dtype)
        hp = TrainHParams(learning_rate=3e-4)
        opt = make_optimizer_for(cfg, hp)
        state = init_train_state(
            torch.Generator(device="cuda").manual_seed(0), cfg, opt)
        step = make_train_step(cfg, opt, hp)
        feed = make_batches(cfg, 8, 128, seed=0)
        ms = []
        for i in range(7):
            batch = shard_batch(next(feed), device="cuda")
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, _ = step(state, batch)
            ev[1].record()
            torch.cuda.synchronize()
            if i >= 2:
                ms.append(ev[0].elapsed_time(ev[1]))
        batch = shard_batch(next(feed), device="cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = step(state, batch)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type.name == "CUDA" and e.device_time > 0]
        busy = sum(e.device_time for e in kernels) / 1e3
        if kernels:
            t0 = min(e.time_range.start for e in kernels)
            t1 = max(e.time_range.end for e in kernels)
            span = (t1 - t0) / 1e3
        else:
            span = float("nan")
        by_kind = {}
        for e in kernels:
            k = kind(e.name)
            by_kind[k] = by_kind.get(k, 0.0) + e.device_time / 1e3
        print(f"[profile {label}] median step {statistics.median(ms):.2f} ms"
              f" (steps {[round(x, 2) for x in ms]}); profiled step: "
              f"{len(kernels)} kernels, {busy:.2f} ms busy over a "
              f"{span:.2f} ms span, idle share {1 - busy / span:.3f}; by "
              "kind (ms): " + ", ".join(
                  f"{k} {v:.2f}" for k, v in sorted(
                      by_kind.items(), key=lambda kv: -kv[1])), flush=True)
        top = {}
        for e in kernels:
            top[e.name] = top.get(e.name, 0.0) + e.device_time / 1e3
        for name, t in sorted(top.items(), key=lambda kv: -kv[1])[:8]:
            print(f"[profile {label}]   {t:8.2f} ms  {name[:110]}")
        del state, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
