#!/usr/bin/env python3
"""Where the time of the port's chunked scans goes, on the card.

Builds textual variants of ``src/repro_torch/kernels/csrc/{ssd,wkv6}.cu``
with one part of the work removed (so their outputs are wrong: the script
only times them), plus a 1xTF32 variant (one mma per product instead of
three), and times each at the serving path's shape and a long one:

    python3 scripts/scan_ablation.py            # both scans, every variant
    python3 scripts/scan_ablation.py ssd 1x     # one scan, some variants
    python3 scripts/scan_ablation.py plans      # the launch plans' choices

``plans`` times the unchanged kernels under other launch plans instead:
K4 with 1 to 16 heads a block, K3 walked and with parallel chunks.

Each variant is compiled with the build flags of ``kernels/runtime.py``
into ``build/ablation/`` (one nvcc each, all at once) and loaded in place of
the kernel library behind the unchanged wrapper.  Times are device times
(CUDA events around 30 launches behind a busy stream, inputs rotated past
the 50 MB L2, as ``chip_smoke.py`` times).  Each line also prints the
largest difference from the unchanged kernel's output: for ``1x`` that is
the error a single TF32 pass would add.  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import importlib
import math
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ablation"

_ONE_PASS = [  # drop the two small-term passes of every 3xTF32 product
    ("for (int j = 0; j < NT; ++j) mma_tf32(acc[j], a.lo, b[j].hi[0], "
     "b[j].hi[1]);", ""),
    ("for (int j = 0; j < NT; ++j) mma_tf32(acc[j], a.hi, b[j].lo[0], "
     "b[j].lo[1]);", ""),
]
VARIANTS = {
    "ssd": {
        "base": [],
        "1x": _ONE_PASS + [
            ("mma_tf32(gacc[j0 + j], fa.lo, fb[j].hi[0], fb[j].hi[1]);", ";"),
            ("mma_tf32(gacc[j0 + j], fa.hi, fb[j].lo[0], fb[j].lo[1]);", ";")],
        # the intra-chunk product, the chunk-state product, C B^T
        "noY": [("mma3_tiles<NTY>(yacc, fa, fb);", "")],
        "noS": [("for (unsigned m = my_units; m; m &= m - 1) {",
                 "for (unsigned m = 0; m; m &= m - 1) {")],
        "noG": [("if (j0 < g_tiles) {", "if (j0 < 0) {")],
    },
    "wkv6": {
        "base": [],
        "1x": _ONE_PASS,
        # the per-pair diagonal sub-blocks, the sub-block pair products,
        # A v, the state product, the chunk loads
        "noDiag": [("if (e < 120) {", "if (e < 0) {")],
        "noOff": [("for (int job = warp; job < 2 * kPairs; job += kWarps) {",
                   "for (int job = warp; job < 0; job += kWarps) {")],
        "noAv": [("oacc, min(2 * J + 2, kv_steps),", "oacc, 0,")],
        "noState": [("for (int tile = warp; tile < 2 * (HD / 16); "
                     "tile += kWarps) {",
                     "for (int tile = warp; tile < 0; tile += kWarps) {")],
        "noLoad": [("stage_rows(k_s, RS, rows_of(k, 1, c), st.s[1], kQ, nv, "
                    "HD);", ""),
                   ("stage_rows(v_s, VS, rows_of(v, 2, c), st.s[2], kQ, nv, "
                    "HD);", ""),
                   ("      stage_lw(c);\n      if (L::kOut) stage_r(c);", ""),
                   ("        stage_lw(c + 1);", ""),
                   ("        stage_r(c + 1);", "")],
    },
}


def build(names):
    """Compile every (scan, variant) in ``names``; returns their paths."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import runtime

    jobs = {}
    for scan, variant in names:
        src = (runtime.CSRC / f"{scan}.cu").read_text()
        hdr = (runtime.CSRC / "scan_tf32.cuh").read_text()
        for old, new in VARIANTS[scan][variant]:
            if old in src:
                src = src.replace(old, new)
            elif old in hdr:
                hdr = hdr.replace(old, new)
            else:
                raise SystemExit(f"{scan} {variant}: no {old!r} in the "
                                 "source (update the variant)")
        d = OUT / f"{scan}_{variant}"
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(runtime.CSRC / "common.cuh", d)
        (d / "scan_tf32.cuh").write_text(hdr)
        (d / f"{scan}.cu").write_text(src)
        cmd = [runtime._nvcc(), *runtime.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / f"{scan}.cu")]
        jobs[(scan, variant)] = (d / "lib.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for key, (_, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
    return {k: path for k, (path, _) in jobs.items()}


def device_ms(torch, fn, arg_sets, reps=30):
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


def scan_inputs(torch):
    """Makers of seeded K4 and K3 inputs at a given shape, and of enough
    copies of one input set to exceed the L2 cache."""
    g = torch.Generator(device="cuda").manual_seed(1)

    def rn(*shape, scale=0.5):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    def wkv(B, S, H, hd):
        lw = torch.clamp(-torch.exp(rn(B, S, H, hd, scale=1.0) * 0.5 - 1),
                         -5.0, -1e-4)
        return (rn(B, S, H, hd, scale=0.4), rn(B, S, H, hd, scale=0.4),
                rn(B, S, H, hd, scale=0.4), lw, rn(H, hd, scale=0.3))

    def ssd(B, S, H, p, n):
        dt = torch.rand(B, S, H, generator=g, device="cuda") * 0.5 + 0.1
        a = -torch.rand(H, generator=g, device="cuda") - 0.2
        return (rn(B, S, H, p, scale=0.4), rn(B, S, n, scale=0.4),
                rn(B, S, n, scale=0.4), dt, a, rn(H, scale=1.0))

    def copies(args):
        size = sum(t.numel() * t.element_size() for t in args)
        return [[t.clone() for t in args]
                for _ in range(max(2, math.ceil((64 << 20) / size)))]

    return {"ssd": ssd, "wkv6": wkv}, copies


def time_plans(torch):
    """The unchanged kernels under other plans than the wrappers pick."""
    sys.path.insert(0, str(ROOT / "src"))
    sops = importlib.import_module("repro_torch.kernels.ssd.ops")
    wops = importlib.import_module("repro_torch.kernels.wkv6.ops")
    ssd_plan, wkv6_plan = sops.ssd_plan, wops.wkv6_plan
    inputs, copies = scan_inputs(torch)
    try:
        for label, shape in (("path", (8, 115, 112, 64, 64)),
                             ("long", (1, 2048, 112, 64, 64))):
            sets = copies(inputs["ssd"](*shape))
            picked = ssd_plan(*shape).heads_per_block
            for hg in (1, 2, 4, 7, 8, 14):
                sops.ssd_plan = lambda *a, hg=hg: ssd_plan(*a)._replace(
                    heads_per_block=hg)
                ms = device_ms(torch, sops.ssd, sets)
                print(f"ssd   {label} {shape}  {hg:2d} heads/block"
                      f"{' (the plan)' if hg == picked else ''}: {ms:.4f} ms",
                      flush=True)
            sops.ssd_plan = ssd_plan
        for label, shape in (("path", (8, 115, 64, 64)),
                             ("mid", (4, 512, 64, 64)),
                             ("long", (1, 2048, 64, 64))):
            sets = copies(inputs["wkv6"](*shape))
            picked = wkv6_plan(*shape).walk
            for walk in (True, False):  # n_sm 1: always walk; huge: never
                wops.wkv6_plan = lambda *a, w=walk: wkv6_plan(
                    *a[:4], 1 if w else 1 << 30)
                ms = device_ms(torch, wops.wkv6, sets)
                print(f"wkv6  {label} {shape}  "
                      f"{'walked' if walk else 'parallel chunks'}"
                      f"{' (the plan)' if walk == picked else ''}: "
                      f"{ms:.4f} ms", flush=True)
    finally:
        sops.ssd_plan, wops.wkv6_plan = ssd_plan, wkv6_plan
    return 0


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("scan_ablation.py: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if argv == ["plans"]:
        return time_plans(torch)
    scans = [a for a in argv if a in VARIANTS] or list(VARIANTS)
    wanted = [a for a in argv if a not in VARIANTS]
    names = [(s, v) for s in scans for v in VARIANTS[s]
             if v == "base" or not wanted or v in wanted]
    libs = build(names)
    inputs, copies = scan_inputs(torch)
    shapes = {"ssd": [("path (8,115,112,64)", (8, 115, 112, 64, 64)),
                      ("long (1,2048,112,64)", (1, 2048, 112, 64, 64))],
              "wkv6": [("path (8,115,64,64)", (8, 115, 64, 64)),
                       ("long (1,2048,64,64)", (1, 2048, 64, 64))]}
    shapes = {k: [(label, inputs[k](*shape)) for label, shape in v]
              for k, v in shapes.items()}
    base = {}
    for scan, variant in names:
        ops = importlib.import_module(f"repro_torch.kernels.{scan}.ops")
        fn = getattr(ctypes.CDLL(str(libs[(scan, variant)])),
                     f"{scan}_launch")
        P, I = ctypes.c_void_p, ctypes.c_int
        n_ptr, n_int = (11, 6) if scan == "ssd" else (10, 5)
        fn.argtypes = [P] * n_ptr + [I] * n_int + [
            ctypes.POINTER(ctypes.c_longlong), P]
        fn.restype = I
        ops._fn = fn  # the wrapper launches this variant
        call = getattr(ops, scan)
        for label, args in shapes[scan]:
            out = [t.clone() for t in call(*args)]
            if variant == "base":
                base[(scan, label)] = out
            diff = max((a - b).abs().max().item()
                       for a, b in zip(out, base[(scan, label)]))
            ms = device_ms(torch, call, copies(args))
            print(f"{scan:5s} {variant:8s} {label:22s} {ms:.4f} ms   "
                  f"max|out - base out| {diff:.3g}", flush=True)
        ops._fn = None
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
