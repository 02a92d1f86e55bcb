"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one run of one
cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``bench/configs/<name>.json``) and a traffic mix
(``bench/traffic/<name>.json``); its metrics are the readers under
``bench/metrics/`` named in ``BENCHMARK.json``; its pool rows and its
correctness limits are ``bench/cells/<cell>.json``.  The last line on
standard output is the result as one JSON object; the numbers that decided
``correct`` close standard error.  Exits 1 without a result when there is
no CUDA card, too few of them, or when JAX or the JAX package was
loaded.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]
# third-party libraries load no JAX on the port's behalf
os.environ.setdefault("USE_FLAX", "0")
# load from one process with few threads: the port's host loop runs on the
# main thread, and no CPU op of it needs a pool of workers
os.environ.setdefault("OMP_NUM_THREADS", "1")
# the port's nvcc builds: one fixed directory inside the checkout, so only
# a checkout's first run builds
os.environ.setdefault("REPRO_TORCH_BUILD_DIR", str(ROOT / "build" / "kernels"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def loaded_forbidden() -> list:
    """Top-level module names in ``sys.modules`` that the port's runs may
    not load, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def refuse_forbidden(when: str) -> None:
    found = loaded_forbidden()
    if found:
        raise RuntimeError(f"the run loaded {found} by {when}: the port's "
                           "benchmark loads neither JAX nor the JAX package")


def cell_spec(name: str, spec: dict) -> dict:
    for wl in spec["workloads"]:
        if wl["name"] == name:
            return wl
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(cell: str, spec: dict, trace: bool) -> list:
    """The cell's metrics: with ``--trace 0`` its end-to-end ones, with
    ``--trace 1`` its per-layer ones (a metric without ``workloads`` is
    every cell's)."""
    pool = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in pool if cell in m.get("workloads", [cell])]


def read_metric(name: str, w):
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(w)


@contextlib.contextmanager
def steady_host():
    """Around the trace: the set-up's objects (the weights' and pools'
    wrappers, the queued trace) collected once and moved out of the
    collector's way, so the window's collections walk only what the
    serving allocates.  The host thread is left to the OS scheduler: a
    core fixed in code is one that another process on the host may hold."""
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def load_cell(cell: str) -> dict:
    return json.loads((HERE / "cells" / f"{cell}.json").read_text())


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", spec: dict = None, config: dict = None,
             traffic: dict = None, cell_file: dict = None,
             control: bool = False) -> dict:
    """One run of ``cell``; returns the result object.  ``config`` /
    ``traffic`` / ``cell_file`` override the cell's files (the CPU tests
    run a reduced configuration this way); ``control`` judges the control
    in the program's place (``bench/control.py`` alone sets it)."""
    import torch

    import check
    import harness
    import traffic as traffic_mod

    t_start = T_START
    spec = spec or json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = cell_spec(cell, spec)
    c = config or harness.load_config(wl["config"])
    t = traffic or traffic_mod.load(wl["traffic"])
    cf = cell_file or load_cell(cell)
    rows, limits = int(cf["rows"]), cf["limits"]
    n = harness.dims(c)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    phases = {"start": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    weights = harness.make_weights(c, seed, dev)
    harness.sync(dev)
    phases["weights"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    system = harness.build_system(c, t, rows, weights, dev)
    phases["build"] = time.perf_counter() - t0
    log(f"[bench] {cell}: placement a={system.placement.a.tolist()} "
        f"m={system.placement.m.tolist()}, {rows} rows a server, "
        f"max_seq_len {system.max_seq_len}")
    t0 = time.perf_counter()
    buckets = harness.warm_up(system, t, n["vocab"], dev)
    phases["warm_up"] = time.perf_counter() - t0
    requests = traffic_mod.generate(t, seed, n["vocab"], rows)
    w = harness.Window(dims=n, rows=rows,
                       open_after=int(t["open_after_rounds"]),
                       seconds=float(seconds))
    w.setup_s = time.perf_counter() - t_start
    log(f"[bench] set-up {w.setup_s:.3f} s (warm buckets {buckets}): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()))

    calls = harness.KernelCalls() if trace else None
    dtrace = None
    if trace:
        import devtrace as trace_mod
        dtrace = trace_mod.DeviceTrace()

    def on_open():
        if trace:
            dtrace.start()
            calls.active = True

    if calls is not None:
        calls.__enter__()
    try:
        with steady_host():
            sched = harness.drive(system, t, requests, w, dev,
                                  on_open=on_open)
    finally:
        if calls is not None:
            calls.__exit__()
    if trace:
        dtrace.stop(w.t_open, w.t_close)
        w.device = dtrace
        w.k1, w.k2 = calls.costs()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    refuse_forbidden("the window's close")
    # attempted: the requests admitted to rows; failed: those the engine
    # dropped or failed (a request still queued is neither)
    attempted = len(w.admitted)
    failed = sum(1 for r in sched.results.values() if r.dropped) + sum(
        1 for sid in w.admitted if sid in system.sessions
        and system.sessions[sid].state == "failed")

    metrics = {}
    for m in metrics_of(cell, spec, trace):
        v = read_metric(m["name"], w)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the program's state goes before the reference runs; the weights are
    # the benchmark's own and stay
    log(f"[bench] fill {w.t_open - t_start - w.setup_s:.3f} s, window "
        f"{w.wall:.3f} s ({w.n_rounds} rounds in all)")
    del system, calls, sched
    harness.free()  # the program's pools and buffers
    t0 = time.perf_counter()
    ok, numbers, detail = check.judge(w, weights, c,
                                      int(t["check_requests"]), seed,
                                      limits, control=control)
    log(f"[bench] reference check {time.perf_counter() - t0:.3f} s")
    ok = ok and failed == 0
    numbers["failed_requests"] = {"value": failed, "limit": 0}
    result = {"correct": bool(ok), "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(0)
                                  if dev.type == "cuda" else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"]["busy_s"] = dtrace.busy_s()
        result["device"]["window_s"] = dtrace.window_s()
        result["breakdown"] = {"device_ops": dtrace.top_ops(),
                               "idle_gaps": dtrace.idle_gaps(w.spans)}
    result["checks"] = numbers
    result["_detail"] = detail
    # the readers and the reference load modules of their own
    refuse_forbidden("the end of the check")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = cell_spec(args.workload, spec)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[bench] needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            ": no result")
        return 1
    torch.set_num_threads(1)
    log(f"[bench] torch {torch.__version__}")
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), spec=spec)
    except RuntimeError as e:
        log(f"[bench] run failed: {e}")
        return 1
    log(f"[bench] {card_line()}")
    detail = result.pop("_detail")
    log(f"[bench] checked {detail.get('served_tokens', 0)} served tokens; "
        f"gaps per request {detail.get('gaps')}")
    for name, x in result["checks"].items():
        log(f"[check] {name} {x['value']} limit {x['limit']}")
    try:
        refuse_forbidden("the result")
    except RuntimeError as e:
        log(f"[bench] run failed: {e}")
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
