"""The readings a cell's correctness limit is set from, on the chip, in one
process: for each seed, one run of the cell through the harness
(``run.run_cell``) with the control in the program's place, judged by the
harness's own comparison (``check.judge``), which comes out not correct.
Beside it each row gives the program's own widest gap over the same
requests, as a sound run's check reads it.

The control is the plain reference computed one precision below the
configuration's bf16: every matrix rounded through float8_e4m3fn (one
scale per tensor).  The benchmark's own runs never run it.

    python3 bench/control.py --workload <cell> --seconds <s> --seeds a b c ...
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


def readings(cell: str, seeds, seconds: float, device: str = "cuda",
             config=None, traffic=None, cell_file=None):
    """[{seed, correct, served, program, program_flips, control,
    control_flips, limit, s}] for each seed."""
    import harness
    import run

    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        res = run.run_cell(cell, seed, seconds, False, device=device,
                           spec=spec, config=config, traffic=traffic,
                           cell_file=cell_file, control=True)
        d, gap = res["_detail"], res["checks"]["widest_gap"]
        row = {"seed": seed, "correct": res["correct"],
               "served": d["served_tokens"], "program": d["program_gap"],
               "program_flips": d["program_flips"], "control": gap["value"],
               "control_flips": d["control_flips"], "limit": gap["limit"],
               "s": time.perf_counter() - t0}
        out.append(row)
        print(json.dumps(row), flush=True)
        del res
        harness.free()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    rows = readings(args.workload, args.seeds, args.seconds)
    print(json.dumps({"workload": args.workload,
                      "program_max": max(r["program"] for r in rows),
                      "control_min": min(r["control"] for r in rows),
                      "control_correct": [r["correct"] for r in rows]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
