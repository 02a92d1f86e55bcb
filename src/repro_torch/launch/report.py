"""Render the port's dry-run artifacts (``launch.dryrun``) into roofline
tables: the reference's ``repro/launch/report.py`` without its tpu-est
columns (the port counts its own ops in their own dtypes), the fit read
against the H100's 80 GB.  In their place, the memory column gives in
brackets the part of the bytes the slot collectives' own ops move (a
group's sums on one device; ``launch.costs.StepCount``).  Every time is a
roofline bound at the H100 SXM data sheet's rates, per slot, not a
measurement.

    PYTHONPATH=src python -m repro_torch.launch.report experiments/dryrun_torch
"""
from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.launch.costs import HBM_BW

SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
               "long_500k": 3}


def load(dirpath="experiments/dryrun_torch"):
    rows = []
    for p in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(p) as f:
            rows.append(json.load(f))
    return rows


def fmt_ms(x):
    """Milliseconds to three significant digits, whole ones from 100 on
    (decode cells' terms sit far below a millisecond)."""
    ms = x * 1e3
    return f"{ms:.0f}" if ms >= 100 else f"{ms:.3g}"


def markdown_table(rows, mesh="16x16"):
    out = ["| arch | shape | compute ms | memory ms (collective ops)"
           " | collective ms"
           " | dominant | useful FLOPs | peak HBM GB | fits 80 GB"
           " | count s |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    sel = [r for r in rows if r["mesh"] == mesh]
    sel.sort(key=lambda r: (r["arch"], SHAPE_ORDER.get(r["shape"], 9)))
    for r in sel:
        t = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_ms(t['compute_s'])} | "
            f"{fmt_ms(t['memory_s'])} "
            f"({fmt_ms(r['collective_bytes'] / HBM_BW)}) | "
            f"{fmt_ms(t['collective_s'])} | "
            f"{t['dominant']} | {r['useful_flops_ratio']:.2f} | "
            f"{r['memory']['peak_hbm_bytes']/1e9:.1f} | "
            f"{'Y' if r['fits_hbm_80g'] else 'N'} | "
            f"{r['count_seconds']} |")
    return "\n".join(out)


def paired_table(rows):
    """One row per (arch, shape) with the single-pod and multi-pod cells
    side by side ("16x16 / 2x16x16" in every column)."""
    cells = {}
    for r in rows:
        cells.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r

    def both(fn):
        return " / ".join(fn(c[m]) if m in c else "—"
                          for m in ("16x16", "2x16x16"))

    out = ["| arch | shape | compute ms | memory ms (collective ops)"
           " | collective ms | dominant | useful FLOPs | peak HBM GB"
           " | fits 80 GB | count s |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape), c in sorted(
            cells.items(),
            key=lambda kv: (kv[0][0], SHAPE_ORDER.get(kv[0][1], 9))):
        out.append(" | ".join([
            f"| {arch}", shape,
            both(lambda r: fmt_ms(r["roofline"]["compute_s"])),
            both(lambda r: f"{fmt_ms(r['roofline']['memory_s'])} "
                           f"({fmt_ms(r['collective_bytes'] / HBM_BW)})"),
            both(lambda r: fmt_ms(r["roofline"]["collective_s"])),
            both(lambda r: r["roofline"]["dominant"]),
            both(lambda r: f"{r['useful_flops_ratio']:.2f}"),
            both(lambda r: f"{r['memory']['peak_hbm_bytes']/1e9:.1f}"),
            both(lambda r: "Y" if r["fits_hbm_80g"] else "N"),
            both(lambda r: str(r["count_seconds"]))]) + " |")
    return "\n".join(out)


def summary(rows):
    worst = sorted(
        (r for r in rows if r["mesh"] == "16x16"
         and r["roofline"]["bound_s"] > 0),
        key=lambda r: r["roofline"]["compute_s"] / r["roofline"]["bound_s"])
    coll = sorted(
        (r for r in rows if r["mesh"] == "16x16"),
        key=lambda r: -r["roofline"]["collective_s"])
    lines = ["worst roofline fraction (single-pod):"]
    for r in worst[:5]:
        t = r["roofline"]
        lines.append(f"  {r['arch']}/{r['shape']}: "
                     f"compute/bound={t['compute_s']/t['bound_s']:.3f} "
                     f"dominant={t['dominant']}")
    lines.append("most collective-bound:")
    for r in coll[:5]:
        lines.append(f"  {r['arch']}/{r['shape']}: "
                     f"coll={r['roofline']['collective_s']*1e3:.0f}ms "
                     f"compute={r['roofline']['compute_s']*1e3:.0f}ms")
    return "\n".join(lines)


if __name__ == "__main__":
    rows = load(sys.argv[1] if len(sys.argv) > 1 else
                "experiments/dryrun_torch")
    print(f"{len(rows)} artifacts\n")
    print("## single-pod 16x16\n")
    print(markdown_table(rows, "16x16"))
    print("\n## multi-pod 2x16x16\n")
    print(markdown_table(rows, "2x16x16"))
    print("\n## both meshes (16x16 / 2x16x16)\n")
    print(paired_table(rows))
    print()
    print(summary(rows))
