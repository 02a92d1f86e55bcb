#!/usr/bin/env python3
"""Run the slab serve phases of one checkout's ``chip_smoke.py`` alone:
full-width Llama-3.2-1B, RWKV6-7B and Zamba2-7B (or the ``ARCH`` names
given), each through the port's scheduler with the round walls, host
syncs and tokens/s it prints.

    python3 scripts/serve_phases.py CHECKOUT [ARCH ...]

``CHECKOUT`` is the root of a checkout (this repository's, or another
commit's unpacked with ``git archive``); its own ``chip_smoke.py`` and
``src/`` are used, and its kernels are built into its ``build/kernels``.
To compare two commits on one card, run them in turns in one command,
one process each (parent, change, change, parent, ...): host-clock round
walls spread widely between runs of one tree.  Needs a CUDA device and
nvcc.
"""
import importlib.util
import sys
from pathlib import Path


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(sys.argv[1]).resolve()
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        print("serve_phases.py: no CUDA device", file=sys.stderr)
        return 2
    smoke.phase_build()
    for arch in sys.argv[2:] or ("llama3_2_1b", "rwkv6_7b", "zamba2_7b"):
        smoke.phase_serve(torch, arch, {})
    return 0


if __name__ == "__main__":
    sys.exit(main())
