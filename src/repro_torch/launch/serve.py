"""Serving launcher: geo-distributed BPRR serving of one architecture on the
port — the counterpart of the reference's ``repro/launch/serve.py`` (the
same cluster, prompts and printed lines).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2_1b \\
        --requests 4 --algorithm proposed [--device cpu] [--width full]

Weights are random from a seeded ``torch.Generator`` (``--width full``: the
published widths in their bf16 param dtype).  It runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--algorithm", default="proposed",
                    choices=["proposed", "petals"])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--servers", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", default="reduced", choices=["reduced", "full"])
    return ap.parse_args(argv)


def run(args: argparse.Namespace, params=None) -> List[str]:
    """Serve ``args.requests`` prompts; returns the printed lines.
    ``params``: the model's weights on ``args.device`` (default: random
    from a seeded generator)."""
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.core import LLMSpec, Problem, ServerSpec, Workload
    from repro_torch.models import init_params
    from repro_torch.serving import GeoServingSystem, generate

    cfg = (get_reduced_config if args.width == "reduced"
           else get_config)(args.arch)
    if params is None:
        params = init_params(
            cfg, torch.Generator(device=args.device).manual_seed(0),
            args.device)
    llm = LLMSpec(cfg.name, cfg.n_layers, block_bytes=50.0,
                  cache_bytes_per_token=0.5)
    rng = np.random.RandomState(0)
    servers = [ServerSpec(j, mem_bytes=50.0 * cfg.n_layers * 2,
                          tau=0.005 * (1 + j % 3))
               for j in range(args.servers)]
    rtt = 0.01 + 0.02 * rng.rand(1, args.servers)
    problem = Problem(llm, servers, 1, rtt, 3 * rtt,
                      workload=Workload(8, args.new_tokens))
    system = GeoServingSystem(cfg, params, problem,
                              algorithm=args.algorithm,
                              max_new_tokens=args.new_tokens + 4,
                              device=args.device)
    lines = [f"{args.algorithm} placement: a={system.placement.a} "
             f"m={system.placement.m}"]
    for r in range(args.requests):
        toks = rng.randint(2, cfg.vocab_size, 8)
        out, vt = generate(system, toks, args.new_tokens)
        lines.append(f"req {r}: virtual {vt:.3f}s  tokens {out[8:8+6]}...")
    return lines


def main(argv: Optional[Sequence[str]] = None):
    for line in run(parse_args(argv)):
        print(line, flush=True)


if __name__ == "__main__":
    main()
