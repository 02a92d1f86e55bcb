"""Training launcher — the counterpart of the reference's
``repro/launch/train.py`` (the same flags, defaults and printed lines).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \\
        --reduced --steps 30 [--device cpu]

It trains on the card unless ``--device cpu`` is given, from random weights
drawn from a seeded ``torch.Generator``, at the config's param dtype
unless ``--dtype`` names another.  The reference's XLA flag block has no
counterpart.  ``--model-parallel k`` trains over a device group, as the
reference does: ``make_ctx(cfg, make_mesh_for(model_parallel=k),
SHAPES_BY_NAME["train_4k"])`` — the cards present (``ValueError`` with
too few), or with ``--device cpu`` k CPU slots; ``run(mesh=)`` takes an
explicit mesh (e.g. repeated slots of one card).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="param and activation dtype (default: the "
                    "config's)")
    return ap.parse_args(argv)


@dataclass
class TrainRun:
    """What a launcher run leaves: the final state, the step function, the
    config, each step's metrics (device tensors) and the printed lines."""
    state: dict
    step_fn: Callable
    cfg: object
    metrics: List[dict] = field(default_factory=list)
    lines: List[str] = field(default_factory=list)


def run(args: argparse.Namespace, params=None,
        step_hook: Optional[Callable] = None, mesh=None) -> TrainRun:
    """Train ``args.steps`` steps.  ``params``: the model's weights on
    ``args.device`` (default: random from a seeded generator).
    ``step_hook(step_fn, state, batch)``, when given, takes each step in
    place of ``step_fn(state, batch)`` (to time or inspect it).  ``mesh``
    (a ``launch.mesh.GroupMesh``): train over that group, whatever
    ``--model-parallel`` says; the state is then the group's."""
    from repro_torch.configs import (SHAPES_BY_NAME, get_config,
                                     get_reduced_config)
    from repro_torch.data import make_batches, shard_batch
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.sharding import make_ctx
    from repro_torch.training import (TrainHParams, checkpoint,
                                      init_train_state, make_optimizer_for,
                                      make_train_step)

    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    if args.dtype:
        cfg = cfg.replace(param_dtype=args.dtype, act_dtype=args.dtype)
    if mesh is None and args.model_parallel > 1:
        devices = ([torch.device("cpu")] * args.model_parallel
                   if torch.device(args.device).type == "cpu" else None)
        mesh = make_mesh_for(model_parallel=args.model_parallel,
                             devices=devices)
    sh = None if mesh is None else \
        make_ctx(cfg, mesh, SHAPES_BY_NAME["train_4k"])
    hp = TrainHParams(learning_rate=args.lr, grad_accum=args.grad_accum)
    opt = make_optimizer_for(cfg, hp)
    gen = (None if params is not None
           else torch.Generator(device=args.device).manual_seed(0))
    state = init_train_state(gen, cfg, opt, params=params,
                             device=args.device, sh=sh)
    step_fn = make_train_step(cfg, opt, hp, sh)
    out = TrainRun(state, step_fn, cfg)

    def say(line):
        print(line, flush=True)
        out.lines.append(line)

    start = 0
    if args.ckpt and checkpoint.latest_step(args.ckpt):
        state, start = checkpoint.restore(args.ckpt, state, sh=sh)
        say(f"resumed at step {start}")
    batches = make_batches(cfg, args.batch, args.seq, seed=0,
                           start_step=start)
    t0 = time.time()
    for i in range(start, args.steps):
        batch = shard_batch(next(batches), mesh, sh, device=args.device)
        if step_hook is None:
            state, metrics = step_fn(state, batch)
        else:
            state, metrics = step_hook(step_fn, state, batch)
        out.metrics.append(metrics)
        if (i + 1) % 5 == 0:
            say(f"step {i+1} loss {float(metrics['loss']):.4f} "
                f"({(time.time()-t0)/5:.2f}s/step)")
            t0 = time.time()
        if args.ckpt and (i + 1) % 20 == 0:
            checkpoint.save(args.ckpt, i + 1, state, sh=sh)
    out.state = state
    say("done")
    return out


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
