#!/usr/bin/env python3
"""How far f32 training gradients of a reduced model sit from a float64
evaluation of the same function: the port's ``train_loss`` gradients in
f32 on the CPU and on the card, against the same weights and batch run in
float64 on the CPU, leaf by leaf as max|d| over the leaf's max |f64|.

    python3 scripts/f64_grads.py [--reference] [ARCH ...]  (default: zamba2_7b)

The weights are ``models.init_params`` from a CPU generator seeded 0 and
the batch is ``make_batches(cfg, 2, 32, seed=0)``: the inputs of
``chip_smoke.py``'s card-vs-CPU train check.  ``--reference`` (on a
machine with the JAX reference, CPU only) takes instead the reference's
``init_params(PRNGKey(0))`` weights and a (2, 16) batch, the inputs of
tests/test_torch_train_loss.py, and adds the reference's own f32
gradients (``jax.grad`` of its ``train_loss``).  The float64 run casts the
weights and frames to float64 and, for its duration, makes
``Tensor.float()`` a cast to float64 (the plain path's f32 upcasts);
RoPE angles stay f32.  Prints the five worst leaves by the card's
distance.  Without a CUDA device only the CPU's distance is printed.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def grads(torch, cfg, params, host, device, dtype):
    from repro_torch.data import shard_batch
    from repro_torch.models import train_loss
    from repro_torch.models.model import tree_map
    from repro_torch.training.optimizer import tree_leaves

    live = tree_map(lambda x: x.to(device, dtype, copy=True)
                    .requires_grad_(True), params)
    batch = {k: (v.to(dtype) if v.is_floating_point() else v)
             for k, v in shard_batch(host, device=device).items()}
    loss, _ = train_loss(live, cfg, batch)
    out = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                              materialize_grads=True)
    return float(loss.detach()), [g.detach().cpu().double() for g in out]


def reference_inputs(arch):
    """(the reference's weights bridged to the port, the (2, 16) batch,
    (the reference's f32 loss, its gradients in ``tree_items`` order))."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get_reduced_config
    from repro.data import make_batches
    from repro.models import NULL_SH, init_params
    from repro.models.model import train_loss
    from repro_torch.training.optimizer import tree_items
    from repro_torch.weights import from_reference

    cfg = get_reduced_config(arch)
    params, _ = init_params(jax.random.PRNGKey(0), cfg)
    host = next(make_batches(cfg, 2, 16, seed=0))
    loss, g = jax.value_and_grad(lambda p: train_loss(
        p, cfg, NULL_SH, {k: jnp.asarray(v) for k, v in host.items()})[0])(
            params)
    leaves = [torch.from_numpy(np.array(x, np.float64))
              for _, x in tree_items(jax.tree.map(np.asarray, g))]
    return (from_reference(jax.tree.map(np.asarray, params), "cpu"), host,
            (float(loss), leaves))


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs import get_reduced_config
    from repro_torch.data import make_batches
    from repro_torch.models import init_params
    from repro_torch.models import layers
    from repro_torch.training.optimizer import tree_items

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = sys.argv[1:]
    reference = "--reference" in args
    args = [a for a in args if a != "--reference"]
    card = torch.cuda.is_available() and not reference
    for arch in args or ["zamba2_7b"]:
        cfg = get_reduced_config(arch)
        if reference:
            params, host, ref = reference_inputs(arch)
        else:
            params = init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
            host = next(make_batches(cfg, 2, 32, seed=0))
        runs = {"cpu": grads(torch, cfg, params, host, "cpu",
                             torch.float32)}
        if reference:
            runs["reference"] = ref
        if card:
            runs["card"] = grads(torch, cfg, params, host, "cuda",
                                 torch.float32)
        as_f32 = torch.Tensor.float
        layers._DTYPES["float64"] = torch.float64
        torch.Tensor.float = lambda self, *a, **k: self.double()
        try:
            cfg64 = cfg.replace(param_dtype="float64", act_dtype="float64")
            loss64, g64 = grads(torch, cfg64, params, host, "cpu",
                                torch.float64)
        finally:
            torch.Tensor.float = as_f32
            del layers._DTYPES["float64"]
        paths = [".".join(p) for p, _ in tree_items(params)]
        rows = []
        for i, (path, t) in enumerate(zip(paths, g64)):
            scale = float(t.abs().max()) if t.numel() else 0.0
            if scale == 0.0:
                continue
            dist = {k: float((v[1][i] - t).abs().max()) / scale
                    for k, v in runs.items()}
            rows.append((max(dist.values()), dist, path))
        rows.sort(reverse=True)
        print(f"[f64 {arch}] loss f64 {loss64!r}, "
              + ", ".join(f"{k} f32 {v[0]!r}" for k, v in runs.items()))
        worst = {k: max(r[1][k] for r in rows) for k in runs}
        print(f"[f64 {arch}] worst leaf distance from f64 (max|d| / max|f64|"
              "): " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
        other = "card" if card else "reference" if reference else None
        if other:
            diff = max(float((a - b).abs().max()) / max(
                float(t.abs().max()), 1e-30) for a, b, t in zip(
                    runs[other][1], runs["cpu"][1], g64) if t.numel())
            print(f"[f64 {arch}] {other} vs CPU f32, worst leaf: "
                  f"{diff:.3g}")
        for _, dist, path in rows[:5]:
            print(f"[f64 {arch}]   {path}: " + ", ".join(
                f"{k} {v:.3g}" for k, v in dist.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
