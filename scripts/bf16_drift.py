#!/usr/bin/env python3
"""Whose arithmetic makes a bf16 model's first step drift from f32 (ROADMAP
C5): the reference's or the port's.  On the CPU, with the JAX reference
installed, for each reduced config cast to bf16:

* ref bf16 - ref f32:   the reference's own drift (its bf16 ``prefill``
                        against the same weights upcast to f32);
* port bf16 - port f32: the port's drift (``prefill`` on the plain
                        versions against ``upcast_prefill_logits``);
* port bf16 - ref bf16: how far the port's bf16 arithmetic sits from the
                        reference's;
* port f32 - ref f32:   the same in f32 (the parity tests' gap),

each as max|diff| over the f32 logit scale, on the last position of a
24-token prompt; with ``--prompts N``, the largest of N prompts (seeds 1
to N) in each column (the scale column: the last prompt's).  The weights are the reference's
``init_params(PRNGKey(0))`` in bf16, bridged bit for bit.

    PYTHONPATH=src python3 scripts/bf16_drift.py [--prompts N] [ARCH ...]
        (default: one prompt, every reduced decoder-only config)
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT = ("llama3_2_1b", "gemma3_4b", "bloom_176b", "qwen2_5_32b",
           "olmo_1b", "chameleon_34b", "rwkv6_7b", "zamba2_7b",
           "deepseek_v2_236b", "llama4_scout_17b_a16e")


def main(argv) -> int:
    n_prompts = 1
    if argv[:1] == ["--prompts"]:
        n_prompts, argv = int(argv[1]), argv[2:]
    archs = argv or DEFAULT
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get_reduced_config
    from repro.models import NULL_SH, init_params
    from repro.models import prefill as r_prefill
    from repro_torch.configs import get_reduced_config as t_reduced
    from repro_torch.models import prefill, upcast_prefill_logits
    from repro_torch.weights import from_reference

    bf16 = dict(param_dtype="bfloat16", act_dtype="bfloat16")
    f32 = dict(param_dtype="float32", act_dtype="float32")
    print(f"{'arch':24s} {'f32 scale':>9s} {'ref bf16-f32':>13s} "
          f"{'port bf16-f32':>14s} {'port-ref bf16':>14s} "
          f"{'port-ref f32':>13s}")
    for arch in archs:
        cfg = get_reduced_config(arch).replace(**bf16)
        tcfg = t_reduced(arch).replace(**bf16)
        params, _ = init_params(jax.random.PRNGKey(0), cfg)
        up = jax.tree.map(lambda x: x.astype(jnp.float32)
                          if x.dtype == jnp.bfloat16 else x, params)
        tparams = from_reference(jax.tree.map(np.asarray, params), "cpu")
        live = slice(0, cfg.vocab_size)
        worst = [0.0] * 4
        for seed in range(1, n_prompts + 1):
            toks = np.random.RandomState(seed).randint(2, cfg.vocab_size,
                                                       (1, 24))
            batch = {"tokens": jnp.asarray(toks)}
            ref_b = np.asarray(r_prefill(params, cfg, NULL_SH, batch)[0][0],
                               np.float32)
            ref_f = np.asarray(r_prefill(up, cfg.replace(**f32), NULL_SH,
                                         batch)[0][0])
            tbatch = {"tokens": torch.from_numpy(toks)}
            port_b = prefill(tparams, tcfg, tbatch, backend="plain")[0][0] \
                .float().numpy()
            port_f = upcast_prefill_logits(tparams, tcfg, tbatch)[0].numpy()
            scale = float(np.abs(ref_f[live]).max())
            pairs = ((ref_b, ref_f), (port_b, port_f), (port_b, ref_b),
                     (port_f, ref_f))
            worst = [max(w, float(np.abs(a[live] - b[live]).max()) / scale)
                     for w, (a, b) in zip(worst, pairs)]
        print(f"{arch:24s} {scale:9.4g} {worst[0]:13.4g} {worst[1]:14.4g} "
              f"{worst[2]:14.4g} {worst[3]:13.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
