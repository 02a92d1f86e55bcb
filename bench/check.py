"""How a run's ``correct`` is decided: a sample of the requests the window
finished (their last token inside it), drawn from the seed with the
longest among them, is run once through the plain float32 reference
(``bench/reference``) over each prompt and its served tokens.  A served
token's first token came from the pooled prefill step (K2 and the cache
writes), the rest from fused decode rounds through the cache pools (K1).
The number compared is the widest gap by which a served token's reference
logit lies below the reference's best at that position; the cell's limit
is in ``bench/cells/<cell>.json``."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def sample(w, n: int, seed: int) -> List:
    """Up to ``n`` sessions that finished inside the window: the longest
    (prompt + output), then others drawn from the seed."""
    done = sorted((s for s in w.sessions.values()
                   if s.complete and w.inside(s.times[-1])),
                  key=lambda s: (len(s.prompt) + len(s.tokens), s.prompt))
    if not done:
        return []
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    rest = done[:-1]
    pick = [rest[i] for i in sorted(rng.choice(len(rest), min(n - 1,
                                                             len(rest)),
                                               replace=False))] if rest \
        else []
    return [done[-1]] + pick


def gaps(ref_logits: List[torch.Tensor], served: List[List[int]],
         chooser: List[torch.Tensor] = None) -> List[float]:
    """Per sequence, the widest gap between the reference's best logit and
    its logit of the token chosen at each position: the served token, or
    (``chooser``) the argmax of another set of logits at that position."""
    out = []
    for i, (lg, toks) in enumerate(zip(ref_logits, served)):
        t = torch.as_tensor(toks, device=lg.device) if chooser is None \
            else chooser[i].argmax(-1)
        best = lg.max(-1).values
        got = lg.gather(-1, t.reshape(-1, 1))[:, 0]
        out.append(float((best - got).max()))
    return out


def flips(ref_logits: List[torch.Tensor], chosen: List[List[int]]) -> float:
    """The share of positions whose chosen token is not the reference's
    best."""
    n = sum(len(c) for c in chosen)
    bad = sum(int((lg.argmax(-1).cpu() != torch.as_tensor(c)).sum())
              for lg, c in zip(ref_logits, chosen))
    return bad / max(n, 1)


def judge(w, weights, c: Dict, n_check: int, seed: int,
          limits: Dict[str, float], control: bool = False
          ) -> Tuple[bool, Dict[str, Dict], Dict]:
    """(correct, {number: {value, limit}}, detail).

    ``control`` puts the control in the program's place (``bench/
    control.py``; the benchmark's runs never do): the reference with every
    matrix rounded through float8_e4m3fn, one precision below the
    configurations' bf16, picks its own best token at each position of the
    same prompts and served tokens, and the widest gap judged is that of
    its picks.  The program's own reading stays in ``detail``."""
    import reference.common as ref

    picked = sample(w, n_check, seed)
    vocab = c["vocab_size"]
    bad_tokens = sum(1 for s in w.sessions.values() for t in s.tokens
                     if not 0 <= t < vocab)
    numbers = {"finished_checked": {"value": len(picked), "limit": 1},
               "tokens_outside_vocab": {"value": bad_tokens, "limit": 0}}
    if not picked:
        return False, numbers, {}
    seqs = [s.prompt + s.tokens for s in picked]
    firsts = [len(s.prompt) for s in picked]
    lg = ref.run(weights, c, seqs, firsts, cast="f32")
    served = [s.tokens for s in picked]
    g = gaps(lg, served)
    detail = {"served_tokens": sum(len(t) for t in served), "gaps": g}
    if control:
        lq = ref.run(weights, c, seqs, firsts, cast="fp8")
        detail.update(program_gap=max(g), program_flips=flips(lg, served),
                      control_flips=flips(lg, [q.argmax(-1).tolist()
                                               for q in lq]))
        g = gaps(lg, served, chooser=lq)
        del lq
    numbers["widest_gap"] = {"value": max(g),
                             "limit": limits["widest_gap"]}
    ok = (len(picked) >= 1 and bad_tokens == 0
          and max(g) <= limits["widest_gap"])
    return ok, numbers, detail
