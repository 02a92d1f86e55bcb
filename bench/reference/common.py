"""Layer-by-layer driver of the plain reference, and the weight casts.

``run`` takes the whole weight tree (bf16 on the card, as served), casts one
layer at a time to float32 (or, for the control, rounds it through fp8
first) and pushes every sequence through it, so the peak is the served
weights plus one float32 layer.  The LM head is taken in vocabulary chunks
and only at the positions whose next token was served.
"""
from __future__ import annotations

import importlib
import math
from typing import Callable, Dict, List, Sequence

import torch

FP8_MAX = 448.0  # float8_e4m3fn


def no_tf32() -> None:
    """Float32 matmuls in float32: the card would run them in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def to_f32(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def via_fp8(x: torch.Tensor) -> torch.Tensor:
    """A matrix rounded through float8_e4m3fn with one scale per tensor
    (the step below bf16 that a later change might take), returned in
    float32; vectors (norm scales and biases) stay float32."""
    if x.dim() < 2:
        return x.float()
    x = x.to(torch.float32, copy=True)
    scale = x.abs().amax().clamp_min(1e-12) / FP8_MAX
    x.div_(scale)
    x.copy_(x.to(torch.float8_e4m3fn))
    return x.mul_(scale)


CASTS: Dict[str, Callable] = {"f32": to_f32, "fp8": via_fp8}
QUERY_BLOCK = 256  # query rows a block: scores stay (H, 256, S)


def causal_attention(q, k, v, slopes=None) -> torch.Tensor:
    """Causal softmax attention of q, k, v (H, S, D) with scale
    1/sqrt(D) and, given ``slopes`` (H,), ALiBi's bias -slope * (i - j),
    computed in blocks of query rows so that a long prompt's scores fit
    beside the weights."""
    S, D = q.shape[1], q.shape[-1]
    pos = torch.arange(S, device=q.device)
    out = []
    for i0 in range(0, S, QUERY_BLOCK):
        i1 = min(i0 + QUERY_BLOCK, S)
        s = torch.einsum("hsk,htk->hst", q[:, i0:i1], k[:, :i1]) \
            / math.sqrt(D)
        dist = (pos[i0:i1, None] - pos[None, :i1]).float()  # query - key
        if slopes is not None:
            s = s - slopes[:, None, None] * dist[None]
        s = s.masked_fill((dist < 0)[None], float("-inf"))
        out.append(torch.einsum("hst,htk->hsk", torch.softmax(s, -1),
                                v[:, :i1]))
    return torch.cat(out, dim=1)


def family(name: str):
    return importlib.import_module(f"reference.{name}")


def layer_slice(tree, i: int, cast: Callable):
    """Layer ``i`` of a stacked (L, ...) tree, cast."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i, cast) for k, v in tree.items()}
    return cast(tree[i])


@torch.no_grad()
def run(w, c, seqs: Sequence[Sequence[int]], firsts: Sequence[int],
        cast: str = "f32", vocab_chunk: int = 16384) -> List[torch.Tensor]:
    """Float32 logits (n, V) of each sequence at positions ``first - 1 ..
    len - 2``: the logits that chose its tokens ``first ..`` (the served
    ones).  ``w``: the weight tree; ``c``: the configuration's keys."""
    no_tf32()
    fam = family(c["family"])
    fn = CASTS[cast]
    dev = w["embed"]["tok"].device
    hs = [fam.embed(w, c, torch.as_tensor(list(s), device=dev), fn)
          for s in seqs]
    blocks = w["segments"]["blocks"]
    n_layers = next(iter(blocks["ln1"].values())).shape[0]
    for i in range(n_layers):
        lw = layer_slice(blocks, i, fn)
        hs = [fam.layer(lw, c, h) for h in hs]
        del lw
    out = []
    for h, s, f in zip(hs, seqs, firsts):
        out.append(fam.logits(w, c, h[f - 1:len(s) - 1], fn, vocab_chunk))
    return out
