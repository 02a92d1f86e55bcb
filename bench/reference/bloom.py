"""BLOOM (BigScience, arXiv:2211.05100) in plain PyTorch, float32.

Pre-LayerNorm blocks: LayerNorm -> multi-head attention with ALiBi (causal,
scale 1/sqrt(head_dim)) -> residual; LayerNorm -> GeLU MLP (d -> 4d -> d)
-> residual; a final LayerNorm and the LM head tied to the word
embeddings.  Departures from the published model, shared with the port and
listed in the configuration file: no embedding LayerNorm and no biases on
the linear layers.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.common import causal_attention


def alibi_slopes(n_heads: int) -> torch.Tensor:
    """BLOOM's geometric ALiBi slopes, with the interleaved extra slopes
    when the head count is not a power of two."""
    p = 2 ** int(math.floor(math.log2(n_heads)))
    base = 2.0 ** (-8.0 / p)
    slopes = [base ** (i + 1) for i in range(p)]
    if p < n_heads:
        extra = 2.0 ** (-4.0 / p)
        slopes += [extra ** (2 * i + 1) for i in range(n_heads - p)]
    return torch.tensor(slopes, dtype=torch.float32)


def layer_norm(x, p, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def embed(w, c, tokens, cast):
    return cast(w["embed"]["tok"][tokens])


def layer(lw, c, h):
    """One block over a whole sequence h (S, d)."""
    eps = c["layer_norm_epsilon"]
    H = c["n_head"]
    x = layer_norm(h, lw["ln1"], eps)
    a = lw["attn"]
    q = torch.einsum("sd,dhk->hsk", x, a["wq"])
    k = torch.einsum("sd,dhk->hsk", x, a["wk"])
    v = torch.einsum("sd,dhk->hsk", x, a["wv"])
    o = causal_attention(q, k, v, alibi_slopes(H).to(h.device))
    h = h + torch.einsum("hsk,hkd->sd", o, a["wo"])
    x = layer_norm(h, lw["ln2"], eps)
    m = F.gelu(x @ lw["ffn"]["wi"], approximate="tanh") @ lw["ffn"]["wo"]
    return h + m


def logits(w, c, h, cast, chunk):
    """Final LayerNorm, then the tied head in vocabulary chunks."""
    fn = {k: v.float() for k, v in w["embed"]["final_norm"].items()}
    x = layer_norm(h, fn, c["layer_norm_epsilon"])
    tok = w["embed"]["tok"]
    V = c["vocab_size"]
    return torch.cat([x @ cast(tok[i:min(i + chunk, V)]).t()
                      for i in range(0, V, chunk)], dim=-1)
