"""Chameleon (arXiv:2405.09818) as a text decoder in plain PyTorch, float32.

Pre-RMSNorm blocks: RMSNorm -> grouped-query attention (64 query heads over
8 KV heads) with RMS qk-norm over head_dim and rotary positions (theta
10000, the two halves of head_dim rotated) -> residual; RMSNorm -> SwiGLU
MLP -> residual; a final RMSNorm and an untied LM head.  Two departures
the port makes, which the configuration file lists, the reference follows
so that the comparison judges the served arithmetic: the pre-norm blocks
(the published 34B model reorders its norms Swin-style, the norm after
each sublayer) and the qk-norm's form (an RMSNorm whose scale all heads
share, where Chameleon's is a per-head LayerNorm).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.common import causal_attention


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    """x (H, S, D): rotate the halves of D by pos * theta^(-2i/D)."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device,
                                       dtype=torch.float32) / D)
    ang = pos.float()[:, None] * inv[None]
    cos, sin = torch.cos(ang)[None], torch.sin(ang)[None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def embed(w, c, tokens, cast):
    return cast(w["embed"]["tok"][tokens])


def layer(lw, c, h):
    """One block over a whole sequence h (S, d)."""
    eps = c["rms_norm_eps"]
    S = h.shape[0]
    H, Kv = c["num_attention_heads"], c["num_key_value_heads"]
    a = lw["attn"]
    x = rms_norm(h, lw["ln1"]["scale"], eps)
    q = torch.einsum("sd,dhk->hsk", x, a["wq"])
    k = torch.einsum("sd,dhk->hsk", x, a["wk"])
    v = torch.einsum("sd,dhk->hsk", x, a["wv"])
    if c.get("qk_layernorm"):
        q = rms_norm(q, a["q_norm"], eps)
        k = rms_norm(k, a["k_norm"], eps)
    pos = torch.arange(S, device=h.device)
    q, k = rope(q, pos, c["rope_theta"]), rope(k, pos, c["rope_theta"])
    k = k.repeat_interleave(H // Kv, dim=0)
    v = v.repeat_interleave(H // Kv, dim=0)
    o = causal_attention(q, k, v)
    h = h + torch.einsum("hsk,hkd->sd", o, a["wo"])
    x = rms_norm(h, lw["ln2"]["scale"], eps)
    f = lw["ffn"]
    return h + (F.silu(x @ f["wg"]) * (x @ f["wu"])) @ f["wo"]


def logits(w, c, h, cast, chunk):
    """Final RMSNorm, then the head (d, V) in vocabulary chunks."""
    x = rms_norm(h, w["embed"]["final_norm"]["scale"].float(),
                 c["rms_norm_eps"])
    head = w["embed"]["head"]
    V = c["vocab_size"]
    return torch.cat([x @ cast(head[:, i:min(i + chunk, V)])
                      for i in range(0, V, chunk)], dim=-1)
