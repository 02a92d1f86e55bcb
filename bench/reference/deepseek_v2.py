"""DeepSeek-V2 (DeepSeek-AI, arXiv:2405.04434; the published
``modeling_deepseek.py``) in plain PyTorch, float32.

Pre-RMSNorm blocks (eps ``rms_norm_eps``, every norm, the q_a and kv_a
norms too): multi-head latent attention, unabsorbed -> residual; RMSNorm
-> FFN -> residual.  The first ``first_k_dense_replace`` blocks have a
dense SwiGLU FFN of width ``intermediate_size``; the rest a mixture of
experts: softmax scores over the routed experts in f32, group-limited
greedy (each of ``n_group`` groups scores its best expert, the
``topk_group`` best groups are kept, the top ``num_experts_per_tok``
scores are taken inside them), the chosen scores times
``routed_scaling_factor`` as weights (``norm_topk_prob`` false: no
renormalisation), every choice computed (no capacity, no dropped token),
one expert at a time, plus the shared experts' SwiGLU of width
``n_shared_experts x moe_intermediate_size``.  A final RMSNorm and the
untied LM head.

Attention: ``q = W_uq RMSNorm(W_dq x)`` split into nope and rope parts;
``c = W_dkv x``, the latent ``RMSNorm(c[:kv_lora])`` and the shared rope
key ``c[kv_lora:]``; per head ``k = [W_uk latent, rope(k_rope)]``, ``v =
W_uv latent``; causal softmax of ``q . k`` times ``(nope + rope)^-1/2
mscale(factor, mscale_all_dim)^2``.  YaRN on the rope dims:
``inv_freq = inter (1 - m) + extra m``, ``extra = theta^(-2i/dim)``,
``inter = extra / factor``, ``m = 1 - clamp((i - low) / (high - low), 0,
1)``, ``low = floor(d(beta_fast))``, ``high = ceil(d(beta_slow))``,
``d(r) = dim ln(original / (2 pi r)) / (2 ln theta)``; cos and sin times
``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``, ``mscale(s,
m) = 0.1 m ln s + 1``.

Departures from the published code, each shared with the port: the rope
dims are rotated in halves (``x[:dim/2]``, ``x[dim/2:]``) where the
published code first permutes them from interleaved pairs, a fixed
permutation of the projections' rope columns, which random weights do not
see; the weights are the benchmark's random ones.  ``embed`` runs the
leading dense blocks too (``common.run`` walks the MoE blocks of
``segments.blocks``), cast one block at a time.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.common import causal_attention, layer_slice


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _mscale(s: float, m: float) -> float:
    return 1.0 if s <= 1 else 0.1 * m * math.log(s) + 1.0


def yarn(c, device):
    """(inv_freq (rope/2,), cos/sin factor, softmax factor) of the config's
    YaRN rope scaling."""
    y, dim = c["rope_scaling"], c["qk_rope_head_dim"]
    theta, s = float(c["rope_theta"]), float(y["factor"])

    def d(r):
        return dim * math.log(y["original_max_position_embeddings"]
                              / (2 * math.pi * r)) / (2 * math.log(theta))

    low = max(math.floor(d(y["beta_fast"])), 0)
    high = min(math.ceil(d(y["beta_slow"])), dim - 1)
    i = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    extra = 1.0 / theta ** (i / dim)
    inter = extra / s
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    m = 1.0 - ramp
    inv_freq = inter * (1 - m) + extra * m
    table = _mscale(s, y["mscale"]) / _mscale(s, y["mscale_all_dim"])
    return inv_freq, table, _mscale(s, y["mscale_all_dim"]) ** 2


def rope(x, pos, c):
    """Rotate x (S, ..., dim) at positions pos (S,), dims in halves."""
    inv_freq, table, _ = yarn(c, x.device)
    ang = pos.float()[:, None] * inv_freq[None]
    cos, sin = torch.cos(ang) * table, torch.sin(ang) * table
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (-1,)
    cos, sin = cos.reshape(shape), sin.reshape(shape)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(a, c, x):
    """Causal MLA over a whole sequence x (S, d) -> (S, d)."""
    eps = c["rms_norm_eps"]
    nope, dr = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    lora = c["kv_lora_rank"]
    S = x.shape[0]
    pos = torch.arange(S, device=x.device)
    q = torch.einsum("sq,qhk->shk", rms_norm(x @ a["wdq"], a["q_norm"], eps),
                     a["wuq"])
    ckv = x @ a["wdkv"]
    latent = rms_norm(ckv[:, :lora], a["kv_norm"], eps)
    k_rope = rope(ckv[:, lora:], pos, c)  # (S, rope), one for every head
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, c)], dim=-1)
    k_nope = torch.einsum("sl,lhk->shk", latent, a["wuk"])
    k = torch.cat([k_nope, k_rope[:, None].expand(-1, k_nope.shape[1], -1)],
                  dim=-1)
    v = torch.einsum("sl,lhk->shk", latent, a["wuv"])
    # causal_attention scales by 1/sqrt(nope + rope); YaRN's factor on q
    q = q * yarn(c, x.device)[2]
    o = causal_attention(q.transpose(0, 1), k.transpose(0, 1),
                         v.transpose(0, 1))
    return torch.einsum("hsk,hkd->sd", o, a["wo"])


def swiglu(x, wg, wu, wo):
    return (F.silu(x @ wg) * (x @ wu)) @ wo


def gate(r, c, x):
    """(weights (S, k), experts (S, k)) of group-limited greedy routing."""
    E, G = c["n_routed_experts"], c["n_group"]
    s = torch.softmax(x @ r, dim=-1)
    best = s.reshape(-1, G, E // G).amax(dim=-1)
    kept = torch.topk(best, c["topk_group"], dim=-1).indices
    mask = torch.zeros_like(best).scatter_(1, kept, 1.0)
    s = s * mask.repeat_interleave(E // G, dim=1)
    w, e = torch.topk(s, c["num_experts_per_tok"], dim=-1)
    if c["norm_topk_prob"]:
        return w / w.sum(-1, keepdim=True), e
    return w * c["routed_scaling_factor"], e


def moe(f, c, x):
    """Every routed choice computed, one expert at a time, plus the shared
    experts."""
    w, e = gate(f["router"], c, x)
    out = swiglu(x, f["swg"], f["swu"], f["swo"])
    for j in torch.unique(e).tolist():
        tok, slot = (e == j).nonzero(as_tuple=True)
        y = swiglu(x[tok], f["wg"][j], f["wu"][j], f["wo"][j])
        out = out.index_add(0, tok, y * w[tok, slot, None])
    return out


def _block(lw, c, h, ffn):
    eps = c["rms_norm_eps"]
    h = h + attention(lw["attn"], c, rms_norm(h, lw["ln1"]["scale"], eps))
    return h + ffn(lw["ffn"], c, rms_norm(h, lw["ln2"]["scale"], eps))


def _dense(f, c, x):
    return swiglu(x, f["wg"], f["wu"], f["wo"])


def embed(w, c, tokens, cast):
    """The token rows, then the leading dense blocks (cast one at a
    time)."""
    h = cast(w["embed"]["tok"][tokens])
    lead = w["segments"]["lead"]
    for i in range(c["first_k_dense_replace"]):
        h = _block(layer_slice(lead, i, cast), c, h, _dense)
    return h


def layer(lw, c, h):
    """One MoE block over a whole sequence h (S, d)."""
    return _block(lw, c, h, moe)


def logits(w, c, h, cast, chunk):
    """Final RMSNorm, then the untied head in vocabulary chunks."""
    x = rms_norm(h, w["embed"]["final_norm"]["scale"].float(),
                 c["rms_norm_eps"])
    head = w["embed"]["head"]
    V = c["vocab_size"]
    return torch.cat([x @ cast(head[:, i:min(i + chunk, V)])
                      for i in range(0, V, chunk)], dim=-1)
