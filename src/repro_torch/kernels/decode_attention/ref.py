"""Plain PyTorch version of K1 (decode attention), in the model layout.

The same function as the CUDA kernel in ``kernels/csrc/decode_attention.cu``
and the reference's ``decode_attention_ref``: one query token per row over a
(B, T, Kv, D) cache, per-row ``pos``/``kv_len``, a sliding ``window``
(causal only), ALiBi ``slopes`` (H,), a caller ``scale``, Dk != Dv — in f32,
with masked probabilities zeroed and the denominator floored at 1e-30 (a
row with no valid key yields zeros, as the kernel does).  The wrapper in
``ops.py`` runs it for CPU tensors; on the card it is the kernel's oracle.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.runtime import NO_WINDOW

NEG_INF = -1e30


def per_row(x, n: int, device) -> torch.Tensor:
    """A scalar or (n,) integer operand as an (n,) int32 tensor."""
    t = torch.as_tensor(x, device=device).to(torch.int32).reshape(-1)
    return t.expand(n).contiguous()


def decode_attention_ref(q, ck, cv, pos, *, window=None, slopes=None,
                         kv_len=None, causal: bool = True, scale=None):
    """q (B,1,H,Dk); ck (B,T,Kv,Dk); cv (B,T,Kv,Dv) -> (B,1,H,Dv)."""
    B, _, H, Dk = q.shape
    T, Kv = ck.shape[1], ck.shape[2]
    G = H // Kv
    scale = 1.0 / math.sqrt(Dk) if scale is None else float(scale)
    qg = q.reshape(B, Kv, G, Dk).float()
    logits = torch.einsum("bkgd,btkd->bkgt", qg, ck.float()) * scale
    kv_pos = torch.arange(T, device=q.device)
    diff = per_row(pos, B, q.device)[:, None] - kv_pos[None, :]  # (B, T)
    if slopes is not None:
        logits = logits + (slopes.float().reshape(Kv, G)[None, :, :, None]
                           * (-diff.abs()).float()[:, None, None, :])
    if causal:
        win = NO_WINDOW if window is None else int(window)
        ok = (diff >= 0) & (diff < win)
    else:
        ok = torch.ones_like(diff, dtype=torch.bool)
    if kv_len is not None:
        ok = ok & (kv_pos[None, :] < per_row(kv_len, B, q.device)[:, None])
    ok = ok[:, None, None, :]
    logits = torch.where(ok, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(logits - m), 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgt,btkd->bkgd", p, cv.float())
    return out.to(q.dtype).reshape(B, 1, H, cv.shape[-1])
