"""Plain PyTorch version of K2 (prefill flash attention), in the model layout.

The same function as the CUDA kernel in ``kernels/csrc/flash_attention.cu``
and the reference's ``attention_ref``: queries at ``q_start + arange(Sq)``
over keys at ``arange(Skv)``, GQA by head groups, causal with an optional
sliding ``window``, ALiBi ``slopes`` (H,), or non-causal Sq != Skv and
Dv != Dk, the scores scaled by ``scale`` (default ``1/sqrt(Dk)``) — in f32, with masked probabilities zeroed and the denominator
floored at 1e-30.  The wrapper in ``ops.py`` runs it for CPU tensors; on
the card it is the kernel's oracle.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.runtime import NO_WINDOW

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window=None, slopes=None,
                  q_start: int = 0, scale=None):
    """q (B,Sq,H,Dk); k (B,Skv,Kv,Dk); v (B,Skv,Kv,Dv) -> (B,Sq,H,Dv)."""
    B, Sq, H, Dk = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    qg = q.reshape(B, Sq, Kv, G, Dk).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    logits = logits / math.sqrt(Dk) if scale is None else logits * scale
    q_pos = q_start + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Skv, device=q.device)
    diff = q_pos[:, None] - kv_pos[None, :]  # (Sq, Skv)
    if slopes is not None:
        logits = logits + (slopes.float().reshape(Kv, G)[None, :, :, None,
                                                        None]
                           * (-diff.abs()).float())
    if causal:
        win = NO_WINDOW if window is None else int(window)
        ok = (diff >= 0) & (diff < win)
    else:
        ok = torch.ones_like(diff, dtype=torch.bool)
    logits = torch.where(ok, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(logits - m), 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)
