"""Plain PyTorch version of K1 (decode attention), in the model layout.

The same function as the CUDA kernel in ``kernels/csrc/decode_attention.cu``
and the reference's ``decode_attention_ref``: one query token per row over a
(B, T, Kv, D) cache, per-row ``pos``/``kv_len``, a sliding ``window``
(causal only), ALiBi ``slopes`` (H,), a caller ``scale``, Dk != Dv — in f32,
with masked probabilities zeroed and the denominator floored at 1e-30 (a
row with no valid key yields zeros, as the kernel does).  The wrapper in
``ops.py`` runs it for CPU tensors; on the card it is the kernel's oracle.

``decode_attention_partials_ref`` and ``merge_partials_ref`` are the two
halves of the same function over a cache cut into time shards: each
shard's f32 split partials (running max ``m``, sum ``l``, unnormalised
output ``acc``; an empty split m = -1e30, l = 0) and their merge.
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


def _masked_logits(q, ck, pos, t0, window, slopes, kv_len, causal, scale):
    """(logits (B,Kv,G,T) f32 with -1e30 where masked, mask (B,1,1,T)) of
    queries over a cache whose first key sits at global position ``t0``."""
    B, _, H, Dk = q.shape
    T, Kv = ck.shape[1], ck.shape[2]
    G = H // Kv
    scale = 1.0 / math.sqrt(Dk) if scale is None else float(scale)
    qg = q.reshape(B, Kv, G, Dk).float()
    logits = torch.einsum("bkgd,btkd->bkgt", qg, ck.float()) * scale
    kv_pos = int(t0) + torch.arange(T, device=q.device)
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
    return torch.where(ok, logits, NEG_INF), ok


def decode_attention_ref(q, ck, cv, pos, *, window=None, slopes=None,
                         kv_len=None, causal: bool = True, scale=None):
    """q (B,1,H,Dk); ck (B,T,Kv,Dk); cv (B,T,Kv,Dv) -> (B,1,H,Dv)."""
    B, _, H, _ = q.shape
    logits, ok = _masked_logits(q, ck, pos, 0, window, slopes, kv_len,
                                causal, scale)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(logits - m), 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgt,btkd->bkgd", p, cv.float())
    return out.to(q.dtype).reshape(B, 1, H, cv.shape[-1])


def decode_attention_partials_ref(q, ck, cv, pos, *, t0: int = 0,
                                  window=None, slopes=None, kv_len=None,
                                  causal: bool = True, scale=None,
                                  chunk=None):
    """The f32 split partials of q (B,1,H,Dk) over a cache shard ck
    (B,T,Kv,Dk) / cv (B,T,Kv,Dv) whose first key sits at global position
    ``t0`` (``pos`` and ``kv_len`` global), in splits of ``chunk`` local
    positions (one split without): (m (S,B,H), l (S,B,H), acc
    (S,B,H,Dv))."""
    B, _, H, _ = q.shape
    T, Kv = ck.shape[1], ck.shape[2]
    logits, ok = _masked_logits(q, ck, pos, t0, window, slopes, kv_len,
                                causal, scale)
    chunk = T if chunk is None else int(chunk)
    ms, ls, accs = [], [], []
    for lo in range(0, T, chunk):
        lg = logits[..., lo:lo + chunk]
        m = lg.amax(dim=-1)
        p = torch.where(ok[..., lo:lo + chunk], torch.exp(lg - m[..., None]),
                        0.0)
        ms.append(m.reshape(B, H))
        ls.append(p.sum(dim=-1).reshape(B, H))
        accs.append(torch.einsum("bkgt,btkd->bkgd", p,
                                 cv[:, lo:lo + chunk].float())
                    .reshape(B, H, cv.shape[-1]))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def merge_partials_ref(m, l, acc, dtype):
    """The merge of split partials (m, l (S,B,H); acc (S,B,H,Dv)) into
    (B,1,H,Dv) of ``dtype``: rescaled by exp(m_s - max m), summed, divided
    by the summed l floored at 1e-30."""
    w = torch.exp(m - m.amax(dim=0))
    den = (w * l).sum(dim=0).clamp_min(1e-30)
    out = (w[..., None] * acc).sum(dim=0) / den[..., None]
    return out.to(dtype)[:, None]
