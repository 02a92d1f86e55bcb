"""Plain PyTorch version of K3 (the RWKV6 WKV recurrence), in the model
layout, with carried state in and out.

    out_t = r_t · (S_{t-1} + u ⊙ k_t ⊗ v_t);   S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t

``wkv6_chunked`` mirrors the path the reference engine runs
(``repro/models/ssm.py:_wkv6_chunked``): chunks of ``Q = min(16, max(4,
S))`` tokens, the explicit masked (Q, Q) decay per channel with exponents
clamped to <= 0, the current-token bonus, and the inter-chunk state —
carried by a sequential loop over chunks where the reference uses an
associative scan (the same sums, associated differently).  Trailing pad
tokens (k = v = lw = 0) leave the state unchanged.  The wrapper in
``ops.py`` runs it for CPU tensors; on the card it is the kernel's oracle.

``wkv6_recurrence`` is the literal step-by-step definition in float64, the
test oracle (the reference's ``kernels/wkv6/ref.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

RWKV_CHUNK = 16


def _pad_seq(x, mult: int):
    """Zero-pad axis 1 of a (B, S, ...) tensor to a multiple of ``mult``."""
    pad = (-x.shape[1]) % mult
    if pad == 0:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


def wkv6_chunked(r, k, v, lw, u, state=None):
    """r/k/v/lw (B,S,h,hd) f32 (lw: log decay, <= 0); u (h,hd) f32; state
    optional (B,h,hd,hd) f32 carry -> (out (B,S,h,hd), state (B,h,hd,hd))."""
    B, S, h, hd = r.shape
    Q = min(RWKV_CHUNK, max(4, S))
    rc, kc, vc, lwc = (_pad_seq(x, Q) for x in (r, k, v, lw))
    nc = rc.shape[1] // Q
    rc, kc, vc, lwc = (x.reshape(B, nc, Q, h, hd) for x in (rc, kc, vc, lwc))

    seg = torch.cumsum(lwc, dim=2)  # inclusive within the chunk
    segx = seg - lwc  # exclusive
    # intra-chunk: out[t] += sum_{i<t} (r_t ⊙ exp(segx_t - seg_i) · k_i) v_i
    decay = torch.exp(torch.clamp(
        segx[:, :, :, None] - seg[:, :, None], max=0.0))  # (B,nc,Q,Q,h,hd)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=r.device),
                      diagonal=-1)
    decay = torch.where(mask[None, None, :, :, None, None], decay, 0.0)
    amat = (rc[:, :, :, None] * kc[:, :, None] * decay).sum(-1)
    y = torch.einsum("bctih,bcihd->bcthd", amat, vc)
    # current-token bonus: (r_t · (u ⊙ k_t)) v_t
    y = y + (rc * u * kc).sum(-1, keepdim=True) * vc
    # inter-chunk: out[t] += (r_t ⊙ exp(segx_t)) · S_chunk_start
    decay_to_end = torch.exp(seg[:, :, -1:] - seg)
    s_local = torch.einsum("bcihd,bcihe->bchde", kc * decay_to_end, vc)
    a_chunk = torch.exp(seg[:, :, -1])  # (B,nc,h,hd)
    s = (torch.zeros((B, h, hd, hd), dtype=r.dtype, device=r.device)
         if state is None else state.to(r.dtype))
    starts = []
    for c in range(nc):
        starts.append(s)
        s = a_chunk[:, c, :, :, None] * s + s_local[:, c]
    y = y + torch.einsum("bcthd,bchde->bcthe", rc * torch.exp(segx),
                         torch.stack(starts, dim=1))
    return y.reshape(B, nc * Q, h, hd)[:, :S], s


def wkv6_recurrence(r, k, v, lw, u, state=None):
    """The literal recurrence in float64: same arguments and results as
    :func:`wkv6_chunked` (returned in float32)."""
    B, S, h, hd = r.shape
    r, k, v, u = (x.double() for x in (r, k, v, u))
    w = torch.exp(lw.double())
    s = (torch.zeros((B, h, hd, hd), dtype=torch.float64, device=r.device)
         if state is None else state.double().clone())
    out = torch.empty((B, S, h, hd), dtype=torch.float64, device=r.device)
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B,h,hd,hd)
        out[:, t] = torch.einsum("bhd,bhde->bhe", r[:, t],
                                 s + u[None, :, :, None] * kv)
        s = w[:, t, :, :, None] * s + kv
    return out.float(), s.float()
