"""Plain PyTorch version of K4 (the Mamba2 SSD scan), in the model layout,
with carried state in and out.

    s_t = exp(dt_t A) s_{t-1} + dt_t x_t ⊗ B_t;   y_t = C_t · s_t + D x_t

``ssd_chunked`` mirrors the chunked SSD the reference engine runs
(``repro/models/ssm.py:apply_mamba_full``): chunks of ``Q = min(256,
max(16, S))`` tokens, the dense (Q, Q) decay with exponents clamped to
<= 0, head-shared B/C (one group), the ``D`` skip, and the inter-chunk
state — carried by a sequential loop over chunks where the reference uses
an associative scan.  Trailing pad tokens (dt = 0) leave the state
unchanged.  The wrapper in ``ops.py`` runs it for CPU tensors; on the card
it is the kernel's oracle.

``ssd_recurrence`` is the literal step-by-step definition in float64, the
test oracle (the reference's ``kernels/ssd/ref.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.wkv6.ref import _pad_seq

MAMBA_CHUNK = 256


def ssd_chunked(x, Bm, Cm, dt, A, D, state=None):
    """x (B,S,h,p); Bm/Cm (B,S,n); dt (B,S,h); A/D (h,); state optional
    (B,h,p,n) carry — all f32 -> (y (B,S,h,p), state (B,h,p,n))."""
    B, S, h, p = x.shape
    n = Bm.shape[-1]
    Q = min(MAMBA_CHUNK, max(16, S))
    xc, bc, cc, dtc = (_pad_seq(t, Q) for t in (x, Bm, Cm, dt))
    nc = xc.shape[1] // Q
    xc = xc.reshape(B, nc, Q, h, p)
    bc, cc = bc.reshape(B, nc, Q, n), cc.reshape(B, nc, Q, n)
    dtc = dtc.reshape(B, nc, Q, h)

    seg = torch.cumsum(dtc * A, dim=2)  # inclusive log decay, <= 0
    # intra-chunk: y[t] = sum_{i<=t} exp(seg[t]-seg[i]) (C_t·B_i) dt_i x_i
    g = torch.einsum("bcqn,bckn->bcqk", cc, bc)
    decay = torch.exp(torch.clamp(seg[:, :, :, None] - seg[:, :, None],
                                  max=0.0))  # (B,nc,Q,Q,h)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    m = torch.where(mask[None, None, :, :, None], g[..., None] * decay, 0.0)
    y = torch.einsum("bcqkh,bckhp->bcqhp", m, xc * dtc[..., None])
    # chunk-local end states and whole-chunk decays
    decay_to_end = torch.exp(seg[:, :, -1:] - seg)  # (B,nc,Q,h)
    s_local = torch.einsum("bcqh,bcqhp,bcqn->bchpn", decay_to_end * dtc, xc,
                           bc)
    a_chunk = torch.exp(seg[:, :, -1])  # (B,nc,h)
    s = (torch.zeros((B, h, p, n), dtype=x.dtype, device=x.device)
         if state is None else state.to(x.dtype))
    starts = []
    for c in range(nc):
        starts.append(s)
        s = a_chunk[:, c, :, None, None] * s + s_local[:, c]
    y = y + torch.einsum("bcqn,bchpn,bcqh->bcqhp", cc,
                         torch.stack(starts, dim=1), torch.exp(seg))
    y = y.reshape(B, nc * Q, h, p)[:, :S] + x * D[:, None]
    return y, s


def ssd_recurrence(x, Bm, Cm, dt, A, D, state=None):
    """The literal recurrence in float64: same arguments and results as
    :func:`ssd_chunked` (returned in float32)."""
    B, S, h, p = x.shape
    n = Bm.shape[-1]
    x, Bm, Cm, dt, A, D = (t.double() for t in (x, Bm, Cm, dt, A, D))
    s = (torch.zeros((B, h, p, n), dtype=torch.float64, device=x.device)
         if state is None else state.double().clone())
    out = torch.empty((B, S, h, p), dtype=torch.float64, device=x.device)
    for t in range(S):
        a = torch.exp(dt[:, t] * A)  # (B,h)
        s = (a[:, :, None, None] * s
             + (dt[:, t, :, None] * x[:, t])[..., None]
             * Bm[:, t, None, None, :])
        out[:, t] = torch.einsum("bn,bhpn->bhp", Cm[:, t], s) \
            + x[:, t] * D[:, None]
    return out.float(), s.float()
