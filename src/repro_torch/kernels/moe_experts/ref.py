"""Plain PyTorch version of the grouped expert products: each expert's
SwiGLU over its own rows of the expert-sorted token rows, one expert at a
time.

``x`` (M, d) holds the routed (token, expert) rows grouped by expert, the
rows of expert ``e`` at ``[offs[e - 1], offs[e])`` (``offs`` the
cumulative row counts, int32); ``wg`` / ``wu`` (E, d, f), ``wo`` (E, f, d).
Row ``i`` of the output is ``(silu(x_i wg_e) * (x_i wu_e)) wo_e`` for its
expert ``e``; rows past ``offs[-1]`` are zero.  The offsets are read on
the host, so on the card this is the oracle, not the serving path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grouped_experts_ref(x, wg, wu, wo, offs):
    """x (M, d) grouped by expert; offs (E,) cumulative ends -> (M, d)."""
    out = x.new_zeros((x.shape[0], wo.shape[-1]))
    lo = 0
    for e, hi in enumerate(offs.tolist()):
        if hi > lo:
            xe = x[lo:hi]
            g = F.silu(xe @ wg[e].to(x.dtype))
            out[lo:hi] = (g * (xe @ wu[e].to(x.dtype))) @ wo[e].to(x.dtype)
        lo = hi
    return out
