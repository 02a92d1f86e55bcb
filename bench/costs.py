"""The benchmark's yardstick of work: the H100's published peaks, the bytes
and flops of one K1 (decode attention) and one K2 (prefill attention) call,
and the useful flops of a served token.

The K1 / K2 counts are a frozen copy of ``cost()`` in the port's
``kernels/decode_attention/ops.py`` and ``kernels/flash_attention/ops.py``:
a later change to the port cannot move the yardstick it is measured by
(``bench/tests/test_bench_costs.py`` holds the copy equal to the port's
``cost()`` at the cells' shapes).  Shapes are plain tuples and positions
plain ints, so nothing here reads a device tensor.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at the 700 W limit
PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: compute or memory, the larger."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / HBM_BYTES_PER_S)


def k1_cost(q_shape: Sequence[int], k_shape: Sequence[int],
            v_shape: Sequence[int], pos: Sequence[int], elem_size: int,
            window: Optional[int] = None,
            kv_len: Optional[Sequence[int]] = None,
            causal: bool = True, n_slopes: int = 0, v_is_k: bool = False,
            t0: int = 0, n_split: Optional[int] = None):
    """(flops, bytes) of one K1 call: the query, each K/V row the mask
    reaches (per row from ``pos``, or from ``kv_len`` alone when
    non-causal), the output, the positions and the ALiBi slopes; the score
    and P·V products over the reached rows."""
    B, _, H, Dk = q_shape
    T, Kv, Dv = k_shape[1], k_shape[2], v_shape[-1]
    v_bytes = 0 if v_is_k else Dv
    kvl = [t0 + T] * B if kv_len is None else list(kv_len)
    rows = 0
    for p, kl in zip(pos, kvl):
        hi = min(p + 1, kl, t0 + T) if causal else min(kl, t0 + T)
        lo = 0 if window is None or not causal else max(0, p - window + 1)
        rows += max(hi - max(lo, t0), 0)
    out_bytes = B * H * Dv * elem_size if n_split is None \
        else 4 * n_split * B * H * (Dv + 2)
    nbytes = B * H * Dk * elem_size + out_bytes \
        + rows * Kv * (Dk + v_bytes) * elem_size + 4 * B + 4 * n_slopes
    return 2 * rows * H * (Dk + Dv), nbytes


def _sum_min(a: int, n: int, cap: int) -> int:
    """sum(min(a + i, cap) for i in range(n))."""
    k = max(0, min(n, cap - a))
    return k * a + k * (k - 1) // 2 + (n - k) * cap


def causal_pairs(sq: int, skv: int, q_start: int, window: int) -> int:
    """The (query, key) pairs causal attention inside ``window`` reaches."""
    b = q_start - window + 1
    i0 = min(sq, max(0, 1 - b))
    past = (sq - i0) * b + (sq * (sq - 1) - i0 * (i0 - 1)) // 2
    return _sum_min(q_start + 1, sq, skv) - past


def k2_cost(q_shape: Sequence[int], k_shape: Sequence[int],
            v_shape: Sequence[int], elem_size: int, q_start: int = 0,
            window: Optional[int] = None, causal: bool = True,
            n_slopes: int = 0):
    """(flops, bytes) of one K2 call: q and the slopes read once, the K/V
    rows the mask reaches read once, out written once; score and P·V flops
    over the causally valid (query, key) pairs (every pair when
    non-causal)."""
    B, Sq, H, Dk = q_shape
    Skv, Kv, Dv = k_shape[1], k_shape[2], v_shape[-1]
    w = Skv + Sq if window is None else window
    pairs = Sq * Skv if not causal else causal_pairs(Sq, Skv, q_start, w)
    keys = Skv if not causal else max(
        0, min(Skv, q_start + Sq) - max(0, q_start - w + 1))
    nbytes = (B * Sq * H * Dk + B * keys * Kv * (Dk + Dv)
              + B * Sq * H * Dv) * elem_size + 4 * n_slopes
    return 2 * B * H * pairs * (Dk + Dv), nbytes


def _dense_flops(dims: Dict[str, int]) -> int:
    """Flops of one token's projections and MLP through one layer: the
    q / k / v / o projections and the MLP (gated: three matrices; plain:
    two)."""
    d, H, Kv, hd, f = (dims[k] for k in ("d", "heads", "kv_heads",
                                         "head_dim", "d_ff"))
    proj = d * H * hd + 2 * d * Kv * hd + H * hd * d
    mlp = (3 if dims["gated"] else 2) * d * f
    return 2 * (proj + mlp)


def layer_flops(dims: Dict[str, int], pos: int) -> int:
    """Useful flops of one token at position ``pos`` (0-based: it attends
    ``pos + 1`` keys) through one decoder layer: projections, MLP, and the
    scores and P·V over its live positions."""
    return _dense_flops(dims) + 4 * dims["heads"] * dims["head_dim"] \
        * (pos + 1)


def head_flops(dims: Dict[str, int]) -> int:
    """Useful flops of the LM head for one generated token."""
    return 2 * dims["d"] * dims["vocab"]


def token_flops(dims: Dict[str, int], pos: int) -> int:
    """One token at ``pos`` through every layer of the (cut) model."""
    return dims["layers"] * layer_flops(dims, pos)


def chunk_flops(dims: Dict[str, int], offset: int, span: int,
                completes: bool) -> int:
    """A prompt chunk's ``span`` live tokens at positions ``offset ..
    offset + span - 1`` through every layer, each over its causal prefix,
    and the LM head once if the chunk completes the prompt (its first
    generated token)."""
    # sum over pos of 4 H hd (pos + 1) = 4 H hd (sum of offset+1 .. +span)
    keys = span * offset + span * (span + 1) // 2
    attn = 4 * dims["heads"] * dims["head_dim"] * keys
    return dims["layers"] * (_dense_flops(dims) * span + attn) \
        + (head_flops(dims) if completes else 0)
