"""DeepSeek-V2's yardstick of work: the useful flops of a served token
through the (cut) model, and the bytes and flops of one call of the grouped
expert products.  ``dims`` is ``families.deepseek_v2.dims``.

Useful flops count the model's own mathematics once for each live token:
MLA's projections (q down and up, the joint latent down, the token's own
k_nope and v up, the output) and causal attention over its prefix in the
unabsorbed form (scores over nope + rope dims, P.V over the value dims),
the router, 6 routed experts and the shared ones in each MoE block, the
dense SwiGLU in the leading blocks, and the LM head for each token
generated.  Padding, idle rows, masked hosted layers, the experts of other
tokens and the absorbed decode's reshuffles are not useful work.

``moe_cost`` is a frozen copy of ``cost()`` in the port's
``kernels/moe_experts/ops.py``, from shapes and per-expert row counts as
plain ints: a later change to the port cannot move the yardstick it is
measured by.
"""
from __future__ import annotations

from typing import Dict, Sequence


def _attn_proj(n: Dict[str, int]) -> int:
    d, H = n["d"], n["heads"]
    ql, kl, nope, rope, v = (n[k] for k in ("q_lora", "kv_lora", "nope",
                                            "rope", "v_dim"))
    return d * ql + ql * H * (nope + rope) + d * (kl + rope) \
        + kl * H * (nope + v) + H * v * d


def _attn_keys(n: Dict[str, int]) -> int:
    """Flops of one query against one key: scores and P.V, every head."""
    return 2 * n["heads"] * (n["nope"] + n["rope"] + n["v_dim"])


def _ffn(n: Dict[str, int], moe: bool) -> int:
    d = n["d"]
    if not moe:
        return 3 * d * n["d_ff"]
    return d * n["experts"] + 3 * d * (n["topk"] * n["expert_ff"]
                                       + n["shared_ff"])


def layers_flops(n: Dict[str, int], tokens: int, keys: int) -> int:
    """``tokens`` live tokens through every layer of the cut model, ``keys``
    (query, key) pairs of causal attention a layer among them."""
    dense = n["n_dense"]
    moe = n["layers"] - dense
    per = 2 * tokens * _attn_proj(n) + _attn_keys(n) * keys
    return dense * (per + 2 * tokens * _ffn(n, False)) \
        + moe * (per + 2 * tokens * _ffn(n, True))


def head_flops(n: Dict[str, int]) -> int:
    return 2 * n["d"] * n["vocab"]


def token_flops(n: Dict[str, int], pos: int) -> int:
    """One decoded token at ``pos`` (attending ``pos + 1`` keys) through
    the model."""
    return layers_flops(n, 1, pos + 1)


def chunk_flops(n: Dict[str, int], offset: int, span: int,
                completes: bool) -> int:
    """A prompt chunk's ``span`` live tokens at ``offset ..``, each over
    its causal prefix, and the head once if it completes the prompt."""
    keys = span * offset + span * (span + 1) // 2
    return layers_flops(n, span, keys) + (head_flops(n) if completes else 0)


def moe_cost(x_shape: Sequence[int], wg_shape: Sequence[int],
             wo_shape: Sequence[int], elem_size: int,
             counts: Sequence[int]):
    """(flops, bytes) of one grouped expert products call: the weights of
    each expert with rows read once, the rows read and the output written
    once, the (E,) int32 offsets; three products of 2 d f flops a row."""
    d, f, E = x_shape[1], wg_shape[-1], wg_shape[0]
    out = wo_shape[-1]
    rows = int(sum(counts))
    experts = sum(1 for c in counts if c)
    nbytes = experts * (2 * d * f + f * out) * elem_size \
        + rows * (d + out) * elem_size + 4 * E
    return 2 * rows * f * (2 * d + out), nbytes
