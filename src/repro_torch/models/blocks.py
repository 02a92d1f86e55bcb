"""Decoder block functions — the BPRR placement granularity; the dense
decoder half of the reference's ``repro/models/blocks.py``.

* ``init_decoder_block(pb, cfg)``                       -> params
* ``decoder_block_full(params, cfg, h, positions, ...)`` -> (h, cache, aux)
* ``decoder_block_decode(params, cfg, h, cache, pos, ...)`` -> (h, cache)

The decode functions update ``cache`` in place (see ``attention``).  Other
block families (MoE, MLA, RWKV6, Mamba2/zamba2, encoder-decoder) are later
slices of the port and raise ``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (ParamBuilder, apply_mlp, apply_norm,
                                       init_mlp, init_norm)

_BIG = 1 << 30


def check_supported(cfg: ModelConfig):
    """Raise ``NotImplementedError`` for what this slice of the port does
    not run yet (dense GQA decoders only)."""
    if cfg.is_enc_dec or cfg.family in ("hybrid", "ssm"):
        raise NotImplementedError(
            f"{cfg.name!r} ({cfg.family}): RWKV6, Mamba2/zamba2 and "
            "encoder-decoder stacks are a later slice of the port "
            "(ROADMAP A9)")
    if cfg.attn_kind == "mla" or cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name!r}: MLA attention and MoE FFNs are a later slice of "
            "the port (ROADMAP A9)")
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"unknown block family {cfg.family!r} for "
                         f"{cfg.name!r}")


def stack_block_kinds(cfg: ModelConfig):
    """Per-block kind tuple (length ``cfg.n_layers``) in BPRR block order."""
    check_supported(cfg)
    return ("decoder",) * cfg.n_layers


def window_for_layer(cfg: ModelConfig, layer_idx: int):
    """Per-layer sliding window (gemma3's local:global pattern) as a python
    int, or None without a window."""
    if cfg.sliding_window <= 0:
        return None
    if cfg.local_global_period <= 0:
        return cfg.sliding_window
    is_global = (int(layer_idx) + 1) % cfg.local_global_period == 0
    return _BIG if is_global else cfg.sliding_window


def init_decoder_block(pb: ParamBuilder, cfg: ModelConfig):
    check_supported(cfg)
    c = pb.child()
    c.sub("ln1", init_norm, cfg)
    c.sub("attn", attn.init_gqa, cfg)
    c.sub("ln2", init_norm, cfg)
    c.sub("ffn", init_mlp, cfg)
    if cfg.sandwich_norm:
        c.sub("post_ln1", init_norm, cfg)
        c.sub("post_ln2", init_norm, cfg)
    return c.params


def decoder_block_full(params, cfg: ModelConfig, h, positions, layer_idx=0,
                       prefix_kv=None, backend: str = "kernel"):
    """Full-sequence decoder block.  Returns (h, cache_entry, aux).

    ``prefix_kv``: optional already-cached (k, v) prefix for chunked
    prefill covering [0, P); ``positions`` must then be ``P + arange(S)``.
    The returned cache entry covers only the positions in ``h``."""
    win = window_for_layer(cfg, layer_idx)
    x = apply_norm(params["ln1"], cfg, h)
    a, kv = attn.apply_gqa_full(params["attn"], cfg, x, positions, win,
                                prefix_kv=prefix_kv, backend=backend)
    cache = {"k": kv[0], "v": kv[1]}
    if cfg.sandwich_norm:
        a = apply_norm(params["post_ln1"], cfg, a)
    h = h + a
    return decoder_block_ffn(params, cfg, h), cache, {}


def decoder_block_attn_decode(params, cfg: ModelConfig, h, cache, pos,
                              layer_idx=0, active=None,
                              backend: str = "kernel"):
    """Attention half of :func:`decoder_block_decode`: ln1 -> attention ->
    residual.  Writes the cache in place (``active`` rows only)."""
    win = window_for_layer(cfg, layer_idx)
    x = apply_norm(params["ln1"], cfg, h)
    a, ck, cv = attn.apply_gqa_decode(params["attn"], cfg, x, cache["k"],
                                      cache["v"], pos, win, active=active,
                                      backend=backend)
    if cfg.sandwich_norm:
        a = apply_norm(params["post_ln1"], cfg, a)
    return h + a, {"k": ck, "v": cv}


def decoder_block_ffn(params, cfg: ModelConfig, h):
    """FFN half: ln2 -> MLP -> residual (position-free)."""
    x = apply_norm(params["ln2"], cfg, h)
    m = apply_mlp(params["ffn"], cfg, x)
    if cfg.sandwich_norm:
        m = apply_norm(params["post_ln2"], cfg, m)
    return h + m


def decoder_block_decode(params, cfg: ModelConfig, h, cache, pos,
                         layer_idx=0, active=None, backend: str = "kernel"):
    """Single-token decoder block.  h (B,1,d); pos (B,).  Returns
    (h, cache) with the cache updated in place."""
    h, cache = decoder_block_attn_decode(params, cfg, h, cache, pos,
                                         layer_idx, active=active,
                                         backend=backend)
    return decoder_block_ffn(params, cfg, h), cache
