"""Model API for dense decoders: param init, prefill, decode — the
counterpart of the reference's ``repro/models/model.py``.

The reference scans stacked per-layer params with ``lax.scan``; here a
Python loop walks the layers of the one ``"blocks"`` segment and indexes
the stacked leaves (views, no copies).  The reference's jit has no
counterpart: PyTorch runs eagerly.  ``decode_step`` updates the caches in
place and returns the same cache tree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.layers import (ParamBuilder, embed_tokens,
                                       init_embedding, lm_head, param_dtype)


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# Stack plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SegmentSpec:
    name: str
    kind: str
    n: int


def stack_plan(cfg: ModelConfig) -> List[SegmentSpec]:
    B.check_supported(cfg)
    return [SegmentSpec("blocks", "decoder", cfg.n_layers)]


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random params with the reference's tree, shapes, dtypes and init
    scales (``model.py:114``), drawn from ``generator`` (other values than
    the reference's PRNG).  For standalone runs on the card; parity tests
    bridge the reference's own params instead (``repro_torch.weights``)."""
    params: Dict = {"embed": init_embedding(ParamBuilder(generator, device),
                                            cfg),
                    "segments": {}}
    for seg in stack_plan(cfg):
        pb = ParamBuilder(generator, device, lead=(seg.n,))
        params["segments"][seg.name] = B.init_decoder_block(pb, cfg)
    return params


def block_param_range(params, cfg: ModelConfig, kind: str, lo: int, hi: int):
    """Per-layer block params stacked on axis 0 for absolute blocks
    ``[lo, hi)`` — VIEWS of the stacked leaves, so replicas of a block on
    several virtual servers share one copy on the device."""
    if kind != "decoder":
        B.check_supported(cfg)
        raise ValueError(f"unknown block kind {kind!r}; supported: decoder")
    return tree_map(lambda x: x[lo:hi], params["segments"]["blocks"])


def layer_params(stacked, i: int):
    """Layer ``i`` of a stacked params (or cache) tree, as views."""
    return tree_map(lambda x: x[i], stacked)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def forward_full(params, cfg: ModelConfig, batch, collect_caches=False,
                 cache_len: Optional[int] = None, backend: str = "kernel"):
    """Run the stack over full sequences.  Returns (h_final, aux, caches);
    caches is {"blocks": {"k", "v": (n_layers, B, T, Kv, hd)}} when
    ``collect_caches`` (time axis grown to ``cache_len`` when given)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    h = embed_tokens(params["embed"], cfg, tokens)
    caches: Dict = {}
    aux = {}
    for seg in stack_plan(cfg):
        seg_params = params["segments"][seg.name]
        entries = []
        for i in range(seg.n):
            h, cache, _ = B.decoder_block_full(
                layer_params(seg_params, i), cfg, h, positions, i,
                backend=backend)
            if collect_caches:
                entries.append(cache)
        if collect_caches:
            caches[seg.name] = {
                key: _grow(torch.stack([e[key] for e in entries]),
                           cache_len, S)
                for key in entries[0]}
    return h, aux, caches


def _grow(x, cache_len: Optional[int], cur_len: int):
    """Zero-pad a stacked (layers, B, T, ...) cache leaf to ``cache_len``."""
    if cache_len is None or cache_len == cur_len:
        return x
    if cache_len < cur_len:
        raise ValueError("cache_len must be >= prefill length")
    pad = x.new_zeros(x.shape[:2] + (cache_len - cur_len,) + x.shape[3:])
    return torch.cat([x, pad], dim=2)


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def prefill(params, cfg: ModelConfig, batch, cache_len: Optional[int] = None,
            backend: str = "kernel"):
    """Process the prompt; returns (last-token logits, caches)."""
    h, _, caches = forward_full(params, cfg, batch, collect_caches=True,
                                cache_len=cache_len, backend=backend)
    logits = lm_head(params["embed"], cfg, h[:, -1:])
    return logits[:, 0], caches


def decode_step(params, cfg: ModelConfig, caches, tokens, pos,
                backend: str = "kernel"):
    """One decode step.  tokens (B,), pos int or (B,) tensor.  Returns
    (logits, caches); the caches are updated in place."""
    h = embed_tokens(params["embed"], cfg, tokens[:, None])
    Bsz = tokens.shape[0]
    if isinstance(pos, torch.Tensor):
        pos_t = pos.reshape(-1).expand(Bsz)
    else:
        pos_t = torch.full((Bsz,), int(pos), device=tokens.device)
    for seg in stack_plan(cfg):
        seg_params = params["segments"][seg.name]
        cache = caches[seg.name]
        for i in range(seg.n):
            h, _ = B.decoder_block_decode(
                layer_params(seg_params, i), cfg, h, layer_params(cache, i),
                pos_t, i, backend=backend)
    logits = lm_head(params["embed"], cfg, h)
    return logits[:, 0], caches


def init_decode_caches(cfg: ModelConfig, batch_size: int, cache_len: int,
                       device="cuda"):
    """Zero-initialised cache tree for decode at a given cache length."""
    caches: Dict = {}
    for seg in stack_plan(cfg):
        kv = (seg.n, batch_size, cache_len, cfg.n_kv_heads, cfg.head_dim)
        caches[seg.name] = {
            "k": torch.zeros(kv, dtype=param_dtype(cfg), device=device),
            "v": torch.zeros(kv, dtype=param_dtype(cfg), device=device)}
    return caches
