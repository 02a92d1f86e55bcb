"""Synthetic-data pipeline — the counterpart of the reference's
``repro/data/pipeline.py``, copied as numpy code:

* ``lm_batches`` — seeded, reproducible packed LM batches (power-law unigram
  stream packed into fixed-length rows, BOS-separated documents),
* ``encdec_batches`` — frame/token pairs for the audio enc-dec arch,
* ``shard_batch`` — put a host batch on the device, or each slot's rows
  on its device over a device group.

Determinism: batch ``i`` is a pure function of (seed, i), drawn with the
reference's numpy calls in the reference's order, so the port's tokens and
frames are bit-equal to the reference's and a restart resumes the stream
exactly (the checkpoint stores the step counter).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig

BOS = 1


def _zipf_tokens(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    """Power-law token stream (zipf-ish) clipped into the vocab."""
    raw = rng.zipf(1.3, size=n)
    return (raw % max(2, vocab - 2) + 2).astype(np.int32)


def _doc_lengths(rng: np.random.Generator, total: int) -> np.ndarray:
    out = []
    left = total
    while left > 0:
        ln = int(np.clip(rng.lognormal(5.0, 1.0), 16, 4096))
        out.append(min(ln, left))
        left -= out[-1]
    return np.asarray(out)


def lm_batches(cfg: ModelConfig, batch_size: int, seq_len: int,
               seed: int = 0, start_step: int = 0) -> Iterator[Dict]:
    """Packed LM batches: documents concatenated with BOS separators."""
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        total = batch_size * seq_len
        toks = _zipf_tokens(rng, total, cfg.vocab_size)
        pos = 0
        for ln in _doc_lengths(rng, total):
            toks[pos] = BOS
            pos += ln
        yield {"tokens": toks.reshape(batch_size, seq_len)}
        step += 1


def encdec_batches(cfg: ModelConfig, batch_size: int, seq_len: int,
                   seed: int = 0, start_step: int = 0) -> Iterator[Dict]:
    """Frame/token pairs for the audio enc-dec stub frontend."""
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step, 7))
        frames = rng.standard_normal(
            (batch_size, seq_len, cfg.frame_dim)).astype(np.float32)
        toks = _zipf_tokens(rng, batch_size * seq_len, cfg.vocab_size)
        toks = toks.reshape(batch_size, seq_len)
        toks[:, 0] = BOS
        yield {"frames": frames, "tokens": toks}
        step += 1


def make_batches(cfg: ModelConfig, batch_size: int, seq_len: int,
                 seed: int = 0, start_step: int = 0) -> Iterator[Dict]:
    if cfg.is_enc_dec:
        return encdec_batches(cfg, batch_size, seq_len, seed, start_step)
    return lm_batches(cfg, batch_size, seq_len, seed, start_step)


def shard_batch(batch: Dict, mesh=None, sh=None, device="cuda"):
    """A host batch as tensors on ``device``, through pinned non-blocking
    copies (``serving.kv_cache.to_device``: no host sync).  Over a device
    group (``mesh`` and ``sh``, a ``launch.sharding.ShardingCtx``): a list
    of per-slot dicts, each slot's rows under ``sh``'s ``batch`` rule on
    its slot's device (every slot of a data index gets that row block, one
    copy a device; all rows where the rule replicates)."""
    from repro_torch.serving.kv_cache import to_device

    if mesh is None and sh is None:
        return {k: to_device(v, device) for k, v in batch.items()}
    if mesh is None or sh is None:
        raise ValueError("shard_batch over a mesh takes both mesh and sh")
    from repro_torch.launch.sharding import slot_index

    out, staged = [], {}
    for s, dev in enumerate(mesh.slot_devices()):
        slot = {}
        for k, v in batch.items():
            axes = ("batch",) + (None,) * (v.ndim - 1)
            idx = slot_index(v.shape, sh.spec(axes, v.shape), mesh, s)
            key = (k, idx[0].start, idx[0].stop, str(dev))
            if key not in staged:
                staged[key] = to_device(np.ascontiguousarray(v[idx]), dev)
            slot[k] = staged[key]
        out.append(slot)
    return out
