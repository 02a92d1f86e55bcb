"""The threefry2x32 counter-based PRNG in torch integer ops: the key
derivation and draws the reference's sampler takes from ``jax.random``
(threefry2x32, the partitionable counter layout), bit for bit.

uint32 arithmetic is done in int64 tensors masked to 32 bits (torch's
``uint32`` lacks most ops), so every function runs on CPU and CUDA
tensors alike, and is vectorised over a leading row axis: a key is an
int64 tensor ``(..., 2)`` holding two uint32 words.

* ``prng_key(seed)``          — ``jax.random.PRNGKey(seed)``: ``[0, seed]``
  for a seed in ``[0, 2**32)``;
* ``fold_in(key, data)``      — ``jax.random.fold_in``;
* ``random_bits(key, n)``     — ``jax.random.bits(key, (n,), uint32)``;
* ``uniform(key, n, minval)`` — ``jax.random.uniform(key, (n,), float32,
  minval, 1.0)``;
* ``gumbel(key, n)``          — ``jax.random.gumbel(key, (n,), float32)``
  (the ``"low"`` mode: ``-log(-log(uniform(tiny, 1)))``).

Keys, bits and uniforms are exact; the Gumbel values go through ``log``,
whose last bit may differ between libraries (the tests state the ulp
tolerance).
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
F32_TINY = 1.1754943508222875e-38  # float32's smallest normal number


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of the count pairs ``(x0, x1)`` under the key
    ``(k0, k1)``: 20 rounds, key injection every 4.  Operands are int64
    tensors holding uint32 values, broadcast together; returns the two
    hashed words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _as_words(a, device=None) -> torch.Tensor:
    """Integers in ``[0, 2**32)`` (python ints, numpy arrays or tensors) as
    an int64 tensor."""
    return torch.as_tensor(a, device=device).to(torch.int64) & M32


def prng_key(seed, device=None) -> torch.Tensor:
    """``PRNGKey(seed)`` for seeds in ``[0, 2**32)``: ``(..., 2)`` int64
    ``[0, seed]``."""
    s = _as_words(seed, device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``fold_in(key, data)``: the hash of the count pair ``(0, data)``
    (``data`` taken as uint32), rows broadcast with the key's lead."""
    d = _as_words(data, key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits for each of ``n`` counters and each key row:
    ``(..., n)`` int64 in ``[0, 2**32)``.  The partitionable layout hashes
    the 64-bit iota split in (high, low) words and XORs the two outputs."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return y0 ^ y1


def uniform(key: torch.Tensor, n: int, minval: float = 0.0) -> torch.Tensor:
    """float32 uniforms in ``[minval, 1)``: the top 23 bits as the mantissa
    of a number in ``[1, 2)``, minus one, scaled and clamped at
    ``minval`` as ``jax.random.uniform`` does (in float32)."""
    bits = random_bits(key, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # float32 scalars as python floats (exact): no host-to-device copy
    lo = float(np.float32(minval))
    scale = float(np.float32(1.0) - np.float32(minval))
    return torch.clamp(f * scale + lo, min=lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """Standard Gumbel draws, float32 ``(..., n)``."""
    return -torch.log(-torch.log(uniform(key, n, F32_TINY)))
