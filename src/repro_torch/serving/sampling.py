"""Token-level sampling policies for the serving engine — the reference's
``repro/serving/sampling.py`` on the port's threefry (``serving.prng``).

A session declares its policy at admission via :class:`SamplingSpec`; the
engine passes the per-row parameters (temperature, top-k, seed, token
index) to ONE vectorised sampler call per decode round, so co-resident
sessions with different policies share the round.

Determinism contract (the reference's): the key for a session's ``i``-th
generated token is ``fold_in(PRNGKey(seed), i)`` — a pure function of
(seed, token index) — so a session draws the identical stream whether it
decodes alone or among neighbours, before or after a failover replay or a
preemption (replay does not re-sample).  Keys and the uniforms under the
Gumbel draws are the reference's bit for bit; the Gumbel values go through
``log`` and may differ from XLA's in the last bits (see ``prng``).

``greedy`` is temperature 0 and reduces to ``argmax(logits)`` (the first
maximal index, as ``jnp.argmax``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.layers import lm_head
from repro_torch.serving import prng
from repro_torch.serving.kv_cache import to_device

SAMPLING_KINDS = ("greedy", "temperature", "top_k")


@dataclass(frozen=True)
class SamplingSpec:
    """Per-session token sampling policy (see the reference).

    * ``greedy``       — argmax (the default; temperature/top_k ignored).
    * ``temperature``  — softmax sampling at ``temperature``.
    * ``top_k``        — restrict to the ``top_k`` highest logits, then
      sample at ``temperature``.
    """

    kind: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.kind not in SAMPLING_KINDS:
            raise ValueError(
                f"unknown sampling kind {self.kind!r}; supported: "
                + ", ".join(SAMPLING_KINDS))
        if self.kind != "greedy" and self.temperature <= 0.0:
            raise ValueError("temperature must be > 0 for stochastic kinds")
        if self.kind == "top_k" and self.top_k <= 0:
            raise ValueError("top_k must be >= 1 for kind='top_k'")
        if not 0 <= int(self.seed) < 2 ** 32:
            raise ValueError("seed must be in [0, 2**32)")

    def row_params(self):
        """(temperature, top_k): greedy is temperature 0; top_k 0 means
        the full vocabulary."""
        if self.kind == "greedy":
            return 0.0, 0
        if self.kind == "temperature":
            return float(self.temperature), 0
        return float(self.temperature), int(self.top_k)

    def key_for(self, token_index: int) -> torch.Tensor:
        """PRNG key (2,) of this session's ``token_index``-th generated
        token; the round tail derives the same key on the device."""
        return _key_for_row(self.seed, token_index)


def _key_for_row(seed, token_index) -> torch.Tensor:
    """fold_in(PRNGKey(seed), token_index) — THE key derivation, for
    scalars or (N,) rows (tensors on any device)."""
    key = prng.prng_key(seed, getattr(seed, "device", None))
    return prng.fold_in(key, token_index)


def _sample_rows(logits, temperature, top_k, keys) -> torch.Tensor:
    """The branchless row sampler over (N, V) logits with (N,) temperature
    / top_k tensors and (N, 2) keys on the logits' device: top-k masks the
    logits below each row's k-th largest (``top_k`` 0: no mask), the
    Gumbel-max draw takes ``argmax(masked / max(T, 1e-6) + gumbel)``, and
    rows at ``T == 0`` take ``argmax(logits)``."""
    logits = logits.float()
    v = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    desc = torch.sort(logits, dim=-1, descending=True).values
    kth = desc.gather(-1, (top_k.long() - 1).clamp(0, v - 1)[:, None])
    masked = torch.where((top_k[:, None] > 0) & (logits < kth),
                         float("-inf"), logits)
    t = torch.clamp(temperature.float(), min=1e-6)[:, None]
    drawn = torch.argmax(masked / t + prng.gumbel(keys, v), dim=-1)
    return torch.where(temperature > 0.0, drawn, greedy)


def make_sampler():
    """THE row sampler: (logits (N, V), temperature (N,), top_k (N,),
    keys (N, 2)) -> (N,) tokens, every operand a tensor on one device."""
    return _sample_rows


def sample_rows(logits, temperature, top_k, seeds, token_index
                ) -> torch.Tensor:
    """Sample (N,) tokens from (N, V) logits with host (N,) row policies:
    ``temperature``, ``top_k``, ``seeds`` and ``token_index``.  A batch
    without a row above temperature 0 is one argmax: nothing is staged and
    no Gumbel is drawn.  Otherwise the rows' policies are staged to the
    logits' device (pinned, asynchronous) and the keys derived there."""
    temperature = np.asarray(temperature, np.float32)
    if not np.any(temperature > 0.0):
        return torch.argmax(logits.float(), dim=-1)
    dev = logits.device
    keys = _key_for_row(to_device(np.asarray(seeds, np.int64), dev),
                        to_device(np.asarray(token_index, np.int64), dev))
    return _sample_rows(logits, to_device(temperature, dev),
                        to_device(np.asarray(top_k, np.int64), dev), keys)


def make_round_tail(cfg, head=None):
    """THE fused decode-round tail: ONE lm_head over the round's W slots
    and one row-sampler call (``head(h_round)``: full-vocabulary logits of
    another LM head, e.g. a device group's vocab shards gathered).

    tail(embed_params, h_round (W, 1, d), temperature (W,), top_k (W,),
         seeds (W,), token_index (W,)) -> (tokens (W,), logits (W, V))

    The row policies are host arrays; unused slots carry temperature 0.
    Rows are independent throughout, so a slot's result does not depend on
    its neighbours."""

    def tail(embed_params, h_round, temperature, top_k, seeds, token_index):
        logits = (lm_head(embed_params, cfg, h_round) if head is None
                  else head(h_round))[:, 0]
        return sample_rows(logits, temperature, top_k, seeds,
                           token_index), logits

    return tail
