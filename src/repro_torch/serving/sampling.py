"""Token selection for the serving engine: the greedy part of the
reference's ``repro/serving/sampling.py``.

``SamplingSpec`` validates like the reference.  Only greedy decoding runs
in this slice: the reference draws temperature / top-k tokens from
threefry keys ``fold_in(PRNGKey(seed), i)``, and matching those streams
bit for bit is ROADMAP A6 — a row with ``temperature > 0`` raises
``NotImplementedError`` here.  Greedy is ``argmax(logits)`` with the first
maximal index winning, as ``jnp.argmax``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.layers import lm_head

SAMPLING_KINDS = ("greedy", "temperature", "top_k")


@dataclass(frozen=True)
class SamplingSpec:
    """Per-session token sampling policy (see the reference)."""

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
        """(temperature, top_k): greedy is temperature 0."""
        if self.kind == "greedy":
            return 0.0, 0
        if self.kind == "temperature":
            return float(self.temperature), 0
        return float(self.temperature), int(self.top_k)


def _require_greedy(temperature):
    if np.any(np.asarray(temperature) > 0.0):
        raise NotImplementedError(
            "temperature / top-k sampling needs the reference's threefry "
            "key streams (ROADMAP A6); this slice decodes greedily")


def sample_tokens(logits, temperature) -> torch.Tensor:
    """Greedy row sampler: logits (N, V) -> (N,) tokens.  ``temperature``
    is the host-side (N,) row policy; any row above 0 raises."""
    _require_greedy(temperature)
    return torch.argmax(logits.float(), dim=-1)


def make_round_tail(cfg):
    """THE fused decode-round tail: ONE lm_head over the round's W slots
    and one argmax.

    tail(embed_params, h_round (W, 1, d), temperature (W,))
        -> (tokens (W,), logits (W, V))

    The row temperatures are a host array (no transfer); unused slots
    carry temperature 0.  Rows are independent throughout, so a slot's result
    does not depend on its neighbours."""

    def tail(embed_params, h_round, temperature):
        _require_greedy(temperature)
        logits = lm_head(embed_params, cfg, h_round)[:, 0]
        return torch.argmax(logits.float(), dim=-1), logits

    return tail
