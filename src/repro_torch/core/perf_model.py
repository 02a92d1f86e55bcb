"""Experimentally-validated performance models from §2.2 of the paper.

* inference-time model, eq. (1)/(4)/(8):
    per-token time at server j reached from i for client c:
        t_ij^c = t_cj + τ_j · (e_j − e_i)        (decoding phase)
    first-token analogue uses per-input RTT and per-block prefill time.
* memory-consumption model, eq. (2)/(5):
    server j hosting m_j blocks and processing k_j^r blocks per session r:
        s_m·m_j + s_c·Σ_r k_j^r  ≤  M_j
  with  s_c = 2·d_model·(l_in + l_out)·dtype_bytes  per block per session.

``LLMSpec.from_model_config`` bridges the paper's abstract model to every
assigned architecture (MLA latent caches, SSM O(1) states, sliding-window
caches — DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

GB = 1 << 30
MB = 1 << 20


# ---------------------------------------------------------------------------
# Model / workload specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LLMSpec:
    """The served model, reduced to what BPRR needs.

    ``block_tau``: optional per-block relative compute weights (length
    ``n_blocks``).  The paper's eq. (1)/(4) charge a uniform ``k_j·τ_j`` per
    hop; heterogeneous stacks (zamba2 hybrids, enc-dec) have per-FAMILY block
    costs, so a hop's compute term becomes ``τ_j · Σ_{b∈hop} w_b``.  ``None``
    keeps the paper's uniform weights (``w_b ≡ 1``).
    """

    name: str
    n_blocks: int  # L
    block_bytes: float  # s_m
    cache_bytes_per_token: float  # per block per session per token
    cache_bytes_const: float = 0.0  # O(1)-state archs (SSM): per block/session
    block_tau: Optional[Tuple[float, ...]] = None  # per-block tau weights

    def __post_init__(self):
        if self.block_tau is not None:
            object.__setattr__(self, "block_tau",
                               tuple(float(w) for w in self.block_tau))
            if len(self.block_tau) != self.n_blocks:
                raise ValueError(
                    f"block_tau has {len(self.block_tau)} weights for "
                    f"{self.n_blocks} blocks")

    def cache_bytes(self, total_tokens: int) -> float:
        """s_c for a session of l_in + l_out = total_tokens."""
        return self.cache_bytes_per_token * total_tokens + self.cache_bytes_const

    def tau_weight(self, lo: int, hi: int) -> float:
        """Σ_{b∈[lo,hi)} w_b — the weighted block count of one hop."""
        if self.block_tau is None:
            return float(hi - lo)
        return float(sum(self.block_tau[lo:hi]))

    def tau_cumweights(self) -> np.ndarray:
        """Prefix sums W with W[e] = Σ_{b<e} w_b, so a hop (e_i → e_j) costs
        ``τ_j · (W[e_j] − W[e_i])`` — the vectorised form the routing DPs
        use."""
        if self.block_tau is None:
            return np.arange(self.n_blocks + 1, dtype=float)
        return np.concatenate([[0.0], np.cumsum(self.block_tau)])

    @staticmethod
    def from_model_config(cfg, dtype_bits: int = 16) -> "LLMSpec":
        """Derive (L, s_m, s_c) from a repro_torch.configs ModelConfig."""
        dtype_bytes = dtype_bits / 8.0
        block_bytes = cfg.block_param_count() * dtype_bytes
        per_tok = 0.0
        const = 0.0
        if cfg.attn_kind == "mla":
            per_tok = (cfg.kv_lora_rank + cfg.rope_head_dim) * 2.0  # bf16 latent
        elif cfg.attn_kind == "gqa" and cfg.n_kv_heads > 0:
            per_tok = 2 * cfg.n_kv_heads * cfg.head_dim * 2.0
            if cfg.sliding_window and cfg.local_global_period:
                # only 1-in-period layers hold unbounded caches; local layers
                # are window-bounded -> fold into the constant term
                frac_global = 1.0 / cfg.local_global_period
                const = (per_tok * cfg.sliding_window
                         * (1 - frac_global))
                per_tok = per_tok * frac_global
        if cfg.family in ("ssm", "hybrid"):
            # O(1) recurrent state per block per session
            if cfg.family == "ssm":
                h, hd = cfg.ssm_heads, cfg.ssm_head_dim
                const = (h * hd * hd + 2 * cfg.d_model) * 4.0
                per_tok = 0.0
            else:  # zamba2: mamba state + shared-attn KV every Nth block
                h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
                const = (h * p * n + (cfg.conv_width - 1)
                         * (cfg.d_inner + 2 * n)) * 4.0
                per_tok = (2 * cfg.n_kv_heads * cfg.head_dim * 2.0
                           / max(1, cfg.shared_attn_period))
        return LLMSpec(name=cfg.name, n_blocks=cfg.n_layers,
                       block_bytes=block_bytes,
                       cache_bytes_per_token=per_tok,
                       cache_bytes_const=const)


# BLOOM-176B as served by PETALS (NF4-quantised blocks) — the paper's model.
BLOOM_PETALS = LLMSpec(
    name="bloom-176b-nf4",
    n_blocks=70,
    block_bytes=1.4 * GB,
    cache_bytes_per_token=2 * 14336 * 2.0,  # 2 tensors * d_model * bf16
)


@dataclass(frozen=True)
class Workload:
    """Nominal request shape (§4.1): ``l_in`` prompt tokens in,
    ``l_out`` generated tokens out — the lengths the cost and memory
    models are evaluated at."""

    l_in: int = 20
    l_out: int = 128

    @property
    def total_tokens(self) -> int:
        return self.l_in + self.l_out


# ---------------------------------------------------------------------------
# Servers / clients / network
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServerSpec:
    """τ_j, τ_j^I(l) and the effective memory M_j (paper §2.2)."""

    sid: int
    mem_bytes: float  # M_j (effective; overhead already subtracted)
    tau: float  # per-block per-token decode time (s)
    tau_prefill_base: float = 0.0  # τ^I(l) = base + per_token * l
    tau_prefill_per_token: float = 0.0

    def tau_prefill(self, l_in: int) -> float:
        return self.tau_prefill_base + self.tau_prefill_per_token * l_in


@dataclass
class Problem:
    """One BPRR instance: model, servers, clients, network, workload."""

    llm: LLMSpec
    servers: List[ServerSpec]
    n_clients: int
    rtt_token: np.ndarray  # (C, S) per-token RTT t_cj (s)
    rtt_prefill: np.ndarray  # (C, S) per-input RTT t^I_cj(l_in) (s)
    workload: Workload = Workload()

    def __post_init__(self):
        self.rtt_token = np.asarray(self.rtt_token, float)
        self.rtt_prefill = np.asarray(self.rtt_prefill, float)
        assert self.rtt_token.shape == (self.n_clients, len(self.servers))

    @property
    def n_servers(self) -> int:
        return len(self.servers)

    @property
    def L(self) -> int:
        return self.llm.n_blocks

    @property
    def s_m(self) -> float:
        return self.llm.block_bytes

    @property
    def s_c(self) -> float:
        return self.llm.cache_bytes(self.workload.total_tokens)

    def mem(self) -> np.ndarray:
        return np.asarray([s.mem_bytes for s in self.servers])

    def tau(self) -> np.ndarray:
        return np.asarray([s.tau for s in self.servers])

    def tau_prefill(self) -> np.ndarray:
        return np.asarray([s.tau_prefill(self.workload.l_in)
                           for s in self.servers])

    def t_star(self) -> np.ndarray:
        """t_*j = max_c t_cj (worst-case client RTT per server)."""
        return self.rtt_token.max(axis=0)


def with_server_taus(problem: Problem, taus: Dict[int, float]) -> Problem:
    """A copy of ``problem`` with per-server τ replaced for the given sids.

    The calibration entry point for device-group servers: the engine
    measures each server's (sharded) pooled decode step via
    ``launch.costs.tau_from_step_cost`` and this folds the result back into
    the perf model — eq. (1)'s per-token times, eq. (20)'s waiting terms,
    and the placement MILP all read τ from here.  Servers absent from
    ``taus`` keep their spec'd value."""
    servers = [dataclasses.replace(s, tau=float(taus[s.sid]))
               if s.sid in taus else s for s in problem.servers]
    return Problem(problem.llm, servers, problem.n_clients,
                   problem.rtt_token, problem.rtt_prefill, problem.workload)


# ---------------------------------------------------------------------------
# Placement / route containers + the paper's equations
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Placement:
    """Contiguous block ranges: server j hosts blocks [a[j], a[j]+m[j]).

    0-based internally (the paper is 1-based); m[j] == 0 means server unused.
    """

    a: np.ndarray
    m: np.ndarray

    def end(self) -> np.ndarray:
        return self.a + self.m

    def hosts(self, j: int, b: int) -> bool:
        return self.a[j] <= b < self.a[j] + self.m[j]

    def coverage(self, L: int) -> np.ndarray:
        """#servers hosting each block."""
        cov = np.zeros(L, int)
        for aj, mj in zip(self.a, self.m):
            cov[aj: aj + mj] += 1
        return cov

    def feasible_cover(self, L: int) -> bool:
        return bool((self.coverage(L) > 0).all())


@dataclass(frozen=True)
class Route:
    """A server chain with per-hop processed-block counts (Lemma 3.1)."""

    servers: Tuple[int, ...]
    blocks: Tuple[int, ...]  # k_j = e_j - e_i per hop

    def __post_init__(self):
        assert len(self.servers) == len(self.blocks)


def route_per_token_time(problem: Problem, route: Route, client: int) -> float:
    """Σ_{j∈p} (t_cj + k_j τ_j)  — eq (4) summed along the path.

    With per-family block weights (``LLMSpec.block_tau``) the compute term
    is ``τ_j · Σ_{b∈hop} w_b`` instead of ``τ_j · k_j``."""
    t = 0.0
    e = 0
    for j, k in zip(route.servers, route.blocks):
        t += (problem.rtt_token[client, j]
              + problem.llm.tau_weight(e, e + k) * problem.servers[j].tau)
        e += k
    return t


def route_prefill_time(problem: Problem, route: Route, client: int) -> float:
    """Σ_{j∈p} (t^I_cj + k_j τ^I_j)  — first-token part of eq (1), with the
    same per-family block weighting as :func:`route_per_token_time`."""
    t = 0.0
    e = 0
    for j, k in zip(route.servers, route.blocks):
        t += (problem.rtt_prefill[client, j]
              + problem.llm.tau_weight(e, e + k)
              * problem.servers[j].tau_prefill(problem.workload.l_in))
        e += k
    return t


def route_total_time(problem: Problem, route: Route, client: int,
                     l_out: Optional[int] = None) -> float:
    """Total inference time, eq (1)."""
    l_out = problem.workload.l_out if l_out is None else l_out
    return (route_prefill_time(problem, route, client)
            + (l_out - 1) * route_per_token_time(problem, route, client))


def route_avg_per_token_time(problem: Problem, route: Route,
                             client: int) -> float:
    """eq (8): total time amortised over all l_out tokens."""
    return (route_total_time(problem, route, client)
            / problem.workload.l_out)


def server_memory_use(problem: Problem, placement: Placement,
                      blocks_per_session: Dict[int, List[int]]) -> np.ndarray:
    """eq (5): s_m m_j + s_c Σ_sessions k_j."""
    use = problem.s_m * placement.m.astype(float)
    for j, ks in blocks_per_session.items():
        use[j] += problem.s_c * float(sum(ks))
    return use


def route_memory_per_session(problem: Problem, route: Route) -> Dict[int, float]:
    return {j: problem.s_c * k for j, k in zip(route.servers, route.blocks)}
