"""Configuration system: architecture configs and input-shape specs.

Every assigned architecture gets a module ``repro_torch/configs/<id>.py`` exporting
``CONFIG`` (the exact full-size config from the assignment table) and
``reduced()`` (a tiny same-family config for CPU smoke tests).

``ModelConfig`` is deliberately a frozen dataclass of plain Python values so a
config hashes/compares cleanly and can be closed over by jitted functions.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Shapes (assignment: LM transformer shapes, seq_len x global_batch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell: what gets lowered in the dry-run."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters.

    The stack is described as a sequence of *scan segments* (see
    ``repro_torch.models.stacks``); which segments exist is derived from the family
    fields below.  ``n_layers`` always counts BPRR *blocks* — the granularity
    at which the paper's placement algorithm assigns work to servers.
    """

    name: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm

    n_layers: int
    d_model: int
    n_heads: int  # query heads (0 for attention-free archs)
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention flavour -------------------------------------------------
    attn_kind: str = "gqa"  # "gqa" | "mla" | "none"
    qkv_bias: bool = False
    qk_norm: bool = False
    pos_kind: str = "rope"  # "rope" | "alibi" | "none"
    rope_theta: float = 10_000.0
    # YaRN rope scaling (``rope_scaling`` type "yarn"; 0: off): the rope
    # frequencies blended between interpolated and extrapolated over the
    # dims between the beta_fast / beta_slow rotation counts at the
    # original context, and the softmax scale times mscale(factor,
    # mscale_all_dim)^2 (MLA, as DeepSeek-V2 applies it)
    yarn_factor: float = 0.0
    yarn_original_max_pos: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0
    sliding_window: int = 0  # >0: window size for local layers
    local_global_period: int = 0  # e.g. 6 => 5 local : 1 global (last in group)
    logit_softcap: float = 0.0

    # --- MLA (deepseek-v2) --------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0  # per-head rope dims for MLA

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # The published DeepSeek-V2 options, all off by default (the reference
    # has none of them).  ``n_dense_layers`` leading blocks with a dense
    # SwiGLU FFN of width ``d_ff`` (``first_k_dense_replace``; the experts'
    # width is ``d_ff_expert``), in a segment of their own ahead of the MoE
    # blocks; group-limited greedy
    # routing over ``moe_n_group`` groups keeping ``moe_topk_group``;
    # ``moe_norm_topk`` False keeps the softmax weights of the chosen
    # experts and scales them by ``moe_routed_scale`` instead of
    # renormalising; ``moe_dropless`` computes every (token, expert)
    # choice (grouped expert products) instead of the capacity dispatch
    n_dense_layers: int = 0
    moe_n_group: int = 0
    moe_topk_group: int = 0
    moe_norm_topk: bool = True
    moe_routed_scale: float = 1.0
    moe_dropless: bool = False

    # --- SSM (mamba2 / rwkv6) ------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    d_inner: int = 0
    conv_width: int = 4

    # --- hybrid (zamba2) ------------------------------------------------------
    shared_attn_period: int = 0  # apply the shared attention block every N layers

    # --- encoder-decoder (seamless) -------------------------------------------
    n_enc_layers: int = 0  # if >0, stack is enc-dec; n_layers == n_enc + n_dec
    n_dec_layers: int = 0

    # --- misc ------------------------------------------------------------------
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric
    sandwich_norm: bool = False  # post-attn/post-ffn norms (gemma3)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 1 << 19
    param_dtype: str = "bfloat16"
    act_dtype: str = "bfloat16"
    optimizer: str = "adamw"  # adamw | adafactor (memory knob for huge archs)

    # Input modality of the stub frontend ("tokens" | "frames").
    frontend: str = "tokens"
    frame_dim: int = 0  # embedding dim of precomputed frames (audio stub)

    # ------------------------------------------------------------------
    # Derived helpers
    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 64 so the vocab dim always shards
        over a 16-way model axis (Megatron-style padding; only seamless's
        256206 actually pads, to 256256).  Loss masks padded columns."""
        return ((self.vocab_size + 63) // 64) * 64

    @property
    def is_enc_dec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.attn_kind == "none" and self.shared_attn_period == 0

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (assignment: SSM / hybrid / local-global)."""
        return (
            self.family in ("ssm", "hybrid")
            or (self.sliding_window > 0 and self.local_global_period > 0)
        )

    def shapes(self) -> Tuple[ShapeSpec, ...]:
        """The applicable shape cells for this architecture."""
        out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
        if self.subquadratic:
            out.append(LONG_500K)
        return tuple(out)

    def skip_reasons(self) -> dict:
        """Shape cells skipped for this arch, with reasons (→ DESIGN.md)."""
        skips = {}
        if not self.subquadratic:
            skips["long_500k"] = (
                "pure full-attention architecture; long_500k requires "
                "sub-quadratic attention per the assignment"
            )
        return skips

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def lead_config(self) -> "ModelConfig":
        """The config the leading dense blocks run under: this one with a
        dense FFN of width ``d_ff`` and no experts."""
        return _lead_config(self)

    # ------------------------------------------------------------------
    # Parameter counting (for roofline MODEL_FLOPS and the BPRR s_m model)
    # ------------------------------------------------------------------
    def block_param_count(self) -> int:
        """Parameters in ONE transformer/SSM block (a BPRR placement unit).

        Mixed stacks return the average per-block count so that
        ``n_layers * block_param_count`` matches the stack total.
        """
        return sum(self._per_block_counts()) // max(1, self.n_layers)

    def _attn_params(self, width: Optional[int] = None) -> int:
        d = width or self.d_model
        if self.attn_kind == "mla":
            q_in = self.q_lora_rank or d
            n = 0
            if self.q_lora_rank:
                n += d * self.q_lora_rank
            n += q_in * self.n_heads * (self.head_dim + self.rope_head_dim)
            n += d * (self.kv_lora_rank + self.rope_head_dim)  # down-proj kv
            n += self.kv_lora_rank * self.n_heads * self.head_dim * 2  # k_up, v_up
            n += self.n_heads * self.head_dim * self.d_model  # out proj
            return n
        nq = d * self.n_heads * self.head_dim
        nkv = 2 * d * self.n_kv_heads * self.head_dim
        no = self.n_heads * self.head_dim * self.d_model
        bias = (self.n_heads + 2 * self.n_kv_heads) * self.head_dim if self.qkv_bias else 0
        return nq + nkv + no + bias

    def _mlp_params(self, d_ff: Optional[int] = None, width: Optional[int] = None) -> int:
        d = width or self.d_model
        f = d_ff or self.d_ff
        return 3 * d * f if self.norm_kind != "layernorm" else 2 * d * f  # gated vs plain

    def _moe_params(self) -> int:
        per_expert = 3 * self.d_model * self.d_ff_expert
        shared = self.n_shared_experts * per_expert
        router = self.d_model * self.n_experts
        return self.n_experts * per_expert + shared + router

    def _mamba_params(self) -> int:
        d, di, n, h = self.d_model, self.d_inner, self.ssm_state, self.ssm_heads
        conv_dim = di + 2 * n
        return (
            d * (2 * di + 2 * n + h)  # in_proj -> x, z, B, C, dt
            + self.conv_width * conv_dim  # depthwise conv
            + 2 * h  # A_log, D
            + di * d  # out proj
        )

    def _rwkv_params(self) -> int:
        d, f = self.d_model, self.d_ff
        tm = 4 * d * d + d * self.ssm_heads  # r,k,v,(g),w projections (approx)
        tm += d * d  # output
        lora = 6 * d * 64  # data-dependent decay low-rank (Finch)
        cm = 2 * d * f  # channel mix: key, value
        return tm + lora + cm

    def _per_block_counts(self):
        """List of per-block param counts covering all n_layers blocks."""
        counts = []
        if self.family == "ssm":  # rwkv6
            counts = [self._rwkv_params()] * self.n_layers
        elif self.family == "hybrid":  # zamba2: mamba blocks + amortized shared attn
            mamba = self._mamba_params()
            counts = [mamba] * self.n_layers
            # one shared attention+mlp block (width 2d in, d out), amortized once
            shared = self._attn_params(width=2 * self.d_model) + self._mlp_params(
                width=2 * self.d_model
            )
            counts[0] += shared
        elif self.is_enc_dec:
            enc = self._attn_params() + self._mlp_params()
            dec = 2 * self._attn_params() + self._mlp_params()  # self + cross
            counts = [enc] * self.n_enc_layers + [dec] * self.n_dec_layers
        elif self.is_moe:
            blk = self._attn_params() + self._moe_params()
            lead = self._attn_params() + self._mlp_params()
            counts = [lead] * self.n_dense_layers + \
                [blk] * (self.n_layers - self.n_dense_layers)
        else:
            blk = self._attn_params() + self._mlp_params()
            counts = [blk] * self.n_layers
        return counts

    def param_count(self) -> int:
        emb = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        if self.frontend == "frames":
            emb += self.frame_dim * self.d_model
        return sum(self._per_block_counts()) + emb + head

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        per_expert = 3 * self.d_model * self.d_ff_expert
        dense_moe = self.n_experts * per_expert
        active_moe = self.moe_top_k * per_expert
        n_moe = self.n_layers - self.n_dense_layers
        return self.param_count() - n_moe * (dense_moe - active_moe)


@functools.lru_cache(maxsize=None)
def _lead_config(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, family="dense", n_experts=0,
                               n_shared_experts=0, moe_top_k=0,
                               n_dense_layers=0)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "deepseek_v2_236b",
    "llama4_scout_17b_a16e",
    "qwen2_5_32b",
    "gemma3_4b",
    "llama3_2_1b",
    "olmo_1b",
    "chameleon_34b",
    "seamless_m4t_large_v2",
    "zamba2_7b",
    "rwkv6_7b",
)

# The paper's own model (used by the simulator / BPRR benchmarks).
PAPER_ARCH_IDS = ("bloom_176b",)


def get_config(arch_id: str) -> ModelConfig:
    import importlib

    arch_id = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def get_reduced_config(arch_id: str) -> ModelConfig:
    import importlib

    arch_id = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.reduced()
