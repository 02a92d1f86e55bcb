"""DeepSeek-V2: MLA with YaRN rope, a leading dense SwiGLU block, then MoE
blocks with group-limited greedy routing over 160 experts (top-6, weights
x 16, no renormalisation), 2 shared experts, an untied head.

Importing this module (the harness does, before it builds the system)
puts :data:`CALLS` on the port's grouped expert products: while
``torch.profiler`` records, each call's shapes and its device tensor of
per-expert row counts are kept, stamped on ``time.perf_counter``, for the
``moe_*`` readers.  The wrapper reads nothing on the host."""
from __future__ import annotations

import time
from typing import List

import torch


def dims(c):
    d, H = c["hidden_size"], c["num_attention_heads"]
    return dict(
        d=d, heads=H, kv_heads=c["num_key_value_heads"],
        head_dim=c["qk_nope_head_dim"], d_ff=c["intermediate_size"],
        gated=True, layers=c["num_hidden_layers"], vocab=c["vocab_size"],
        q_lora=c["q_lora_rank"], kv_lora=c["kv_lora_rank"],
        nope=c["qk_nope_head_dim"], rope=c["qk_rope_head_dim"],
        v_dim=c["v_head_dim"], experts=c["n_routed_experts"],
        topk=c["num_experts_per_tok"], expert_ff=c["moe_intermediate_size"],
        shared_ff=c["n_shared_experts"] * c["moe_intermediate_size"],
        n_dense=c["first_k_dense_replace"])


def port_config(c, ModelConfig):
    n = dims(c)
    if n["v_dim"] != n["nope"]:
        raise ValueError("the port's MLA takes v_head_dim == "
                         "qk_nope_head_dim")
    y = c["rope_scaling"]
    return ModelConfig(
        name=f"deepseek-v2-{n['layers']}l", family="moe",
        n_layers=n["layers"], d_model=n["d"], n_heads=n["heads"],
        n_kv_heads=n["kv_heads"], head_dim=n["nope"], d_ff=n["d_ff"],
        vocab_size=n["vocab"], attn_kind="mla", kv_lora_rank=n["kv_lora"],
        q_lora_rank=n["q_lora"], rope_head_dim=n["rope"],
        rope_theta=float(c["rope_theta"]), n_experts=n["experts"],
        n_shared_experts=c["n_shared_experts"], moe_top_k=n["topk"],
        d_ff_expert=n["expert_ff"], norm_kind="rmsnorm",
        norm_eps=c["rms_norm_eps"], tie_embeddings=False,
        max_seq_len=c["max_position_embeddings"],
        n_dense_layers=n["n_dense"],
        moe_n_group=c["n_group"], moe_topk_group=c["topk_group"],
        moe_norm_topk=bool(c["norm_topk_prob"]),
        moe_routed_scale=float(c["routed_scaling_factor"]),
        moe_dropless=True, yarn_factor=float(y["factor"]),
        yarn_original_max_pos=int(y["original_max_position_embeddings"]),
        yarn_beta_fast=float(y["beta_fast"]),
        yarn_beta_slow=float(y["beta_slow"]),
        yarn_mscale=float(y["mscale"]),
        yarn_mscale_all_dim=float(y["mscale_all_dim"]))


def _attn_spec(seg, L, n):
    d, H, ql, kl = n["d"], n["heads"], n["q_lora"], n["kv_lora"]
    nope, rope = n["nope"], n["rope"]
    a = seg + ("attn",)
    return [
        (seg + ("ln1", "scale"), (L, d), "float32", "one", 0.1),
        (a + ("wdq",), (L, d, ql), "bfloat16", "normal", d ** -0.5),
        (a + ("q_norm",), (L, ql), "float32", "one", 0.1),
        (a + ("wuq",), (L, ql, H, nope + rope), "bfloat16", "normal",
         ql ** -0.5),
        (a + ("wdkv",), (L, d, kl + rope), "bfloat16", "normal", d ** -0.5),
        (a + ("kv_norm",), (L, kl), "float32", "one", 0.1),
        (a + ("wuk",), (L, kl, H, nope), "bfloat16", "normal", kl ** -0.5),
        (a + ("wuv",), (L, kl, H, nope), "bfloat16", "normal", kl ** -0.5),
        (a + ("wo",), (L, H, nope, d), "bfloat16", "normal",
         (H * nope) ** -0.5),
        (seg + ("ln2", "scale"), (L, d), "float32", "one", 0.1),
    ]


def routed_weight_sum(c, samples: int = 20000) -> float:
    """The mean of a token's routed weights' sum, ``routed_scaling_factor
    x`` the chosen softmax scores, under the router this module draws
    (logits N(0, 1) for an RMS-normed input), by the config's gate: 3.18
    for DeepSeek-V2's 160 experts, 8 groups keeping 3, top-6, x 16.  A
    fixed seeded draw on the CPU (1 where the weights are renormalised)."""
    if c["norm_topk_prob"]:
        return 1.0
    E, G = c["n_routed_experts"], c["n_group"]
    g = torch.Generator().manual_seed(0)
    s = torch.softmax(torch.randn(samples, E, generator=g), dim=-1)
    best = s.reshape(samples, G, E // G).amax(dim=-1)
    kept = torch.topk(best, c["topk_group"], dim=-1).indices
    mask = torch.zeros_like(best).scatter_(1, kept, 1.0)
    w = torch.topk(s * mask.repeat_interleave(E // G, dim=1),
                   c["num_experts_per_tok"], dim=-1).values
    return float(w.sum(dim=-1).mean()) * c["routed_scaling_factor"]


def weight_spec(c):
    """(path, shape, dtype, kind, std): every matrix N(0, 1/fan_in) in bf16
    (its output O(1) per element for an O(1) input), the router's (d, E)
    in f32 at 1/sqrt(d) too (logits N(0, 1) over the experts, so the
    softmax picks from a spread, not a tie); norm scales 1 + N(0, 0.1^2)
    in f32.  The routed experts' down projections are further divided by
    :func:`routed_weight_sum` (3.18): the routed sum's weights, 16 x the
    chosen softmax scores, add up to that on average, so the divided sum
    stays the size of one expert's output, O(1) like every other branch
    of the residual stream.  160 experts, unpadded."""
    n = dims(c)
    d, f, E, fs, V = n["d"], n["expert_ff"], n["experts"], n["shared_ff"], \
        n["vocab"]
    F = n["d_ff"]
    L0, L = n["n_dense"], n["layers"] - n["n_dense"]
    lead, b = ("segments", "lead"), ("segments", "blocks")
    return [
        (("embed", "tok"), (V, d), "bfloat16", "normal", d ** -0.5),
        (("embed", "head"), (d, V), "bfloat16", "normal", d ** -0.5),
        (("embed", "final_norm", "scale"), (d,), "float32", "one", 0.1),
    ] + _attn_spec(lead, L0, n) + [
        (lead + ("ffn", "wg"), (L0, d, F), "bfloat16", "normal", d ** -0.5),
        (lead + ("ffn", "wu"), (L0, d, F), "bfloat16", "normal", d ** -0.5),
        (lead + ("ffn", "wo"), (L0, F, d), "bfloat16", "normal", F ** -0.5),
    ] + _attn_spec(b, L, n) + [
        (b + ("ffn", "router"), (L, d, E), "float32", "normal", d ** -0.5),
        (b + ("ffn", "wg"), (L, E, d, f), "bfloat16", "normal", d ** -0.5),
        (b + ("ffn", "wu"), (L, E, d, f), "bfloat16", "normal", d ** -0.5),
        (b + ("ffn", "wo"), (L, E, f, d), "bfloat16", "normal",
         f ** -0.5 / routed_weight_sum(c)),
        (b + ("ffn", "swg"), (L, d, fs), "bfloat16", "normal", d ** -0.5),
        (b + ("ffn", "swu"), (L, d, fs), "bfloat16", "normal", d ** -0.5),
        (b + ("ffn", "swo"), (L, fs, d), "bfloat16", "normal", fs ** -0.5),
    ]


class ExpertCalls:
    """The grouped expert products' calls while ``torch.profiler`` records:
    [(perf_counter stamp, rows (M, d) shape, wg shape, wo shape, element
    size, the call's (E,) int32 offsets cloned on the device)].  The
    wrapper replaces ``repro_torch.kernels.moe_experts.grouped_experts``,
    the attribute the MoE layer calls."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.calls: List[tuple] = []
        self.real = None

    def install(self) -> None:
        from repro_torch.kernels import moe_experts

        if self.real is not None:
            return
        self.real = real = moe_experts.grouped_experts

        def grouped_experts(x, wg, wu, wo, offs):
            if torch.autograd._profiler_enabled():
                self.calls.append((self.clock(), tuple(x.shape),
                                   tuple(wg.shape), tuple(wo.shape),
                                   x.element_size(), offs.clone()))
            return real(x, wg, wu, wo, offs)

        moe_experts.grouped_experts = grouped_experts

    def inside(self, t_open: float, t_close: float):
        """[(x shape, wg shape, wo shape, element size, per-expert row
        counts)] of the calls stamped inside the window, the counts read in
        one transfer."""
        calls = [c for c in self.calls if t_open < c[0] <= t_close]
        if not calls:
            return []
        offs = torch.stack([c[5] for c in calls]).to(torch.int64)
        counts = torch.diff(offs, dim=1, prepend=torch.zeros_like(
            offs[:, :1])).tolist()
        return [c[1:5] + (n,) for c, n in zip(calls, counts)]


CALLS = ExpertCalls()
CALLS.install()
