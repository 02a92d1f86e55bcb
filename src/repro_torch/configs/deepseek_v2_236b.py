"""DeepSeek-V2 236B [arXiv:2405.04434; hf].

60L d_model=5120 128H d_ff(expert)=1536 vocab=102400, MoE 160 routed experts
top-6 + 2 shared, MLA with kv_lora_rank=512 (+64 rope dims), q_lora_rank=1536.

This config is the reference's (``repro/configs``), which every parity test
holds the port to: uniform MoE layers with renormalised plain top-6 routing,
capacity dispatch, experts padded to 256 for expert parallelism, and plain
RoPE (DESIGN.md §5).  The published model's options — a dense first layer
(``n_dense_layers``, of width ``d_ff``), group-limited greedy routing
(``moe_n_group`` / ``moe_topk_group``) with the weights x 16 and not
renormalised (``moe_norm_topk``, ``moe_routed_scale``), dropless unpadded
experts (``moe_dropless``) and YaRN (``yarn_*``) — exist in
``ModelConfig``, off here.  ``bench/configs/deepseekv2-l8.json`` turns them
on (through ``bench/families/deepseek_v2.py``), on solo servers, and
``tests/test_torch_deepseek_v2_published.py`` holds them to a plain
reference.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=1536,
    vocab_size=102400,
    attn_kind="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    n_experts=160,
    n_shared_experts=2,
    moe_top_k=6,
    d_ff_expert=1536,
    rope_theta=10_000.0,
    norm_kind="rmsnorm",
    max_seq_len=131072,
    # factored second moments: the 236B cell is HBM-bound on 16 GB v5e
    # chips (EXPERIMENTS.md §Perf iter A4)
    optimizer="adafactor",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-v2-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=48,
        d_ff_expert=48,
        vocab_size=256,
        kv_lora_rank=32,
        q_lora_rank=48,
        rope_head_dim=8,
        n_experts=8,
        n_shared_experts=1,
        moe_top_k=2,
        max_seq_len=512,
        param_dtype="float32",
        act_dtype="float32",
    )
