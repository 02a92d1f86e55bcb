"""The reduced shapes of the DeepSeek-V2 cell (``deepseekv2.decode``) for
the benchmark's CPU tests, added to ``bench_support``'s before a test
imports them (``setdefault``: an entry of ``bench_support`` wins).  The
configuration keeps every published option at a reduced size: 1 dense
block and 3 MoE blocks of 16 experts in 4 groups (keep 2, top-4), 2 shared,
x 16, and YaRN over an original context of 16 that the prompts run past;
the conversation backlog is cut as the chat backlog is.  Not covered
here: a test that runs the cells in a process of its own
(``test_bench_imports``) does not load this file, and
``test_bench_control`` has no wider shape of this configuration."""
import bench_support

bench_support.REDUCED.setdefault("deepseekv2-l8", dict(
    hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
    q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16, v_head_dim=16,
    qk_rope_head_dim=8, n_routed_experts=16, n_group=4, topk_group=2,
    num_experts_per_tok=4, moe_intermediate_size=32, intermediate_size=96,
    vocab_size=256, num_hidden_layers=4,
    rope_scaling=dict(type="yarn", factor=40, beta_fast=32, beta_slow=1,
                      mscale=0.707, mscale_all_dim=0.707,
                      original_max_position_embeddings=16)))
bench_support.REDUCED_TRAFFIC.setdefault("conversation_backlog", dict(
    requests=200, open_after_rounds=4, check_requests=6,
    prompt_tokens=dict(min=8, max=24, dist="loguniform"),
    new_tokens=dict(min=6, max=12, dist="uniform"), max_seq_len=40))
