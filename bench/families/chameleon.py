"""Chameleon: GQA with RMS qk-norm and RoPE, RMSNorm, SwiGLU, untied head."""
from __future__ import annotations


def dims(c):
    d, H = c["hidden_size"], c["num_attention_heads"]
    return dict(d=d, heads=H, kv_heads=c["num_key_value_heads"],
                head_dim=d // H, d_ff=c["intermediate_size"], gated=True,
                layers=c["num_hidden_layers"], vocab=c["vocab_size"])


def port_config(c, ModelConfig):
    n = dims(c)
    return ModelConfig(
        name=f"chameleon-{n['layers']}l", family="vlm",
        n_layers=n["layers"], d_model=n["d"], n_heads=n["heads"],
        n_kv_heads=n["kv_heads"], head_dim=n["head_dim"], d_ff=n["d_ff"],
        vocab_size=n["vocab"], attn_kind="gqa",
        qk_norm=bool(c["qk_layernorm"]), pos_kind="rope",
        rope_theta=float(c["rope_theta"]), norm_kind="rmsnorm",
        norm_eps=c["rms_norm_eps"], tie_embeddings=False)


def weight_spec(c):
    """As ``families.bloom.weight_spec``: bf16 matrices at 1/sqrt(fan_in),
    f32 norm and qk-norm scales at 1 + N(0, 0.1^2)."""
    n = dims(c)
    d, H, Kv, hd, f, L, V = (n[k] for k in ("d", "heads", "kv_heads",
                                            "head_dim", "d_ff", "layers",
                                            "vocab"))
    b = ("segments", "blocks")
    return [
        (("embed", "tok"), (V, d), "bfloat16", "normal", d ** -0.5),
        (("embed", "head"), (d, V), "bfloat16", "normal", d ** -0.5),
        (("embed", "final_norm", "scale"), (d,), "float32", "one", 0.1),
        (b + ("ln1", "scale"), (L, d), "float32", "one", 0.1),
        (b + ("attn", "wq"), (L, d, H, hd), "bfloat16", "normal", d ** -0.5),
        (b + ("attn", "wk"), (L, d, Kv, hd), "bfloat16", "normal",
         d ** -0.5),
        (b + ("attn", "wv"), (L, d, Kv, hd), "bfloat16", "normal",
         d ** -0.5),
        (b + ("attn", "wo"), (L, H, hd, d), "bfloat16", "normal",
         (H * hd) ** -0.5),
        (b + ("attn", "q_norm"), (L, hd), "float32", "one", 0.1),
        (b + ("attn", "k_norm"), (L, hd), "float32", "one", 0.1),
        (b + ("ln2", "scale"), (L, d), "float32", "one", 0.1),
        (b + ("ffn", "wg"), (L, d, f), "bfloat16", "normal", d ** -0.5),
        (b + ("ffn", "wu"), (L, d, f), "bfloat16", "normal", d ** -0.5),
        (b + ("ffn", "wo"), (L, f, d), "bfloat16", "normal", f ** -0.5),
    ]
