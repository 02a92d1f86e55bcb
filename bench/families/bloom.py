"""BLOOM: multi-head attention with ALiBi, LayerNorm, GeLU MLP, tied head."""
from __future__ import annotations


def dims(c):
    d, H = c["hidden_size"], c["n_head"]
    return dict(d=d, heads=H, kv_heads=H, head_dim=d // H, d_ff=4 * d,
                gated=False, layers=c["n_layer"], vocab=c["vocab_size"])


def port_config(c, ModelConfig):
    n = dims(c)
    return ModelConfig(
        name=f"bloom-{n['layers']}l", family="dense", n_layers=n["layers"],
        d_model=n["d"], n_heads=n["heads"], n_kv_heads=n["kv_heads"],
        head_dim=n["head_dim"], d_ff=n["d_ff"], vocab_size=n["vocab"],
        attn_kind="gqa", pos_kind="alibi", norm_kind="layernorm",
        norm_eps=c["layer_norm_epsilon"], tie_embeddings=True)


def weight_spec(c):
    """(path, shape, dtype, kind, std): matrices drawn N(0, std^2) with std
    1/sqrt(fan_in) in bf16; norm scales 1 + N(0, 0.1^2) and biases
    N(0, 0.1^2) in f32 (the port keeps them in f32)."""
    n = dims(c)
    d, H, hd, f, L, V = (n[k] for k in ("d", "heads", "head_dim", "d_ff",
                                        "layers", "vocab"))
    b = ("segments", "blocks")
    return [
        (("embed", "tok"), (V, d), "bfloat16", "normal", d ** -0.5),
        (("embed", "final_norm", "scale"), (d,), "float32", "one", 0.1),
        (("embed", "final_norm", "bias"), (d,), "float32", "normal", 0.1),
        (b + ("ln1", "scale"), (L, d), "float32", "one", 0.1),
        (b + ("ln1", "bias"), (L, d), "float32", "normal", 0.1),
        (b + ("attn", "wq"), (L, d, H, hd), "bfloat16", "normal", d ** -0.5),
        (b + ("attn", "wk"), (L, d, H, hd), "bfloat16", "normal", d ** -0.5),
        (b + ("attn", "wv"), (L, d, H, hd), "bfloat16", "normal", d ** -0.5),
        (b + ("attn", "wo"), (L, H, hd, d), "bfloat16", "normal",
         (H * hd) ** -0.5),
        (b + ("ln2", "scale"), (L, d), "float32", "one", 0.1),
        (b + ("ln2", "bias"), (L, d), "float32", "normal", 0.1),
        (b + ("ffn", "wi"), (L, d, f), "bfloat16", "normal", d ** -0.5),
        (b + ("ffn", "wo"), (L, f, d), "bfloat16", "normal", f ** -0.5),
    ]
