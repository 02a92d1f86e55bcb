"""DeepSeek-V2's published options in the port, on the CPU: a leading dense
block, group-limited greedy routing with the chosen weights x 16 (no
renormalisation), the dropless MoE on grouped expert products, YaRN, and
unpadded experts on a solo server.

The engine (batched prefill, then fused decode rounds, as the benchmark
builds it) is held against the benchmark's plain float32 reference
(``bench/reference/deepseek_v2.py``) at a reduced size with every option
on; the reference is imported with ``bench/`` on ``sys.path``, as
``bench/tests`` does."""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "bench"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

import repro_torch.core as C  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.attention import mla_softmax_scale  # noqa: E402
from repro_torch.models.layers import (yarn_correction_range,  # noqa: E402
                                       yarn_inv_freq, yarn_mscale)
from repro_torch.serving import (ContinuousBatchingScheduler,  # noqa: E402
                                 GeoServingSystem)
from repro_torch.serving.trace import Tracer  # noqa: E402

# the published config's keys (bench/configs/deepseekv2-l8.json) at a
# reduced size: 1 dense block + 3 MoE blocks, 16 experts in 4 groups (keep
# 2, top-4), 2 shared, x 16, YaRN with an original context of 64 that the
# prompts run past
REDUCED = dict(
    family="deepseek_v2", hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
    q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16, v_head_dim=16,
    qk_rope_head_dim=8, n_routed_experts=16, n_group=4, topk_group=2,
    num_experts_per_tok=4, n_shared_experts=2, moe_intermediate_size=32,
    intermediate_size=96, vocab_size=256, num_hidden_layers=4,
    first_k_dense_replace=1, norm_topk_prob=False, routed_scaling_factor=16,
    rms_norm_eps=1e-6, rope_theta=10000, max_position_embeddings=4096,
    rope_scaling=dict(type="yarn", factor=40, beta_fast=32, beta_slow=1,
                      mscale=0.707, mscale_all_dim=0.707,
                      original_max_position_embeddings=64))


def family():
    from families import deepseek_v2

    return deepseek_v2


def reduced(**kw):
    c = dict(REDUCED, **kw)
    cfg = family().port_config(c, ModelConfig).replace(
        param_dtype="float32", act_dtype="float32")
    return c, cfg


def weights(c, seed=1234):
    """The benchmark family's weight tree (``weight_spec``), in float32."""
    g = torch.Generator().manual_seed(seed)
    tree = {}
    for path, shape, _, kind, std in family().weight_spec(c):
        t = torch.randn(shape, generator=g) * std
        if kind == "one":
            t += 1.0
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def problem(n_layers):
    """Two servers: server 0 hosts [0, 2) — the dense block and the first
    MoE block, one hosted run across the segment boundary — and server 1
    [2, 4)."""
    llm = C.LLMSpec("deepseek_v2", n_layers, block_bytes=50.0,
                    cache_bytes_per_token=0.01)
    servers = [C.ServerSpec(j, 2 * 50.0 + 20.0, 0.01) for j in range(2)]
    rtt = np.full((1, 2), 0.02)
    return C.Problem(llm, servers, 1, rtt, 3 * rtt,
                     workload=C.Workload(80, 6))


# f32 on both sides, the same equations; they differ in the order of
# their sums (einsum against matmul, the absorbed decode's latent-space
# attention against the reference's unabsorbed heads, chunked heads),
# ~1e-6 of a logit of magnitude ~4: 2e-4 leaves room for that and none for
# a dropped choice, a wrong weight or rope frequency (each moves logits by
# 1e-2 or more at this size)
LOGIT_ATOL = 2e-4


def test_engine_prefill_and_fused_decode_match_the_plain_reference():
    import reference.common as ref

    c, cfg = reduced()
    w = weights(c)
    system = GeoServingSystem(
        cfg, w, problem(cfg.n_layers), algorithm="proposed", R=3,
        max_new_tokens=6, max_sessions=3, max_seq_len=96,
        prefill_mode="batched", decode_mode="fused", backend="kernel",
        cache_layout="slab", device="cpu")
    assert [int(x) for x in system.placement.a] == [0, 2]
    assert system.servers[0].kinds == ("lead", "decoder")
    rng = np.random.RandomState(3)
    prompts = [rng.randint(2, cfg.vocab_size, n) for n in (70, 66, 81)]
    sids = []
    for p in prompts:
        route, _ = C.shortest_path_route(system.problem,
                                         system.alive_placement(), 0)
        sids.append(system.create_session(p, 0, route, 6))
    assert system.try_admit_sessions(sids) == sids
    system.drain_prefill()
    hist = [[system.sessions[s].last_logits.reshape(-1).clone()
             for s in sids]]
    while any(system.sessions[s].n_generated < 6 for s in sids):
        system.decode_round()
        hist.append([system.sessions[s].last_logits.reshape(-1).clone()
                     for s in sids])
    seqs = [[int(t) for t in system.sessions[s].tokens] for s in sids]
    assert [q[:len(p)] for q, p in zip(seqs, prompts)] == \
        [list(p) for p in prompts]
    # the reference's logits at each position that chose a served token
    want = ref.run(w, c, seqs, [len(p) for p in prompts])
    for i, lg in enumerate(want):
        got = torch.stack([h[i] for h in hist[:lg.shape[0]]])
        torch.testing.assert_close(got, lg, rtol=0, atol=LOGIT_ATOL)
        # the served tokens are the engine's greedy picks
        assert [int(t) for t in got.argmax(-1)] == seqs[i][len(prompts[i]):]


def test_group_limited_greedy_gate_by_hand():
    """Scores a seeded softmax over 16 experts in 4 groups of 4: the top 2
    groups by their best member, the top 4 scores inside them, weights 16
    x score."""
    _, cfg = reduced()
    cfg = cfg.replace(d_model=16)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(64, 16, generator=g) * 2
    w, e, probs = moe.router_topk({"router": torch.eye(16)}, cfg, x)
    p = torch.softmax(x, -1).numpy()
    for t in range(64):
        best = p[t].reshape(4, 4).max(1)
        groups = np.argsort(-best)[:2]
        allowed = [j for j in range(16) if j // 4 in groups]
        top = sorted(allowed, key=lambda j: -p[t, j])[:4]
        assert sorted(e[t].tolist()) == sorted(top)
        np.testing.assert_allclose(sorted(w[t].tolist()),
                                   sorted(16 * p[t, top]), rtol=1e-6)
    torch.testing.assert_close(probs, torch.softmax(x, -1))


def test_yarn_matches_the_closed_form():
    """DeepSeek-V2's numbers: low 10, high 23, mscale(40, 0.707) = 1.2608,
    and the blend of extrapolated and interpolated frequencies."""
    assert yarn_correction_range(64, 10000.0, 4096, 32, 1) == (10, 23)
    assert yarn_mscale(40, 0.707) == pytest.approx(1.26081, abs=1e-5)
    assert yarn_mscale(1.0, 0.707) == 1.0
    got = yarn_inv_freq(64, 10000.0, 40.0, 4096, 32.0, 1.0).double()
    i = np.arange(32)
    extra = 10000.0 ** (-2 * i / 64)
    m = 1 - np.clip((i - 10) / 13, 0, 1)
    want = extra / 40 * (1 - m) + extra * m
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert got[9] == pytest.approx(extra[9], rel=1e-6)
    assert got[23] == pytest.approx(extra[23] / 40, rel=1e-6)
    cfg = family().port_config(_published(), ModelConfig)
    assert mla_softmax_scale(cfg) == pytest.approx(
        192 ** -0.5 * 1.2608 ** 2, rel=1e-4)


def _published():
    import json

    return json.loads((BENCH / "configs" / "deepseekv2-l8.json")
                      .read_text())


def _moe_params(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    d, f, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    fs = f * cfg.n_shared_experts
    r = {"router": torch.randn(d, E, generator=g) * d ** -0.5,
         "wg": torch.randn(E, d, f, generator=g) * d ** -0.5,
         "wu": torch.randn(E, d, f, generator=g) * d ** -0.5,
         "wo": torch.randn(E, f, d, generator=g) * f ** -0.5,
         "swg": torch.randn(d, fs, generator=g) * d ** -0.5,
         "swu": torch.randn(d, fs, generator=g) * d ** -0.5,
         "swo": torch.randn(fs, d, generator=g) * fs ** -0.5}
    return r


def test_dropless_computes_every_choice_under_any_load():
    """Every token's best expert is expert 0: the capacity dispatch drops
    most of them, the dropless layer none, and it equals the reference's
    per-expert loop; a row's output is the same alone as among others."""
    from reference.deepseek_v2 import moe as ref_moe

    c, cfg = reduced()
    p = _moe_params(cfg)
    p["router"][0, 0] = 50.0
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 40, cfg.d_model, generator=g)
    x[..., 0] = x[..., 0].abs() + 1.0
    out, aux = moe.apply_moe(p, cfg, x, per_row=True)
    _, cap_aux = moe.apply_moe(p, cfg.replace(moe_dropless=False), x,
                               per_row=True)
    assert float(cap_aux["moe_drop_frac"].min()) > 0.1
    assert float(aux["moe_drop_frac"].abs().max()) == 0.0
    w, e, _ = moe.router_topk(p, cfg, x.reshape(-1, cfg.d_model))
    assert bool((e == 0).any(dim=-1).all())
    for b in range(3):
        torch.testing.assert_close(out[b], ref_moe(p, c, x[b]),
                                   rtol=1e-5, atol=1e-5)
        alone, _ = moe.apply_moe(p, cfg, x[b:b + 1], per_row=True)
        # the same products of the same row: only the matmuls' row
        # blocking may differ
        torch.testing.assert_close(alone[0], out[b], rtol=1e-6, atol=1e-6)


def test_solo_server_holds_the_published_expert_count():
    """A dropless config's weights are not padded: the solo server's MoE
    run holds n_experts (DeepSeek-V2's 160, not expert_alloc's 256)."""
    from repro_torch.models.model import init_params

    full = family().port_config(_published(), ModelConfig)
    meta = init_params(full, None, "meta")
    assert meta["segments"]["blocks"]["ffn"]["wg"].shape[:2] == (7, 160)
    assert meta["segments"]["lead"]["ffn"]["wg"].shape == (1, 5120, 12288)
    assert moe.expert_alloc(160) == 256
    c, cfg = reduced(n_routed_experts=64, n_group=8, moe_intermediate_size=8)
    assert moe.expert_alloc(64) == 256
    w = weights(c)
    system = GeoServingSystem(
        cfg, w, problem(cfg.n_layers), algorithm="proposed", R=2,
        max_new_tokens=2, max_sessions=2, max_seq_len=40, device="cpu")
    moe_runs = [p for s in system.servers.values()
                for p, (kind, _, _) in zip(s.run_params, s.runs)
                if kind == "decoder"]
    assert moe_runs and all(p["ffn"]["wg"].shape[1] == 64
                            for p in moe_runs)


def test_moe_spans_and_counts_inside_the_steps():
    """With a tracer on, each ``hop`` span of a round counts the tokens its
    calls put through MoE layers and their (token, expert) pairs, from
    sizes; the tokens are the same with the tracer off."""
    c, cfg = reduced()
    w = weights(c)
    out = {}
    for on in (False, True):
        system = GeoServingSystem(
            cfg, w, problem(cfg.n_layers), algorithm="proposed", R=2,
            max_new_tokens=3, max_sessions=2, max_seq_len=40,
            prefill_mode="batched", decode_mode="fused", device="cpu")
        if on:
            system.tracer = Tracer()
        sched = ContinuousBatchingScheduler(system, R=2)
        rng = np.random.RandomState(0)
        for i, n in enumerate((9, 12)):
            sched.submit(i, rng.randint(2, cfg.vocab_size, n), 0.0, n_new=3)
        out[on] = [list(r.tokens) for r in sched.run()]
        if on:
            spans = system.tracer.spans
    assert out[True] == out[False]
    assert [s.n_moe for s in system.servers.values()] == [1, 2]
    assert not [s for s in spans if s.name == "moe"]
    hops = [s for s in spans if s.name == "hop" and "moe_tokens" in s.attrs]
    assert hops
    for s in hops:
        assert s.attrs["moe_pairs"] == 4 * s.attrs["moe_tokens"]
    decode = [s for s in hops if s.parent.name == "decode_round"]
    # a decode step runs every hosted MoE block over the server's 2 rows:
    # the dense block and 1 MoE block on server 0, 2 MoE blocks on server 1
    assert decode and all(s.attrs["moe_tokens"] in (2, 4) for s in decode)
    assert sum(s.attrs["moe_tokens"] for s in decode) == \
        6 * sum(s.name == "decode_round" for s in spans)
