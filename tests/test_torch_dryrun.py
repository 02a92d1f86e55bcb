"""The port's dry run (``repro_torch.launch.dryrun``) and the group forms
of ``prefill`` / ``decode_step`` it counts, against the JAX reference on
the CPU.

* (a) ``python -m repro_torch.launch.dryrun --list`` prints the
  reference's ``--list`` line for line (both in subprocesses);
* (b) ``init_params_shapes`` at full width gives the reference's leaf
  shapes, dtypes and logical axes for every architecture and BLOOM-176B
  (the weight bridge maps the trees by their paths, which are the same);
* (c) the group forms of ``prefill`` and ``decode_step`` on CPU slots
  (meshes (1, 2), (2, 1), (2, 2) and a (2, 1, 2) pod mesh, the rules of
  the cell) give the solo port's logits and the reference's monolithic
  ``prefill`` / ``decode_step``'s, for every reduced architecture; the
  slots' cache shards, put back together, are the solo caches after the
  prefill and after the decode step;
* (d) the per-slot ``argument_size_in_bytes`` of reduced Llama's train,
  prefill and decode cells on a (2, 2) mesh equals the reference's
  compiled ``memory_analysis()`` on 4 forced CPU devices (a subprocess);
* (e) a (1, 2) dense decode cell's collective wire bytes equal a hand
  count of its all-reduces and its vocabulary gather;
* (f) slot 0 standing in for every slot counts what the loop over every
  slot counts (flops, bytes, wire bytes, argument bytes) on reduced
  (2, 4) cells — decode (the cache's time axis over ``model``: K1's
  partials merged) and prefill of the dense, recurrent, hybrid and
  encoder-decoder stacks; of a train cell, its flops and argument bytes
  (its loss and aux scalars live on slot 0 alone, so a slot's average
  of bytes is not slot 0's by those few scalar ops) — Llama / Gemma
  under ``attn_seq_q``, and the MoE stacks with and without ``seq_act``
  (their expert sends' wire bytes too), under the dry run's own remat
  setting;
* (g) ``lower_cell("llama3_2_1b", "decode_32k", False)`` at full width
  with every artifact key the reference's report reads; Qwen2.5-32B's
  decode cell (40 query heads on a model axis of 16: the ``head_dim``
  fallback) counts too, its q / k / v gathered over the model row;
* (h) ``report.markdown_table`` renders the port's artifacts.

Tolerances: logits at rtol 2e-4 / atol 1e-5 (tests/test_torch_model.py;
gemma3 atol 5e-5 there; zamba2 atol 1e-4 and caches 2e-4, ROADMAP C2);
every count exact.  Weights are the reference's ``init_params(PRNGKey(0),
cfg)`` bridged with ``weights.from_reference``.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_reduced_config
from repro.configs import get_config as r_get_config
from repro.models import NULL_SH
from repro.models import decode_step as r_decode_step
from repro.models import init_params as r_init_params
from repro.models import prefill as r_prefill
from repro.models.model import init_params_shapes as r_init_params_shapes
from repro_torch.configs import ShapeSpec
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.launch import report
from repro_torch.launch.dryrun import cell_specs, count_cell, lower_cell
from repro_torch.launch.mesh import GroupMesh
from repro_torch.launch.sharding import (cache_shardings, make_ctx, shard,
                                         shard_params, unshard)
from repro_torch.models import decode_step, prefill
from repro_torch.models.layers import group_ctxs, row_heads
from repro_torch.models.model import init_params_shapes
from repro_torch.weights import from_reference

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 1e-5
LOGIT_ATOL = {"gemma3_4b": 5e-5, "zamba2_7b": 1e-4}
CACHE_ATOL = {"gemma3_4b": 5e-5, "zamba2_7b": 2e-4}
B, S, T = 4, 8, 16  # rows, prompt, cache length
MESHES = [(1, 2), (2, 1), (2, 2), (2, 1, 2)]


def cpu_mesh(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return GroupMesh(np.full(shape, "cpu", dtype=object), axes)


def meta_mesh(shape):
    return GroupMesh(np.full(shape, torch.device("meta"), dtype=object))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    return env


# ---------------------------------------------------------------------------
# (a) the cell list
# ---------------------------------------------------------------------------


def test_list_matches_reference():
    out = {}
    for pkg in ("repro", "repro_torch"):
        res = subprocess.run(
            [sys.executable, "-m", f"{pkg}.launch.dryrun", "--list"],
            capture_output=True, text=True, env=_env(), timeout=300)
        assert res.returncode == 0, res.stderr
        out[pkg] = res.stdout.splitlines()
    assert out["repro_torch"] == out["repro"]
    assert len(out["repro"]) == 40


# ---------------------------------------------------------------------------
# (b) parameter shapes
# ---------------------------------------------------------------------------


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", list(ARCH_IDS) + ["bloom_176b"])
def test_init_params_shapes_match_reference(arch):
    r_shapes, r_axes = r_init_params_shapes(r_get_config(arch))
    t_shapes, t_axes = init_params_shapes(t_get_config(arch))
    want = {p: (tuple(x.shape), str(x.dtype)) for p, x in _flat(r_shapes)}
    got = {p: (tuple(x.shape), str(x.dtype).split(".")[-1])
           for p, x in _flat(t_shapes)}
    assert got == want
    assert all(x.device.type == "meta" for _, x in _flat(t_shapes))
    flat_axes = {p: tuple(a) for p, a in _flat(
        jax.tree.map(tuple, r_axes, is_leaf=lambda a: isinstance(a, tuple)))}
    assert dict(_flat(t_axes)) == flat_axes


# ---------------------------------------------------------------------------
# (c) the group forms of prefill and decode_step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def solo_run(arch):
    """Bridged params, the batch, and the reference's and the solo port's
    prefill / decode step (logits and caches)."""
    cfg = get_reduced_config(arch)
    params, _ = r_init_params(jax.random.PRNGKey(0), cfg)
    tcfg = t_get_reduced_config(arch)
    tparams = from_reference(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.RandomState(3)
    toks = rng.randint(2, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.is_enc_dec:
        batch = {"frames": rng.randn(B, S, cfg.frame_dim).astype(np.float32),
                 "tokens": toks}
    nxt = rng.randint(2, cfg.vocab_size, B).astype(np.int32)
    rl, rcache = jax.jit(lambda p, b: r_prefill(p, cfg, NULL_SH, b,
                                                cache_len=T))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    rd, _ = jax.jit(lambda p, c, t: r_decode_step(p, cfg, NULL_SH, c, t, S))(
        params, rcache, jnp.asarray(nxt))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, tcache = prefill(tparams, tcfg, tb, cache_len=T)
    td, after = decode_step(tparams, tcfg, _clone(tcache),
                            torch.from_numpy(nxt), S)
    return dict(cfg=tcfg, params=tparams, batch=tb, nxt=torch.from_numpy(nxt),
                ref=(np.asarray(rl), np.asarray(rd)), solo=(tl, td),
                caches=(tcache, after))


def _clone(tree):
    """A copy of a cache tree (an MLA layer's latent / krope stay the
    views of one buffer)."""
    if isinstance(tree, dict):
        if "latent" in tree:
            from repro_torch.models.attention import mla_cache_views
            buf = torch.cat([tree["latent"], tree["krope"]], dim=-1)
            return dict(mla_cache_views(buf, tree["latent"].shape[-1]),
                        **{k: _clone(v) for k, v in tree.items()
                           if k not in ("latent", "krope")})
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _unshard_tree(parts, specs, mesh, like):
    if isinstance(like, dict):
        return {k: _unshard_tree([p[k] for p in parts], specs[k], mesh,
                                 like[k]) for k in like}
    return unshard(parts, specs, mesh, tuple(like.shape))


def _close(got, want, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=atol, err_msg=what)


def _assert_caches(got, want, atol, what):
    for (path, g), (_, w) in zip(_flat(got), _flat(want)):
        _close(g, w, atol, f"{what} {path}")


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_group_prefill_and_decode_match_solo_and_reference(arch, shape):
    run = solo_run(arch)
    cfg = run["cfg"]
    atol = LOGIT_ATOL.get(arch, ATOL)
    mesh = cpu_mesh(shape)
    sh = make_ctx(cfg, mesh, ShapeSpec("prefill", T, B, "prefill"))
    ctxs = group_ctxs(mesh, sh.rules)
    ps = shard_params(cfg, sh, run["params"])
    bspec = sh.spec(("batch", None), (B, S))
    batches = [{} for _ in ctxs]
    for k, v in run["batch"].items():
        for d, blk in zip(batches, shard(v, bspec + (None,) * (v.dim() - 2),
                                         mesh)):
            d[k] = blk
    logits, caches = prefill(ps, cfg, batches, cache_len=T, ctxs=ctxs)
    got = torch.cat([logits[s] for s in row_heads(ctxs)])
    _close(got, run["solo"][0], atol, "prefill vs solo")
    _close(got, run["ref"][0], atol, "prefill vs reference")
    specs = cache_shardings(cfg, sh, run["caches"][0])
    _assert_caches(_unshard_tree(caches, specs, mesh, run["caches"][0]),
                   run["caches"][0], CACHE_ATOL.get(arch, ATOL),
                   "prefill caches")
    dsh = make_ctx(cfg, mesh, ShapeSpec("decode", T, B, "decode"))
    dctxs = group_ctxs(mesh, dsh.rules)
    toks = shard(run["nxt"], dsh.spec(("batch",), (B,)), mesh)
    logits, caches = decode_step(ps, cfg, caches, toks, S, ctxs=dctxs)
    got = torch.cat([logits[s] for s in row_heads(dctxs)])
    _close(got, run["solo"][1], atol, "decode vs solo")
    _close(got, run["ref"][1], atol, "decode vs reference")
    _assert_caches(_unshard_tree(caches, specs, mesh, run["caches"][1]),
                   run["caches"][1], CACHE_ATOL.get(arch, ATOL),
                   "decode caches")


# ---------------------------------------------------------------------------
# (d) argument bytes against the reference's compiled memory analysis
# ---------------------------------------------------------------------------

_REFERENCE_ARGS = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
from repro.configs import ShapeSpec, get_reduced_config
from repro.launch.dryrun import _opt_shardings, _with_shardings, param_specs
from repro.launch.mesh import compat_make_mesh
from repro.launch.sharding import batch_specs, cache_specs, make_ctx
from repro.models.model import decode_step, prefill
from repro.training.train_step import (TrainHParams, make_optimizer_for,
                                       make_train_step)

cfg = get_reduced_config("llama3_2_1b")
mesh = compat_make_mesh((2, 2), ("data", "model"))
out = {}
for kind in ("train", "prefill", "decode"):
    shape = ShapeSpec(kind, %(T)d, %(B)d, kind)
    sh = make_ctx(cfg, mesh, shape)
    params, _, pshard = param_specs(cfg, sh)
    if kind == "train":
        hp = TrainHParams(remat=True, grad_accum=1)
        opt = make_optimizer_for(cfg, hp)
        opt_shapes = jax.eval_shape(opt.init, params)
        state = {"params": params,
                 "opt": _with_shardings(opt_shapes, _opt_shardings(
                     opt, pshard, opt_shapes, mesh)),
                 "step": jax.ShapeDtypeStruct((), jnp.int32)}
        lowered = jax.jit(make_train_step(cfg, sh, opt, hp),
                          donate_argnums=0).lower(
            state, batch_specs(cfg, shape, sh))
    elif kind == "prefill":
        lowered = jax.jit(lambda p, b: prefill(
            p, cfg, sh, b, cache_len=shape.seq_len)).lower(
            params, batch_specs(cfg, shape, sh))
    else:
        caches = cache_specs(cfg, shape, sh, enc_len=shape.seq_len)
        tokens = jax.ShapeDtypeStruct((shape.global_batch,), jnp.int32,
                                      sharding=sh.named_sharding("batch"))
        lowered = jax.jit(lambda p, c, t: decode_step(
            p, cfg, sh, c, t, shape.seq_len - 1), donate_argnums=1).lower(
            params, caches, tokens)
    out[kind] = int(lowered.compile().memory_analysis()
                    .argument_size_in_bytes)
print("ARGS " + json.dumps(out))
""" % {"T": T, "B": B}


def test_argument_bytes_match_reference_memory_analysis(tmp_path):
    """Every leaf's per-slot bytes agree, so no leaf is named here: the
    params, AdamW's m / v, the int32 step, the batch, the caches and the
    tokens, each as the cell's specs shard it."""
    script = tmp_path / "ref_args.py"
    script.write_text(_REFERENCE_ARGS)
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, env=_env(), timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    line = [x for x in res.stdout.splitlines() if x.startswith("ARGS ")]
    want = json.loads(line[0][5:])
    cfg = t_get_reduced_config("llama3_2_1b")
    for kind in ("train", "prefill", "decode"):
        got = count_cell(cell_specs(cfg, ShapeSpec(kind, T, B, kind),
                                    meta_mesh((2, 2))), meta_mesh((2, 2)),
                         with_corrections=False)
        assert got["memory"]["argument_size_in_bytes"] == want[kind], kind


# ---------------------------------------------------------------------------
# (e) collective bytes by hand
# ---------------------------------------------------------------------------


def test_dense_decode_wire_bytes_by_hand():
    """Reduced Llama (4 heads, 2 KV heads, f32) decoding on (1, 2): each
    slot all-reduces (2 (g-1)/g N, g = 2) the vocab-parallel embedding's
    rows and, in each layer, the attention's and the MLP's output (B, 1,
    d), and all-gathers ((g-1)/g of the gathered N) the logits' vocabulary
    shards (B, 1, V / 2); the KV heads split over the model axis, so the
    cache's time axis is whole and nothing is merged."""
    cfg = t_get_reduced_config("llama3_2_1b")
    assert cfg.n_kv_heads % 2 == 0 and cfg.padded_vocab % 2 == 0
    mesh = meta_mesh((1, 2))
    got = count_cell(cell_specs(cfg, ShapeSpec("decode", T, B, "decode"),
                                mesh), mesh, with_corrections=False)["cost"]
    row = B * cfg.d_model * 4
    reduce = 2 * (2 - 1) / 2 * row * (1 + 2 * cfg.n_layers)
    gather = (2 - 1) / 2 * (2 * B * cfg.padded_vocab // 2 * 4)
    assert got.coll_by_kind == {"all-reduce": reduce, "all-gather": gather}
    assert got.coll_wire_bytes == reduce + gather
    assert got.coll_count == 2 + 2 * cfg.n_layers


# ---------------------------------------------------------------------------
# (f) slot 0 standing in for every slot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("arch", ["llama3_2_1b", "rwkv6_7b", "zamba2_7b",
                                  "seamless_m4t_large_v2"])
def test_stand_in_counts_the_slot_loop(arch, kind):
    cfg = t_get_reduced_config(arch)
    mesh = meta_mesh((2, 4))
    shape = ShapeSpec(kind, T, 8, kind)
    loop = count_cell(cell_specs(cfg, shape, mesh, stand_in=False), mesh,
                      with_corrections=False)
    one = count_cell(cell_specs(cfg, shape, mesh), mesh,
                     with_corrections=False)
    assert one["cost"].to_dict() == loop["cost"].to_dict()
    assert one["kernel_cost"].to_dict() == loop["kernel_cost"].to_dict()
    assert one["memory"]["argument_size_in_bytes"] == \
        loop["memory"]["argument_size_in_bytes"]
    if arch == "llama3_2_1b" and kind == "decode":  # K1 partials merged
        assert one["cost"].coll_by_kind["merge"] > 0


@pytest.mark.parametrize("arch", ["llama3_2_1b", "gemma3_4b"])
def test_stand_in_counts_the_slot_loop_in_training(arch):
    """A train cell under ``attn_seq_q`` and the ``head_dim`` fallback (4
    heads on a model row of 8), at a length where the plain attention
    skips the chunks above each row block's diagonal, so that the slots'
    work differs: the stand-in counts every block's forward and backward
    at 1/8, the slot loop's flops exactly.  Both run under the dry run's
    own remat setting (``models.model._call``: the recompute's early stop
    off, as in the training step), with nothing set here."""
    cfg = t_get_reduced_config(arch)
    mesh = meta_mesh((1, 8))
    shape = ShapeSpec("train", 4096, 2, "train")
    rules = make_ctx(cfg, mesh, shape).rules
    assert rules["attn_seq_q"] == rules["head_dim"] == "model"
    loop = count_cell(cell_specs(cfg, shape, mesh, stand_in=False),
                      mesh, with_corrections=False)
    one = count_cell(cell_specs(cfg, shape, mesh), mesh,
                     with_corrections=False)
    assert one["cost"].flops == loop["cost"].flops > 0


@pytest.mark.parametrize("seq_act", [False, True], ids=["rows", "seq_act"])
@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e",
                                  "deepseek_v2_236b"])
def test_stand_in_counts_the_slot_loop_in_moe_training(arch, seq_act):
    """An MoE train cell on a (2, 2) meta mesh (the unpadded MoE's
    kept-row sends, each source at its even share of the capacity on meta
    tensors; DeepSeek-V2 with Adafactor's update on each slot's block),
    under its own rules and under rules that set ``seq_act`` (a remat
    stash past 8e9 bytes) at its small batch: the stand-in's flops,
    argument bytes and MoE wire bytes are the slot loop's."""
    cfg = t_get_reduced_config(arch)
    mesh = meta_mesh((2, 2))
    shape = ShapeSpec("train", 64, 4, "train")
    rules = make_ctx(cfg, mesh, ShapeSpec("train_seq_act", 1 << 20, 64,
                                          "train")).rules if seq_act \
        else None
    loop = count_cell(cell_specs(cfg, shape, mesh, stand_in=False,
                                 rules=rules), mesh, with_corrections=False)
    one = count_cell(cell_specs(cfg, shape, mesh, rules=rules), mesh,
                     with_corrections=False)
    assert one["cost"].flops == loop["cost"].flops > 0
    assert one["memory"]["argument_size_in_bytes"] == \
        loop["memory"]["argument_size_in_bytes"]
    for kind in ("moe-dispatch", "moe-return"):
        assert one["cost"].coll_by_kind[kind] == \
            loop["cost"].coll_by_kind[kind] > 0


def test_train_cell_counts_the_optimizer_state_in_f32():
    """A bf16 train cell's argument bytes are slot 0's training state as
    the group step holds it — the params' bf16 shards, AdamW's f32
    moments of them, the step — and its batch block: the moments in f32
    whatever the params' dtype, as both packages' optimizers keep them."""
    from repro_torch.models.model import tree_nbytes
    from repro_torch.training.train_step import (GroupLayout,
                                                 make_optimizer_for)
    from repro_torch.training import TrainHParams
    from repro_torch.training.optimizer import tree_leaves

    cfg = t_get_reduced_config("llama3_2_1b").replace(
        param_dtype="bfloat16", act_dtype="bfloat16")
    mesh = meta_mesh((2, 2))
    shape = ShapeSpec("train", 64, 4, "train")
    spec = cell_specs(cfg, shape, mesh)
    got = count_cell(spec, mesh, with_corrections=False)
    opt = make_optimizer_for(cfg, TrainHParams())
    state = GroupLayout(cfg, spec["sh"]).init_state(spec["params"], opt)
    moments = tree_nbytes(state["opt"][0])
    assert moments == 8 * sum(x.numel() for x in
                              tree_leaves(state["params"][0]))
    assert got["memory"]["argument_size_in_bytes"] == (
        tree_nbytes(state["params"][0]) + moments + 4
        + 2 * 64 * 4)  # int32 tokens of the slot's 2 rows


# ---------------------------------------------------------------------------
# (g) a full-width cell, (h) the report
# ---------------------------------------------------------------------------

ARTIFACT_KEYS = {"arch", "shape", "mesh", "n_chips", "count_seconds",
                 "memory", "raw_cost", "corrected_cost", "segments",
                 "aten_flops", "collective_bytes", "kernel_cost",
                 "roofline", "model_flops_per_device", "useful_flops_ratio",
                 "fits_hbm_80g"}


@functools.lru_cache(maxsize=None)
def llama_decode_cell():
    return lower_cell("llama3_2_1b", "decode_32k", False)


def test_full_width_cell_and_unported_rules():
    art = llama_decode_cell()
    assert ARTIFACT_KEYS <= set(art)
    assert art["n_chips"] == 256 and art["mesh"] == "16x16"
    assert set(art["memory"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes", "peak_hbm_bytes"}
    assert {"compute_s", "memory_s", "memory_s_floor", "collective_s",
            "dominant", "bound_s"} <= set(art["roofline"])
    assert art["corrected_cost"] == art["raw_cost"]
    assert art["segments"]["blocks"]["n"] == 16
    assert art["raw_cost"]["flops"] > 0 and art["fits_hbm_80g"]
    assert art["raw_cost"]["coll_by_kind"]["merge"] > 0  # time shards
    # the collectives' own sums and copies: a part of the bytes
    assert 0 < art["collective_bytes"] < art["raw_cost"]["bytes_accessed"]
    json.dumps(art)
    qwen = lower_cell("qwen2_5_32b", "decode_32k", False)
    assert ARTIFACT_KEYS <= set(qwen) and qwen["fits_hbm_80g"]
    assert qwen["raw_cost"]["flops"] > 0
    coll = qwen["raw_cost"]["coll_by_kind"]
    assert coll["all-gather"] > 0 and coll["merge"] > 0
    json.dumps(qwen)


def test_report_renders_artifacts(tmp_path):
    art = llama_decode_cell()
    (tmp_path / "llama3_2_1b__decode_32k__single.json").write_text(
        json.dumps(art))
    rows = report.load(str(tmp_path))
    table = report.markdown_table(rows, "16x16")
    assert "fits 80 GB" in table and "tpu" not in table
    line = [x for x in table.splitlines() if x.startswith("| llama3_2_1b")]
    assert len(line) == 1 and "| decode_32k |" in line[0]
    assert "llama3_2_1b/decode_32k" in report.summary(rows)
    assert report.markdown_table(rows, "2x16x16").count("\n") == 1
    pair = report.paired_table(rows).splitlines()
    assert len(pair) == 3 and pair[2].startswith("| llama3_2_1b | decode_32k")
    assert pair[2].count(" / —") == 8
