"""The reference's three activation layout rules in the port's group
training step, against the port's solo step and the JAX reference on the
CPU (a group's slots all name the ``cpu`` device).

* ``seq_act`` (Megatron-SP): every reduced architecture on meshes (1, 2)
  and (2, 2) under ``make_ctx`` at a train shape whose remat stash passes
  8e9 bytes (2^20 positions x 64 rows, so ``make_rules`` sets it), run on
  the tests' B 4 x S 16 batch — the loss, the metrics and every gradient
  leaf against the solo port's ``train_loss`` and the reference's
  ``jax.value_and_grad``; each slot's remat stash (the block inputs the
  checkpoint keeps) holds S/M positions; a block's wire bytes equal the
  same block's without the rule (ring model: all-reduce = reduce-scatter
  + all-gather);
* ``attn_seq_q`` and the ``head_dim`` fallback: every reduced
  architecture with attention on a (1, 8) mesh (4 query heads do not
  divide 8; head_dim 16 or 32 does), and Llama and Gemma on (2, 8) —
  the same loss and gradient checks;
* ``make_train_step`` over a (2, 8) group under all three rules at once:
  two AdamW steps at the solo step's loss, after which every slot holding
  a leaf's block holds it bit for bit alike.

Tolerances (tests/test_torch_group_training.py's): losses at rtol 2e-4 /
atol 1e-5; a gradient leaf at max|got - want| <= atol + rtol * max|want|
with (1e-5, 2e-4), zamba2 (1e-4, 1e-3) (ROADMAP C2).  Weights are the
reference's ``init_params(PRNGKey(0), cfg)`` bridged with
``weights.from_reference``; batches come from both packages'
``make_batches`` (asserted bit-equal).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_reduced_config
from repro.data import make_batches as r_make_batches
from repro.models import NULL_SH as R_NULL_SH, init_params as r_init_params
from repro.models.model import train_loss as r_train_loss
from repro_torch.configs import SHAPES_BY_NAME, ShapeSpec
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.data import make_batches, shard_batch
from repro_torch.launch.mesh import GroupMesh
from repro_torch.launch.sharding import make_ctx
from repro_torch.models import model as TMODEL
from repro_torch.models import train_loss
from repro_torch.models.layers import count_collectives, seq_ctxs
from repro_torch.training import (TrainHParams, init_train_state,
                                  make_optimizer_for, make_train_step)
from repro_torch.training.optimizer import tree_items, tree_leaves, tree_map
from repro_torch.training.train_step import GroupLayout
from repro_torch.weights import from_reference

torch.set_num_threads(1)

B, S = 4, 16
GRAD_TOL = {"zamba2_7b": (1e-4, 1e-3)}
# a train cell whose per-data-block remat stash (64 rows x 2^20 positions
# x d_model x 2 bytes x layers) passes 8e9 bytes on the reduced configs
SEQ_ACT_SHAPE = ShapeSpec("train_seq_act", 1 << 20, 64, "train")
ATTN_ARCHS = [a for a in ARCH_IDS if a != "rwkv6_7b"]


def cpu_mesh(shape):
    return GroupMesh(np.full(shape, "cpu", dtype=object))


def ctx(cfg, shape, spec):
    return make_ctx(cfg, cpu_mesh(shape), spec)


@functools.lru_cache(maxsize=None)
def setup(arch, capacity_factor=None):
    """(reference loss, metrics, grads by path; port cfg, numpy params,
    host batch, solo loss, metrics, grads by path); ``capacity_factor``:
    the MoE's in both configs, else the config's."""
    cfg, tcfg = get_reduced_config(arch), t_get_reduced_config(arch)
    if capacity_factor is not None:
        cfg = cfg.replace(capacity_factor=capacity_factor)
        tcfg = tcfg.replace(capacity_factor=capacity_factor)
    params, _ = r_init_params(jax.random.PRNGKey(0), cfg)
    np_params = jax.tree.map(np.asarray, params)
    rb = next(r_make_batches(cfg, B, S, seed=0))
    hb = next(make_batches(tcfg, B, S, seed=0))
    for k in rb:
        np.testing.assert_array_equal(rb[k], hb[k])
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: r_train_loss(p, cfg, R_NULL_SH,
                               {k: jnp.asarray(v) for k, v in rb.items()},
                               remat=True), has_aux=True))(params)
    live = tree_map(lambda p: p.requires_grad_(True),
                    from_reference(np_params, "cpu"))
    tl, tm = train_loss(live, tcfg, shard_batch(hb, device="cpu"))
    tg = torch.autograd.grad(tl, tree_leaves(live), allow_unused=True,
                             materialize_grads=True)
    return dict(
        ref=(float(loss), {k: float(v) for k, v in metrics.items()},
             dict(tree_items(jax.tree.map(np.asarray, grads)))),
        solo=(float(tl.detach()),
              {k: float(v.detach()) for k, v in tm.items()},
              {p: g.numpy() for (p, _), g in zip(tree_items(live), tg)}),
        cfg=tcfg, np_params=np_params, batch=hb)


def group_grads(arch, shape, spec, capacity_factor=None):
    """(loss, metrics, whole gradients by path) of the group's loss under
    the rules of ``spec`` on ``shape``."""
    run = setup(arch, capacity_factor)
    sh = ctx(run["cfg"], shape, spec)
    lay = GroupLayout(run["cfg"], sh)
    loss, metrics, grads = lay.loss_and_grads(
        lay.shard(from_reference(run["np_params"], "cpu")),
        shard_batch(run["batch"], sh.mesh, sh, device="cpu"))
    whole = lay.unshard(lay.reduce_grads(grads))
    return (sh, float(loss), {k: float(v) for k, v in metrics.items()},
            {p: g.numpy() for p, g in tree_items(whole)})


def assert_leaf_close(got, want, atol, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    if want.size == 0:
        return
    err = float(np.max(np.abs(got - want)))
    bound = atol + rtol * float(np.max(np.abs(want)))
    assert err <= bound, (what, err, bound)


def assert_matches(arch, loss, metrics, grads, capacity_factor=None):
    run = setup(arch, capacity_factor)
    atol, rtol = GRAD_TOL.get(arch, (1e-5, 2e-4))
    for name, (w_loss, w_metrics, w_grads) in (("solo", run["solo"]),
                                               ("reference", run["ref"])):
        np.testing.assert_allclose(loss, w_loss, rtol=2e-4, atol=1e-5,
                                   err_msg=name)
        assert metrics.keys() == w_metrics.keys()
        for k in metrics:
            np.testing.assert_allclose(metrics[k], w_metrics[k], rtol=2e-4,
                                       atol=1e-5, err_msg=f"{name} {k}")
        assert grads.keys() == w_grads.keys()
        for path, g in grads.items():
            assert_leaf_close(g, w_grads[path], atol, rtol, (name,) + path)


# ---------------------------------------------------------------------------
# seq_act: the sequence-sharded residual stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_seq_act_loss_and_grads_match_solo_and_reference(arch, shape):
    sh, loss, metrics, grads = group_grads(arch, shape, SEQ_ACT_SHAPE)
    assert sh.rules["seq_act"] == "model"
    assert_matches(arch, loss, metrics, grads)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
def test_seq_act_moe_routes_each_slots_block(shape, monkeypatch):
    """Reduced Llama-4-Scout under ``seq_act``: the unpadded MoE routes each
    slot's own (B_l, S/M, d) block of the residual stream, with no
    sequence gathered before it, its capacity positions ranked at each
    token's global (row, position) index; the loss, every gradient leaf,
    the drop fraction and the aux loss are the solo step's and the
    reference's, at the config's capacity factor (nothing dropped) and at
    0.5 (a capacity of 8 a expert for 64 top-1 choices over 4 experts:
    the ranking decides which are dropped)."""
    from repro_torch.models import moe as TMOE

    calls = []
    real = TMOE.apply_moe_batch_group

    def spy(ps, cfg, ctxs, xs):
        calls.append(tuple(xs[0].shape))
        return real(ps, cfg, ctxs, xs)

    monkeypatch.setattr(TMOE, "apply_moe_batch_group", spy)
    arch = "llama4_scout_17b_a16e"
    d = setup(arch)["cfg"].d_model
    for factor in (None, 0.5):
        calls.clear()
        sh, loss, metrics, grads = group_grads(arch, shape, SEQ_ACT_SHAPE,
                                               factor)
        assert sh.rules["seq_act"] == "model"
        assert calls and set(calls) == {(B // shape[0], S // shape[1], d)}
        assert (metrics["moe_drop_frac"] > 0) == (factor is not None)
        assert_matches(arch, loss, metrics, grads, factor)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "zamba2_7b",
                                  "seamless_m4t_large_v2"])
def test_seq_act_stash_holds_each_slots_positions(arch, monkeypatch):
    """Under remat the training step keeps each layer's input for the
    backward pass (the checkpoint's tensor arguments): under ``seq_act``
    a slot's are (B_l, S/M, d), without it (B_l, S, d) — the stash the
    dry run's memory floor divides by the model extent."""
    run = setup(arch)
    cfg = run["cfg"]
    kept = []

    def recording(fn, *args, **kw):
        # (segment, layer, params, hs, ...): the slots' residual blocks
        kept.extend(tuple(x.shape) for x in args[3])
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw)

    monkeypatch.setattr(TMODEL, "checkpoint", recording)
    for spec, width in ((SEQ_ACT_SHAPE, S // 2),
                        (SHAPES_BY_NAME["train_4k"], S)):
        kept.clear()
        sh = ctx(cfg, (2, 2), spec)
        lay = GroupLayout(cfg, sh)
        lay.loss_and_grads(lay.shard(from_reference(run["np_params"],
                                                    "cpu")),
                           shard_batch(run["batch"], sh.mesh, sh,
                                       device="cpu"))
        assert kept and set(s[1] for s in kept) == {width}, (spec.name,
                                                            kept[:4])
        assert set(s[0] for s in kept) == {B // 2}


@pytest.mark.parametrize("arch", ["llama3_2_1b", "gemma3_4b"])
def test_seq_act_block_wire_bytes_equal_the_all_reduce(arch):
    """One decoder layer of the training step moves the same wire bytes
    with the sequence-sharded residual stream (all-gather before the
    attention and the MLP, reduce-scatter after) as without it (an
    all-reduce after each), by the reference's ring model."""
    run = setup(arch)
    cfg = run["cfg"]
    wire = {}
    for spec in (SEQ_ACT_SHAPE, SHAPES_BY_NAME["train_4k"]):
        sh = ctx(cfg, (1, 2), spec)
        lay = GroupLayout(cfg, sh)
        ps = lay.gather_fsdp(lay.shard(from_reference(run["np_params"],
                                                      "cpu")))
        ctxs = seq_ctxs(lay.ctxs, B, S)
        w = S // ctxs[0].seq[1]
        hs = [torch.randn(B, w, cfg.d_model,
                          generator=torch.Generator().manual_seed(c.j))
              for c in ctxs]
        seg = TMODEL.stack_plan(cfg)[0]
        pl = TMODEL._slot_layers([p["segments"] for p in ps], seg.name,
                                 seg.n)[0]
        with count_collectives() as cc:
            TMODEL._full_layer_group(cfg, seg, pl, ctxs, hs,
                                     [torch.arange(S)] * 2, 0, "plain")
        wire[spec.name] = cc.by_kind
    split, whole = wire[SEQ_ACT_SHAPE.name], wire["train_4k"]
    assert set(split) == {"all-gather", "reduce-scatter"}
    assert set(whole) == {"all-reduce"}
    assert split["all-gather"] == split["reduce-scatter"]
    assert sum(split.values()) == whole["all-reduce"]


def _pad_experts(params, E_alloc):
    """``params`` with every MoE layer's experts padded with zeros to
    ``E_alloc`` (the router still picks among the first E)."""
    ffn = params["segments"]["blocks"]["ffn"]
    ffn.update({k: torch.cat([ffn[k], ffn[k].new_zeros(
        (ffn[k].shape[0], E_alloc - ffn[k].shape[1]) + ffn[k].shape[2:])],
        dim=1) for k in ("wg", "wu", "wo")})
    return params


@pytest.mark.parametrize("spec", [SEQ_ACT_SHAPE, SHAPES_BY_NAME["train_4k"]],
                         ids=lambda s: s.name)
def test_padded_moe_takes_pure_ep_over_sequence_blocks(spec, monkeypatch):
    """DeepSeek-V2's 8 experts padded to 16 (``expert_alloc`` with the
    padding thresholds lowered to the reduced config), which the rules put
    over (data, model) as the reference's put a padded MoE: the training
    step's MoE takes the pure-EP all-to-all (the reference's
    ``_apply_moe_ep`` token grid: each slot routes its block of the rows
    at its block of the positions — under ``seq_act`` its own block of
    the residual stream), and with room for every token (capacity factor
    8, so local and global capacities drop nothing) the loss, metrics
    and every gradient leaf equal the solo port's on the same weights."""
    from repro_torch.models import moe as TMOE

    monkeypatch.setattr(TMOE, "EP_MIN_EXPERTS", 8)
    monkeypatch.setattr(TMOE, "EP_PAD_GROUP", 16)
    run = setup("deepseek_v2_236b")
    cfg = run["cfg"].replace(capacity_factor=8.0)
    sh = ctx(cfg, (2, 2), spec)
    assert (sh.rules["experts"], sh.rules["expert_mlp"]) == (
        ("data", "model"), None)
    assert sh.rules["seq_act"] == ("model" if spec is SEQ_ACT_SHAPE
                                   else None)
    calls = []
    real = TMOE._apply_moe_ep

    def spy(ps, cfg, ctxs, xs):
        calls.append(tuple(xs[0].shape))
        return real(ps, cfg, ctxs, xs)

    monkeypatch.setattr(TMOE, "_apply_moe_ep", spy)
    lay = GroupLayout(cfg, sh)
    loss, metrics, grads = lay.loss_and_grads(
        lay.shard(_pad_experts(from_reference(run["np_params"], "cpu"),
                               16)),
        shard_batch(run["batch"], sh.mesh, sh, device="cpu"))
    assert calls and set(calls) == {(B // 2, S // 2, cfg.d_model)}
    grads = {p: g.numpy()
             for p, g in tree_items(lay.unshard(lay.reduce_grads(grads)))}
    live = tree_map(lambda p: p.requires_grad_(True), _pad_experts(
        from_reference(run["np_params"], "cpu"), 16))
    tl, tm = train_loss(live, cfg, shard_batch(run["batch"], device="cpu"))
    tg = torch.autograd.grad(tl, tree_leaves(live), allow_unused=True,
                             materialize_grads=True)
    np.testing.assert_allclose(float(loss), float(tl.detach()), rtol=2e-4,
                               atol=1e-5)
    for k in tm:
        np.testing.assert_allclose(float(metrics[k]), float(tm[k].detach()),
                                   rtol=2e-4, atol=1e-5, err_msg=k)
    for (path, _), g in zip(tree_items(live), tg):
        assert_leaf_close(grads[path], g.numpy(), 1e-5, 2e-4, path)


# ---------------------------------------------------------------------------
# attn_seq_q and the head_dim fallback
# ---------------------------------------------------------------------------


ATTN_CASES = [(a, (1, 8)) for a in ATTN_ARCHS] + [
    ("llama3_2_1b", (2, 8)), ("gemma3_4b", (2, 8))]


@pytest.mark.parametrize("arch,shape", ATTN_CASES, ids=str)
def test_attention_rules_loss_and_grads_match_solo_and_reference(arch,
                                                                 shape):
    sh, loss, metrics, grads = group_grads(arch, shape,
                                           SHAPES_BY_NAME["train_4k"])
    assert sh.rules["attn_seq_q"] == "model"
    if get_reduced_config(arch).attn_kind != "mla":
        assert sh.rules["head_dim"] == "model"
        assert sh.spec(("embed_fsdp", "heads", "head_dim"),
                       (64, 4, setup(arch)["cfg"].head_dim))[2] == "model"
    assert_matches(arch, loss, metrics, grads)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "gemma3_4b"])
def test_attention_rules_step_keeps_replicas_bit_equal(arch):
    """``make_train_step`` over a (2, 8) group under ``attn_seq_q``, the
    ``head_dim`` fallback and ``seq_act`` together: two AdamW steps, after
    which every slot holding a leaf's block holds it bit for bit alike,
    and the loss is the solo step's."""
    run = setup(arch)
    cfg = run["cfg"]
    hp = TrainHParams(learning_rate=5e-3)
    opt = make_optimizer_for(cfg, hp)
    spec = ShapeSpec("train_seq_act", 1 << 20, 64, "train")
    sh = ctx(cfg, (2, 8), spec)
    assert (sh.rules["seq_act"], sh.rules["attn_seq_q"],
            sh.rules["head_dim"]) == ("model",) * 3
    state = init_train_state(None, cfg, opt,
                             params=from_reference(run["np_params"], "cpu"),
                             device="cpu", sh=sh)
    step = make_train_step(cfg, opt, hp, sh)
    batches = shard_batch(run["batch"], sh.mesh, sh, device="cpu")
    for _ in range(2):
        state, metrics = step(state, batches)
    solo = init_train_state(None, cfg, opt,
                            params=from_reference(run["np_params"], "cpu"),
                            device="cpu")
    solo_step = make_train_step(cfg, opt, hp)
    for _ in range(2):
        solo, solo_metrics = solo_step(solo, shard_batch(run["batch"],
                                                         device="cpu"))
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(solo_metrics["loss"]), rtol=2e-4,
                               atol=1e-5)
    lay = GroupLayout(cfg, sh)
    flat = [tree_leaves(p) for p in state["params"]]
    for k, leaf in enumerate(lay.leaves):
        for s, owner in enumerate(leaf["owners"]):
            assert torch.equal(flat[s][k], flat[owner][k]), (k, s)
