"""Training over a device group in the port against the port's solo step
and the JAX reference's, in f32 on the CPU (a group's slots all name the
``cpu`` device).

* the matrix: every reduced architecture of tests/test_torch_train_loss.py
  on meshes (1, 2), (2, 1) and (2, 2) under the reference's training
  rules (``make_ctx`` at ``train_4k``: batch and ``embed_fsdp`` over
  ``data``, heads / MLP / vocab over ``model``, experts where the rules
  put them) — the group's loss and MoE metrics, and every gradient leaf
  (reduced over the slots and put back together), against the solo
  port's ``train_loss`` and the reference's ``jax.value_and_grad`` of
  its ``train_loss`` (what ``make_train_step(cfg, NULL_SH, ...)``
  differentiates); then one AdamW and one Adafactor step: the optimizer
  state against the solo step's and the reference's (its optimizer's
  update of its gradients, the rest of its ``train_step``), and the
  params against the solo optimizer applied to the group's gradients
  (AdamW's first step is ~lr·sign(g): an element whose |g| sits near eps
  moves by up to 2 lr between two gradients that agree to 1e-6, so the
  params are held beyond what the update makes of the two gradients);
* grad accumulation on a group (2 micro-batches, the solo step's rows)
  against the solo step and the reference's jitted ``make_train_step``;
* the clip's global norm counts each element once; replicas stay
  bit-equal over 3 steps; the MoE drop fraction and aux loss are the
  whole batch's;
* a group checkpoint (unsharded, the reference's npz + manifest format)
  restores into the solo port, into another group and into the
  reference; ``shard_batch`` over a mesh; ``launch.train`` over a CPU
  group prints the solo launcher's losses; the rules that raised before
  (``seq_act``, ``attn_seq_q``, the ``head_dim`` fallback) build and run
  their step (tests/test_torch_group_rules.py holds them leaf by leaf).

Tolerances (tests/test_torch_training.py's): losses at rtol 2e-4 / atol
1e-5; a gradient or moment leaf at max|got - want| <= atol + rtol *
max|want| with (1e-5, 2e-4), zamba2 (1e-4, 1e-3) (ROADMAP C2), the second
moments at twice the rtol (squares double a relative error); params at
``ATOL`` 5e-5.  Weights are the reference's ``init_params(PRNGKey(0),
cfg)`` bridged with ``weights.from_reference``; batches come from both
packages' ``make_batches`` (asserted bit-equal).
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_reduced_config
from repro.data import make_batches as r_make_batches
from repro.models import NULL_SH as R_NULL_SH, init_params as r_init_params
from repro.models.model import train_loss as r_train_loss
from repro.training import TrainHParams as RHParams
from repro.training import checkpoint as r_checkpoint
from repro.training import init_train_state as r_init_train_state
from repro.training import make_optimizer_for as r_make_optimizer_for
from repro.training import make_train_step as r_make_train_step
from repro_torch.configs import SHAPES_BY_NAME, ShapeSpec
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.data import make_batches, shard_batch
from repro_torch.launch import train as t_launch
from repro_torch.launch.mesh import GroupMesh
from repro_torch.launch.sharding import (batch_specs, cache_specs,
                                         make_ctx, param_axes)
from repro_torch.models import train_loss
from repro_torch.models.layers import count_collectives
from repro_torch.training import (TrainHParams, checkpoint,
                                  init_train_state, make_optimizer_for,
                                  make_train_step)
from repro_torch.training.optimizer import tree_items, tree_leaves, tree_map
from repro_torch.training.train_step import GroupLayout
from repro_torch.weights import from_reference

torch.set_num_threads(1)

B, S = 4, 16
LR = 5e-3
ATOL = 5e-5
MESHES = [(1, 2), (2, 1), (2, 2)]
GRAD_TOL = {"zamba2_7b": (1e-4, 1e-3)}


def cpu_mesh(shape):
    return GroupMesh(np.full(shape, "cpu", dtype=object))


def ctx(cfg, shape):
    return make_ctx(cfg, cpu_mesh(shape), SHAPES_BY_NAME["train_4k"])


def port_params(np_params):
    return from_reference(np_params, "cpu")


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(reference (cfg, params, loss, metrics, grads by path), port (cfg,
    numpy params, host batch, loss, metrics, grads by path))."""
    cfg, tcfg = get_reduced_config(arch), t_get_reduced_config(arch)
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
    ref = (cfg, params, float(loss),
           {k: float(v) for k, v in metrics.items()},
           dict(tree_items(jax.tree.map(np.asarray, grads))))
    live = tree_map(lambda p: p.requires_grad_(True),
                    port_params(np_params))
    tl, tm = train_loss(live, tcfg, shard_batch(hb, device="cpu"))
    tg = torch.autograd.grad(tl, tree_leaves(live), allow_unused=True,
                             materialize_grads=True)
    solo = (tcfg, np_params, hb, float(tl.detach()),
            {k: float(v.detach()) for k, v in tm.items()},
            dict(zip([p for p, _ in tree_items(live)], tg)))
    return ref, solo


@functools.lru_cache(maxsize=None)
def group_grads(arch, shape):
    """(loss, metrics, whole gradients by path) of the group's loss at the
    bridged weights: every slot's gradient reduced over the slots and the
    blocks put back together."""
    _, (tcfg, np_params, hb, _, _, _) = setup(arch)
    sh = ctx(tcfg, shape)
    lay = GroupLayout(tcfg, sh)
    loss, metrics, grads = lay.loss_and_grads(
        lay.shard(port_params(np_params)),
        shard_batch(hb, sh.mesh, sh, device="cpu"))
    whole = lay.unshard(lay.reduce_grads(grads))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            dict(tree_items(whole)))


def assert_leaf_close(got, want, atol, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    if want.size == 0:
        return
    err = float(np.max(np.abs(got - want)))
    bound = atol + rtol * float(np.max(np.abs(want)))
    assert err <= bound, (what, err, bound)


def items(tree):
    return [(p, x.detach().numpy() if torch.is_tensor(x) else np.asarray(x))
            for p, x in tree_items(tree)]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_group_loss_and_grads_match_solo_and_reference(arch, shape):
    (_, _, r_loss, r_metrics, r_grads), (_, _, _, t_loss, t_metrics,
                                         t_grads) = setup(arch)
    loss, metrics, grads = group_grads(arch, shape)
    np.testing.assert_allclose(loss, t_loss, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(loss, r_loss, rtol=2e-4, atol=1e-5)
    assert metrics.keys() == t_metrics.keys() == r_metrics.keys()
    for k in metrics:
        np.testing.assert_allclose(metrics[k], t_metrics[k], rtol=2e-4,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(metrics[k], r_metrics[k], rtol=2e-4,
                                   atol=1e-5, err_msg=k)
    assert grads.keys() == t_grads.keys() == r_grads.keys()
    atol, rtol = GRAD_TOL.get(arch, (1e-5, 2e-4))
    for path, g in grads.items():
        assert_leaf_close(g.numpy(), t_grads[path].numpy(), atol, rtol,
                          ("solo",) + path)
        assert_leaf_close(g.numpy(), r_grads[path], atol, rtol,
                          ("reference",) + path)


def _opt_bounds(arch, path):
    atol, rtol = GRAD_TOL.get(arch, (1e-5, 2e-4))
    second = path[-1] in ("v", "vr", "vc") or path[0] == "v"
    return atol, rtol * (2 if second else 1)


@functools.lru_cache(maxsize=None)
def _reference_step(arch, optimizer):
    """The reference's state after one step of its optimizer on its
    gradients (its ``train_step`` at grad_accum 1), as numpy by path."""
    (cfg, params, _, _, r_grads), _ = setup(arch)
    cfg = cfg.replace(optimizer=optimizer)
    ropt = r_make_optimizer_for(cfg, RHParams(learning_rate=LR))
    state = r_init_train_state(None, cfg, ropt, params=params)
    grads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [jnp.asarray(r_grads[p]) for p, _ in tree_items(
            jax.tree.map(np.asarray, params))])
    new_p, new_opt = jax.jit(ropt.update)(state["params"], grads,
                                          state["opt"], state["step"])
    return dict(items({"params": jax.tree.map(np.asarray, new_p),
                       "opt": jax.tree.map(np.asarray, new_opt)}))


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_group_step_matches_solo_and_reference(arch, shape, optimizer):
    _, (tcfg, np_params, hb, _, _, _) = setup(arch)
    tcfg = tcfg.replace(optimizer=optimizer)
    hp = TrainHParams(learning_rate=LR)
    opt = make_optimizer_for(tcfg, hp)
    sh = ctx(tcfg, shape)
    state = init_train_state(None, tcfg, opt,
                             params=port_params(np_params), device="cpu",
                             sh=sh)
    state, metrics = make_train_step(tcfg, opt, hp, sh)(
        state, shard_batch(hb, sh.mesh, sh, device="cpu"))
    assert [int(t) for t in state["step"]] == [1] * (shape[0] * shape[1])
    got = dict(items(GroupLayout(tcfg, sh).unshard_state(state)))
    # the solo step from the same weights and batch
    solo = init_train_state(None, tcfg, opt, params=port_params(np_params),
                            device="cpu")
    solo, solo_metrics = make_train_step(tcfg, opt, hp)(
        solo, shard_batch(hb, device="cpu"))
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(solo_metrics["loss"]), rtol=2e-4,
                               atol=1e-5)
    solo = dict(items(solo))
    ref = _reference_step(arch, optimizer)
    for path, want in solo.items():
        if path[0] != "opt":
            continue
        atol, rtol = _opt_bounds(arch, path[1:])
        assert_leaf_close(got[path], want, atol, rtol, ("solo",) + path)
        assert_leaf_close(got[path], ref[path], atol, rtol,
                          ("reference",) + path)
    # the params: the solo optimizer applied to the group's gradients
    grads = group_grads(arch, shape)[2]
    twin = init_train_state(None, tcfg, opt, params=port_params(np_params),
                            device="cpu")
    opt.update(twin["params"], _tree_of(twin["params"], grads), twin["opt"],
               twin["step"])
    for path, want in items({"params": twin["params"]}):
        np.testing.assert_allclose(got[path], want, rtol=0, atol=ATOL,
                                   err_msg=str(path))


def _tree_of(like, by_path):
    """A tree of ``like``'s structure holding clones of ``by_path``'s
    leaves (the optimizer scales its gradients in place)."""
    from repro_torch.training.optimizer import tree_unflatten

    return tree_unflatten(like, [by_path[p].clone()
                                 for p, _ in tree_items(like)])


def test_group_grad_accumulation_matches_solo_and_reference():
    """Two micro-batches on a (2, 2) group are the solo step's (the
    global batch's rows [m B/2, (m+1) B/2) spread over the data slots),
    for a dense and an MoE stack; Llama's against the reference's jitted
    ``make_train_step(cfg, NULL_SH, ...)`` at grad_accum 2 too."""
    for arch in ("llama3_2_1b", "llama4_scout_17b_a16e"):
        (cfg, params, _, _, _), (tcfg, np_params, hb, _, _, _) = setup(arch)
        hp = TrainHParams(learning_rate=LR, grad_accum=2)
        opt = make_optimizer_for(tcfg, hp)
        sh = ctx(tcfg, (2, 2))
        state = init_train_state(None, tcfg, opt,
                                 params=port_params(np_params),
                                 device="cpu", sh=sh)
        state, metrics = make_train_step(tcfg, opt, hp, sh)(
            state, shard_batch(hb, sh.mesh, sh, device="cpu"))
        solo = init_train_state(None, tcfg, opt,
                                params=port_params(np_params), device="cpu")
        solo, solo_metrics = make_train_step(tcfg, opt, hp)(
            solo, shard_batch(hb, device="cpu"))
        for k in solo_metrics:
            np.testing.assert_allclose(float(metrics[k]),
                                       float(solo_metrics[k]), rtol=2e-4,
                                       atol=1e-5, err_msg=k)
        got = dict(items(GroupLayout(tcfg, sh).unshard_state(state)))
        want = dict(items(solo))
        for path, w in want.items():
            if path[0] == "opt":
                atol, rtol = _opt_bounds(arch, path[1:])
                assert_leaf_close(got[path], w, atol, rtol, path)
        if arch != "llama3_2_1b":
            continue
        rhp = RHParams(learning_rate=LR, grad_accum=2)
        ropt = r_make_optimizer_for(cfg, rhp)
        r_state = r_init_train_state(None, cfg, ropt, params=params)
        r_state, r_metrics = jax.jit(r_make_train_step(
            cfg, R_NULL_SH, ropt, rhp))(
            r_state, {k: jnp.asarray(v) for k, v in hb.items()})
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(r_metrics["loss"]), rtol=2e-4,
                                   atol=1e-5)
        ref = dict(items(jax.tree.map(np.asarray, r_state)))
        for path, w in ref.items():
            if path[0] == "opt":
                atol, rtol = _opt_bounds(arch, path[1:])
                assert_leaf_close(got[path], w, atol, rtol, path)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "deepseek_v2_236b"])
def test_clip_counts_each_element_once(arch):
    """The global norm the clip reads, on every slot of a (2, 2) group,
    equals the norm of the whole gradient (the solo step's, within f32
    rounding), although most leaves sit on several slots."""
    _, (tcfg, np_params, hb, _, _, t_grads) = setup(arch)
    sh = ctx(tcfg, (2, 2))
    lay = GroupLayout(tcfg, sh)
    _, _, grads = lay.loss_and_grads(
        lay.shard(port_params(np_params)),
        shard_batch(hb, sh.mesh, sh, device="cpu"))
    grads = lay.reduce_grads(grads)
    want = sum(float(torch.sum(g.double() ** 2)) for g in t_grads.values())
    sqs = lay.global_sq(grads)
    for sq in sqs:
        assert torch.equal(sq, sqs[0])
        np.testing.assert_allclose(float(sq), want, rtol=1e-5)
    every = sum(float(torch.sum(g.double() ** 2)) for t in grads
                for g in tree_leaves(t))
    assert every > 1.05 * want  # replicas counted on every slot differ


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["llama3_2_1b", "llama4_scout_17b_a16e"])
def test_replicas_stay_bit_equal(arch, optimizer):
    """After 3 steps on a (2, 2) group every copy of a leaf's block — the
    params and the optimizer state — is bit-equal across the slots that
    hold it."""
    _, (tcfg, np_params, _, _, _, _) = setup(arch)
    tcfg = tcfg.replace(optimizer=optimizer)
    hp = TrainHParams(learning_rate=LR)
    opt = make_optimizer_for(tcfg, hp)
    sh = ctx(tcfg, (2, 2))
    lay = GroupLayout(tcfg, sh)
    state = init_train_state(None, tcfg, opt,
                             params=port_params(np_params), device="cpu",
                             sh=sh)
    step = make_train_step(tcfg, opt, hp, sh)
    for hb in zip(range(3), make_batches(tcfg, B, S, seed=1)):
        state, _ = step(state, shard_batch(hb[1], sh.mesh, sh,
                                           device="cpu"))
    params = [tree_leaves(t) for t in state["params"]]
    checked = 0
    for k, leaf in enumerate(lay.leaves):
        for s, owner in enumerate(leaf["owners"]):
            if owner != s:
                assert torch.equal(params[s][k], params[owner][k]), k
                checked += 1
    assert checked > 0
    opts = [tree_leaves(t) for t in state["opt"]]
    for s in range(1, 4):
        for k, x in enumerate(opts[s]):
            if optimizer == "adafactor":  # whole on every slot
                assert torch.equal(x, opts[0][k])
    if optimizer == "adamw":
        for which in ("m", "v"):
            trees = [tree_leaves(o[which]) for o in state["opt"]]
            for k, leaf in enumerate(lay.leaves):
                for s, owner in enumerate(leaf["owners"]):
                    assert torch.equal(trees[s][k], trees[owner][k])


@pytest.mark.parametrize("arch", ["deepseek_v2_236b",
                                  "llama4_scout_17b_a16e"])
def test_moe_routing_is_the_whole_batch(arch):
    """The group's MoE drop fraction and aux loss equal the solo step's
    over the whole batch (capacity of all B * S tokens), where routing
    each data slot's rows with a capacity of its own would drop another
    share of the choices."""
    from repro_torch.models import moe

    _, (tcfg, np_params, hb, _, t_metrics, _) = setup(arch)
    for shape in [(2, 1), (2, 2)]:
        _, metrics, _ = group_grads(arch, shape)
        for k in ("moe_aux_loss", "moe_drop_frac"):
            np.testing.assert_allclose(metrics[k], t_metrics[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    # per-slot capacities drop another share where every token picks the
    # same experts (one token's features repeated)
    params = port_params(np_params)
    ffn = tree_map(lambda x: x[0], params["segments"]["blocks"]["ffn"])
    x = torch.randn(1, 1, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0)).expand(B, S, tcfg.d_model)
    whole = float(moe.apply_moe(ffn, tcfg, x)[1]["moe_drop_frac"])
    halves = [float(moe.apply_moe(ffn, tcfg, h)[1]["moe_drop_frac"])
              for h in x.chunk(2)]
    assert whole != sum(halves) / 2


def test_adafactor_update_keeps_f32_temporaries_to_a_block():
    """Reduced DeepSeek-V2's Adafactor update on a meta (1, 8) group: no
    f32 tensor that the update makes outgrows the largest block a slot
    holds of any leaf (the moments are put together from the slots'
    partial sums; the update is each slot's block), where the largest
    whole leaf is several blocks."""
    import math

    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import init_params

    tcfg = t_get_reduced_config("deepseek_v2_236b")
    assert tcfg.optimizer == "adafactor"
    mesh = GroupMesh(np.full((1, 8), torch.device("meta"), dtype=object))
    sh = make_ctx(tcfg, mesh, SHAPES_BY_NAME["train_4k"])
    lay = GroupLayout(tcfg, sh)
    opt = make_optimizer_for(tcfg, TrainHParams(learning_rate=LR))
    whole = init_params(tcfg, None, "meta")
    state = lay.init_state(whole, opt)
    grads = [tree_map(torch.empty_like, t) for t in state["params"]]
    block = max(x.numel() for t in state["params"] for x in tree_leaves(t))
    leaf = max(x.numel() for x in tree_leaves(whole))

    class Widest(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for x in (out if isinstance(out, (tuple, list)) else [out]):
                if torch.is_tensor(x) and x.dtype == torch.float32:
                    self.most = max(self.most, math.prod(x.shape))
            return out

    with Widest() as w:
        lay.factored_update(opt.factored, state["params"], grads,
                            [o["stats"] for o in state["opt"]],
                            state["step"])
    assert 0 < w.most <= block < leaf


@pytest.mark.parametrize("spec", [SHAPES_BY_NAME["train_4k"],
                                  ShapeSpec("train_seq_act", 1 << 20, 64,
                                            "train")],
                         ids=lambda s: s.name)
def test_moe_dispatch_sends_each_holder_its_kept_rows(spec):
    """Reduced Llama-4-Scout's MoE on a (2, 2) group (experts over data, 2
    a slot; their FFN over model): each source sends each holder of its
    experts only its kept rows of those experts, each with its position
    in the holder's block, and takes back the outputs of those rows from
    the holder at its model index (the FFN shards' partial sums added
    over the model row) — the counted wire bytes equal a count of the
    kept choices from the whole batch's routing (``_sort_dispatch`` at
    the global capacity), by token block and expert block — and the
    outputs are ``apply_moe``'s of the whole batch.  Under ``seq_act`` a slot's
    tokens are its row block's positions block.  Capacity factor 0.5:
    some choices are dropped."""
    from repro_torch.models import moe
    from repro_torch.models.layers import seq_ctxs

    _, (tcfg, np_params, _, _, _, _) = setup("llama4_scout_17b_a16e")
    tcfg = tcfg.replace(capacity_factor=0.5)
    sh = ctx(tcfg, (2, 2))
    sh = make_ctx(tcfg, sh.mesh, spec)
    lay = GroupLayout(tcfg, sh)
    params = port_params(np_params)
    fs = [tree_map(lambda x: x[0], p["segments"]["blocks"]["ffn"])
          for p in lay.gather_fsdp(lay.shard(params))]
    ffn = tree_map(lambda x: x[0], params["segments"]["blocks"]["ffn"])
    ctxs = seq_ctxs(lay.ctxs, B, S)
    M = ctxs[0].seq[1]
    assert M == (2 if spec.name == "train_seq_act" else 1)
    x = torch.randn(B, S, tcfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    w = S // M
    xs = [x[c.i * 2:(c.i + 1) * 2, (c.j if M > 1 else 0) * w:][:, :w]
          for c in ctxs]
    with count_collectives() as cc:
        outs, aux = moe.apply_moe_batch_group(fs, tcfg, ctxs, xs)
    want, want_aux = moe.apply_moe(ffn, tcfg, x)
    for c, o, xi in zip(ctxs, outs, xs):
        lo = (c.j if M > 1 else 0) * w
        np.testing.assert_allclose(o.detach().numpy(), want[
            c.i * 2:(c.i + 1) * 2, lo:lo + w].detach().numpy(), rtol=2e-4,
            atol=1e-5)
    for kk in want_aux:
        np.testing.assert_allclose(float(aux[kk]), float(want_aux[kk]),
                                   rtol=1e-5, atol=1e-7)
    # the whole batch's routing: kept choices by (token block, expert block)
    E, k, d = tcfg.n_experts, tcfg.moe_top_k, tcfg.d_model
    C = moe._capacity(tcfg, B * S)
    top_w, top_e, _ = moe.router_topk(ffn, tcfg, x.reshape(B * S, d))
    slot_of = moe._sort_dispatch(x.reshape(B * S, d), top_w, top_e, E, C)[1]
    kept = {}
    for t, e in zip(*np.nonzero((slot_of < E * C).numpy())):
        r, pos = divmod(int(t), S)
        blk = (r // 2, pos // w if M > 1 else 0)
        key = (blk, int(top_e[t, e]) // 2)
        kept[key] = kept.get(key, 0) + 1
    slots = [(i, j) for i in range(2) for j in range(2)]
    dispatch = ret = 0
    for h in slots:  # holder (expert block h[0], FFN shard h[1])
        srcs = slots if M > 1 else [(i, h[1]) for i in range(2)]
        for src in srcs:
            rows = kept.get(((src[0], src[1] if M > 1 else 0), h[0]), 0)
            if src != h:
                dispatch += rows * (d * 4 + 8)
    for src in slots:
        for b in range(2):
            rows = kept.get(((src[0], src[1] if M > 1 else 0), b), 0)
            ret += rows * d * 4 if (b, src[1]) != src else 0
    assert sum(kept.values()) < B * S * k  # some choices dropped
    assert cc.by_kind["moe-dispatch"] == dispatch > 0
    assert cc.by_kind["moe-return"] == ret > 0


def test_group_checkpoint_restores_in_solo_group_and_reference(tmp_path):
    """A (2, 2) group's state after one step, saved unsharded: the solo
    port restores the same values, a (1, 2) group restores them into its
    shards, and the reference restores them into its own state."""
    arch = "llama3_2_1b"
    (cfg, params, _, _, _), (tcfg, np_params, hb, _, _, _) = setup(arch)
    hp = TrainHParams(learning_rate=LR)
    opt = make_optimizer_for(tcfg, hp)
    sh = ctx(tcfg, (2, 2))
    state = init_train_state(None, tcfg, opt, params=port_params(np_params),
                             device="cpu", sh=sh)
    state, _ = make_train_step(tcfg, opt, hp, sh)(
        state, shard_batch(hb, sh.mesh, sh, device="cpu"))
    want = items(GroupLayout(tcfg, sh).unshard_state(state))
    checkpoint.save(str(tmp_path), 1, state, sh=sh)
    solo = init_train_state(None, tcfg, opt, params=port_params(np_params),
                            device="cpu")
    restored, step = checkpoint.restore(str(tmp_path), solo)
    assert step == 1
    for (p, a), (_, b) in zip(items(restored), want):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    sh2 = ctx(tcfg, (1, 2))
    other = init_train_state(None, tcfg, opt, params=port_params(np_params),
                             device="cpu", sh=sh2)
    other, step = checkpoint.restore(str(tmp_path), other, sh=sh2)
    assert step == 1
    for (p, a), (_, b) in zip(
            items(GroupLayout(tcfg, sh2).unshard_state(other)), want):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    ropt = r_make_optimizer_for(cfg, RHParams(learning_rate=LR))
    r_state = r_init_train_state(None, cfg, ropt, params=params)
    r_restored, step = r_checkpoint.restore(str(tmp_path), r_state)
    assert step == 1
    for (p, a), (_, b) in zip(items(jax.tree.map(np.asarray, r_restored)),
                              want):
        np.testing.assert_array_equal(a, b, err_msg=str(p))


def test_shard_batch_over_a_mesh():
    """Each slot gets its data index's rows on its device (one tensor per
    row block and device, shared by the model slots); a batch the rule
    replicates (3 rows on 2 data slots) goes whole to every slot."""
    tcfg = t_get_reduced_config("seamless_m4t_large_v2")
    hb = next(make_batches(tcfg, 4, 8, seed=0))
    sh = ctx(tcfg, (2, 2))
    slots = shard_batch(hb, sh.mesh, sh, device="cpu")
    assert len(slots) == 4
    for s, slot in enumerate(slots):
        i = s // 2
        for k, v in hb.items():
            np.testing.assert_array_equal(slot[k].numpy(),
                                          v[i * 2:(i + 1) * 2])
    assert slots[0]["tokens"] is slots[1]["tokens"]
    odd = {"tokens": np.arange(12, dtype=np.int32).reshape(3, 4)}
    sh3 = make_ctx(tcfg, sh.mesh, ShapeSpec("train_3", 4, 3, "train"))
    assert sh3.rules["batch"] is None
    for slot in shard_batch(odd, sh.mesh, sh3, device="cpu"):
        np.testing.assert_array_equal(slot["tokens"].numpy(),
                                      odd["tokens"])
    with pytest.raises(ValueError, match="both"):
        shard_batch(odd, mesh=sh.mesh, device="cpu")


_LOSS_LINE = re.compile(r"^step (\d+) loss ([0-9.]+) \(")


def _losses(lines):
    return {int(m.group(1)): float(m.group(2))
            for m in map(_LOSS_LINE.match, lines) if m}


def test_launcher_model_parallel_prints_the_solo_losses():
    """``--model-parallel 2 --device cpu`` trains over a (1, 2) group of
    CPU slots and an explicit (2, 2) mesh over four: both print the solo
    launcher's loss lines within rtol 1e-4 (its reference tolerance)."""
    _, (tcfg, np_params, _, _, _, _) = setup("llama3_2_1b")
    argv = ["--reduced", "--steps", "10", "--device", "cpu"]
    solo = t_launch.run(t_launch.parse_args(argv),
                        params=port_params(np_params))
    group = t_launch.run(t_launch.parse_args(argv + ["--model-parallel",
                                                     "2"]),
                         params=port_params(np_params))
    assert isinstance(group.state["params"], list)
    assert len(group.state["params"]) == 2
    mesh = t_launch.run(t_launch.parse_args(argv),
                        params=port_params(np_params),
                        mesh=cpu_mesh((2, 2)))
    want = _losses(solo.lines)
    assert sorted(want) == [5, 10]
    for run in (group, mesh):
        assert run.lines[-1] == "done"
        got = _losses(run.lines)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4)


def test_unported_rules_raise():
    """The rules this test once pinned as raising now run: ``seq_act``
    (full-width Llama-3.2-1B at ``train_4k`` on a model axis of 2: a remat
    stash above 8e9 bytes) builds its step, and the attention rules for
    query heads that do not divide the model axis (reduced Llama's 4 on
    8: ``attn_seq_q`` and the ``head_dim`` fallback) take a step whose
    loss is the solo step's; RWKV6, which has no attention, trains where
    its rules set ``attn_seq_q``."""
    cfg = t_get_config("llama3_2_1b")
    sh = ctx(cfg, (1, 2))
    assert sh.rules["seq_act"] == "model"
    opt = make_optimizer_for(cfg, TrainHParams())
    make_train_step(cfg, opt, TrainHParams(), sh)
    _, (small, np_params, hb, t_loss, _, _) = setup("llama3_2_1b")
    sh = ctx(small, (1, 8))
    assert (sh.rules["attn_seq_q"], sh.rules["head_dim"]) == ("model",
                                                              "model")
    hp = TrainHParams(learning_rate=LR)
    opt = make_optimizer_for(small, hp)
    state = init_train_state(None, small, opt,
                             params=port_params(np_params), device="cpu",
                             sh=sh)
    _, metrics = make_train_step(small, opt, hp, sh)(
        state, shard_batch(hb, sh.mesh, sh, device="cpu"))
    np.testing.assert_allclose(float(metrics["loss"]), t_loss, rtol=2e-4,
                               atol=1e-5)
    rwkv = t_get_reduced_config("rwkv6_7b")
    assert ctx(rwkv, (1, 2)).rules["attn_seq_q"] == "model"
    make_train_step(rwkv, make_optimizer_for(rwkv, TrainHParams()),
                    TrainHParams(), ctx(rwkv, (1, 2)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_and_specs_match_reference(arch):
    """``param_axes`` is the reference's axes tree of ``init_params``, and
    ``batch_specs`` / ``cache_specs`` give the reference's shapes with the
    rows over ``data`` on a (2, 2) mesh."""
    from repro.models.model import init_decode_caches as r_init_caches
    from repro.models.model import param_axes as r_param_axes
    from repro_torch.models import init_params

    cfg, tcfg = get_reduced_config(arch), t_get_reduced_config(arch)
    want = dict(tree_items(r_param_axes(cfg)))
    got = dict(tree_items(param_axes(tcfg, init_params(tcfg, None,
                                                       "meta"))))
    assert got == want
    sh = ctx(tcfg, (2, 2))
    shape = ShapeSpec("cell", 32, 4, "train")
    for k, (x, spec) in batch_specs(tcfg, shape, sh).items():
        assert x.shape[0] == 4 and spec[0] == "data", k
    enc = 8 if tcfg.is_enc_dec else None
    ref = jax.eval_shape(lambda: r_init_caches(cfg, 4, 32, enc_len=enc))
    ref_shapes = dict((p, tuple(x.shape)) for p, x in tree_items(
        jax.tree.map(lambda a: np.empty(a.shape, np.int8), ref)))
    got_specs = cache_specs(tcfg, shape, sh, enc_len=enc)
    got_shapes = {p: tuple(v[0].shape) for p, v in tree_items(got_specs)}
    assert got_shapes == ref_shapes


def test_group_step_counts_its_collectives():
    """A (2, 2) group's step moves data only through its counted
    collectives: the ``embed_fsdp`` all-gathers, the model rows'
    all-reduces, the data-parallel reduce-scatters and all-reduces of the
    gradients."""
    _, (tcfg, np_params, hb, _, _, _) = setup("llama3_2_1b")
    hp = TrainHParams(learning_rate=LR)
    opt = make_optimizer_for(tcfg, hp)
    sh = ctx(tcfg, (2, 2))
    state = init_train_state(None, tcfg, opt, params=port_params(np_params),
                             device="cpu", sh=sh)
    batch = shard_batch(hb, sh.mesh, sh, device="cpu")
    with count_collectives() as coll:
        make_train_step(tcfg, opt, hp, sh)(state, batch)
    for kind in ("all-gather", "all-reduce", "reduce-scatter"):
        assert coll.by_kind[kind] > 0, kind
