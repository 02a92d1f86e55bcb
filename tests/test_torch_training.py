"""The port's training substrate against the JAX reference's, on the CPU:
the counterparts of tests/test_training.py, each held to the reference.

* one AdamW and one Adafactor step: params and optimizer state leaf by leaf
  at atol 5e-5 (the reference's own bound between two compilations of a
  step, tests/test_training.py), state shapes equal;
* grad accumulation (2 micro-batches == 1 batch, and == the reference's);
* the loss falls over 8 steps, step by step as the reference's does;
* Adafactor's factored state stays under 0.6x the params;
* checkpoints: round trip and resume, a reference-written checkpoint
  restored and continued by the port, a port-written one restored by the
  reference;
* the data stream: deterministic and bit-equal to the reference's;
* the launcher's printed losses against the reference launcher's, and its
  resume from a checkpoint;
* int8 quantisation bit-equal to the reference's, and ``int8_allreduce``
  on gloo groups of 1, 2 and 4 ranks (spawned processes,
  tests/torch_dist_worker.py).
"""
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import get_reduced_config
from repro.data import make_batches as r_make_batches
from repro.launch.mesh import compat_make_mesh
from repro.models import NULL_SH, init_params
from repro.training import TrainHParams as RHParams
from repro.training import checkpoint as r_checkpoint
from repro.training import init_train_state as r_init_train_state
from repro.training import int8_allreduce as r_int8_allreduce
from repro.training import make_optimizer_for as r_make_optimizer_for
from repro.training import make_train_step as r_make_train_step
from repro.training.train_step import int8_dequantize as r_dequantize
from repro.training.train_step import int8_quantize as r_quantize
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.data import make_batches, shard_batch
from repro_torch.launch import train as t_launch
from repro_torch.training import (TrainHParams, checkpoint, init_train_state,
                                  make_optimizer_for, make_train_step)
from repro_torch.training.optimizer import tree_items, tree_leaves
from repro_torch.training.train_step import int8_dequantize, int8_quantize
from repro_torch.weights import from_reference

torch.set_num_threads(1)

ATOL = 5e-5


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    params, _ = init_params(jax.random.PRNGKey(0), get_reduced_config(arch))
    return params, jax.tree.map(np.asarray, params)


def setups(arch="llama3_2_1b", accum=1, optimizer=None):
    """(reference (cfg, state, jitted step), port (cfg, state, step)) from
    the same weights, as tests/test_training.py's ``_setup``."""
    cfg, tcfg = get_reduced_config(arch), t_get_reduced_config(arch)
    if optimizer:
        cfg, tcfg = cfg.replace(optimizer=optimizer), \
            tcfg.replace(optimizer=optimizer)
    params, np_params = ref_params(arch)
    rhp = RHParams(learning_rate=5e-3, grad_accum=accum, remat=True)
    ropt = r_make_optimizer_for(cfg, rhp)
    r_state = r_init_train_state(None, cfg, ropt, params=params)
    r_step = jax.jit(r_make_train_step(cfg, NULL_SH, ropt, rhp))
    hp = TrainHParams(learning_rate=5e-3, grad_accum=accum, remat=True)
    opt = make_optimizer_for(tcfg, hp)
    state = init_train_state(None, tcfg, opt,
                             params=from_reference(np_params, "cpu"),
                             device="cpu")
    return (cfg, r_state, r_step), (tcfg, state, make_train_step(tcfg, opt,
                                                                 hp))


def batches(cfg, tcfg, bsz, seq, seed):
    """The same host batches from both pipelines (asserted bit-equal), as
    (reference arrays, port tensors) pairs."""
    for rb, tb in zip(r_make_batches(cfg, bsz, seq, seed=seed),
                      make_batches(tcfg, bsz, seq, seed=seed)):
        for k in rb:
            np.testing.assert_array_equal(rb[k], tb[k])
        yield ({k: jnp.asarray(v) for k, v in rb.items()},
               shard_batch(tb, device="cpu"))


def items(tree):
    """(path, numpy leaf) of a port or reference state tree."""
    return [(p, x.numpy() if torch.is_tensor(x) else np.asarray(x))
            for p, x in tree_items(tree)]


def assert_trees_close(port, ref, atol=ATOL):
    got, want = items(port), items(ref)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                   err_msg=str(path))


@pytest.mark.parametrize("arch,optimizer", [
    ("llama3_2_1b", "adamw"), ("llama3_2_1b", "adafactor"),
    ("deepseek_v2_236b", "adafactor")])
def test_one_step_matches_reference(arch, optimizer):
    (cfg, r_state, r_step), (tcfg, state, step) = setups(arch,
                                                         optimizer=optimizer)
    rb, tb = next(batches(cfg, tcfg, 2, 32, seed=0))
    r_state, r_metrics = r_step(r_state, rb)
    state, metrics = step(state, tb)
    assert int(state["step"]) == int(r_state["step"]) == 1
    assert_trees_close(state["params"], r_state["params"])
    assert_trees_close(state["opt"], r_state["opt"])
    assert metrics.keys() == r_metrics.keys()
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(r_metrics[k]),
                                   rtol=2e-4, atol=1e-5, err_msg=k)


def assert_leaves_scaled(port, ref, atol=1e-7, rtol=2e-4):
    """max|port - ref| <= atol + rtol * max|ref| on every leaf."""
    got, want = items(port), items(ref)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape, path
        bound = atol + rtol * float(np.max(np.abs(b)))
        assert float(np.max(np.abs(a - b))) <= bound, path


def test_grad_accum_equivalence():
    (cfg, r2, r_step2), (tcfg, s2, step2) = setups(accum=2)
    _, (_, s1, step1) = setups(accum=1)
    rb, tb = next(batches(cfg, tcfg, 4, 32, seed=1))
    s1, m1 = step1(s1, tb)
    s2, m2 = step2(s2, tb)
    r2, rm2 = r_step2(r2, rb)
    err = max(float(torch.max(torch.abs(a - b)))
              for a, b in zip(tree_leaves(s1["params"]),
                              tree_leaves(s2["params"])))
    assert err < ATOL, f"grad-accum diverges from full batch: {err}"
    # the accumulated gradients, as AdamW's moments hold them (linear in
    # the gradient: the params' one-step update is g / (|g| + eps), which
    # amplifies f32 noise where |g| is near eps)
    assert_leaves_scaled(s2["opt"], r2["opt"])
    np.testing.assert_allclose(float(m2["loss"]), float(rm2["loss"]),
                               rtol=2e-4, atol=1e-5)


def test_loss_decreases_as_the_reference():
    (cfg, r_state, r_step), (tcfg, state, step) = setups()
    rb, tb = next(batches(cfg, tcfg, 4, 64, seed=0))
    losses, r_losses = [], []
    for _ in range(8):  # overfit one batch
        state, metrics = step(state, tb)
        r_state, r_metrics = r_step(r_state, rb)
        losses.append(float(metrics["loss"]))
        r_losses.append(float(r_metrics["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses
    np.testing.assert_allclose(losses, r_losses, rtol=1e-4)


def test_adafactor_state_is_factored():
    (_, r_state, _), (_, state, _) = setups(optimizer="adafactor")
    got, want = items(state["opt"]), items(r_state["opt"])
    assert [(p, a.shape) for p, a in got] == [(p, b.shape) for p, b in want]
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    n_stats = sum(x.numel() for x in tree_leaves(state["opt"]))
    assert n_stats < 0.6 * n_params
    assert all(x.dtype == torch.float32 for x in tree_leaves(state["opt"]))


def test_checkpoint_roundtrip_and_resume(tmp_path):
    (cfg, _, _), (tcfg, state, step) = setups()
    feed = batches(cfg, tcfg, 2, 32, seed=2)
    b1, b2 = next(feed)[1], next(feed)[1]
    state1, _ = step(state, b1)
    path = checkpoint.save(str(tmp_path), 1, state1)
    assert os.path.exists(path)
    assert checkpoint.latest_step(str(tmp_path)) == 1
    restored, step_no = checkpoint.restore(str(tmp_path), state1)
    assert step_no == 1
    for (pa, a), (pb, b) in zip(tree_items(state1), tree_items(restored)):
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(a, b), pa
    # resume equivalence: continuing from the restored state == continuing
    # directly (the step updates its state in place: restored is a copy)
    s_resumed, _ = step(restored, b2)
    s_direct, _ = step(state1, b2)
    for a, b in zip(tree_leaves(s_direct), tree_leaves(s_resumed)):
        assert torch.equal(a, b)


def test_checkpoint_bf16_bits_roundtrip(tmp_path):
    tree = {"w": torch.randn(3, 5).to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32)}
    checkpoint.save(str(tmp_path), 7, tree)
    got, step_no = checkpoint.restore(str(tmp_path), tree)
    assert step_no == 7 and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16),
                       tree["w"].view(torch.int16))
    assert torch.equal(got["step"], tree["step"])


def test_reference_checkpoint_continues_in_the_port(tmp_path):
    (cfg, r_state, r_step), (tcfg, state, step) = setups()
    feed = batches(cfg, tcfg, 2, 32, seed=2)
    (rb1, _), (rb2, tb2) = next(feed), next(feed)
    r_state1, _ = r_step(r_state, rb1)
    r_checkpoint.save(str(tmp_path), 1, r_state1)
    restored, step_no = checkpoint.restore(str(tmp_path), state)
    assert step_no == 1
    for (p, a), (_, b) in zip(items(restored), items(r_state1)):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    r_state2, _ = r_step(r_state1, rb2)
    state2, _ = step(restored, tb2)
    assert_trees_close(state2, r_state2)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    (cfg, r_state, _), (tcfg, state, step) = setups()
    state1, _ = step(state, next(batches(cfg, tcfg, 2, 32, seed=2))[1])
    checkpoint.save(str(tmp_path), 1, state1)
    restored, step_no = r_checkpoint.restore(str(tmp_path), r_state)
    assert step_no == 1
    for (p, a), (_, b) in zip(items(state1), items(restored)):
        np.testing.assert_array_equal(a, b, err_msg=str(p))


@pytest.mark.parametrize("arch", ["llama3_2_1b", "seamless_m4t_large_v2"])
@pytest.mark.parametrize("seed,start", [(3, 5), (0, 0)])
def test_data_pipeline_matches_reference(arch, seed, start):
    cfg, tcfg = get_reduced_config(arch), t_get_reduced_config(arch)
    a = next(make_batches(tcfg, 4, 64, seed=seed, start_step=start))
    b = next(make_batches(tcfg, 4, 64, seed=seed, start_step=start))
    want = next(r_make_batches(cfg, 4, 64, seed=seed, start_step=start))
    assert a.keys() == want.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], want[k])
        assert a[k].dtype == want[k].dtype
    c = next(make_batches(tcfg, 4, 64, seed=seed + 1, start_step=start))
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (4, 64)
    assert a["tokens"].min() >= 0
    assert a["tokens"].max() < cfg.vocab_size


_LOSS_LINE = re.compile(r"^step (\d+) loss ([0-9.]+) \(")


def _losses(lines):
    return {int(m.group(1)): float(m.group(2))
            for m in map(_LOSS_LINE.match, lines) if m}


def test_launcher_losses_match_reference_launcher(monkeypatch, capsys):
    from repro.launch import train as r_launch

    monkeypatch.setattr("sys.argv", ["train", "--reduced", "--steps", "10"])
    r_launch.main()
    r_lines = capsys.readouterr().out.splitlines()
    run = t_launch.run(
        t_launch.parse_args(["--reduced", "--steps", "10", "--device",
                             "cpu"]),
        params=from_reference(ref_params("llama3_2_1b")[1], "cpu"))
    assert run.lines[-1] == r_lines[-1] == "done"
    got, want = _losses(run.lines), _losses(r_lines)
    assert sorted(got) == sorted(want) == [5, 10]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    assert got[10] < got[5]


def test_launcher_resumes_from_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    whole = t_launch.main(["--reduced", "--steps", "25", "--device", "cpu",
                           "--batch", "2", "--seq", "32"])
    first = t_launch.main(["--reduced", "--steps", "20", "--device", "cpu",
                           "--batch", "2", "--seq", "32", "--ckpt", ckpt])
    assert checkpoint.latest_step(ckpt) == 20
    second = t_launch.main(["--reduced", "--steps", "25", "--device", "cpu",
                            "--batch", "2", "--seq", "32", "--ckpt", ckpt])
    assert second.lines[0] == "resumed at step 20"
    assert _losses(first.lines)[20] == _losses(whole.lines)[20]
    assert _losses(second.lines)[25] == _losses(whole.lines)[25]
    for a, b in zip(tree_leaves(second.state), tree_leaves(whole.state)):
        assert torch.equal(a, b)


def test_int8_quantize_matches_reference():
    rng = np.random.RandomState(0)
    # halfway cases: amax 127 gives scale 1, so x / scale lands on .5 ties
    ties = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5]],
                    np.float32)
    for x in (rng.randn(4, 64).astype(np.float32), ties,
              np.zeros((2, 8), np.float32)):
        q, s = int8_quantize(torch.from_numpy(x))
        rq, rs = r_quantize(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(int8_dequantize(q, s).numpy(),
                                      np.asarray(r_dequantize(rq, rs)))


def _gloo_allreduce(tmp_path, inputs):
    """``int8_allreduce`` of ``xs[r]`` on rank r of a gloo group of
    len(xs) spawned processes, for each ``xs`` of ``inputs``: every rank's
    results."""
    import multiprocessing as mp

    from torch_dist_worker import INIT_TIMEOUT, int8_allreduce_rank

    world = len(inputs[0])
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=int8_allreduce_rank,
                         args=(r, world, str(tmp_path / "store"), inputs,
                               queue)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        out = dict(queue.get(timeout=2 * INIT_TIMEOUT) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=INIT_TIMEOUT)
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0] * world
    return [out[r] for r in range(world)]


def _reference_composition(xs):
    """The reference's int8 all-reduce composed from its own quantise /
    dequantise over the same chunks (reduce-scatter, local sum, second
    quantisation, gather), for any number of ranks."""
    n = len(xs)
    flat = [np.concatenate([x.reshape(-1), np.zeros((-x.size) % n,
                                                    x.dtype)]) for x in xs]
    q, s = zip(*(r_quantize(jnp.asarray(f.reshape(n, -1))) for f in flat))
    parts = []
    for j in range(n):  # rank j's chunk, from everyone
        q_t = jnp.stack([qr[j] for qr in q])
        s_t = jnp.stack([sr[j] for sr in s])
        local = jnp.sum(r_dequantize(q_t, s_t), axis=0)
        q2, s2 = r_quantize(local[None])
        parts.append(np.asarray(r_dequantize(q2, s2))[0])
    return np.concatenate(parts)[:xs[0].size].reshape(xs[0].shape)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_int8_allreduce_on_gloo(tmp_path, world):
    # tests/test_training.py's input, and one that needs padding
    inputs = [np.random.RandomState(0).randn(world, 64, 8).astype(np.float32),
              np.random.RandomState(1).randn(world, 61, 7).astype(np.float32)]
    got = _gloo_allreduce(tmp_path, inputs)
    for i, xs in enumerate(inputs):
        want = _reference_composition(xs)
        if world == 1:  # the reference's own shard_map on one CPU device
            from jax.sharding import PartitionSpec as P

            mesh = compat_make_mesh((1,), ("x",), devices=jax.devices()[:1])
            f = compat.shard_map(lambda v: r_int8_allreduce(v[0], "x"),
                                 mesh=mesh, in_specs=P("x"), out_specs=P())
            np.testing.assert_array_equal(want,
                                          np.asarray(f(jnp.asarray(xs))))
        for rank_out in got:
            np.testing.assert_array_equal(rank_out[i], want)
    # tests/test_training.py's int8 quantisation error bound, on its input
    total = inputs[0].sum(axis=0)
    rel = np.abs(got[0][0] - total) / (np.abs(total) + 1e-3)
    assert rel.mean() < 0.05, rel.mean()
