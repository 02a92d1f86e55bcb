"""The port's performance-model layer against the reference, on the CPU.

* ``launch.costs``: ``CostSummary``, ``roofline_terms`` and
  ``tau_from_step_cost`` give the reference's numbers once the port's H100
  constants are patched to the reference's (exact: the same arithmetic);
  the kernel wrappers' ``*_cost`` give every data-independent bound of
  PERF.md §6 to its printed digit, and the formulas they replace exactly.
* ``BlockServer.decode_step_cost`` on the reduced llama, slab and paged,
  equals an analytic count made here from the param and pool trees
  (exact), whatever the backend; every reduced family counts.
* ``calibrate_taus`` / ``calibrated_problem``: τ finite and positive, the
  live problem untouched, a controller built on (or swapped to) the
  calibrated problem routes on fresh edge costs (the reference's
  tests/test_routing_online.py:168-215, tests/test_sharded_serving.py:
  173-198 in the port's form).
* ``torch_shortest_paths(device="cpu")``: the numpy DP's terminal servers
  and costs (exact, float64), and ``jax_shortest_paths``'s costs within
  float32's rtol 1e-5.
* The port's engine against the port's simulator on the reference's
  cross-validation (benchmarks/engine_validation.py ``cross_validate``):
  R 1/4/8 poisson, bursty R4/R8 and the zamba2 hybrid R4/R8 with its
  per-family block weights give BENCH_engine.json's ``xval.*`` rows (the
  reference's numbers) within 1e-12 relative.
* The serve launcher prints the reference launcher's lines, with bridged
  weights.
"""
import json
import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as RC
import repro.launch.costs as RCost
import repro_torch.core as TC
import repro_torch.launch.costs as TCost
from repro.configs import get_reduced_config
from repro.models import init_params
from repro_torch import kernels as K
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.models import init_params as t_init_params
from repro_torch.models.blocks import stack_block_kinds
from repro_torch.serving import ContinuousBatchingScheduler, GeoServingSystem
from repro_torch.sim import (SimConfig, bursty_requests, poisson_requests,
                             prompts_for, simulate)
from repro_torch.weights import from_reference

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _bridged(n_layers=None):
    cfg = get_reduced_config("llama3_2_1b")
    tcfg = t_get_reduced_config("llama3_2_1b")
    if n_layers:
        cfg, tcfg = cfg.replace(n_layers=n_layers), \
            tcfg.replace(n_layers=n_layers)
    params, _ = init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, tcfg, from_reference(
        jax.tree.map(np.asarray, params), "cpu")


def _geo_problem(C, L, taus=(0.004, 0.004, 0.020, 0.020, 0.020)):
    """examples/geo_serve.py's heterogeneous 5-server cluster."""
    llm = C.LLMSpec("t", L, block_bytes=50.0, cache_bytes_per_token=0.5)
    mem = (500.0, 500.0, 220.0, 220.0, 220.0)
    servers = [C.ServerSpec(j, m, t, tau_prefill_base=0.002,
                            tau_prefill_per_token=0.0005)
               for j, (m, t) in enumerate(zip(mem, taus))]
    rtt = np.array([[0.01, 0.01, 0.03, 0.03, 0.03]])
    return C.Problem(llm, servers, 1, rtt, 3 * rtt, workload=C.Workload(8, 16))


# ---------------------------------------------------------------------------
# launch.costs arithmetic
# ---------------------------------------------------------------------------


def test_card_constants():
    """NVIDIA's H100 SXM data sheet, dense rates."""
    assert TCost.HBM_BW == 3.35e12
    assert TCost.PEAK_FLOPS == {"bfloat16": 989e12, "tfloat32": 495e12,
                                "float32": 67e12}
    assert TCost.PEAK_FLOPS_BF16 == TCost.PEAK_FLOPS["bfloat16"]


@pytest.mark.parametrize("flops,nbytes", [(197e12, 819e9 / 2), (1e9, 3e9),
                                          (6.9e9, 8.7e8), (0.0, 0.0)])
def test_roofline_and_tau_equal_reference(monkeypatch, flops, nbytes):
    """The reference's arithmetic exactly, at the reference's constants
    (the collective term is 0 on one card; the reference's is 0 for a
    step without collectives)."""
    monkeypatch.setitem(TCost.PEAK_FLOPS, "bfloat16", RCost.PEAK_FLOPS_BF16)
    monkeypatch.setattr(TCost, "HBM_BW", RCost.HBM_BW)
    rc = RCost.CostSummary(flops=flops, bytes_accessed=nbytes)
    tc = TCost.CostSummary(flops=flops, bytes_accessed=nbytes)
    ref, got = RCost.roofline_terms(rc, 1), TCost.roofline_terms(tc, 1)
    for key in got:
        assert got[key] == ref[key], key
    for m, n in ((7, 8), (3, 8), (1, 1), (0, 4)):
        assert TCost.tau_from_step_cost(tc, 1, m, n) == \
            RCost.tau_from_step_cost(rc, 1, m, n)


def test_cost_summary_equals_reference():
    fields = dict(flops=1.0, bytes_accessed=2.0, coll_wire_bytes=3.0,
                  coll_count=1, coll_by_kind={"all-reduce": 3.0})
    out = []
    for C in (RCost, TCost):
        b = C.CostSummary()
        b.scaled_add(C.CostSummary(**fields), 5.0)
        b.scaled_add(C.CostSummary(flops=0.5, bytes_accessed=1.0), 2.0)
        out.append(b.to_dict())
    assert out[0] == out[1]


# the per-call bound formulas chip_smoke.py carried before they moved into
# the kernel wrappers (``*_cost``), kept here as the arithmetic to hold
_HBM = 3.35e12
_PEAK = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12}


def _old_bound(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / _HBM, flops / _PEAK[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _old_decode_bound(q, k, v, pos, window=None, kv_len=None, causal=True):
    B, _, H, Dk = q.shape
    T, Kv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    es = q.element_size()
    v_bytes = 0 if v.data_ptr() == k.data_ptr() else Dv
    pos_l = [int(p) for p in pos.tolist()]
    kvl = [T] * B if kv_len is None else [int(x) for x in kv_len.tolist()]
    rows = 0
    for p, kl in zip(pos_l, kvl):
        hi = min(p + 1, kl, T) if causal else min(kl, T)
        lo = 0 if window is None or not causal else max(0, p - window + 1)
        rows += max(hi - lo, 0)
    nbytes = (B * H * Dk + B * H * Dv) * es \
        + rows * Kv * (Dk + v_bytes) * es + 4 * B
    return _old_bound(nbytes, 2 * rows * H * (Dk + Dv),
                      str(q.dtype).split(".")[-1])


def _old_prefill_bound(q, k, v, q_start=0, window=None, causal=True):
    B, Sq, H, Dk = q.shape
    Skv, Dv = k.shape[1], v.shape[-1]
    es = q.element_size()
    w = Skv + Sq if window is None else window
    pairs = Sq * Skv if not causal else sum(
        min(q_start + i + 1, Skv) - max(0, q_start + i - w + 1)
        for i in range(Sq))
    nbytes = (q.numel() + k.numel() + v.numel() + B * Sq * H * Dv) * es
    return _old_bound(nbytes, 2 * B * H * pairs * (Dk + Dv),
                      str(q.dtype).split(".")[-1])


def _old_scan_bound(kind, args):
    if kind == "wkv6":
        r, k, v, lw, u = args[:5]
        state = args[5] if len(args) > 5 else None
        B, S, H, hd = r.shape
        n_state = B * H * hd * hd
        nbytes = 4 * (5 * B * S * H * hd + H * hd + n_state
                      + (0 if state is None else n_state))
        flops = 4 * B * S * H * hd * hd
    else:
        x, bm, cm, dt, A, D = args[:6]
        state = args[6] if len(args) > 6 else None
        B, S, H, p = x.shape
        n = bm.shape[-1]
        n_state = B * H * p * n
        nbytes = 4 * (2 * B * S * H * p + 2 * B * S * n + B * S * H + 2 * H
                      + n_state + (0 if state is None else n_state))
        flops = 4 * B * S * H * p * n
    return _old_bound(nbytes, flops, "tfloat32")


def _z(*shape, dt=torch.bfloat16):
    return torch.zeros(shape, dtype=dt)


def _decode_args(B, H, Kv, D, T, Dv=None, pos=None):
    q, k = _z(B, 1, H, D), _z(B, T, Kv, D)
    v = _z(B, T, Kv, Dv or D)
    if pos is None:
        pos = torch.as_tensor(
            np.random.default_rng(B + T).integers(0, T, B))
    return q, k, v, pos


def _mla_args():
    """Absorbed MLA decode: the joint (…, 576) cache as keys, its first
    512 columns as values (bytes counted once)."""
    q = _z(8, 1, 128, 576)
    k = _z(8, 192, 1, 576)
    pos = torch.as_tensor(np.random.default_rng(1).integers(0, 192, 8))
    return q, k, k[..., :512], pos


def _wkv(B, S, state=False):
    f = torch.float32
    args = [_z(B, S, 64, 64, dt=f) for _ in range(4)] + [_z(64, 64, dt=f)]
    return args + ([_z(B, 64, 64, 64, dt=f)] if state else [])


def _ssd(B, S, state=False):
    f = torch.float32
    args = [_z(B, S, 112, 64, dt=f), _z(B, S, 64, dt=f), _z(B, S, 64, dt=f),
            _z(B, S, 112, dt=f), _z(112, dt=f), _z(112, dt=f)]
    return args + ([_z(B, 112, 64, 64, dt=f)] if state else [])


_CROSS_KVL = torch.tensor([256] * 6 + [512, 1000])
# (row, package cost, old formula, dtype, PERF.md §6's printed bound or
# None where the row's positions come from the run's data)
BOUND_ROWS = {
    "K1 path": (lambda: K.decode_attention_cost(*_decode_args(8, 32, 8, 64,
                                                              192)),
                lambda: _old_decode_bound(*_decode_args(8, 32, 8, 64, 192)),
                "bfloat16", None),
    "K1 long": (lambda: K.decode_attention_cost(*_decode_args(
                    8, 32, 8, 64, 4096, pos=torch.full((8,), 4095))),
                lambda: _old_decode_bound(*_decode_args(
                    8, 32, 8, 64, 4096, pos=torch.full((8,), 4095))),
                "bfloat16", (0.0201, "bytes")),
    "K1 D=224": (lambda: K.decode_attention_cost(*_decode_args(8, 32, 32,
                                                               224, 192)),
                 lambda: _old_decode_bound(*_decode_args(8, 32, 32, 224,
                                                         192)),
                 "bfloat16", None),
    "K1 MLA": (lambda: K.decode_attention_cost(*_mla_args()),
               lambda: _old_decode_bound(*_mla_args()), "bfloat16", None),
    "K1 D=256": (lambda: K.decode_attention_cost(
                     *_decode_args(8, 8, 4, 256, 1344), window=1024),
                 lambda: _old_decode_bound(
                     *_decode_args(8, 8, 4, 256, 1344), window=1024),
                 "bfloat16", None),
    "K1 cross": (lambda: K.decode_attention_cost(
                     *_decode_args(8, 16, 16, 64, 1024), kv_len=_CROSS_KVL,
                     causal=False),
                 lambda: _old_decode_bound(
                     *_decode_args(8, 16, 16, 64, 1024), kv_len=_CROSS_KVL,
                     causal=False),
                 "bfloat16", (0.0037, "bytes")),
    "K2 path": (lambda: K.flash_attention_cost(
                    _z(8, 128, 32, 64), _z(8, 128, 8, 64), _z(8, 128, 8, 64)),
                lambda: _old_prefill_bound(
                    _z(8, 128, 32, 64), _z(8, 128, 8, 64), _z(8, 128, 8, 64)),
                "bfloat16", (0.0031, "bytes")),
    "K2 long": (lambda: K.flash_attention_cost(
                    _z(1, 2048, 32, 64), _z(1, 2048, 8, 64),
                    _z(1, 2048, 8, 64)),
                lambda: _old_prefill_bound(
                    _z(1, 2048, 32, 64), _z(1, 2048, 8, 64),
                    _z(1, 2048, 8, 64)),
                "bfloat16", (0.0174, "operations")),
    "K2 D=224": (lambda: K.flash_attention_cost(
                     *[_z(8, 115, 32, 224) for _ in range(3)]),
                 lambda: _old_prefill_bound(
                     *[_z(8, 115, 32, 224) for _ in range(3)]),
                 "bfloat16", (0.0157, "bytes")),
    "K2 MLA": (lambda: K.flash_attention_cost(
                   _z(8, 128, 128, 192), _z(8, 128, 128, 192),
                   _z(8, 128, 128, 128)),
               lambda: _old_prefill_bound(
                   _z(8, 128, 128, 192), _z(8, 128, 128, 192),
                   _z(8, 128, 128, 128)),
               "bfloat16", (0.0501, "bytes")),
    "K2 D=256": (lambda: K.flash_attention_cost(
                     _z(8, 320, 8, 256), _z(8, 1344, 4, 256),
                     _z(8, 1344, 4, 256), 1024, 1024),
                 lambda: _old_prefill_bound(
                     _z(8, 320, 8, 256), _z(8, 1344, 4, 256),
                     _z(8, 1344, 4, 256), 1024, 1024),
                 "bfloat16", (0.0217, "operations")),
    "K2 enc": (lambda: K.flash_attention_cost(
                   *[_z(1, 1000, 16, 64) for _ in range(3)], causal=False),
               lambda: _old_prefill_bound(
                   *[_z(1, 1000, 16, 64) for _ in range(3)], causal=False),
               "bfloat16", (0.0041, "operations")),
    "K2 cross": (lambda: K.flash_attention_cost(
                     _z(8, 16, 16, 64), _z(8, 1000, 16, 64),
                     _z(8, 1000, 16, 64), causal=False),
                 lambda: _old_prefill_bound(
                     _z(8, 16, 16, 64), _z(8, 1000, 16, 64),
                     _z(8, 1000, 16, 64), causal=False),
                 "bfloat16", (0.0099, "bytes")),
    "K3 path": (lambda: K.wkv6_cost(*_wkv(8, 115)),
                lambda: _old_scan_bound("wkv6", _wkv(8, 115)),
                "tfloat32", (0.0250, "bytes")),
    "K3 long": (lambda: K.wkv6_cost(*_wkv(1, 2048)),
                lambda: _old_scan_bound("wkv6", _wkv(1, 2048)),
                "tfloat32", (0.0504, "bytes")),
    "K3 carried state": (lambda: K.wkv6_cost(*_wkv(2, 33, True)),
                         lambda: _old_scan_bound("wkv6", _wkv(2, 33, True)),
                         "tfloat32", None),
    "K4 path": (lambda: K.ssd_cost(*_ssd(8, 115)),
                lambda: _old_scan_bound("ssd", _ssd(8, 115)),
                "tfloat32", (0.0204, "bytes")),
    "K4 long": (lambda: K.ssd_cost(*_ssd(1, 2048)),
                lambda: _old_scan_bound("ssd", _ssd(1, 2048)),
                "tfloat32", (0.0362, "bytes")),
    "K4 carried state": (lambda: K.ssd_cost(*_ssd(2, 33, True)),
                         lambda: _old_scan_bound("ssd", _ssd(2, 33, True)),
                         "tfloat32", None),
}


@pytest.mark.parametrize("row", list(BOUND_ROWS))
def test_kernel_bounds_unchanged(row):
    """The kernel rows' bounds from the wrappers' costs: the same numbers
    as the formulas they replace, and PERF.md §6's printed digits."""
    cost, old, dtype, printed = BOUND_ROWS[row]
    got = TCost.bound_ms(cost(), dtype)
    assert got == old()
    if printed is not None:
        assert (round(got[0], 4), got[1]) == printed


@pytest.mark.parametrize("q_start,window,keys", [
    (1920, 1024, 1151), (0, 1024, 128), (1920, None, 2048),
    (64, None, 192)])
def test_k2_cost_reads_the_reached_keys(q_start, window, keys):
    """K2's bytes count the K/V rows the causal span and the window reach
    (a slot's 128 query rows at ``q_start`` over 2048 keys), and its flops
    the reached (query, key) pairs, as a loop over the queries gives."""
    q, k, v = _z(1, 128, 8, 256), _z(1, 2048, 4, 256), _z(1, 2048, 4, 256)
    got = K.flash_attention_cost(q, k, v, q_start, window)
    w = 1 << 30 if window is None else window
    reach = [range(max(0, q_start + i - w + 1), q_start + i + 1)
             for i in range(128)]
    assert len(set().union(*reach)) == keys
    es = q.element_size()
    assert got.bytes_accessed == (2 * q.numel() + keys * 4 * 512) * es
    assert got.flops == 2 * 8 * sum(len(r) for r in reach) * 512


# ---------------------------------------------------------------------------
# the pooled decode step's count
# ---------------------------------------------------------------------------


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _analytic_llama_count(cfg, srv, layout):
    """The reduced llama's pooled decode step, counted from its trees:
    every matrix of a hosted layer meets N rows (2 flops a product), and
    attention reads every cache position (score and P·V); each parameter
    and cache byte is read once, one token per row written to K and V,
    h read and written, positions (int64) and the layer mask read, and on
    the paged layout the int64 page table."""
    N, T, m = srv.pool.n_rows, srv.pool.max_len, srv.m
    params = list(_leaves(srv.run_params[0]))
    matrices = sum(x.numel() for x in params if x.dim() >= 3)  # (m, ...)
    flops = 2 * N * matrices \
        + m * 2 * N * T * cfg.n_heads * 2 * cfg.head_dim
    es = 4  # float32
    cache = m * N * T * cfg.n_kv_heads * cfg.head_dim * es * 2  # K and V
    nbytes = sum(x.numel() for x in params) * es + cache + cache // T \
        + 2 * N * cfg.d_model * es + N * 8 + m * N
    if layout == "paged":
        nbytes += N * (T // srv.pool.page_size) * 8
    return flops, nbytes


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_decode_step_cost_equals_analytic_count(layout):
    cfg, _, tcfg, tparams = _bridged(n_layers=8)
    counts = {}
    for backend in ("kernel", "plain"):
        system = GeoServingSystem(tcfg, tparams, _geo_problem(TC, 8),
                                  R=4, max_new_tokens=16, max_sessions=4,
                                  backend=backend, cache_layout=layout,
                                  device="cpu")
        pools = {j: [x.clone() for x in _leaves(dict(enumerate(
            srv.pool.tree)))] for j, srv in system.servers.items()}
        launches = K.decode_attention.launches
        counts[backend] = {}
        for j, srv in system.servers.items():
            cost = srv.decode_step_cost()
            assert srv.decode_step_cost() is cost  # cached
            assert (cost.flops, cost.bytes_accessed) == \
                _analytic_llama_count(tcfg, srv, layout), j
            counts[backend][j] = cost.to_dict()
            assert all(torch.equal(a, b) for a, b in zip(
                pools[j], _leaves(dict(enumerate(srv.pool.tree)))))
        assert K.decode_attention.launches == launches
    assert counts["kernel"] == counts["plain"]


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_7b",
                                  "deepseek_v2_236b", "gemma3_4b",
                                  "seamless_m4t_large_v2",
                                  "llama4_scout_17b_a16e"])
def test_decode_step_cost_every_family(arch):
    """Every reduced family counts its step on meta tensors: flops and
    bytes beyond the decoding layers' parameters, τ finite and positive,
    slab and paged alike apart from the page table.  A server hosting
    encoder blocks only does no decode work: no flops, and the bytes of
    h and the row vectors alone."""
    cfg = t_get_reduced_config(arch)
    params = t_init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prob = _geo_problem(TC, cfg.n_layers)
    costs = {}
    for layout in ("slab", "paged"):
        system = GeoServingSystem(cfg, params, prob, R=4, max_new_tokens=8,
                                  max_sessions=4, cache_layout=layout,
                                  device="cpu")
        for j, srv in system.servers.items():
            c = srv.decode_step_cost()
            params_b = sum(x.numel() * x.element_size()
                           for (kind, _, _), r in zip(srv.runs,
                                                      srv.run_params)
                           if kind != "enc" for x in _leaves(r))
            if set(srv.kinds) == {"enc"}:
                N, es = srv.pool.n_rows, 2 if cfg.param_dtype == \
                    "bfloat16" else 4
                assert c.flops == 0 and c.bytes_accessed == \
                    2 * N * cfg.d_model * es + N * 8 + srv.m * N + \
                    (N * srv.pool.max_pages * 8 if layout == "paged" else 0)
            else:
                assert c.flops > 0 and c.bytes_accessed > params_b
            costs.setdefault(j, []).append(
                (c.flops, c.bytes_accessed, srv.pool.n_rows,
                 srv.pool.max_len // max(1, srv.pool.page_size)))
        taus = system.calibrate_taus()
        assert all(math.isfinite(t) and t > 0 for t in taus.values())
    for (f0, b0, N, _), (f1, b1, _, pages) in costs.values():
        assert f0 == f1 and b1 - b0 == N * pages * 8


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def test_calibrated_taus_feed_perf_model():
    """Step cost -> roofline -> per-server τ: finite, positive, folded
    into a COPY of the problem; the live engine keeps its spec'd τ, so
    its virtual clock does not change."""
    _, _, tcfg, tparams = _bridged()
    llm = TC.LLMSpec("toy", tcfg.n_layers, block_bytes=100.0,
                     cache_bytes_per_token=1.0)
    servers = [TC.ServerSpec(j, mem_bytes=1000.0, tau=0.01 * (j + 1),
                             tau_prefill_base=0.002,
                             tau_prefill_per_token=0.0005) for j in range(2)]
    rtt = np.full((1, 2), 0.02)
    prob = TC.Problem(llm, servers, 1, rtt, rtt * 3,
                      workload=TC.Workload(4, 4))
    system = GeoServingSystem(tcfg, tparams, prob, R=2, max_new_tokens=4,
                              max_sessions=4, device="cpu")
    cost = next(iter(system.servers.values())).decode_step_cost()
    assert cost.flops > 0 and cost.bytes_accessed > 0
    taus = system.calibrate_taus()
    assert set(taus) == set(system.servers)
    assert all(np.isfinite(t) and t > 0 for t in taus.values())
    cal = system.calibrated_problem()
    np.testing.assert_array_equal(cal.tau(),
                                  [taus[s.sid] for s in cal.servers])
    assert system.problem.tau().tolist() == [0.01, 0.02]
    assert system.problem is prob
    # the live virtual clock is the spec'd τ's: a generation after the
    # calibration bills the same time as one on a fresh engine
    toks = np.arange(2, 8)
    fresh = GeoServingSystem(tcfg, tparams, prob, R=2, max_new_tokens=4,
                             max_sessions=4, device="cpu")
    from repro_torch.serving import generate
    assert generate(system, toks, 3)[1] == generate(fresh, toks, 3)[1]


def test_calibrated_problem_gets_fresh_route_cache():
    """An ``OnlineBPRR`` built from ``calibrated_problem()`` — and one whose
    τ vector is swapped in via ``replace_servers`` — serves edge costs of
    the CALIBRATED τ, not a memo warmed on the spec'd τ."""
    _, _, tcfg, tparams = _bridged()
    llm = TC.LLMSpec("toy", tcfg.n_layers, block_bytes=100.0,
                     cache_bytes_per_token=1.0)
    servers = [TC.ServerSpec(j, mem_bytes=1000.0, tau=0.01 * (j + 1),
                             tau_prefill_base=0.002,
                             tau_prefill_per_token=0.0005) for j in range(2)]
    rtt = np.full((1, 2), 0.02)
    prob = TC.Problem(llm, servers, 1, rtt, rtt * 3,
                      workload=TC.Workload(4, 4))
    system = GeoServingSystem(tcfg, tparams, prob, R=2, max_new_tokens=4,
                              max_sessions=4, device="cpu")
    cal = system.calibrated_problem()
    assert not np.array_equal(cal.tau(), prob.tau())

    ctl = TC.OnlineBPRR(cal, R=2)
    fresh = TC.RouteCostCache(ctl.problem, ctl.placement)
    np.testing.assert_array_equal(ctl._route_cache.cost(0), fresh.cost(0))
    assert not np.array_equal(ctl._route_cache.cost(0),
                              TC.RouteCostCache(prob, ctl.placement).cost(0))

    ctl2 = TC.OnlineBPRR(prob, R=2)
    stale = ctl2._route_cache
    stale.cost(0)
    stale.cost(0, True)  # warm both memo keys
    ctl2.replace_servers(cal)
    assert ctl2._route_cache is not stale
    fresh2 = TC.RouteCostCache(ctl2.problem, ctl2.placement)
    for avg in (False, True):
        np.testing.assert_array_equal(ctl2._route_cache.cost(0, avg),
                                      fresh2.cost(0, avg))
    assert not np.array_equal(stale.cost(0), fresh2.cost(0))


# ---------------------------------------------------------------------------
# batched min-plus routing
# ---------------------------------------------------------------------------


def _routing_problem(C, seed, L=4, n=4, clients=2):
    """tests/test_routing_online.py's random problem."""
    rng = np.random.default_rng(seed)
    llm = C.LLMSpec("t", L, block_bytes=4.0, cache_bytes_per_token=0.25)
    servers = [C.ServerSpec(j, mem_bytes=float(4 * rng.integers(2, 6)),
                            tau=float(0.05 + 0.3 * rng.random()))
               for j in range(n)]
    rtt = 0.02 + 0.3 * rng.random((clients, n))
    return C.Problem(llm, servers, clients, rtt, 4 * rtt,
                     workload=C.Workload(2, 4))


@pytest.mark.parametrize("waited", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5, 8, 13])
def test_torch_shortest_paths_equal_numpy_dp_and_jax(seed, waited):
    out = {}
    for C in (RC, TC):
        prob = _routing_problem(C, seed)
        pl, info = C.cg_bp(prob, 2)
        assert info.feasible
        rng = np.random.default_rng(seed + 50)
        wait = 0.05 * rng.random((prob.n_servers + 1, prob.n_servers)) \
            if waited else None
        lw = float(prob.workload.l_out) if waited else 1.0
        out[C] = (prob, pl, wait, lw)
    prob, pl, wait, lw = out[TC]
    dist, choice = TC.torch_shortest_paths(prob, pl, waiting=wait,
                                           l_max_weight=lw, device="cpu")
    assert dist.dtype == torch.float64 and dist.device.type == "cpu"
    for c in range(prob.n_clients):
        route, cost = TC.shortest_path_route(prob, pl, c, waiting=wait,
                                             l_max_weight=lw)
        assert int(choice[c]) == route.servers[-1]
        assert float(dist[c]) == cost
    rprob, rpl, rwait, _ = out[RC]
    best, _ = RC.jax_shortest_paths(rprob, rpl, waiting=rwait,
                                    l_max_weight=lw)
    np.testing.assert_allclose(np.asarray(best), dist.numpy(), rtol=1e-5)


def test_torch_shortest_paths_no_route():
    """A placement that leaves a block uncovered routes nowhere: inf."""
    prob = _routing_problem(TC, 0)
    pl = TC.Placement(a=np.array([0, 0, 0, 0]), m=np.array([1, 1, 1, 1]))
    dist, _ = TC.torch_shortest_paths(prob, pl, device="cpu")
    assert torch.isinf(dist).all()


# ---------------------------------------------------------------------------
# engine against simulator: the reference's cross-validation
# ---------------------------------------------------------------------------

HYBRID_TAU = {"mamba": 0.7, "mamba_shared": 1.9}


def _xval_problem(block_tau=None):
    """benchmarks/engine_validation.py:59-78 ``_concurrency_problem``."""
    llm = TC.LLMSpec("xval", 8, block_bytes=50.0, cache_bytes_per_token=0.5,
                     block_tau=block_tau)
    fast = dict(tau_prefill_base=0.002, tau_prefill_per_token=0.0005)
    slow = dict(tau_prefill_base=0.004, tau_prefill_per_token=0.001)
    servers = [TC.ServerSpec(j, 500.0, 0.004, **fast) for j in (0, 1)] + \
        [TC.ServerSpec(j, 260.0, 0.020, **slow) for j in (2, 3, 4)]
    rtt = np.array([[0.01, 0.01, 0.03, 0.03, 0.03]])
    return TC.Problem(llm, servers, 1, rtt, 3 * rtt,
                      workload=TC.Workload(8, 12))


@pytest.mark.parametrize("name,R,trace,arch", [
    ("xval.R1", 1, "poisson", "llama3_2_1b"),
    ("xval.R4", 4, "poisson", "llama3_2_1b"),
    ("xval.R8", 8, "poisson", "llama3_2_1b"),
    ("xval.bursty.R4", 4, "bursty", "llama3_2_1b"),
    ("xval.bursty.R8", 8, "bursty", "llama3_2_1b"),
    ("xval.hybrid.R4", 4, "poisson", "zamba2_7b"),
    ("xval.hybrid.R8", 8, "poisson", "zamba2_7b"),
])
def test_engine_vs_simulator_cross_validation(name, R, trace, arch):
    """The reference's ``cross_validate(R, n_requests=10)`` through the
    port: engine == simulator, and both == BENCH_engine.json's row, within
    1e-12 relative (the clock depends only on placement, routing and
    admission, so the port's seeded weights serve)."""
    cfg = t_get_reduced_config(arch).replace(n_layers=8)
    block_tau = None
    if cfg.family == "hybrid":
        block_tau = tuple(HYBRID_TAU[k] for k in stack_block_kinds(cfg))
    problem = _xval_problem(block_tau)
    lw = problem.workload
    requests = bursty_requests(n_bursts=2, burst_size=4, spacing=2.0) \
        if trace == "bursty" else poisson_requests(10, 1.0, seed=0)
    sim = simulate(problem, SimConfig("proposed", n_requests=len(requests),
                                      rate=1.0, seed=0, R=R),
                   requests=requests)
    params = t_init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    system = GeoServingSystem(cfg, params, problem, algorithm="proposed",
                              R=R, max_new_tokens=lw.l_out,
                              max_sessions=max(8, R), device="cpu")
    sched = ContinuousBatchingScheduler(system, R=R, arrival_rate=1.0)
    for req, toks in zip(requests, prompts_for(requests, lw.l_in,
                                               cfg.vocab_size, seed=0)):
        sched.submit(req.rid, toks, req.arrival, n_new=lw.l_out,
                     client=req.client)
    served = [r for r in sched.run() if not r.dropped]
    assert len(served) == len(requests)
    eng = {"first_token": float(np.mean([r.first_token for r in served])),
           "per_token": float(np.mean([r.per_token for r in served]))}
    simm = {"first_token": sim.first_token, "per_token": sim.per_token_all}
    ref = json.loads((ROOT / "BENCH_engine.json").read_text())[
        "scenarios"][name]
    for k in eng:
        assert abs(eng[k] - simm[k]) <= 1e-12 * simm[k], k
        assert abs(eng[k] - ref[k + "_eng"]) <= 1e-12 * ref[k + "_eng"], k
        assert abs(simm[k] - ref[k + "_sim"]) <= 1e-12 * ref[k + "_sim"], k
    assert sched.max_concurrency == ref["max_concurrency"]


# ---------------------------------------------------------------------------
# the serve launcher
# ---------------------------------------------------------------------------


def test_serve_launcher_prints_reference_lines(monkeypatch, capsys):
    from repro.launch import serve as rserve
    from repro_torch.launch import serve as tserve

    argv = ["--requests", "2", "--new-tokens", "6", "--servers", "3"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    rserve.main()
    want = capsys.readouterr().out.splitlines()
    _, _, _, tparams = _bridged()
    got = tserve.run(tserve.parse_args(argv + ["--device", "cpu"]),
                     params=tparams)
    assert len(want) == 3 and got == want
