"""The port's CUDA kernels and its engine on the card.  These need an NVIDIA
GPU and nvcc; elsewhere they skip.  Run them on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX: the GPU machine has none.  Kernels are held
against their plain PyTorch versions: the attention kernels at f32 1e-5,
bf16 2e-2 abs; the scans (K3 WKV6, K4 SSD, f32 only) at atol 1e-4 + rtol
1e-3, the reference's own kernel-vs-oracle tolerance (kernel and plain
version chunk the sequence differently, and the kernels' products run as
3xTF32 on the tensor cores: the same sums, associated differently).  The
engine on the kernels is held against the engine on the plain versions.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (HEAD_DIM_PAIRS, HEAD_DIMS, attention_ref,
                                 decode_attention, decode_attention_ref,
                                 decode_plan, flash_attention, ssd,
                                 ssd_chunked, ssd_plan, wkv6, wkv6_chunked,
                                 wkv6_plan)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rn(gen, *shape, dtype):
    return (torch.randn(*shape, generator=gen, device="cuda") * 0.5).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Kv,Dk,Dv,T,pos,window", [
    (8, 32, 8, 64, 64, 192, [5, 40, 77, 191, 0, 100, 150, 63], None),
    (2, 4, 2, 16, 16, 96, [90, 50], 4),
    (2, 4, 2, 128, 64, 300, [299, 10], 100),
    (2, 4, 2, 16, 16, 65, [64, 64], None),
])
def test_decode_kernel_matches_plain(cuda, dtype, B, H, Kv, Dk, Dv, T, pos,
                                     window):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = _rn(g, B, 1, H, Dk, dtype=dtype)
    k, v = _rn(g, B, T, Kv, Dk, dtype=dtype), _rn(g, B, T, Kv, Dv,
                                                  dtype=dtype)
    p = torch.tensor(pos, device=cuda)
    n = decode_attention.launches
    out = decode_attention(q, k, v, p, window=window)
    assert decode_attention.launches == n + 1
    ref = decode_attention_ref(q, k, v, p, window=window)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Skv,H,Kv,Dk,Dv,window,q_start,causal", [
    (8, 128, 128, 32, 8, 64, 64, None, 0, True),
    (1, 96, 96, 2, 2, 16, 16, 4, 0, True),
    (2, 16, 48, 4, 2, 16, 16, None, 32, True),
    (2, 7, 19, 4, 2, 32, 16, None, 0, False),
    (1, 130, 130, 4, 2, 128, 128, None, 0, True),
])
def test_flash_kernel_matches_plain(cuda, dtype, B, S, Skv, H, Kv, Dk, Dv,
                                    window, q_start, causal):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = _rn(g, B, S, H, Dk, dtype=dtype)
    k, v = _rn(g, B, Skv, Kv, Dk, dtype=dtype), _rn(g, B, Skv, Kv, Dv,
                                                    dtype=dtype)
    kw = dict(causal=causal, window=window, q_start=q_start)
    out = flash_attention(q, k, v, **kw)
    ref = attention_ref(q, k, v, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_224_kernels_match_plain(cuda, dtype):
    """zamba2's shared attention: K2 at Dk = Dv = 224 (189,440 bytes of
    shared memory, opted in) and K1 at D = 224 with G = 1."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = _rn(g, 2, 70, 4, 224, dtype=dtype)
    k, v = _rn(g, 2, 70, 4, 224, dtype=dtype), _rn(g, 2, 70, 4, 224,
                                                   dtype=dtype)
    n = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == n + 1
    err = (out.float() - attention_ref(q, k, v).float()).abs().max().item()
    assert err <= TOL[dtype]
    qd = _rn(g, 3, 1, 4, 224, dtype=dtype)
    ck, cv = _rn(g, 3, 90, 4, 224, dtype=dtype), _rn(g, 3, 90, 4, 224,
                                                     dtype=dtype)
    p = torch.tensor([89, 0, 41], device=cuda)
    out = decode_attention(qd, ck, cv, p)
    ref = decode_attention_ref(qd, ck, cv, p)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


# K1 split-KV cases: (B, H, Kv, Dk, Dv, T, pos, window, kv_len, causal)
SPLIT_CASES = {
    # a long cache, rows at the split and tile edges
    "long": (5, 32, 8, 64, 64, 4096, [0, 63, 64, 2047, 4095], None, None,
             True),
    # a window that crosses split boundaries (32 splits of 128 positions)
    "window": (2, 32, 8, 64, 64, 4096, [3000, 1100], 1500, None, True),
    # kv_len leaves most splits empty; one row fully masked (kv_len 0)
    "kv_len": (3, 8, 4, 64, 64, 4096, [0, 0, 0], None, [100, 5, 0], False),
    # row 0: its window [251, 300] lies beyond kv_len 200, no reachable key
    "masked": (2, 8, 2, 64, 64, 512, [300, 40], 50, [200, 512], True),
    # zamba2's shared attention: G = 1 at D = 224
    "d224": (2, 4, 4, 224, 224, 1024, [1023, 517], None, None, True),
    # B * Kv >= 264: one split, no combine pass
    "one_split": (33, 16, 8, 64, 64, 100, list(range(0, 99, 3)), None, None,
                  True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_decode_split_kv_matches_plain(cuda, dtype, case):
    B, H, Kv, Dk, Dv, T, pos, window, kv_len, causal = SPLIT_CASES[case]
    n_split = decode_plan(B, Kv, T, Dk, Dv, torch.tensor([], dtype=dtype)
                          .element_size())[1]
    assert (n_split == 1) == (case == "one_split"), n_split
    g = torch.Generator(device=cuda).manual_seed(5)
    q = _rn(g, B, 1, H, Dk, dtype=dtype)
    k, v = _rn(g, B, T, Kv, Dk, dtype=dtype), _rn(g, B, T, Kv, Dv,
                                                  dtype=dtype)
    kw = dict(window=window, causal=causal,
              kv_len=None if kv_len is None else torch.tensor(kv_len,
                                                              device=cuda))
    p = torch.tensor(pos, device=cuda)
    out = decode_attention(q, k, v, p, **kw)
    ref = decode_attention_ref(q, k, v, p, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    if kv_len is not None and 0 in kv_len:
        assert (out[kv_len.index(0)] == 0).all()
    if case == "masked":
        assert (out[0] == 0).all()
    # deterministic: the combine pass sums the splits in a fixed order
    assert torch.equal(out, decode_attention(q, k, v, p, **kw))


PAIRS = [(a, b) for a in HEAD_DIMS for b in HEAD_DIMS] + list(HEAD_DIM_PAIRS)


@pytest.mark.parametrize("Dk,Dv", PAIRS)
def test_flash_tensor_core_every_head_dim_pair(cuda, Dk, Dv):
    """bf16 K2 (tensor cores) at every instantiated (Dk, Dv), S = 70 (not a
    multiple of the 64-row tile), GQA 4 over 2."""
    g = torch.Generator(device=cuda).manual_seed(6)
    dt = torch.bfloat16
    q = _rn(g, 2, 70, 4, Dk, dtype=dt)
    k, v = _rn(g, 2, 70, 2, Dk, dtype=dt), _rn(g, 2, 70, 2, Dv, dtype=dt)
    n = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == n + 1
    err = (out.float() - attention_ref(q, k, v).float()).abs().max().item()
    assert err <= TOL[dt]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Skv,H,Kv,Dk,Dv,window,q_start,causal,alibi", [
    (1, 70, 200, 4, 1, 64, 128, 50, 130, True, True),  # chunk, window, ALiBi
    (2, 100, 300, 4, 2, 64, 64, None, 0, False, False),  # non-causal
    (1, 200, 200, 8, 2, 128, 128, 70, 0, True, True),
])
def test_flash_masking_features(cuda, dtype, B, S, Skv, H, Kv, Dk, Dv, window,
                                q_start, causal, alibi):
    g = torch.Generator(device=cuda).manual_seed(7)
    q = _rn(g, B, S, H, Dk, dtype=dtype)
    k, v = _rn(g, B, Skv, Kv, Dk, dtype=dtype), _rn(g, B, Skv, Kv, Dv,
                                                    dtype=dtype)
    sl = torch.linspace(0.05, 0.5, H, device=cuda) if alibi else None
    kw = dict(causal=causal, window=window, q_start=q_start, slopes=sl)
    out = flash_attention(q, k, v, **kw)
    ref = attention_ref(q, k, v, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_misaligned_bf16_view_raises(cuda):
    """The 16-byte copies need aligned rows: a view one element off raises
    ValueError instead of reading across rows."""
    wide = torch.zeros((2, 64, 2, 72), dtype=torch.bfloat16, device=cuda)
    off = wide[..., 1:65]
    q = torch.zeros((2, 1, 4, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        decode_attention(q, off, off, torch.tensor([3, 5], device=cuda))
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(off, off, off)


def _strided(g, *shape, fn=lambda x: x):
    """f32 operand ``fn(randn)`` in the model layout, read through non-unit
    strides: a slice of a wider buffer, as the kernels must take."""
    wide = fn(torch.randn(*shape[:-1], shape[-1] + 8, generator=g,
                          device="cuda"))
    return wide[..., 4:4 + shape[-1]]


def _scan_close(a, b):
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("B,S,H,hd,with_state", [
    (2, 37, 3, 64, False),   # S not a multiple of any chunk
    (1, 1, 2, 16, True),     # one token, carried state
    (2, 130, 4, 32, True),
    (1, 70, 2, 128, False),
    # the chunk edges at the kernel's Q = 64: Q - 1, Q, Q + 1, 4Q + 3
    (2, 63, 3, 64, True),
    (2, 64, 3, 64, False),
    (2, 65, 2, 32, True),
    (1, 259, 2, 64, True),
    (1, 259, 2, 16, False),
    # a (row, head) pair per SM or more: each block walks its chunks
    (5, 130, 64, 64, True),
    (3, 200, 96, 32, False),
])
def test_wkv6_kernel_matches_plain(cuda, B, S, H, hd, with_state):
    g = torch.Generator(device=cuda).manual_seed(3)
    r, k, v = (_strided(g, B, S, H, hd, fn=lambda x: x * 0.4)
               for _ in range(3))
    lw = _strided(g, B, S, H, hd, fn=lambda x: torch.clamp(
        -torch.exp(x * 0.5 - 1), -5.0, -1e-4))
    u = torch.randn(H, hd, generator=g, device=cuda) * 0.3
    s0 = (torch.randn(B, H, hd, hd, generator=g, device=cuda) * 0.3
          if with_state else None)
    n = wkv6.launches
    out, st = wkv6(r, k, v, lw, u, s0)
    assert wkv6.launches == n + 1
    ref, ref_st = wkv6_chunked(r, k, v, lw, u, s0)
    _scan_close(out, ref)
    _scan_close(st, ref_st)
    # deterministic: no atomics, partial sums merged in a fixed order
    out2, st2 = wkv6(r, k, v, lw, u, s0)
    assert torch.equal(out, out2) and torch.equal(st, st2)
    # trailing zero tokens leave the carried state unchanged
    z = torch.zeros(B, 5, H, hd, device=cuda)
    _, st_pad = wkv6(*(torch.cat([x, z], 1) for x in (r, k, v, lw)), u, s0)
    _scan_close(st_pad, st)


@pytest.mark.parametrize("B,S,H,p,n,with_state", [
    (2, 45, 3, 64, 64, False),
    (1, 1, 2, 16, 16, True),
    (2, 300, 4, 64, 32, True),  # more than one plain chunk of 256
    (1, 20, 2, 32, 128, False),
    # the chunk edges at the kernel's Q = 128: Q - 1, Q, Q + 1, 4Q + 3
    (2, 127, 3, 64, 64, True),
    (2, 128, 5, 64, 64, False),
    (2, 129, 3, 32, 128, True),
    (1, 515, 3, 64, 64, True),
    (1, 515, 18, 16, 16, False),
    # 3 heads a block on 132 SMs (ssd_plan), the last block holding 1
    (2, 129, 67, 16, 16, True),
])
def test_ssd_kernel_matches_plain(cuda, B, S, H, p, n, with_state):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = _strided(g, B, S, H, p, fn=lambda t: t * 0.4)
    bm = _strided(g, B, S, n, fn=lambda t: t * 0.4)
    cm = _strided(g, B, S, n, fn=lambda t: t * 0.4)
    dt = torch.rand(B, S, H, generator=g, device=cuda) * 0.5 + 0.1
    A = -torch.rand(H, generator=g, device=cuda) - 0.2
    D = torch.randn(H, generator=g, device=cuda)
    s0 = (torch.randn(B, H, p, n, generator=g, device=cuda) * 0.3
          if with_state else None)
    launches = ssd.launches
    y, st = ssd(x, bm, cm, dt, A, D, s0)
    assert ssd.launches == launches + 1
    ref, ref_st = ssd_chunked(x, bm, cm, dt, A, D, s0)
    _scan_close(y, ref)
    _scan_close(st, ref_st)
    # deterministic: no atomics, partial sums merged in a fixed order
    y2, st2 = ssd(x, bm, cm, dt, A, D, s0)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    _, st_pad = ssd(torch.cat([x, torch.zeros_like(x[:, :7])], 1),
                    torch.cat([bm, torch.zeros_like(bm[:, :7])], 1),
                    torch.cat([cm, torch.zeros_like(cm[:, :7])], 1),
                    torch.cat([dt, torch.zeros_like(dt[:, :7])], 1), A, D,
                    s0)
    _scan_close(st_pad, st)


@pytest.mark.parametrize("S,with_state", [(40, False), (64, True),
                                          (200, True)])
def test_wkv6_kernel_deep_decay(cuda, S, with_state):
    """K3 with lw down to -60 on some channels and -1e-4 on others: the
    sub-block factors stay <= 1, so the output is finite and within the
    tolerance of the plain version and of the float64 recurrence."""
    from repro_torch.kernels import wkv6_recurrence

    B, H, hd = 2, 3, 64
    g = torch.Generator(device=cuda).manual_seed(8)
    r, k, v = (_strided(g, B, S, H, hd, fn=lambda x: x * 0.4)
               for _ in range(3))
    lw = _strided(g, B, S, H, hd, fn=lambda x: -60.0 * torch.rand(
        x.shape, generator=g, device=cuda))
    lw[..., :8] = -60.0
    lw[..., 8:16] = -1e-4
    u = torch.randn(H, hd, generator=g, device=cuda) * 0.3
    s0 = (torch.randn(B, H, hd, hd, generator=g, device=cuda) * 0.3
          if with_state else None)
    out, st = wkv6(r, k, v, lw, u, s0)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(st).all())
    ref, ref_st = wkv6_chunked(r, k, v, lw, u, s0)
    _scan_close(out, ref)
    _scan_close(st, ref_st)
    lo, lst = wkv6_recurrence(r, k, v, lw, u, s0)
    _scan_close(out, lo)
    _scan_close(st, lst)


def test_scan_misaligned_view_raises(cuda):
    """The scans copy rows 16 bytes at a time: a view one element off
    raises ValueError instead of reading across rows."""
    wide = torch.zeros((2, 20, 3, 65), device=cuda)
    off = wide[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        wkv6(off, off, off, off, torch.zeros(3, 64, device=cuda))
    bc = torch.zeros((2, 20, 65), device=cuda)[..., 1:]
    dt = torch.ones(2, 20, 3, device=cuda)
    a = -torch.ones(3, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        ssd(off, bc, bc, dt, a, a)


def test_scan_plans_count_launches(cuda):
    """The counter counts calls; a call takes one launch for a single
    chunk or a walk over the chunks, three (local, carry, output) for
    parallel chunks."""
    for S in (1, 64, 65, 300):
        for rows in (1, 5):  # 128 or 640 (row, head) pairs
            plan = wkv6_plan(rows, S, 128, 64)
            n = wkv6.launches
            zeros = torch.zeros(rows, S, 128, 64, device=cuda)
            out, st = wkv6(zeros, zeros, zeros, zeros,
                           torch.zeros(128, 64, device=cuda))
            assert wkv6.launches == n + 1
            assert not bool(out.any()) and not bool(st.any())
            assert plan.launches == (1 if plan.walk else 3)
            assert plan.walk == (S <= plan.chunk or rows == 5)
    for S in (1, 128, 129):
        plan = ssd_plan(1, S, 2, 64, 64)
        assert plan.launches == (1 if S <= plan.chunk else 3)


def test_unsupported_head_dim_raises(cuda):
    q = torch.zeros((1, 4, 2, 48), device=cuda)
    with pytest.raises(NotImplementedError, match="head dims"):
        flash_attention(q, q, q)


# the kernels each reduced stack's serving path launches
PATH_KERNELS = {"llama3_2_1b": (decode_attention, flash_attention),
                "rwkv6_7b": (wkv6,),
                "zamba2_7b": (ssd, decode_attention, flash_attention)}


@pytest.mark.parametrize("arch", list(PATH_KERNELS))
def test_engine_kernel_equals_plain_backend(cuda, arch):
    """A reduced stack served on the card: the kernel backend gives the
    plain backend's greedy streams, and every kernel of its path ran."""
    import repro_torch.core as C
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import init_params
    from repro_torch.serving import (ContinuousBatchingScheduler,
                                     GeoServingSystem)

    cfg = get_reduced_config(arch)
    if arch == "llama3_2_1b":
        cfg = cfg.replace(n_layers=8)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    L = cfg.n_layers
    llm = C.LLMSpec("t", L, block_bytes=50.0, cache_bytes_per_token=0.5)
    servers = [C.ServerSpec(j, m, t) for j, (m, t) in enumerate(
        [(500.0, 0.004), (500.0, 0.004), (220.0, 0.02), (220.0, 0.02)])]
    rtt = np.array([[0.01, 0.01, 0.03, 0.03]])
    prob = C.Problem(llm, servers, 1, rtt, 3 * rtt, workload=C.Workload(8, 16))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(2, cfg.vocab_size, n) for n in (8, 13, 5, 8)]
    streams = {}
    for backend in ("kernel", "plain"):
        system = GeoServingSystem(cfg, params, prob, R=4, max_new_tokens=16,
                                  backend=backend)
        sched = ContinuousBatchingScheduler(system, R=4)
        for rid, p in enumerate(prompts):
            sched.submit(rid, p, 0.1 * rid, n_new=10)
        before = [k.launches for k in PATH_KERNELS[arch]]
        streams[backend] = [list(s.tokens) for s in sched.run()]
        ran = [k.launches - b for k, b in zip(PATH_KERNELS[arch], before)]
        assert (min(ran) > 0) == (backend == "kernel"), ran
    assert streams["kernel"] == streams["plain"]
