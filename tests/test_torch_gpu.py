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

from repro_torch.kernels import (HEAD_DIM_PAIRS, HEAD_DIM_PAIRS_F32,
                                 HEAD_DIMS, attention_ref, decode_attention,
                                 decode_attention_partials,
                                 decode_attention_partials_ref,
                                 decode_attention_ref, decode_plan,
                                 flash_attention, head_group,
                                 merge_partials, merge_partials_ref, ssd,
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


# K1 partials over a group's time shards: (B, H, Dk, Dv, T, shards, pos,
# scale, mla) — DeepSeek-V2's (1, 2) slot (96 of 192 positions a slot,
# absorbed MLA over the joint latent buffer) and reduced Llama-3.2-1B's
# (2, 4) time shard (its 4 query heads over 2 KV heads, 10 of 40
# positions a slot)
PARTIAL_CASES = {
    "mla_slot": (8, 128, 576, 512, 192, 2, [191, 95, 96, 0, 150, 40, 191,
                                            120], 1.0 / 192 ** 0.5, True),
    "gqa_shard": (2, 4, 16, 16, 40, 4, [39, 12], None, False),
    "gqa_window_alibi": (3, 8, 64, 64, 384, 3, [383, 200, 10], None,
                         False),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(PARTIAL_CASES))
def test_decode_partials_and_merge_match_plain(cuda, dtype, case):
    """K1's split kernel alone over each time shard (first key at t0) and
    the combine kernel over the shards' partials in slot order equal the
    plain partials and merge, and the whole-cache plain version; each
    launch is counted."""
    B, H, Dk, Dv, T, n, pos, scale, mla = PARTIAL_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(5)
    q = _rn(g, B, 1, H, Dk, dtype=dtype)
    kw = dict(scale=scale)
    if mla:  # keys: the joint buffer; values: its latent columns
        buf = _rn(g, B, T, Dk, dtype=dtype)
        k, v = buf[:, :, None, :], buf[:, :, None, :Dv]
    else:
        k, v = _rn(g, B, T, 2, Dk, dtype=dtype), _rn(g, B, T, 2, Dv,
                                                     dtype=dtype)
    if case == "gqa_window_alibi":
        kw.update(window=150, slopes=torch.linspace(0.01, 0.3, H,
                                                    device=cuda))
    p = torch.tensor(pos, device=cuda)
    w = T // n
    n0 = (decode_attention_partials.launches, merge_partials.launches)
    parts = [decode_attention_partials(q, k[:, i * w:(i + 1) * w],
                                       v[:, i * w:(i + 1) * w], p,
                                       t0=i * w, **kw) for i in range(n)]
    out = merge_partials(parts, dtype)
    assert decode_attention_partials.launches == n0[0] + n
    assert merge_partials.launches == n0[1] + 1
    from repro_torch.kernels.decode_attention.ops import _plan

    chunk = _plan(q, k[:, :w], v[:, :w])[1][2]
    plain = [decode_attention_partials_ref(
        q, k[:, i * w:(i + 1) * w], v[:, i * w:(i + 1) * w], p, t0=i * w,
        chunk=chunk, **kw) for i in range(n)]
    for got, want in zip(parts, plain):
        assert got[0].shape == want[0].shape
        torch.testing.assert_close(got[0], want[0], atol=TOL[dtype],
                                   rtol=TOL[dtype])
    ref = merge_partials_ref(*(torch.cat([x[i] for x in plain])
                               for i in range(3)), dtype)
    whole = decode_attention_ref(q, k, v, p, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert (out.float() - whole.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("lo,hi", [(0, 2), (2, 4), (1, 3)])
def test_scans_take_head_slice_views(cuda, lo, hi):
    """K3 and K4 on a slot's head slice, as views of the whole operands
    (its heads of u, A, D and of the carried state), equal their plain
    versions on the same views and that slice of the whole call; plans
    come from the smaller H."""
    B, S, H = 2, 150, 4
    g = torch.Generator(device=cuda).manual_seed(9)
    r, k, v = (_strided(g, B, S, H, 64, fn=lambda x: x * 0.4)
               for _ in range(3))
    lw = _strided(g, B, S, H, 64, fn=lambda x: torch.clamp(
        -torch.exp(x * 0.5 - 1), -5.0, -1e-4))
    u = torch.randn(H, 64, generator=g, device=cuda) * 0.3
    s0 = torch.randn(B, H, 64, 64, generator=g, device=cuda) * 0.3
    view = [x[:, :, lo:hi] for x in (r, k, v, lw)]
    n = wkv6.launches
    out, st = wkv6(*view, u[lo:hi], s0[:, lo:hi])
    assert wkv6.launches == n + 1
    ref, ref_st = wkv6_chunked(*view, u[lo:hi], s0[:, lo:hi])
    _scan_close(out, ref)
    _scan_close(st, ref_st)
    full, full_st = wkv6(r, k, v, lw, u, s0)
    _scan_close(out, full[:, :, lo:hi])
    _scan_close(st, full_st[:, lo:hi])
    x = _strided(g, B, S, H, 64, fn=lambda t: t * 0.4)
    bm = _strided(g, B, S, 64, fn=lambda t: t * 0.4)
    cm = _strided(g, B, S, 64, fn=lambda t: t * 0.4)
    dt = torch.rand(B, S, H, generator=g, device=cuda) * 0.5 + 0.1
    A = -torch.rand(H, generator=g, device=cuda) - 0.2
    D = torch.randn(H, generator=g, device=cuda)
    s1 = torch.randn(B, H, 64, 64, generator=g, device=cuda) * 0.3
    args = (x[:, :, lo:hi], bm, cm, dt[:, :, lo:hi], A[lo:hi], D[lo:hi],
            s1[:, lo:hi])
    n = ssd.launches
    y, st = ssd(*args)
    assert ssd.launches == n + 1
    ref, ref_st = ssd_chunked(*args)
    _scan_close(y, ref)
    _scan_close(st, ref_st)
    full, full_st = ssd(x, bm, cm, dt, A, D, s1)
    _scan_close(y, full[:, :, lo:hi])
    _scan_close(st, full_st[:, lo:hi])


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
                "zamba2_7b": (ssd, decode_attention, flash_attention),
                "deepseek_v2_236b": (decode_attention, flash_attention),
                "llama4_scout_17b_a16e": (decode_attention, flash_attention),
                "gemma3_4b": (decode_attention, flash_attention),
                "bloom_176b": (decode_attention, flash_attention),
                "qwen2_5_32b": (decode_attention, flash_attention),
                "olmo_1b": (decode_attention, flash_attention),
                "chameleon_34b": (decode_attention, flash_attention)}


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


def test_upcast_twin_equals_whole_tree_upcast_on_card(cuda):
    """chip_smoke.py's C5 twin on reduced Llama in bf16: casting one
    layer at a time (``upcast_prefill_logits``) gives the logits of
    ``prefill`` on the whole tree cast to f32 up front — bit for bit with
    the LM head cast whole, within 1e-6 of the logit scale with the head
    cast in vocabulary chunks."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import (init_params, prefill,
                                    upcast_prefill_logits)
    from repro_torch.models.model import tree_map

    cfg = get_reduced_config("llama3_2_1b").replace(
        param_dtype="bfloat16", act_dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        2, cfg.vocab_size, (1, 9))).to(cuda)
    batch = {"tokens": tokens}
    whole = prefill(tree_map(lambda x: x.float(), params),
                    cfg.replace(param_dtype="float32", act_dtype="float32"),
                    batch, backend="plain")[0]
    assert torch.equal(upcast_prefill_logits(params, cfg, batch,
                                             vocab_chunk=None), whole)
    chunked = upcast_prefill_logits(params, cfg, batch, vocab_chunk=96)
    assert (chunked - whole).abs().max() <= 1e-6 * whole.abs().max()


def test_page_table_round_trip(cuda):
    """A paged pool on the card: the device page table equals the host
    table after every change (each upload staged through its own pinned
    buffer), a gather/scatter round trip leaves every real page as it
    was, and a decode scatter writes only the page holding ``pos``."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models.layers import NULL
    from repro_torch.serving import CachePool
    from repro_torch.serving.kv_cache import _gather_paged, _scatter_paged

    cfg = get_reduced_config("llama3_2_1b")
    pool = CachePool(cfg, ("decoder", "decoder"), n_rows=4, max_len=16,
                     cap_slots=8, layout="paged", page_size=4, device=cuda)
    tables = []
    for sid, pages in ((0, 2), (1, 3), (2, 1)):
        pool.alloc(sid, 2, n_pages=pages)
        tables.append(pool.page_table())
    pool.grow_pages(0, 4)
    pool.release(1)
    tables.append(pool.page_table())
    torch.cuda.synchronize()
    assert torch.equal(tables[-1].cpu(),
                       torch.from_numpy(pool.pages.table.astype(np.int64)))
    assert tables[0].cpu()[pool.rows[0], :2].tolist() == [1, 2]
    g = torch.Generator(device=cuda).manual_seed(0)
    for key, leaf in pool.tree[0].items():
        leaf.copy_(torch.randn(leaf.shape, generator=g, device=cuda))
    before = {k: v.clone() for k, v in pool.tree[0].items()}
    table = pool.page_table()
    scratch = _gather_paged([NULL], pool.runs, [pool.tree], [table], 4)[0]
    assert scratch[0]["k"].shape == (2, 4, 16, cfg.n_kv_heads, cfg.head_dim)
    assert scratch[0]["k"].is_contiguous()
    _scatter_paged(NULL, pool.runs, pool.tree, scratch, table, 4)
    for key in before:  # every real page unchanged (page 0 is the trash)
        assert torch.equal(pool.tree[0][key][:, 1:], before[key][:, 1:])
    row = pool.rows[0]
    scratch[0]["k"][:, row] += 1.0
    pos = torch.zeros(4, dtype=torch.int64, device=cuda)
    pos[row] = 9  # page index 2 of row 0
    _scatter_paged(NULL, pool.runs, pool.tree, scratch, table, 4, pos)
    changed = (pool.tree[0]["k"] != before["k"]).flatten(2).any(-1).any(0)
    assert changed[1:].nonzero().flatten().tolist() == [
        int(pool.pages.table[row, 2]) - 1]


def test_threefry_bits_cuda_equal_cpu(cuda):
    """Keys, bits and uniforms from the same (seed, index) rows are
    bit-identical on the card and on the CPU."""
    from repro_torch.serving import prng
    from repro_torch.serving.sampling import _key_for_row

    seeds = torch.tensor([0, 1, 2 ** 31, 2 ** 32 - 1]).repeat_interleave(4)
    index = torch.tensor([0, 1, 2 ** 31, 2 ** 32 - 1]).repeat(4)
    keys = [_key_for_row(seeds.to(d), index.to(d)) for d in ("cpu", cuda)]
    assert keys[1].device.type == torch.device(cuda).type
    assert torch.equal(keys[0], keys[1].cpu())
    bits = [prng.random_bits(k, 4099).cpu() for k in keys]
    assert torch.equal(bits[0], bits[1])
    u = [prng.uniform(k, 4099, prng.F32_TINY).cpu() for k in keys]
    assert torch.equal(u[0].view(torch.int32), u[1].view(torch.int32))


@pytest.mark.parametrize("arch", ["llama3_2_1b", "zamba2_7b",
                                  "deepseek_v2_236b"])
def test_engine_paged_equals_slab(cuda, arch):
    """A reduced stack on the card under the paged layout, with a session
    preempted mid-decode and resumed: the slab layout's streams, sampled
    sessions included, and the kernels of the path ran."""
    import repro_torch.core as C
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import init_params
    from repro_torch.serving import GeoServingSystem, SamplingSpec

    cfg = get_reduced_config(arch)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    llm = C.LLMSpec("t", cfg.n_layers, block_bytes=100.0,
                    cache_bytes_per_token=1.0)
    servers = [C.ServerSpec(j, 2000.0, 0.01 * (j + 1)) for j in range(2)]
    rtt = np.full((1, 2), 0.02)
    prob = C.Problem(llm, servers, 1, rtt, 3 * rtt, workload=C.Workload(4, 4))
    rng = np.random.RandomState(1)
    prompts = [rng.randint(2, cfg.vocab_size, n) for n in (4, 6, 4)]
    specs = [SamplingSpec(), SamplingSpec("temperature", temperature=3.0,
                                          seed=5),
             SamplingSpec("top_k", temperature=2.0, top_k=4, seed=2 ** 32 - 1)]
    streams = {}
    for layout in ("slab", "paged"):
        system = GeoServingSystem(cfg, params, prob, R=2, max_new_tokens=4,
                                  max_sessions=4, cache_layout=layout,
                                  page_size=2)
        route, _ = C.shortest_path_route(system.problem,
                                         system.alive_placement(), 0)
        sids = [system.create_session(p, 0, route, 4, sampling=s)
                for p, s in zip(prompts, specs)]
        before = [k.launches for k in PATH_KERNELS[arch]]
        assert system.try_admit_sessions(sids) == sids
        system.drain_prefill()
        system.decode_round(sids)
        if layout == "paged":
            system.preempt_session(sids[0])
        while any(system.sessions[s].n_generated < 4 for s in sids):
            system.decode_round()
        assert min(k.launches - b for k, b in
                   zip(PATH_KERNELS[arch], before)) > 0
        streams[layout] = [list(system.sessions[s].tokens) for s in sids]
        if layout == "paged":
            assert system.round_stats["resumes"] == 1
    assert streams["paged"] == streams["slab"]


# ---------------------------------------------------------------------------
# The MLA and gemma3 shapes: K1 head groups, K2's new pairs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,H,lora,rope,T,pos", [
    (torch.bfloat16, 128, 512, 64, 300, [299, 17, 128]),  # full width
    (torch.float32, 4, 32, 8, 70, [69, 0, 33]),           # reduced
])
def test_decode_mla_joint_cache(cuda, dtype, H, lora, rope, T, pos):
    """Absorbed MLA decode as the model calls it: one kv head, the joint
    (B, T, lora + rope) cache as the keys and its latent columns as the
    values (strided views), the faithful scale; G = 128 runs as 32 groups
    of 4 heads.  Deterministic across calls."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B = len(pos)
    q = _rn(g, B, 1, H, lora + rope, dtype=dtype)
    buf = _rn(g, B, T, lora + rope, dtype=dtype)
    keys, values = buf[:, :, None, :], buf[:, :, None, :lora]
    p = torch.tensor(pos, device=cuda)
    scale = 1.0 / np.sqrt(128 + rope)
    n = decode_attention.launches
    out = decode_attention(q, keys, values, p, scale=scale)
    assert decode_attention.launches == n + 1
    ref = decode_attention_ref(q, keys, values, p, scale=scale)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert torch.equal(out, decode_attention(q, keys, values, p,
                                             scale=scale))
    assert head_group(H, lora) == min(H, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_d256_window_beyond_1024(cuda, dtype):
    """gemma3's local layers: head dim 256, window 1024, positions past
    it (and a global layer's row without a window)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    B, H, Kv, D, T = 3, 8, 4, 256, 1344
    q = _rn(g, B, 1, H, D, dtype=dtype)
    k, v = _rn(g, B, T, Kv, D, dtype=dtype), _rn(g, B, T, Kv, D, dtype=dtype)
    p = torch.tensor([1300, 1343, 600], device=cuda)
    for window in (1024, None):
        out = decode_attention(q, k, v, p, window=window)
        ref = decode_attention_ref(q, k, v, p, window=window)
        assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("case", ["d256_window_chunk", "mla_192_128",
                                  "mla_reduced_f32"])
def test_flash_new_pairs(cuda, case):
    """K2 at the new shapes: gemma3's 256 with window 1024 on a chunk at
    q_start 1024; MLA's (192, 128) with Kv = H in bf16; the reduced MLA
    (24, 16) in f32."""
    dtype, B, S, Skv, H, Kv, Dk, Dv, window, q_start = {
        "d256_window_chunk": (torch.bfloat16, 1, 320, 1344, 8, 4, 256, 256,
                              1024, 1024),
        "mla_192_128": (torch.bfloat16, 2, 100, 100, 8, 8, 192, 128, None,
                        0),
        "mla_reduced_f32": (torch.float32, 2, 37, 37, 4, 4, 24, 16, None,
                            0),
    }[case]
    g = torch.Generator(device=cuda).manual_seed(9)
    q = _rn(g, B, S, H, Dk, dtype=dtype)
    k, v = _rn(g, B, Skv, Kv, Dk, dtype=dtype), _rn(g, B, Skv, Kv, Dv,
                                                    dtype=dtype)
    kw = dict(window=window, q_start=q_start)
    n = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == n + 1
    err = (out.float() - attention_ref(q, k, v, **kw).float()).abs().max()
    assert err.item() <= TOL[dtype]


@pytest.mark.parametrize("Dk,Dv", HEAD_DIM_PAIRS_F32)
def test_flash_f32_pairs(cuda, Dk, Dv):
    g = torch.Generator(device=cuda).manual_seed(10)
    q = _rn(g, 2, 70, 4, Dk, dtype=torch.float32)
    k = _rn(g, 2, 70, 2, Dk, dtype=torch.float32)
    v = _rn(g, 2, 70, 2, Dv, dtype=torch.float32)
    err = (flash_attention(q, k, v) - attention_ref(q, k, v)).abs().max()
    assert err.item() <= TOL[torch.float32]


# ---------------------------------------------------------------------------
# Encoder-decoder shapes: K2 non-causal (encoder, cross prefill), K1
# non-causal with a per-row kv_len (cross decode), the seamless engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Sq,Skv", [(1000, 1000), (8, 1000), (16, 256),
                                    (13, 77)])
def test_flash_noncausal_ragged(cuda, Sq, Skv):
    """bf16 K2 without a causal mask at ragged (Sq, Skv), head dim 64, Kv =
    H: the last key tile masks keys >= Skv (the keys and queries are views
    of longer buffers whose tails hold garbage)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = _rn(g, 2, Sq + 64, 16, 64, dtype=torch.bfloat16)
    k = _rn(g, 2, Skv + 64, 16, 64, dtype=torch.bfloat16)
    v = _rn(g, 2, Skv + 64, 16, 64, dtype=torch.bfloat16)
    k[:, Skv:], v[:, Skv:] = 40.0, -40.0
    q, k, v = q[:, :Sq], k[:, :Skv], v[:, :Skv]
    out = flash_attention(q, k, v, causal=False)
    ref = attention_ref(q, k, v, causal=False)
    assert out.shape == (2, Sq, 16, 64)
    assert (out.float() - ref.float()).abs().max().item() \
        <= TOL[torch.bfloat16]


def test_decode_cross_kv_len_g1(cuda):
    """bf16 K1 cross decode at G = 1 over a cache of T = 1024 (the pool's
    max_enc_len) with per-row kv_len 1, 256, 1000 and 1024: keys at or past
    kv_len count for nothing (they hold garbage here), and pos is ignored."""
    g = torch.Generator(device=cuda).manual_seed(4)
    B, T = 4, 1024
    q = _rn(g, B, 1, 16, 64, dtype=torch.bfloat16)
    k = _rn(g, B, T, 16, 64, dtype=torch.bfloat16)
    v = _rn(g, B, T, 16, 64, dtype=torch.bfloat16)
    kv_len = torch.tensor([1, 256, 1000, 1024], device=cuda)
    pos = torch.tensor([3, 0, 17, 5], device=cuda)
    out = decode_attention(q, k, v, pos, kv_len=kv_len, causal=False)
    ref = decode_attention_ref(q, k, v, pos, kv_len=kv_len, causal=False)
    assert (out.float() - ref.float()).abs().max().item() \
        <= TOL[torch.bfloat16]
    for b, n in enumerate(kv_len.tolist()):
        k[b, n:], v[b, n:] = 50.0, -50.0
    again = decode_attention(q, k, v, pos + 7, kv_len=kv_len, causal=False)
    assert torch.equal(again, out)


def _encdec_system(cuda, layout, backend="kernel"):
    import repro_torch.core as C
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import init_params
    from repro_torch.serving import GeoServingSystem

    cfg = get_reduced_config("seamless_m4t_large_v2")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    llm = C.LLMSpec("t", cfg.n_layers, block_bytes=100.0,
                    cache_bytes_per_token=1.0)
    servers = [C.ServerSpec(j, 300.0, 0.01 * (j + 1)) for j in range(6)]
    rtt = np.full((1, 6), 0.02)
    prob = C.Problem(llm, servers, 1, rtt, 3 * rtt, workload=C.Workload(4, 6))
    return cfg, GeoServingSystem(cfg, params, prob, R=2, max_new_tokens=6,
                                 max_sessions=4, max_seq_len=16,
                                 max_enc_len=32, cache_layout=layout,
                                 page_size=2, backend=backend, device=cuda)


def test_encdec_engine_paged_equals_slab(cuda):
    """The reduced seamless engine on the card, with encoder lengths that
    group apart and a session preempted mid-decode (paged): the paged
    streams equal the slab ones and the kernel backend's equal the plain
    backend's; K2 ran non-causal and K1 ran cross decode."""
    import repro_torch.core as C

    rng = np.random.RandomState(2)
    jobs = [(rng.randint(2, 256, n), rng.randn(e, 24).astype(np.float32))
            for n, e in ((4, 9), (6, 21), (5, 9))]
    streams = {}
    for layout, backend in (("slab", "kernel"), ("paged", "kernel"),
                            ("slab", "plain")):
        cfg, system = _encdec_system(cuda, layout, backend)
        sids = []
        for p, f in jobs:
            route, _ = C.shortest_path_route(system.problem,
                                             system.alive_placement(), 0)
            sids.append(system.create_session(p, 0, route, 6, frames=f))
        n1, n2 = decode_attention.launches, flash_attention.launches
        assert system.try_admit_sessions(sids) == sids
        system.drain_prefill()
        system.decode_round(sids)
        if layout == "paged":
            system.preempt_session(sids[1])
        while any(system.sessions[s].n_generated < 6 for s in sids):
            system.decode_round()
        ran = (decode_attention.launches - n1, flash_attention.launches - n2)
        assert (min(ran) > 0) == (backend == "kernel"), ran
        streams[(layout, backend)] = [list(system.sessions[s].tokens)
                                      for s in sids]
    assert streams[("paged", "kernel")] == streams[("slab", "kernel")] == \
        streams[("slab", "plain")]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shortest_paths_on_card_equal_numpy_dp(cuda, seed):
    """The batched min-plus DP on the card: the numpy DP's terminal servers
    and costs (float64 on both sides: equal to 1e-12 relative), with and
    without WS-RR waiting."""
    import repro_torch.core as C

    rng = np.random.default_rng(seed)
    n, L = 5, 5
    llm = C.LLMSpec("t", L, block_bytes=4.0, cache_bytes_per_token=0.25)
    servers = [C.ServerSpec(j, float(4 * rng.integers(3, 7)),
                            float(0.05 + 0.3 * rng.random()))
               for j in range(n)]
    rtt = 0.02 + 0.3 * rng.random((3, n))
    prob = C.Problem(llm, servers, 3, rtt, 4 * rtt, workload=C.Workload(2, 4))
    pl, info = C.cg_bp(prob, 2)
    assert info.feasible
    for wait, lw in ((None, 1.0), (0.05 * rng.random((n + 1, n)), 4.0)):
        dist, choice = C.torch_shortest_paths(prob, pl, waiting=wait,
                                              l_max_weight=lw)
        assert dist.is_cuda and choice.is_cuda
        for c in range(prob.n_clients):
            route, cost = C.shortest_path_route(prob, pl, c, waiting=wait,
                                                l_max_weight=lw)
            assert int(choice[c]) == route.servers[-1]
            assert abs(float(dist[c]) - cost) <= 1e-12 * cost


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_step_count_cuda_equals_cpu(cuda, layout):
    """``decode_step_cost`` of a reduced f32 system on the card equals the
    CPU's, server for server (the count runs on meta tensors wherever the
    server lives), and it launches no kernel."""
    import repro_torch.core as C
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import init_params
    from repro_torch.serving import GeoServingSystem

    cfg = get_reduced_config("llama3_2_1b").replace(n_layers=8)
    llm = C.LLMSpec("t", 8, block_bytes=50.0, cache_bytes_per_token=0.5)
    servers = [C.ServerSpec(j, m, t) for j, (m, t) in enumerate(
        [(500.0, 0.004), (500.0, 0.004), (220.0, 0.02), (220.0, 0.02)])]
    rtt = np.array([[0.01, 0.01, 0.03, 0.03]])
    prob = C.Problem(llm, servers, 1, rtt, 3 * rtt, workload=C.Workload(8, 16))
    counts = {}
    for dev in ("cuda", "cpu"):
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
        system = GeoServingSystem(cfg, params, prob, R=4, max_new_tokens=16,
                                  cache_layout=layout, device=dev)
        before = decode_attention.launches
        counts[dev] = {j: srv.decode_step_cost().to_dict()
                       for j, srv in system.servers.items()}
        assert decode_attention.launches == before
        taus = system.calibrate_taus()
        assert all(np.isfinite(t) and t > 0 for t in taus.values())
    assert counts["cuda"] == counts["cpu"]


def _grad_calls():
    """K1-K4 wrapper calls on CUDA tensors made by ``t(*shape)``."""
    return {
        "decode_attention": lambda t: decode_attention(
            t(2, 1, 4, 16), t(2, 8, 2, 16), t(2, 8, 2, 16), 3),
        "flash_attention": lambda t: flash_attention(
            t(2, 8, 4, 16), t(2, 8, 2, 16), t(2, 8, 2, 16)),
        "wkv6": lambda t: wkv6(t(2, 8, 2, 64), t(2, 8, 2, 64),
                               t(2, 8, 2, 64), -t(2, 8, 2, 64).abs(),
                               t(2, 64)),
        "ssd": lambda t: ssd(t(2, 8, 2, 64), t(2, 8, 64), t(2, 8, 64),
                             t(2, 8, 2).abs(), -t(2).abs(), t(2)),
    }


@pytest.mark.parametrize("name", ["decode_attention", "flash_attention",
                                  "wkv6", "ssd"])
def test_kernel_refuses_grad_on_card(cuda, name):
    """A kernel has no backward: under autograd, on CUDA inputs that
    require grad, its wrapper raises and launches nothing; the same call
    under no_grad launches the kernel."""
    import repro_torch.kernels as K

    g = torch.Generator(device=cuda).manual_seed(0)
    call, fn = _grad_calls()[name], getattr(K, name)

    def needs_grad(*shape):
        return torch.randn(shape, generator=g,
                           device=cuda).requires_grad_(True)

    before = fn.launches
    with pytest.raises(RuntimeError, match="no backward"):
        call(needs_grad)
    assert fn.launches == before
    with torch.no_grad():
        call(needs_grad)
    assert fn.launches == before + 1


@pytest.mark.parametrize("arch", ["deepseek_v2_236b",
                                  "llama4_scout_17b_a16e", "qwen2_5_32b",
                                  "gemma3_4b", "llama3_2_1b", "olmo_1b",
                                  "chameleon_34b", "seamless_m4t_large_v2",
                                  "zamba2_7b", "rwkv6_7b"])
def test_train_step_on_card_equals_cpu(cuda, arch):
    """One reduced f32 train step (TF32 off) on the card against the same
    step on the CPU: the loss at rtol 1e-5; each gradient leaf at max|d|
    <= atol + rtol max|cpu| (1e-5, 2e-4; zamba2 1e-4, 5e-3: ROADMAP C2,
    its f32 gradients sit up to 1.9e-3 of a leaf's scale off a float64
    evaluation, scripts/f64_grads.py); the params at atol 5e-5 (zamba2
    1e-4) plus 1.1x the difference AdamW's first update, lr g / (|g| +
    1e-8), makes of the two gradients (where |g| nears eps it turns f32
    noise of the gradient into up to 2 lr)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.data import make_batches, shard_batch
    from repro_torch.models import init_params, train_loss
    from repro_torch.models.model import tree_map
    from repro_torch.training import (TrainHParams, init_train_state,
                                      make_optimizer_for, make_train_step)
    from repro_torch.training.optimizer import tree_leaves

    cfg = get_reduced_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    host = next(make_batches(cfg, 2, 32, seed=0))
    hp = TrainHParams(learning_rate=5e-3)
    out = {}
    for dev in ("cpu", "cuda"):
        batch = shard_batch(host, device=dev)
        live = tree_map(lambda x: x.to(dev, copy=True).requires_grad_(True),
                        params)
        loss, _ = train_loss(live, cfg, batch)
        grads = [g.cpu() for g in torch.autograd.grad(
            loss, tree_leaves(live), allow_unused=True,
            materialize_grads=True)]
        opt = make_optimizer_for(cfg, hp)
        state = init_train_state(None, cfg, opt, device=dev, params=tree_map(
            lambda x: x.to(dev, copy=True), params))
        state, metrics = make_train_step(cfg, opt, hp)(state, batch)
        norm = float(torch.sqrt(sum((g * g).sum() for g in grads)))
        first = [hp.learning_rate * gc / (gc.abs() + 1e-8) for gc in
                 (g * min(1.0, 1.0 / norm) for g in grads)]
        out[dev] = (float(metrics["loss"]), grads,
                    [x.cpu() for x in tree_leaves(state["params"])], first)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    g_atol, g_rtol = (1e-4, 5e-3) if arch == "zamba2_7b" else (1e-5, 2e-4)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        if b.numel():
            assert float((a - b).abs().max()) <= \
                g_atol + g_rtol * float(b.abs().max())
    atol = 1e-4 if arch == "zamba2_7b" else 5e-5
    for a, b, ua, ub in zip(out["cuda"][2], out["cpu"][2], out["cuda"][3],
                            out["cpu"][3]):
        d = (a - b).abs()
        bound = atol + (1.1 * (ua - ub).abs() if cfg.optimizer == "adamw"
                        else 0.0)
        bad = d > bound
        assert not bool(bad.any()), (float(d.max()), d[bad][:4].tolist())


# ---------------------------------------------------------------------------
# Device-group servers on the card (the slots share the card)
# ---------------------------------------------------------------------------


def _group_problem(C, L, n_servers, mem=1000.0):
    llm = C.LLMSpec("t", L, block_bytes=100.0, cache_bytes_per_token=1.0)
    servers = [C.ServerSpec(j, mem, 0.01 * (j + 1), 0.002, 0.0005)
               for j in range(n_servers)]
    rtt = np.full((1, n_servers), 0.02)
    return C.Problem(llm, servers, 1, rtt, 3 * rtt, workload=C.Workload(4, 4))


def _group_drive(system, C, lengths=(4, 6, 5), n_new=4):
    rng = np.random.RandomState(0)
    sids = []
    for n in lengths:
        route, _ = C.shortest_path_route(system.problem,
                                         system.alive_placement(), 0)
        prompt = rng.randint(2, system.cfg.vocab_size, n)
        kw = {} if not system.cfg.is_enc_dec else {"frames": rng.randn(
            n + 3, system.cfg.frame_dim).astype(np.float32)}
        sids.append(system.create_session(prompt, 0, route, n_new, **kw))
    assert system.try_admit_sessions(sids) == sids
    system.drain_prefill()
    hist = [[system.sessions[s].last_logits.clone() for s in sids]]
    while any(system.sessions[s].n_generated < n_new for s in sids):
        system.decode_round()
        hist.append([system.sessions[s].last_logits.clone() for s in sids])
    return ([list(system.sessions[s].tokens) for s in sids],
            [system.sessions[s].virtual_time for s in sids], hist,
            dict(system.round_stats))


# the kernels each reduced stack's group runs (K1 as partials + merge on
# time-sharded slab slots; the paged steps gather whole pages and run K1)
GROUP_KERNELS = {
    "llama3_2_1b": ("decode_attention_partials", "merge_partials",
                    "flash_attention"),
    "deepseek_v2_236b": ("decode_attention_partials", "merge_partials",
                         "flash_attention"),
    "llama4_scout_17b_a16e": ("decode_attention", "flash_attention"),
    "rwkv6_7b": ("wkv6",),
    "zamba2_7b": ("ssd", "decode_attention", "flash_attention"),
    "seamless_m4t_large_v2": ("decode_attention", "flash_attention"),
}


@pytest.mark.parametrize("layout", ["slab", "paged"])
@pytest.mark.parametrize("mode", ["fused", "serial"])
@pytest.mark.parametrize("arch,shape", [("llama3_2_1b", (2, 4)),
                                        ("deepseek_v2_236b", (2, 4)),
                                        ("llama4_scout_17b_a16e", (4, 2)),
                                        ("rwkv6_7b", (2, 4)),
                                        ("zamba2_7b", (2, 4)),
                                        ("seamless_m4t_large_v2", (2, 4))])
def test_group_equals_solo_on_card(cuda, arch, shape, mode, layout):
    """``chip_smoke.py`` [groups] (b): a reduced f32 stack on a group of
    slots on the card gives the card's solo streams, virtual clocks and
    round_stats exactly, logits within the reference's LOGIT_TOL (zamba2
    at C2's atol 1e-4), and the kernels of its group path ran."""
    from repro_torch import kernels as K
    import repro_torch.core as C
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.mesh import GroupMesh
    from repro_torch.models import init_params
    from repro_torch.serving import GeoServingSystem

    cfg = get_reduced_config(arch)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    kw = dict(R=2, max_new_tokens=4, max_sessions=4, decode_mode=mode,
              cache_layout=layout, page_size=2 if layout == "paged" else None)
    want = _group_drive(GeoServingSystem(
        cfg, params, _group_problem(C, cfg.n_layers, 2), **kw), C)
    mesh = GroupMesh(np.full(shape, "cuda", dtype=object))
    names = GROUP_KERNELS[arch]
    if layout == "paged":  # whole pages gathered: K1 over the whole cache
        names = tuple(n for n in names if n != "merge_partials")
        names = tuple("decode_attention" if n.endswith("partials") else n
                      for n in names)
    before = [getattr(K, n).launches for n in names]
    got = _group_drive(GeoServingSystem(
        cfg, params, _group_problem(C, cfg.n_layers, 2), mesh=mesh, **kw), C)
    ran = [getattr(K, n).launches - b for n, b in zip(names, before)]
    assert min(ran) > 0, dict(zip(names, ran))
    assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
    atol = 1e-4 if arch == "zamba2_7b" else 5e-6
    for hg, hw in zip(got[2], want[2]):
        for a, b in zip(hg, hw):
            torch.testing.assert_close(a, b, atol=atol, rtol=1e-4)


def test_hetero_groups_bf16_first_step_on_card(cuda):
    """``chip_smoke.py`` [groups] (a) at reduced depth: bf16 Llama-3.2-1B
    at full width, 4 layers, groups {solo, (1, 2), (2, 2)} on three
    servers, session j on server j: K1 ran, 1 host sync a fused decode
    round, first-step greedy tokens equal the solo run's and logits within
    2.5% of its scale."""
    import warnings

    import repro_torch.core as C
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import group_meshes
    from repro_torch.models import init_params
    from repro_torch.serving import GeoServingSystem

    cfg = get_config("llama3_2_1b").replace(n_layers=4)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    prob = _group_problem(C, cfg.n_layers, 3)
    runs = {}
    for tag, groups in (("solo", None), ("groups", group_meshes(
            {0: None, 1: (1, 2), 2: (2, 2)}, devices=["cuda"] * 6))):
        system = GeoServingSystem(cfg, params, prob, R=3, max_new_tokens=4,
                                  max_sessions=4, max_seq_len=128,
                                  device_groups=groups)
        rng = np.random.RandomState(0)
        sids = []
        for j, n in enumerate((40, 64, 33)):  # session j on server j
            sids.append(system.create_session(
                rng.randint(2, cfg.vocab_size, n), 0,
                C.Route(servers=(j,), blocks=(cfg.n_layers,)), 4))
        assert system.try_admit_sessions(sids) == sids
        system.drain_prefill()
        first = [(system.sessions[s].tokens[-1],
                  system.sessions[s].last_logits.float().clone())
                 for s in sids]
        before = decode_attention.launches
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                system.decode_round(sids)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("called a synchronizing" in str(w.message)
                    for w in caught)
        assert syncs == 1, syncs
        assert decode_attention.launches > before
        runs[tag] = first
    for (t_s, l_s), (t_g, l_g) in zip(runs["solo"], runs["groups"]):
        assert t_s == t_g
        assert float((l_g - l_s).abs().max()) <= \
            0.025 * float(l_s.abs().max())


def test_readback_spans_are_the_host_syncs_on_card(cuda):
    """The program's ``readback`` spans (``serving/trace.py``) are its host
    syncs: over one prefill round that finishes two sessions (one bucket
    group) and one fused decode round, the synchronizing calls torch warns
    about equal the readback spans, 2 + 1."""
    import warnings

    import repro_torch.core as C
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import init_params
    from repro_torch.serving import GeoServingSystem
    from repro_torch.serving.trace import Tracer

    cfg = get_reduced_config("llama3_2_1b")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    system = GeoServingSystem(cfg, params,
                              _group_problem(C, cfg.n_layers, 2), R=4,
                              max_new_tokens=4, max_sessions=4,
                              max_seq_len=64)
    route, _ = C.shortest_path_route(system.problem,
                                     system.alive_placement(), 0)
    rng = np.random.RandomState(0)

    def admit(lengths):
        sids = [system.create_session(rng.randint(2, cfg.vocab_size, n), 0,
                                      route, 3) for n in lengths]
        assert system.try_admit_sessions(sids) == sids
        return sids

    # the same shapes once first: kernel builds and first launches
    warm = admit((20, 27))
    system.drain_prefill()
    system.decode_round(warm)
    for sid in warm:
        system.retire_session(sid)
    sids = admit((21, 30))
    tr = system.tracer = Tracer()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            done = system.prefill_round()
            out = system.decode_round(sids)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing" in str(w.message)
                for w in caught)
    assert sorted(done) == sids and sorted(out) == sids
    assert syncs == sum(s.name == "readback" for s in tr.spans) == 3


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_prefill_alone_equals_four_member_group_on_card(cuda, layout):
    """A bf16 BLOOM stack at head dim 128: each session's tokens and
    ``last_logits`` are bit-equal whether it is prefilled alone or in a
    four-member bucket group.  Each member is prefilled in a one-row call
    on its own pool row, so its GEMMs have the same shapes either way."""
    import repro_torch.core as C
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import init_params
    from repro_torch.serving import GeoServingSystem

    cfg = get_reduced_config("bloom_176b").replace(
        n_layers=4, d_model=1024, n_heads=8, n_kv_heads=8, head_dim=128,
        d_ff=4096, param_dtype="bfloat16", act_dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(2, cfg.vocab_size, n) for n in (40, 53, 61, 47)]

    def run(batch):
        system = GeoServingSystem(cfg, params,
                                  _group_problem(C, cfg.n_layers, 2), R=2,
                                  max_new_tokens=4, max_sessions=4,
                                  max_seq_len=96, cache_layout=layout)
        route, _ = C.shortest_path_route(system.problem,
                                         system.alive_placement(), 0)
        sids = [system.create_session(p, 0, route, 4) for p in batch]
        assert system.try_admit_sessions(sids) == sids
        assert len(system._prefill_groups) == 1
        system.drain_prefill()
        first = [system.sessions[s].last_logits.clone() for s in sids]
        for _ in range(3):
            system.decode_round(sids)
        return [(list(system.sessions[s].tokens), f,
                 system.sessions[s].last_logits) for s, f in zip(sids, first)]

    grouped = run(prompts)
    for p, (tokens, first, last) in zip(prompts, grouped):
        [(t_a, f_a, l_a)] = run([p])
        assert t_a == tokens
        assert torch.equal(f_a, first) and torch.equal(l_a, last)


@pytest.mark.parametrize("arch,mem", [("llama3_2_1b", 260.0),
                                      ("deepseek_v2_236b", 260.0),
                                      ("zamba2_7b", 520.0)])
def test_split_page_axis_equals_solo_on_card(cuda, arch, mem):
    """Paged page arrays split over ``data`` on a (2, 2) group of card
    slots (servers whose 35 / 37 pages and the trash page divide the data
    axis): a row's pages read from and written to the data slot holding
    them, counted; streams, clocks and round_stats the card's solo run's,
    logits within LOGIT_TOL (zamba2 at C2's atol 1e-4), K1 ran."""
    import repro_torch.core as C
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.mesh import GroupMesh
    from repro_torch.models import init_params
    from repro_torch.models.layers import count_collectives
    from repro_torch.serving import GeoServingSystem
    from repro_torch.serving.kv_cache import page_blocks

    cfg = get_reduced_config(arch)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    kw = dict(R=2, max_new_tokens=4, max_sessions=4, cache_layout="paged",
              page_size=4)
    want = _group_drive(GeoServingSystem(
        cfg, params, _group_problem(C, cfg.n_layers, 2, mem), **kw), C)
    system = GeoServingSystem(cfg, params,
                              _group_problem(C, cfg.n_layers, 2, mem),
                              mesh=GroupMesh(np.full((2, 2), "cuda",
                                                     dtype=object)), **kw)
    assert any(page_blocks(s.mesh, s.pool.slot_specs) == 2
               for s in system.servers.values())
    before = decode_attention.launches
    with count_collectives() as coll:
        got = _group_drive(system, C)
    assert decode_attention.launches > before
    assert coll.by_kind["page-read"] > 0 and coll.by_kind["page-write"] > 0
    assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
    atol = 1e-4 if arch == "zamba2_7b" else 5e-6
    for hg, hw in zip(got[2], want[2]):
        for a, b in zip(hg, hw):
            torch.testing.assert_close(a, b, atol=atol, rtol=1e-4)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "gemma3_4b"])
def test_head_dim_group_equals_solo_on_card(cuda, arch):
    """``chip_smoke.py`` [groups] (i) and the Gemma ``[dryrun]`` cells at
    reduced width, in f32: 4 query heads on a (1, 8) group of card slots
    take the ``head_dim`` fallback.  The engine (the cache's time axis
    over the 8 slots: K1 partials and their merge, K2 on each slot) gives
    the card's solo streams, virtual clocks and round_stats exactly,
    logits within f32's 1e-5 of the solo logit scale (the head_dim
    blocks' partial sums associate otherwise: 3e-7 to 7e-7 of the scale
    on the CPU, as a (2, 4) group's heads); the group ``prefill`` under a
    prefill cell's rules (``attn_seq_q``: K2 on each slot's 2 query rows
    at q_start 2 j) gives the solo prefill's logits, held the same way."""
    from repro_torch import kernels as K
    import repro_torch.core as C
    from repro_torch.configs import ShapeSpec, get_reduced_config
    from repro_torch.launch.mesh import GroupMesh
    from repro_torch.launch.sharding import make_ctx, shard, shard_params
    from repro_torch.models import init_params, prefill
    from repro_torch.models.layers import group_ctxs
    from repro_torch.serving import GeoServingSystem

    cfg = get_reduced_config(arch)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    kw = dict(R=2, max_new_tokens=4, max_sessions=4)
    want = _group_drive(GeoServingSystem(
        cfg, params, _group_problem(C, cfg.n_layers, 2), **kw), C)
    mesh = GroupMesh(np.full((1, 8), "cuda", dtype=object))
    names = ("decode_attention_partials", "merge_partials",
             "flash_attention")
    before = [getattr(K, n).launches for n in names]
    got = _group_drive(GeoServingSystem(
        cfg, params, _group_problem(C, cfg.n_layers, 2), mesh=mesh, **kw), C)
    ran = [getattr(K, n).launches - b for n, b in zip(names, before)]
    assert min(ran) > 0, dict(zip(names, ran))
    assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
    for hg, hw in zip(got[2], want[2]):
        for a, b in zip(hg, hw):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    sh = make_ctx(cfg, mesh, ShapeSpec("prefill", 32, 2, "prefill"))
    assert sh.rules["attn_seq_q"] == sh.rules["head_dim"] == "model"
    tokens = torch.randint(2, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).to(cuda)
    solo, _ = prefill(params, cfg, {"tokens": tokens}, cache_len=32)
    n0 = K.flash_attention.launches
    logits, _ = prefill(shard_params(cfg, sh, params), cfg,
                        [{"tokens": t} for t in shard(
                            tokens, sh.spec(("batch", None), (2, 16)),
                            mesh)], cache_len=32,
                        ctxs=group_ctxs(mesh, sh.rules))
    assert K.flash_attention.launches > n0
    assert float((logits[0] - solo).abs().max()) <= \
        1e-5 * float(solo.abs().max())


@pytest.mark.parametrize("arch,optimizer", [("llama3_2_1b", "adamw"),
                                            ("deepseek_v2_236b", "adafactor"),
                                            ("zamba2_7b", "adamw"),
                                            ("llama4_scout_17b_a16e",
                                             "adamw")])
def test_group_train_step_equals_solo_on_card(cuda, arch, optimizer):
    """``chip_smoke.py`` [train group] at reduced width: one f32 step over
    a (2, 2) group of card slots against the solo step on the card from
    the same weights and batch — the loss at rtol 1e-5, every gradient
    leaf (reduced over the slots and put back together) at max|d| <=
    atol + rtol max|solo| (1e-5, 2e-4; zamba2 C2's (1e-4, 1e-3)), no host
    sync inside the step, replicas bit-equal.  Llama-4-Scout runs under
    ``seq_act`` (a cell whose remat stash passes 8e9 bytes): its MoE
    routes each slot's own block of the positions."""
    import warnings

    from repro_torch.configs import (SHAPES_BY_NAME, ShapeSpec,
                                     get_reduced_config)
    from repro_torch.data import make_batches, shard_batch
    from repro_torch.launch.mesh import GroupMesh
    from repro_torch.launch.sharding import make_ctx
    from repro_torch.models import init_params, train_loss
    from repro_torch.training import (TrainHParams, init_train_state,
                                      make_optimizer_for, make_train_step)
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.train_step import GroupLayout

    cfg = get_reduced_config(arch).replace(optimizer=optimizer)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    host = next(make_batches(cfg, 4, 32, seed=0))
    live = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                    params)
    loss, _ = train_loss(live, cfg, shard_batch(host, device=cuda))
    want = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                               materialize_grads=True)
    mesh = GroupMesh(np.full((2, 2), "cuda", dtype=object))
    seq_act = arch == "llama4_scout_17b_a16e"
    sh = make_ctx(cfg, mesh, ShapeSpec("train_seq_act", 1 << 20, 64,
                                       "train") if seq_act
                  else SHAPES_BY_NAME["train_4k"])
    assert (sh.rules["seq_act"] == "model") == seq_act
    lay = GroupLayout(cfg, sh)
    batch = shard_batch(host, mesh, sh, device=cuda)
    g_loss, _, grads = lay.loss_and_grads(lay.shard(params), batch)
    got = tree_leaves(lay.unshard(lay.reduce_grads(grads)))
    torch.testing.assert_close(g_loss, loss.detach(), rtol=1e-5, atol=0)
    atol, rtol = (1e-4, 1e-3) if arch == "zamba2_7b" else (1e-5, 2e-4)
    for a, b in zip(got, want):
        if b.numel():
            assert float((a - b).abs().max()) <= \
                atol + rtol * float(b.abs().max())
    hp = TrainHParams(learning_rate=5e-3)
    opt = make_optimizer_for(cfg, hp)
    state = init_train_state(None, cfg, opt, params=params, device=cuda,
                             sh=sh)
    step = make_train_step(cfg, opt, hp, sh)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, metrics = step(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert not [w for w in caught if "called a synchronizing"
                in str(w.message)]
    assert torch.isfinite(metrics["loss"])
    flat = [tree_leaves(t) for t in state["params"]]
    for k, leaf in enumerate(lay.leaves):
        for s, owner in enumerate(leaf["owners"]):
            assert torch.equal(flat[s][k], flat[owner][k])


# ---------------------------------------------------------------------------
# DeepSeek-V2's published options: grouped expert products, K2's scale
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,d,f,M", [(16, 64, 32, 50), (160, 512, 256, 768),
                                     (160, 512, 256, 6144)])
def test_grouped_experts_match_plain_on_card(cuda, E, d, f, M):
    """The grouped GEMMs against the plain per-expert loop in bf16, with
    half the rows on one expert and some experts empty; three launches and
    no host sync."""
    from repro_torch.kernels import grouped_experts, grouped_experts_ref

    g = torch.Generator(device="cuda").manual_seed(0)
    wg = torch.randn(E, d, f, generator=g, device="cuda") * d ** -0.5
    wu = torch.randn(E, d, f, generator=g, device="cuda") * d ** -0.5
    wo = torch.randn(E, f, d, generator=g, device="cuda") * f ** -0.5
    wg, wu, wo = (w.bfloat16() for w in (wg, wu, wo))
    e = torch.randint(0, E // 2, (M,), generator=g, device="cuda")
    e[: M // 2] = 3
    e = torch.sort(e).values
    counts = torch.zeros(E, dtype=torch.int32, device="cuda")
    counts.scatter_add_(0, e, torch.ones_like(e, dtype=torch.int32))
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    x = torch.randn(M, d, generator=g, device="cuda").bfloat16()
    before = grouped_experts.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = grouped_experts(x, wg, wu, wo, offs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert grouped_experts.launches - before == 3
    want = grouped_experts_ref(x, wg, wu, wo, offs)
    torch.testing.assert_close(y.float(), want.float(), rtol=0,
                               atol=TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype,Dk,Dv", [(torch.bfloat16, 192, 128),
                                         (torch.float32, 24, 16)])
def test_flash_scale_matches_plain_on_card(cuda, dtype, Dk, Dv):
    """K2's ``scale`` (MLA under YaRN: 192^-1/2 x 1.2608^2) against the
    plain version's, at a chunked-prefill offset."""
    g = torch.Generator(device="cuda").manual_seed(1)
    q = _rn(g, 2, 64, 8, Dk, dtype=dtype)
    k = _rn(g, 2, 96, 8, Dk, dtype=dtype)
    v = _rn(g, 2, 96, 8, Dv, dtype=dtype)
    scale = Dk ** -0.5 * 1.2608 ** 2
    out = flash_attention(q, k, v, q_start=32, scale=scale)
    want = attention_ref(q, k, v, q_start=32, scale=scale)
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=TOL[dtype])
    assert not torch.allclose(out.float(), flash_attention(
        q, k, v, q_start=32).float(), atol=TOL[dtype])


def test_readback_spans_on_a_deepseek_path_on_card(cuda):
    """The published DeepSeek-V2 options (a leading dense block, group-
    limited routing x 16, the dropless MoE on the grouped GEMMs, YaRN) at
    a reduced size in bf16: a prefill round finishing two sessions and a
    fused decode round make 2 + 1 host syncs, each a ``readback`` span,
    and each hop that runs MoE layers counts their tokens and pairs."""
    import sys
    import warnings
    from pathlib import Path

    import repro_torch.core as C
    from repro_torch.configs.base import ModelConfig
    from repro_torch.serving import GeoServingSystem
    from repro_torch.serving.trace import Tracer

    sys.path.append(str(Path(__file__).resolve().parents[1] / "bench"))
    from families import deepseek_v2 as fam

    import json
    c = json.loads((Path(__file__).resolve().parents[1] / "bench" /
                    "configs" / "deepseekv2-l8.json").read_text())
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16,
             v_head_dim=16, qk_rope_head_dim=16, n_routed_experts=16,
             n_group=4, topk_group=2, num_experts_per_tok=4,
             moe_intermediate_size=32, intermediate_size=96, vocab_size=256,
             num_hidden_layers=4)
    c["rope_scaling"] = dict(c["rope_scaling"],
                             original_max_position_embeddings=16)
    cfg = fam.port_config(c, ModelConfig)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = {}
    for path, shape, dt, kind, std in fam.weight_spec(c):
        t = torch.randn(shape, generator=g, device="cuda") * std
        t = (t + 1.0 if kind == "one" else t).to(getattr(torch, dt))
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    system = GeoServingSystem(cfg, params,
                              _group_problem(C, cfg.n_layers, 2), R=4,
                              max_new_tokens=4, max_sessions=4,
                              max_seq_len=64, prefill_mode="batched",
                              decode_mode="fused")
    route, _ = C.shortest_path_route(system.problem,
                                     system.alive_placement(), 0)
    rng = np.random.RandomState(0)

    def admit(lengths):
        sids = [system.create_session(rng.randint(2, cfg.vocab_size, n), 0,
                                      route, 3) for n in lengths]
        assert system.try_admit_sessions(sids) == sids
        return sids

    warm = admit((20, 27))
    system.drain_prefill()
    system.decode_round(warm)
    for sid in warm:
        system.retire_session(sid)
    sids = admit((21, 30))
    tr = system.tracer = Tracer()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            done = system.prefill_round()
            out = system.decode_round(sids)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing" in str(w.message)
                for w in caught)
    assert sorted(done) == sids and sorted(out) == sids
    assert syncs == sum(s.name == "readback" for s in tr.spans) == 3
    hops = [s for s in tr.spans
            if s.name == "hop" and "moe_tokens" in s.attrs]
    assert hops and all(s.attrs["moe_pairs"] == 4 * s.attrs["moe_tokens"]
                        for s in hops)
