"""The port's CUDA kernels and its engine on the card.  These need an NVIDIA
GPU and nvcc; elsewhere they skip.  Run them on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX: the GPU machine has none.  Kernels are held
against their plain PyTorch versions: the attention kernels at f32 1e-5,
bf16 2e-2 abs; the scans (K3 WKV6, K4 SSD, f32 only) at atol 1e-4 + rtol
1e-3, the reference's own kernel-vs-oracle tolerance (the kernels step
token by token, the plain versions chunk: the same sums, associated
differently).  The engine on the kernels is held against the engine on the
plain versions.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (attention_ref, decode_attention,
                                 decode_attention_ref, flash_attention, ssd,
                                 ssd_chunked, wkv6, wkv6_chunked)

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
    # trailing zero tokens leave the carried state unchanged
    z = torch.zeros(B, 5, H, hd, device=cuda)
    _, st_pad = wkv6(*(torch.cat([x, z], 1) for x in (r, k, v, lw)), u, s0)
    _scan_close(st_pad, st)


@pytest.mark.parametrize("B,S,H,p,n,with_state", [
    (2, 45, 3, 64, 64, False),
    (1, 1, 2, 16, 16, True),
    (2, 300, 4, 64, 32, True),  # more than one plain chunk of 256
    (1, 20, 2, 32, 128, False),
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
    _, st_pad = ssd(torch.cat([x, torch.zeros_like(x[:, :7])], 1),
                    torch.cat([bm, torch.zeros_like(bm[:, :7])], 1),
                    torch.cat([cm, torch.zeros_like(cm[:, :7])], 1),
                    torch.cat([dt, torch.zeros_like(dt[:, :7])], 1), A, D,
                    s0)
    _scan_close(st_pad, st)


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
