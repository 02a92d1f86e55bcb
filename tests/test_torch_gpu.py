"""The port's CUDA kernels and its engine on the card.  These need an NVIDIA
GPU and nvcc; elsewhere they skip.  Run them on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX: the GPU machine has none.  Kernels are held
against their plain PyTorch versions (f32 1e-5, bf16 2e-2 abs); the
engine on the kernels against the engine on the plain attention.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (attention_ref, decode_attention,
                                 decode_attention_ref, flash_attention)

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


def test_unsupported_head_dim_raises(cuda):
    q = torch.zeros((1, 4, 2, 48), device=cuda)
    with pytest.raises(NotImplementedError, match="head dims"):
        flash_attention(q, q, q)


def test_engine_kernel_equals_plain_backend(cuda):
    """Reduced llama3 served on the card: the kernel backend gives the
    plain backend's greedy streams, and both kernels ran."""
    import repro_torch.core as C
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import init_params
    from repro_torch.serving import (ContinuousBatchingScheduler,
                                     GeoServingSystem)

    cfg = get_reduced_config("llama3_2_1b").replace(n_layers=8)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    llm = C.LLMSpec("t", 8, block_bytes=50.0, cache_bytes_per_token=0.5)
    servers = [C.ServerSpec(j, m, t) for j, (m, t) in enumerate(
        [(500.0, 0.004), (500.0, 0.004), (220.0, 0.02), (220.0, 0.02)])]
    rtt = np.array([[0.01, 0.01, 0.03, 0.03]])
    prob = C.Problem(llm, servers, 1, rtt, 3 * rtt, workload=C.Workload(8, 16))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(2, cfg.vocab_size, n) for n in (8, 13, 5)]
    streams = {}
    for backend in ("kernel", "plain"):
        system = GeoServingSystem(cfg, params, prob, R=4, max_new_tokens=16,
                                  backend=backend)
        sched = ContinuousBatchingScheduler(system, R=4)
        for rid, p in enumerate(prompts):
            sched.submit(rid, p, 0.1 * rid, n_new=10)
        n = (decode_attention.launches, flash_attention.launches)
        streams[backend] = [list(s.tokens) for s in sched.run()]
        ran = (decode_attention.launches - n[0],
               flash_attention.launches - n[1])
        assert (min(ran) > 0) == (backend == "kernel"), ran
    assert streams["kernel"] == streams["plain"]
