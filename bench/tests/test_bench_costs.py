"""bench/costs.py: the frozen K1 / K2 counts equal the port's ``cost()`` at
the cells' shapes, and the useful flops of one token equal a hand count
from the configuration."""
import pytest
import torch

import bench_support  # noqa: F401  (bench/ and src/ on the path)
import costs
import harness

# (q, k/v) of the cells' K1 calls: all pool rows over max_seq_len positions
K1_SHAPES = {
    "chameleon34b.decode": ((128, 1, 64, 128), (128, 224, 8, 128), 0),
    "bloom176b.decode": ((64, 1, 112, 128), (64, 224, 112, 128), 112),
    "bloom176b.prefill": ((4, 1, 112, 128), (4, 2048, 112, 128), 112),
    "chameleon34b.prefill": ((6, 1, 64, 128), (6, 2048, 8, 128), 0),
}
# K2 calls: all pool rows at a bucket
K2_SHAPES = {
    "chameleon34b.decode": ((128, 64, 64, 128), (128, 64, 8, 128), 0),
    "bloom176b.decode": ((64, 32, 112, 128), (64, 32, 112, 128), 112),
    "bloom176b.prefill": ((4, 2048, 112, 128), (4, 2048, 112, 128), 112),
    "chameleon34b.prefill": ((6, 1024, 64, 128), (6, 1024, 8, 128), 0),
}


def _big(shape):
    """A full-shape bf16 view of one element (what cost() reads is the
    shape, the dtype and the storage)."""
    return torch.zeros(1, dtype=torch.bfloat16).expand(shape)


@pytest.mark.parametrize("cell", sorted(K1_SHAPES))
def test_k1_cost_is_the_ports(cell):
    from repro_torch.kernels.decode_attention import ops

    qs, ks, ns = K1_SHAPES[cell]
    q, ck, cv = _big(qs), _big(ks), _big(ks)
    g = torch.Generator().manual_seed(len(cell))
    pos = torch.randint(0, ks[1], (qs[0],), generator=g)
    slopes = torch.ones(ns) if ns else None
    want = ops.cost(q, ck, cv, pos, slopes=slopes)
    got = costs.k1_cost(qs, ks, ks, pos.tolist(), 2, n_slopes=ns)
    assert got == (want.flops, want.bytes_accessed)


@pytest.mark.parametrize("cell", sorted(K2_SHAPES))
@pytest.mark.parametrize("q_start", [0, 64])
def test_k2_cost_is_the_ports(cell, q_start):
    from repro_torch.kernels.flash_attention import ops

    qs, ks, ns = K2_SHAPES[cell]
    ks = (ks[0], ks[1] + q_start) + ks[2:]
    slopes = torch.ones(ns) if ns else None
    want = ops.cost(_big(qs), _big(ks), _big(ks), q_start=q_start,
                    slopes=slopes)
    got = costs.k2_cost(qs, ks, ks, 2, q_start=q_start, n_slopes=ns)
    assert got == (want.flops, want.bytes_accessed)


def test_token_flops_by_hand():
    b = harness.dims(harness.load_config("bloom176b-l11"))
    d = 14336
    # q, k, v, o: 4 d^2; MLP d x 4d twice: 8 d^2; scores and P.V over p + 1
    # keys: 2 * 2 * d * (p + 1); two flops a multiply-add
    for p in (0, 19, 255):
        assert costs.layer_flops(b, p) == 2 * 12 * d * d + 4 * d * (p + 1)
    assert costs.head_flops(b) == 2 * d * 250880
    c = harness.dims(harness.load_config("chameleon34b"))
    d, f, kv = 8192, 22016, 8 * 128
    for p in (0, 1023):
        assert costs.layer_flops(c, p) == \
            2 * (2 * d * d + 2 * d * kv + 3 * d * f) + 4 * d * (p + 1)
    assert costs.token_flops(c, 5) == 48 * costs.layer_flops(c, 5)


@pytest.mark.parametrize("name", ["bloom176b-l11", "chameleon34b"])
def test_chunk_flops_sum_the_tokens(name):
    n = harness.dims(harness.load_config(name))
    for off, span in ((0, 1), (0, 8), (16, 33), (1024, 1008)):
        for done in (False, True):
            assert costs.chunk_flops(n, off, span, done) == sum(
                costs.token_flops(n, p) for p in range(off, off + span)) \
                + (costs.head_flops(n) if done else 0)


def test_kernel_bounds_by_hand():
    """K1 at G = 2 over three rows at positions 0, 3, 9 and K2 causal over
    a 4-token chunk at q_start 2, counted by hand in bf16."""
    B, H, Kv, D = 3, 4, 2, 8
    f, b = costs.k1_cost((B, 1, H, D), (B, 16, Kv, D), (B, 16, Kv, D),
                         [0, 3, 9], 2)
    keys = 1 + 4 + 10
    assert f == 2 * keys * H * (D + D)
    assert b == (B * H * D * 2 + B * H * D * 2 + keys * Kv * 2 * D * 2
                 + 4 * B)
    f, b = costs.k1_cost((B, 1, H, D), (B, 16, Kv, D), (B, 16, Kv, D),
                         [0, 3, 9], 2, n_slopes=H)
    assert b == (B * H * D * 2 + B * H * D * 2 + keys * Kv * 2 * D * 2
                 + 4 * B + 4 * H)
    # queries at 2..5 over keys 0..5: 3 + 4 + 5 + 6 causal pairs, 6 keys
    f, b = costs.k2_cost((1, 4, H, D), (1, 6, Kv, D), (1, 6, Kv, D), 2,
                         q_start=2)
    assert f == 2 * H * (3 + 4 + 5 + 6) * (D + D)
    assert b == (4 * H * D + 6 * Kv * 2 * D + 4 * H * D) * 2
    assert costs.bound_s(989e12, 0) == 1.0
    assert costs.bound_s(0, 3.35e12) == 1.0


def test_params_of_the_cut_models():
    """11 BLOOM layers are 30.7 B params with the tied head (57.2 GiB in
    bf16); Chameleon-34B at full depth 34.3 B (63.9 GiB)."""
    def count(name):
        c = harness.load_config(name)
        total = 0
        for _, shape, *_ in harness.family(c).weight_spec(c):
            n = 1
            for x in shape:
                n *= x
            total += n
        return total

    assert abs(count("bloom176b-l11") / 1e9 - 30.72) < 0.01
    assert abs(count("chameleon34b") / 1e9 - 34.29) < 0.01
