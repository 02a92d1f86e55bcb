"""The plain reference (bench/reference) against the port's plain path
(``backend="plain"``) at reduced widths, in float32 on the CPU."""
import pytest
import torch

from bench_support import reduced_config


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


@pytest.mark.parametrize("block", [256, 4])
@pytest.mark.parametrize("name", ["bloom176b-l11", "chameleon34b"])
def test_reference_matches_port_plain_path(name, block, monkeypatch):
    """Also with the attention's query blocks smaller than the prompts."""
    import harness
    import reference.common as ref

    monkeypatch.setattr(ref, "QUERY_BLOCK", block)
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.layers import lm_head
    from repro_torch.models.model import forward_full

    c = reduced_config(name)
    w = _f32(harness.make_weights(c, 1234, "cpu"))
    cfg = harness.family(c).port_config(c, ModelConfig).replace(
        param_dtype="float32", act_dtype="float32")
    g = torch.Generator().manual_seed(0)
    seqs = [torch.randint(2, c["vocab_size"], (n,), generator=g).tolist()
            for n in (9, 23)]
    got = ref.run(w, c, seqs, [1, 1])
    for s, lg in zip(seqs, got):
        h, _, _ = forward_full(w, cfg, {"tokens": torch.tensor([s])},
                               backend="plain")
        want = lm_head(w["embed"], cfg, h)[0, :-1]
        assert lg.shape == want.shape
        torch.testing.assert_close(lg, want, rtol=1e-4, atol=1e-4)


def test_bloom_alibi_slopes_match_the_port():
    from reference.bloom import alibi_slopes
    from repro_torch.models.layers import alibi_slopes as port

    for h in (4, 6, 12, 112):
        torch.testing.assert_close(alibi_slopes(h), port(h))


def test_fp8_control_rounds_matrices_only():
    from reference.common import via_fp8

    x = torch.randn(64, 32)
    q = via_fp8(x)
    assert not torch.equal(q, x)
    assert (q - x).abs().max() <= x.abs().max() / 8
    v = torch.randn(32)
    assert torch.equal(via_fp8(v), v)
