"""DeepSeek-V2's useful model flops of the rounds that ended inside the
window (bench/costs_deepseek.py: live tokens through MLA, the dense block,
the router, 6 routed and the shared experts, causal attention over their
prefix, the LM head per generated token; the stamps and chunks that
readers.useful_flops reads) over the window's wall times 989 TFLOP/s
(H100 bf16 dense), in %.
"""
import costs
import costs_deepseek


def read(w):
    n = w.dims
    total = 0
    for t1, chunks in w.chunks:
        if w.inside(t1):
            total += sum(costs_deepseek.chunk_flops(n, off, span, done)
                         for _, off, span, done in chunks)
    for s in w.sessions.values():
        p = len(s.prompt)
        for k, ts in enumerate(s.times[1:], start=1):
            if w.inside(ts):
                total += costs_deepseek.token_flops(n, p + k - 1) \
                    + costs_deepseek.head_flops(n)
    return 100.0 * total / (w.wall * costs.PEAK_FLOPS_BF16) if total \
        else None
