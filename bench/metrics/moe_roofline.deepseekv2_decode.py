"""The grouped expert products (a dropless MoE layer's three grouped GEMMs):
the sum of each call's bound, max(bytes / 3.35 TB/s, flops / 989 TFLOP/s)
with the weights of its distinct experts read once, the rows and outputs,
and the flops of its live (token, expert) pairs
(bench/costs_deepseek.py), over their kernels' device time, in %.
"""
import costs
import costs_deepseek
import moe_calls


def read(w):
    found = moe_calls.calls(w)
    t = moe_calls.kernel_s(w)
    if not found or t <= 0:
        return None
    return 100.0 * sum(costs.bound_s(*costs_deepseek.moe_cost(*c))
                       for c in found) / t
