"""Useful model flops of the rounds that ended inside the window
(bench/costs.py: live tokens through the layers of their routes, attention
over their causal prefix, the LM head per generated token) over the
window's wall times 989 TFLOP/s (H100 bf16 dense), in %.
"""
import readers


def read(w):
    return readers.mfu(w)
