"""K2 (prefill attention): the sum of each call's bound for the keys it
reaches, causal and ALiBi (bench/costs.py), over K2's device time, in %.
"""
import readers


def read(w):
    return readers.roofline(w, w.k2, readers.K2_KERNELS)
