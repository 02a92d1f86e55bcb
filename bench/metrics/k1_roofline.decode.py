"""K1 (decode attention): the sum of each call's bound, max(bytes / 3.35
TB/s, flops / 989 TFLOP/s) for the keys each row reaches (bench/costs.py),
over the device time of its split and combine kernels, in %.
"""
import readers


def read(w):
    return readers.roofline(w, w.k1, readers.K1_KERNELS)
