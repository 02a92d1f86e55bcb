"""The share of the traced window with no kernel, copy or set running on the
device (torch.profiler), in %.
"""
import readers


def read(w):
    return readers.idle_share(w)
