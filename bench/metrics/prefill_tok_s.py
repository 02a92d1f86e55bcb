"""Live prompt tokens (padding excluded) of every prefill chunk whose round
ended inside the window, over the wall from the window's start to the end
of the last such round.
"""
import readers


def read(w):
    return readers.prefill_rate(w)
