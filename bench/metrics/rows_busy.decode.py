"""Sessions decoded in each decode round of the window over the round's pool
rows, averaged over the rounds, in %.
"""
import readers


def read(w):
    return readers.rows_busy(w)
