"""Device operations (kernels, copies, sets) whose start lies inside a
program ``decode_round`` span that ended inside the traced window, over
those rounds.
"""
import program


def read(w):
    return program.kernels_per_round(w)
