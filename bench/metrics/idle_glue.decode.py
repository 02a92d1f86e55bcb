"""Device-idle seconds of the traced window inside the program's
``decode_round``, ``prefill_round`` and ``admit`` spans but outside every
``step`` (the engine's host bookkeeping: staging, embed, tail, readback,
emit), over the window, in % (bench/program.py).
"""
import program


def read(w):
    return program.idle_share_in(w, "glue")
