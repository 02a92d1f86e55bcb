"""Every token the decode rounds that ended inside the window produced, over
the window's wall (first tokens come from prefill rounds and are not
counted).
"""
import readers


def read(w):
    return readers.decode_tokens(w) / w.wall
