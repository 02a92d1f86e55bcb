"""Process start to the first timed round: imports, CUDA start, weights drawn
on the card, the system's build and the warm-up of the cell's buckets (in a
checkout's first run, the kernels' nvcc build too).
"""


def read(w):
    return w.setup_s
