"""Wall time in prefill_round spans that ended inside the window over their
count, in ms.
"""
import readers


def read(w):
    return readers.round_ms(w, "prefill_round")
