"""The share of the window's wall outside the benchmark's spans around
try_admit_sessions, prefill_round and decode_round (the scheduler, the
controller and Python between engine calls), in %.
"""
import readers


def read(w):
    return 100.0 * (1.0 - readers.engine_share(w))
