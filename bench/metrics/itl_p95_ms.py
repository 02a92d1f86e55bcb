"""95th percentile of all wall gaps between consecutive tokens of a session,
for the gaps that end inside the window, in ms.
"""
import readers


def read(w):
    gaps = readers.token_gaps(w)
    return 1e3 * readers.percentile(gaps, 95) if gaps else None
