"""90th percentile over every request whose first token came inside the
window, each timed from the wall time when the scheduler took up its
arrival to its first token, in ms.
"""
import readers


def read(w):
    t = readers.ttfts(w)
    return 1e3 * readers.percentile(t, 90) if t else None
