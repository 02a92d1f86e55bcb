"""The grouped expert products' kernels' device time over the traced
window's busy device time, in %.
"""
import moe_calls


def read(w):
    t = moe_calls.kernel_s(w)
    if w.device is None or t <= 0:
        return None
    return 100.0 * t / w.device.busy_s()
