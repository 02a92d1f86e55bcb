"""K3 wrapper: the RWKV6 WKV recurrence in the model layout through the
hand-written CUDA kernel (``kernels/csrc/wkv6.cu``).

``wkv6`` takes r/k/v/lw (B,S,H,hd), u (H,hd) and an optional carried state
(B,H,hd,hd), all float32 (the reference casts r/k/v to f32 before the
scan), and returns (out (B,S,H,hd), state_out (B,H,hd,hd)).  A CPU tensor
goes to the plain version (``ref.py``); a CUDA tensor goes to the kernel,
or the call raises — there is no fallback.  ``wkv6.launches`` counts
kernel launches.  The kernel reads the four sequence operands through
their strides, so the wrapper makes no transposed copies.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.runtime import check_launch, load_library
from repro_torch.kernels.wkv6.ref import wkv6_chunked

# head dims the kernel is instantiated for (one thread per state column,
# the column held in registers)
HEAD_DIMS = (16, 32, 64, 128)
_fn = None


def wkv6_unsupported(*, state=None) -> Optional[str]:
    """Reason the kernel cannot serve a WKV6 call, else None — carried
    state in and out is native, as in the reference's guard."""
    return None


def _launcher():
    global _fn
    if _fn is None:
        fn = load_library("wkv6").wkv6_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I,
                       ctypes.POINTER(ctypes.c_longlong), P]
        fn.restype = I
        _fn = fn
    return _fn


def wkv6(r, k, v, lw, u, state=None):
    """r/k/v/lw (B,S,H,hd); u (H,hd); state optional (B,H,hd,hd) -> (out
    (B,S,H,hd), state_out (B,H,hd,hd)), all float32."""
    reason = wkv6_unsupported(state=state)
    if reason is not None:
        raise ValueError(f"wkv6 does not support {reason}")
    if r.device.type == "cpu":
        return wkv6_chunked(r, k, v, lw, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    B, S, H, hd = r.shape
    ops = (r, k, v, lw)
    if any(x.shape != r.shape for x in ops) or u.shape != (H, hd):
        raise ValueError(f"wkv6: bad shapes r {tuple(r.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"lw {tuple(lw.shape)} u {tuple(u.shape)}")
    if state is not None and state.shape != (B, H, hd, hd):
        raise ValueError(f"wkv6: state {tuple(state.shape)}, want "
                         f"{(B, H, hd, hd)}")
    tensors = ops + (u,) + (() if state is None else (state,))
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError("wkv6: the kernel takes float32 operands")
    if any(x.device != r.device for x in tensors):
        raise ValueError("wkv6: operands on different devices")
    if any(x.stride(-1) != 1 for x in ops):
        raise ValueError("wkv6: head dims must be contiguous")
    if hd not in HEAD_DIMS:
        raise NotImplementedError(
            f"wkv6: no kernel for head dim {hd} (built for {HEAD_DIMS})")
    u = u.contiguous()
    state = None if state is None else state.contiguous()
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    state_out = torch.empty((B, H, hd, hd), dtype=torch.float32,
                            device=r.device)
    strides = (ctypes.c_longlong * 12)(*(s for x in ops
                                         for s in x.stride()[:3]))
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _launcher()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), None if state is None else state.data_ptr(),
        out.data_ptr(), state_out.data_ptr(), B, S, H, hd, strides, stream)
    if err < 0:
        raise ValueError(f"wkv6: the kernel does not take hd={hd}")
    check_launch("wkv6", err)
    wkv6.launches += 1
    return out, state_out


wkv6.launches = 0
