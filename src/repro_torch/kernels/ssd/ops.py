"""K4 wrapper: the Mamba2 SSD scan in the model layout through the
hand-written CUDA kernel (``kernels/csrc/ssd.cu``).

``ssd`` takes x (B,S,H,p), head-shared Bm/Cm (B,S,n), dt (B,S,H), A/D
(H,) and an optional carried state (B,H,p,n), all float32 (the reference
casts x, B and C to f32 before the scan), and returns (y (B,S,H,p),
state_out (B,H,p,n)); ``y`` includes the ``D`` skip.  A CPU tensor goes to
the plain version (``ref.py``); a CUDA tensor goes to the kernel, or the
call raises — there is no fallback.  ``ssd.launches`` counts kernel
launches.  The kernel reads x, B, C and dt through their strides, so the
wrapper makes no transposed copies.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.runtime import check_launch, load_library
from repro_torch.kernels.ssd.ref import ssd_chunked

# state sizes the kernel is instantiated for (one thread per state row,
# the row held in registers); head dims up to one block of threads
STATE_SIZES = (16, 32, 64, 128)
MAX_HEAD_DIM = 1024
_fn = None


def ssd_unsupported(*, state=None) -> Optional[str]:
    """Reason the kernel cannot serve an SSD call, else None — carried
    state in and out is native, as in the reference's guard."""
    return None


def _launcher():
    global _fn
    if _fn is None:
        fn = load_library("ssd").ssd_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                       ctypes.POINTER(ctypes.c_longlong), P]
        fn.restype = I
        _fn = fn
    return _fn


def ssd(x, Bm, Cm, dt, A, D, state=None):
    """x (B,S,H,p); Bm/Cm (B,S,n); dt (B,S,H); A/D (H,); state optional
    (B,H,p,n) -> (y (B,S,H,p), state_out (B,H,p,n)), all float32."""
    reason = ssd_unsupported(state=state)
    if reason is not None:
        raise ValueError(f"ssd does not support {reason}")
    if x.device.type == "cpu":
        return ssd_chunked(x, Bm, Cm, dt, A, D, state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    B, S, H, p = x.shape
    n = Bm.shape[-1]
    if (Bm.shape != (B, S, n) or Cm.shape != (B, S, n)
            or dt.shape != (B, S, H) or A.shape != (H,) or D.shape != (H,)):
        raise ValueError(f"ssd: bad shapes x {tuple(x.shape)} "
                         f"B {tuple(Bm.shape)} C {tuple(Cm.shape)} "
                         f"dt {tuple(dt.shape)} A {tuple(A.shape)} "
                         f"D {tuple(D.shape)}")
    if state is not None and state.shape != (B, H, p, n):
        raise ValueError(f"ssd: state {tuple(state.shape)}, want "
                         f"{(B, H, p, n)}")
    tensors = (x, Bm, Cm, dt, A, D) + (() if state is None else (state,))
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("ssd: the kernel takes float32 operands")
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssd: operands on different devices")
    if x.stride(-1) != 1 or Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
        raise ValueError("ssd: head and state dims must be contiguous")
    if n not in STATE_SIZES or p > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"ssd: no kernel for state size {n}, head dim {p} (built for "
            f"states {STATE_SIZES}, head dims <= {MAX_HEAD_DIM})")
    A, D = A.contiguous(), D.contiguous()
    state = None if state is None else state.contiguous()
    y = torch.empty((B, S, H, p), dtype=torch.float32, device=x.device)
    state_out = torch.empty((B, H, p, n), dtype=torch.float32,
                            device=x.device)
    strides = (ctypes.c_longlong * 10)(
        *x.stride()[:3], *Bm.stride()[:2], *Cm.stride()[:2], *dt.stride())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher()(
        x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
        A.data_ptr(), D.data_ptr(),
        None if state is None else state.data_ptr(), y.data_ptr(),
        state_out.data_ptr(), B, S, H, p, n, strides, stream)
    if err < 0:
        raise ValueError(f"ssd: the kernel does not take n={n}, p={p}")
    check_launch("ssd", err)
    ssd.launches += 1
    return y, state_out


ssd.launches = 0
