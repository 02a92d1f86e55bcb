"""K1 wrapper: model-layout decode attention through the hand-written CUDA
kernel (``kernels/csrc/decode_attention.cu``).

``decode_attention`` takes (B,1,H,Dk) queries over (B,T,Kv,Dk)/(B,T,Kv,Dv)
caches with the reference's masking surface (per-row ``pos``, ``window``,
ALiBi ``slopes``, ``kv_len``, ``scale``).  A CPU tensor goes to the plain
version (``ref.py``); a CUDA tensor goes to the kernel, or the call raises —
there is no fallback.  ``decode_attention.launches`` counts kernel launches.

The kernel reads the caches through their strides in the pool's own
layout, so the wrapper copies nothing but the (B, H, Dk) query.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      per_row)
from repro_torch.kernels.runtime import NO_WINDOW, check_launch, load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def decode_attention_unsupported(*, causal: bool = True, window=None,
                                 slopes=None, kv_len=None,
                                 scale=None) -> Optional[str]:
    """Reason the kernel cannot serve a decode-attention call, else None —
    the same gap as the reference's guard."""
    if window is not None and not causal:
        return ("sliding-window masking on non-causal (cross) decode "
                "attention")
    return None


def _launcher():
    global _fn
    if _fn is None:
        fn = load_library("decode_attention").decode_attention_launch
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [I, P, P, P, P, P, P, P, I, I, I, I, I, I,
                       L, L, L, L, L, L, I, I, ctypes.c_float, P]
        fn.restype = I
        _fn = fn
    return _fn


def decode_attention(q, ck, cv, pos, *, window=None, slopes=None,
                     kv_len=None, causal: bool = True,
                     scale: Optional[float] = None):
    """q (B,1,H,Dk); ck (B,T,Kv,Dk); cv (B,T,Kv,Dv) -> (B,1,H,Dv).

    ``pos``/``kv_len``: int or (B,) integer tensor.  ``window``: optional
    int.  ``slopes``: optional (H,) f32.  ``scale``: optional softmax scale
    (default 1/sqrt(Dk))."""
    reason = decode_attention_unsupported(causal=causal, window=window,
                                          slopes=slopes, kv_len=kv_len,
                                          scale=scale)
    if reason is not None:
        raise ValueError(f"decode_attention does not support {reason}")
    if q.device.type == "cpu":
        return decode_attention_ref(q, ck, cv, pos, window=window,
                                    slopes=slopes, kv_len=kv_len,
                                    causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    B, one, H, Dk = q.shape
    T, Kv = ck.shape[1], ck.shape[2]
    Dv = cv.shape[-1]
    if one != 1 or ck.shape != (B, T, Kv, Dk) or cv.shape[:3] != (B, T, Kv):
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(ck.shape)} v {tuple(cv.shape)}")
    if H % Kv:
        raise ValueError(f"decode_attention: {H} heads over {Kv} kv heads")
    if q.dtype not in _DTYPES or ck.dtype != q.dtype or cv.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}/{ck.dtype}/"
                         f"{cv.dtype}; the kernel takes float32 or bfloat16")
    if ck.stride(-1) != 1 or cv.stride(-1) != 1:
        raise ValueError("decode_attention: cache head dim must be "
                         "contiguous")
    if not (ck.device == cv.device == q.device):
        raise ValueError("decode_attention: operands on different devices")
    qc = q.reshape(B, H, Dk).contiguous()
    pos_t = per_row(pos, B, q.device)
    kvl_t = None if kv_len is None else per_row(kv_len, B, q.device)
    sl = None
    if slopes is not None:
        sl = slopes.to(device=q.device, dtype=torch.float32).contiguous()
        if sl.shape != (H,):
            raise ValueError(f"decode_attention: slopes {tuple(sl.shape)}, "
                             f"want ({H},)")
    out = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=q.device)
    scale = 1.0 / math.sqrt(Dk) if scale is None else float(scale)
    win = NO_WINDOW if window is None else int(window)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(
        _DTYPES[q.dtype], qc.data_ptr(), ck.data_ptr(), cv.data_ptr(),
        pos_t.data_ptr(), None if kvl_t is None else kvl_t.data_ptr(),
        None if sl is None else sl.data_ptr(), out.data_ptr(),
        B, T, Kv, H // Kv, Dk, Dv, *ck.stride()[:3], *cv.stride()[:3],
        win, int(bool(causal)), scale, stream)
    if err < 0:
        raise ValueError(f"decode_attention: the kernel does not take "
                         f"Dk={Dk}, Dv={Dv}, G={H // Kv} (shared memory)")
    check_launch("decode_attention", err)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
