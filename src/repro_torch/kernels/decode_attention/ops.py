"""K1 wrapper: model-layout decode attention through the hand-written CUDA
kernel (``kernels/csrc/decode_attention.cu``).

``decode_attention`` takes (B,1,H,Dk) queries over (B,T,Kv,Dk)/(B,T,Kv,Dv)
caches with the reference's masking surface (per-row ``pos``, ``window``,
ALiBi ``slopes``, ``kv_len``, ``scale``).  A CPU tensor goes to the plain
version (``ref.py``); a CUDA tensor goes to the kernel, or the call raises —
there is no fallback.  ``decode_attention.launches`` counts kernel launches.

The kernel reads the caches through their strides in the pool's own
layout, so the wrapper copies nothing but the (B, H, Dk) query.  It splits
the key axis over ``decode_plan(...)`` slices, a pure function of host-known
sizes (never of ``pos`` or ``kv_len``: reading those would sync the host),
and allocates the f32 partials the combine pass merges.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      per_row)
from repro_torch.kernels.runtime import NO_WINDOW, check_launch, load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# blocks the split grid aims at: four 4-warp blocks per SM of the H100's
# 132 (faster on the card than two or eight at a long cache)
TARGET_BLOCKS = 528
# (row, kv-head) pairs that give two blocks per SM alone: no split
FILL_PAIRS = 256
# shared-memory budget of the two-stage K/V ring of one block, so that
# several blocks fit on an SM (228 KB each)
RING_BYTES = 72 * 1024
TILES = (64, 32, 16)
_fn = None


def decode_plan(n_rows: int, n_kv: int, t_len: int, dk: int, dv: int,
                elem_size: int) -> Tuple[int, int, int]:
    """(tile, n_split, chunk) of a K1 launch, from sizes alone.

    ``tile``: keys per shared-memory stage, the largest of ``TILES`` whose
    two-stage ring (K rows padded to an odd count of 16-byte chunks) fits
    ``RING_BYTES``; it shrinks (to 32 at least) while the cache has fewer
    tiles than the wanted splits.  The key axis [0, t_len) is cut into
    ``n_split`` slices of ``chunk`` positions (a multiple of ``tile``; the
    last slice is cut at t_len).  ``n_split`` aims at ``TARGET_BLOCKS``
    blocks over the n_rows * n_kv (row, kv-head) pairs, and is 1 once the
    pairs alone fill the card (``FILL_PAIRS``)."""
    epc = 16 // elem_size
    row = 16 * ((dk // epc | 1) + dv // epc)
    fits = [t for t in TILES if 2 * t * row <= RING_BYTES]
    tile = fits[0] if fits else TILES[-1]
    pairs = max(1, n_rows * n_kv)
    want = 1 if pairs >= FILL_PAIRS else max(1, round(TARGET_BLOCKS / pairs))
    while tile > 32 and -(-t_len // tile) < want:
        tile //= 2
    n_tiles = max(1, -(-t_len // tile))
    per = -(-n_tiles // min(want, n_tiles))
    chunk = per * tile
    return tile, max(1, -(-t_len // chunk)), chunk


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
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                       ctypes.POINTER(ctypes.c_longlong), I, I,
                       ctypes.c_float, I, I, I, P]
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
    es = q.element_size()
    if any(x.data_ptr() % 16 for x in (ck, cv)) or \
            any(d * es % 16 for d in (Dk, Dv)) or \
            any(st * es % 16 for st in ck.stride()[:3] + cv.stride()[:3]):
        raise ValueError(
            "decode_attention: the kernel copies cache rows 16 bytes at a "
            "time and needs 16-byte aligned K/V bases, strides and rows "
            f"(Dk={Dk}, Dv={Dv} of {q.dtype}, strides k {ck.stride()} "
            f"v {cv.stride()})")
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
    tile, n_split, chunk = decode_plan(B, Kv, T, Dk, Dv, es)
    part = [None] * 3
    if n_split > 1:
        part = [torch.empty((n_split, B * H), dtype=torch.float32,
                            device=q.device) for _ in range(2)]
        part.append(torch.empty((n_split, B * H, Dv), dtype=torch.float32,
                                device=q.device))
    scale = 1.0 / math.sqrt(Dk) if scale is None else float(scale)
    win = NO_WINDOW if window is None else int(window)
    strides = (ctypes.c_longlong * 6)(*ck.stride()[:3], *cv.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(
        _DTYPES[q.dtype], qc.data_ptr(), ck.data_ptr(), cv.data_ptr(),
        pos_t.data_ptr(), None if kvl_t is None else kvl_t.data_ptr(),
        None if sl is None else sl.data_ptr(), out.data_ptr(),
        *(None if x is None else x.data_ptr() for x in part),
        B, T, Kv, H // Kv, Dk, Dv, strides, win, int(bool(causal)), scale,
        tile, chunk, n_split, stream)
    if err < 0:
        raise ValueError(f"decode_attention: the kernel does not take "
                         f"Dk={Dk}, Dv={Dv}, G={H // Kv} (G <= 8, "
                         f"G * Dv <= 2048, shared memory)")
    check_launch("decode_attention", err)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
