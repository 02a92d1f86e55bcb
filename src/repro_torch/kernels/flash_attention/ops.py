"""K2 wrapper: model-layout prefill attention through the hand-written CUDA
kernels: bf16 on the tensor cores (``kernels/csrc/flash_attention_sm90.cu``,
``mma.sync`` bf16 with f32 accumulation), f32 on the CUDA cores
(``kernels/csrc/flash_attention.cu``, the parity models' 1e-5 path).

``flash_attention`` takes (B,Sq,H,Dk) queries over unexpanded
(B,Skv,Kv,Dk)/(B,Skv,Kv,Dv) keys/values with the reference's masking
surface (causal/non-causal, ``window``, ALiBi ``slopes``, the chunked-prefill
``q_start``, which the kernel takes at run time) and an optional softmax
``scale`` (default ``1/sqrt(Dk)``).  A CPU tensor goes to the
plain version (``ref.py``); a CUDA tensor goes to the kernel, or the call
raises — there is no fallback.  A meta tensor inside
``runtime.count_meta_calls`` adds the call's ``cost`` and returns an empty
output (the dry run's count); outside it, it raises.
``flash_attention.launches`` counts kernel launches.  The kernels read
q/k/v through their strides, so the wrapper makes no transposed copies.
The dtype picks the kernel (``DESIGNS``); a bf16 call the tensor-core
kernel cannot take raises.  ``cost`` gives a call's bytes and flops.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.runtime import (NO_WINDOW, check_launch,
                                         load_library, meta_calls,
                                         refuse_grad)
from repro_torch.launch.costs import CostSummary, count_weight

# which kernel serves each dtype: the bf16 tensor-core kernel, or the f32
# CUDA-core one
DESIGNS = {torch.bfloat16: "tc-mma.sync", torch.float32: "cuda-core"}
# head dims both kernels are instantiated for (Dk and Dv independently),
# and the extra (Dk, Dv) pairs of each: zamba2's shared attention (224),
# gemma3 (256) and DeepSeek's unabsorbed MLA prefill (nope + rope, nope) in
# bf16 at full width, and the reduced MLA (24, 16) in f32
HEAD_DIMS = (16, 32, 64, 128)
HEAD_DIM_PAIRS = ((224, 224), (256, 256), (192, 128))
HEAD_DIM_PAIRS_F32 = ((224, 224), (24, 16))
_PAIRS = {torch.bfloat16: HEAD_DIM_PAIRS, torch.float32: HEAD_DIM_PAIRS_F32}
_fns = {}


def flash_attention_unsupported(*, causal: bool = True, window=None,
                                slopes=None, q_start: int = 0
                                ) -> Optional[str]:
    """Reason the kernel cannot serve a prefill-attention call, else None —
    the same gaps as the reference's guard."""
    if not causal:
        if window is not None:
            return "sliding-window masking on non-causal attention"
        if q_start:
            return "chunked-prefill q_start offsets on non-causal attention"
        if slopes is not None:
            return "ALiBi slopes on non-causal attention"
    return None


def cost(q, k, v, q_start: int = 0, window=None,
         causal: bool = True, slopes=None) -> CostSummary:
    """Bytes and flops one call needs for these inputs: q and the ALiBi
    slopes read once, the K/V rows the mask reaches read once (causal:
    keys [q_start - window + 1, q_start + Sq) cut to [0, Skv); every key
    when non-causal), out written once; score and P·V flops over the
    causally valid (query, key) pairs (inside the window when there is
    one), or over every pair when non-causal."""
    B, Sq, H, Dk = q.shape
    Skv, Kv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    es = q.element_size()
    w = Skv + Sq if window is None else window
    pairs = Sq * Skv if not causal else causal_pairs(Sq, Skv, q_start, w)
    keys = Skv if not causal else max(
        0, min(Skv, q_start + Sq) - max(0, q_start - w + 1))
    nbytes = (q.numel() + B * keys * Kv * (Dk + Dv) + B * Sq * H * Dv) \
        * es + (0 if slopes is None else 4 * H)
    return CostSummary(flops=2 * B * H * pairs * (Dk + Dv),
                       bytes_accessed=nbytes)


def _sum_min(a: int, n: int, cap: int) -> int:
    """sum(min(a + i, cap) for i in range(n))."""
    k = max(0, min(n, cap - a))  # the terms below the cap
    return k * a + k * (k - 1) // 2 + (n - k) * cap


def causal_pairs(sq: int, skv: int, q_start: int, window: int) -> int:
    """The (query, key) pairs causal attention inside ``window`` reaches:
    ``sum(min(q_start + i + 1, skv) - max(0, q_start + i - window + 1))``
    over the ``sq`` queries, in closed form."""
    b = q_start - window + 1  # the first key of query i is max(0, b + i)
    i0 = min(sq, max(0, 1 - b))  # the queries from i0 on start past key 0
    past = (sq - i0) * b + (sq * (sq - 1) - i0 * (i0 - 1)) // 2
    return _sum_min(q_start + 1, sq, skv) - past


def _launcher(dtype):
    """The C launcher of the kernel that serves ``dtype``."""
    if dtype not in _fns:
        lib, name = ((load_library("flash_attention_sm90"),
                      "flash_attention_tc_launch")
                     if dtype == torch.bfloat16 else
                     (load_library("flash_attention"),
                      "flash_attention_launch"))
        fn = getattr(lib, name)
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I,
                       ctypes.POINTER(ctypes.c_longlong), I, I, I,
                       ctypes.c_float, P]
        fn.restype = I
        _fns[dtype] = fn
    return _fns[dtype]


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    slopes=None, q_start: int = 0,
                    scale: Optional[float] = None):
    """q (B,Sq,H,Dk); k (B,Skv,Kv,Dk); v (B,Skv,Kv,Dv) -> (B,Sq,H,Dv).

    ``window``: optional int.  ``slopes``: optional (H,) f32.  ``q_start``:
    absolute position of the first query (queries [q_start, q_start+Sq)
    over keys [0, Skv)).  ``scale``: the scores' factor (None:
    ``1/sqrt(Dk)``)."""
    reason = flash_attention_unsupported(causal=causal, window=window,
                                         slopes=slopes, q_start=q_start)
    if reason is not None:
        raise ValueError(f"flash_attention does not support {reason}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             slopes=slopes, q_start=q_start, scale=scale)
    refuse_grad("flash_attention (K2)", q, k, v, slopes)
    counting = meta_calls()
    if q.device.type == "meta" and counting is not None:
        counting.cost.scaled_add(cost(q, k, v, q_start, window, causal,
                                      slopes), count_weight())
        return q.new_empty(q.shape[:3] + v.shape[-1:])
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    B, Sq, H, Dk = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    if k.shape != (B, Skv, Kv, Dk) or v.shape[:3] != (B, Skv, Kv):
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if H % Kv:
        raise ValueError(f"flash_attention: {H} heads over {Kv} kv heads")
    if q.dtype not in DESIGNS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes float32 or bfloat16")
    if not ((Dk in HEAD_DIMS and Dv in HEAD_DIMS)
            or (Dk, Dv) in _PAIRS[q.dtype]):
        raise NotImplementedError(
            f"flash_attention: no {q.dtype} kernel for head dims Dk={Dk}, "
            f"Dv={Dv} (built for {HEAD_DIMS} and the pairs "
            f"{_PAIRS[q.dtype]})")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: head dims must be contiguous")
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention: operands on different devices")
    if q.dtype == torch.bfloat16 and (
            any(x.data_ptr() % 16 for x in (q, k, v))
            or any(st % 8 for x in (q, k, v) for st in x.stride()[:3])):
        raise ValueError(
            "flash_attention: the bf16 kernel copies rows 16 bytes at a time "
            "and needs 16-byte aligned q/k/v bases and strides (strides q "
            f"{q.stride()} k {k.stride()} v {v.stride()})")
    sl = None
    if slopes is not None:
        sl = slopes.to(device=q.device, dtype=torch.float32).contiguous()
        if sl.shape != (H,):
            raise ValueError(f"flash_attention: slopes {tuple(sl.shape)}, "
                             f"want ({H},)")
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    win = NO_WINDOW if window is None else int(window)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if sl is None else sl.data_ptr(), out.data_ptr(), B, Sq, Skv,
        H, Kv, Dk, Dv, strides, win, int(bool(causal)), int(q_start),
        1.0 / math.sqrt(Dk) if scale is None else float(scale), stream)
    if err < 0:
        raise ValueError(f"flash_attention: the kernel does not take "
                         f"Dk={Dk}, Dv={Dv}")
    check_launch("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
