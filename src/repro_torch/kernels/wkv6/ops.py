"""K3 wrapper: the RWKV6 WKV recurrence in the model layout through the
hand-written CUDA kernel (``kernels/csrc/wkv6.cu``, a chunked scan on the
tensor cores).

``wkv6`` takes r/k/v/lw (B,S,H,hd), u (H,hd) and an optional carried state
(B,H,hd,hd), all float32 (the reference casts r/k/v to f32 before the
scan), and returns (out (B,S,H,hd), state_out (B,H,hd,hd)).  A CPU tensor
goes to the plain version (``ref.py``); a CUDA tensor goes to the kernel,
or the call raises — there is no fallback.  ``wkv6.launches`` counts
wrapper calls that ran the kernel; one call issues
``wkv6_plan(...).launches`` CUDA launches (one when a block per (row, head)
walks the chunks; local states, carry and output when the chunks run in
parallel).  The kernel reads the four sequence
operands through their strides, so the wrapper makes no transposed copies;
it allocates the chunk-state scratch the plan names.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.runtime import (check_launch, load_library,
                                         require_ints)
from repro_torch.kernels.wkv6.ref import wkv6_chunked

# tokens per chunk of the kernel, in sub-blocks of SUB_BLOCK
CHUNK = 64
SUB_BLOCK = 16
# head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)
# the H100's SMs
N_SM = 132
_fn = None


class WkvPlan(NamedTuple):
    """How one K3 call is cut: ``chunk`` tokens per chunk, ``n_chunks``
    chunks covering [0, S); ``walk``: one block per (row, head) walks the
    chunks in order with its state in shared memory (one launch), else the
    chunks run in parallel (local states, carry, output: three launches);
    the chunk kernels' grid (heads, chunks, rows), ``launches`` CUDA
    launches, and the f32 scratch shapes (chunk states, per-channel chunk
    decays), or None when it walks."""
    chunk: int
    n_chunks: int
    walk: bool
    grid: Tuple[int, int, int]
    launches: int
    scratch: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]


def wkv6_plan(n_rows: int, seq: int, n_heads: int, hd: int,
              n_sm: int = N_SM) -> WkvPlan:
    """The plan of a K3 call, from sizes alone.  It walks when there is one
    chunk, or when there are at least as many (row, head) pairs as SMs:
    then parallel chunks would add little work in flight and cost the
    chunk states' traffic and a second pass over k, v and lw
    (``scripts/scan_ablation.py plans`` times both on the card)."""
    require_ints(n_rows=n_rows, seq=seq, n_heads=n_heads, hd=hd, n_sm=n_sm)
    n_chunks = max(1, -(-seq // CHUNK))
    walk = n_chunks == 1 or n_rows * n_heads >= n_sm
    scratch = None if walk else (
        (n_rows, n_chunks, n_heads, hd, hd), (n_rows, n_chunks, n_heads, hd))
    return WkvPlan(CHUNK, n_chunks, walk,
                   (n_heads, 1 if walk else n_chunks, n_rows),
                   1 if walk else 3, scratch)


def wkv6_unsupported(*, state=None) -> Optional[str]:
    """Reason the kernel cannot serve a WKV6 call, else None — carried
    state in and out is native, as in the reference's guard."""
    return None


def _launcher():
    global _fn
    if _fn is None:
        fn = load_library("wkv6").wkv6_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
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
    if S < 1:
        raise ValueError("wkv6: empty sequence")
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
    if any(x.data_ptr() % 16 for x in ops) or \
            any(s % 4 for x in ops for s in x.stride()[:-1]):
        raise ValueError(
            "wkv6: the kernel copies r, k, v and lw rows 16 bytes at a time "
            "and needs 16-byte aligned bases and strides (strides "
            f"{[x.stride() for x in ops]})")
    plan = wkv6_plan(B, S, H, hd,
                     torch.cuda.get_device_properties(r.device)
                     .multi_processor_count)
    u = u.contiguous()
    state = None if state is None else state.contiguous()
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    state_out = torch.empty((B, H, hd, hd), dtype=torch.float32,
                            device=r.device)
    scratch = [None, None] if plan.scratch is None else [
        torch.empty(s, dtype=torch.float32, device=r.device)
        for s in plan.scratch]
    strides = (ctypes.c_longlong * 12)(*(s for x in ops
                                         for s in x.stride()[:3]))
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _launcher()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), None if state is None else state.data_ptr(),
        out.data_ptr(), state_out.data_ptr(),
        *(None if t is None else t.data_ptr() for t in scratch),
        B, S, H, hd, int(plan.walk), strides, stream)
    if err < 0:
        raise ValueError(f"wkv6: the kernel does not take hd={hd}")
    check_launch("wkv6", err)
    wkv6.launches += 1
    return out, state_out


wkv6.launches = 0
