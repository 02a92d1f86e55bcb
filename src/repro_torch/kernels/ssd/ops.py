"""K4 wrapper: the Mamba2 SSD scan in the model layout through the
hand-written CUDA kernel (``kernels/csrc/ssd.cu``, a chunked scan on the
tensor cores).

``ssd`` takes x (B,S,H,p), head-shared Bm/Cm (B,S,n), dt (B,S,H), A/D
(H,) and an optional carried state (B,H,p,n), all float32 (the reference
casts x, B and C to f32 before the scan), and returns (y (B,S,H,p),
state_out (B,H,p,n)); ``y`` includes the ``D`` skip.  A CPU tensor goes to
the plain version (``ref.py``); a CUDA tensor goes to the kernel, or the
call raises — there is no fallback.  ``ssd.launches`` counts wrapper calls
that ran the kernel; one call issues ``ssd_plan(...).launches`` CUDA
launches (one for a single chunk; local states, carry and output
otherwise).  The kernel reads x, B, C and dt through their strides, so the
wrapper makes no transposed copies; it allocates the chunk-state scratch
the plan names.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.runtime import (check_launch, load_library,
                                         require_ints)
from repro_torch.kernels.ssd.ref import ssd_chunked

# tokens per chunk of the kernel
CHUNK = 128
# (head dim p, state size n) pairs the kernel is instantiated for
SHAPES = ((16, 16), (32, 128), (64, 32), (64, 64))
# heads that may share one block (and its C B^T); the H100's SMs, which
# hold one block each
MAX_HEADS_PER_BLOCK = 14
N_SM = 132
_fn = None


class SsdPlan(NamedTuple):
    """How one K4 call is cut: ``chunk`` tokens per chunk, ``n_chunks``
    chunks covering [0, S), ``heads_per_block`` heads per block (sharing
    its C B^T), the output kernel's grid (head groups, chunks, rows),
    ``launches`` CUDA launches, and the f32 scratch shapes (chunk states,
    chunk decays), or None for a single chunk."""
    chunk: int
    n_chunks: int
    heads_per_block: int
    grid: Tuple[int, int, int]
    launches: int
    scratch: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]


def ssd_plan(n_rows: int, seq: int, n_heads: int, p: int, n: int,
             n_sm: int = N_SM) -> SsdPlan:
    """The plan of a K4 call, from sizes alone.  ``heads_per_block`` takes
    the least work in waves of one block per SM, a wave costing its heads
    plus about three heads' time for the block's own work: the B/C loads,
    C B^T and the dt cumsums (``scripts/scan_ablation.py plans`` times
    the choices on the card)."""
    require_ints(n_rows=n_rows, seq=seq, n_heads=n_heads, p=p, n=n,
                 n_sm=n_sm)
    n_chunks = max(1, -(-seq // CHUNK))

    def cost(hg):
        blocks = n_rows * n_chunks * -(-n_heads // hg)
        return -(-blocks // n_sm) * (hg + 3), hg

    hg = min(range(1, min(MAX_HEADS_PER_BLOCK, max(n_heads, 1)) + 1),
             key=cost)
    grid = (-(-n_heads // hg), n_chunks, n_rows)
    scratch = None if n_chunks == 1 else (
        (n_rows, n_chunks, n_heads, p, n), (n_rows, n_chunks, n_heads))
    return SsdPlan(CHUNK, n_chunks, hg, grid, 1 if n_chunks == 1 else 3,
                   scratch)


def ssd_unsupported(*, state=None) -> Optional[str]:
    """Reason the kernel cannot serve an SSD call, else None — carried
    state in and out is native, as in the reference's guard."""
    return None


def _launcher():
    global _fn
    if _fn is None:
        fn = load_library("ssd").ssd_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
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
    if S < 1:
        raise ValueError("ssd: empty sequence")
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
    if (p, n) not in SHAPES:
        raise NotImplementedError(
            f"ssd: no kernel for head dim {p}, state size {n} (built for "
            f"(p, n) in {SHAPES})")
    rows = (x, Bm, Cm)
    if any(t.data_ptr() % 16 for t in rows) or \
            any(s % 4 for t in rows for s in t.stride()[:-1]):
        raise ValueError(
            "ssd: the kernel copies x, B and C rows 16 bytes at a time and "
            "needs 16-byte aligned bases and strides (strides x "
            f"{x.stride()} B {Bm.stride()} C {Cm.stride()})")
    plan = ssd_plan(B, S, H, p, n,
                    torch.cuda.get_device_properties(x.device)
                    .multi_processor_count)
    A, D = A.contiguous(), D.contiguous()
    state = None if state is None else state.contiguous()
    y = torch.empty((B, S, H, p), dtype=torch.float32, device=x.device)
    state_out = torch.empty((B, H, p, n), dtype=torch.float32,
                            device=x.device)
    scratch = [None, None] if plan.scratch is None else [
        torch.empty(s, dtype=torch.float32, device=x.device)
        for s in plan.scratch]
    strides = (ctypes.c_longlong * 10)(
        *x.stride()[:3], *Bm.stride()[:2], *Cm.stride()[:2], *dt.stride())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher()(
        x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
        A.data_ptr(), D.data_ptr(),
        None if state is None else state.data_ptr(), y.data_ptr(),
        state_out.data_ptr(),
        *(None if t is None else t.data_ptr() for t in scratch),
        B, S, H, p, n, plan.heads_per_block, strides, stream)
    if err < 0:
        raise ValueError(f"ssd: the kernel does not take n={n}, p={p}")
    check_launch("ssd", err)
    ssd.launches += 1
    return y, state_out


ssd.launches = 0
