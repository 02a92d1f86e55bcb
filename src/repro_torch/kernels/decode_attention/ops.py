"""K1 wrapper: model-layout decode attention through the hand-written CUDA
kernel (``kernels/csrc/decode_attention.cu``).

``decode_attention`` takes (B,1,H,Dk) queries over (B,T,Kv,Dk)/(B,T,Kv,Dv)
caches with the reference's masking surface (per-row ``pos``, ``window``,
ALiBi ``slopes``, ``kv_len``, ``scale``).  A CPU tensor goes to the plain
version (``ref.py``); a CUDA tensor goes to the kernel, or the call raises —
there is no fallback.  ``decode_attention.launches`` counts kernel launches.

The kernel reads the caches through their strides in the pool's own
layout, so the wrapper copies nothing but the (B, H, Dk) query (absorbed
MLA decode passes the joint latent buffer as the keys and its latent
columns as the values).  A kv head's G query heads run in groups of
``head_group(G, Dv)`` heads, one block each; the wrapper splits the key
axis over ``decode_plan(...)`` slices.  Both are pure functions of
host-known sizes (never of ``pos`` or ``kv_len``: reading those would sync
the host).  The wrapper allocates the f32 partials the combine pass
merges.  ``cost`` gives a call's bytes and flops (the kernel rows'
bounds, and the attention share of ``BlockServer.decode_step_cost``,
which runs its step on meta tensors inside
``runtime.count_meta_calls``).

A device group whose slots hold time shards of the cache runs the split
kernel alone on each slot: ``decode_attention_partials`` returns the
slot's f32 split partials over its shard (first key at global position
``t0``; the plan from the shard's own length), and ``merge_partials``
runs the combine kernel over the slots' partials concatenated in slot
order.  Each has its own launch counter; ``merge_cost`` prices a merge.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.decode_attention.ref import (
    decode_attention_partials_ref, decode_attention_ref, merge_partials_ref,
    per_row)
from repro_torch.kernels.runtime import (NO_WINDOW, check_launch,
                                         load_library, meta_calls,
                                         refuse_grad)
from repro_torch.launch.costs import CostSummary, count_weight

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
# query heads one block owns: the kernel keeps g <= 8 score rows and
# g * Dv / 2 output pairs over its 128 threads (8 each)
MAX_GROUP = 8
MAX_GROUP_DV = 2048
_fn = None


def head_group(group: int, dv: int) -> int:
    """Query heads per block: the largest divisor g of the kv head's
    ``group`` heads with g <= 8 and g * Dv <= 2048 (all of them up to G = 8
    at Dv <= 256; 4 of MLA's 128 at Dv = 512).  0 when none fits."""
    return max((g for g in range(1, min(group, MAX_GROUP) + 1)
                if group % g == 0 and g * dv <= MAX_GROUP_DV), default=0)


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
    pairs alone fill the card (``FILL_PAIRS``).  With head groups
    (``head_group``) the wrapper passes rows x groups as ``n_rows``."""
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


def _rows(x, n: int):
    """A scalar or per-row integer operand as n host ints (a tensor on the
    card is read to the host)."""
    v = x.tolist() if hasattr(x, "tolist") else x
    return [int(v)] * n if isinstance(v, int) else [int(a) for a in v]


def _root(x):
    return x if x._base is None else x._base


def cost(q, ck, cv, pos, *, window=None, kv_len=None,
         causal: bool = True, slopes=None, t0: int = 0,
         n_split: Optional[int] = None) -> CostSummary:
    """Bytes and flops one call needs for these inputs: the query, each
    K/V row the mask reaches (data dependent: per row from ``pos``, or
    from ``kv_len`` alone for non-causal cross attention), the output, the
    positions and the ALiBi slopes; the score and P·V products over the
    reached rows.
    Values that are columns of the keys' rows (absorbed MLA decode) are
    bytes already counted with the keys.  ``pos`` / ``kv_len``: an int or
    per-row values (global).  A partials call (``n_split``: its splits) is
    over a shard whose first key sits at ``t0`` and writes its f32
    partials in place of the output."""
    B, _, H, Dk = q.shape
    T, Kv, Dv = ck.shape[1], ck.shape[2], cv.shape[-1]
    es = q.element_size()
    v_bytes = 0 if cv.data_ptr() == ck.data_ptr() and \
        _root(cv) is _root(ck) else Dv
    kvl = [t0 + T] * B if kv_len is None else _rows(kv_len, B)
    rows = 0
    for p, kl in zip(_rows(pos, B), kvl):
        hi = min(p + 1, kl, t0 + T) if causal else min(kl, t0 + T)
        lo = 0 if window is None or not causal else max(0, p - window + 1)
        rows += max(hi - max(lo, t0), 0)
    out_bytes = B * H * Dv * es if n_split is None \
        else 4 * n_split * B * H * (Dv + 2)
    nbytes = B * H * Dk * es + out_bytes \
        + rows * Kv * (Dk + v_bytes) * es + 4 * B \
        + (0 if slopes is None else 4 * H)
    return CostSummary(flops=2 * rows * H * (Dk + Dv), bytes_accessed=nbytes)


def merge_cost(n_parts: int, n_heads_all: int, dv: int,
               elem_size: int) -> CostSummary:
    """Bytes and flops of one merge: the f32 partials (m, l, acc) of
    ``n_parts`` splits over ``n_heads_all`` (row, head) pairs read once,
    the output written once; a rescale and an add per partial element."""
    return CostSummary(
        flops=3 * n_parts * n_heads_all * (dv + 1),
        bytes_accessed=4 * n_parts * n_heads_all * (dv + 2)
        + n_heads_all * dv * elem_size)


def _launcher():
    global _fn
    if _fn is None:
        lib = load_library("decode_attention")
        fn = lib.decode_attention_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                       I, ctypes.POINTER(ctypes.c_longlong), I, I,
                       ctypes.c_float, I, I, I, P]
        fn.restype = I
        merge = lib.decode_merge_launch
        merge.argtypes = [I, P, P, P, P, I, I, I, P]
        merge.restype = I
        _fn = (fn, merge)
    return _fn


def _plan(q, ck, cv):
    """(head group g, (tile, n_split, chunk)) of a call, from sizes."""
    B, _, H, Dk = q.shape
    T, Kv, Dv = ck.shape[1], ck.shape[2], cv.shape[-1]
    G = H // Kv
    g = head_group(G, Dv)
    # (row, head-group) pairs play the rows of the split plan
    return g, decode_plan(B * (G // max(g, 1)), Kv, T, Dk, Dv,
                          q.element_size())


def _check(name, q, ck, cv, causal, window, slopes, kv_len, scale):
    reason = decode_attention_unsupported(causal=causal, window=window,
                                          slopes=slopes, kv_len=kv_len,
                                          scale=scale)
    if reason is not None:
        raise ValueError(f"{name} does not support {reason}")


def _check_cuda(name, q, ck, cv, slopes):
    """The kernel's operand checks; returns the head group."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    B, one, H, Dk = q.shape
    T, Kv = ck.shape[1], ck.shape[2]
    Dv = cv.shape[-1]
    if one != 1 or ck.shape != (B, T, Kv, Dk) or cv.shape[:3] != (B, T, Kv):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(ck.shape)} v {tuple(cv.shape)}")
    if H % Kv:
        raise ValueError(f"{name}: {H} heads over {Kv} kv heads")
    if q.dtype not in _DTYPES or ck.dtype != q.dtype or cv.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{ck.dtype}/"
                         f"{cv.dtype}; the kernel takes float32 or bfloat16")
    if ck.stride(-1) != 1 or cv.stride(-1) != 1:
        raise ValueError(f"{name}: cache head dim must be contiguous")
    es = q.element_size()
    if any(x.data_ptr() % 16 for x in (ck, cv)) or \
            any(d * es % 16 for d in (Dk, Dv)) or \
            any(st * es % 16 for st in ck.stride()[:3] + cv.stride()[:3]):
        raise ValueError(
            f"{name}: the kernel copies cache rows 16 bytes at a "
            "time and needs 16-byte aligned K/V bases, strides and rows "
            f"(Dk={Dk}, Dv={Dv} of {q.dtype}, strides k {ck.stride()} "
            f"v {cv.stride()})")
    if not (ck.device == cv.device == q.device):
        raise ValueError(f"{name}: operands on different devices")
    if slopes is not None and tuple(slopes.shape) != (H,):
        raise ValueError(f"{name}: slopes {tuple(slopes.shape)}, "
                         f"want ({H},)")
    G = H // Kv
    g = head_group(G, Dv)
    if g == 0:
        raise ValueError(f"{name}: no head group of {G} heads at "
                         f"Dv={Dv} fits a block (g <= {MAX_GROUP}, g * Dv "
                         f"<= {MAX_GROUP_DV})")
    return g


def _launch(name, q, ck, cv, pos, kv_len, slopes, out, part, g, plan,
            window, causal, scale, t0):
    B, _, H, Dk = q.shape
    T, Kv, Dv = ck.shape[1], ck.shape[2], cv.shape[-1]
    tile, n_split, chunk = plan
    qc = q.reshape(B, H, Dk).contiguous()
    pos_t = per_row(pos, B, q.device)
    kvl_t = None if kv_len is None else per_row(kv_len, B, q.device)
    sl = None if slopes is None else slopes.to(
        device=q.device, dtype=torch.float32).contiguous()
    scale = 1.0 / math.sqrt(Dk) if scale is None else float(scale)
    win = NO_WINDOW if window is None else int(window)
    strides = (ctypes.c_longlong * 6)(*ck.stride()[:3], *cv.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    G = H // Kv
    err = _launcher()[0](
        _DTYPES[q.dtype], qc.data_ptr(), ck.data_ptr(), cv.data_ptr(),
        pos_t.data_ptr(), None if kvl_t is None else kvl_t.data_ptr(),
        None if sl is None else sl.data_ptr(),
        None if out is None else out.data_ptr(),
        *(None if x is None else x.data_ptr() for x in part),
        B, T, int(t0), Kv, g, G // g, Dk, Dv, strides, win,
        int(bool(causal)), scale, tile, chunk, n_split, stream)
    if err < 0:
        raise ValueError(f"{name}: the kernel does not take "
                         f"Dk={Dk}, Dv={Dv}, {g} heads a block (shared "
                         "memory)")
    check_launch(name, err)


def decode_attention(q, ck, cv, pos, *, window=None, slopes=None,
                     kv_len=None, causal: bool = True,
                     scale: Optional[float] = None):
    """q (B,1,H,Dk); ck (B,T,Kv,Dk); cv (B,T,Kv,Dv) -> (B,1,H,Dv).

    ``pos``/``kv_len``: int or (B,) integer tensor.  ``window``: optional
    int.  ``slopes``: optional (H,) f32.  ``scale``: optional softmax scale
    (default 1/sqrt(Dk))."""
    _check("decode_attention", q, ck, cv, causal, window, slopes, kv_len,
           scale)
    if q.device.type == "cpu":
        return decode_attention_ref(q, ck, cv, pos, window=window,
                                    slopes=slopes, kv_len=kv_len,
                                    causal=causal, scale=scale)
    refuse_grad("decode_attention (K1)", q, ck, cv, slopes)
    counting = meta_calls()
    if q.device.type == "meta" and counting is not None:
        counting.cost.scaled_add(cost(
            q, ck, cv, counting.pos, window=window, causal=causal,
            kv_len=None if kv_len is None else counting.kv_len,
            slopes=slopes), count_weight())
        n_split = _plan(q, ck, cv)[1][1]
        part = _partials(n_split, q.shape[0] * q.shape[2], cv.shape[-1],
                         q.device) if n_split > 1 else None  # as launched
        out = q.new_empty(q.shape[:3] + cv.shape[-1:])
        del part
        return out
    g = _check_cuda("decode_attention", q, ck, cv, slopes)
    B, _, H, _ = q.shape
    Dv = cv.shape[-1]
    out = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=q.device)
    _, plan = _plan(q, ck, cv)
    n_split = plan[1]
    part = [None] * 3
    if n_split > 1:
        part = _partials(n_split, B * H, Dv, q.device)
    _launch("decode_attention", q, ck, cv, pos, kv_len, slopes, out, part,
            g, plan, window, causal, scale, 0)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def _partials(n_split: int, n_heads_all: int, dv: int, device):
    f32 = torch.float32
    return [torch.empty((n_split, n_heads_all), dtype=f32, device=device),
            torch.empty((n_split, n_heads_all), dtype=f32, device=device),
            torch.empty((n_split, n_heads_all, dv), dtype=f32,
                        device=device)]


def decode_attention_partials(q, ck, cv, pos, *, t0: int = 0, window=None,
                              slopes=None, kv_len=None, causal: bool = True,
                              scale: Optional[float] = None):
    """The split kernel of K1 alone over a cache shard: q (B,1,H,Dk) over
    ck (B,T,Kv,Dk) / cv (B,T,Kv,Dv), whose first key sits at global
    position ``t0`` (``pos`` / ``kv_len`` global), -> the f32 partials of
    its ``decode_plan`` splits over T: (m (S,B,H), l (S,B,H), acc
    (S,B,H,Dv)).  A split (or a whole shard) the mask does not reach is an
    empty partial (m = -1e30, l = 0, acc = 0)."""
    _check("decode_attention_partials", q, ck, cv, causal, window, slopes,
           kv_len, scale)
    _, plan = _plan(q, ck, cv)
    B, _, H, _ = q.shape
    Dv = cv.shape[-1]
    n_split = plan[1]
    if q.device.type == "cpu":
        return decode_attention_partials_ref(
            q, ck, cv, pos, t0=t0, window=window, slopes=slopes,
            kv_len=kv_len, causal=causal, scale=scale, chunk=plan[2])
    refuse_grad("decode_attention_partials (K1)", q, ck, cv, slopes)
    counting = meta_calls()
    if q.device.type == "meta" and counting is not None:
        counting.cost.scaled_add(cost(
            q, ck, cv, counting.pos, window=window, causal=causal,
            kv_len=None if kv_len is None else counting.kv_len,
            slopes=slopes, t0=t0, n_split=n_split), count_weight())
        m, l, acc = _partials(n_split, B * H, Dv, q.device)
        return (m.view(n_split, B, H), l.view(n_split, B, H),
                acc.view(n_split, B, H, Dv))
    g = _check_cuda("decode_attention_partials", q, ck, cv, slopes)
    m, l, acc = _partials(n_split, B * H, Dv, q.device)
    _launch("decode_attention_partials", q, ck, cv, pos, kv_len, slopes,
            None, (m, l, acc), g, plan, window, causal, scale, t0)
    decode_attention_partials.launches += 1
    return (m.view(n_split, B, H), l.view(n_split, B, H),
            acc.view(n_split, B, H, Dv))


decode_attention_partials.launches = 0


def merge_partials(parts, dtype=torch.float32):
    """The combine kernel of K1 over a group's partials: ``parts`` a list
    of (m, l, acc) triples (``decode_attention_partials``'s), in slot
    order, concatenated along the split axis and merged in that order ->
    (B,1,H,Dv) of ``dtype``."""
    m = torch.cat([p[0] for p in parts]) if len(parts) > 1 else parts[0][0]
    l = torch.cat([p[1] for p in parts]) if len(parts) > 1 else parts[0][1]
    acc = torch.cat([p[2] for p in parts]) if len(parts) > 1 \
        else parts[0][2]
    S, B, H, Dv = acc.shape
    if m.device.type == "cpu":
        return merge_partials_ref(m, l, acc, dtype)
    counting = meta_calls()
    if m.device.type == "meta" and counting is not None:
        counting.cost.scaled_add(merge_cost(
            S, B * H, Dv, torch.empty((), dtype=dtype).element_size()),
            count_weight())
        return acc.new_empty((B, 1, H, Dv), dtype=dtype)
    if m.device.type != "cuda":
        raise ValueError(f"merge_partials: no kernel for device {m.device}")
    if dtype not in _DTYPES or any(x.dtype != torch.float32
                                   for x in (m, l, acc)):
        raise ValueError(f"merge_partials: f32 partials into float32 or "
                         f"bfloat16, not {dtype}")
    if m.shape != (S, B, H) or l.shape != (S, B, H) or \
            not (m.device == l.device == acc.device):
        raise ValueError("merge_partials: partials of mismatched shapes or "
                         "devices")
    m, l, acc = m.contiguous(), l.contiguous(), acc.contiguous()
    out = torch.empty((B, 1, H, Dv), dtype=dtype, device=m.device)
    stream = torch.cuda.current_stream(m.device).cuda_stream
    err = _launcher()[1](_DTYPES[dtype], m.data_ptr(), l.data_ptr(),
                         acc.data_ptr(), out.data_ptr(), B * H, S, Dv,
                         stream)
    if err < 0:
        raise ValueError(f"merge_partials: the kernel does not take "
                         f"{S} partials of Dv={Dv}")
    check_launch("merge_partials", err)
    merge_partials.launches += 1
    return out


merge_partials.launches = 0
