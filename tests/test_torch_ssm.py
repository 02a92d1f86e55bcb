"""The port's RWKV6 and Mamba2/zamba2 path against the JAX reference on the
CPU: the plain K3 (WKV6) and K4 (SSD) scans, the mixers, the blocks, and
the monolithic prefill + greedy decode of the reduced ``rwkv6_7b`` and
``zamba2_7b``.

Inputs are made with numpy from a seed and handed to both packages;
weights are the reference's ``init_params(PRNGKey(0), cfg)`` bridged with
``repro_torch.weights.from_reference``.  The scans run here through the
wrappers on CPU tensors, i.e. their plain chunked versions; they are held
against the reference's Pallas kernels in interpret mode and its literal
``*_ref`` recurrences at the reference's own kernel tolerance (atol 1e-4,
rtol 1e-3: the chunked and sequential forms associate the decay products
differently).  Model-level outputs are held at rtol 2e-4 / atol 1e-5.
The CUDA kernels run only on the card (tests/test_torch_gpu.py,
chip_smoke.py); here CPU emulations of their chunk phases, with the
3xTF32 split of their tensor-core products, are held against the same
oracles at the same tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.kernels import ssd as r_ssd
from repro.kernels import ssd_ref as r_ssd_ref
from repro.kernels import wkv6 as r_wkv6
from repro.kernels import wkv6_ref as r_wkv6_ref
from repro.models import NULL_SH
from repro.models import blocks as RB
from repro.models import decode_step as r_decode_step
from repro.models import init_params as r_init_params
from repro.models import prefill as r_prefill
from repro.models import ssm as RS
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.kernels import (ssd, ssd_plan, ssd_recurrence,
                                 ssd_unsupported, wkv6, wkv6_plan,
                                 wkv6_recurrence, wkv6_unsupported)
from repro_torch.kernels.ssd import CHUNK as SSD_CHUNK
from repro_torch.kernels.wkv6 import CHUNK as WKV_CHUNK
from repro_torch.kernels.wkv6 import SUB_BLOCK
from repro_torch.models import blocks as TB
from repro_torch.models import decode_step as t_decode_step
from repro_torch.models import init_params as t_init_params
from repro_torch.models import prefill as t_prefill
from repro_torch.models import ssm as TS
from repro_torch.models.model import layer_params
from repro_torch.weights import from_reference

# tier-1 runs several test processes at once: one torch thread each keeps
# them from oversubscribing the cores (the shapes here are tiny)
torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5
K_RTOL, K_ATOL = 1e-3, 1e-4
# zamba2 through its 7 layers: each block alone agrees to ~5e-6 at |h| ~ 15
# (f32 rounding, 3e-7 of the scale), but the recurrences amplify it across
# layers to ~1.3e-4 on K/V entries of magnitude ~3 and up to ~1e-4 on
# logits of scale ~3.3 (3e-5 of the scale).  The reference's own
# engine-vs-monolithic zamba2 test misses atol 1e-5 the same way (by
# 1.4e-5, ROADMAP C), so zamba2 is held at atol 2e-4 (caches) / 1e-4
# (logits) with the same rtol
CACHE_ATOL = {"rwkv6_7b": ATOL, "zamba2_7b": 2e-4}
LOGIT_ATOL = {"rwkv6_7b": ATOL, "zamba2_7b": 1e-4}
SEQ_LENS = [1, 5, 16, 37, 64, 130]


def close(t, r, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(r),
                               rtol=rtol, atol=atol)


def T(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def bridged(arch):
    cfg = get_reduced_config(arch)
    params, _ = r_init_params(jax.random.PRNGKey(0), cfg)
    tparams = from_reference(jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, t_get_reduced_config(arch), tparams


# ---------------------------------------------------------------------------
# K3: WKV6
# ---------------------------------------------------------------------------


def _wkv_inputs(seed, B, S, H, hd, state=False):
    rng = np.random.RandomState(seed)
    r, k, v = [(rng.randn(B, S, H, hd) * 0.4).astype(np.float32)
               for _ in range(3)]
    lw = np.clip(-np.exp(rng.randn(B, S, H, hd) * 0.5 - 1), -5.0,
                 -1e-4).astype(np.float32)
    u = (rng.randn(H, hd) * 0.3).astype(np.float32)
    s0 = (rng.randn(B, H, hd, hd) * 0.3).astype(np.float32) if state \
        else None
    return r, k, v, lw, u, s0


def _flat(x):
    B, S, H, hd = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, hd)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", SEQ_LENS)
def test_wkv6_plain_vs_reference(S, with_state):
    """The plain chunked K3 equals the reference's Pallas kernel (interpret
    mode) and its literal recurrence, from zeros or a carried state."""
    B, H, hd = 2, 3, 8
    r, k, v, lw, u, s0 = _wkv_inputs(S, B, S, H, hd, with_state)
    out, st = wkv6(*map(T, (r, k, v, lw, u)),
                   None if s0 is None else T(s0))
    ro, rst = r_wkv6(*map(jnp.asarray, (r, k, v, lw, u)),
                     None if s0 is None else jnp.asarray(s0),
                     interpret=True)
    close(out, ro, K_RTOL, K_ATOL)
    close(st, rst, K_RTOL, K_ATOL)
    uf = np.broadcast_to(u[None], (B, H, hd)).reshape(B * H, hd)
    lo, lst = r_wkv6_ref(_flat(r), _flat(k), _flat(v), _flat(lw), uf,
                         None if s0 is None else s0.reshape(B * H, hd, hd))
    close(out, np.asarray(lo).reshape(B, H, S, hd).transpose(0, 2, 1, 3),
          K_RTOL, K_ATOL)
    close(st, np.asarray(lst).reshape(B, H, hd, hd), K_RTOL, K_ATOL)
    # the port's own float64 oracle
    po, pst = wkv6_recurrence(*map(T, (r, k, v, lw, u)),
                              None if s0 is None else T(s0))
    close(out, po, K_RTOL, K_ATOL)
    close(st, pst, K_RTOL, K_ATOL)


def test_wkv6_resume_and_zero_pad_invariance():
    """Splitting a sequence and carrying the state across the split gives
    the one-shot run; trailing zero tokens (k = v = lw = 0) leave the state
    unchanged."""
    r, k, v, lw, u, _ = _wkv_inputs(10, 2, 37, 2, 8)
    args = [T(x) for x in (r, k, v, lw)]
    out, st = wkv6(*args, T(u))
    o1, s1 = wkv6(*[a[:, :13] for a in args], T(u))
    o2, s2 = wkv6(*[a[:, 13:] for a in args], T(u), s1)
    close(torch.cat([o1, o2], 1), out, K_RTOL, K_ATOL)
    close(s2, st, K_RTOL, K_ATOL)
    padded = [torch.cat([a, torch.zeros_like(a[:, :5])], 1) for a in args]
    _, sp = wkv6(*padded, T(u))
    close(sp, st, K_RTOL, K_ATOL)


@pytest.mark.parametrize("lo,hi", [(0, 2), (2, 4), (1, 3)])
def test_wkv6_head_slice_equals_slice_of_whole_call(lo, hi):
    """A device-group slot's call on its head slice (views of the whole
    operands, its heads of the carried state) equals that slice of the
    whole call."""
    r, k, v, lw, u, s0 = _wkv_inputs(21, 2, 70, 4, 8, state=True)
    args = [T(x) for x in (r, k, v, lw)]
    out, st = wkv6(*args, T(u), T(s0))
    o, s = wkv6(*[a[:, :, lo:hi] for a in args], T(u)[lo:hi],
                T(s0)[:, lo:hi])
    np.testing.assert_array_equal(o.numpy(), out[:, :, lo:hi].numpy())
    np.testing.assert_array_equal(s.numpy(), st[:, lo:hi].numpy())


# ---------------------------------------------------------------------------
# K4: SSD
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, B, S, H, p, n, state=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, S, H, p) * 0.4).astype(np.float32)
    Bm = (rng.randn(B, S, n) * 0.4).astype(np.float32)
    Cm = (rng.randn(B, S, n) * 0.4).astype(np.float32)
    dt = (np.abs(rng.randn(B, S, H)) * 0.5 + 0.1).astype(np.float32)
    A = (-np.abs(rng.randn(H)) - 0.2).astype(np.float32)
    D = rng.randn(H).astype(np.float32)
    s0 = (rng.randn(B, H, p, n) * 0.3).astype(np.float32) if state else None
    return x, Bm, Cm, dt, A, D, s0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", SEQ_LENS)
def test_ssd_plain_vs_reference(S, with_state):
    """The plain chunked K4 equals the reference's Pallas kernel (interpret
    mode) and its literal recurrence, from zeros or a carried state."""
    B, H, p, n = 2, 3, 8, 4
    x, Bm, Cm, dt, A, D, s0 = _ssd_inputs(S, B, S, H, p, n, with_state)
    y, st = ssd(*map(T, (x, Bm, Cm, dt, A, D)),
                None if s0 is None else T(s0))
    ry, rst = r_ssd(*map(jnp.asarray, (x, Bm, Cm, dt, A, D)),
                    None if s0 is None else jnp.asarray(s0), interpret=True)
    close(y, ry, K_RTOL, K_ATOL)
    close(st, rst, K_RTOL, K_ATOL)
    xf = _flat(x)
    dtf = dt.transpose(0, 2, 1).reshape(B * H, S)
    Af = np.broadcast_to(A[None], (B, H)).reshape(-1)
    Df = np.broadcast_to(D[None], (B, H)).reshape(-1)
    ly, lst = r_ssd_ref(xf, Bm, Cm, dtf, Af, Df,
                        None if s0 is None else s0.reshape(B * H, p, n))
    close(y, np.asarray(ly).reshape(B, H, S, p).transpose(0, 2, 1, 3),
          K_RTOL, K_ATOL)
    close(st, np.asarray(lst).reshape(B, H, p, n), K_RTOL, K_ATOL)
    py, pst = ssd_recurrence(*map(T, (x, Bm, Cm, dt, A, D)),
                             None if s0 is None else T(s0))
    close(y, py, K_RTOL, K_ATOL)
    close(st, pst, K_RTOL, K_ATOL)


@pytest.mark.parametrize("lo,hi", [(0, 2), (2, 4), (1, 3)])
def test_ssd_head_slice_equals_slice_of_whole_call(lo, hi):
    """K4 on a slot's head slice (x, dt, A, D and the state's heads; B and
    C shared) equals that slice of the whole call."""
    x, Bm, Cm, dt, A, D, s0 = _ssd_inputs(22, 2, 150, 4, 8, 4, state=True)
    y, st = ssd(*map(T, (x, Bm, Cm, dt, A, D)), T(s0))
    ys, ss = ssd(T(x)[:, :, lo:hi], T(Bm), T(Cm), T(dt)[:, :, lo:hi],
                 T(A)[lo:hi], T(D)[lo:hi], T(s0)[:, lo:hi])
    np.testing.assert_array_equal(ys.numpy(), y[:, :, lo:hi].numpy())
    np.testing.assert_array_equal(ss.numpy(), st[:, lo:hi].numpy())


def test_ssd_resume_and_zero_pad_invariance():
    x, Bm, Cm, dt, A, D, _ = _ssd_inputs(11, 2, 300, 2, 8, 4)
    seq = [T(a) for a in (x, Bm, Cm, dt)]
    y, st = ssd(*seq, T(A), T(D))
    y1, s1 = ssd(*[a[:, :131] for a in seq], T(A), T(D))
    y2, s2 = ssd(*[a[:, 131:] for a in seq], T(A), T(D), s1)
    close(torch.cat([y1, y2], 1), y, K_RTOL, K_ATOL)
    close(s2, st, K_RTOL, K_ATOL)
    padded = [torch.cat([a, torch.zeros_like(a[:, :7])], 1) for a in seq]
    _, sp = ssd(*padded, T(A), T(D))
    close(sp, st, K_RTOL, K_ATOL)


@pytest.mark.parametrize("which", ["wkv6", "ssd"])
def test_scan_no_fallback_off_cpu(which):
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel or raises — never silently to the plain path."""
    assert wkv6_unsupported() is None and ssd_unsupported() is None
    before = (wkv6.launches, ssd.launches)
    with pytest.raises(ValueError, match="no kernel for device"):
        if which == "wkv6":
            x = torch.zeros((1, 4, 2, 16), device="meta")
            wkv6(x, x, x, x, torch.zeros((2, 16), device="meta"))
        else:
            x = torch.zeros((1, 4, 2, 16), device="meta")
            b = torch.zeros((1, 4, 16), device="meta")
            dt = torch.zeros((1, 4, 2), device="meta")
            a = torch.zeros((2,), device="meta")
            ssd(x, b, b, dt, a, a)
    assert (wkv6.launches, ssd.launches) == before


# ---------------------------------------------------------------------------
# the CUDA kernels' chunked decompositions, emulated on the CPU
# ---------------------------------------------------------------------------
#
# csrc/wkv6.cu and csrc/ssd.cu run only on the card.  These emulations
# follow their arithmetic phase by phase (chunk-local states, the carry,
# the output; for K3 the sub-block reference points) with every tensor-core
# product as 3xTF32, and are held against the float64 recurrences and the
# reference's Pallas kernels (interpret mode) at the kernels' tolerance.

LOG2E = 1.4426950408889634
EMU_SEQ_LENS = [1, 15, 16, 17, 127, 128, 129, 300]


def _tf32(x):
    """cvt.rna.tf32.f32: f32 rounded to its top 19 bits, half away from
    zero (add half of the dropped part to the magnitude, then cut it)."""
    b = x.contiguous().view(torch.int32)
    mag = ((b & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    return (mag | (b & -0x80000000)).view(torch.float32)


def _mm3(a, b):
    """a @ b as the kernels' 3xTF32 mma.sync: both operands split into
    TF32 hi + lo parts, a_lo b_hi + a_hi b_lo + a_hi b_hi summed in f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _exp2_le0(z):
    return torch.exp2(torch.clamp(z, max=0.0))


def _chunks(x, Q):
    """(B, S, ...) zero-padded to whole chunks -> (B, nc, Q, ...)."""
    pad = (-x.shape[1]) % Q
    x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
    return x.reshape(x.shape[0], -1, Q, *x.shape[2:])


def _carry(s_local, a_chunk, state):
    """start[c] = s; s = a_chunk[c] s + s_local[c] (rows of s scaled)."""
    s = torch.zeros_like(s_local[:, 0]) if state is None else state
    starts = []
    for c in range(s_local.shape[1]):
        starts.append(s)
        s = a_chunk[:, c, ..., None] * s + s_local[:, c]
    return torch.stack(starts, 1), s


def _ssd_emulation(x, Bm, Cm, dt, A, D, state=None):
    """K4 as ssd.cu computes it: chunks of 128, seg in log2 units, local
    states, carry, output with G = C B^T and the masked decay."""
    B, S, H, p = x.shape
    Q = SSD_CHUNK
    xc = _chunks(x, Q).permute(0, 1, 3, 2, 4)  # (B,nc,H,Q,p)
    bc, cc = _chunks(Bm, Q), _chunks(Cm, Q)  # (B,nc,Q,n)
    dtc = _chunks(dt, Q).permute(0, 1, 3, 2)  # (B,nc,H,Q)
    seg = torch.cumsum(dtc * (A * LOG2E)[:, None], dim=-1)
    end = seg[..., -1:]
    w = dtc * _exp2_le0(end - seg)
    s_local = _mm3((xc * w[..., None]).transpose(-1, -2), bc[:, :, None])
    start, s = _carry(s_local, _exp2_le0(end)[..., 0, None], state)
    g = _mm3(cc, bc.transpose(-1, -2))[:, :, None]  # (B,nc,1,Q,Q)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    m = torch.where(mask, g * _exp2_le0(seg[..., :, None] - seg[..., None, :]),
                    0.0)
    y = _mm3(cc[:, :, None] * _exp2_le0(seg)[..., None],
             start.transpose(-1, -2)) + _mm3(m, xc * dtc[..., None])
    y = y + D[:, None, None] * xc
    return y.permute(0, 1, 3, 2, 4).reshape(B, -1, H, p)[:, :S], s


def _wkv6_emulation(r, k, v, lw, u, state=None):
    """K3 as wkv6.cu computes it: chunks of 64 in sub-blocks of 16, seg in
    log2 units; sub-block pairs factored about rho = seg at the last token
    of the earlier block, diagonal sub-blocks per pair in f32; local
    states, carry, output."""
    B, S, H, hd = r.shape
    Q, sub = WKV_CHUNK, SUB_BLOCK
    rc, kc, vc, lc = (_chunks(t, Q).permute(0, 1, 3, 2, 4)
                      for t in (r, k, v, lw))  # (B,nc,H,Q,hd)
    seg = torch.cumsum(lc * LOG2E, dim=-2)
    segx = torch.cat([torch.zeros_like(seg[..., :1, :]), seg[..., :-1, :]],
                     dim=-2)
    end = seg[..., -1:, :]
    amat = torch.zeros(*rc.shape[:-1], Q)
    strict = torch.tril(torch.ones(sub, sub, dtype=torch.bool), -1)
    for J in range(Q // sub):
        tj = slice(sub * J, sub * J + sub)
        for I in range(J):
            ii = slice(sub * I, sub * I + sub)
            rho = seg[..., sub * I + sub - 1: sub * I + sub, :]
            amat[..., tj, ii] = _mm3(
                rc[..., tj, :] * _exp2_le0(segx[..., tj, :] - rho),
                (kc[..., ii, :] * _exp2_le0(rho - seg[..., ii, :]))
                .transpose(-1, -2))
        dec = _exp2_le0(segx[..., tj, None, :] - seg[..., None, tj, :])
        blk = (rc[..., tj, None, :] * kc[..., None, tj, :] * dec).sum(-1)
        bonus = (rc[..., tj, :] * u[:, None, :] * kc[..., tj, :]).sum(-1)
        amat[..., tj, tj] = torch.where(strict, blk, 0.0) + \
            torch.diag_embed(bonus)
    s_local = _mm3((kc * _exp2_le0(end - seg)).transpose(-1, -2), vc)
    start, s = _carry(s_local, _exp2_le0(end[..., 0, :]), state)
    out = _mm3(rc * _exp2_le0(segx), start) + _mm3(amat, vc)
    return out.permute(0, 1, 3, 2, 4).reshape(B, -1, H, hd)[:, :S], s


def test_tf32_split_emulation():
    """The emulated cvt.rna: ties round away from zero at the 10th
    mantissa bit; hi + lo carries ~22 bits of every value."""
    one = 1.0
    vals = torch.tensor([one + 2 ** -11, -(one + 2 ** -11), one + 2 ** -12,
                         one + 3 * 2 ** -12, 2 ** -20 * (one + 2 ** -11)])
    want = torch.tensor([one + 2 ** -10, -(one + 2 ** -10), one,
                         one + 2 ** -10, 2 ** -20 * (one + 2 ** -10)])
    assert torch.equal(_tf32(vals), want)
    x = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32))
    hi = _tf32(x)
    assert bool(((hi - x).abs() <= 2 ** -11 * x.abs()).all())
    lo = _tf32(x - hi)
    assert bool(((hi + lo - x).abs() <= 2 ** -21 * x.abs()).all())


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", EMU_SEQ_LENS)
def test_wkv6_kernel_emulation(S, with_state):
    """K3's chunked two-level decomposition with 3xTF32 products equals the
    float64 recurrence and the reference's Pallas kernel."""
    B, H, hd = 2, 2, 16
    r, k, v, lw, u, s0 = _wkv_inputs(100 + S, B, S, H, hd, with_state)
    out, st = _wkv6_emulation(*map(T, (r, k, v, lw, u)),
                              None if s0 is None else T(s0))
    po, pst = wkv6_recurrence(*map(T, (r, k, v, lw, u)),
                              None if s0 is None else T(s0))
    close(out, po, K_RTOL, K_ATOL)
    close(st, pst, K_RTOL, K_ATOL)
    ro, rst = r_wkv6(*map(jnp.asarray, (r, k, v, lw, u)),
                     None if s0 is None else jnp.asarray(s0),
                     interpret=True)
    close(out, ro, K_RTOL, K_ATOL)
    close(st, rst, K_RTOL, K_ATOL)


@pytest.mark.parametrize("S,with_state", [(17, False), (129, True),
                                          (300, True)])
def test_wkv6_kernel_emulation_deep_decay(S, with_state):
    """lw down to -60 on some channels and -1e-4 on others: every factor of
    the sub-block form stays <= 1, so nothing overflows (no inf or nan)
    and the result holds the oracle's tolerance."""
    B, H, hd = 2, 2, 16
    r, k, v, lw, u, s0 = _wkv_inputs(200 + S, B, S, H, hd, with_state)
    lw = (-60.0 * np.random.RandomState(S).rand(*lw.shape)).astype(
        np.float32)
    lw[..., :4] = -60.0
    lw[..., 4:8] = -1e-4
    out, st = _wkv6_emulation(*map(T, (r, k, v, lw, u)),
                              None if s0 is None else T(s0))
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(st).all())
    po, pst = wkv6_recurrence(*map(T, (r, k, v, lw, u)),
                              None if s0 is None else T(s0))
    close(out, po, K_RTOL, K_ATOL)
    close(st, pst, K_RTOL, K_ATOL)
    ro, rst = r_wkv6(*map(jnp.asarray, (r, k, v, lw, u)),
                     None if s0 is None else jnp.asarray(s0),
                     interpret=True)
    close(out, ro, K_RTOL, K_ATOL)
    close(st, rst, K_RTOL, K_ATOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", EMU_SEQ_LENS)
def test_ssd_kernel_emulation(S, with_state):
    """K4's chunked SSD decomposition with 3xTF32 products equals the
    float64 recurrence and the reference's Pallas kernel."""
    B, H, p, n = 2, 3, 16, 16
    x, Bm, Cm, dt, A, D, s0 = _ssd_inputs(100 + S, B, S, H, p, n,
                                          with_state)
    y, st = _ssd_emulation(*map(T, (x, Bm, Cm, dt, A, D)),
                           None if s0 is None else T(s0))
    py, pst = ssd_recurrence(*map(T, (x, Bm, Cm, dt, A, D)),
                             None if s0 is None else T(s0))
    close(y, py, K_RTOL, K_ATOL)
    close(st, pst, K_RTOL, K_ATOL)
    ry, rst = r_ssd(*map(jnp.asarray, (x, Bm, Cm, dt, A, D)),
                    None if s0 is None else jnp.asarray(s0), interpret=True)
    close(y, ry, K_RTOL, K_ATOL)
    close(st, rst, K_RTOL, K_ATOL)


def test_scan_plans_from_sizes():
    """The wrappers' launch plans are functions of sizes alone (a tensor
    value raises), cover [0, S) with whole chunks, take one launch for one
    chunk and three (local, carry, output) past it, and cover every head."""
    for S in (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 300, 2048):
        wp = wkv6_plan(2, S, 3, 64)
        sp = ssd_plan(2, S, 112, 64, 64)
        for plan, Q in ((wp, WKV_CHUNK), (sp, SSD_CHUNK)):
            assert plan.chunk == Q
            assert (plan.n_chunks - 1) * Q < S <= plan.n_chunks * Q
        # 6 (row, head) pairs, fewer than the SMs: parallel chunks past one
        assert wp.walk == (wp.n_chunks == 1)
        assert sp.launches == (1 if sp.n_chunks == 1 else 3)
        for plan, one in ((wp, wp.walk), (sp, sp.n_chunks == 1)):
            assert plan.launches == (1 if one else 3)
            assert (plan.scratch is None) == one
        assert wp.grid == (3, 1 if wp.walk else wp.n_chunks, 2)
        hg = sp.heads_per_block
        assert sp.grid[1:] == (sp.n_chunks, 2)
        assert (sp.grid[0] - 1) * hg < 112 <= sp.grid[0] * hg <= 112 + hg - 1
        if wp.scratch is not None:
            assert wp.scratch == ((2, wp.n_chunks, 3, 64, 64),
                                  (2, wp.n_chunks, 3, 64))
        if sp.scratch is not None:
            assert sp.scratch == ((2, sp.n_chunks, 112, 64, 64),
                                  (2, sp.n_chunks, 112))
    # the serving path's shapes: K4 in one chunk, seven heads a block; K3's
    # 512 (row, head) pairs, more than the SMs, so each walks its two chunks
    assert ssd_plan(8, 115, 112, 64, 64)[1:4] == (1, 7, (16, 1, 8))
    wp = wkv6_plan(8, 115, 64, 64)
    assert (wp.n_chunks, wp.walk, wp.launches, wp.scratch) == (2, True, 1,
                                                               None)
    # the long row: 64 pairs, 32 chunks in parallel
    wp = wkv6_plan(1, 2048, 64, 64)
    assert (wp.walk, wp.grid, wp.launches) == (False, (64, 32, 1), 3)
    with pytest.raises(TypeError):
        wkv6_plan(2, torch.tensor(5), 3, 64)
    with pytest.raises(TypeError):
        ssd_plan(2, 5, torch.tensor(3), 64, 64)


# ---------------------------------------------------------------------------
# mixers and blocks
# ---------------------------------------------------------------------------


def _rwkv_layer(layer=1):
    cfg, params, tcfg, tparams = bridged("rwkv6_7b")
    p = jax.tree.map(lambda x: x[layer], params["segments"]["blocks"])
    return cfg, p, tcfg, layer_params(tparams["segments"]["blocks"], layer)


def _mamba_layer():
    """A mamba mixer of the mega segment (step 1, block 0)."""
    cfg, params, tcfg, tparams = bridged("zamba2_7b")
    p = jax.tree.map(lambda x: x[1, 0], params["segments"]["mega"]["mamba"])
    tp = layer_params(layer_params(tparams["segments"]["mega"]["mamba"], 1),
                      0)
    return cfg, p, tcfg, tp


@pytest.mark.parametrize("S", [1, 19])
def test_rwkv_time_mix_full_and_decode(S):
    cfg, p, tcfg, tp = _rwkv_layer()
    rng = np.random.RandomState(S)
    x = (rng.randn(2, S, cfg.d_model) * 0.5).astype(np.float32)
    ry, rst = RS.apply_rwkv_tm_full(p["tm"], cfg, NULL_SH, jnp.asarray(x))
    ty, tst = TS.apply_rwkv_tm_full(tp["tm"], tcfg, T(x))
    close(ty, ry)
    close(tst["wkv"], rst["wkv"])
    close(tst["shift"], rst["shift"], 0, 0)
    x1 = (rng.randn(2, 1, cfg.d_model) * 0.5).astype(np.float32)
    ry1, rst1 = RS.apply_rwkv_tm_decode(p["tm"], cfg, NULL_SH,
                                        jnp.asarray(x1), rst)
    ty1, tst1 = TS.apply_rwkv_tm_decode(tp["tm"], tcfg, T(x1), tst)
    close(ty1, ry1)
    close(tst1["wkv"], rst1["wkv"])


def test_rwkv_channel_mix():
    cfg, p, tcfg, tp = _rwkv_layer(0)
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 9, cfg.d_model) * 0.5).astype(np.float32)
    ry, rs = RS.apply_rwkv_cm(p["cm"], cfg, NULL_SH, jnp.asarray(x))
    ty, ts = TS.apply_rwkv_cm(tp["cm"], tcfg, T(x))
    close(ty, ry)
    close(ts, rs, 0, 0)
    ry1, _ = RS.apply_rwkv_cm(p["cm"], cfg, NULL_SH, jnp.asarray(x[:, :1]),
                              shift_state=rs)
    ty1, _ = TS.apply_rwkv_cm(tp["cm"], tcfg, T(x[:, :1]), shift_state=ts)
    close(ty1, ry1)


@pytest.mark.parametrize("S", [1, 3, 24])
def test_mamba_mixer_full_and_decode(S):
    """Prefill (the plain SSD path) and one decode step; the conv tail
    carries the last w-1 inputs (zero-padded under w-1 tokens)."""
    cfg, p, tcfg, tp = _mamba_layer()
    rng = np.random.RandomState(S)
    x = (rng.randn(2, S, cfg.d_model) * 0.5).astype(np.float32)
    ry, rst = RS.apply_mamba_full(p["mixer"], cfg, NULL_SH, jnp.asarray(x))
    ty, tst = TS.apply_mamba_full(tp["mixer"], tcfg, T(x))
    close(ty, ry)
    close(tst["ssm"], rst["ssm"])
    close(tst["conv"], rst["conv"])
    x1 = (rng.randn(2, 1, cfg.d_model) * 0.5).astype(np.float32)
    ry1, rst1 = RS.apply_mamba_decode(p["mixer"], cfg, NULL_SH,
                                      jnp.asarray(x1), rst)
    ty1, tst1 = TS.apply_mamba_decode(tp["mixer"], tcfg, T(x1), tst)
    close(ty1, ry1)
    close(tst1["ssm"], rst1["ssm"])
    close(tst1["conv"], rst1["conv"])


def test_rwkv_and_mamba_blocks():
    cfg, p, tcfg, tp = _rwkv_layer()
    rng = np.random.RandomState(5)
    h = (rng.randn(1, 11, cfg.d_model) * 0.5).astype(np.float32)
    rh, rst = RB.rwkv_block_full(p, cfg, NULL_SH, jnp.asarray(h))
    th, tst = TB.rwkv_block_full(tp, tcfg, T(h))
    close(th, rh)
    assert set(tst) == set(rst) == {"wkv", "shift_tm", "shift_cm"}
    h1 = (rng.randn(1, 1, cfg.d_model) * 0.5).astype(np.float32)
    rh1, _ = RB.rwkv_block_decode(p, cfg, NULL_SH, jnp.asarray(h1), rst)
    th1, _ = TB.rwkv_block_decode(tp, tcfg, T(h1), tst)
    close(th1, rh1)
    cfg, p, tcfg, tp = _mamba_layer()
    rh, rst = RB.mamba_block_full(p, cfg, NULL_SH, jnp.asarray(h))
    th, tst = TB.mamba_block_full(tp, tcfg, T(h))
    close(th, rh)
    rh1, _ = RB.mamba_block_decode(p, cfg, NULL_SH, jnp.asarray(h1), rst)
    th1, _ = TB.mamba_block_decode(tp, tcfg, T(h1), tst)
    close(th1, rh1)


def test_zamba_shared_full_and_decode():
    """The shared attention+MLP on concat(h, emb0) at width 2*d_model, then
    one decode token with its K/V written in place at ``pos``."""
    cfg, params, tcfg, tparams = bridged("zamba2_7b")
    rng = np.random.RandomState(6)
    S, Tc = 10, 14
    h = (rng.randn(1, S, cfg.d_model) * 0.5).astype(np.float32)
    e0 = (rng.randn(1, S, cfg.d_model) * 0.5).astype(np.float32)
    pos = np.arange(S)
    rh, rkv = RB.zamba_shared_full(params["shared"], cfg, NULL_SH,
                                   jnp.asarray(h), jnp.asarray(e0),
                                   jnp.asarray(pos))
    th, tkv = TB.zamba_shared_full(tparams["shared"], tcfg, T(h), T(e0),
                                   T(pos))
    close(th, rh)
    close(tkv["k"], rkv["k"])
    ck = np.zeros((1, Tc, cfg.n_kv_heads, cfg.head_dim), np.float32)
    cv = np.zeros_like(ck)
    ck[:, :S], cv[:, :S] = np.asarray(rkv["k"]), np.asarray(rkv["v"])
    h1 = (rng.randn(1, 1, cfg.d_model) * 0.5).astype(np.float32)
    e1 = (rng.randn(1, 1, cfg.d_model) * 0.5).astype(np.float32)
    rh1, rc1 = RB.zamba_shared_decode(
        params["shared"], cfg, NULL_SH, jnp.asarray(h1), jnp.asarray(e1),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, S)
    cache = {"k": T(ck), "v": T(cv)}
    th1, _ = TB.zamba_shared_decode(tparams["shared"], tcfg, T(h1), T(e1),
                                    cache, T(np.array([S])))
    close(th1, rh1)
    close(cache["k"], rc1["k"])
    close(cache["v"], rc1["v"])


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------


def test_stack_kinds_and_plan_match_reference():
    from repro.models import stack_block_kinds as r_kinds
    from repro.models import stack_plan as r_plan
    from repro_torch.models import stack_block_kinds as t_kinds
    from repro_torch.models import stack_plan as t_plan

    for arch in ("rwkv6_7b", "zamba2_7b"):
        for reduced in (True, False):
            cfg = get_reduced_config(arch)
            tcfg = t_get_reduced_config(arch)
            if not reduced:
                from repro.configs import get_config
                from repro_torch.configs import get_config as t_get_config
                cfg, tcfg = get_config(arch), t_get_config(arch)
            assert t_kinds(tcfg) == r_kinds(cfg)
            assert [(s.name, s.kind, s.n, s.blocks_per_step)
                    for s in t_plan(tcfg)] == \
                [(s.name, s.kind, s.n, s.blocks_per_step)
                 for s in r_plan(cfg)]


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_7b"])
def test_init_params_matches_reference_tree(arch):
    """The torch init gives the reference's tree, shapes and dtypes
    (nested (n_mega, per, ...) mamba leaves and ``params["shared"]``)."""
    cfg, params, tcfg, _ = bridged(arch)
    tp = t_init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))[0])
    assert {jax.tree_util.keystr(k) for k, _ in ref} == \
        {jax.tree_util.keystr(k) for k in got}
    for path, leaf in ref:
        g = got[path]
        assert g.shape == leaf.shape and g.dtype == leaf.dtype, path


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_7b"])
def test_prefill_and_decode_steps(arch):
    """Monolithic prompt + 5 greedy decode steps: logits within tolerance
    at every step, identical greedy tokens, the recurrent caches equal."""
    cfg, params, tcfg, tparams = bridged(arch)
    rng = np.random.RandomState(10)
    toks = rng.randint(2, cfg.vocab_size, (2, 19))
    cache_len = 19 + 6
    rl, rcache = r_prefill(params, cfg, NULL_SH,
                           {"tokens": jnp.asarray(toks)}, cache_len=cache_len)
    tl, tcache = t_prefill(tparams, tcfg, {"tokens": T(toks)},
                           cache_len=cache_len)
    close(tl, rl, atol=LOGIT_ATOL[arch])
    flat_r = dict(jax.tree_util.tree_flatten_with_path(rcache)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tcache))[0])
    assert flat_r.keys() == flat_t.keys()
    for path in flat_r:
        close(T(flat_t[path]), flat_r[path], atol=CACHE_ATOL[arch])
    nxt = np.asarray(jnp.argmax(rl, -1))
    assert (tl.argmax(-1).numpy() == nxt).all()
    for i in range(5):
        rl, rcache = r_decode_step(params, cfg, NULL_SH, rcache,
                                   jnp.asarray(nxt), 19 + i)
        tl, tcache = t_decode_step(tparams, tcfg, tcache, T(nxt), 19 + i)
        close(tl, rl, atol=LOGIT_ATOL[arch])
        nxt = np.asarray(jnp.argmax(rl, -1))
        assert (tl.argmax(-1).numpy() == nxt).all()


def test_block_param_range_views_and_boundary_copy():
    """Hybrid ranges inside the mega segment or the tail are views of the
    stacked leaves (replicas share one copy); a range across the boundary
    copies just that range; every range equals the reference's."""
    from repro.models.model import block_param_range as r_range
    from repro_torch.models import block_param_range, hybrid_mamba_stack

    cfg, params, tcfg, tparams = bridged("zamba2_7b")  # 7 = 2 x 3 + 1
    mega = tparams["segments"]["mega"]["mamba"]["mixer"]["wz"]
    v = block_param_range(tparams, tcfg, "mamba", 1, 5)["mixer"]["wz"]
    assert v.untyped_storage().data_ptr() == \
        mega.untyped_storage().data_ptr()
    assert v.data_ptr() == mega[0, 1].data_ptr()
    tail = tparams["segments"]["tail"]["mixer"]["wz"]
    v = block_param_range(tparams, tcfg, "mamba", 6, 7)["mixer"]["wz"]
    assert v.data_ptr() == tail.data_ptr()
    for lo, hi in [(0, 3), (2, 3), (3, 6), (6, 7), (4, 7), (0, 7)]:
        got = block_param_range(tparams, tcfg, "mamba", lo, hi)
        ref = r_range(params, cfg, "mamba", lo, hi)
        for g, r in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                     got)),
                        jax.tree.leaves(ref)):
            np.testing.assert_array_equal(g, np.asarray(r))
    assert hybrid_mamba_stack(tparams, tcfg)["mixer"]["wz"].shape[0] == 7
    rw = block_param_range(bridged("rwkv6_7b")[3], t_get_reduced_config(
        "rwkv6_7b"), "rwkv", 1, 2)["tm"]["wr"]
    assert rw.data_ptr() == \
        bridged("rwkv6_7b")[3]["segments"]["blocks"]["tm"]["wr"][1].data_ptr()
