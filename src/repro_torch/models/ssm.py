"""State-space sequence mixers: Mamba2 (SSD) and RWKV6 (Finch) time/channel
mix — the counterpart of the reference's ``repro/models/ssm.py``.

Full-sequence paths (prefill) run the scan through the hand-written kernels
on CUDA tensors under ``backend="kernel"`` (K3 ``kernels.wkv6``, K4
``kernels.ssd``) and through their plain chunked versions otherwise (the
reference's default ``backend="xla"`` path).  Projections, token shift,
the depthwise conv and gating are plain PyTorch either way.  Decode paths
are single-step recurrences over carried state, elementwise, with no
kernel, as in the reference.

State-dict key names are a SERVING CONTRACT: the serving pools
(``repro_torch.serving.kv_cache``) write ``ssm``, ``conv``, ``wkv`` and
``shift*`` whole (recurrent state) and ``k``/``v`` per position.  Keep
the reference's names.

Host data: every constant here is built on the input's device (``torch.
ones``/``zeros`` fills, ``linspace`` at init), so the prefill and decode
paths make no host-to-device copy, which would sync the stream.

``*_group`` forms run a mixer on the slots of a device group
(``layers.GroupCtx``; per-slot lists in slot order) under the reference's
param layout (``launch.sharding.block_param_axes``): each slot projects
its own heads (RWKV6's ``heads_x_dim`` columns, Mamba2's ``inner``
columns and ``ssm_heads``), runs the scan (K3 / K4 in prefill) on its
head slice with its heads of the carried state, and the model row adds
the output projections' partial sums in slot order.  The reference's
rules never shard the recurrent states over ``model`` (``ssm_heads_act``
has no rule), so every model slot holds them whole: the slots' new state
heads (and Mamba2's conv-tail columns) are gathered in slot order after
each step, which keeps the replicas equal.  Mamba2's gated norm spans all
of ``d_inner``: its input is gathered over the row first.  Under
``seq_act`` a mixer takes the whole sequence (the blocks gather it over
the model row first: the token shift, the causal conv and the scans read
across the shards' boundaries) and hands back the slot's block of its
output (``layers.reduce_out``).  The solo server runs them on its one
``NULL`` slot, with the solo functions' ops.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import use_kernel
from repro_torch.kernels.ssd import ssd, ssd_chunked
from repro_torch.kernels.wkv6 import wkv6, wkv6_chunked
from repro_torch.models.layers import (NULL, ParamBuilder, gather_model,
                                       param_dtype, reduce_out,
                                       rms_norm_simple, seq_block)

# per-step log-decay clamp for RWKV6 (the reference's stability bound)
RWKV_MIN_LOG_W = -5.0


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================


def init_mamba(pb: ParamBuilder, cfg: ModelConfig):
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    dt = param_dtype(cfg)
    c = pb.child()
    c.dense("wz", (d, di), dt)
    c.dense("wx", (d, di), dt)
    c.dense("wB", (d, n), dt)
    c.dense("wC", (d, n), dt)
    c.dense("wdt", (d, h), dt)
    c.dense("conv_w", (cfg.conv_width, conv_dim), dt, scale=0.5)
    c.zeros("conv_b", (conv_dim,), dt)
    c.const("dt_bias", torch.zeros(h, device=c.device))
    c.const("A_log", torch.log(torch.linspace(1.0, 16.0, h,
                                              device=c.device)))
    c.zeros("D", (h,), torch.float32)
    c.ones("norm", (di,), torch.float32)
    c.dense("out_proj", (di, d), dt)
    return c.params


def _mamba_inputs(params, cfg: ModelConfig, x):
    """Projections shared by prefill and decode: (z, (xc, B, C) pre-conv
    pieces, dt_raw)."""
    z = x @ params["wz"].to(x.dtype)
    xc = x @ params["wx"].to(x.dtype)
    bp = x @ params["wB"].to(x.dtype)
    cp = x @ params["wC"].to(x.dtype)
    dt_raw = x @ params["wdt"].to(x.dtype)
    return z, (xc, bp, cp), dt_raw


def apply_mamba_full(params, cfg: ModelConfig, x, backend: str = "kernel"):
    """Full-sequence Mamba2.  x (B,S,d) -> (y (B,S,d), state) with state
    {"ssm": (B,h,p,n) f32, "conv": (B, w-1, d_inner+2n) f32}."""
    ys, states = mamba_full_group([params], cfg, [NULL], [x], backend)
    return ys[0], states[0]


def apply_mamba_decode(params, cfg: ModelConfig, x, state):
    """Single-token Mamba2 step.  x (B,1,d) -> (y (B,1,d), new state)."""
    ys, states = mamba_decode_group([params], cfg, [NULL], [x], [state])
    return ys[0], states[0]


# ===========================================================================
# RWKV6 (Finch)
# ===========================================================================

_TM_LORA = 32
_DECAY_LORA = 64
_N_MIX = 5  # w, k, v, r, g


def init_rwkv_tm(pb: ParamBuilder, cfg: ModelConfig):
    d = cfg.d_model
    h, hd = cfg.ssm_heads, cfg.ssm_head_dim
    dt = param_dtype(cfg)
    f32 = torch.float32
    c = pb.child()
    c.zeros("mu_x", (d,), f32)
    c.zeros("mu", (_N_MIX, d), f32)
    c.dense("mix_A", (d, _N_MIX * _TM_LORA), f32)
    c.dense("mix_B", (_N_MIX, _TM_LORA, d), f32, scale=0.1)
    c.dense("wr", (d, d), dt)
    c.dense("wk", (d, d), dt)
    c.dense("wv", (d, d), dt)
    c.dense("wg", (d, d), dt)
    c.const("w0", torch.full((d,), -1.0, device=c.device))
    c.dense("w_A", (d, _DECAY_LORA), f32)
    c.dense("w_B", (_DECAY_LORA, d), f32, scale=0.1)
    c.const("u", torch.zeros((h, hd), device=c.device))
    c.ones("out_norm", (d,), f32)
    c.dense("wo", (d, d), dt)
    return c.params


def _rwkv_mix(params, x, sx):
    """Data-dependent token-shift interpolation (ddlerp) for w, k, v, r, g.
    x, sx: (B,S,d).  Returns 5 mixed tensors (B,S,d) in order w,k,v,r,g."""
    dx = (sx - x).float()
    xf = x.float()
    xx = xf + dx * params["mu_x"]
    lo = torch.tanh(xx @ params["mix_A"])  # (B,S,5*lora)
    lo = lo.reshape(*lo.shape[:-1], _N_MIX, _TM_LORA)
    delta = torch.einsum("bsml,mld->mbsd", lo, params["mix_B"])
    return [(xf + dx * (params["mu"][i] + delta[i])).to(x.dtype)
            for i in range(_N_MIX)]


def _rwkv_decay(params, xw):
    """Per-channel log-decay log(w_t) <= 0 with the stability clamp."""
    omega = params["w0"] + torch.tanh(
        xw.float() @ params["w_A"]) @ params["w_B"]
    return torch.clamp(-torch.exp(omega), RWKV_MIN_LOG_W, -1e-4)


def _rwkv_out(params, cfg: ModelConfig, y, g, x, lo: int = 0, n=None):
    """Per-head group norm, gate, output projection.  y (..., h, hd) f32;
    a group slot's channels [lo, lo + n) (its heads, ``g`` and ``wo``
    rows)."""
    hd = cfg.ssm_head_dim
    n = cfg.d_model if n is None else n
    y = rms_norm_simple(y, y.new_ones(hd), cfg.norm_eps)
    y = y.reshape(*y.shape[:-2], n)
    out_norm = params["out_norm"]
    if n != cfg.d_model:
        out_norm = out_norm[lo:lo + n]
    y = (y * out_norm * g).to(x.dtype)
    return y @ params["wo"].to(x.dtype)


def apply_rwkv_tm_full(params, cfg: ModelConfig, x, backend: str = "kernel"):
    """Full-sequence RWKV6 time-mix.  x (B,S,d) -> (y, state) with state
    {"wkv": (B,h,hd,hd) f32, "shift": (B,d) f32} — the last-token carry."""
    ys, states = rwkv_tm_full_group([params], cfg, [NULL], [x], backend)
    return ys[0], states[0]


def apply_rwkv_tm_decode(params, cfg: ModelConfig, x, state):
    """Single-token RWKV6 time-mix.  x (B,1,d) -> (y, new state)."""
    ys, states = rwkv_tm_decode_group([params], cfg, [NULL], [x], [state])
    return ys[0], states[0]


def init_rwkv_cm(pb: ParamBuilder, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    dt = param_dtype(cfg)
    c = pb.child()
    c.zeros("mu_k", (d,), torch.float32)
    c.zeros("mu_r", (d,), torch.float32)
    c.dense("wk", (d, f), dt)
    c.dense("wv", (f, d), dt)
    c.dense("wr", (d, d), dt)
    return c.params


def apply_rwkv_cm(params, cfg: ModelConfig, x, shift_state=None):
    """RWKV6 channel-mix.  Full sequence when ``shift_state`` is None, else
    one token after the carried shift.  Returns (y, new shift state)."""
    return rwkv_cm_group([params], cfg, [NULL], [x], [shift_state])[0]


# ===========================================================================
# Group forms (device-group slots; the solo server's one NULL slot)
# ===========================================================================


def _slot_cols(c, n: int, whole: int):
    """(first column, count) of a slot's block of a ``whole``-wide axis of
    which it holds ``n`` columns (its model index's block when split)."""
    return (0, n) if n == whole else (c.j * n, n)


def _heads_of(n: int, hd: int, what: str, heads: int):
    """The heads of a slot's ``n`` columns; ``NotImplementedError`` where
    the columns cut heads of ``hd`` or its per-head params (``heads`` of
    them) are not split the same way."""
    if n % hd or n // hd != heads:
        raise NotImplementedError(
            f"a device group whose {what} shard ({n} columns) does not hold "
            f"whole heads of {hd} with their {heads} per-head params is not "
            "emulated (ROADMAP A10(b))")
    return n // hd


def _gather_if(ctxs, parts, split: bool, dim: int):
    return gather_model(ctxs, parts, dim) if split else parts


def rwkv_tm_full_group(ps, cfg: ModelConfig, ctxs, xs,
                       backend: str = "kernel"):
    """:func:`apply_rwkv_tm_full` on a group: per-slot (y, state)."""
    hd, d = cfg.ssm_head_dim, cfg.d_model
    ys, wkvs = [], []
    for p, c, x in zip(ps, ctxs, xs):
        B, S, _ = x.shape
        lo, n = _slot_cols(c, p["wr"].shape[1], d)
        h = _heads_of(n, hd, "heads_x_dim", p["u"].shape[0])
        sx = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
        xw, xk, xv, xr, xg = _rwkv_mix(p, x, sx)
        r = (xr @ p["wr"].to(x.dtype)).reshape(B, S, h, hd)
        k = (xk @ p["wk"].to(x.dtype)).reshape(B, S, h, hd)
        v = (xv @ p["wv"].to(x.dtype)).reshape(B, S, h, hd)
        g = F.silu((xg @ p["wg"].to(x.dtype)).float())
        lw = _rwkv_decay(p, xw)[..., lo:lo + n].reshape(B, S, h, hd)
        scan = wkv6 if use_kernel(backend, x) else wkv6_chunked
        y, wkv_state = scan(r.float(), k.float(), v.float(), lw, p["u"])
        ys.append(_rwkv_out(p, cfg, y, g, x, lo, n))
        wkvs.append(wkv_state)
    split = ps[0]["wr"].shape[1] != d
    ys = reduce_out(ctxs, ys, split)
    wkvs = _gather_if(ctxs, wkvs, split, 1)
    return ys, [{"wkv": w, "shift": x[:, -1].float()}
                for w, x in zip(wkvs, xs)]


def rwkv_tm_decode_group(ps, cfg: ModelConfig, ctxs, xs, states):
    """:func:`apply_rwkv_tm_decode` on a group: each slot steps its heads
    of the (whole) carried state; per-slot (y, new state)."""
    hd, d = cfg.ssm_head_dim, cfg.d_model
    ys, wkvs = [], []
    for p, c, x, st in zip(ps, ctxs, xs, states):
        B = x.shape[0]
        lo, n = _slot_cols(c, p["wr"].shape[1], d)
        h = _heads_of(n, hd, "heads_x_dim", p["u"].shape[0])
        sx = st["shift"].to(x.dtype)[:, None]
        xw, xk, xv, xr, xg = _rwkv_mix(p, x, sx)
        r = (xr @ p["wr"].to(x.dtype)).reshape(B, h, hd).float()
        k = (xk @ p["wk"].to(x.dtype)).reshape(B, h, hd).float()
        v = (xv @ p["wv"].to(x.dtype)).reshape(B, h, hd).float()
        g = F.silu((xg @ p["wg"].to(x.dtype)).float())
        lw = _rwkv_decay(p, xw)[..., lo:lo + n].reshape(B, h, hd)
        s = st["wkv"][:, lo // hd:lo // hd + h]  # (B,h,hd,hd)
        kv = torch.einsum("bhd,bhe->bhde", k, v)
        y = torch.einsum("bhd,bhde->bhe", r,
                         s + p["u"][None, ..., None] * kv)
        wkvs.append(torch.exp(lw)[..., None] * s + kv)
        ys.append(_rwkv_out(p, cfg, y[:, None], g, x, lo, n))
    split = ps[0]["wr"].shape[1] != d
    ys = reduce_out(ctxs, ys, split)
    wkvs = _gather_if(ctxs, wkvs, split, 1)
    return ys, [{"wkv": w, "shift": x[:, 0].float()}
                for w, x in zip(wkvs, xs)]


def rwkv_cm_group(ps, cfg: ModelConfig, ctxs, xs, shift_states=None):
    """:func:`apply_rwkv_cm` on a group (``wk`` columns / ``wv`` rows per
    slot, ``wr`` whole): per-slot (y, new shift state); ``y`` on the
    slot's ``seq`` block of the (whole) input positions under
    ``seq_act``."""
    shift_states = shift_states or [None] * len(xs)
    kvs, rs, shifts = [], [], []
    for p, x, st in zip(ps, xs, shift_states):
        if st is None:
            sx = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
            shifts.append(x[:, -1].float())
        else:
            sx = st.to(x.dtype)[:, None]
            shifts.append(x[:, 0].float())
        dx = sx - x
        xk = x + dx * p["mu_k"].to(x.dtype)
        xr = x + dx * p["mu_r"].to(x.dtype)
        kk = torch.square(F.relu(xk @ p["wk"].to(x.dtype)))
        kvs.append(kk @ p["wv"].to(x.dtype))
        rs.append(torch.sigmoid((xr @ p["wr"].to(x.dtype)).float()))
    kvs = reduce_out(ctxs, kvs, ps[0]["wk"].shape[1] != cfg.d_ff)
    return [((seq_block(c, r) * kv.float()).to(x.dtype), sh)
            for c, r, kv, x, sh in zip(ctxs, rs, kvs, xs, shifts)]


def _slot_conv(p, cfg: ModelConfig, lo: int, n: int):
    """The conv weights and bias of a slot's conv channels: its ``inner``
    columns [lo, lo + n) of the x piece, then B and C whole."""
    di = cfg.d_inner
    w, b = p["conv_w"], p["conv_b"]
    if n == di:
        return w, b
    return (torch.cat([w[:, lo:lo + n], w[:, di:]], dim=1),
            torch.cat([b[lo:lo + n], b[di:]]))


def _mamba_post_group(ps, cfg: ModelConfig, ctxs, gs, cols, split: bool):
    """Mamba2's gated RMSNorm over all of ``d_inner`` (the slots' gated
    outputs gathered over the row) and the out projection's partial sums,
    added over the row."""
    gs = _gather_if(ctxs, gs, split, -1)
    outs = []
    for p, g, (lo, n) in zip(ps, gs, cols):
        g = rms_norm_simple(g, p["norm"], cfg.norm_eps)
        if split:
            g = g[..., lo:lo + n]
        outs.append(g @ p["out_proj"].to(g.dtype))
    return reduce_out(ctxs, outs, split)


def mamba_full_group(ps, cfg: ModelConfig, ctxs, xs,
                     backend: str = "kernel"):
    """:func:`apply_mamba_full` on a group: per-slot (y, state)."""
    di, nst, w = cfg.d_inner, cfg.ssm_state, cfg.conv_width
    pd = cfg.ssm_head_dim
    gs, cols, ssms, tails = [], [], [], []
    for p, c, x in zip(ps, ctxs, xs):
        B, S, _ = x.shape
        lo, n = _slot_cols(c, p["wx"].shape[1], di)
        h = _heads_of(n, pd, "inner", p["A_log"].shape[0])
        z, pieces, dt_raw = _mamba_inputs(p, cfg, x)
        cw, cb = _slot_conv(p, cfg, lo, n)
        bounds = ((0, n), (n, n + nst), (n + nst, n + 2 * nst))
        convs, tl = [], []
        for piece, (a, b) in zip(pieces, bounds):
            pad = F.pad(piece, (0, 0, w - 1, 0))
            out = sum(pad[:, i: i + S] * cw[i, a:b].to(x.dtype)
                      for i in range(w))
            convs.append(F.silu(out + cb[a:b].to(x.dtype)))
            tl.append(pad[:, S:])
        xc, bm, cm = convs[0], convs[1].float(), convs[2].float()
        dtv = F.softplus(dt_raw.float() + p["dt_bias"])
        a = -torch.exp(p["A_log"])
        xh = xc.reshape(B, S, h, pd).float()
        scan = ssd if use_kernel(backend, x) else ssd_chunked
        y, ssm_state = scan(xh, bm, cm, dtv, a, p["D"])
        y = y.reshape(B, S, n).to(x.dtype)
        gs.append(y * F.silu(z.float()).to(y.dtype))
        cols.append((lo, n))
        ssms.append(ssm_state)
        tails.append(tl)
    split = ps[0]["wx"].shape[1] != di
    outs = _mamba_post_group(ps, cfg, ctxs, gs, cols, split)
    ssms = _gather_if(ctxs, ssms, split, 1)
    x_tails = _gather_if(ctxs, [t[0] for t in tails], split, -1)
    return outs, [{"ssm": st, "conv": torch.cat([xt] + t[1:],
                                                 dim=-1).float()}
                  for st, xt, t in zip(ssms, x_tails, tails)]


def mamba_decode_group(ps, cfg: ModelConfig, ctxs, xs, states):
    """:func:`apply_mamba_decode` on a group: each slot steps its heads of
    the (whole) carried state and its conv columns; per-slot (y, new
    state)."""
    di, nst = cfg.d_inner, cfg.ssm_state
    pd = cfg.ssm_head_dim
    gs, cols, ssms, convs_new = [], [], [], []
    for p, c, x, st in zip(ps, ctxs, xs, states):
        B = x.shape[0]
        lo, n = _slot_cols(c, p["wx"].shape[1], di)
        h = _heads_of(n, pd, "inner", p["A_log"].shape[0])
        z, pieces, dt_raw = _mamba_inputs(p, cfg, x)
        conv_in = torch.cat(pieces, dim=-1)  # (B,1,n+2n_state)
        carry = st["conv"] if n == di else torch.cat(
            [st["conv"][..., lo:lo + n], st["conv"][..., di:]], dim=-1)
        window = torch.cat([carry.to(x.dtype), conv_in], dim=1)
        cw, cb = _slot_conv(p, cfg, lo, n)
        conv = torch.einsum("bwc,wc->bc", window, cw.to(x.dtype))
        conv = F.silu(conv + cb.to(x.dtype))
        convs_new.append(window[:, 1:].float())
        xc = conv[:, :n].reshape(B, h, pd).float()
        bm = conv[:, n: n + nst].float()
        cm = conv[:, n + nst:].float()
        dtv = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])
        a = torch.exp(dtv * -torch.exp(p["A_log"]))
        s = st["ssm"][:, lo // pd:lo // pd + h] * a[..., None, None] \
            + torch.einsum("bh,bhp,bn->bhpn", dtv, xc, bm)
        y = torch.einsum("bn,bhpn->bhp", cm, s) \
            + xc * p["D"][None, :, None]
        y = y.reshape(B, 1, n).to(x.dtype)
        gs.append(y * F.silu(z.float()).to(y.dtype))
        cols.append((lo, n))
        ssms.append(s)
    split = ps[0]["wx"].shape[1] != di
    outs = _mamba_post_group(ps, cfg, ctxs, gs, cols, split)
    ssms = _gather_if(ctxs, ssms, split, 1)
    x_conv = _gather_if(ctxs, [cv[..., :n] for cv, (_, n) in
                               zip(convs_new, cols)], split, -1)
    return outs, [{"ssm": s, "conv": torch.cat([xc, cv[..., n:]], dim=-1)
                   if split else cv}
                  for s, xc, cv, (_, n) in zip(ssms, x_conv, convs_new,
                                               cols)]
