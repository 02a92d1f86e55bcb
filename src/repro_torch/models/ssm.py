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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import use_kernel
from repro_torch.kernels.ssd import ssd, ssd_chunked
from repro_torch.kernels.wkv6 import wkv6, wkv6_chunked
from repro_torch.models.layers import (ParamBuilder, param_dtype,
                                       rms_norm_simple)

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


def _conv_slices(params, cfg: ModelConfig):
    di, n = cfg.d_inner, cfg.ssm_state
    w, b = params["conv_w"], params["conv_b"]
    return ((w[:, :di], b[:di]), (w[:, di: di + n], b[di: di + n]),
            (w[:, di + n:], b[di + n:]))


def _mamba_post(params, cfg: ModelConfig, y, z):
    """Gated RMSNorm + output projection.  y/z: (..., d_inner)."""
    g = y * F.silu(z.float()).to(y.dtype)
    g = rms_norm_simple(g, params["norm"], cfg.norm_eps)
    return g @ params["out_proj"].to(g.dtype)


def apply_mamba_full(params, cfg: ModelConfig, x, backend: str = "kernel"):
    """Full-sequence Mamba2.  x (B,S,d) -> (y (B,S,d), state) with state
    {"ssm": (B,h,p,n) f32, "conv": (B, w-1, d_inner+2n) f32}."""
    B, S, _ = x.shape
    di, h, w = cfg.d_inner, cfg.ssm_heads, cfg.conv_width
    p = cfg.ssm_head_dim
    z, pieces, dt_raw = _mamba_inputs(params, cfg, x)

    # causal depthwise conv (width w), per piece: it never mixes channels
    convs, tails = [], []
    for piece, (cw, cb) in zip(pieces, _conv_slices(params, cfg)):
        pad = F.pad(piece, (0, 0, w - 1, 0))
        out = sum(pad[:, i: i + S] * cw[i].to(x.dtype) for i in range(w))
        convs.append(F.silu(out + cb.to(x.dtype)))
        tails.append(pad[:, S:])
    xc, bm, cm = convs[0], convs[1].float(), convs[2].float()
    conv_tail = torch.cat(tails, dim=-1)  # (B, w-1, di+2n): the decode carry
    dtv = F.softplus(dt_raw.float() + params["dt_bias"])  # (B,S,h)
    a = -torch.exp(params["A_log"])  # (h,) negative

    xh = xc.reshape(B, S, h, p).float()
    scan = ssd if use_kernel(backend, x) else ssd_chunked
    y, ssm_state = scan(xh, bm, cm, dtv, a, params["D"])
    y = y.reshape(B, S, di).to(x.dtype)
    out = _mamba_post(params, cfg, y, z)
    return out, {"ssm": ssm_state, "conv": conv_tail.float()}


def apply_mamba_decode(params, cfg: ModelConfig, x, state):
    """Single-token Mamba2 step.  x (B,1,d) -> (y (B,1,d), new state)."""
    B = x.shape[0]
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    p = cfg.ssm_head_dim
    z, pieces, dt_raw = _mamba_inputs(params, cfg, x)
    conv_in = torch.cat(pieces, dim=-1)  # (B,1,conv_dim)
    window = torch.cat([state["conv"].to(x.dtype), conv_in], dim=1)
    conv = torch.einsum("bwc,wc->bc", window,
                        params["conv_w"].to(x.dtype))
    conv = F.silu(conv + params["conv_b"].to(x.dtype))  # (B,conv_dim)
    new_conv = window[:, 1:].float()

    xc = conv[:, :di].reshape(B, h, p).float()
    bm = conv[:, di: di + n].float()
    cm = conv[:, di + n:].float()
    dtv = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])
    a = torch.exp(dtv * -torch.exp(params["A_log"]))  # (B,h)
    s = state["ssm"] * a[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dtv, xc, bm)
    y = torch.einsum("bn,bhpn->bhp", cm, s) + xc * params["D"][None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    return _mamba_post(params, cfg, y, z), {"ssm": s, "conv": new_conv}


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


def _rwkv_out(params, cfg: ModelConfig, y, g, x):
    """Per-head group norm, gate, output projection.  y (..., h, hd) f32."""
    hd = cfg.ssm_head_dim
    y = rms_norm_simple(y, y.new_ones(hd), cfg.norm_eps)
    y = y.reshape(*y.shape[:-2], cfg.d_model)
    y = (y * params["out_norm"] * g).to(x.dtype)
    return y @ params["wo"].to(x.dtype)


def apply_rwkv_tm_full(params, cfg: ModelConfig, x, backend: str = "kernel"):
    """Full-sequence RWKV6 time-mix.  x (B,S,d) -> (y, state) with state
    {"wkv": (B,h,hd,hd) f32, "shift": (B,d) f32} — the last-token carry."""
    B, S, _ = x.shape
    h, hd = cfg.ssm_heads, cfg.ssm_head_dim
    sx = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _rwkv_mix(params, x, sx)
    r = (xr @ params["wr"].to(x.dtype)).reshape(B, S, h, hd)
    k = (xk @ params["wk"].to(x.dtype)).reshape(B, S, h, hd)
    v = (xv @ params["wv"].to(x.dtype)).reshape(B, S, h, hd)
    g = F.silu((xg @ params["wg"].to(x.dtype)).float())
    lw = _rwkv_decay(params, xw).reshape(B, S, h, hd)
    scan = wkv6 if use_kernel(backend, x) else wkv6_chunked
    y, wkv_state = scan(r.float(), k.float(), v.float(), lw, params["u"])
    out = _rwkv_out(params, cfg, y, g, x)
    return out, {"wkv": wkv_state, "shift": x[:, -1].float()}


def apply_rwkv_tm_decode(params, cfg: ModelConfig, x, state):
    """Single-token RWKV6 time-mix.  x (B,1,d) -> (y, new state)."""
    B = x.shape[0]
    h, hd = cfg.ssm_heads, cfg.ssm_head_dim
    sx = state["shift"].to(x.dtype)[:, None]
    xw, xk, xv, xr, xg = _rwkv_mix(params, x, sx)
    r = (xr @ params["wr"].to(x.dtype)).reshape(B, h, hd).float()
    k = (xk @ params["wk"].to(x.dtype)).reshape(B, h, hd).float()
    v = (xv @ params["wv"].to(x.dtype)).reshape(B, h, hd).float()
    g = F.silu((xg @ params["wg"].to(x.dtype)).float())
    lw = _rwkv_decay(params, xw).reshape(B, h, hd)
    s = state["wkv"]  # (B,h,hd,hd)
    kv = torch.einsum("bhd,bhe->bhde", k, v)
    y = torch.einsum("bhd,bhde->bhe", r, s + params["u"][None, ..., None]
                     * kv)
    new_s = torch.exp(lw)[..., None] * s + kv
    out = _rwkv_out(params, cfg, y[:, None], g, x)
    return out, {"wkv": new_s, "shift": x[:, 0].float()}


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
    if shift_state is None:
        sx = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
        new_state = x[:, -1].float()
    else:
        sx = shift_state.to(x.dtype)[:, None]
        new_state = x[:, 0].float()
    dx = sx - x
    xk = x + dx * params["mu_k"].to(x.dtype)
    xr = x + dx * params["mu_r"].to(x.dtype)
    kk = torch.square(F.relu(xk @ params["wk"].to(x.dtype)))
    kv = kk @ params["wv"].to(x.dtype)
    r = torch.sigmoid((xr @ params["wr"].to(x.dtype)).float())
    return (r * kv.float()).to(x.dtype), new_state
