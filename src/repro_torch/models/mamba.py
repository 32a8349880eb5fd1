"""Mamba-2 block (SSD, arXiv:2405.21060), the counterpart of
``repro.models.mamba``: param defs, the depthwise causal conv, the
prefill block and the one-token decode step.

The prefill's chunked scan is ``kernels.ops.ssd_scan``: the CUDA kernel
(K5) on the card, the plain version on the CPU. JAX's block calls the
jnp ``ssd_scan_ref`` (mamba.py:184); both keep xdt in f32 and return the
final state. The conv and the decode recurrence are plain PyTorch, as in
JAX (no Pallas kernel). The decode carries (ssm_state, conv_tail) per
slot.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamDef, rms_norm


def mamba_dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads, n_groups * d_state, conv kernel)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    gn = s.n_groups * s.d_state
    return d_in, nheads, gn, s.conv_kernel


def mamba_param_defs(cfg: ArchConfig, scan_dims: Tuple[int, ...] = ()) -> dict:
    d = cfg.d_model
    d_in, nheads, gn, k = mamba_dims(cfg)
    ld = tuple("layers" for _ in scan_dims)
    return {
        "wz": ParamDef(scan_dims + (d, d_in), ld + ("embed", "ff")),
        "wx": ParamDef(scan_dims + (d, d_in), ld + ("embed", "ff")),
        "wB": ParamDef(scan_dims + (d, gn), ld + ("embed", "bc")),
        "wC": ParamDef(scan_dims + (d, gn), ld + ("embed", "bc")),
        "wdt": ParamDef(scan_dims + (d, nheads), ld + ("embed", "heads")),
        "conv_x": ParamDef(scan_dims + (k, d_in), ld + ("conv", "ff"),
                           init="const:0.25"),
        "conv_B": ParamDef(scan_dims + (k, gn), ld + ("conv", "bc"),
                           init="const:0.25"),
        "conv_C": ParamDef(scan_dims + (k, gn), ld + ("conv", "bc"),
                           init="const:0.25"),
        "A_log": ParamDef(scan_dims + (nheads,), ld + ("heads",),
                          init="const:0.0"),
        "dt_bias": ParamDef(scan_dims + (nheads,), ld + ("heads",),
                            init="const:-2.0"),
        "D_skip": ParamDef(scan_dims + (nheads,), ld + ("heads",),
                           init="ones"),
        "norm": ParamDef(scan_dims + (d_in,), ld + ("ff",), init="ones"),
        "out_proj": ParamDef(scan_dims + (d_in, d), ld + ("ff", "embed")),
    }


def causal_conv(x, w):
    """Depthwise causal conv: x (B, S, C), w (K, C) -> (B, S, C), summed
    in the reference's order (tap K-1 first)."""
    k = w.shape[0]
    out = x * w[k - 1]
    for i in range(k - 1):
        shift = k - 1 - i
        out = out + F.pad(x, (0, 0, shift, 0))[:, :-shift] * w[i]
    return out


def ssd_decode_step(state, x1, dt1, a_log, b1, c1):
    """One-token recurrence. state (B, H, P, N) f32; x1 (B, H, P); dt1
    (B, H); b1/c1 (B, G, N). Returns (y (B, H, P) in x1's dtype, new
    state f32)."""
    hg = x1.shape[1] // b1.shape[1]
    A = -torch.exp(a_log.float())
    a = torch.exp(dt1.float() * A)                           # (B, H)
    bh = b1.repeat_interleave(hg, dim=1)                     # (B, H, N)
    ch = c1.repeat_interleave(hg, dim=1)
    xdt = x1.float() * dt1[..., None]
    state = state * a[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xdt, bh.float())
    y = torch.einsum("bhpn,bhn->bhp", state, ch.float())
    return y.to(x1.dtype), state


def _in_proj(x, p):
    return (x @ p["wz"], x @ p["wx"], x @ p["wB"], x @ p["wC"],
            x @ p["wdt"])


def _dt(dt_raw, p):
    return F.softplus(dt_raw.float() + p["dt_bias"].float())


def _out(y, xh, z, p, cfg: ArchConfig):
    """D-skip, gate, norm and out projection of a (..., H, P) scan
    output."""
    y = y + xh * p["D_skip"].to(xh.dtype)[:, None]
    y = y.reshape(*y.shape[:-2], -1)
    return rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps) @ p["out_proj"]


def mamba_block(x, p, cfg: ArchConfig):
    """Prefill path. x (B, S, D) -> (out (B, S, D), final state (B, H,
    P, N) f32, conv tail (B, K-1, d_in + 2 G N)); the tail is left-padded
    with zeros when S < K-1."""
    s = cfg.ssm
    d_in, nheads, gn, k = mamba_dims(cfg)
    nb, seq, _ = x.shape
    z, xi, bi, ci, dt_raw = _in_proj(x, p)
    conv_in = torch.cat([xi, bi, ci], dim=-1)
    xi = F.silu(causal_conv(xi, p["conv_x"]))
    bi = F.silu(causal_conv(bi, p["conv_B"]))
    ci = F.silu(causal_conv(ci, p["conv_C"]))
    xh = xi.reshape(nb, seq, nheads, s.head_dim)
    y, state = ops.ssd_scan(
        xh, _dt(dt_raw, p), p["A_log"],
        bi.reshape(nb, seq, s.n_groups, s.d_state),
        ci.reshape(nb, seq, s.n_groups, s.d_state), chunk=s.chunk_size)
    out = _out(y, xh, z, p, cfg)
    if seq >= k - 1:
        tail = conv_in[:, seq - (k - 1):]
    else:
        tail = F.pad(conv_in, (0, 0, k - 1 - seq, 0))
    return out, state, tail


def mamba_decode(x, p, cfg: ArchConfig, ssm_state, conv_tail):
    """Decode path. x (B, 1, D); ssm_state (B, H, P, N) f32; conv_tail
    (B, K-1, C). Returns (out (B, 1, D), new ssm_state, new conv_tail)."""
    s = cfg.ssm
    d_in, nheads, gn, k = mamba_dims(cfg)
    nb = x.shape[0]
    z, xi, bi, ci, dt_raw = _in_proj(x[:, 0], p)
    new_in = torch.cat([xi, bi, ci], dim=-1)                 # (B, C)
    full = torch.cat([conv_tail, new_in[:, None, :]], dim=1)  # (B, K, C)
    w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
    conv_out = torch.einsum("bkc,kc->bc", full, w)
    xi, bi, ci = torch.split(F.silu(conv_out), [d_in, gn, gn], dim=-1)
    xh = xi.reshape(nb, nheads, s.head_dim)
    y, ssm_state = ssd_decode_step(
        ssm_state, xh, _dt(dt_raw, p), p["A_log"],
        bi.reshape(nb, s.n_groups, s.d_state),
        ci.reshape(nb, s.n_groups, s.d_state))
    out = _out(y, xh, z, p, cfg)[:, None, :]
    return out, ssm_state, full[:, 1:]
