"""Mamba2 block via SSD (state-space duality): prefill through the scan
kernel, decode as the O(1) recurrence in torch ops.

The port's counterpart of ``repro/models/ssm.py``.  The projections are
stored separately (``w_z``, ``w_x``, ``w_B``, ``w_C``, ``w_dt``), as in the
reference, so RSI compresses each on its own and every one goes through
``nn.dense``.  The prefill's chunked scan goes through
``dispatch.ssd_scan`` (the hand-written ``ssd_scan`` kernel on the card, the
plain chunked version elsewhere), where the reference calls
``_ssd_chunk_scan``.  The decode step stays in torch ops: the reference
computes it in XLA, outside any Pallas kernel.

The decode cache per layer is ``{"conv_x": (B, w-1, d_inner), "conv_B":
(B, w-1, s), "conv_C": (B, w-1, s), "state": (B, nh, hd, s) fp32}``: the
conv tails are the last w-1 raw projections, the state the SSD state.
``mamba2_decode`` updates it IN PLACE (the tensors may be views of a model's
stacked (L, B, ...) cache).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import modules as nn
from repro_torch.runtime import dispatch

__all__ = ["mamba2_init", "mamba2_forward", "mamba2_init_cache", "mamba2_decode"]


def mamba2_init(generator: torch.Generator, cfg, dtype, device) -> dict:
    """Random params in the reference's tree layout (``mamba2_init``)."""
    d, din, s, nh, w = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_conv_width

    def conv(ch):
        return (torch.randn((w, ch), generator=generator, dtype=torch.float32, device=device) * w**-0.5).to(dtype)

    return {
        "w_z": nn.dense_init(generator, d, din, dtype, device),
        "w_x": nn.dense_init(generator, d, din, dtype, device),
        "w_B": nn.dense_init(generator, d, s, dtype, device),
        "w_C": nn.dense_init(generator, d, s, dtype, device),
        "w_dt": nn.dense_init(generator, d, nh, dtype, device),
        "dt_bias": torch.zeros((nh,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=device)).to(dtype),
        "D_param": torch.ones((nh,), dtype=dtype, device=device),
        "conv_x": conv(din),
        "conv_B": conv(s),
        "conv_C": conv(s),
        "ssm_norm": nn.rmsnorm_init(din, dtype, device),
        "out_proj": nn.dense_init(generator, din, d, dtype, device, scale=din**-0.5),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, tail=None) -> torch.Tensor:
    """x: (B, L, ch); w: (width, ch); tail: (B, width-1, ch) left context
    (zeros by default).  Unrolled fp32 multiply-adds, as the reference's:
    ``F.conv1d`` in fp32 goes through cuDNN in TF32 by default on the card."""
    width, L = w.shape[0], x.shape[1]
    if tail is None:
        tail = x.new_zeros((x.shape[0], width - 1, x.shape[-1]))
    xp = torch.cat([tail, x], dim=1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + xp[:, i : i + L].float() * w[i].float()
    return F.silu(out).to(x.dtype)


def _tail(raw: torch.Tensor, width: int) -> torch.Tensor:
    """The last width-1 rows of ``raw`` (B, L, ch) as a conv tail, zero-padded
    on the left where L < width - 1 (the reference slices rows L-w+1..L-1)."""
    B, L, ch = raw.shape
    if L >= width - 1:
        return raw[:, L - (width - 1):]
    return torch.cat([raw.new_zeros((B, width - 1 - L, ch)), raw], dim=1)


def _gated_out(p, y: torch.Tensor, z: torch.Tensor, cfg) -> torch.Tensor:
    y = nn.rmsnorm(p["ssm_norm"], y * F.silu(z.float()).to(y.dtype), cfg.norm_eps)
    return nn.dense(p["out_proj"], y)


def mamba2_forward(p, u: torch.Tensor, cfg, *, return_cache: bool = False):
    """u: (B, L, d_model) -> (B, L, d_model); with ``return_cache`` also the
    layer's decode cache after the last position."""
    B, L, _ = u.shape
    din, nh, hd = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_head_dim
    z = nn.dense(p["w_z"], u)
    x_raw = nn.dense(p["w_x"], u)
    B_raw = nn.dense(p["w_B"], u)
    C_raw = nn.dense(p["w_C"], u)
    dt = F.softplus(nn.dense(p["w_dt"], u).float() + p["dt_bias"].float())  # (B, L, nh)

    x = _causal_depthwise_conv(x_raw, p["conv_x"])
    Bv = _causal_depthwise_conv(B_raw, p["conv_B"])
    Cv = _causal_depthwise_conv(C_raw, p["conv_C"])

    xh = x.reshape(B, L, nh, hd)
    A = -torch.exp(p["A_log"].float())
    # x̄ = x * dt rounded to the model dtype before the scan (ssm.py:148)
    y, state = dispatch.ssd_scan(xh, dt, Bv, Cv, A, chunk=cfg.ssm_chunk, round_xbar=True)
    y = y + xh * p["D_param"].to(y.dtype)[None, None, :, None]
    out = _gated_out(p, y.reshape(B, L, din), z, cfg)
    if not return_cache:
        return out
    w = cfg.ssm_conv_width
    cache = {"conv_x": _tail(x_raw, w), "conv_B": _tail(B_raw, w), "conv_C": _tail(C_raw, w), "state": state}
    return out, cache


def mamba2_init_cache(cfg, batch: int, dtype, device) -> dict:
    din, s, nh, hd, w = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_conv_width
    return {
        "conv_x": torch.zeros((batch, w - 1, din), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, w - 1, s), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, w - 1, s), dtype=dtype, device=device),
        "state": torch.zeros((batch, nh, hd, s), dtype=torch.float32, device=device),
    }


def mamba2_decode(p, u: torch.Tensor, cache: dict, cfg):
    """Single-token recurrence.  u: (B, 1, d_model).  Updates ``cache`` in
    place and returns (out, cache)."""
    B = u.shape[0]
    din, nh, hd = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_head_dim
    z = nn.dense(p["w_z"], u)
    x_raw = nn.dense(p["w_x"], u)
    B_raw = nn.dense(p["w_B"], u)
    C_raw = nn.dense(p["w_C"], u)
    dt = F.softplus(nn.dense(p["w_dt"], u).float() + p["dt_bias"].float())[:, 0]  # (B, nh)

    x = _causal_depthwise_conv(x_raw, p["conv_x"], tail=cache["conv_x"])[:, 0]
    Bv = _causal_depthwise_conv(B_raw, p["conv_B"], tail=cache["conv_B"])[:, 0]
    Cv = _causal_depthwise_conv(C_raw, p["conv_C"], tail=cache["conv_C"])[:, 0]

    xh = x.reshape(B, nh, hd).float()
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A[None, :])  # (B, nh)
    # state * decay + outer(x * dt, B), in place: the same two roundings as the reference's
    state = cache["state"]
    state.mul_(decay[:, :, None, None]).add_((xh * dt[:, :, None])[..., None] * Bv.float()[:, None, None, :])
    y = torch.einsum("bs,bhds->bhd", Cv.float(), state)
    y = y + xh * p["D_param"].float()[None, :, None]
    out = _gated_out(p, y.reshape(B, 1, din).to(u.dtype), z, cfg)
    for name, new in (("conv_x", x_raw), ("conv_B", B_raw), ("conv_C", C_raw)):
        cache[name].copy_(torch.cat([cache[name][:, 1:], new], dim=1))
    return out, cache
