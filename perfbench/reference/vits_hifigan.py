"""VITS's own inference in plain PyTorch, written from the published code
(Kim et al. 2021, arXiv:2106.06103; github.com/jaywalnut310/vits,
`models.py`: `SynthesizerTrn.infer`, `Generator`,
`StochasticDurationPredictor`; `modules.py`: `DDSConv`, `ConvFlow`,
`ElementwiseAffine`, `Flip`; `transforms.py`: the piecewise
rational-quadratic spline), as functions of a weight dict with the
published state-dict names. It is the VITS cell's yardstick for
`correct` and imports nothing of the measured program: the text
encoder, the flow, `generate_path` and the weight-norm rule are
`perfbench.reference.vits`'s, which VITS and its iSTFT descendants
share.

Layouts: activations [B, C, T], masks [B, 1, T], the stochastic duration
predictor's noise [B, 2, T_x], waveforms [B, T_wav].

Departures from the published code, none of which changes a value:
  - only inference: no dropout (the modules' eval mode), and of the
    stochastic duration predictor only the reverse (sampling), through
    the published chain with its "useless vflow" dropped: Flip, ConvFlow
    4, Flip, ConvFlow 3, Flip, ConvFlow 2, Flip, ElementwiseAffine;
  - the noise is an input (`eps` for the prior, `w_eps` for the
    duration predictor) where `infer` draws `torch.randn` itself, so
    both sides of a comparison read the same draws;
  - the spline is computed only in its inverse direction, with no
    log-determinant, and `searchsorted` adds its 1e-6 to a copy of the
    bin edges where the published code adds it in place (the edges it
    changes are read before the change);
  - `infer` cuts the output at a given frame count (the serving bucket),
    as `max_len` does, and returns each row's frames.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.vits import (LRELU, conv1d, flow, generate_path,
                                      layer_norm, seq_mask, text_encoder,
                                      weight)

SDP_FLOWS = 4
NUM_BINS, TAIL_BOUND = 10, 5.0
MIN_BIN_WIDTH = MIN_BIN_HEIGHT = MIN_DERIVATIVE = 1e-3


# ---------------------------------------------------------------- decoder
def generator(p, m, z, g):
    """HiFi-GAN V1 (`models.py:Generator`): z [B, C, T] ->
    [B, 1, T * prod(upsample_rates)], tanh. g [B, gin, 1] enters once,
    through `dec.cond` after `dec.conv_pre`."""
    x = conv1d(p, "dec.conv_pre", z, padding=3)
    if g is not None:
        x = x + conv1d(p, "dec.cond", g)
    kernels = m["resblock_kernel_sizes"]
    for i, (u, k) in enumerate(zip(m["upsample_rates"],
                                   m["upsample_kernel_sizes"])):
        x = F.conv_transpose1d(F.leaky_relu(x, LRELU),
                               weight(p, f"dec.ups.{i}"),
                               p[f"dec.ups.{i}.bias"], u, (k - u) // 2)
        acc = 0
        for j, (rk, dil) in enumerate(zip(kernels,
                                          m["resblock_dilation_sizes"])):
            name = f"dec.resblocks.{i * len(kernels) + j}"
            r = x
            for n, d in enumerate(dil):
                t = conv1d(p, f"{name}.convs1.{n}", F.leaky_relu(r, LRELU),
                           padding=(rk * d - d) // 2, dilation=d)
                t = conv1d(p, f"{name}.convs2.{n}", F.leaky_relu(t, LRELU),
                           padding=(rk - 1) // 2)
                r = t + r
            acc = acc + r
        x = acc / len(kernels)
    x = conv1d(p, "dec.conv_post", F.leaky_relu(x), padding=3)
    return torch.tanh(x)


# ------------------------------------------ stochastic duration predictor
def dds_conv(p, name, x, mask, g=None, kernel=3, n_layers=3):
    """`modules.py:DDSConv`: dilated depth-separable convs, LayerNorm and
    GELU, each layer added back."""
    if g is not None:
        x = x + g
    for i in range(n_layers):
        d = kernel ** i
        y = conv1d(p, f"{name}.convs_sep.{i}", x * mask,
                   padding=(kernel * d - d) // 2, dilation=d,
                   groups=x.shape[1])
        y = F.gelu(layer_norm(p, f"{name}.norms_1.{i}", y))
        y = conv1d(p, f"{name}.convs_1x1.{i}", y)
        y = F.gelu(layer_norm(p, f"{name}.norms_2.{i}", y))
        x = x + y
    return x * mask


def _spline_inverse(y, uw, uh, ud, bound=TAIL_BOUND):
    """The inverse of `transforms.py`'s unconstrained rational-quadratic
    spline with linear tails on [-bound, bound]: y [...] and its bins'
    widths, heights [..., K] and inner derivatives [..., K - 1] -> x."""
    inside = (y >= -bound) & (y <= bound)
    out = y.clone()
    if not inside.any():
        return out
    y_in = y[inside]
    uw, uh = uw[inside], uh[inside]
    const = float(np.log(np.exp(1 - MIN_DERIVATIVE) - 1))
    ud = F.pad(ud[inside], (1, 1), value=const)
    k = uw.shape[-1]

    def edges(u, lo, hi, least):
        s = least + (1 - least * k) * F.softmax(u, dim=-1)
        c = F.pad(torch.cumsum(s, dim=-1), (1, 0))
        c = (hi - lo) * c + lo
        c[..., 0], c[..., -1] = lo, hi
        return c, c[..., 1:] - c[..., :-1]

    cw, widths = edges(uw, -bound, bound, MIN_BIN_WIDTH)
    ch, heights = edges(uh, -bound, bound, MIN_BIN_HEIGHT)
    derivs = MIN_DERIVATIVE + F.softplus(ud)
    shifted = ch.clone()
    shifted[..., -1] += 1e-6
    idx = (torch.sum(y_in[..., None] >= shifted, dim=-1) - 1)[..., None]

    def at(t):
        return t.gather(-1, idx)[..., 0]

    x_lo, w, y_lo, h = at(cw), at(widths), at(ch), at(heights)
    delta = at(heights / widths)
    d0, d1 = at(derivs), at(derivs[..., 1:])
    dy = y_in - y_lo
    a = dy * (d0 + d1 - 2 * delta) + h * (delta - d0)
    b = h * d0 - dy * (d0 + d1 - 2 * delta)
    c = -delta * dy
    root = (2 * c) / (-b - torch.sqrt(b.pow(2) - 4 * a * c))
    out[inside] = root * w + x_lo
    return out


def _conv_flow_reverse(p, name, z, mask, cond):
    """`modules.py:ConvFlow` reversed: the second channel through the
    inverse spline that the first channel's convs parametrise."""
    z0, z1 = z[:, :1], z[:, 1:]
    h = conv1d(p, f"{name}.pre", z0)
    # the filter channels (the predictor's input width, models.py:25)
    scale = math.sqrt(h.shape[1])
    h = dds_conv(p, f"{name}.convs", h, mask, cond)
    h = conv1d(p, f"{name}.proj", h) * mask
    b, _, t = z0.shape
    h = h.reshape(b, 1, -1, t).permute(0, 1, 3, 2)
    z1 = _spline_inverse(z1, h[..., :NUM_BINS] / scale,
                         h[..., NUM_BINS:2 * NUM_BINS] / scale,
                         h[..., 2 * NUM_BINS:])
    return torch.cat([z0, z1], dim=1) * mask


def sdp_reverse(p, h, x_mask, g, w_eps, noise_scale_w):
    """`StochasticDurationPredictor.forward(reverse=True)`: the text states
    h [B, H, T] (and g) condition the reversed flows, which take the
    noise w_eps [B, 2, T] times `noise_scale_w` to logw [B, 1, T]."""
    x = conv1d(p, "dp.pre", h.detach())
    if g is not None:
        x = x + conv1d(p, "dp.cond", g.detach())
    x = dds_conv(p, "dp.convs", x, x_mask)
    x = conv1d(p, "dp.proj", x) * x_mask
    z = w_eps * noise_scale_w
    for i in range(SDP_FLOWS - 1, 0, -1):  # the first ConvFlow is dropped
        z = _conv_flow_reverse(p, f"dp.flows.{1 + 2 * i}",
                               torch.flip(z, dims=(1,)), x_mask, x)
    z = torch.flip(z, dims=(1,))
    z = (z - p["dp.flows.0.m"]) * torch.exp(-p["dp.flows.0.logs"]) * x_mask
    return z[:, :1]


# ------------------------------------------------------------ inference
def _durations(p, m, x, x_lengths, sid, w_eps, noise_scale_w, length_scale):
    g = p["emb_g.weight"][sid][:, :, None] if sid is not None else None
    h, m_p, logs_p, x_mask = text_encoder(p, m, x, x_lengths, False)
    logw = sdp_reverse(p, h, x_mask, g, w_eps, noise_scale_w)
    w_ceil = torch.ceil(torch.exp(logw) * x_mask * length_scale)
    return g, m_p, logs_p, x_mask, w_ceil


def infer(p, m, x, x_lengths, sid, eps, w_eps, frames, noise_scale=0.667,
          length_scale=1.0, noise_scale_w=0.8):
    """Text -> waveform at `frames` output frames (a row's predicted
    frames beyond it are cut): ids [B, T_x], sid [B] (None: no
    speakers), eps [B, C, frames] the prior's noise, w_eps [B, 2, T_x]
    the duration predictor's. Returns (waveform [B, frames * hop],
    y_lengths [B])."""
    g, m_p, logs_p, x_mask, w_ceil = _durations(
        p, m, x, x_lengths, sid, w_eps, noise_scale_w, length_scale)
    y_lengths = torch.clamp(w_ceil.sum(dim=(1, 2)), min=1).clamp(max=frames)
    y_mask = seq_mask(y_lengths, frames)[:, None]
    attn = generate_path(w_ceil[:, 0], y_mask.transpose(1, 2) * x_mask)
    m_p = m_p @ attn.transpose(1, 2)
    logs_p = logs_p @ attn.transpose(1, 2)
    z_p = m_p + eps * torch.exp(logs_p) * noise_scale
    z = flow(p, z_p, y_mask, g, reverse=True)
    return generator(p, m, z * y_mask, g)[:, 0], y_lengths.long()


def predicted_frames(p, m, x, x_lengths, sid, w_eps, noise_scale_w=0.8,
                     length_scale=1.0):
    """The duration predictor's frames of each row [B] under w_eps."""
    w_ceil = _durations(p, m, x, x_lengths, sid, w_eps, noise_scale_w,
                        length_scale)[-1]
    return torch.clamp(w_ceil.sum(dim=(1, 2)), min=1).long()
