"""A plain PyTorch MB-iSTFT-VITS, written from the published model
(VITS, Kim et al. 2021; MB-iSTFT-VITS, Kawamura et al. 2023; the
reference code's `models.py`, `modules.py`, `attentions.py`, `losses.py`,
`pqmf.py`, `stft_loss.py`, `mel_processing.py`), as functions of a weight
dict (the reference code's state-dict names). It is the benchmark's
yardstick for `correct` and imports nothing of the measured program.

Layouts: activations [B, C, T], masks [B, 1, T], waveforms [B, 1, T].
Dropout is `F.dropout` at the published places, in the published order,
so that a caller that seeds torch's generator alike before a training
forward gets the program's masks (the program draws them from the same
generator, in the same order and shapes).

Departures from the reference code, each the measured configuration's:
the flow's coupling layers are mean-only (the reference code's
`mean_only=True`); the speaker embedding conditions the duration
predictor's input through a 1x1 conv and every ResBlock through its own
1x1 conv (the multi-stream fork's `cond` convs); the linear spectrogram
pads with zeros (this fork's front end) and takes sqrt(power) with no
epsilon.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

LRELU = 0.1
Weights = Dict[str, torch.Tensor]


# ---------------------------------------------------------------- layers
def weight(p: Weights, name: str) -> torch.Tensor:
    """A conv's weight; weight norm (g, v) as torch.nn.utils.weight_norm:
    w = g * v / ||v||, the norm over every dim but 0."""
    if name + ".weight" in p:
        return p[name + ".weight"]
    v, g = p[name + ".weight_v"], p[name + ".weight_g"]
    return v * (g / v.pow(2).sum(dim=tuple(range(1, v.dim())),
                                 keepdim=True).sqrt())


def conv1d(p, name, x, stride=1, padding=0, dilation=1, groups=1):
    return F.conv1d(x, weight(p, name), p.get(name + ".bias"), stride,
                    padding, dilation, groups)


def layer_norm(p, name, x, eps=1e-5):
    """LayerNorm over the channels of [B, C, T]."""
    mean = x.mean(dim=1, keepdim=True)
    var = (x - mean).pow(2).mean(dim=1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    return y * p[name + ".gamma"][None, :, None] + p[name + ".beta"][None, :,
                                                                       None]


def seq_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    return (torch.arange(t, device=lengths.device)[None]
            < lengths[:, None]).float()


def dropout(x, p, train):
    return F.dropout(x, p, train) if train and p > 0 else x


# ----------------------------------------------------------- text encoder
def _rel_to_abs(x):
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1)).view(b, h, l * 2 * l)
    x = F.pad(x, (0, l - 1)).view(b, h, l + 1, 2 * l - 1)
    return x[:, :, :l, l - 1:]


def _abs_to_rel(x):
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1)).view(b, h, l * l + l * (l - 1))
    x = F.pad(x, (l, 0)).view(b, h, l, 2 * l)
    return x[:, :, :, 1:]


def _rel_emb(emb, length, window):
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    if pad > 0:
        emb = F.pad(emb, (0, 0, pad, pad))
    return emb[:, start:start + 2 * length - 1]


def attention(p, name, x, mask, n_heads, p_drop, train, window=4):
    b, c, t = x.shape
    dk = c // n_heads

    def split(z):
        return z.view(b, n_heads, dk, t).transpose(2, 3)

    q = split(conv1d(p, name + ".conv_q", x)) * (1.0 / math.sqrt(dk))
    k = split(conv1d(p, name + ".conv_k", x))
    v = split(conv1d(p, name + ".conv_v", x))
    scores = q @ k.transpose(-2, -1)
    rel_k = _rel_emb(p[name + ".emb_rel_k"], t, window)
    scores = scores + _rel_to_abs(q @ rel_k[0].t())
    scores = scores.masked_fill(mask == 0, -1e4)
    attn = dropout(torch.softmax(scores, dim=-1), p_drop, train)
    out = attn @ v
    rel_v = _rel_emb(p[name + ".emb_rel_v"], t, window)
    out = out + _abs_to_rel(attn) @ rel_v[0]
    out = out.transpose(2, 3).reshape(b, c, t)
    return conv1d(p, name + ".conv_o", out)


def ffn(p, name, x, mask, k, p_drop, train):
    pad = ((k - 1) // 2, k // 2)
    y = conv1d(p, name + ".conv_1", F.pad(x * mask, pad))
    y = dropout(torch.relu(y), p_drop, train)
    y = conv1d(p, name + ".conv_2", F.pad(y * mask, pad))
    return y * mask


def text_encoder(p, m, x, x_lengths, train):
    """ids [B, T] -> (h, m_p, logs_p [B, C, T], x_mask [B, 1, T])."""
    hc = m["hidden_channels"]
    h = (F.embedding(x, p["enc_p.emb.weight"]) * math.sqrt(hc)).transpose(1,
                                                                          2)
    x_mask = seq_mask(x_lengths, x.shape[1])[:, None]
    attn_mask = x_mask[:, :, None] * x_mask[:, :, :, None]
    h = h * x_mask
    pd = m["p_dropout"]
    for i in range(m["n_layers"]):
        e = f"enc_p.encoder.{{}}.{i}"
        y = attention(p, e.format("attn_layers"), h, attn_mask,
                      m["n_heads"], pd, train)
        h = layer_norm(p, e.format("norm_layers_1"),
                       h + dropout(y, pd, train))
        y = ffn(p, e.format("ffn_layers"), h, x_mask, m["kernel_size"], pd,
                train)
        h = layer_norm(p, e.format("norm_layers_2"),
                       h + dropout(y, pd, train))
    h = h * x_mask
    stats = conv1d(p, "enc_p.proj", h) * x_mask
    m_p, logs_p = stats.split(m["inter_channels"], dim=1)
    return h, m_p, logs_p, x_mask


# ------------------------------------------------- WaveNet, flow, encoders
def wavenet(p, name, x, mask, g, n_layers, kernel=5, rate=1):
    hc = x.shape[1]
    out = torch.zeros_like(x)
    g_all = conv1d(p, name + ".cond_layer", g) if g is not None else None
    for i in range(n_layers):
        d = rate ** i
        x_in = conv1d(p, f"{name}.in_layers.{i}", x,
                      padding=(kernel * d - d) // 2, dilation=d)
        if g_all is not None:
            x_in = x_in + g_all[:, i * 2 * hc:(i + 1) * 2 * hc]
        acts = torch.tanh(x_in[:, :hc]) * torch.sigmoid(x_in[:, hc:])
        rs = conv1d(p, f"{name}.res_skip_layers.{i}", acts)
        if i < n_layers - 1:
            x = (x + rs[:, :hc]) * mask
            out = out + rs[:, hc:]
        else:
            out = out + rs
    return out * mask


def posterior(p, spec, lengths, g, eps):
    """spec [B, bins, T] -> (z, m_q, logs_q, y_mask)."""
    y_mask = seq_mask(lengths, spec.shape[2])[:, None]
    h = wavenet(p, "enc_q.enc", conv1d(p, "enc_q.pre", spec) * y_mask,
                y_mask, g, 16)
    stats = conv1d(p, "enc_q.proj", h) * y_mask
    m_q, logs_q = stats.split(stats.shape[1] // 2, dim=1)
    return (m_q + eps * torch.exp(logs_q)) * y_mask, m_q, logs_q, y_mask


def _coupling(p, i, x, mask, g, reverse):
    half = x.shape[1] // 2
    x0, x1 = x[:, :half], x[:, half:]
    name = f"flow.flows.{2 * i}"
    h = wavenet(p, name + ".enc", conv1d(p, name + ".pre", x0) * mask, mask,
                g, 4)
    mean = conv1d(p, name + ".post", h) * mask
    x1 = (x1 - mean) * mask if reverse else (mean + x1) * mask
    return torch.cat([x0, x1], dim=1)


def flow(p, x, mask, g, reverse=False, n_flows=4):
    """Four mean-only affine couplings, each followed by a channel flip."""
    if not reverse:
        for i in range(n_flows):
            x = torch.flip(_coupling(p, i, x, mask, g, False), dims=(1,))
        return x
    for i in reversed(range(n_flows)):
        x = _coupling(p, i, torch.flip(x, dims=(1,)), mask, g, True)
    return x


def duration_predictor(p, h, x_mask, g, p_drop, train):
    x = h.detach()
    if g is not None:
        x = x + conv1d(p, "dp.cond", g)
    x = conv1d(p, "dp.conv_1", x * x_mask, padding=1)
    x = dropout(layer_norm(p, "dp.norm_1", torch.relu(x)), p_drop, train)
    x = conv1d(p, "dp.conv_2", x * x_mask, padding=1)
    x = dropout(layer_norm(p, "dp.norm_2", torch.relu(x)), p_drop, train)
    return conv1d(p, "dp.proj", x * x_mask) * x_mask


# ----------------------------------------------------------------- MAS
def neg_cent(z_p, m_p, logs_p):
    """[B, T_y, T_x] log-likelihood of frame y under token x's prior."""
    s = torch.exp(-2.0 * logs_p)
    nc1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_p, 1, keepdim=True)
    nc2 = (-0.5 * z_p * z_p).transpose(1, 2) @ s
    nc3 = z_p.transpose(1, 2) @ (m_p * s)
    nc4 = torch.sum(-0.5 * m_p * m_p * s, 1, keepdim=True)
    return nc1 + nc2 + nc3 + nc4


def maximum_path(nc: torch.Tensor, t_ys, t_xs) -> torch.Tensor:
    """The monotonic alignment search of the reference code's
    `monotonic_align/core.pyx` in float32 with numpy, vectorised over the
    batch: value[y, x] = nc[y, x] + max(value[y-1, x], value[y-1, x-1])
    inside each item's band; the backtrack steps down a token where the
    diagonal predecessor is strictly larger, or where it must."""
    value = nc.detach().float().cpu().numpy().copy()
    b, t_y_max, t_x_max = value.shape
    t_ys = np.asarray(t_ys, np.int64)
    t_xs = np.asarray(t_xs, np.int64)
    neg = np.float32(-1e9)
    xs = np.arange(t_x_max)[None]
    for y in range(t_y_max):
        lo = (t_xs + y - t_ys)[:, None]
        hi = np.minimum(t_xs, y + 1)[:, None]
        band = (xs >= lo) & (xs < hi) & (y < t_ys)[:, None]
        if y == 0:
            prev = np.where(xs == 0, np.float32(0.0), neg)
            cur = np.full(xs.shape, neg, np.float32)
        else:
            row = value[:, y - 1]
            shifted = np.pad(row, ((0, 0), (1, 0)))[:, :-1]  # value[y-1, x-1]
            prev = np.where(xs == 0, neg, shifted)
            cur = np.where(xs == y, neg, row)
        value[:, y] += np.where(band, np.maximum(prev, cur), np.float32(0.0))
    path = np.zeros((b, t_y_max, t_x_max), np.float32)
    rows = np.arange(b)
    index = t_xs - 1
    for y in range(t_y_max - 1, -1, -1):
        live = y < t_ys
        path[rows[live], y, index[live]] = 1.0
        if y == 0:
            break
        up = value[rows, y - 1, index]
        diag = value[rows, y - 1, np.maximum(index - 1, 0)]
        step = live & (index != 0) & ((index == y) | (up < diag))
        index = index - step
    return torch.from_numpy(path).to(nc.device)


def generate_path(w_ceil: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Durations [B, T_x] -> alignment [B, T_y, T_x] under mask."""
    cum = torch.cumsum(w_ceil, dim=1)
    t_y = mask.shape[1]
    frames = torch.arange(t_y, device=w_ceil.device, dtype=cum.dtype)
    ends = (frames[None, :, None] < cum[:, None, :]).float()
    starts = F.pad(ends, (1, 0))[:, :, :-1]
    return (ends - starts) * mask


# ------------------------------------------------------------------ DSP
def hann(n: int, device) -> torch.Tensor:
    return torch.hann_window(n, periodic=True, dtype=torch.float32,
                             device=device)


def istft(mag, phase, n_fft, hop):
    """center=True inverse STFT of mag * e^{i phase} [N, bins, F] with a
    periodic Hann window of n_fft: irfft, window, overlap-add, division by
    the window's squared overlap-add (1 where it vanishes), trimmed."""
    frames = torch.fft.irfft(torch.polar(mag, phase), n_fft, dim=1)
    win = hann(n_fft, mag.device)
    n, _, f = frames.shape
    length = (f - 1) * hop + n_fft
    sig = F.fold(frames * win[None, :, None], (1, length), (1, n_fft),
                 stride=(1, hop)).view(n, length)
    env = F.fold(win.pow(2)[None, :, None].expand(1, n_fft, f), (1, length),
                 (1, n_fft), stride=(1, hop)).view(length)
    env = torch.where(env > torch.finfo(torch.float32).tiny, env,
                      torch.ones_like(env))
    sig = sig / env
    return sig[:, n_fft // 2:length - n_fft // 2]


def pqmf_filters(subbands=4, taps=62, cutoff=0.15, beta=9.0):
    """Cosine-modulated analysis and synthesis filters [s, taps + 1] of a
    Kaiser-windowed prototype (the reference code's `pqmf.py`)."""
    n = np.arange(taps + 1) - 0.5 * taps
    with np.errstate(invalid="ignore", divide="ignore"):
        proto = np.sin(np.pi * cutoff * n) / (np.pi * n)
    proto[taps // 2] = cutoff
    proto = proto * np.kaiser(taps + 1, beta)
    k = np.arange(subbands)[:, None]
    arg = (2 * k + 1) * (np.pi / (2 * subbands)) * (np.arange(taps + 1)
                                                    - (taps - 1) / 2)
    sign = np.where(k % 2 == 0, 1.0, -1.0) * np.pi / 4
    ana = 2 * proto * np.cos(arg + sign)
    syn = 2 * proto * np.cos(arg - sign)
    return ana.astype(np.float32), syn.astype(np.float32)


def pqmf_analysis(x, subbands=4, taps=62):
    ana = torch.from_numpy(pqmf_filters(subbands, taps)[0]).to(x.device)
    y = F.conv1d(F.pad(x, (taps // 2, taps // 2)), ana[:, None])
    return y[:, :, ::subbands]


def pqmf_synthesis(x, subbands=4, taps=62):
    syn = torch.from_numpy(pqmf_filters(subbands, taps)[1]).to(x.device)
    b, s, t = x.shape
    up = torch.zeros(b, s, t * s, device=x.device, dtype=x.dtype)
    up[:, :, ::s] = x * s
    return F.conv1d(F.pad(up, (taps // 2, taps // 2)), syn[None])


def magnitude(y, n_fft, hop, win, center, eps=0.0):
    spec = torch.stft(y, n_fft, hop, win, window=hann(win, y.device),
                      center=center, pad_mode="reflect", return_complex=True)
    power = spec.real.pow(2) + spec.imag.pow(2)
    if eps:
        power = power.clamp(min=eps)
    return power.sqrt()


def linear_spectrogram(y, n_fft, hop, win):
    """[B, T] in [-1, 1] -> [B, bins, F], zero-padded (n_fft - hop) / 2."""
    pad = (n_fft - hop) // 2
    return magnitude(F.pad(y, (pad, pad)), n_fft, hop, win, center=False)


def mel_basis(sr, n_fft, n_mels, fmin=0.0, fmax=None):
    """Slaney-scale, Slaney-normalised mel filters [n_mels, bins]
    (librosa.filters.mel's defaults)."""
    fmax = sr / 2.0 if fmax is None else fmax
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0

    def to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz, min_log_mel + np.log(
            np.maximum(f, 1e-10) / min_log_hz) / logstep, f / f_sp)

    def to_hz(mel):
        return np.where(mel >= min_log_mel, min_log_hz * np.exp(
            logstep * (mel - min_log_mel)), f_sp * mel)

    freqs = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    pts = to_hz(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))
    ramps = pts[:, None] - freqs[None]
    lower = -ramps[:-2] / np.diff(pts)[:-1, None]
    upper = ramps[2:] / np.diff(pts)[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (pts[2:] - pts[:-2]))[:, None]
    return w.astype(np.float32)


def log_mel(spec, d):
    basis = torch.from_numpy(mel_basis(d["sampling_rate"], d["filter_length"],
                                       d["n_mel_channels"], d["mel_fmin"],
                                       d["mel_fmax"])).to(spec.device)
    return torch.log(torch.clamp(basis @ spec, min=1e-5))


# -------------------------------------------------------------- decoder
def decoder(p, m, z, g):
    """z [B, C, T] -> (waveform [B, 1, T * hop], sub-band signals or the
    multi-stream conv input)."""
    x = conv1d(p, "dec.conv_pre", z, padding=3)
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
            if g is not None:
                r = r + conv1d(p, name + ".cond", g)
            for n, d in enumerate(dil):
                t = conv1d(p, f"{name}.convs1.{n}", F.leaky_relu(r, LRELU),
                           padding=(rk * d - d) // 2, dilation=d)
                t = conv1d(p, f"{name}.convs2.{n}", F.leaky_relu(t, LRELU),
                           padding=(rk - 1) // 2)
                r = t + r
            acc = acc + r
        x = acc / len(kernels)
    x = F.pad(F.leaky_relu(x), (1, 0), mode="reflect")
    x = conv1d(p, "dec.subband_conv_post", x, padding=3)
    s, n_fft = m["subbands"], m["gen_istft_n_fft"]
    b, _, t = x.shape
    x = x.view(b * s, n_fft + 2, t)
    bins = n_fft // 2 + 1
    mag, ph = torch.exp(x[:, :bins]), math.pi * torch.sin(x[:, bins:])
    bands = istft(mag, ph, n_fft, m["gen_istft_hop_size"]).view(b, s, -1)
    if m["mb_istft_vits"]:
        return pqmf_synthesis(bands, s), bands
    up = F.pad((bands * s)[..., None], (0, s - 1)).reshape(b, s, -1)
    return conv1d(p, "dec.multistream_conv_post", up, padding=31), up


# --------------------------------------------------------- discriminator
S_SPECS = ((16, 15, 1, 1, 7), (64, 41, 4, 4, 20), (256, 41, 4, 16, 20),
           (1024, 41, 4, 64, 20), (1024, 41, 4, 256, 20), (1024, 5, 1, 1, 2))
PERIODS = (2, 3, 5, 7, 11)


def discriminator(p, y):
    """Scale discriminator then the period ones on y [N, 1, T] ->
    (scores, feature maps), one entry per sub-discriminator."""
    scores, fmaps = [], []
    x, fmap = y, []
    for i, (_, _, s, groups, pad) in enumerate(S_SPECS):
        x = F.leaky_relu(conv1d(p, f"discriminators.0.convs.{i}", x, s, pad,
                                groups=groups), LRELU)
        fmap.append(x)
    x = conv1d(p, "discriminators.0.conv_post", x, padding=1)
    fmap.append(x)
    scores.append(x.flatten(1))
    fmaps.append(fmap)
    for j, period in enumerate(PERIODS, start=1):
        n, c, t = y.shape
        x = y
        if t % period:
            x = F.pad(x, (0, period - t % period), mode="reflect")
        x = x.view(n, c, -1, period)
        fmap = []
        for i in range(5):
            name = f"discriminators.{j}.convs.{i}"
            x = F.leaky_relu(F.conv2d(x, weight(p, name), p[name + ".bias"],
                                      (3 if i < 4 else 1, 1), (2, 0)), LRELU)
            fmap.append(x)
        name = f"discriminators.{j}.conv_post"
        x = F.conv2d(x, weight(p, name), p[name + ".bias"], 1, (1, 0))
        fmap.append(x)
        scores.append(x.flatten(1))
        fmaps.append(fmap)
    return scores, fmaps


# ---------------------------------------------------------- inference
def infer(p, m, x, x_lengths, sid, eps, frames, noise_scale=0.667,
          length_scale=1.0):
    """Text -> waveform at `frames` output frames (a row's predicted
    frames beyond it are cut): ids [B, T_x], eps [B, C, frames] the
    prior's noise. Returns (waveform [B, frames * hop], y_lengths [B])."""
    g = p["emb_g.weight"][sid][:, :, None] if sid is not None else None
    h, m_p, logs_p, x_mask = text_encoder(p, m, x, x_lengths, False)
    logw = duration_predictor(p, h, x_mask, g, 0.0, False)
    w_ceil = torch.ceil(torch.exp(logw) * x_mask * length_scale)
    y_lengths = torch.clamp(w_ceil.sum(dim=(1, 2)), min=1).clamp(max=frames)
    y_mask = seq_mask(y_lengths, frames)[:, None]
    attn = generate_path(w_ceil[:, 0], y_mask.transpose(1, 2) * x_mask)
    m_p = m_p @ attn.transpose(1, 2)
    logs_p = logs_p @ attn.transpose(1, 2)
    z_p = m_p + eps * torch.exp(logs_p) * noise_scale
    z = flow(p, z_p, y_mask, g, reverse=True)
    o, _ = decoder(p, m, z * y_mask, g)
    return o[:, 0], y_lengths.long()


def predicted_frames(p, m, x, x_lengths, sid, length_scale=1.0):
    """The duration predictor's frames of each row [B]."""
    g = p["emb_g.weight"][sid][:, :, None] if sid is not None else None
    h, _, _, x_mask = text_encoder(p, m, x, x_lengths, False)
    logw = duration_predictor(p, h, x_mask, g, 0.0, False)
    w_ceil = torch.ceil(torch.exp(logw) * x_mask * length_scale)
    return torch.clamp(w_ceil.sum(dim=(1, 2)), min=1).long()
