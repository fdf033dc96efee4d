"""The benchmark's own count of a training step's floating-point
operations, worked out from the configuration and each row's real
lengths, whatever implements the step.

It counts the convolutions and matrix products that the published step
needs, 2 operations a multiply-add: the generator forward once; the
discriminator step's forward on the real and the detached fake slices
and its backward (weight gradients, and input gradients past the first
layer); the generator step's discriminator forward on both slices and
the input gradients of the fake half through it (the real half's
feature maps are targets and need no gradient); the generator's
backward (input and weight gradients of every layer that has them; the
duration predictor's input is detached); the mel and sub-band losses'
filter products. FFTs, element-wise work and the optimizers are not
counted. Each row is counted at its own text and frame lengths, so work
on padding counts against the step's share of the peak."""

from __future__ import annotations

from typing import Sequence

SAMPLES = 8192  # the decoder's slice, segment_size


def _conv(c_out, c_in, k, t, groups=1):
    return 2.0 * c_out * (c_in // groups) * k * t


def text_encoder(m, t):
    h, f, k, c = (m["hidden_channels"], m["filter_channels"],
                  m["kernel_size"], m["inter_channels"])
    layer = (4 * _conv(h, h, 1, t)          # q, k, v, o
             + 2 * 2.0 * t * t * h          # scores, weights x values
             + 2 * 2.0 * t * (2 * t - 1) * h  # relative keys and values
             + _conv(f, h, k, t) + _conv(h, f, k, t))
    return m["n_layers"] * layer + _conv(2 * c, h, 1, t)


def _widths(m):
    return (m["hidden_channels"], m["inter_channels"],
            m.get("gin_channels", 0))


def _wavenet(h, n_layers, t, gin):
    per = sum(_conv(2 * h, h, 5, t) + _conv(2 * h if i < n_layers - 1
                                            else h, h, 1, t)
              for i in range(n_layers))
    return per + (_conv(2 * h * n_layers, gin, 1, 1) if gin else 0.0)


def posterior(m, bins, t):
    h, c, gin = _widths(m)
    return (_conv(h, bins, 1, t), _wavenet(h, 16, t, gin)
            + _conv(2 * c, h, 1, t))


def flow(m, t):
    h, c, gin = _widths(m)
    return 4 * (_conv(h, c // 2, 1, t) + _wavenet(h, 4, t, gin)
                + _conv(c // 2, h, 1, t))


def duration(m, t):
    """(first conv, the rest): the first conv's input is detached."""
    h, _, gin = _widths(m)
    cond = _conv(h, gin, 1, 1) if gin else 0.0
    return (_conv(256, h, 3, t), cond + _conv(256, 256, 3, t)
            + _conv(1, 256, 1, t))


def decoder(m, frames: int):
    """(the generator head on one row's slice of `frames` frames, its
    fixed synthesis filter, which has no weight gradient)."""
    ch, gin = m["upsample_initial_channel"], m.get("gin_channels", 0)
    total = _conv(ch, m["inter_channels"], 7, frames)
    t = frames
    for u, k in zip(m["upsample_rates"], m["upsample_kernel_sizes"]):
        total += 2.0 * ch * (ch // 2) * k * t  # transposed conv, per input
        ch, t = ch // 2, t * u
        for rk, dil in zip(m["resblock_kernel_sizes"],
                           m["resblock_dilation_sizes"]):
            total += 2 * len(dil) * _conv(ch, ch, rk, t)
            if gin:
                total += _conv(ch, gin, 1, 1)
    s, n_fft = m["subbands"], m["gen_istft_n_fft"]
    total += _conv(s * (n_fft + 2), ch, 7, t + 1)
    synth = _conv(1, s, 63, SAMPLES)
    if m.get("ms_istft_vits"):
        return total + synth, 0.0
    return total, synth


def discriminator(samples: int = SAMPLES):
    """(forward of one waveform, forward of its first layers): the scale
    discriminator and the periods 2, 3, 5, 7, 11."""
    total, first = 0.0, 0.0
    t, c_in = samples, 1
    for i, (c, k, s, g) in enumerate(((16, 15, 1, 1), (64, 41, 4, 4),
                                      (256, 41, 4, 16), (1024, 41, 4, 64),
                                      (1024, 41, 4, 256), (1024, 5, 1, 1))):
        t = t // s
        f = _conv(c, c_in, k, t, g)
        total += f
        first += f if i == 0 else 0.0
        c_in = c
    total += _conv(1, 1024, 3, t)
    for p in (2, 3, 5, 7, 11):
        h, c_in = -(-samples // p), 1
        for i, c in enumerate((32, 128, 512, 1024, 1024)):
            h = (h + 4 - 5) // (3 if i < 4 else 1) + 1
            f = 2.0 * c * c_in * 5 * h * p
            total += f
            first += f if i == 0 else 0.0
            c_in = c
        total += 2.0 * 1024 * 3 * h * p
    return total, first


def mel(data, frames: int):
    return 2.0 * data["n_mel_channels"] * (data["filter_length"] // 2 + 1) \
        * frames


def step_flops(cfg, rows: Sequence[tuple]) -> float:
    """The operations of one training step over rows of (text ids,
    spectrogram frames)."""
    m, d = cfg["model"], cfg["data"]
    bins = d["filter_length"] // 2 + 1
    seg_frames = SAMPLES // d["hop_length"]
    dec, synth = decoder(m, seg_frames)
    d_fwd, d_first = discriminator()
    per_row_fixed = (
        3 * dec + 2 * synth              # forward, input and weight grads
        + 2 * d_fwd + 2 * d_fwd + (2 * d_fwd - 2 * d_first)  # D step
        + 2 * d_fwd + d_fwd              # G step: both slices, fake grads
        + 3 * mel(d, seg_frames))        # real (no grad), fake (+ grad)
    if m.get("mb_istft_vits"):
        per_row_fixed += 2.0 * m["subbands"] * 63 * SAMPLES  # analysis
    total = 0.0
    c = m["inter_channels"]
    for t_x, t_y in rows:
        pre, rest = posterior(m, bins, t_y)
        first, dp_rest = duration(m, t_x)
        total += (3 * text_encoder(m, t_x)
                  + 2 * pre + 3 * rest
                  + 3 * flow(m, t_y)
                  + (3 if _widths(m)[2] else 2) * first + 3 * dp_rest
                  + 2 * 2.0 * t_y * t_x * c      # MAS log-likelihoods
                  + 4 * 2.0 * c * t_x * t_y      # prior expansion, grads
                  + per_row_fixed)
    return total
