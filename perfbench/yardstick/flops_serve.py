"""The benchmark's own count of a served request's floating-point
operations, from the configuration and the request's real lengths,
whatever implements it: the text encoder, the duration predictor (the
deterministic one, or the stochastic one's reverse: its text convs and
three ConvFlows), the prior's expansion over the frames, the flow's
reverse, and the decoder head at the request's frames (the iSTFT heads'
trunk and post conv, and the fixed PQMF synthesis or the multi-stream
synthesis conv; VITS's HiFi-GAN trunk, its speaker `cond` conv and its
one-channel post conv). It uses `flops.py`'s terms as they are, 2
operations a multiply-add; FFTs, the spline and element-wise work are not
counted, nor the padding a decode adds."""

from __future__ import annotations

import math

from perfbench.yardstick import flops
from perfbench.yardstick.flops import _conv


def _dds(ch, t, kernel=3, n_layers=3):
    """A DDSConv: depthwise convs and 1x1 convs."""
    return n_layers * (_conv(ch, ch, kernel, t, groups=ch)
                       + _conv(ch, ch, 1, t))


def sdp_reverse(m, t_x):
    """The stochastic duration predictor's reverse: pre, cond, its DDSConv
    and proj on the text, then three ConvFlows (pre, DDSConv, the spline's
    parameters)."""
    h, _, gin = flops._widths(m)
    text = (_conv(h, h, 1, t_x) + (_conv(h, gin, 1, 1) if gin else 0.0)
            + _dds(h, t_x) + _conv(h, h, 1, t_x))
    conv_flow = _conv(h, 1, 1, t_x) + _dds(h, t_x) + _conv(29, h, 1, t_x)
    return text + 3 * conv_flow


def head(m, data, frames):
    """The decoder head on one row of `frames` frames."""
    if not (m.get("mb_istft_vits") or m.get("ms_istft_vits")
            or m.get("istft_vits")):
        up = math.prod(m["upsample_rates"])
        ch_in = m["upsample_initial_channel"]
        trunk = flops.decoder(dict(m, subbands=0, gen_istft_n_fft=0,
                                   gin_channels=0), frames)[0]
        cond = _conv(ch_in, m["gin_channels"], 1, 1) \
            if m.get("gin_channels") else 0.0
        ch_out = ch_in // 2 ** len(m["upsample_rates"])
        return trunk + cond + _conv(1, ch_out, 7, frames * up)
    total, _ = flops.decoder(dict(m, subbands=m.get("subbands") or 1)
                             if m.get("istft_vits") else m, frames)
    if m.get("mb_istft_vits"):
        total += _conv(1, m["subbands"], 63, frames * data["hop_length"])
    return total


def request_flops(cfg, t_x: int, t_y: int) -> float:
    """The operations of one served row of `t_x` ids and `t_y` frames."""
    m, d = cfg["model"], cfg["data"]
    c = m["inter_channels"]
    if m.get("use_sdp"):
        dur = sdp_reverse(m, t_x)
    else:
        dur = sum(flops.duration(m, t_x))
    return (flops.text_encoder(m, t_x) + dur
            + 2 * 2.0 * c * t_x * t_y      # m_p, logs_p over the frames
            + flops.flow(m, t_y) + head(m, d, t_y))
