"""Multi-period + scale discriminator (counterpart of
`mb_istft_vits_tpu/models/discriminator.py`; reference `models.py:477-564`).

State-dict names are the reference's (`discriminators.0` is the scale
discriminator, `discriminators.1..5` the periods 2, 3, 5, 7, 11), so a
reference `D_*.pth` loads as it is. Waveforms are [B, 1, T]; feature maps
are torch's [B, C, T] and [B, C, T/p, p]. The widths are fixed by the
reference, not by the config.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mb_istft_vits_torch.nn import Conv1d, Conv2d, get_padding, leaky_relu


class DiscriminatorP(nn.Module):
    """Period discriminator: fold time into [T/p, p] and run (k, 1) 2-D
    convs (reference models.py:477-511)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (get_padding(kernel_size, 1), 0)
        chans = [1, 32, 128, 512, 1024]
        self.convs = nn.ModuleList(
            Conv2d(c_in, c_out, (kernel_size, 1), (stride, 1), pad,
                   weight_norm=True)
            for c_in, c_out in zip(chans[:-1], chans[1:]))
        self.convs.append(Conv2d(1024, 1024, (kernel_size, 1), (1, 1), pad,
                                 weight_norm=True))
        self.conv_post = Conv2d(1024, 1, (3, 1), (1, 1), (1, 0),
                                weight_norm=True)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x [B, 1, T] -> (scores [B, T'], feature maps)."""
        b, c, t = x.shape
        p = self.period
        if t % p != 0:
            x = F.pad(x, (0, p - t % p), mode="reflect")
        x = x.view(b, c, -1, p)
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1), fmap


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped 1-D convs (reference models.py:514-539)."""

    # (out channels, kernel, stride, groups, padding); input 1 channel
    SPECS = ((16, 15, 1, 1, 7), (64, 41, 4, 4, 20), (256, 41, 4, 16, 20),
             (1024, 41, 4, 64, 20), (1024, 41, 4, 256, 20), (1024, 5, 1, 1, 2))

    def __init__(self):
        super().__init__()
        c_in = 1
        self.convs = nn.ModuleList()
        for c_out, k, s, g, pad in self.SPECS:
            self.convs.append(Conv1d(c_in, c_out, k, stride=s, padding=pad,
                                     groups=g, weight_norm=True))
            c_in = c_out
        self.conv_post = Conv1d(1024, 1, 3, padding=1, weight_norm=True)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """S + P{2,3,5,7,11} ensemble (reference models.py:542-564)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.discriminators = nn.ModuleList(
            [DiscriminatorS()] + [DiscriminatorP(p) for p in periods])

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """Real y and generated y_hat [B, 1, T] -> (y_d_rs, y_d_gs,
        fmap_rs, fmap_gs), one entry per sub-discriminator.

        The convs see each item alone, so both halves go through each
        sub-discriminator as one batch of 2B: the reference's two passes in
        one. Only when y_hat takes a gradient and nothing else can (y needs
        none, nor does any of D's parameters: the generator's step, where
        the real maps are targets) does the real half go alone under
        `no_grad`, so autograd records, and the backward runs, the B fake
        rows only."""
        b = y.shape[0]
        y_hat = y_hat.to(y.dtype)
        real_is_target = (
            torch.is_grad_enabled() and y_hat.requires_grad
            and not y.requires_grad
            and not any(p.requires_grad for p in self.parameters()))
        both = None if real_is_target else torch.cat([y, y_hat])
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            if real_is_target:
                with torch.no_grad():
                    score_r, fmap_r = d(y)
                score_g, fmap_g = d(y_hat)
            else:
                score, fmap = d(both)
                score_r, score_g = score[:b], score[b:]
                fmap_r, fmap_g = [f[:b] for f in fmap], [f[b:] for f in fmap]
            y_d_rs.append(score_r)
            y_d_gs.append(score_g)
            fmap_rs.append(fmap_r)
            fmap_gs.append(fmap_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
