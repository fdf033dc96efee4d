"""GAN, feature-matching, KL and multi-resolution STFT losses (counterpart
of `mb_istft_vits_tpu/losses.py`; reference `losses.py`, `stft_loss.py`).

Every loss is computed in float32 whatever the compute dtype, as the
reference keeps its losses out of autocast (train_latest.py:190,205).
Discriminator outputs and feature maps are lists over the sub-
discriminators; layouts are torch's ([B, C, ...])."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from mb_istft_vits_torch.dsp.stft import stft_magnitude


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """x2-weighted L1 feature matching; the real maps carry no gradient
    (reference losses.py:9-17)."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach().float()
                                               - gl.float()))
    return loss * 2


def discriminator_loss(disc_real_outputs, disc_generated_outputs
                       ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                  List[torch.Tensor]]:
    """LSGAN discriminator loss (reference losses.py:20-33)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean((1 - dr.float()) ** 2)
        g_loss = torch.mean(dg.float() ** 2)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """LSGAN generator loss (reference losses.py:36-45)."""
    gen_losses = [torch.mean((1 - dg.float()) ** 2) for dg in disc_outputs]
    return sum(gen_losses), gen_losses


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask) -> torch.Tensor:
    """Masked gaussian KL between posterior and prior, over the masked
    frames (reference losses.py:48-63): z_p .. logs_p [B, C, T], z_mask
    [B, 1, T] (or the same transposed)."""
    z_p, logs_q, m_p, logs_p, z_mask = (
        v.float() for v in (z_p, logs_q, m_p, logs_p, z_mask))
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / torch.sum(z_mask)


def stft_loss_pair(x: torch.Tensor, y: torch.Tensor, fft_size: int,
                   hop: int, win: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(spectral convergence, log-magnitude L1) at one resolution
    (reference stft_loss.py:31-94); x, y [B, T]."""
    x_mag = stft_magnitude(x.float(), fft_size, hop, win, center=True,
                           eps=1e-7)
    y_mag = stft_magnitude(y.float(), fft_size, hop, win, center=True,
                           eps=1e-7)
    sc = torch.linalg.norm(y_mag - x_mag) / torch.linalg.norm(y_mag)
    mag = torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))
    return sc, mag


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor,
                               fft_sizes: Sequence[int],
                               hop_sizes: Sequence[int],
                               win_lengths: Sequence[int]
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MR-STFT loss averaged over the resolutions (reference
    stft_loss.py:97-135)."""
    sc_loss, mag_loss = 0.0, 0.0
    for fs, hs, wl in zip(fft_sizes, hop_sizes, win_lengths):
        sc, mag = stft_loss_pair(x, y, fs, hs, wl)
        sc_loss = sc_loss + sc
        mag_loss = mag_loss + mag
    n = len(fft_sizes)
    return sc_loss / n, mag_loss / n


def subband_stft_loss(y_mb: torch.Tensor, y_hat_mb: torch.Tensor,
                      fft_sizes: Sequence[int], hop_sizes: Sequence[int],
                      win_lengths: Sequence[int]) -> torch.Tensor:
    """MR-STFT on band-major sub-band signals [B, S, T_sub], flattened to
    [B * S, T] and cut to the shorter length (reference losses.py:65-70)."""
    y = y_mb.reshape(-1, y_mb.shape[-1])
    y_hat = y_hat_mb.reshape(-1, y_hat_mb.shape[-1])
    t = min(y.shape[-1], y_hat.shape[-1])
    sc, mag = multi_resolution_stft_loss(y_hat[:, :t], y[:, :t], fft_sizes,
                                         hop_sizes, win_lengths)
    return sc + mag
