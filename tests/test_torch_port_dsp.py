"""The port's `dsp` package against the JAX package's on the CPU: the
public names of `dsp/__init__.py`, `hann_window`, the channels-last
`PQMFBank.analysis` / `.synthesis` and the `TorchSTFT` stand-in, each
within 1e-4 (max-abs) of JAX's on the same numpy inputs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import mb_istft_vits_torch.dsp as port_dsp
import mb_istft_vits_tpu.dsp as jax_dsp
from mb_istft_vits_torch.dsp.pqmf import PQMF
from mb_istft_vits_tpu.dsp.stft import TorchSTFT as JaxTorchSTFT

from tests.torch_port_common import ATOL, assert_close, n, t

# the JAX package's jnp-only spelling and the port's torch one
RENAMED = {"resample_poly_jax": "resample_poly_torch"}


def test_dsp_exports_the_jax_packages_names():
    names = [k for k in vars(jax_dsp) if not k.startswith("_")
             and callable(getattr(jax_dsp, k))]
    assert len(names) == 15
    missing = [k for k in names if not hasattr(port_dsp, RENAMED.get(k, k))]
    assert missing == []
    assert port_dsp.PQMFBank is PQMF  # the decoder's filterbank


@pytest.mark.parametrize("win_length", [4, 16, 800, 1024])
def test_hann_window_matches_jax(win_length):
    got = port_dsp.hann_window(win_length)
    assert got.dtype == torch.float32
    assert_close(n(got), jax_dsp.hann_window(win_length), what="hann")


@pytest.mark.parametrize("subbands,t_len", [(4, 256), (4, 1001), (2, 130)])
def test_pqmf_bank_channels_last_matches_jax(subbands, t_len):
    rng = np.random.RandomState(t_len)
    wav = rng.uniform(-1, 1, (2, t_len, 1)).astype(np.float32)
    ours, theirs = port_dsp.PQMFBank(subbands), jax_dsp.PQMFBank(subbands)
    bands = ours.analysis(t(wav))
    assert bands.shape == (2, -(-t_len // subbands), subbands)
    assert_close(n(bands), np.asarray(theirs.analysis(wav)),
                 what="analysis")
    sub = rng.randn(2, t_len // subbands, subbands).astype(np.float32)
    out = ours.synthesis(t(sub))
    assert out.shape == (2, (t_len // subbands) * subbands, 1)
    assert_close(n(out), np.asarray(theirs.synthesis(sub)), what="synthesis")
    # the channels-last methods are the band-major ones transposed
    np.testing.assert_array_equal(
        n(bands), n(ours.analysis_bm(t(wav).transpose(1, 2)).transpose(1, 2)))


@pytest.mark.parametrize("fl,hop,wl", [(800, 200, 800), (16, 4, 16),
                                       (64, 16, 48)])
def test_torch_stft_matches_jax(fl, hop, wl):
    rng = np.random.RandomState(fl)
    y = rng.uniform(-1, 1, (2, 40 * hop)).astype(np.float32)
    ours, theirs = port_dsp.TorchSTFT(fl, hop, wl), JaxTorchSTFT(fl, hop, wl)
    mag, phase = ours.transform(t(y))
    jmag, jphase = (np.asarray(a) for a in theirs.transform(y))
    assert_close(n(mag), jmag, atol=ATOL * max(1.0, float(jmag.max()) / 10),
                 what="magnitude")
    # the phase is defined where the magnitude is not ~0; compare it on
    # the unit circle there (angles near +-pi wrap)
    keep = jmag > 1e-2
    for f in (np.cos, np.sin):
        assert_close(f(n(phase))[keep], f(jphase)[keep], what="phase")
    # inverse of the same magnitude and phase: [B, 1, T]
    wav = ours.inverse(t(jmag), t(jphase))
    want = np.asarray(theirs.inverse(jmag, jphase))
    assert wav.shape == want.shape and wav.shape[1] == 1
    assert_close(n(wav), want, what="inverse")


def test_spectral_normalize_matches_jax():
    x = np.exp(np.random.RandomState(0).randn(3, 80, 7)).astype(np.float32)
    x[0, 0, :3] = 0.0  # clipped at 1e-5
    assert_close(n(port_dsp.spectral_normalize(t(x))),
                 np.asarray(jax_dsp.spectral_normalize(x)), what="log")
