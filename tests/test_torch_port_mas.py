"""Monotonic Alignment Search in the PyTorch port: the plain version is
bit-exact to the numpy transcription of the reference DP and to the JAX
package's Pallas kernels (run in interpret mode); the kernel wrappers
refuse CPU tensors and never fall back. The CUDA kernels themselves are
held against the plain version in test_torch_port_kernels.py (on a card)
and by chip_smoke.py."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mb_istft_vits_tpu.ops.mas import maximum_path_numpy

from mb_istft_vits_torch import kernels
from mb_istft_vits_torch.ops import mas


def _problem(rng, b, t_y, t_x, t_ys=None, t_xs=None):
    """Random neg_cent with ragged lengths (t_y >= t_x for a valid path)."""
    neg_cent = (rng.randn(b, t_y, t_x) * 3).astype(np.float32)
    if t_xs is None:
        t_xs = rng.randint(1, t_x + 1, size=b)
    if t_ys is None:
        t_ys = rng.randint(1, t_y + 1, size=b)
    t_xs, t_ys = np.asarray(t_xs), np.asarray(t_ys)
    t_ys = np.maximum(t_ys, t_xs)
    mask = ((np.arange(t_y)[None, :, None] < t_ys[:, None, None])
            & (np.arange(t_x)[None, None, :] < t_xs[:, None, None])
            ).astype(np.float32)
    return neg_cent, mask


# ragged batches whose edge items have t_x == 1, t_y == t_x, and full size
CASES = {
    "ragged": dict(b=5, t_y=41, t_x=19),
    "edges": dict(b=4, t_y=33, t_x=17, t_ys=[33, 9, 17, 5], t_xs=[1, 9, 17, 5]),
    "rows_not_multiple_of_8": dict(b=3, t_y=29, t_x=29, t_ys=[29, 29, 20],
                                   t_xs=[29, 1, 20]),
}


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU,
    as tests/test_ops.py does."""
    from jax.experimental import pallas as pl

    import mb_istft_vits_tpu.ops.mas_pallas as mp

    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(mp.pl, "pallas_call", interp)
    return mp


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_oracle_and_pallas(interpret_pallas, case):
    neg_cent, mask = _problem(np.random.RandomState(len(case)), **CASES[case])
    oracle = maximum_path_numpy(neg_cent, mask)
    ours = mas.maximum_path(torch.from_numpy(neg_cent), torch.from_numpy(mask))
    np.testing.assert_array_equal(ours.numpy(), oracle)
    for force in ("fused", "two_pass"):
        pallas = np.asarray(interpret_pallas.maximum_path_pallas(
            jnp.asarray(neg_cent), jnp.asarray(mask), force=force))
        np.testing.assert_array_equal(ours.numpy(), pallas, err_msg=force)


def test_plain_halves_compose_and_bits_round_trip():
    rng = np.random.RandomState(1)
    neg_cent, mask = _problem(rng, b=3, t_y=90, t_x=70)  # 3 words per row
    nc = torch.from_numpy(neg_cent) * torch.from_numpy(mask)
    t_ys, t_xs = mas.mas_lengths(torch.from_numpy(mask))
    dec = mas.mas_decisions_plain(nc, t_ys, t_xs)
    bits = mas.pack_decisions(dec)
    assert bits.shape == (3, 90, 3) and bits.dtype == torch.int32
    assert torch.equal(mas.unpack_decisions(bits, 70), dec)
    path = mas.mas_backtrack_plain(dec, t_ys, t_xs)
    np.testing.assert_array_equal(path.numpy(),
                                  maximum_path_numpy(neg_cent, mask))


def test_kernel_route_refuses_cpu_tensors():
    neg_cent, mask = _problem(np.random.RandomState(2), b=2, t_y=9, t_x=4)
    nc, m = torch.from_numpy(neg_cent), torch.from_numpy(mask)
    t_ys, t_xs = mas.mas_lengths(m)
    mas.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        mas.maximum_path(nc, m, impl="kernel")
    for fn in (mas.mas_fused, mas.mas_forward_bits):
        with pytest.raises(ValueError, match="CUDA"):
            fn(nc, t_ys, t_xs)
    with pytest.raises(ValueError, match="CUDA"):
        mas.mas_backtrack(mas.pack_decisions(nc > 0), t_ys, t_xs, 4)
    with pytest.raises(ValueError):
        mas.maximum_path(nc, m, impl="fallback")
    assert mas.launch_counts == {"mas_fused": 0, "mas_fwd": 0, "mas_bwd": 0}


def test_kernel_library_raises_without_nvcc(monkeypatch, tmp_path):
    """No built library and no compiler: loading raises, nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    kernels.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            kernels.library()
    finally:
        kernels.library.cache_clear()
