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
from torch_port_mas_bits import BACKTRACK_CASES, PATTERNS, decisions


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


def _pallas_backtrack(dec, t_ys, t_xs):
    """The JAX package's `_bwd_kernel` in interpret mode, called with the
    specs of `_maximum_path_two_pass`: decisions [B, T_y, T_x] (as int8
    [T_y, B, T_x]) -> path [B, T_y, T_x]."""
    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from mb_istft_vits_tpu.ops.mas_pallas import _bwd_kernel

    b, t_y_max, t_x_max = dec.shape
    rev_spec = pl.BlockSpec((1, b, t_x_max), lambda i: (t_y_max - 1 - i, 0, 0),
                            memory_space=pltpu.VMEM)
    len_spec = pl.BlockSpec(memory_space=pltpu.VMEM)
    path = pl.pallas_call(
        _bwd_kernel,
        grid=(t_y_max,),
        in_specs=[len_spec, len_spec, rev_spec],
        out_specs=rev_spec,
        out_shape=jax.ShapeDtypeStruct((t_y_max, b, t_x_max), jnp.float32),
        scratch_shapes=[pltpu.VMEM((b, t_x_max), jnp.float32)],
        interpret=True,
    )(jnp.asarray(t_ys)[:, None], jnp.asarray(t_xs)[:, None],
      jnp.asarray(dec.transpose(1, 0, 2).astype(np.int8)))
    return np.asarray(path).transpose(1, 0, 2)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("case", sorted(BACKTRACK_CASES))
def test_plain_backtrack_matches_pallas_on_arbitrary_decisions(case, pattern):
    """The plain backtrack (the CUDA kernel's yardstick) against the TPU
    kernel it replaces, on decisions the DP never produces (the same
    patterns as the card test of mas_backtrack)."""
    dec, t_ys, t_xs = decisions(case, pattern)
    ours = mas.mas_backtrack_plain(torch.from_numpy(dec),
                                   torch.from_numpy(t_ys),
                                   torch.from_numpy(t_xs))
    np.testing.assert_array_equal(ours.numpy(),
                                  _pallas_backtrack(dec, t_ys, t_xs))


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
        mas.maximum_path(nc, m, use_pallas=True)
    for fn in (mas.mas_fused, mas.mas_forward_bits):
        with pytest.raises(ValueError, match="CUDA"):
            fn(nc, t_ys, t_xs)
    with pytest.raises(ValueError, match="CUDA"):
        mas.mas_backtrack(mas.pack_decisions(nc > 0), t_ys, t_xs, 4)
    with pytest.raises(ValueError):
        mas.maximum_path(nc, m, use_pallas="fallback")
    assert mas.launch_counts == {"mas_fused": 0, "mas_fwd": 0, "mas_bwd": 0,
                                 "mas_path": 0}


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


def test_ptxas_spill_report_is_read_per_function():
    """chip_smoke.py fails the build when a DP kernel spills; the report it
    reads is nvcc's `-Xptxas -v` output."""
    report = [
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'",
        "ptxas info    : Function properties for _Z3fooPf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, 380 bytes cmem[0]",
        "ptxas info    : Function properties for _Z3barPf",
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads",
    ]
    assert kernels.ptxas_spills(report) == {"_Z3fooPf": (0, 0),
                                            "_Z3barPf": (4, 12)}
