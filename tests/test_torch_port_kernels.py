"""The MAS CUDA kernels against the port's plain PyTorch version, on a card.

The plain version is held bit-exact to the reference DP on the CPU
(test_torch_port_mas.py); here the kernels are held bit-exact to it. These
tests need a CUDA device and skip without one. This file imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernels.py
"""

from __future__ import annotations

import pytest
import torch

from mb_istft_vits_torch.ops import mas
from torch_port_mas_bits import BACKTRACK_CASES, PATTERNS, decisions

# (B, T_y, T_x, t_ys, t_xs): ragged items, t_x == 1, t_y == t_x, T_x > 32
# (several decision words per row) and T_y not a multiple of 8; then rows
# that do not start on a 16-byte boundary (T_x = 1 mod 4), T_x = 32 K at
# each one-warp instantiation K in {4, 8, 12, 16}, T_x > 512 (three warps
# per item), t_y == 1 and T_y == 1000
CASES = [
    (4, 33, 17, [33, 9, 17, 5], [1, 9, 17, 5]),
    (3, 29, 29, [29, 29, 20], [29, 1, 20]),
    (5, 130, 70, [130, 70, 100, 1, 64], [70, 70, 33, 1, 40]),
    (3, 61, 41, [61, 41, 50], [41, 41, 17]),
    (2, 140, 128, [140, 128], [128, 100]),
    (2, 300, 256, [300, 256], [256, 129]),
    (2, 400, 384, [400, 390], [384, 257]),
    (2, 520, 512, [520, 512], [512, 385]),
    (2, 1100, 1050, [1100, 800], [1050, 513]),
    (3, 7, 5, [1, 7, 3], [1, 5, 3]),
    (2, 1000, 380, [1000, 640], [380, 201]),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the MAS kernels have no CPU mode)")
    return torch.device("cuda")


def _problem(case, device):
    b, t_y, t_x, t_ys, t_xs = case
    gen = torch.Generator().manual_seed(t_y)
    neg_cent = torch.randn((b, t_y, t_x), generator=gen) * 3
    t_ys, t_xs = torch.tensor(t_ys), torch.tensor(t_xs)
    mask = ((torch.arange(t_y)[None, :, None] < t_ys[:, None, None])
            & (torch.arange(t_x)[None, None, :] < t_xs[:, None, None])).float()
    return neg_cent.to(device), mask.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("force", ["fused", "two_pass"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:3])))
def test_kernels_bit_exact_to_plain(cuda_device, case, force):
    neg_cent, mask = _problem(case, cuda_device)
    ours = mas.maximum_path(neg_cent, mask, use_pallas=True, force=force)
    plain = mas.maximum_path(neg_cent, mask, use_pallas=False)
    torch.cuda.synchronize()
    assert torch.equal(ours, plain)
    assert torch.equal(ours.sum(-1), mask[..., 0])  # one token per frame


@pytest.mark.cuda
def test_forward_bits_and_backtrack_match_plain_halves(cuda_device):
    neg_cent, mask = _problem(CASES[2], cuda_device)
    nc = neg_cent * mask
    t_ys, t_xs = mas.mas_lengths(mask)
    dec = mas.mas_decisions_plain(nc, t_ys, t_xs)
    rows = (torch.arange(nc.shape[1], device=nc.device)[None, :, None]
            < t_ys.long()[:, None, None])
    bits = mas.mas_forward_bits(nc.contiguous(), t_ys, t_xs)
    assert torch.equal(mas.unpack_decisions(bits, nc.shape[2]) & rows,
                       dec & rows)
    path = mas.mas_backtrack(mas.pack_decisions(dec), t_ys, t_xs, nc.shape[2])
    assert torch.equal(path, mas.mas_backtrack_plain(dec, t_ys, t_xs))


@pytest.mark.cuda
def test_forward_bits_at_the_column_limit(cuda_device):
    """T_x = mas_max_columns(): sixteen warps per item on the DP."""
    t_x = 8192
    case = (1, t_x + 40, t_x, [t_x + 40], [t_x])
    neg_cent, mask = _problem(case, cuda_device)
    nc = (neg_cent * mask).contiguous()
    t_ys, t_xs = mas.mas_lengths(mask)
    dec = mas.mas_decisions_plain(nc, t_ys, t_xs)
    bits = mas.mas_forward_bits(nc, t_ys, t_xs)
    assert torch.equal(mas.unpack_decisions(bits, t_x), dec)
    path = mas.mas_backtrack(bits, t_ys, t_xs, t_x)
    assert torch.equal(path, mas.mas_backtrack_plain(dec, t_ys, t_xs))


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("case", sorted(BACKTRACK_CASES))
def test_backtrack_bit_exact_on_arbitrary_decisions(cuda_device, case,
                                                    pattern):
    """mas_backtrack on decisions the DP never produces: all ones, all
    zeros, random, runs of moves across words inside one window; t_x at
    31..65, 0 and 1, t_y below and across windows, T_x = 8192; rows
    y >= t_y hold the complement of the pattern and must not be read."""
    dec, t_ys, t_xs = (torch.from_numpy(a).to(cuda_device)
                       for a in decisions(case, pattern))
    path = mas.mas_backtrack(mas.pack_decisions(dec), t_ys, t_xs,
                             dec.shape[2])
    plain = mas.mas_backtrack_plain(dec, t_ys, t_xs)
    torch.cuda.synchronize()
    assert torch.equal(path, plain)


@pytest.mark.cuda
def test_launch_counts_and_refusals(cuda_device):
    neg_cent, mask = _problem(CASES[0], cuda_device)
    before = dict(mas.launch_counts)
    mas.maximum_path(neg_cent, mask, force="fused")
    mas.maximum_path(neg_cent, mask, force="two_pass")
    assert mas.launch_counts["mas_fused"] == before["mas_fused"] + 1
    assert mas.launch_counts["mas_fwd"] == before["mas_fwd"] + 1
    assert mas.launch_counts["mas_bwd"] == before["mas_bwd"] + 1
    assert mas.launch_counts["mas_path"] == before["mas_path"] + 1
    t_ys, t_xs = mas.mas_lengths(mask)
    with pytest.raises(ValueError):
        mas.mas_fused(neg_cent.double(), t_ys, t_xs)
    with pytest.raises(ValueError):
        mas.mas_fused(neg_cent, t_ys.long(), t_xs)
