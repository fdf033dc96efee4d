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

# (B, T_y, T_x, t_ys, t_xs): ragged items, t_x == 1, t_y == t_x, T_x > 32
# (several decision words per row) and T_y not a multiple of 8
CASES = [
    (4, 33, 17, [33, 9, 17, 5], [1, 9, 17, 5]),
    (3, 29, 29, [29, 29, 20], [29, 1, 20]),
    (5, 130, 70, [130, 70, 100, 1, 64], [70, 70, 33, 1, 40]),
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
    ours = mas.maximum_path(neg_cent, mask, impl="kernel", force=force)
    plain = mas.maximum_path(neg_cent, mask, impl="plain")
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
def test_launch_counts_and_refusals(cuda_device):
    neg_cent, mask = _problem(CASES[0], cuda_device)
    before = dict(mas.launch_counts)
    mas.maximum_path(neg_cent, mask, force="fused")
    mas.maximum_path(neg_cent, mask, force="two_pass")
    assert mas.launch_counts["mas_fused"] == before["mas_fused"] + 1
    assert mas.launch_counts["mas_fwd"] == before["mas_fwd"] + 1
    assert mas.launch_counts["mas_bwd"] == before["mas_bwd"] + 1
    t_ys, t_xs = mas.mas_lengths(mask)
    with pytest.raises(ValueError):
        mas.mas_fused(neg_cent.double(), t_ys, t_xs)
    with pytest.raises(ValueError):
        mas.mas_fused(neg_cent, t_ys.long(), t_xs)
