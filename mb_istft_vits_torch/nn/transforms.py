"""Piecewise rational-quadratic spline transforms of the stochastic
duration predictor's flows (counterpart of
`mb_istft_vits_tpu/nn/transforms.py`; reference `transforms.py`):
softmax-binned widths and heights, softplus derivatives, linear tails,
the analytic forward and the quadratic-root inverse, with log|det|.

As in the JAX package, the reference's boolean-mask scatter
(`transforms.py:77-92`) is a select: the spline runs on the inputs
clamped into its interval and `torch.where` keeps the tails' identity.
The clamp matters for training: the unselected branch stays finite, so
no NaN reaches the gradient through the select.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _searchsorted(bin_locations: torch.Tensor, inputs: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Bin of each input (reference `transforms.py:47-52`): eps added to
    the last edge, the edges at or below the input counted, then clipped
    to a valid bin. Counting keeps the reference's tie rule at the edges,
    which `torch.searchsorted` does not."""
    last = bin_locations[..., -1:] + eps
    edges = torch.cat([bin_locations[..., :-1], last], dim=-1)
    idx = torch.sum(inputs[..., None] >= edges, dim=-1) - 1
    return torch.clamp(idx, 0, edges.shape[-1] - 2)


def _knots(unnormalized: torch.Tensor, lo: float, hi: float,
           min_bin: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax bins of at least `min_bin` over [lo, hi] -> (cumulative
    edges [..., K + 1] with exact end points, bin sizes [..., K])."""
    num_bins = unnormalized.shape[-1]
    sizes = torch.softmax(unnormalized, dim=-1)
    sizes = min_bin + (1 - min_bin * num_bins) * sizes
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = (hi - lo) * cum + lo
    cum = torch.cat([torch.full_like(cum[..., :1], lo), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], hi)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    left: float = 0.0,
    right: float = 1.0,
    bottom: float = 0.0,
    top: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Monotone RQ spline on [left, right] x [bottom, top] (reference
    `transforms.py:96-193`); inputs inside the interval (callers clamp).
    Returns (outputs, logabsdet), logabsdet of the direction taken."""
    cumwidths, widths = _knots(unnormalized_widths, left, right,
                               min_bin_width)
    cumheights, heights = _knots(unnormalized_heights, bottom, top,
                                 min_bin_height)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    bin_idx = _searchsorted(cumheights if inverse else cumwidths,
                            inputs)[..., None]

    def gather(t: torch.Tensor) -> torch.Tensor:
        return torch.gather(t, -1, bin_idx)[..., 0]

    input_cumwidths = gather(cumwidths)
    input_bin_widths = gather(widths)
    input_cumheights = gather(cumheights)
    delta = heights / widths
    input_delta = gather(delta)
    input_derivatives = gather(derivatives)
    input_derivatives_plus_one = gather(derivatives[..., 1:])
    input_heights = gather(heights)
    d_sum = input_derivatives + input_derivatives_plus_one - 2 * input_delta

    if inverse:
        diff = inputs - input_cumheights
        a = diff * d_sum + input_heights * (input_delta - input_derivatives)
        b = input_heights * input_derivatives - diff * d_sum
        c = -input_delta * diff
        discriminant = torch.clamp(b * b - 4 * a * c, min=0.0)
        theta = (2 * c) / (-b - torch.sqrt(discriminant))
        outputs = theta * input_bin_widths + input_cumwidths
    else:
        theta = (inputs - input_cumwidths) / input_bin_widths
    theta_one_minus_theta = theta * (1 - theta)
    denominator = input_delta + d_sum * theta_one_minus_theta
    derivative_numerator = input_delta ** 2 * (
        input_derivatives_plus_one * theta ** 2
        + 2 * input_delta * theta_one_minus_theta
        + input_derivatives * (1 - theta) ** 2)
    logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
    if inverse:
        return outputs, -logabsdet
    numerator = input_heights * (input_delta * theta ** 2
                                 + input_derivatives * theta_one_minus_theta)
    return input_cumheights + numerator / denominator, logabsdet


def unconstrained_rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The spline inside [-tail_bound, tail_bound], the identity outside
    (reference `transforms.py:55-94`): the end derivatives are pinned to
    1, so the pieces join smoothly."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.expm1(1 - min_derivative))
    unnormalized_derivatives = F.pad(unnormalized_derivatives, (1, 1),
                                     value=constant)
    spline_out, spline_logdet = rational_quadratic_spline(
        torch.clamp(inputs, -tail_bound, tail_bound),
        unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
        inverse=inverse, left=-tail_bound, right=tail_bound,
        bottom=-tail_bound, top=tail_bound, min_bin_width=min_bin_width,
        min_bin_height=min_bin_height, min_derivative=min_derivative)
    outputs = torch.where(inside, spline_out, inputs)
    logabsdet = torch.where(inside, spline_logdet,
                            torch.zeros_like(spline_logdet))
    return outputs, logabsdet


def piecewise_rational_quadratic_transform(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tails: Optional[str] = None,
    tail_bound: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatcher (reference `transforms.py:12-44`): no tails (the inputs
    in [0, 1]) or linear tails outside +-tail_bound."""
    if tails is None:
        return rational_quadratic_spline(
            inputs, unnormalized_widths, unnormalized_heights,
            unnormalized_derivatives, inverse=inverse)
    if tails != "linear":
        raise NotImplementedError(f"{tails} tails are not implemented")
    return unconstrained_rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, inverse=inverse, tail_bound=tail_bound)
