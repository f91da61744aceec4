"""Luminance remapping (Hertzmann §3.4).

Affine-matches the A/A' luminance statistics to B's before matching:

    Y_A <- (sigma_B / sigma_A) * (Y_A - mu_A) + mu_B

Both A and A' move with A's statistics so the analogy A:A' is preserved.
The standard deviation is the population one (ddof 0), as `jnp.std`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def luminance_stats(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and (population) standard deviation of a luminance image."""
    return y.mean(), y.std(correction=0)


def remap_luminance(
    y_a: torch.Tensor,
    y_ap: torch.Tensor,
    y_b: torch.Tensor,
    eps: float = 1e-6,
    b_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Remap (Y_A, Y_A') to B's luminance statistics using A's statistics.
    `eps` guards flat images (sigma_A ~ 0)."""
    mu_a, sigma_a = luminance_stats(y_a)
    mu_b, sigma_b = b_stats if b_stats is not None else luminance_stats(y_b)
    scale = sigma_b / torch.clamp(sigma_a, min=eps)
    return scale * (y_a - mu_a) + mu_b, scale * (y_ap - mu_a) + mu_b
