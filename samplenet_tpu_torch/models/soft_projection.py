"""Soft projection's temperature parameter and sigma^2.

Mirrors samplenet_tpu/models/soft_projection.py:30-77 (the parameter and
`sigma()` in its three conventions), so the sampler's weights are complete
and carry the reference key `project._temperature`. `project()`, the
differentiable k-NN mixture used in training, is slice 2 of the port.

  * torch (registration/src/soft_projection.py:92-99): sigma^2 = max(t^2, min_sigma)
  * tf (classification/soft_projection.py:41): sigma^2 = t^2
  * recon (reconstruction/src/soft_projection.py:51-54): sigma^2 = max(t, min_sigma)^2
"""

from __future__ import annotations

import torch
from torch import nn


def sigma_from_temperature(temperature: torch.Tensor, mode: str,
                           min_sigma: float) -> torch.Tensor:
    if mode == "torch":
        return torch.clamp(temperature ** 2, min=min_sigma)
    if mode == "tf":
        return temperature ** 2
    if mode == "recon":
        return torch.clamp(temperature, min=min_sigma) ** 2
    raise ValueError(f"unknown sigma_mode: {mode!r}")


class SoftProjection(nn.Module):
    """Holds the temperature; a frozen one still lives in `_temperature`,
    with requires_grad off, as in the reference torch module."""

    def __init__(self, group_size: int, initial_temperature: float = 1.0,
                 is_temperature_trainable: bool = True,
                 min_sigma: float = 1e-2, sigma_mode: str = "torch", *,
                 device=None):
        super().__init__()
        if sigma_mode not in ("torch", "tf", "recon"):
            raise ValueError(f"unknown sigma_mode: {sigma_mode!r}")
        self.group_size = group_size
        self.min_sigma = min_sigma
        self.sigma_mode = sigma_mode
        self._temperature = nn.Parameter(
            torch.tensor(initial_temperature, dtype=torch.float32,
                         device=device),
            requires_grad=is_temperature_trainable)

    def sigma(self) -> torch.Tensor:
        return sigma_from_temperature(self._temperature, self.sigma_mode,
                                      self.min_sigma)
