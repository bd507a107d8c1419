"""DDPM noise schedule tables (port of flowerdiff/diffusion/schedule.py).

Linear beta in [1e-4, 0.02]; alpha = 1 - beta; alpha_bar = cumprod(alpha).
Built in float64 and rounded once to float32, so the tables are bit-equal to
the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Immutable DDPM schedule tables, each (n_steps,) float32."""

    beta: torch.Tensor
    alpha: torch.Tensor
    alpha_bar: torch.Tensor

    @property
    def n_steps(self) -> int:
        return int(self.beta.shape[0])

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(*(getattr(self, f.name).to(device)
                                   for f in dataclasses.fields(self)))


def linear_schedule(n_steps: int = 1000, beta_start: float = 1e-4,
                    beta_end: float = 0.02) -> DiffusionSchedule:
    i = np.arange(n_steps, dtype=np.float64)
    beta64 = beta_start + i * (beta_end - beta_start) / (n_steps - 1)
    alpha64 = 1.0 - beta64
    alpha_bar64 = np.cumprod(alpha64)
    return DiffusionSchedule(
        beta=torch.from_numpy(beta64.astype(np.float32)),
        alpha=torch.from_numpy(alpha64.astype(np.float32)),
        alpha_bar=torch.from_numpy(alpha_bar64.astype(np.float32)),
    )
