"""Canonical on-device dataset container (gpz_tpu.dataset.Dataset).

The reference threads (X, Y, Psi, omega, training-selection) through every
call (ref GPz/GPz.m:1, GPz/train.m:40); here they are one container with NaNs
already converted to (zero-filled X, boolean mask).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Dataset:
    """Preprocessed training/inference data.

    X     (n, d)  inputs, zero-filled where missing, already normalized
    Y     (n, k)  centered targets (None at pure-inference time)
    mask  (n, d)  True where X is observed (ref: NaN pattern grouping,
                  getPHI.m:43-54, replaced by this mask)
    psi   input-noise variances, already rescaled by sdX (ref GPz/fixPsi.m):
          None | (n, d) diagonal per-row | (n, d, d) full covariance per-row
    omega (n,)    cost-sensitive sample weights (ref GPz/getOmega.m); rows
                  with omega == 0 contribute exactly zero to every reduction
                  in the objective, which is how padding a row shard
                  (pad_dataset) stays exact.
    """

    X: torch.Tensor
    mask: torch.Tensor
    omega: torch.Tensor
    Y: Optional[torch.Tensor] = None
    psi: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.X.shape[0]

    @property
    def d(self) -> int:
        return self.X.shape[1]

    def __getitem__(self, idx) -> "Dataset":
        """Row-subset (for train/valid/test splits)."""
        return Dataset(
            X=self.X[idx],
            mask=self.mask[idx],
            omega=self.omega[idx],
            Y=None if self.Y is None else self.Y[idx],
            psi=None if self.psi is None else self.psi[idx],
        )


def pad_dataset(data: Dataset, target_n: int) -> Dataset:
    """Pad to `target_n` rows with omega=0 rows, which add exact zeros to
    every reduction of the objective (gpz_tpu.dataset.pad_dataset)."""
    n = data.n
    if n == target_n:
        return data
    if n > target_n:
        raise ValueError(f"cannot pad {n} rows down to {target_n}")
    pad = target_n - n

    def pad0(x):
        if x is None:
            return None
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    return Dataset(
        X=pad0(data.X),
        # padded rows are marked fully observed so PHI stays finite
        mask=torch.cat([data.mask, data.mask.new_ones((pad, data.d))]),
        omega=pad0(data.omega),
        Y=pad0(data.Y),
        psi=pad0(data.psi),
    )
