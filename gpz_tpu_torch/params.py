"""Model parameters as a dataclass of tensors (gpz_tpu.params.GPzParams)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gpz_tpu_torch.config import ModelConfig

#: field names, in the order and spelling of the checkpoint's arrays
#: (gpz_tpu/checkpoint.py::_pset_arrays)
FIELDS = ("P", "gamma", "ln_alpha", "b", "v", "ln_tau")


@dataclasses.dataclass
class GPzParams:
    """GPz hyperparameters.

    Fields (ref theta layout, GPz/init.m:87,97):
      P        (m, d)  basis centers
      gamma    method-dependent canonical shape, broadcast by expand_gamma;
               for the full family the Cholesky-like factor with
               iSigma = gamma^T gamma (ref getPHI.m:73)
      ln_alpha (m, k)  log precision of the weight prior
      b        (k,)    log noise variance offset
      v        (m, k)  heteroscedastic basis weights (None if homoscedastic)
      ln_tau   (m, k)  log precision of the prior on v (None if homoscedastic)
    """

    P: torch.Tensor
    gamma: torch.Tensor
    ln_alpha: torch.Tensor
    b: torch.Tensor
    v: Optional[torch.Tensor] = None
    ln_tau: Optional[torch.Tensor] = None

    @property
    def heteroscedastic(self) -> bool:
        return self.v is not None

    def astype(self, dtype: torch.dtype) -> "GPzParams":
        return GPzParams(**{
            f: None if t is None else t.to(dtype)
            for f, t in self._items()
        })

    def expand_gamma(self, cfg: ModelConfig) -> torch.Tensor:
        """Canonical gamma broadcast to the working shape: (m, d) for
        GL/VL/GD/VD, (m, d, d) for GC/VC. Autograd sums the gradient over
        the broadcast axes (ref GPz/GPz.m:215-225)."""
        return self.gamma.expand(cfg.gamma_expanded_shape)

    def flatten(self):
        """(flat vector, unravel): every present field raveled row-major and
        concatenated in the order of FIELDS, which is the leaf order of
        gpz_tpu's ravel_pytree, so a flat vector means the same parameters
        in both packages. unravel(flat) gives GPzParams of views into flat
        (autograd flows through them); unravel of a (B, p) batch of such
        vectors gives B parameter sets, every field with a leading axis B."""
        present = [(f, t) for f, t in self._items() if t is not None]
        shapes = [(f, tuple(t.shape), t.numel()) for f, t in present]
        flat = torch.cat([t.reshape(-1) for _, t in present])

        def unravel(vec: torch.Tensor) -> "GPzParams":
            if vec.dim() not in (1, 2) or vec.shape[-1] != flat.shape[0]:
                raise ValueError(f"expected a vector of {flat.shape[0]} "
                                 f"values or a batch of them, got "
                                 f"{tuple(vec.shape)}")
            lead = vec.shape[:-1]
            out, at = {}, 0
            for f, shape, size in shapes:
                out[f] = vec[..., at:at + size].reshape(*lead, *shape)
                at += size
            return GPzParams(**out)

        return flat, unravel

    @classmethod
    def from_numpy(cls, arrays: dict, device, dtype: torch.dtype
                   ) -> "GPzParams":
        """Parameters copied from host arrays keyed by FIELDS (v / ln_tau
        may be absent for a homoscedastic model)."""
        return cls(**{
            f: torch.tensor(np.ascontiguousarray(arrays[f]), dtype=dtype,
                            device=device)
            for f in FIELDS if arrays.get(f) is not None
        })

    def to_numpy(self) -> dict:
        """Host arrays keyed by FIELDS, omitting absent (None) fields."""
        return {f: t.detach().cpu().numpy() for f, t in self._items()
                if t is not None}

    def _items(self):
        return ((f, getattr(self, f)) for f in FIELDS)


def zeros_like_params(params: GPzParams) -> GPzParams:
    """Parameters of the same shapes, dtypes and device, all zero (absent
    fields stay absent)."""
    return GPzParams(**{f: None if t is None else torch.zeros_like(t)
                        for f, t in params._items()})
