"""Model serialization (gpz_tpu.checkpoint): a versioned .npz with a JSON
header. Format v1 is shared with gpz_tpu, so either package loads what the
other saved.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from gpz_tpu_torch.config import ModelConfig
from gpz_tpu_torch.params import GPzParams
from gpz_tpu_torch.objective import Posterior
from gpz_tpu_torch.model import GPzModel, ParamSet

_FORMAT_VERSION = 1


def _pset_arrays(prefix: str, pset: ParamSet) -> dict:
    arrays = {
        **pset.params.to_numpy(),
        "w": pset.post.w,
        "iSigma_w": pset.post.iSigma_w,
        "logdet": pset.post.logdet,
        "priors": pset.priors,
    }
    return {f"{prefix}.{k}": v for k, v in arrays.items()}


def save_model(model: GPzModel, path: str) -> None:
    """Serialize a GPzModel to one .npz file (atomic rename)."""
    header = {
        "format_version": _FORMAT_VERSION,
        "cfg": dataclasses.asdict(model.cfg),
        "best_score": model.best.score,
        "last_score": model.last.score,
    }
    arrays = {
        "muX": model.muX,
        "sdX": model.sdX,
        "muY": model.muY,
        **_pset_arrays("last", model.last),
        **_pset_arrays("best", model.best),
    }
    arrays = {
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
        else np.asarray(v)
        for k, v in arrays.items()
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, __header__=json.dumps(header), **arrays)
    os.replace(tmp, path)


def _load_pset(prefix: str, z, dtype, device, score: float) -> ParamSet:
    def t(name):
        return torch.tensor(np.ascontiguousarray(z[f"{prefix}.{name}"]),
                            dtype=dtype, device=device)

    params = GPzParams.from_numpy(
        {k[len(prefix) + 1:]: z[k] for k in z.files
         if k.startswith(prefix + ".")},
        device, dtype,
    )
    post = Posterior(w=t("w"), iSigma_w=t("iSigma_w"), logdet=t("logdet"))
    return ParamSet(params=params, post=post, priors=t("priors"), score=score)


def load_model(path: str, device=None) -> GPzModel:
    """Load a GPzModel saved by either package's save_model; parameters
    land on `device` (None: the CUDA device; without one torch's own error
    is raised) in the checkpoint's cfg.dtype."""
    device = torch.device("cuda" if device is None else device)
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(str(z["__header__"]))
        if header["format_version"] != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {header['format_version']}"
            )
        cfg = ModelConfig(**header["cfg"])
        dtype = getattr(torch, cfg.dtype)
        return GPzModel(
            cfg=cfg,
            muX=np.asarray(z["muX"]),
            sdX=np.asarray(z["sdX"]),
            muY=np.asarray(z["muY"]),
            last=_load_pset("last", z, dtype, device, header["last_score"]),
            best=_load_pset("best", z, dtype, device, header["best_score"]),
        )
