"""Multi-process initialization and data loading
(gpz_tpu.parallel.distributed).

The reference is single-process (SURVEY §2.3: no distributed backend at all).
Here a multi-process run is a torch.distributed process group and the
(restart, data) mesh over its ranks: each rank initializes the group, loads
only its row range of the catalog onto its device, and the objective's sums
over rows are all-reduced over the data group (NCCL where each rank has its
own GPU, gloo on the CPU or for several ranks on one GPU: NCCL refuses two
ranks on one device).

Typical entry, the same program on every rank:

    from gpz_tpu_torch.parallel import distributed as dist
    dist.initialize("10.0.0.1:29500", num_processes, rank)   # or env://
    mesh = make_mesh()                      # all ranks on the data axis
    lo, hi = dist.host_row_range(n_total)
    local = Dataset(...)                    # rows lo:hi, pad_dataset'ed
    data, n_eff = dist.global_dataset(local, mesh)
    fun = sharded_value_and_grad(unravel, cfg, mesh)  # fun(flat, data, n_eff)

gpz_tpu's global_dataset returns one array sharded over every device; here
each rank keeps its own rows, and what is global is n_eff.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from gpz_tpu_torch.dataset import Dataset

# how long a rendezvous or a collective waits for the other ranks
TIMEOUT = datetime.timedelta(minutes=1)

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: datetime.timedelta = TIMEOUT,
) -> None:
    """Initialize the default process group. Idempotent.

    With `coordinator_address` ("host:port" for tcp://, or any init-method
    URL such as file://...) the group is num_processes ranks and this is
    rank process_id; a failure raises (a swallowed one would quietly
    degrade a multi-process run to one process). Without it, torch's
    environment variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as
    torch.distributed.run sets them) are read if present; with neither the
    process stays single-process and nothing is initialized. `backend`
    defaults to NCCL where CUDA is present, gloo otherwise; with NCCL the
    rank's device is LOCAL_RANK, or its rank modulo the devices. Every
    collective and rendezvous waits at most `timeout`.
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is not None:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        kw = dict(init_method=init_method, world_size=num_processes,
                  rank=process_id)
    elif all(k in os.environ for k in _ENV):
        kw = dict(init_method="env://")
    else:
        return
    dist.init_process_group(backend, timeout=timeout, **kw)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))


def host_row_range(n_total: int) -> Tuple[int, int]:
    """Contiguous row range this rank should load (balanced split over the
    ranks of the default group; all rows without one)."""
    p = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    base, extra = divmod(n_total, p)
    lo = i * base + min(i, extra)
    hi = lo + base + (1 if i < extra else 0)
    return lo, hi


def global_dataset(local: Dataset, mesh, device=None) -> Tuple[Dataset, float]:
    """This rank's rows as its shard of a dataset split over the mesh's data
    group: (the rows on `device`, n_eff).

    Each rank passes only its local rows. Local row counts must already be
    equal across the data group (pad with omega=0 rows via
    dataset.pad_dataset), and a rank whose count differs makes every rank
    raise. n_eff is the global count of nonzero-weight rows. `device`
    defaults to the rank's CUDA device.
    """
    from gpz_tpu_torch.parallel.mesh import DATA_AXIS

    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    group = mesh.get_group(DATA_AXIS)
    out = Dataset(**{f: None if getattr(local, f) is None
                     else getattr(local, f).to(device)
                     for f in ("X", "mask", "omega", "Y", "psi")})
    counts = torch.tensor([out.n, -out.n], dtype=torch.float64, device=device)
    dist.all_reduce(counts, op=dist.ReduceOp.MAX, group=group)
    hi, lo = counts.tolist()
    if hi != -lo:
        raise ValueError(f"local row counts differ across the data group "
                         f"({-lo:.0f} to {hi:.0f} rows): pad every rank's "
                         "rows to the largest count with dataset.pad_dataset")
    n_eff = (out.omega > 0).sum().to(torch.float64).reshape(1)
    dist.all_reduce(n_eff, group=group)
    return out, float(n_eff)
