"""The (restart, data) grid of ranks (gpz_tpu.parallel.mesh).

gpz_tpu's mesh has two axes of devices (SURVEY §2.3 / §5):
  * `data`    — the sample axis n is sharded here; the objective's Gram,
                rhs and scalar reductions are summed over it
  * `restart` — independent random restarts / posterior chains; parameters
                are split here and the data is replicated

Here the mesh is a grid of the ranks of the default torch.distributed
process group, rank = restart index * n_data + data index (gpz_tpu's
row-major device grid), with one process group along each axis: the ranks
of a row share its data group, the ranks of a column its restart group.

It is not torch's DeviceMesh: the groups here take a finite timeout
(distributed.TIMEOUT unless given, as `distributed.initialize` does; a
new_group's default is the backend's, 30 minutes for gloo), so that ranks
which fall out of step fail within it instead of hanging, and creating
them sets no CUDA device.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from gpz_tpu_torch.parallel.distributed import TIMEOUT

DATA_AXIS = "data"
RESTART_AXIS = "restart"


class Mesh:
    """A (restart, data) grid of ranks with a process group along each axis.

    shape: {RESTART_AXIS: n_restart, DATA_AXIS: n_data}. `get_group(axis)`
    is this rank's group along the axis (what the samplers' `axis_name`
    takes), `size(axis)` its number of ranks and `get_local_rank(axis)` this
    rank's index in it.
    """

    def __init__(self, n_restart: int, n_data: int, timeout=TIMEOUT):
        self.shape = {RESTART_AXIS: n_restart, DATA_AXIS: n_data}
        rank = dist.get_rank()
        self._coords = divmod(rank, n_data) if rank < n_restart * n_data \
            else None
        self._groups = {}
        # every rank takes part in creating every group, in one order
        for axis, lines in (
                (DATA_AXIS, [[r * n_data + c for c in range(n_data)]
                             for r in range(n_restart)]),
                (RESTART_AXIS, [[r * n_data + c for r in range(n_restart)]
                                for c in range(n_data)])):
            for ranks in lines:
                group = dist.new_group(ranks, timeout=timeout)
                if rank in ranks:
                    self._groups[axis] = group

    def _axis(self, axis: str) -> int:
        if axis not in self.shape:
            raise KeyError(f"no mesh axis {axis!r}; the axes are "
                           f"{tuple(self.shape)}")
        if self._coords is None:
            raise ValueError(f"rank {dist.get_rank()} lies outside the "
                             f"{self.shape} mesh")
        return 0 if axis == RESTART_AXIS else 1

    def get_group(self, axis: str):
        self._axis(axis)
        return self._groups[axis]

    def size(self, axis: str) -> int:
        self._axis(axis)
        return self.shape[axis]

    def get_local_rank(self, axis: str) -> int:
        return self._coords[self._axis(axis)]


def make_mesh(n_data: Optional[int] = None, n_restart: int = 1,
              timeout=TIMEOUT) -> Mesh:
    """Create a (restart, data) mesh over the ranks of the default process
    group; every rank calls it with the same arguments.

    With n_data=None, all ranks not consumed by the restart axis go to the
    data axis. A smaller mesh takes the first ranks; the others hold a mesh
    whose groups they cannot use. Needs an initialized process group
    (`distributed.initialize`): it never makes a world of one by itself.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group: call "
            "gpz_tpu_torch.parallel.distributed.initialize first (with "
            "num_processes=1 for a single process)")
    total = dist.get_world_size()
    if n_data is None:
        if total % n_restart != 0:
            raise ValueError(
                f"{total} ranks not divisible by n_restart={n_restart}")
        n_data = total // n_restart
    if n_restart * n_data > total:
        raise ValueError(
            f"mesh ({n_restart} x {n_data}) exceeds {total} ranks")
    return Mesh(n_restart, n_data, timeout)
