"""Device meshes for cohort-scale data parallelism.

Counterpart of ``ventjax/dist/mesh.py``.  The primary scaling axis is the
cohort batch: a 1-D ("batch",) mesh over devices, each analysing its shard
of subjects with no traffic between shards on the hot path.  Two kinds of
mesh carry the same shard body:

- ``Mesh``: every shard in this process, one torch device per shard.  A
  device may repeat, so one card, or the CPU, can hold several shards (the
  counterpart of JAX's fake host devices).  The shards run one after
  another on the host thread: the kernels' launch counters stay exact, and
  on several cards a shard's host syncs (one per N4 iteration) hold the
  others back, so each shard costs about what the whole batch costs on one
  card (the slice is launch- and sync-bound).  The cohort driver and the
  service therefore take the mesh only when asked (``use_mesh``).
- ``RankMesh``: one shard per rank of a ``torch.distributed`` group
  (``initialize_multihost``), each on its rank's device.  The multi-process
  cohort driver takes one when the default group holds several ranks;
  ``process_allgather`` and ``broadcast_one_to_all`` are its collectives.

``local_devices`` is the one function that lists the devices of this
process; the meshes default to it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ventjax_torch.pipeline.result import map_leaves
from ventjax_torch.utils.device import resolve_device


def local_devices(device="cuda") -> List[torch.device]:
    """The devices of this process that ``device`` names: every visible
    card for ``"cuda"`` (none raises), the one card of an explicit index
    (``"cuda:1"``), the one CPU for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)   # no card raises
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(dev)]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh in one process: the device of each shard, in order."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _per_shard(n: int, shards: int) -> int:
    """Lanes a shard of an n-lane batch split over ``shards``."""
    if n % shards != 0:
        raise ValueError(f"a batch of {n} does not split over the "
                         f"{shards}-shard mesh; pad it to a multiple of "
                         f"{shards}")
    return n // shards


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A 1-D mesh over the ranks of a torch.distributed group (None: the
    default group): this rank's shard is its rank, on ``device``."""

    device: torch.device
    group: object = None

    @property
    def size(self) -> int:
        import torch.distributed as dist

        return dist.get_world_size(self.group)

    @property
    def index(self) -> int:
        import torch.distributed as dist

        return dist.get_rank(self.group)

    def lanes(self, n: int) -> slice:
        """This rank's lanes of an n-lane batch: the index-th of the
        group's equal, contiguous runs."""
        per = _per_shard(n, self.size)
        return slice(self.index * per, (self.index + 1) * per)

    def global_rank(self, index: int) -> int:
        """The default group's rank of this group's rank ``index``."""
        import torch.distributed as dist

        if self.group is None:
            return index
        return dist.get_global_rank(self.group, index)

    @property
    def comm_device(self) -> torch.device:
        """Where the group's collectives take their tensors: the host under
        gloo, which moves host tensors only, else the rank's device."""
        import torch.distributed as dist

        if dist.get_backend(self.group) == "gloo":
            return torch.device("cpu")
        return self.device


def make_batch_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """A 1-D mesh over the first n devices (default: every local card).
    ventjax's ``axis_name`` has no counterpart: nothing here names an
    axis."""
    if devices is None:
        devices = local_devices()
    if n_devices is not None:
        devices = list(devices)[:n_devices]
    return Mesh(tuple(torch.device(d) for d in devices))


def process_allgather(t: torch.Tensor, mesh: RankMesh,
                      device="cpu") -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0, in rank order, in
    ``t``'s dtype on ``device`` (default the host: the counterpart of
    ``jax.experimental.multihost_utils.process_allgather(t, tiled=True)``).
    It travels on the group's communication device, booleans as uint8.
    Every rank must call it with the same shape, in the same order as its
    other collectives."""
    import torch.distributed as dist

    x = t.to(mesh.comm_device,
             torch.uint8 if t.dtype == torch.bool else t.dtype).contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts).to(device=device, dtype=t.dtype)


def broadcast_one_to_all(x, mesh: RankMesh) -> np.ndarray:
    """Rank 0's host array ``x`` (of the group ``mesh`` names) on every
    rank, as numpy: the counterpart of ``jax.experimental.multihost_utils.
    broadcast_one_to_all``.  Every rank passes an array of the same shape
    and dtype; booleans travel as uint8."""
    import torch.distributed as dist

    a = np.asarray(x)
    t = torch.from_numpy(np.ascontiguousarray(
        a.astype(np.uint8) if a.dtype == np.bool_ else a)).to(
            mesh.comm_device)
    dist.broadcast(t, src=mesh.global_rank(0), group=mesh.group)
    return t.cpu().numpy().astype(a.dtype, copy=False)


def shard_cohort_fn(cohort_fn: Callable, mesh) -> Callable:
    """Run a batched pipeline fn (hp[N,...], mask[N,...]) -> result over
    the batch axis of ``mesh``.

    Every shard gets an equal, contiguous run of lanes and runs the
    unmodified ``cohort_fn`` on its device; every tensor leaf of the result
    (each VentResult field and each StudyMetrics field) comes back in lane
    order.  On a ``Mesh`` the result lives on the first device; on a
    ``RankMesh`` every rank passes the whole batch, runs its own lanes and
    receives everyone's (an all-gather), on its device.  Lanes are
    independent, so the result is the unsharded call's bit for bit where
    the device's arithmetic does not depend on the batch size.
    """
    def sharded(hp, mask):
        if isinstance(mesh, RankMesh):
            own = mesh.lanes(hp.shape[0])
            mine = cohort_fn(hp[own].to(mesh.device),
                             mask[own].to(mesh.device))
            return map_leaves(lambda xs: process_allgather(
                xs[0], mesh, xs[0].device), [mine])
        per = _per_shard(hp.shape[0], mesh.size)
        parts = [cohort_fn(hp[i * per:(i + 1) * per].to(d),
                           mask[i * per:(i + 1) * per].to(d))
                 for i, d in enumerate(mesh.devices)]
        first = mesh.devices[0]
        return map_leaves(
            lambda xs: torch.cat([x.to(first) for x in xs], dim=0), parts)

    return sharded


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Multi-process runtime init (a no-op when single-process):
    ``torch.distributed.init_process_group`` at
    ``tcp://coordinator_address`` with ``num_processes`` ranks, this one
    ``process_id``.

    The backend is fixed here, once: ``backend=None`` takes "nccl" where a
    card is visible (each rank on card ``process_id`` modulo the cards)
    and "gloo" on the CPU.  "gloo" lets several ranks share one card,
    which NCCL refuses; gloo moves host tensors only, so the collectives of
    this package copy card tensors to the host and back under it.
    """
    if not (num_processes is not None and num_processes > 1
            or coordinator_address):
        return
    if not coordinator_address or process_id is None:
        raise ValueError(
            f"initialize_multihost: {num_processes} processes need the "
            f"coordinator's host:port and this process's id (got "
            f"{coordinator_address!r}, {process_id!r}); nothing detects them")
    import torch.distributed as dist

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes or 1), rank=int(process_id))


def make_rank_mesh(device=None, group=None) -> RankMesh:
    """A mesh of one shard per rank of ``group`` (None: the default group,
    after ``initialize_multihost``), on ``device`` (default: the card
    ``torch.cuda.current_device()`` where a card is visible, else the
    CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return RankMesh(resolve_device(device), group)
