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

A third, ``BatchSpaceMesh`` (``make_batch_space_mesh``), is the 2-D
("batch", "space") mesh: batch rows take lanes, and the shards of a row
take H-slabs of each volume (``dist/space.py``).  ``spatial_shard_fn`` runs
the analysis pipeline over it and ``models.segmentation.
make_sharded_train_step`` the U-Net's train step; its shards live in this
process, like ``Mesh``'s.  ``RankSpaceMesh`` (``make_rank_space_mesh``)
is the same mesh over torch.distributed ranks, one (row, slab) block a
rank, each batch row with its own process group; both functions take
either kind.

``local_devices`` is the one function that lists the devices of this
process; the meshes default to it.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ventjax_torch.dist import space
from ventjax_torch.pipeline.result import map_leaves
from ventjax_torch.utils.device import resolve_device

#: How long a collective of a group made here may wait for its peers
#: before it fails the run (``initialize_multihost``'s ``timeout``).
_GROUP_TIMEOUT: Optional[datetime.timedelta] = None


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


@dataclasses.dataclass(frozen=True)
class BatchSpaceMesh:
    """A 2-D ("batch", "space") mesh in one process: ``devices[b][s]`` is
    the device of batch row b's space shard s.  A device may repeat, as in
    ``Mesh``, so one card or the CPU can hold every shard."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def n_batch(self) -> int:
        return len(self.devices)

    @property
    def n_space(self) -> int:
        return len(self.devices[0])

    @property
    def size(self) -> int:
        return self.n_batch * self.n_space


def make_batch_space_mesh(
    n_batch: int,
    n_space: int,
    devices: Optional[Sequence[torch.device]] = None,
) -> BatchSpaceMesh:
    """A ("batch", "space") mesh of n_batch x n_space shards over the first
    n_batch * n_space of ``devices`` (default: every local card), row-major
    (batch row b holds devices[b * n_space:(b + 1) * n_space])."""
    if devices is None:
        devices = local_devices()
    devices = [torch.device(d) for d in devices]
    need = n_batch * n_space
    if n_batch < 1 or n_space < 1 or len(devices) < need:
        raise ValueError(
            f"a ({n_batch}, {n_space}) batch x space mesh needs "
            f"{n_batch} * {n_space} = {need} devices, got {len(devices)} "
            f"(a device may repeat: pass devices=[dev] * {need})")
    return BatchSpaceMesh(tuple(
        tuple(devices[b * n_space:(b + 1) * n_space])
        for b in range(n_batch)))


@dataclasses.dataclass(frozen=True)
class RankSpaceMesh:
    """A ("batch", "space") mesh over the ranks of the default
    torch.distributed group: rank r holds batch row r // n_space and slab
    r % n_space on ``device``; ``row_groups[b]`` is batch row b's process
    group, over which its slabs' collectives run."""

    n_batch: int
    n_space: int
    device: torch.device
    row_groups: Tuple[object, ...]

    @property
    def size(self) -> int:
        return self.n_batch * self.n_space

    @property
    def rank(self) -> int:
        import torch.distributed as dist

        return dist.get_rank()

    @property
    def row(self) -> int:
        return self.rank // self.n_space

    @property
    def slab(self) -> int:
        return self.rank % self.n_space

    @property
    def row_ranks(self) -> space.RankGroup:
        """This rank's batch row, one slab a rank."""
        return space.RankGroup(self.row_groups[self.row], self.slab,
                               self.n_space, self.device,
                               self.row * self.n_space)

    @property
    def all_ranks(self) -> space.RankGroup:
        """Every rank of the mesh, in rank order (row by row)."""
        return space.RankGroup(None, self.rank, self.size, self.device, 0)


def make_rank_space_mesh(n_batch: int, n_space: int,
                         device="cuda") -> RankSpaceMesh:
    """A ("batch", "space") mesh over the n_batch * n_space ranks of the
    default group (after ``initialize_multihost``), on ``device`` (default:
    the card ``torch.cuda.current_device()``; without a card that raises:
    pass ``"cpu"``).  Every rank must call it, with the same shape: it
    makes each batch row's group, in row order.  A world of another size
    raises, naming both numbers."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_rank_space_mesh: no torch.distributed group; call "
            "dist.initialize_multihost first")
    need, world = n_batch * n_space, dist.get_world_size()
    if n_batch < 1 or n_space < 1 or world != need:
        raise ValueError(
            f"a ({n_batch}, {n_space}) batch x space rank mesh needs "
            f"{n_batch} * {n_space} = {need} ranks; the group has {world}")
    groups = tuple(
        dist.new_group(list(range(b * n_space, (b + 1) * n_space)),
                       timeout=_GROUP_TIMEOUT)
        for b in range(n_batch))
    return RankSpaceMesh(n_batch, n_space,
                         resolve_device("cuda" if device is None else device),
                         groups)


def spatial_shard_fn(cohort_fn: Callable, mesh) -> Callable:
    """The analysis pipeline with its inputs sharded [N@batch, H@space, W,
    D] over ``mesh``: the counterpart of ventjax's ``spatial_shard_fn``.

    ventjax jits any function under sharding annotations and XLA derives
    the collectives.  Here they are written by hand for the pipeline
    (``pipeline/spatial.py``), so ``cohort_fn`` must name the pipeline and
    its geometry: ``functools.partial(analyze_cohort, geom=...,
    config=...)`` or what ``make_analyze_fn(vox, shape, config,
    batched=True)`` returns.  Any other function raises a TypeError.

    The returned fn takes [N, H, W, D] host or device tensors, splits N
    over the batch rows and H over each row's space shards (H divisible by
    the space size, N by the batch size), runs the slab program row after
    row (within an N4 iteration the slabs go in lockstep) and returns a
    VentResult whose leaves are in lane and row order on the mesh's first
    device.

    Over a ``RankSpaceMesh`` every rank calls the returned fn with the
    whole batch and works on its own (row, slab) block: the batch row's
    ranks run the slab program together, one slab each, and every rank
    returns the whole VentResult on its device, all_gathered in lane and
    row order (what ``process_allgather`` gives the cohort driver)."""
    from ventjax_torch.pipeline.spatial import analyze_spatial, pipeline_of

    geom, config = pipeline_of(cohort_fn)

    if isinstance(mesh, RankSpaceMesh):
        def on_ranks(hp, mask):
            per = _per_shard(hp.shape[0], mesh.n_batch)
            lanes = slice(mesh.row * per, (mesh.row + 1) * per)
            with space.on_ranks(mesh.row_ranks):
                res = analyze_spatial(hp[lanes], mask[lanes], geom, config,
                                      [mesh.device], own_slab=True)
            world, S = mesh.all_ranks, mesh.n_space

            def volume(x):
                parts = space.all_gather(x, world)
                return torch.cat([torch.cat(parts[b * S:(b + 1) * S], dim=1)
                                  for b in range(mesh.n_batch)], dim=0)

            def lanes_of(x):
                return torch.cat(space.all_gather(x, world)[::S], dim=0)

            out = map_leaves(lambda xs: volume(xs[0]),
                             [dataclasses.replace(res, metrics=None)])
            return dataclasses.replace(
                out, metrics=map_leaves(lambda xs: lanes_of(xs[0]),
                                        [res.metrics]))

        return on_ranks

    def sharded(hp, mask):
        per = _per_shard(hp.shape[0], mesh.n_batch)
        parts = [analyze_spatial(hp[b * per:(b + 1) * per],
                                 mask[b * per:(b + 1) * per], geom, config,
                                 row)
                 for b, row in enumerate(mesh.devices)]
        first = mesh.devices[0][0]
        return map_leaves(
            lambda xs: torch.cat([x.to(first) for x in xs], dim=0), parts)

    return sharded


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
    timeout: float = 600.0,
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

    ``timeout`` (seconds) bounds how long a collective of the default
    group, or of a group ``make_rank_space_mesh`` makes, waits for its
    peers: a rank that hangs fails the run instead of stalling it.
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
    global _GROUP_TIMEOUT
    _GROUP_TIMEOUT = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes or 1), rank=int(process_id),
        timeout=_GROUP_TIMEOUT)


def make_rank_mesh(device="cuda", group=None) -> RankMesh:
    """A mesh of one shard per rank of ``group`` (None: the default group,
    after ``initialize_multihost``), on ``device`` (default: the card
    ``torch.cuda.current_device()``; without a card that raises, as every
    entry point of the port does: pass ``device="cpu"`` for the CPU)."""
    return RankMesh(resolve_device("cuda" if device is None else device),
                    group)
