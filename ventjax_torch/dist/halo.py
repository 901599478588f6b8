"""Slice-axis (D) sharded CI by halo exchange.

Counterpart of ``ventjax/dist/halo.py``, with its arithmetic.  For volumes
whose slice axis is split over a mesh, each shard computes CI for the
defect voxels of its own slab.  The pairwise engine needs only the witness
defect voxels within the sphere reach, ``halo_width`` slices (the reach
along the slice axis plus one slab of slack for the wrap-alias candidates,
which shift dk by at most 1).  So each shard compacts its slab's defect
coordinates once and sends fixed-size boundary coordinate messages to its
neighbours (3 x halo_pad int32, not dense slabs), then runs the two-phase
engine (``ops/ci_pairwise.resolve_balls_two_phase``; on a card its head is
kernel K3) on (local centers, local + halo witnesses).  The map is the
unsharded engine's bit for bit.

The shard body is ``_pack`` (compaction and messages) and ``_resolve``
(engine and scatter); two exchanges drive it:

- a ``Mesh`` in one process: the messages move between the shards'
  devices by tensor copy (``calculate_ci_sharded``, ``analyze
  --shard-slices``, config ``ci_shard_slices``);
- a ``RankMesh``, one shard per rank of a torch.distributed group: the
  messages go by ``batch_isend_irecv`` and the sums by ``all_reduce``
  (under gloo through the host).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ventjax_torch.dist import mesh as dmesh
from ventjax_torch.dist.mesh import Mesh, RankMesh
from ventjax_torch.ops.basic import compact_mask_indices
from ventjax_torch.ops.ci_pairwise import (
    SENT, CIPairwiseGeometry, resolve_balls_two_phase,
)


def halo_width(geom: CIPairwiseGeometry) -> int:
    """Slabs of witness context needed on each side of a shard."""
    reach = int(np.floor(np.sqrt(geom.r2_last) / geom.scale[2]))
    return reach + 1  # +1: wrap-alias candidates shift dk by +-1


def padded_depth_for(depth: int, n_shards: int) -> int:
    """Smallest multiple of n_shards >= depth (zero-padding the slice axis
    adds no defect voxels and, with the geometry kept at the original
    shape, no alias images, so results stay bit-identical)."""
    return -(-depth // n_shards) * n_shards


@dataclasses.dataclass(frozen=True)
class _Plan:
    geom: CIPairwiseGeometry
    n_shards: int
    dl: int              # slices per shard
    hz: int              # halo width in slices
    K: int               # center lanes per shard
    HP: int              # boundary message lanes per side
    head_balls: int
    tail_k: Optional[int]


@dataclasses.dataclass
class _Slab:
    """One shard's compaction and its two boundary messages."""
    index: int
    cidx: torch.Tensor   # [1, K] flat slab indices
    nc: torch.Tensor     # [1] defect voxels in the slab
    valid: torch.Tensor  # [1, K] real-center lanes
    v: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # [1, K] int32
    top: torch.Tensor    # [3, HP] +1-encoded, for shard index + 1
    n_top: torch.Tensor
    bot: torch.Tensor    # [3, HP] +1-encoded, for shard index - 1
    n_bot: torch.Tensor


def _first(m: torch.Tensor, pad: int):
    """compact_mask_indices of a [1, L] row, for any pad (a pad beyond the
    row fills with indices of zero entries past it)."""
    if pad > m.shape[1]:
        m = F.pad(m, (0, pad - m.shape[1]))
    return compact_mask_indices(m, pad)


def _pack(defect_local: torch.Tensor, index: int, plan: _Plan) -> _Slab:
    """Compact one [H, W, dl] slab once and select its boundary defects."""
    H, W, _ = plan.geom.shape
    dl, K, HP, hz = plan.dl, plan.K, plan.HP, plan.hz
    dev = defect_local.device
    cidx, nc = _first((defect_local != 0).reshape(1, -1), K)
    valid = torch.arange(K, device=dev)[None] < nc[:, None]

    def coord(x, fill):
        return torch.where(valid, x.to(torch.int32),
                           torch.full_like(x, fill, dtype=torch.int32))

    vkl = (cidx % dl).to(torch.int32)          # local slice index
    v = (coord(cidx // (W * dl), SENT), coord((cidx // dl) % W, -SENT),
         coord(vkl + index * dl, SENT))
    v = tuple(c.contiguous() for c in v)

    def message(sel):
        # +1 encoding: an edge shard receives zeros, which must decode as
        # "no witnesses", not as voxel (0, 0, 0)
        lane, n_sel = _first(sel, HP)
        ok = torch.arange(HP, device=dev)[None] < n_sel[:, None]
        lc = lane.clamp(max=K - 1)
        return torch.cat([torch.where(ok, c.gather(1, lc) + 1,
                                      torch.zeros_like(lc, dtype=torch.int32))
                          for c in v]).contiguous(), n_sel[0]

    top, n_top = message(valid & (vkl >= dl - hz))
    bot, n_bot = message(valid & (vkl < hz))
    return _Slab(index, cidx, nc, valid, v, top, n_top, bot, n_bot)


def _unpack(msg: torch.Tensor):
    ok = msg[0:1] > 0
    return (torch.where(ok, msg[0:1] - 1, SENT),
            torch.where(ok, msg[1:2] - 1, -SENT),
            torch.where(ok, msg[2:3] - 1, SENT))


def _resolve(s: _Slab, lo_msg: Optional[torch.Tensor],
             hi_msg: Optional[torch.Tensor], plan: _Plan):
    """The engine on one slab: centers are its compaction, witnesses the
    compaction and the halo below (the message of shard index - 1's top)
    and above (shard index + 1's bottom); a message an edge shard does not
    receive is None.  Returns (ci [H, W, dl], saturated count, overflow)."""
    geom = plan.geom
    H, W, _ = geom.shape
    M = geom.n_balls
    n, i, HP = plan.n_shards, s.index, plan.HP
    dev = s.cidx.device
    if n == 1:
        # No neighbours: the slab is the volume, and the engine scans K
        # witness lanes, not K + 2*HP of guaranteed-empty halo.
        w = s.v
        halo_ovf = torch.zeros(1, dtype=torch.bool, device=dev)
    else:
        empty = torch.zeros((3, HP), dtype=torch.int32, device=dev)
        lo = _unpack(empty if lo_msg is None else lo_msg)
        hi = _unpack(empty if hi_msg is None else hi_msg)
        w = tuple(torch.cat(parts, dim=1).contiguous()
                  for parts in zip(s.v, lo, hi))
        # A truncated message only loses witnesses someone receives: the
        # last shard's top and shard 0's bottom go nowhere.
        halo_ovf = (((s.n_top > HP) & (i < n - 1))
                    | ((s.n_bot > HP) & (i > 0))).reshape(1)
    jballs, tail_ovf = resolve_balls_two_phase(
        s.v, w, geom, head_balls=plan.head_balls, tail_k=plan.tail_k,
        valid=s.valid)
    saturated = (jballs >= M - 1) & s.valid
    cv = torch.as_tensor(geom.radii32, device=dev)[jballs] * geom.min_vox
    V = H * W * plan.dl
    ci = torch.zeros((1, V + 1), dtype=torch.float32, device=dev)
    ci.scatter_(1, torch.where(s.valid, s.cidx, torch.full_like(s.cidx, V)),
                cv)
    overflow = (s.nc > plan.K) | halo_ovf | tail_ovf
    return ci[0, :V].reshape(H, W, plan.dl), saturated.sum(), overflow[0]


def make_sliced_ci_fn(
    geom: CIPairwiseGeometry,
    mesh,
    max_defect_per_shard: int = 2048,
    halo_pad: Optional[int] = None,
    padded_depth: Optional[int] = None,
    head_balls: int = 96,
    tail_k: Optional[int] = None,
):
    """The slice-sharded CI with the semantics of calculate_ci_pairwise:
    fn -> (ci_map, n_saturated, overflow).

    On a ``Mesh``, fn takes the whole defect volume [H, W, Dp] and returns
    the map on the mesh's first device; on a ``RankMesh``, each rank passes
    its own slab [H, W, Dp / n] (shard = rank) and gets its slab of the
    map, the sums taken over every rank.

    ``padded_depth`` (default: the geometry's depth D) is the array depth
    Dp; it must be a multiple of the shard count and >= D.  The CI geometry,
    its wrap-alias images included, is always that of the original (H, W,
    D) volume; pad slices hold no centers and no witnesses, so a
    zero-padded call equals the unsharded engine on the unpadded volume.

    Each shard compacts its slab once into ``max_defect_per_shard`` center
    lanes (K), selects the boundary defects within the halo from those
    lanes and exchanges ``halo_pad``-lane coordinate messages (default
    K // 2, so the witnesses, local + both halos, are 2K lanes), then runs
    the two-phase engine (tail budget ``tail_k``, default max(256, K // 8)
    per shard).  A center, halo or tail overflow on any shard saturates
    those rows and sets the overflow flag (never silently wrong).
    """
    H, W, D = geom.shape
    n_shards = mesh.size
    Dp = D if padded_depth is None else int(padded_depth)
    if Dp < D:
        raise ValueError(f"padded_depth {Dp} is smaller than the volume depth {D}")
    if Dp % n_shards != 0:
        raise ValueError(
            f"slice axis must divide the mesh: pad the volume to "
            f"{padded_depth_for(Dp, n_shards)} slices "
            f"(ventjax_torch.dist.halo.padded_depth_for) or use "
            f"calculate_ci_sharded, which pads automatically"
        )
    dl = Dp // n_shards
    hz = halo_width(geom)
    if hz > dl:
        n_max = Dp // hz
        hint = (f"use at most {n_max} shards" if n_max >= 2 else
                "this volume is too thin to shard — run without "
                "--shard-slices")
        raise ValueError(
            f"halo width {hz} slices exceeds the {dl}-slice shard depth for "
            f"{n_shards} shards; {hint}, or use a smaller ci_rmax (the halo "
            f"is the sphere reach along the slice axis)"
        )
    K = int(max_defect_per_shard)
    plan = _Plan(geom, n_shards, dl, hz, K,
                 K // 2 if halo_pad is None else int(halo_pad),
                 int(head_balls), tail_k)
    if isinstance(mesh, RankMesh):
        return lambda slab: _rank_ci(slab, plan, mesh)

    def fn(defect: torch.Tensor):
        if tuple(defect.shape) != (H, W, Dp):
            raise ValueError(f"defect shape {tuple(defect.shape)} != "
                             f"{(H, W, Dp)}")
        slabs = [_pack(defect[:, :, i * dl:(i + 1) * dl].to(d), i, plan)
                 for i, d in enumerate(mesh.devices)]
        out = []
        for i, (s, d) in enumerate(zip(slabs, mesh.devices)):
            lo = slabs[i - 1].top.to(d) if i > 0 else None
            hi = slabs[i + 1].bot.to(d) if i < n_shards - 1 else None
            out.append(_resolve(s, lo, hi, plan))
        first = mesh.devices[0]
        ci = torch.cat([o[0].to(first) for o in out], dim=2)
        nsat = sum(o[1].to(first) for o in out)
        ovf = torch.stack([o[2].to(first) for o in out]).any()
        return ci, nsat, ovf

    return fn


def _rank_ci(slab: torch.Tensor, plan: _Plan, mesh: RankMesh):
    """The shard body on this rank's slab, its messages exchanged with the
    neighbouring ranks."""
    import torch.distributed as dist

    H, W, _ = plan.geom.shape
    if tuple(slab.shape) != (H, W, plan.dl):
        raise ValueError(f"rank slab shape {tuple(slab.shape)} != "
                         f"{(H, W, plan.dl)}")
    i, n = mesh.index, mesh.size
    s = _pack(slab.to(mesh.device), i, plan)
    lo = hi = None
    if n > 1:
        where = mesh.comm_device
        ops, recv = [], {}
        for peer, msg in ((i - 1, s.bot), (i + 1, s.top)):
            if 0 <= peer < n:
                recv[peer] = torch.empty((3, plan.HP), dtype=torch.int32,
                                         device=where)
                rank = mesh.global_rank(peer)
                ops += [dist.P2POp(dist.isend, msg.to(where), rank,
                                   mesh.group),
                        dist.P2POp(dist.irecv, recv[peer], rank, mesh.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        lo, hi = (recv[p].to(mesh.device) if p in recv else None
                  for p in (i - 1, i + 1))
    ci, nsat, ovf = _resolve(s, lo, hi, plan)
    sums = torch.stack([nsat, ovf.to(nsat.dtype)]).to(mesh.comm_device)
    dist.all_reduce(sums, group=mesh.group)
    sums = sums.to(mesh.device)
    return ci, sums[0], sums[1] > 0


def calculate_ci_sharded(
    defect: torch.Tensor,
    geom: CIPairwiseGeometry,
    mesh: Optional[Mesh] = None,
    n_shards: Optional[int] = None,
    max_defect_voxels: int = 8192,
    halo_pad: Optional[int] = None,
    head_balls: int = 96,
    tail_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Oversize-volume CI of one [H, W, D] defect volume, slice-sharded
    over the devices of a ``Mesh``: the product surface.

    Same contract as ``calculate_ci_pairwise`` (bit-identical map, the
    (ci_map, n_saturated, overflow) triple, here for one volume); the slice
    axis is zero-padded to the mesh.  The default mesh is the first
    ``n_shards`` of the local devices of the defect's device type, its own
    device first (all of them without ``n_shards``).  ``max_defect_voxels`` is the per-shard center
    budget (a safe bound is the whole volume's defect count); ``halo_pad``
    the per-side boundary message size (default K // 2).

    Raises ValueError with an actionable message when the geometry cannot
    shard (the gather-ladder geometry, or more shards than the halo or the
    devices allow).
    """
    if not isinstance(geom, CIPairwiseGeometry):
        raise ValueError(
            "slice-sharded CI requires the pairwise engine, but this voxel "
            "geometry failed its float32 exactness proof and fell back to "
            "the gather-ladder engine (see pipeline.analyze.build_geometry). "
            "Run unsharded, or change vox/ci_rmax to a geometry the pairwise "
            "engine accepts."
        )
    H, W, D = geom.shape
    if tuple(defect.shape) != (H, W, D):
        raise ValueError(f"defect shape {tuple(defect.shape)} != geometry "
                         f"{geom.shape}")
    if mesh is None:
        # every card, the defect's own first: the map comes back there
        devices = dmesh.local_devices(defect.device.type)
        if defect.device in devices:
            i = devices.index(defect.device)
            devices = devices[i:] + devices[:i]
        n = n_shards or len(devices)
        if n > len(devices):
            raise ValueError(
                f"--shard-slices {n} exceeds the {len(devices)} visible "
                f"device(s); use at most {len(devices)} shards"
            )
        mesh = Mesh(tuple(devices[:n]))
    Dp = padded_depth_for(D, mesh.size)
    fn = make_sliced_ci_fn(
        geom, mesh, max_defect_per_shard=int(max_defect_voxels),
        halo_pad=(int(max_defect_voxels) // 2 if halo_pad is None
                  else int(halo_pad)),
        padded_depth=Dp, head_balls=int(head_balls), tail_k=tail_k)
    ci, nsat, ovf = fn(F.pad(defect, (0, Dp - D)))
    return ci[:, :, :D], nsat, ovf
