"""The space axis: a volume's H axis in slabs, and the collectives between
them.

ventjax shards H over the "space" axis of its ("batch", "space") mesh with
sharding annotations, and XLA derives every collective.  Nothing in torch
derives them for this package's kernels, so this module writes each one
by hand, for the points where the pipeline (``pipeline/spatial.py``) and the
U-Net (``models/segmentation.py``) need one.

Layout.  H splits into ``n_space`` equal, contiguous slabs (an H that does
not divide raises: padding H would move the SNR noise mask's FOV-buffer
rows).  H is the leading spatial axis, so a slab's voxels are one
contiguous run of each lane's row-major flat volume, and its masked voxels,
compacted in row-major order, are one contiguous run of the lane's global
compacted list; slab s's run starts at the sum of the counts of the slabs
before it.

In one process every shard lives here: a collective takes the list of
the shards' tensors (slab order, each on its shard's device) and returns
either a list of the same kind or one tensor on the first shard's device.
A value every shard needs (a replicated one) is computed once there and
copied to the others (``to``).  Reductions add in shard order, so the
result does not depend on the devices; ``row_sums_sharded`` reproduces
``ops.basic.row_sums`` bit for bit, and the compacted-list tools
(``gather_runs``, ``chunk_layout``, ``gather_owned``) let a slab launch
kernels over whole chunks of the global list, whose per-chunk partials
then combine to the unsharded launch's bits.

Over ranks (``on_ranks``: one slab a torch.distributed rank) the same
functions take this rank's one-element list.  Each collective first
all_gathers every rank's part into the full slab-ordered list (a part
whose size may differ between ranks is padded to the largest, its size
gathered beside it) and then runs the in-process arithmetic on it, so the
bits are the in-process form's; it returns this rank's element or the
replicated value.  Nothing uses ``all_reduce``, whose order the backend
picks.  The rank's own part keeps its autograd graph in the gathered
list, and the halo exchange sends each halo's gradient back to the rank
it came from (``_HaloExchange``), which is what the sharded train step
needs.  ``once`` computes a value on the row's first rank and broadcasts
it.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import List, Optional, Sequence

import torch

from ventjax_torch.ops.basic import row_sums


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """Ranks of a torch.distributed ``group`` that hold one shard each:
    this rank's shard ``index`` of ``size``, on ``device``; ``src`` is the
    default group's rank of the group's first rank (the source of its
    broadcasts)."""

    group: object
    index: int
    size: int
    device: torch.device
    src: int

    @property
    def comm_device(self) -> torch.device:
        """Where the group's collectives take their tensors: the host under
        gloo, which moves host tensors only, else the rank's device."""
        import torch.distributed as dist

        if dist.get_backend(self.group) == "gloo":
            return torch.device("cpu")
        return self.device


_RANKS: contextvars.ContextVar = contextvars.ContextVar("space_ranks",
                                                        default=None)


@contextlib.contextmanager
def on_ranks(ranks: RankGroup):
    """The collectives of this module over ``ranks``, one shard a rank, in
    this block: each takes and returns this rank's one-element list."""
    token = _RANKS.set(ranks)
    try:
        yield ranks
    finally:
        _RANKS.reset(token)


def numbered(xs):
    """(slab index, slab) of the slabs this process holds: every one in
    order, or this rank's one under ``on_ranks``."""
    r = _RANKS.get()
    if r is None:
        return list(enumerate(xs))
    (x,) = xs
    return [(r.index, x)]


def _wire(dtype):
    """The dtype a tensor travels in (gloo and NCCL move no booleans)."""
    return torch.uint8 if dtype == torch.bool else dtype


def all_gather(x: torch.Tensor, r: RankGroup, dim: Optional[int] = None):
    """Every rank's ``x`` of the group ``r`` in rank order, on this rank's
    device in x's dtype, this rank's slot ``x`` itself.  With ``dim``, x's
    size along it may differ between ranks: the sizes are gathered first
    and each part is padded to the largest for the transfer."""
    import torch.distributed as dist

    y = x.detach().to(r.comm_device, _wire(x.dtype)).contiguous()
    sizes = None
    if dim is not None:
        n = torch.tensor([y.shape[dim]], dtype=torch.int64,
                         device=r.comm_device)
        ns = [torch.empty_like(n) for _ in range(r.size)]
        dist.all_gather(ns, n, group=r.group)
        sizes = [int(v) for v in ns]
        grow = max(sizes) - y.shape[dim]
        if grow:
            shape = list(y.shape)
            shape[dim] = grow
            y = torch.cat([y, y.new_zeros(shape)], dim)
    bufs = [torch.empty_like(y) for _ in range(r.size)]
    dist.all_gather(bufs, y, group=r.group)
    out = []
    for t, b in enumerate(bufs):
        if t == r.index:
            out.append(x)
            continue
        if sizes is not None:
            b = b.narrow(dim, 0, sizes[t])
        out.append(b.to(r.device, x.dtype))
    return out


def _gathered(parts, dim: Optional[int] = None):
    """The full slab-ordered list of ``parts``: as given in one process,
    every rank's under ``on_ranks`` (see ``all_gather``)."""
    r = _RANKS.get()
    if r is None:
        return list(parts)
    (x,) = parts
    return all_gather(x, r, dim)


_DTYPES = (torch.float32, torch.float64, torch.int64, torch.int32,
           torch.int16, torch.uint8, torch.int8, torch.bool)


def once(fn, *args):
    """``fn(*args)`` (a tensor or a tuple of tensors), a value every slab
    needs, computed once: directly in one process; under ``on_ranks`` on
    the group's first rank, then broadcast with its shapes and dtypes to
    the others, onto their devices."""
    r = _RANKS.get()
    if r is None or r.size == 1:
        return fn(*args)
    import torch.distributed as dist

    head = torch.zeros(64, dtype=torch.int64)
    if r.index == 0:
        out = fn(*args)
        ts = [out] if isinstance(out, torch.Tensor) else list(out)
        fields = [int(isinstance(out, torch.Tensor)), len(ts)]
        for t in ts:
            fields += [_DTYPES.index(t.dtype), t.dim(), *t.shape]
        head[:len(fields)] = torch.tensor(fields)
    head = head.to(r.comm_device)
    dist.broadcast(head, src=r.src, group=r.group)
    h = head.tolist()
    single, n, pos = h[0], h[1], 2
    res = []
    for i in range(n):
        dt, nd = _DTYPES[h[pos]], h[pos + 1]
        shape = h[pos + 2:pos + 2 + nd]
        pos += 2 + nd
        if r.index == 0:
            buf = ts[i].to(r.comm_device, _wire(dt)).contiguous()
        else:
            buf = torch.empty(shape, dtype=_wire(dt), device=r.comm_device)
        dist.broadcast(buf, src=r.src, group=r.group)
        res.append(ts[i] if r.index == 0 else buf.to(r.device, dt))
    return res[0] if single else tuple(res)


def slab_height(shape, n_space: int) -> int:
    """Rows of each of ``n_space`` slabs of a volume whose H is shape[0]
    (a [N, H, ...] batch gives shape[1:])."""
    H = int(shape[0])
    if n_space < 1 or H % n_space != 0:
        raise ValueError(
            f"a volume of shape {tuple(int(s) for s in shape)} does not "
            f"split into {n_space} equal H-slabs (H = {H}); the space axis "
            f"needs H divisible by the mesh's space size")
    return H // n_space


def split_rows(x: torch.Tensor, devices: Sequence[torch.device],
               dim: int = 1) -> List[torch.Tensor]:
    """x split along ``dim`` (H of [N, H, ...]) into len(devices) equal
    slabs, slab s on devices[s], contiguous; under ``on_ranks`` this
    rank's slab of the group's, on devices[0]."""
    r = _RANKS.get()
    if r is not None:
        h = slab_height(x.shape[dim:], r.size)
        return [x.narrow(dim, r.index * h, h).to(devices[0]).contiguous()]
    h = slab_height(x.shape[dim:], len(devices))
    return [x.narrow(dim, s * h, h).to(d).contiguous()
            for s, d in enumerate(devices)]


def gather_rows(slabs: Sequence[torch.Tensor], device=None,
                dim: int = 1) -> torch.Tensor:
    """The slabs concatenated along ``dim`` in slab order, on ``device``
    (default: the first slab's); their sizes along ``dim`` may differ."""
    slabs = _gathered(slabs, dim)
    dev = slabs[0].device if device is None else device
    return torch.cat([x.to(dev) for x in slabs], dim=dim)


def to(x: torch.Tensor, device) -> torch.Tensor:
    """x on ``device``: a replicated value's copy for one shard (no copy
    where it is there already)."""
    return x if x.device == torch.device(device) else x.to(device)


def halo_rows(slabs: Sequence[torch.Tensor], width: int, dim: int = 1,
              edge: str = "zeros"):
    """Each slab's neighbour rows along ``dim``: a list of (lo, hi), lo the
    previous slab's last ``width`` rows and hi the next slab's first, on
    the slab's own device.  Beyond the volume's global edges they are
    zeros (``edge="zeros"``) or absent, None (``edge="none"``)."""
    r = _RANKS.get()
    if r is not None:
        (x,) = slabs
        if width > x.shape[dim]:
            raise ValueError(f"halo of {width} rows exceeds the slab height "
                             f"{x.shape[dim]}")
        lo, hi = _HaloExchange.apply(x, width, dim, r)
        if edge == "none":
            lo = None if r.index == 0 else lo
            hi = None if r.index + 1 == r.size else hi
        return [(lo, hi)]
    S = len(slabs)
    h = slabs[0].shape[dim]
    if width > h:
        raise ValueError(f"halo of {width} rows exceeds the slab height {h}")
    out = []
    for s, x in enumerate(slabs):
        def edge_rows():
            if edge == "none":
                return None
            shape = list(x.shape)
            shape[dim] = width
            return torch.zeros(shape, dtype=x.dtype, device=x.device)

        lo = (slabs[s - 1].narrow(dim, h - width, width).to(x.device)
              if s > 0 else edge_rows())
        hi = (slabs[s + 1].narrow(dim, 0, width).to(x.device)
              if s + 1 < S else edge_rows())
        out.append((lo, hi))
    return out


class _HaloExchange(torch.autograd.Function):
    """A rank's (lo, hi) halo rows (zeros beyond the global edges): every
    rank's first and last ``width`` rows are all_gathered and
    ``halo_rows`` runs on them.  The backward sends each halo's gradient
    back to the rank whose rows it was: lo's to the previous slab's last
    rows, hi's to the next slab's first."""

    @staticmethod
    def forward(ctx, x, width, dim, r):
        ctx.width, ctx.dim, ctx.r, ctx.shape = width, dim, r, x.shape
        h = x.shape[dim]
        edges = torch.cat([x.narrow(dim, 0, width),
                           x.narrow(dim, h - width, width)], dim)
        with on_ranks(None):
            return halo_rows(all_gather(edges, r), width, dim)[r.index]

    @staticmethod
    def backward(ctx, g_lo, g_hi):
        w, dim, r = ctx.width, ctx.dim, ctx.r
        h = ctx.shape[dim]
        ref = g_lo if g_lo is not None else g_hi
        shape = list(ctx.shape)
        shape[dim] = w
        zero = lambda g: g if g is not None else ref.new_zeros(shape)
        parts = all_gather(torch.cat([zero(g_lo), zero(g_hi)], dim), r)
        gx = ref.new_zeros(ctx.shape)
        if r.index > 0:
            gx.narrow(dim, 0, w).add_(parts[r.index - 1].narrow(dim, w, w))
        if r.index + 1 < r.size:
            gx.narrow(dim, h - w, w).add_(parts[r.index + 1].narrow(dim, 0,
                                                                    w))
        return gx, None, None, None


def with_halo(slabs: Sequence[torch.Tensor], width: int, dim: int = 1,
              edge: str = "zeros") -> List[torch.Tensor]:
    """Each slab with its halo rows on either side along ``dim`` (zeros, or
    nothing with ``edge="none"``, beyond the global edges)."""
    return [torch.cat([t for t in (lo, x, hi) if t is not None], dim=dim)
            for x, (lo, hi) in zip(slabs, halo_rows(slabs, width, dim, edge))]


def sum_in_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """((p0 + p1) + p2) + ... on the first shard's device: a shard-order
    sum of partials."""
    parts = _gathered(parts)
    dev = parts[0].device
    out = parts[0]
    for p in parts[1:]:
        out = out + p.to(dev)
    return out


def sum_int(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The exact int64 sum of integer partials, on the first shard's
    device."""
    return sum_in_order([p.to(torch.int64) for p in parts])


def reduce_min(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    parts = _gathered(parts)
    dev = parts[0].device
    out = parts[0]
    for p in parts[1:]:
        out = torch.minimum(out, p.to(dev))
    return out


def reduce_max(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    parts = _gathered(parts)
    dev = parts[0].device
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p.to(dev))
    return out


def reduce_any(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    parts = _gathered(parts)
    dev = parts[0].device
    out = parts[0]
    for p in parts[1:]:
        out = out | p.to(dev)
    return out


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


def row_sums_sharded(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``row_sums`` of the row that ``parts`` (its equal, contiguous
    segments along the last axis, in order) make up, bit for bit, on the
    first shard's device.

    row_sums pads the row of length V to P = next_pow2(V) and halves it by
    elementwise adds.  With n (a power of two) segments, P = n * L2 where
    L2 = next_pow2(L) for segments of length L, and the first log2(n)
    levels add whole L2-segments of the padded row elementwise, segment t
    and t + n/2 in each: those levels run across shards, and the last
    L2-segment is finished locally.  Where L is not a power of two the
    segments are first cut to the padded row's L2-segments (a shift of
    rows between neighbours).  Any other n gathers the row."""
    parts = _gathered(parts)
    S = len(parts)
    L = parts[0].shape[-1]
    if any(p.shape[-1] != L for p in parts):
        raise ValueError("row_sums_sharded: segments of unequal length "
                         f"{[p.shape[-1] for p in parts]}")
    if S == 1 or S & (S - 1):
        return row_sums(gather_rows(parts, dim=-1))
    L2 = _next_pow2(L)
    segs = list(parts)
    if L2 != L:
        V = S * L
        segs = []
        for t in range(S):
            dev = parts[t].device
            a, b = t * L2, min((t + 1) * L2, V)
            pieces = []
            g = a
            while g < b:
                s, o = divmod(g, L)
                n = min(L - o, b - g)
                pieces.append(parts[s][..., o:o + n].to(dev))
                g += n
            seg = (torch.cat(pieces, -1) if pieces
                   else parts[t][..., :0])
            segs.append(torch.nn.functional.pad(seg, (0, L2 - seg.shape[-1])))
    while len(segs) > 1:
        h = len(segs) // 2
        segs = [segs[t] + segs[t + h].to(segs[t].device) for t in range(h)]
    return row_sums(segs[0]).to(parts[0].device)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def masked_mean_sharded(xs, ms) -> torch.Tensor:
    """``ops.basic.masked_mean`` of the volume the slabs ``xs`` (weights
    ``ms``) make up, bit for bit."""
    parts = [torch.stack([_flat(x) * _flat(m).to(x.dtype),
                          _flat(m).to(x.dtype)], dim=1)
             for x, m in zip(xs, ms)]
    s = row_sums_sharded(parts)
    return s[:, 0] / s[:, 1]


def masked_std_sharded(xs, ms) -> torch.Tensor:
    """``ops.basic.masked_std`` over slabs, bit for bit."""
    ws = [_flat(m).to(x.dtype) for x, m in zip(xs, ms)]
    s = row_sums_sharded([torch.stack([_flat(x) * w, w], dim=1)
                          for x, w in zip(xs, ws)])
    n = s[:, 1]
    mu = s[:, 0] / n
    ss = row_sums_sharded([w * (_flat(x) - to(mu, x.device)[:, None]) ** 2
                           for x, w in zip(xs, ws)])
    return torch.sqrt(ss / n)


def masked_sorted_index_sharded(xs, ms, frac: float) -> torch.Tensor:
    """``ops.basic.masked_sorted_index`` over slabs: each slab's masked
    values (sorted, as many as the fullest lane holds) are gathered, which
    gives the volume's order statistic exactly."""
    counts = [(_flat(m) > 0).sum(1) for m in ms]
    count = sum_int(counts)
    idx = (count.to(torch.float32) * frac).to(torch.int64)
    runs = []
    for x, m, c in zip(xs, ms, counts):
        keyed = torch.where(_flat(m) > 0, _flat(x),
                            torch.full_like(_flat(x), float("inf")))
        k = int(c.max()) if c.numel() else 0
        runs.append(torch.sort(keyed, dim=1).values[:, :max(k, 1)])
    srt = torch.sort(gather_rows(runs, dim=1), dim=1).values
    return srt.gather(1, idx.clamp(0, srt.shape[1] - 1)[:, None])[:, 0]


def gather_runs(runs: Sequence[torch.Tensor], counts: Sequence[torch.Tensor],
                pad: int, fill=0, device=None) -> torch.Tensor:
    """The global compacted list [N, pad] of each lane from per-slab runs:
    slab s's first counts[s] entries of runs[s] [N, P_s] (clipped to P_s),
    one after another in slab order, ``fill`` past the last; on ``device``
    (default: the first slab's)."""
    runs, counts = _gathered(runs, dim=1), _gathered(counts)
    dev = runs[0].device if device is None else device
    cat = torch.cat([r.to(dev) for r in runs], dim=1)
    ok = torch.cat([torch.arange(r.shape[1], device=dev)[None, :]
                    < c.to(dev)[:, None] for r, c in zip(runs, counts)], 1)
    if cat.shape[1] < pad:
        grow = pad - cat.shape[1]
        cat = torch.nn.functional.pad(cat, (0, grow))
        ok = torch.nn.functional.pad(ok, (0, grow))
    return _compact(cat, ok, pad, fill)


def _compact(cat, ok, width, fill):
    """The entries of cat where ok, in order, in ``width`` slots; fill
    after."""
    ar = torch.arange(cat.shape[1], device=cat.device)
    key = torch.where(ok, ar, torch.full_like(ar, cat.shape[1]))
    order = torch.sort(key, dim=1, stable=True).indices[:, :width]
    out = cat.gather(1, order)
    live = torch.arange(width, device=cat.device)[None, :] < ok.sum(1)[:, None]
    return torch.where(live, out, torch.full_like(out, fill))


@dataclasses.dataclass
class ChunkLayout:
    """Which whole chunks of each lane's global compacted list each slab
    owns (a chunk belongs to the slab that holds its first entry), and
    where each slab's owned-chunk buffer takes its entries from: its own
    run, then the heads of the slabs after it (at most ``chunk - 1``
    entries, the owned chunks' tail).

    widths[s]: slab s's buffer width (the fullest lane's owned chunks, at
    least one chunk, so that every slab launches); valid[s] [N, widths[s]]:
    the buffer slots that hold a list entry (a lane's owned range, below
    the list's valid length); counts[s] [N]: their number; sources[s] [N,
    widths[s]]: where each slot's entry lies in slab s's own run followed
    by the heads of the slabs after it."""
    chunk: int
    widths: List[int]
    valid: List[torch.Tensor]
    counts: List[torch.Tensor]
    sources: List[torch.Tensor]


def chunk_layout(counts: Sequence[torch.Tensor], widths: Sequence[int],
                 cap: torch.Tensor, chunk: int) -> ChunkLayout:
    """The chunk ownership of a global compacted list whose slab s holds
    counts[s] [N] entries (in a run of width widths[s]) and whose first
    ``cap`` [N] positions are valid (the rest is padding).  Under
    ``on_ranks`` every rank works out every slab's layout from the
    gathered counts and widths and keeps its own."""
    r = _RANKS.get()
    if r is not None:
        (c,) = counts
        both = all_gather(torch.cat([
            c.to(torch.int64), torch.tensor([widths[0]], device=c.device)]),
            r)
        with on_ranks(None):
            full = chunk_layout([b[:-1] for b in both],
                                [int(b[-1]) for b in both], cap, chunk)
        i = r.index
        return ChunkLayout(chunk, [full.widths[i]], [full.valid[i]],
                           [full.counts[i]], [full.sources[i]])
    S = len(counts)
    dev0 = counts[0].device
    cnt = [c.to(dev0, torch.int64) for c in counts]
    cap = cap.to(dev0, torch.int64)
    off = torch.zeros_like(cap)
    head = chunk - 1
    ws, valids, nv, srcs = [], [], [], []
    for s in range(S):
        dev = counts[s].device
        o, e = off, torch.minimum(off + cnt[s], cap)
        first = (o + chunk - 1) // chunk * chunk
        owns = first < e
        start = torch.where(owns, first, o)
        length = torch.where(owns, (e + chunk - 1) // chunk * chunk - first,
                             torch.zeros_like(o))
        width = max(chunk, int(length.max()) if length.numel() else 0)
        j = torch.arange(width, device=dev0)[None, :]
        live = (j < length[:, None]) & (start[:, None] + j < cap[:, None])
        # the source layout: own run, then each later slab's head
        runs_ok = [(torch.arange(widths[s], device=dev0)[None, :]
                    >= (start - o)[:, None])
                   & (torch.arange(widths[s], device=dev0)[None, :]
                      < cnt[s][:, None])]
        for t in range(s + 1, S):
            hw = min(head, widths[t])
            runs_ok.append(torch.arange(hw, device=dev0)[None, :]
                           < cnt[t][:, None])
        ok = torch.cat(runs_ok, 1)
        ar = torch.arange(ok.shape[1], device=dev0)
        key = torch.where(ok, ar, torch.full_like(ar, ok.shape[1]))
        order = torch.sort(key, dim=1, stable=True).indices
        if order.shape[1] < width:
            order = torch.nn.functional.pad(order, (0, width - order.shape[1]))
        src = order[:, :width]
        ws.append(width)
        valids.append(live.to(dev))
        nv.append(live.sum(1).to(dev))
        srcs.append(src.to(dev))
        off = off + cnt[s]
    return ChunkLayout(chunk, ws, valids, nv, srcs)


def gather_owned(runs: Sequence[torch.Tensor], layout: ChunkLayout,
                 fill=0) -> List[torch.Tensor]:
    """Each slab's owned-chunk buffer [N, widths[s]] of a per-voxel
    quantity held in per-slab runs (the layout's runs): its own entries,
    then the tail it receives from the next slabs (their first
    ``chunk - 1`` entries at most), ``fill`` in slots that hold no list
    entry."""
    head = layout.chunk - 1
    r = _RANKS.get()
    if r is not None:
        (own,) = runs
        heads = all_gather(own[:, :head], r, dim=1)
        return [_owned(own, heads[r.index + 1:], layout.sources[0],
                       layout.valid[0], fill)]
    return [_owned(runs[s], [t[:, :head] for t in runs[s + 1:]],
                   layout.sources[s], layout.valid[s], fill)
            for s in range(len(runs))]


def _owned(own, later_heads, sources, valid, fill):
    """One slab's owned-chunk buffer from its own run and the heads of the
    slabs after it."""
    dev = own.device
    cat = torch.cat([own] + [t.to(dev) for t in later_heads], dim=1)
    buf = cat.gather(1, sources.clamp(max=cat.shape[1] - 1))
    return torch.where(valid, buf, torch.full_like(buf, fill)).contiguous()


def cat_chunks(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-slab per-chunk partials [N, nchunk_s, ...] concatenated along
    the chunk axis in slab order, on the first shard's device.  A lane's
    owned chunks come first in each slab's partials, and the slots after
    them hold a reduction's identity, so the lane's chunks meet in global
    chunk order with identities between them, which leave a sum, a min
    and a max unchanged."""
    return gather_rows(parts, dim=1)
