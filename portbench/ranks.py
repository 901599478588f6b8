#!/usr/bin/env python3
"""A cell over several ranks: one process a card, one torch.distributed
rank each.

``harness.measure`` hands a cell whose ``chips`` is more than 1 to
``measure`` here, in the process that the benchmark's command started (the
parent).  The parent builds the port's CUDA libraries once, starts one
rank process a card (this file run as a script; rank r on card r, pinned
to the r-th equal share of the parent's CPUs), waits for them, and hands
rank 0's result back to ``harness.run``, which prints it.  A rank that
exits non-zero ends the run: the parent stops the others at once and the
run exits non-zero with no result.  A rank whose peer died or hangs fails
in its next collective within the group's timeout (``GROUP_TIMEOUT_S``).

A rank joins the group through the port's ``dist.mesh.initialize_multihost``
(NCCL on the cards, gloo on the CPU) and takes ``make_rank_mesh()``.  It
makes the whole pool from the seed, as every rank of the cohort driver
stacks the whole batch, checks the pool's digest against rank 0's, and
keeps its own lanes (``RankMesh.lanes``).  The pads grow as
``harness.Cell`` grows them, over the whole batch: each set-up call's
overflow flags and, on a CI overflow, the largest defect count travel
across the ranks, so every rank runs the same pads.

A call (``RankCell.call``) is ``Cell.call`` on this rank's lanes (to the
card, ``analyze_cohort``, the maps and metrics to the host), then the
batch's metrics gathered to every rank with ``dist.mesh.process_allgather``,
as the cohort driver's ``shard_export`` gathers them.  Rank 0's stop flag
travels in the same vector, so the ranks run in lockstep with no other
wait, and rank 0 decides when a window ends.  A call's time is rank 0's
from its start to the gathered batch on its host, which waits for the
slowest rank.  With ``--trace 1`` every rank records the traced window
under torch.profiler; the per-layer metrics read rank 0's, and
``device.busy_s`` and ``window_s`` are the ranks' mean.

``correct``: each rank judges its own lanes of the sampled calls on its
own card (``compare.judge``), with the metrics that rank 0 received for
them in the gather, and its maps against its own set-up output; rank 0
takes the worst of each number.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.compare import MAPS, NAMES, judge  # noqa: E402

#: How long a collective waits for its peers before it fails the rank.
GROUP_TIMEOUT_S = 300.0
#: Seconds between the parent's looks at its ranks.
POLL_S = 0.05


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cpu_shares(cpus: List[int], n: int) -> List[List[int]]:
    """``cpus`` cut into ``n`` equal runs (each rank's own CPUs); every
    rank gets all of them where there are fewer than ``n``."""
    per = len(cpus) // n
    if per == 0:
        return [list(cpus)] * n
    return [list(cpus[r * per:(r + 1) * per]) for r in range(n)]


def pool_digest(hp, mask) -> str:
    """sha256 of the whole pool's bytes (studies and masks)."""
    h = hashlib.sha256()
    for t in (hp, mask):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def breaker_name(breaker) -> str:
    """``module:qualname`` of a test's breaker, which each rank imports."""
    return f"{breaker.__module__}:{breaker.__qualname__}"


def resolve(name: str):
    """The object that ``breaker_name`` named."""
    mod, qual = name.split(":")
    obj = importlib.import_module(mod)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


# ---------------------------------------------------------------- parent

def measure(args: argparse.Namespace, spec: SimpleNamespace, t_proc: float,
            device: str, root: Path, breaker=None):
    """(result, checks) of a run over ``chips`` ranks, or an exit code."""
    import torch

    chips = int(spec.cell["chips"])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        harness.build_libraries()
    shares = cpu_shares(sorted(os.sched_getaffinity(0)), chips)
    port = free_port()
    procs = []
    for r in range(chips):
        cmd = [sys.executable, str(Path(__file__).resolve()),
               "--rank", str(r), "--world", str(chips), "--port", str(port),
               "--root", str(root), "--device", "cuda" if on_card else "cpu",
               "--t-proc", repr(t_proc),
               "--cpus", ",".join(map(str, shares[r])),
               "--timeout", repr(GROUP_TIMEOUT_S),
               "--trace-seconds", repr(harness.TRACE_SECONDS),
               "--workload", args.workload, "--seed", str(args.seed),
               "--seconds", repr(args.seconds), "--trace", str(args.trace)]
        if breaker is not None:
            cmd += ["--breaker", breaker_name(breaker)]
        # rank 0's standard output carries its result; every other line a
        # rank prints goes to standard error
        procs.append(subprocess.Popen(
            cmd, stdin=subprocess.DEVNULL,
            stdout=subprocess.PIPE if r == 0 else 2, cwd=str(harness.ROOT)))
    try:
        codes = wait_all(procs)
        last = procs[0].stdout.read().decode().strip().splitlines()
    finally:
        stop_all(procs)
        procs[0].stdout.close()
    bad = {r: c for r, c in enumerate(codes) if c != 0}
    if bad:
        harness.log(f"rank(s) {sorted(bad)} exited with "
                    f"{sorted(set(bad.values()))}; no result")
        return 1
    if not last:
        harness.log("rank 0 printed no result")
        return 1
    got = json.loads(last[-1])
    got["result"]["device"].update(
        host_cpus=os.cpu_count(), rank_cpus=shares)
    return got["result"], [tuple(r) for r in got["rows"]]


def wait_all(procs) -> List[int]:
    """Every rank's exit code; the first rank that fails stops the others
    (their codes then are the signal's)."""
    while True:
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes):
            stop_all(procs)
            return [p.returncode for p in procs]
        if all(c == 0 for c in codes):
            return codes
        time.sleep(POLL_S)


def stop_all(procs, grace: float = 5.0) -> None:
    """Stop every rank still running and wait until each has ended."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


# ------------------------------------------------------------------ rank

class RankCell(harness.Cell):
    """``harness.Cell`` on this rank's lanes of the whole batch: the pool,
    the pads and a call as set out in the module's docstring."""

    def __init__(self, spec: SimpleNamespace, seed: int, device, mesh):
        self.mesh = mesh
        #: rank 0's test, just before a call's gather, of whether the
        #: window ends with this call
        self.stop = lambda: False
        super().__init__(spec, seed, device)

    def keep(self, hp, mask):
        torch = self.torch
        digest = pool_digest(hp, mask)
        harness.log(f"rank {self.mesh.index}: pool digest {digest}")
        mine = torch.tensor(list(bytes.fromhex(digest)), dtype=torch.uint8)
        every = self.gather(mine).reshape(self.mesh.size, -1)
        if not bool((every == every[0]).all()):
            raise RuntimeError(f"rank {self.mesh.index}: the pool's digest "
                               f"differs from rank 0's")
        own = self.mesh.lanes(self.bs)
        self.batch, self.bs = self.bs, own.stop - own.start
        lanes = (-1, self.batch, *self.shape)
        return (hp.reshape(lanes)[:, own].cpu().numpy(),
                mask.reshape(lanes)[:, own].cpu().numpy())

    def gather(self, t):
        """Every rank's ``t`` along dim 0, in rank order, on the host."""
        from ventjax_torch.dist.mesh import process_allgather
        return process_allgather(t, self.mesh)

    def call(self, b: int):
        torch = self.torch
        t0 = time.perf_counter()
        out, _ = super().call(b)
        with torch.profiler.record_function("portbench.gather"):
            m = out["metrics"]
            stop = float(self.mesh.index == 0 and self.stop())
            vec = torch.stack([v.to(torch.float32) for v in m.values()]
                              + [torch.full((self.bs,), stop)], dim=-1)
            out["rows"] = self.gather(vec)
        out["stop"] = bool(out["rows"][0, -1])
        return out, time.perf_counter() - t0

    def batch_metrics(self, rows, like: Dict) -> Dict:
        """Gathered rows as StudyMetrics' fields, in ``like``'s dtypes."""
        return {k: rows[:, i].to(v.dtype) for i, (k, v) in
                enumerate(like.items())}

    def largest_lung(self) -> int:
        return int(self.max_over_ranks([super().largest_lung()])[0])

    def overflow(self, out):
        return super().overflow(
            {"metrics": self.batch_metrics(out["rows"], out["metrics"])})

    def largest_defect(self, out) -> int:
        return int(self.max_over_ranks([super().largest_defect(out)])[0])

    def failed(self, out) -> int:
        return super().failed(
            {"metrics": self.batch_metrics(out["rows"], out["metrics"])})

    def max_over_ranks(self, values: List[float]) -> List[float]:
        """Each of ``values`` at its largest over the ranks."""
        every = self.gather(self.torch.tensor([values],
                                              dtype=self.torch.float64))
        return [float(v) for v in every.max(0).values]


def traced_window(cell: RankCell, order: List[int], start: int, root: Path,
                  on_card: bool, seconds: float, tries: int = 3):
    """``harness.traced_window`` on every rank in lockstep: rank 0 ends the
    window; a session in which any rank lost device activities is taken
    again on every rank."""
    torch = cell.torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import devtrace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    seen = []
    for _ in range(tries):
        sync()
        with profile(activities=acts) as prof:
            if on_card:
                for _ in range(24):
                    torch.cuda._sleep(100)
            cell.call(order[start % len(order)])
            sync()
            c0 = harness._counters()
            calls, t0, i = [], time.perf_counter(), start + 1
            cell.stop = lambda: (len(calls) >= 1
                                 and time.perf_counter() - t0 >= seconds)
            with torch.profiler.record_function("portbench.window"):
                while True:
                    b = order[i % len(order)]
                    with torch.profiler.record_function("portbench.call"):
                        out, _ = cell.call(b)
                    calls.append(b)
                    i += 1
                    if out["stop"]:
                        break
            cell.stop = lambda: False
            sync()
            counts = harness._delta(c0, harness._counters())
        tr = devtrace.read(prof, "portbench.window", "portbench.call")
        got = {k: tr.device_seconds([spec["match"][0]])[1]
               for k, spec in harness.kernel_specs(root).items()}
        seen.append(got)
        ok = not on_card or all(got[k] == counts.get(k, got[k]) for k in got)
        if cell.max_over_ranks([0.0 if ok else 1.0])[0] == 0.0:
            return tr, calls, counts
    raise RuntimeError(f"torch.profiler lost device activities in {tries} "
                       f"sessions on some rank; this rank's: {seen}")


def run_rank(args: argparse.Namespace, mesh, device: str, root: Path,
             breaker=None) -> Optional[Dict]:
    """One rank's part of a run: rank 0's {"result", "rows"}, else None."""
    import torch

    spec = harness.load_cell(root, args.workload)
    chips = int(spec.cell["chips"])
    on_card = torch.device(device).type == "cuda"
    rank = mesh.index
    cell = RankCell(spec, args.seed, device, mesh)
    harness.log(f"rank {rank}: set up {cell.bs} of {cell.batch} lanes, N4 "
                f"pad {cell.cfg.n4_mask_pad}, CI pad "
                f"{cell.cfg.ci_max_defect_voxels}, CI tail "
                f"{cell.cfg.ci_tail_k}, {time.time() - args.t_proc:.1f} s "
                f"after the run started")
    if breaker is not None:
        breaker(cell)
    rng = np.random.default_rng([args.seed % (1 << 63), 7])
    order = [int(b) for b in rng.permutation(cell.n_batches)]
    n_sample = int(spec.traffic["sample_calls"])
    sample: List = []
    lat, fails, studies = [], 0, 0

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    cell.max_over_ranks([0.0])      # every rank at the window's start
    c0 = harness._counters()
    t_setup = time.time() - args.t_proc
    t0 = time.perf_counter()
    cell.stop = lambda: time.perf_counter() - t0 >= args.seconds
    i = 0
    while True:
        b = order[i % len(order)]
        out, dt = cell.call(b)
        lat.append(dt)
        studies += cell.batch
        fails += cell.failed(out)
        # reservoir sample of the calls, drawn from the seed (every rank
        # draws the same)
        if len(sample) < n_sample:
            sample.append((b, out))
        else:
            j = int(rng.integers(0, i + 1))
            if j < n_sample:
                sample[j] = (b, out)
        i += 1
        if out["stop"]:
            break
    window_s = time.perf_counter() - t0
    cell.stop = lambda: False
    counts = harness._delta(c0, harness._counters())
    peak = cell.max_over_ranks(
        [torch.cuda.max_memory_allocated() if on_card else 0.0])[0]
    calls = i

    result: Dict = {"correct": False, "attempted": studies, "failed": fails}
    names = harness.cell_metrics(spec.bench, args.workload, bool(args.trace))
    values: Dict[str, float] = {}
    device_info = (harness.card_info(torch, chips) if on_card else
                   {"platform": "cpu", "kind": "cpu", "count": chips})
    device_info["memory_peak_bytes"] = int(peak)
    breakdown = None
    if not args.trace:
        e2e = {"studies_per_s": studies / window_s,
               "latency_ms_p95": float(np.percentile(lat, 95)) * 1e3,
               "peak_mem_mib": peak / 2 ** 20,
               "setup_s": t_setup}
        values = {m["name"]: e2e[m["name"]] for m in names}
    else:
        t_tr = time.time()
        tr, tcalls, tcounts = traced_window(cell, order, i, root, on_card,
                                            args.trace_seconds)
        harness.log(f"rank {rank}: traced window: {len(tcalls)} calls, "
                    f"{len(tr.device)} device activities, read in "
                    f"{time.time() - t_tr:.1f} s")
        every = cell.gather(torch.tensor([[tr.busy_s(), tr.window_s]],
                                         dtype=torch.float64))
        device_info["busy_s"] = float(every[:, 0].mean())
        device_info["window_s"] = float(every[:, 1].mean())
        if rank == 0:
            work: Dict[int, Dict] = {}
            ctx = SimpleNamespace(
                trace=tr, calls=tcalls, studies=len(tcalls) * cell.bs,
                counts=tcounts, window_calls=calls, window_counts=counts,
                root=root,
                work=lambda b: work.setdefault(b, harness.batch_work(cell,
                                                                     b)))
            for m in names:
                v = harness.load_reader(root, m["name"])(ctx)
                if v is not None:
                    values[m["name"]] = v
            breakdown = {"device_ops": tr.top_ops(),
                         "idle_gaps": tr.idle_gaps()}
            del work, ctx

    harness.log(f"rank {rank}: window: {calls} calls in {window_s:.2f} s")
    t_ref = time.time()
    # the reference, once the window has closed and the program's state
    # is freed; each rank judges its own lanes with the metrics rank 0
    # received for them
    from ventjax_torch.dist.mesh import broadcast_one_to_all
    own = mesh.lanes(cell.batch)
    rows0 = broadcast_one_to_all(
        np.stack([out["rows"].numpy() for _, out in sample]), mesh)
    samples = []
    for (b, out), got in zip(sample, rows0):
        judged = {k: out[k] for k in MAPS}
        judged["metrics"] = cell.batch_metrics(
            torch.from_numpy(got[own]), out["metrics"])
        samples.append((cell.hp[b], cell.mask[b], judged, cell.outputs[b]))
    del cell.outputs
    if on_card:
        torch.cuda.empty_cache()
    limits = {k: v for k, v in spec.config["fidelity"].items()
              if not k.startswith("_")}
    _, rows = judge(samples, cell.vox, cell.pipe, limits, device)
    mine = {k: v for k, v, _ in rows}
    worst = cell.max_over_ranks([mine[k] for k in NAMES])
    rows = [(k, v, float(limits[k])) for k, v in zip(NAMES, worst)]
    harness.log(f"rank {rank}: reference: {len(samples)} calls judged in "
                f"{time.time() - t_ref:.1f} s")
    if rank != 0:
        return None
    units = {m["name"]: m["unit"] for m in names}
    result["correct"] = all(v <= lim for _, v, lim in rows)
    result["metrics"] = {k: {"value": v, "unit": units[k]}
                         for k, v in values.items()}
    result["device"] = device_info
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return {"result": result, "rows": rows}


def die_with_parent() -> None:
    """Have the kernel kill this rank when the parent ends (Linux)."""
    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)


def main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="portbench/ranks.py")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    ap.add_argument("--t-proc", type=float, required=True)
    ap.add_argument("--cpus", required=True)
    ap.add_argument("--timeout", type=float, required=True)
    ap.add_argument("--trace-seconds", type=float, required=True)
    ap.add_argument("--breaker", default=None)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    die_with_parent()
    os.sched_setaffinity(0, [int(c) for c in args.cpus.split(",")])

    import torch
    import torch.distributed as dist

    from ventjax_torch.dist import mesh as dmesh

    torch.set_num_threads(2)
    on_card = args.device == "cuda"
    if on_card:
        harness.load_libraries()
    dmesh.initialize_multihost(
        f"127.0.0.1:{args.port}", args.world, args.rank,
        backend="nccl" if on_card else "gloo", timeout=args.timeout)
    mesh = dmesh.make_rank_mesh(args.device)
    breaker = resolve(args.breaker) if args.breaker else None
    out = run_rank(args, mesh, str(mesh.device), Path(args.root), breaker)
    dist.destroy_process_group()
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"rank {args.rank}: the run loaded {bad}; no result")
        return 3
    if out is not None:
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
