"""One run of one cell of the port's benchmark.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (see ``portbench/README.md``).  Everything that belongs to
one configuration, traffic mix or per-layer metric is a file found by its
name in ``BENCHMARK.json``: ``configs/<config>.json``,
``traffic/<mix>.json``, ``metrics/<metric>.py`` (and the kernels' data in
``kernels/``).

A run: set-up (the card's libraries, a pool of studies made from the seed,
the pads grown call batch by call batch as the cohort driver grows them,
each pool batch's output at the final pads kept for the repeat check)
-> the measured window, a closed loop of one client (each call takes the
next batch of the pool from host memory, runs
``ventjax_torch.pipeline.analyze_cohort`` and ends when its metrics and
the maps an export needs are on the host) -> with ``--trace 1``, a traced
window under torch.profiler for the per-layer metrics -> the comparison
with the plain reference (``compare.py``) on a sample of the window's calls
-> one JSON line on standard output.

It measures ``ventjax_torch`` only, and never on the CPU: without a card it
exits with 2 and prints no result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

from portbench.compare import MAPS, judge

ROOT = Path(__file__).resolve().parents[1]
#: Top-level modules that may not be loaded in a run: the JAX stack and
#: the JAX package the port was made from (compared as whole names).
FORBIDDEN = ("jax", "jaxlib", "flax", "ventjax")
#: Length of the traced window, seconds (at least two calls).
TRACE_SECONDS = 3.0
#: The N4 pad covers the pool's largest lung in steps of the cohort
#: driver's smallest N4 bucket (``pipeline/cohort.py``).
N4_PAD_STEP = 8192
#: The cohort driver's first CI bucket; it grows from there on overflow up
#: to ``VentConfig.ci_max_defect_voxels``, then widens the tail to the pad.
CI_PAD_FIRST = 512


def process_start() -> float:
    """Wall-clock time at which this process started (Linux /proc)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(float(l.split()[1]) for l in f if l.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (sys.modules)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, workload: str) -> SimpleNamespace:
    """The cell called ``workload`` with its configuration and mix."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return SimpleNamespace(
        bench=bench, cell=cell, config=load_json(root / conf["file"]),
        traffic=load_json(root / "portbench" / "traffic"
                          / f"{cell['traffic']}.json"))


def cell_metrics(bench: Dict, name: str, trace: bool) -> List[Dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end ones, or
    with ``trace`` its per-layer ones (those that list the cell, or that
    list none and move an end-to-end metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in names
                             else [])]


def load_reader(root: Path, metric: str):
    """``read(ctx)`` of ``portbench/metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _counters():
    from ventjax_torch.ops import (ci_cuda, n4, n4_cuda, n4_field_cuda,
                                   n4_sharpen_cuda)
    out = {"n4_host_syncs": n4.HOST_SYNCS["n4"]}
    for d in (n4_cuda.LAUNCHES, n4_sharpen_cuda.LAUNCHES, ci_cuda.LAUNCHES,
              n4_field_cuda.LAUNCHES):
        out.update(d)
    return out


def _delta(a: Dict, b: Dict) -> Dict:
    return {k: b[k] - a[k] for k in b}


class Cell:
    """The program under test, set up for one cell: the pool on the host,
    the configuration with its pads and geometry, and one call."""

    def __init__(self, spec: SimpleNamespace, seed: int, device):
        import torch

        from portbench.generate import make_studies
        from ventjax_torch.config import DEFAULT_CONFIG
        from ventjax_torch.pipeline import analyze_cohort

        self.torch = torch
        self.analyze_cohort = analyze_cohort
        self.dev = torch.device(device)
        c, t = spec.config, spec.traffic
        self.shape = tuple(c["shape"])
        self.vox = tuple(c["vox"])
        self.pipe = c["pipeline"]
        self.bs = int(t["studies_per_call"])
        pool = int(t["pool_studies"])
        if pool % self.bs or pool < 2 * self.bs:
            raise ValueError("a mix's pool holds two or more whole calls")
        hp, mask = make_studies(pool, self.shape, self.vox, seed, self.dev,
                                **t["phantom"])
        self.hp = hp.cpu().numpy().reshape(-1, self.bs, *self.shape)
        self.mask = mask.cpu().numpy().reshape(-1, self.bs, *self.shape)
        del hp, mask
        fields = {k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in self.pipe.items()}
        V = int(np.prod(self.shape))
        most = int((self.mask > 0).reshape(-1, V).sum(1).max())
        base = DEFAULT_CONFIG.replace(
            n4_mask_pad=min(V, -(-most // N4_PAD_STEP) * N4_PAD_STEP),
            **fields)
        # The CI pad and tail as the cohort driver grows them, call batch by
        # call batch at the cell's own size: from its first bucket to the
        # power of two that holds the defect count (the defect map does not
        # depend on the CI pad), up to the ceiling, then the tail at the
        # pad's width.  Each batch's output at the final pads is kept.
        top = base.ci_max_defect_voxels
        pads = (min(CI_PAD_FIRST, top), False)
        self.outputs: Dict[int, Dict] = {}
        made_at: Dict[int, tuple] = {}
        self._set_pads(base, *pads)
        for b in range(self.n_batches):
            while True:
                out = self.call(b)[0]
                self.outputs[b], made_at[b] = out, pads
                m = out["metrics"]
                if bool(m["n4_overflow"].any()):
                    raise RuntimeError("the N4 pad overflowed")
                if not bool(m["ci_overflow"].any()):
                    break
                n_def = int((out["defect"] != 0).reshape(self.bs, -1)
                            .sum(1).max())
                if pads[0] < top:
                    need = 1 << int(math.ceil(math.log2(max(n_def, 1))))
                    pads = (min(top, max(2 * pads[0], need)), False)
                elif not pads[1]:
                    pads = (top, True)
                else:
                    raise RuntimeError("the CI pad overflowed at its ceiling")
                self._set_pads(base, *pads)
        for b, at in made_at.items():
            if at != pads:
                self.outputs[b] = self.call(b)[0]

    def _set_pads(self, base, ci_pad: int, tail_full: bool) -> None:
        from ventjax_torch.pipeline import build_geometry
        self.cfg = base.replace(
            ci_max_defect_voxels=ci_pad,
            ci_tail_k=ci_pad if tail_full else base.ci_tail_k)
        self.geom = build_geometry(self.vox, self.shape, self.cfg)

    @property
    def n_batches(self) -> int:
        return self.hp.shape[0]

    def call(self, b: int):
        """One call on pool batch ``b``: (output on the host, seconds)."""
        torch = self.torch
        rf = torch.profiler.record_function
        t0 = time.perf_counter()
        with rf("portbench.h2d"):
            hp = torch.from_numpy(self.hp[b]).to(self.dev)
            mask = torch.from_numpy(self.mask[b]).to(self.dev)
        with rf("portbench.analyze"):
            res = self.analyze_cohort(hp, mask, self.geom, self.cfg)
        with rf("portbench.d2h"):
            out = {k: getattr(res, k).cpu() for k in MAPS}
            out["metrics"] = {k: v.cpu() for k, v in vars(res.metrics).items()}
        return out, time.perf_counter() - t0

    def failed(self, out) -> int:
        """Studies of one call whose result is flagged or not finite."""
        m = out["metrics"]
        bad = (m["ci_overflow"] | m["n4_overflow"] | ~m["valid"])
        for k in ("snr", "vdp", "vdp_lb", "vdp_km", "lung_volume",
                  "defect_volume"):
            bad = bad | ~self.torch.isfinite(m[k])
        return int(bad.sum())


def batch_work(cell: Cell, b: int) -> Dict:
    """What the kernels' work counts read for pool batch ``b``: the N4
    weights' terms, each study's iterations a level (the program's N4 on
    the same inputs, outside the windows), the program's defect map."""
    torch = cell.torch
    from portbench.kernels.work import lane_terms
    from portbench.reference.geometry import shell_structure, sphere_pixels
    from ventjax_torch.ops.n4 import n4_bias_correction

    p = cell.pipe
    hp = torch.from_numpy(cell.hp[b]).to(cell.dev)
    mask = torch.from_numpy(cell.mask[b]).to(cell.dev)
    _, iters = n4_bias_correction(
        hp, mask, fitting_levels=p["n4_fitting_levels"],
        max_iters=p["n4_max_iters"],
        convergence_threshold=p["n4_convergence_threshold"],
        bins=p["n4_histogram_bins"], fwhm=p["n4_bias_fwhm"],
        wiener_noise=p["n4_wiener_noise"],
        control_points=p["n4_control_points"],
        mask_pad=cell.cfg.n4_mask_pad, return_iters=True)
    weights = (mask > 0) & (hp > 0)
    radii = shell_structure(sphere_pixels(cell.vox, p["ci_rmax"]))[0]
    return {"terms": lane_terms(weights, p["n4_fitting_levels"],
                                p["n4_control_points"]),
            "iters": iters.to(torch.int64),
            "defect": cell.outputs[b]["defect"].to(cell.dev),
            "rmax": int(p["ci_rmax"]), "n_balls": len(radii)}


def kernel_specs(root: Path) -> Dict[str, Dict]:
    """``portbench/kernels/<kernel>.json`` by kernel name."""
    return {p.stem: load_json(p)
            for p in sorted((root / "portbench" / "kernels").glob("*.json"))}


def traced_window(cell: Cell, order: List[int], start: int, root: Path,
                  tries: int = 3):
    """(Trace, calls' batch indices, counter deltas) of a window of calls
    under torch.profiler; a session that lost device activities (fewer
    kernel activities than the wrappers counted launches) is taken again."""
    torch = cell.torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import devtrace

    seen = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(24):
                torch.cuda._sleep(100)
            cell.call(order[start % len(order)])
            torch.cuda.synchronize()
            c0 = _counters()
            calls, t0, i = [], time.perf_counter(), start + 1
            with torch.profiler.record_function("portbench.window"):
                while len(calls) < 2 or time.perf_counter() - t0 < TRACE_SECONDS:
                    b = order[i % len(order)]
                    with torch.profiler.record_function("portbench.call"):
                        cell.call(b)
                    calls.append(b)
                    i += 1
            torch.cuda.synchronize()
            counts = _delta(c0, _counters())
        tr = devtrace.read(prof, "portbench.window", "portbench.call")
        # each roofline kernel's first activity name runs once a launch
        got = {k: tr.device_seconds([spec["match"][0]])[1]
               for k, spec in kernel_specs(root).items()}
        seen.append(got)
        if all(got[k] == counts.get(k, got[k]) for k in got):
            return tr, calls, counts
    raise RuntimeError(f"torch.profiler lost device activities in {tries} "
                       f"sessions: {seen}")


def card_info(torch, chips: int) -> Dict:
    import subprocess
    limit = None
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        limit = q.stdout.strip().splitlines()[0] if q.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "power_limit": limit}


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(argv: List[str], device: Optional[str] = None,
        root: Path = ROOT, breaker=None) -> int:
    """A whole run; returns the exit code.  ``device`` is the card unless a
    test names the CPU; ``breaker`` lets a test break the timed path."""
    t_proc = process_start()
    out = measure(parse(argv), t_proc, device, root, breaker)
    if isinstance(out, int):
        return out
    result, rows = out
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    for k, v, lim in rows:
        print(f"check {k} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def measure(args: argparse.Namespace, t_proc: float, device=None,
            root: Path = ROOT, breaker=None):
    """(result, checks) of one run, or an exit code where it cannot run."""
    spec = load_cell(root, args.workload)
    chips = int(spec.cell["chips"])

    import torch
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA card(s); "
                  f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                  f"{torch.cuda.device_count()} visible; no result",
                  file=sys.stderr)
            return 2
        device = "cuda:0"
    on_card = torch.device(device).type == "cuda"
    torch.set_num_threads(2)
    if on_card:
        from ventjax_torch import _build
        from ventjax_torch.utils.doctor import LIBRARIES
        with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as pool:
            for f in [pool.submit(_build.build, n) for n in LIBRARIES]:
                f.result()
        for n in LIBRARIES:
            _build.load(n)

    cell = Cell(spec, args.seed, device)
    log(f"set up: N4 pad {cell.cfg.n4_mask_pad}, CI pad "
        f"{cell.cfg.ci_max_defect_voxels}, CI tail {cell.cfg.ci_tail_k}, "
        f"{time.time() - t_proc:.1f} s after the process started")
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
    c0 = _counters()
    t_setup = time.time() - t_proc
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < args.seconds:
        b = order[i % len(order)]
        out, dt = cell.call(b)
        lat.append(dt)
        studies += cell.bs
        fails += cell.failed(out)
        # reservoir sample of the calls, drawn from the seed
        if len(sample) < n_sample:
            sample.append((b, out))
        else:
            j = int(rng.integers(0, i + 1))
            if j < n_sample:
                sample[j] = (b, out)
        i += 1
    window_s = time.perf_counter() - t0
    counts = _delta(c0, _counters())
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    calls = i

    result: Dict = {"correct": False, "attempted": studies, "failed": fails}
    names = cell_metrics(spec.bench, args.workload, bool(args.trace))
    values: Dict[str, float] = {}
    device_info = (card_info(torch, chips) if on_card else
                   {"platform": "cpu", "kind": "cpu", "count": 1})
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
        tr, tcalls, tcounts = traced_window(cell, order, i, root)
        log(f"traced window: {len(tcalls)} calls, {len(tr.device)} device "
            f"activities, read in {time.time() - t_tr:.1f} s")
        work: Dict[int, Dict] = {}
        ctx = SimpleNamespace(
            trace=tr, calls=tcalls, studies=len(tcalls) * cell.bs,
            counts=tcounts, window_calls=calls, window_counts=counts,
            root=root,
            work=lambda b: work.setdefault(b, batch_work(cell, b)))
        for m in names:
            v = load_reader(root, m["name"])(ctx)
            if v is not None:
                values[m["name"]] = v
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        del work, ctx

    log(f"window: {calls} calls in {window_s:.2f} s")
    t_ref = time.time()
    # the reference, once the window has closed and the program's state
    # is freed
    samples = [(cell.hp[b], cell.mask[b], out, cell.outputs[b])
               for b, out in sample]
    del cell.outputs
    if on_card:
        torch.cuda.empty_cache()
    limits = {k: v for k, v in spec.config["fidelity"].items()
              if not k.startswith("_")}
    ok, rows = judge(samples, cell.vox, cell.pipe, limits, device)
    log(f"reference: {len(samples)} calls judged in "
        f"{time.time() - t_ref:.1f} s")
    units = {m["name"]: m["unit"] for m in names}
    result["correct"] = bool(ok)
    result["metrics"] = {k: {"value": v, "unit": units[k]}
                         for k, v in values.items()}
    result["device"] = device_info
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows
