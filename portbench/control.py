#!/usr/bin/env python3
"""Readings that the limits of the comparison were set from.

    python3 portbench/control.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--seconds 3] [--out FILE]

run on the card from the root of a checkout.  For each of ``--seeds`` it
makes a run of the cell with a short window (the program's readings,
which give each number's lower reading), and for each of
``--control-seeds`` the control: the plain reference put in the program's
place and computed one precision below the configuration's (float32 with
TF32 matrix products, where the configuration states float32 with TF32
off), on the batches a run would sample, judged by the same comparison
(each number's upper reading).  One JSON line per reading goes to
standard output and to ``--out``.  The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from portbench import harness  # noqa: E402


@contextlib.contextmanager
def tf32():
    """TF32 matrix products on inside the block."""
    import torch
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def control_readings(spec, seed: int, device):
    """(correct, checks) of the control on the cell's own batches: the
    reference in float32 with TF32 products in the program's place."""
    import torch

    from portbench.compare import MAPS, judge
    from portbench.generate import make_studies
    from portbench.reference import pipeline as R

    c, t = spec.config, spec.traffic
    shape, vox, bs = tuple(c["shape"]), tuple(c["vox"]), t["studies_per_call"]
    hp, mask = make_studies(t["pool_studies"], shape, vox, seed, device,
                            **t["phantom"])
    hp = hp.cpu().numpy().reshape(-1, bs, *shape)
    mask = mask.cpu().numpy().reshape(-1, bs, *shape)
    rng = np.random.default_rng([seed % (1 << 63), 7])
    batches = [int(b) for b in rng.permutation(hp.shape[0])]
    samples = []
    for b in batches[:t["sample_calls"]]:
        with tf32():
            out = R.analyze(torch.as_tensor(hp[b], device=device),
                            torch.as_tensor(mask[b], device=device), vox,
                            c["pipeline"], dtype=torch.float32)
        got = {**{k: out[k].float().cpu() for k in MAPS},
               "metrics": {k: v.cpu() for k, v in out["metrics"].items()}}
        # the control runs each batch once: it is its own repeat
        samples.append((hp[b], mask[b], got, got))
    limits = {k: v for k, v in c["fidelity"].items() if not k.startswith("_")}
    return judge(samples, vox, c["pipeline"], limits, device)


def main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control.py: needs a CUDA card", file=sys.stderr)
        return 2
    sink = open(args.out, "a") if args.out else None

    def emit(rec: Dict):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for seed in args.seeds:
        t0 = time.time()
        out = harness.measure(harness.parse(
            ["--workload", args.workload, "--seed", str(seed),
             "--seconds", str(args.seconds)]), time.time())
        result, rows = out
        emit({"kind": "program", "workload": args.workload, "seed": seed,
              "correct": result["correct"], "failed": result["failed"],
              "checks": {k: v for k, v, _ in rows},
              "seconds": time.time() - t0})
    spec = harness.load_cell(ROOT, args.workload)
    for seed in args.control_seeds:
        t0 = time.time()
        ok, rows = control_readings(spec, seed, "cuda:0")
        emit({"kind": "control", "workload": args.workload, "seed": seed,
              "correct": ok, "checks": {k: v for k, v, _ in rows},
              "seconds": time.time() - t0})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
