#!/usr/bin/env python3
"""Where K9's time goes: variants of ventjax_torch/csrc/ci_densify.cu's
one-launch rank scan, timed round-robin on one NVIDIA GPU.

Run from the repository root:  python3 scripts/k9_variants.py [--rounds 8]

Each variant is the committed source with one change, written under
build/k9_variants/<name>/ and built by nvcc under its own name:
- committed: the source as it is (512-thread blocks; each lane of the
  look-back waits for its own word of the window);
- threads256, threads1024: 256- or 1024-thread blocks (K9's tile is
  16 x 2 voxels a thread, so a row has 2x or 1/2x the tiles);
- wait_nearest: the look-back waits only for the words down to the
  nearest published inclusive prefix, re-reading the words that hold a
  count alone (a nearer prefix may appear meanwhile);
- no_wait (a diagnostic, wrong ranks): the tile offset taken as 0, so no
  block waits for another.
The variants that compute ranks are held bit-equal to rank_plain at
V 262,144, 100,003 and 4,112.  Device time per call by
chip_smoke.device_ms at the main path's shape (N 16, V 262,144, the
slice's defect share), each variant once per round, the order reversed
every other round.  Prints one JSON line of means and rounds, with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from ventjax_torch import _build  # noqa: E402
from ventjax_torch.ops import ci_densify_cuda as cd  # noqa: E402

WAIT_NEAREST = '''    unsigned s = idx >= 0 ? load_status(status + idx) : ST_P;
    unsigned pmask;
    while (true) {
      pmask = __ballot_sync(FULL, s >= ST_P);
      const unsigned need = pmask != 0u ? pmask ^ (pmask - 1u) : FULL;
      if ((__ballot_sync(FULL, s == 0u) & need) == 0u) break;
      if (s < ST_P && ((need >> lid) & 1u)) s = load_status(status + idx);
    }'''
WAIT_ALL = '''    unsigned s = ST_P;
    if (idx >= 0) {
      do {
        s = load_status(status + idx);
      } while (s == 0u);
    }
    const unsigned pmask = __ballot_sync(FULL, s >= ST_P);'''
THREADS = "constexpr int RANK_THREADS = 512;"
BOUNDS = "__launch_bounds__(RANK_THREADS, 2) rank_scan"
LOOK = "const unsigned excl = tile > 0 ? look_back(status, tile, lid) : 0u;"

VARIANTS = {
    "committed": [],
    "threads256": [(THREADS, "constexpr int RANK_THREADS = 256;"),
                   (BOUNDS, "__launch_bounds__(RANK_THREADS, 4) rank_scan")],
    "threads1024": [(THREADS, "constexpr int RANK_THREADS = 1024;"),
                    (BOUNDS, "__launch_bounds__(RANK_THREADS, 1) rank_scan")],
    "wait_nearest": [(WAIT_ALL, WAIT_NEAREST)],
    "no_wait": [(LOOK, "const unsigned excl = 0u;")],
}
DIAGNOSTIC = ("no_wait",)


def write_variants(root):
    src = (REPO / "ventjax_torch" / "csrc" / "ci_densify.cu").read_text()
    dirs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the source no longer "
                                   f"holds {old.strip()[:60]!r}")
            text = text.replace(old, new)
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "ci_densify.cu").write_text(text)
        dirs[name] = d
    return dirs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k9_variants: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dirs = write_variants(REPO / "build" / "k9_variants")
    with ThreadPoolExecutor(len(dirs)) as pool:
        list(pool.map(lambda d: _build.build("ci_densify", d), dirs.values()))
    libs = {n: _build.load("ci_densify", d) for n, d in dirs.items()}
    gen = np.random.default_rng(0)
    for name, lib in libs.items():
        if name in DIAGNOSTIC:
            continue
        for N, V in ((16, 262144), (16, 100003), (3, 4112)):
            d = torch.from_numpy(gen.random((N, V)) < 0.05).to(dev)
            got = cs.under(cd, lib, lambda: cd.rank(d))()
            if not torch.equal(got, cd.rank_plain(d)):
                raise AssertionError(f"variant {name} differs at {N}x{V}")
    d01 = (cs.severe_map(512, dev) != 0).reshape(cs.BATCH, -1)
    fns = {n: cs.under(cd, lib, lambda: cd.rank(d01))
           for n, lib in libs.items()}
    names = list(fns)
    rounds = {n: [] for n in names}
    for r in range(args.rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            rounds[n].append(cs.device_ms(fns[n]))
    print(json.dumps({
        "card": card, "N": cs.BATCH, "V": int(d01.shape[1]),
        "mean_ms": {n: float(np.mean(v)) for n, v in rounds.items()},
        "rounds_ms": rounds}), flush=True)


if __name__ == "__main__":
    main()
