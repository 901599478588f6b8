"""A tiny cell for the CPU tests: a copy of the benchmark's data in a
temporary root, with a 64x64x8 configuration, a mix of two studies a call
and a cell ``tiny.cell`` added as new files and entries."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DATA = ("configs", "traffic", "metrics", "kernels")


def make_root(tmp: Path) -> Path:
    """A root holding BENCHMARK.json and portbench's data files, plus the
    tiny configuration, mix and cell (listed by every per-layer metric)."""
    for d in DATA:
        shutil.copytree(ROOT / "portbench" / d, tmp / "portbench" / d)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "portbench/configs/clinical_128x128x16.json")
                      .read_text())
    conf.update(name="tiny", shape=[64, 64, 8])
    (tmp / "portbench/configs/tiny.json").write_text(json.dumps(conf))
    mix = json.loads((ROOT / "portbench/traffic/typical.b16.pool32.json")
                     .read_text())
    mix.update(name="tiny", studies_per_call=2, pool_studies=4,
               sample_calls=2)
    (tmp / "portbench/traffic/tiny.json").write_text(json.dumps(mix))
    bench["configs"].append({"name": "tiny", "source": "a test size",
                             "file": "portbench/configs/tiny.json",
                             "reduced": ["shape"], "why": "CPU tests"})
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny",
                               "traffic": "tiny", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append("tiny.cell")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run_tiny(root: Path, capsys, seconds: float = 1.0, seed: int = 3,
             breaker=None):
    """(exit code, the result line as a dict or None, stderr) of a run of
    the tiny cell on the CPU."""
    from portbench.harness import run

    rc = run(["--workload", "tiny.cell", "--seed", str(seed), "--seconds",
              str(seconds)], device="cpu", root=root, breaker=breaker)
    out, err = capsys.readouterr()
    lines = [l for l in out.splitlines() if l.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), err
