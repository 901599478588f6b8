"""BENCHMARK.json's form, the result line's schema, the run without a card
and the import boundary (no JAX, no JAX package, no bench.py)."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests._tiny import ROOT, make_root, run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_and_names():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_cells_configs_and_mixes_resolve():
    configs = {c["name"]: c for c in BENCH["configs"]}
    pairs = set()
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        spec = harness.load_cell(ROOT, w["name"])
        assert spec.config["name"] == w["config"]
        assert spec.traffic["name"] == w["traffic"]
    for c in configs.values():
        assert c["file"].startswith("portbench/") and c["reduced"] == []
        assert len(c["source"]) <= 200
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)


def test_every_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert callable(harness.load_reader(ROOT, m["name"]))
    assert [m["name"] for m in harness.cell_metrics(
        BENCH, "clinical.cohort16", False)] == [
        "studies_per_s", "latency_ms_p95", "peak_mem_mib", "setup_s"]


def test_result_line_schema(tmp_path, capsys):
    rc, res, err = run_tiny(make_root(tmp_path), capsys)
    assert rc == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0 and res["attempted"] % 2 == 0
    assert set(res["metrics"]) == {"studies_per_s", "latency_ms_p95",
                                   "peak_mem_mib", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert res["device"]["platform"] == "cpu"
    assert set(res["checks"]) == {"snr_rel", "n4_rel", "vdp_pp",
                                  "defect_mismatch", "ci_map_mm",
                                  "ci_subject_mm", "volume_rel",
                                  "repeat_diff"}
    # each compared number beside its limit, as the last lines of stderr
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(l.startswith("check ") and " limit " in l for l in tail)


def test_no_card_exits_nonzero_without_a_result():
    p = subprocess.run(
        [sys.executable, str(ROOT / "portbench/run.py"), "--workload",
         "clinical.cohort16", "--seed", "2147483700", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _literals(path: Path):
    """String constants of a module other than its docstrings."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_no_jax_nor_jax_package_nor_bench_imported():
    for path in (ROOT / "portbench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "ventjax", "bench",
                           "benchmarks"}, path
        if "tests" not in path.parts:
            assert not [s for s in _literals(path)
                        if "bench.py" in s or "benchmarks/" in s], path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "functools", "math", "typing", "numpy",
                        "torch", "portbench"}, (path, tops)


@pytest.mark.parametrize("mods,found", [
    (["jax.numpy"], ["jax"]), (["ventjax.ops"], ["ventjax"]),
    (["ventjax_torch", "jaxtyping", "flaxen"], []),
    (["flax", "jaxlib"], ["flax", "jaxlib"])])
def test_forbidden_modules_compares_whole_top_level_names(mods, found):
    assert harness.forbidden_modules(["os", "portbench.harness"] + mods) \
        == found
