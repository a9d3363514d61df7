"""The harness is driven by data: a cell, a configuration, a traffic mix
and a metric added as new files and entries are found without an edit;
BENCHMARK.json keeps to its contract's shape; the run refuses to print a
result without a card or without the port; nothing under benchmark/
imports JAX or the JAX side, and the yardstick imports nothing of the
port."""

import ast
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "cffm_tpu", "oracle", "bench", "bench_input",
             "bench_scaling", "scripts"}
# the yardstick: what later changes to the port may not move
YARDSTICK = ("reference.py", "traffic.py", "work.py", "checks.py", "weights.py", "trace.py")


def _roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_side_imports(path):
    assert not set(_roots(path)) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_port(name):
    assert "cffm_tpu_torch" not in set(_roots(BENCH / name))


def test_benchmark_json_shape():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "checks" / f"{w['name']}.json").exists()
        reported = [m for m in e2e.values() if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
    for m in b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", m["workloads"]))
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists()


def test_new_cell_config_traffic_and_metric_are_found(tmp_path):
    """Copy the benchmark, add one of each as new files and entries, and
    resolve the new cell and metric from the copy, with no file edited."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "criteo_kaggle.json").read_text())
    cfg["name"] = "criteo_kaggle_copy"
    (tmp_path / "benchmark" / "configs" / "criteo_kaggle_copy.json").write_text(json.dumps(cfg))
    traffic = json.loads((BENCH / "traffic" / "train_zipf.json").read_text())
    traffic["ids"] = dict(traffic["ids"], a=1.1)
    (tmp_path / "benchmark" / "traffic" / "train_flat.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark" / "checks" / "copy-train-flat.json").write_text(
        json.dumps({"change_gap_median": 0.004}))
    (tmp_path / "benchmark" / "metrics" / "steps.train.py").write_text(
        "def read(run):\n    return float(run.window_examples)\n")
    b["configs"].append(dict(b["configs"][0], name="criteo_kaggle_copy",
                             file="benchmark/configs/criteo_kaggle_copy.json"))
    b["workloads"].append({"name": "copy-train-flat", "config": "criteo_kaggle_copy",
                           "traffic": "train_flat", "chips": 1, "why": "test"})
    for m in b["end_to_end"]:
        if m["name"] == "train_ex_per_s":
            m["workloads"].append("copy-train-flat")
    b["per_layer"].append({"name": "steps.train", "unit": "ex", "better": "higher",
                           "source": "host_clock", "layer": "step", "moves": "train_ex_per_s",
                           "workloads": ["copy-train-flat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = "\n".join([
        "from benchmark import spec, readers",
        "b = spec.benchmark()",
        "c = spec.cell(b, 'copy-train-flat')",
        "assert c['config']['name'] == 'criteo_kaggle_copy'",
        "assert c['traffic']['ids']['a'] == 1.1",
        "assert spec.driver(c['traffic']).__name__ == 'benchmark.drivers.train'",
        "m = [m for m in b['per_layer'] if spec.applies(m, 'copy-train-flat')]",
        "assert [x['name'] for x in m] == ['steps.train'], m",
        "run = readers.Run(model={}, train=True, window_s=1.0, window_examples=7)",
        "assert spec.metric_module('steps.train').read(run) == 7.0",
        "assert spec.applies([e for e in b['end_to_end'] if e['name'] == 'setup_s'][0],",
        "                    'copy-train-flat')",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env={"PYTHONPATH": str(tmp_path), "PATH": ""})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_run_without_a_card_prints_nothing_and_fails():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "kaggle-train-zipf",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_run_without_the_port_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "kaggle-train-zipf",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
