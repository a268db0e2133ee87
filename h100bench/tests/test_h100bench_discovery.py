"""The harness finds every piece by name, and a later change can add a
configuration, a traffic mix, a metric and a cell by adding files and
entries only."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from h100bench import cell as cells

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_each_cell_finds_its_pieces():
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        c = cells.find_cell(w["name"], bench)
        assert c.config["model"] == w["config"]
        assert cells.runner(c.traffic["kind"]).run
        assert c.limits
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer
        for m in c.end_to_end + c.per_layer:
            assert callable(cells.reader(m["name"]))
        for m in c.per_layer:
            assert m["moves"] in names


def test_every_file_named_in_the_benchmark_exists():
    bench = cells.load_benchmark()
    for cfg in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, cfg["file"]))
    here = os.path.join(ROOT, "h100bench")
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(here, "traffic", w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(here, "limits", w["name"] + ".json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(here, "metrics", m["name"] + ".py"))


def test_a_missing_cell_is_refused():
    with pytest.raises(KeyError):
        cells.find_cell("no.such_cell")


def test_an_added_configuration_mix_metric_and_cell_run_without_editing_a_file(tmp_path):
    """A copy of the benchmark gains a configuration (TIGER at another
    dropout), a traffic mix (streamed training at batch 8), a metric and a
    cell, by new files and new entries only; the cell runs end to end on the
    CPU and reports the new metric."""
    shutil.copytree(os.path.join(ROOT, "h100bench"), tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    hb = tmp_path / "h100bench"
    cfg = json.loads((hb / "configs" / "tiger.json").read_text())
    cfg["arch"]["dropout_rate"] = 0.2
    (hb / "configs" / "tiger_dropout.json").write_text(json.dumps(cfg))
    (hb / "traffic" / "train_b8.json").write_text(json.dumps({
        "kind": "train", "students": 24, "batch": 8, "items": 700, "min_items": 4,
        "max_items": 41, "num_topics": 16, "topic_stickiness": 0.85, "checked_steps": 3,
        "warmup_steps": 3, "trace_steps": 1}))
    (hb / "limits" / "tiger_dropout.train_b8.json").write_text(json.dumps(
        {"batch_mismatch": {"limit": 0}, "loss_gap": {"limit": 1e-4},
         "grad_gap": {"limit": 1e-3}, "update_gap": {"limit": 1e-2}}))
    (hb / "metrics" / "steps_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx['window']['steps'])\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiger_dropout", "source": "test",
                             "file": "h100bench/configs/tiger_dropout.json",
                             "reduced": ["arch"], "why": "test"})
    bench["workloads"].append({"name": "tiger_dropout.train_b8", "config": "tiger_dropout",
                               "traffic": "train_b8", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("tiger_dropout.train_b8")
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "test",
                               "moves": "train_examples_per_s",
                               "workloads": ["tiger_dropout.train_b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, time, torch; torch.set_num_threads(2)\n"
        "from h100bench import run\n"
        "cell, r = run.run_cell('tiger_dropout.train_b8', 3, 0.5, True, 'cpu', time.perf_counter())\n"
        "print(json.dumps(run.result_line(cell, r, True, {'platform': 'cpu'})))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line
    assert line["metrics"]["steps_in_window"]["value"] >= 1


def test_benchmark_json_keeps_the_contracts_forms():
    import re

    bench = cells.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    line = lambda s: 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s  # noqa: E731
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert all(line(w) for w in bench["command"]) and len(bench["command"]) <= 32
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert all(name.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and name.match(w["traffic"]) and line(w["why"])
        assert w["chips"] == 1
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert len(json.dumps(bench)) <= 64 * 1024
