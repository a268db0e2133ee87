"""The result line's keys and the run's refusals."""

import json

import pytest

from h100bench import cell as cells, check, run
from h100bench.runners import Run


def _run(trace):
    tr = {"busy_s": 0.9, "window_s": 1.0, "steps": 2, "launches": [0, 0, 0],
          "ops": {"gemm": 0.5, "elementwise": 0.4}, "idle": {"generate": 0.08, "readback": 0.02}}
    return Run(setup_s=9.5, window={"seconds": 2.0, "batches": 4, "students": 400,
                                    "latencies": [0.5, 0.5, 0.4, 0.6], "flops": 1e12, "batch": 100},
               spans={"generate": [0.01] * 4, "readback": [0.4] * 4},
               trace=tr if trace else None, numbers={"score_gap": 1e-6, "best_gap": 0.0},
               notes=[], attempted=4, failed=0, memory_peak_bytes=123)


def test_the_last_line_has_the_contract_keys_and_check_last():
    cell = cells.find_cell("tiger.recommend_b4096")
    dev = {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 123}
    line = run.result_line(cell, _run(False), False, dict(dev))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert set(line["metrics"]) == {"recs_per_s", "recommend_ms_p95", "setup_s"}
    assert line["metrics"]["recs_per_s"] == {"value": 200.0, "unit": "students/s"}
    assert line["correct"] is True
    assert line["check"]["score_gap"] == {"value": 1e-6, "limit": cell.limits["score_gap"]["limit"]}
    traced = run.result_line(cell, _run(True), True, dict(dev))
    assert list(traced)[-1] == "check" and "breakdown" in traced
    assert traced["device"]["busy_s"] == 0.9 and traced["device"]["window_s"] == 1.0
    assert traced["breakdown"]["idle_gaps"][0] == ["generate", 0.08]
    assert {m["name"] for m in cell.per_layer} >= set(traced["metrics"])
    assert "device_idle_pct.recommend" in traced["metrics"]
    json.dumps(traced)


def test_a_number_over_its_limit_or_missing_is_not_correct():
    ok, shown = check.judge({"a": 2.0}, {"a": {"limit": 1.0}, "b": {"limit": 0}})
    assert not ok and shown["b"]["value"] is None
    assert check.judge({"a": float("nan")}, {"a": {"limit": 1.0}})[0] is False
    assert check.judge({"a": 1.0}, {"a": {"limit": 1.0}})[0] is True


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "tiger.recommend_b4096", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_with_jax_loaded_the_run_prints_no_result(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "jax", sys)
    assert "jax" in run.forbidden_modules()


@pytest.mark.card
def test_a_whole_run_on_the_card(card, capsys):
    assert run.main(["--workload", "tiger.recommend_b4096", "--seed", "3", "--seconds", "2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
