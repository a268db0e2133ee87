"""Finds a cell's pieces by name, from ``BENCHMARK.json`` and the files
beside this module; keeps no list of them in code.

- configuration ``<c>``: ``configs/<c>.json``;
- traffic mix ``<t>``: ``traffic/<t>.json``, whose ``kind`` names the
  general runner that reads it (``runners/<kind>.py``);
- limits of the correctness check of cell ``<w>``: ``limits/<w>.json``;
- metric ``<m>``: its reader ``metrics/<m>.py``, a ``read(ctx)`` that
  returns the value or None when it finds nothing to read.

A cell reports the end-to-end metrics whose ``workloads`` list it (all of
them where there is no list) and, in a traced run, the per-layer metrics
whose ``workloads`` list it, or, without a list, those whose ``moves``
metric it reports.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: Optional[dict] = None, here: str = HERE) -> Cell:
    bench = load_benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name=name, chips=w["chips"],
                config=_json(os.path.join(here, "configs", w["config"] + ".json")),
                traffic=_json(os.path.join(here, "traffic", w["traffic"] + ".json")),
                limits=_json(os.path.join(here, "limits", name + ".json")),
                end_to_end=e2e, per_layer=layer)


def runner(kind: str):
    """The general runner of a traffic kind, ``h100bench.runners.<kind>``."""
    return importlib.import_module(f"h100bench.runners.{kind}")


def reader(metric: str, here: str = HERE):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(here, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("h100bench_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
