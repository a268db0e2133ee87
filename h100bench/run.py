"""Run one cell of the benchmark once and print its result line.

    python3 -m h100bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run makes its inputs and weights from the
seed, sets up, warms up, measures for ``--seconds``, checks what the timed
path produced against the plain reference, and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``: each number compared, with its limit (also the last lines of
standard error). It exits 2, and prints no result, without enough CUDA
devices for the cell, and 3 if the JAX package or JAX was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "genrec_tpu")


def forbidden_modules():
    """Modules loaded whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def result_line(cell, run, trace: bool, device_info: dict) -> dict:
    from h100bench import cell as cells, check

    ctx = {"cell": cell, "window": run.window, "spans": run.spans,
           "trace": run.trace if trace else None, "setup_s": run.setup_s}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, shown = check.judge(run.numbers, cell.limits)
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        tr = run.trace
        device_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {
            "device_ops": sorted(([k, v] for k, v in tr["ops"].items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(([k, v] for k, v in tr["idle"].items()),
                                key=lambda kv: -kv[1])[:10]}
    out["check"] = shown
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t0: float,
             traffic_overrides=None):
    """Set up, measure and check one cell on ``device``: the runner's Run."""
    import torch

    from h100bench import cell as cells

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cell = cells.find_cell(name)
    if traffic_overrides:
        cell.traffic.update(traffic_overrides)
    return cell, cells.runner(cell.traffic["kind"]).run(cell, seed, seconds, trace, device, t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from h100bench import cell as cells

    chips = cells.find_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    cell, run = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                   "memory_peak_bytes": run.memory_peak_bytes}
    line = result_line(cell, run, bool(args.trace), device_info)
    bad = forbidden_modules()
    if bad:
        print(f"h100bench: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for note in run.notes:
        print(note, file=sys.stderr)
    for name, c in line["check"].items():
        verdict = "ok" if line["correct"] or (c["value"] is not None and c["value"] <= c["limit"]) \
            else "FAILS"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
