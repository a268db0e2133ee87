"""The benchmark measures the port only: no module it loads is JAX or the
JAX package (top-level names compared whole, since the port's name begins
with the JAX package's), and its yardstick loads nothing of the port."""

import ast
import json
import os
import subprocess
import sys

from h100bench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "h100bench")
YARDSTICK = ("reference/model.py", "check.py", "counts.py", "corpus.py", "trace.py",
             "readings.py", "cell.py")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _files():
    for d, _, names in os.walk(BENCH):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def test_top_level_names_are_compared_whole(monkeypatch):
    fake = ["genrec_tpu_torch.models", "jaxtyping", "flaxen", "genrec_tpux"]
    for name in fake:
        monkeypatch.setitem(sys.modules, name, sys)
    for name in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    assert run.forbidden_modules() == []
    for name in ("genrec_tpu.data", "jax", "jaxlib.xla", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == ["flax.linen", "genrec_tpu.data", "jax", "jaxlib.xla"]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _files():
        for mod in _imports(path):
            assert mod.split(".")[0] not in run.FORBIDDEN, (path, mod)


def test_the_yardstick_imports_nothing_of_the_port():
    paths = [os.path.join(BENCH, p) for p in YARDSTICK]
    paths += [os.path.join(BENCH, "metrics", n) for n in os.listdir(os.path.join(BENCH, "metrics"))]
    for path in paths:
        for mod in _imports(path):
            assert mod.split(".")[0] != "genrec_tpu_torch", (path, mod)
    code = ("import sys, json; import h100bench.reference.model, h100bench.check, "
            "h100bench.counts, h100bench.corpus, h100bench.trace, h100bench.readings; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    loaded = set(json.loads(out.stdout))
    assert not loaded & {"genrec_tpu_torch", "genrec_tpu", "jax", "jaxlib", "flax"}, loaded


def test_a_whole_run_loads_neither_jax_nor_the_jax_package(tiny):
    code = (
        "import json, sys, time, torch; torch.set_num_threads(2)\n"
        "from h100bench import run\n"
        f"cell, r = run.run_cell('tiger.recommend_b4096', 5, 0.5, False, 'cpu', time.perf_counter(), "
        f"{tiny['tiger.recommend_b4096']!r})\n"
        "print(json.dumps(run.forbidden_modules()))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == []
    assert "genrec_tpu_torch" in json.loads(lines[-1])
