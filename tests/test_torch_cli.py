"""The port's CLI (genrec_tpu_torch/cli.py) against the JAX package's, on the
CPU at a tiny size:

- every subcommand parses the JAX CLI's flags to the same defaults, plus
  ``--device`` on the pipelines and ``serve``, and ``--help`` works; each
  training subcommand hands its pipeline the JAX CLI's config;
- ``synth --users 60 --items 40`` writes the JAX CLI's files, array for array;
- each training subcommand but ``tiger-prefix`` at its default config and
  ``--device cpu`` writes a best checkpoint, and ``sasrec`` and ``tiger``
  the results CSV at the JAX CLI's path with its columns;
- ``serve --tiger-ckpt`` (through ``make_context``, on port 0) answers
  ``/api/v1/recommend/model`` with ``tiger_model_fn``'s lists for the
  checkpoint ``tiger`` wrote, after ``init-db``.
"""

import argparse
import ast
import contextlib
import csv
import dataclasses
import importlib
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.request

import h5py
import numpy as np
import pytest
import torch

from genrec_tpu import cli as jcli
from genrec_tpu.pipelines import sasrec_pipeline as jsasrec
from genrec_tpu.pipelines import tiger_pipeline as jtiger
from genrec_tpu_torch import cli
from genrec_tpu_torch.backend.server import BackendHTTPServer
from genrec_tpu_torch.serving.model_fn import tiger_model_fn

PIPELINES = ("sasrec", "rqvae", "tiger", "tiger-prefix", "dense-t5")
REQUIRED = {"etl-app-db": ["--db", "x.db"], "etl-mooccube": ["--courses", "c", "--users", "u"]}
SUBCOMMANDS = ("synth",) + PIPELINES + ("etl-app-db", "etl-mooccube", "serve", "init-db",
                                        "view-db", "check-alignment")


class _Parsed(Exception):
    pass


def _parsed(main, argv, monkeypatch):
    """The namespace ``main`` parses from ``argv``, without running it."""
    orig = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        raise _Parsed(orig(self, args, namespace))

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed) as e:
            main(argv)
    return {k: v for k, v in vars(e.value.args[0]).items() if k != "fn"}


@pytest.mark.parametrize("sub", SUBCOMMANDS)
def test_subcommand_parses_the_jax_flags_and_defaults(sub, monkeypatch, capsys):
    argv = [sub] + REQUIRED.get(sub, [])
    got, want = _parsed(cli.main, argv, monkeypatch), _parsed(jcli.main, argv, monkeypatch)
    if sub in PIPELINES or sub == "serve":
        assert got.pop("device") is None
    assert got == want
    with pytest.raises(SystemExit) as e:
        cli.main([sub, "--help"])
    assert e.value.code == 0
    assert (("--device" in capsys.readouterr().out)
            == (sub in PIPELINES or sub == "serve"))


def test_module_entry_point_runs_check_alignment():
    """``python -m genrec_tpu_torch.cli check-alignment`` runs
    tests/test_torch_alignment.py's ten invariants."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "genrec_tpu_torch.cli", "check-alignment"],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:]
    assert "10 passed" in out.stdout


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _h5_items(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def test_synth_writes_the_jax_files(tmp_path):
    argv = ["synth", "--users", "60", "--items", "40"]
    cli.main(argv + ["--out", str(tmp_path / "port")])
    jcli.main(argv + ["--out", str(tmp_path / "jax")])
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax") and len(files) == 10
    for rel in files:
        a, b = str(tmp_path / "port" / rel), str(tmp_path / "jax" / rel)
        if rel.endswith(".h5"):
            ta, tb = _h5_items(a), _h5_items(b)
            assert sorted(ta) == sorted(tb), rel
            for k in ta:
                assert ta[k].dtype == tb[k].dtype, (rel, k)
                if ta[k].dtype.kind == "O":
                    assert [np.asarray(x).tolist() for x in ta[k]] == \
                           [np.asarray(x).tolist() for x in tb[k]], (rel, k)
                else:
                    np.testing.assert_array_equal(ta[k], tb[k])
        elif rel.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype and x.shape == (41, 4)
            np.testing.assert_array_equal(x, y)
        else:
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), rel


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("synth") / "data")
    cli.main(["synth", "--out", d, "--users", "60", "--items", "40"])
    return d


def _jax_csv_header(sub, data_dir, ckpt_dir, metrics, monkeypatch):
    """The header of the results CSV the JAX CLI writes for ``sub``, its
    training and scoring stubbed to return ``metrics`` (only the row's
    composition and path are the JAX CLI's)."""
    with monkeypatch.context() as m:
        if sub == "tiger":
            m.setattr(jtiger, "train", lambda cfg: jtiger.TIGERArtifacts(None, None))
            m.setattr(jtiger, "_evaluate_device_resident", lambda *a, **k: dict(metrics))
            m.setattr(jtiger, "beam_evaluate", lambda *a, **k: dict(metrics))
            csv_name = "RQVAE-T5-results.csv"
        else:
            m.setattr(jsasrec, "train", lambda cfg: jsasrec.SASRecArtifacts(None, 40, None))
            m.setattr(jsasrec, "rank_evaluate", lambda *a, **k: dict(metrics))
            csv_name = "SASREC-results.csv"
        jcli.main([sub, "--data-dir", data_dir, "--ckpt-dir", ckpt_dir, "--epochs", "1"])
    with open(os.path.join(ckpt_dir, csv_name)) as f:
        return next(csv.reader(f)), csv_name


@pytest.mark.parametrize("sub,flags", [
    ("sasrec", []), ("rqvae", []), ("tiger", ["--constrained", "trie", "--len-buckets", "1"]),
    ("tiger-prefix", ["--constrained", "none"]), ("dense-t5", []),
])
def test_training_subcommand_builds_the_jax_config(sub, flags, tmp_path, monkeypatch):
    """The config each subcommand hands its pipeline's ``main`` equals the
    JAX CLI's, field for field, and the port's also gets ``--device``."""
    module = sub.replace("-", "_") + "_pipeline"
    jmod = importlib.import_module(f"genrec_tpu.pipelines.{module}")
    pmod = importlib.import_module(f"genrec_tpu_torch.pipelines.{module}")
    seen = {}
    monkeypatch.setattr(jmod, "main", lambda cfg: seen.setdefault("jax", cfg) and np.zeros((1, 4)))
    monkeypatch.setattr(pmod, "main", lambda cfg, device: seen.setdefault("port", (cfg, device))
                        and np.zeros((1, 4)))
    argv = [sub, "--data-dir", str(tmp_path / "d"), "--ckpt-dir", str(tmp_path / "c"),
            "--epochs", "3"] + flags
    jcli.main(argv)
    cli.main(argv + ["--device", "cpu"])
    cfg, device = seen["port"]
    assert device == torch.device("cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(seen["jax"])
    assert cfg.trainer.epochs == 3 and cfg.trainer.ckpt_dir == str(tmp_path / "c")


@contextlib.contextmanager
def _two_threads():
    """Two intra-op threads for a CPU training run: the suite runs in several
    processes at once, where every process's full thread pool would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiger_run(synth_dir, tmp_path_factory):
    """``tiger --epochs 1 --device cpu --constrained trie``: its checkpoint
    directory and what it printed."""
    ckpt = str(tmp_path_factory.mktemp("tiger") / "ckpt")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), _two_threads():
        cli.main(["tiger", "--data-dir", synth_dir, "--ckpt-dir", ckpt, "--epochs", "1",
                  "--device", "cpu", "--constrained", "trie"])
    return ckpt, buf.getvalue()


# tiger-prefix is held by its config above and tests/test_torch_tiger_prefix_pipeline.py's
# `main` from H5 files: its default config's one CPU epoch (a B=256 step over 156-token
# targets and a 20-beam evaluate) takes 12 s alone and over 110 s beside the suite's other
# processes
@pytest.mark.parametrize("sub", [s for s in PIPELINES if s != "tiger-prefix"])
def test_training_subcommand_on_the_cpu(sub, synth_dir, tmp_path, monkeypatch, capsys, request):
    data_dir = synth_dir
    if sub == "rqvae":  # rqvae rewrites the code file the other subcommands read
        data_dir = str(tmp_path / "data")
        shutil.copytree(synth_dir, data_dir)
    if sub == "tiger":
        ckpt, out = request.getfixturevalue("tiger_run")
    else:
        ckpt = str(tmp_path / "ckpt")
        with _two_threads():
            cli.main([sub, "--data-dir", data_dir, "--ckpt-dir", ckpt, "--epochs", "1",
                      "--device", "cpu"])
        out = capsys.readouterr().out
    assert os.path.exists(os.path.join(ckpt, "best.pt")), os.listdir(ckpt)
    if sub == "rqvae":
        codes = np.load(os.path.join(data_dir, "course", "course_rqvae_codes.npy"))
        assert codes.shape == (41, 4) and len({tuple(r) for r in codes[1:]}) == 40
        assert "codes shape: (41, 4)" in out
        return
    metrics = ast.literal_eval(out.strip().splitlines()[-1])  # the printed dict
    assert metrics and all(np.isfinite(v) for v in metrics.values())
    csvs = [f for f in os.listdir(ckpt) if f.endswith(".csv")]
    if sub not in ("sasrec", "tiger"):
        assert csvs == []  # as the JAX CLI: no results path for these
        return
    want, name = _jax_csv_header(sub, data_dir, str(tmp_path / "jax_ckpt"), metrics, monkeypatch)
    assert csvs == [name]
    with open(os.path.join(ckpt, name)) as f:
        assert next(csv.reader(f)) == want


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v1/recommend/model",
                                 data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_serve_answers_from_the_checkpoint_tiger_wrote(synth_dir, tiger_run, tmp_path):
    ckpt, db = tiger_run[0], str(tmp_path / "app.db")
    cli.main(["init-db", "--db", db])
    args = cli.build_parser().parse_args(
        ["serve", "--data-dir", synth_dir, "--db", db, "--tiger-ckpt", ckpt,
         "--sasrec-ckpt", str(tmp_path / "unused"), "--port", "0", "--device", "cpu"])
    ctx = cli.make_context(args)
    assert ctx.recommender is None and ctx.catalog is None  # no recommendation_data.h5
    srv = BackendHTTPServer(ctx, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, args=(0.05,), daemon=True).start()
    try:
        fn = tiger_model_fn(ckpt, os.path.join(synth_dir, "course", "course_rqvae_codes.npy"),
                            device="cpu")
        port = srv.server_address[1]
        for hist in ([], [1, 2, 3], list(range(5, 25))):
            status, body = _post(port, {"history": hist, "top_k": 10})
            assert status == 200 and [r["item_id"] for r in body["data"]] == fn(hist, 10)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=10) as r:
            assert json.loads(r.read())["status"] == "healthy"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/v1/courses", timeout=10) as r:
            assert json.loads(r.read())["data"] == []  # the DB's empty class_index
        assert ctx.db.count("students") == 2  # the DB init-db seeded
    finally:
        srv.shutdown()
        srv.server_close()
        ctx.db.close()
