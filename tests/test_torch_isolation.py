"""The port stands alone: no file of ``genrec_tpu_torch`` and not
``chip_smoke.py`` imports JAX, its libraries or the JAX package; the package
imports on a machine with no ``nvcc``, no ``triton`` and no ``g++`` on the
path, without importing pydantic (``backend/schemas.py`` defines its models
when first asked for); its entry points run
on the card unless the caller asks for the CPU, and raise without a card.
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from genrec_tpu_torch.configs import SASRecConfig, TIGERConfig
from genrec_tpu_torch.data.contracts import InteractionData
from genrec_tpu_torch.data.datasets import TigerArrays
from genrec_tpu_torch.models.sasrec import SASRec
from genrec_tpu_torch.models.tiger import TIGER
from genrec_tpu_torch.pipelines import sasrec_pipeline, tiger_pipeline
from genrec_tpu_torch.train.checkpoint import save_best
from genrec_tpu_torch.serving import model_fn
from genrec_tpu_torch.train.trainer import Trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "genrec_tpu"}


def _port_files():
    files = sorted((ROOT / "genrec_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_file_imports_jax_or_the_jax_package():
    offenders = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & BANNED)
                 for p in _port_files()}
    assert not {k: v for k, v in offenders.items() if v}


def _clean_env():
    env = dict(os.environ)
    env.update(PATH=os.path.dirname(sys.executable), CUDA_HOME="/nonexistent",
               CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    env.pop("CUDA_PATH", None)
    return env


def test_package_imports_without_nvcc_triton_or_jax():
    code = (
        "import importlib, pkgutil, sys, genrec_tpu_torch\n"
        "for m in pkgutil.walk_packages(genrec_tpu_torch.__path__, 'genrec_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(BANNED)!r})\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules and 'pydantic' not in sys.modules\n"
        "print('imported', len([m for m in sys.modules if m.startswith('genrec_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_clean_env(), cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15


def test_chip_smoke_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=_clean_env(),
                         cwd=str(ROOT), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_point_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        model_fn.tiger_model_fn(str(tmp_path), str(tmp_path / "codes.npy"))
    with pytest.raises(RuntimeError, match="CUDA"):
        model_fn.resolve_device("cuda:0")
    assert model_fn.resolve_device("cpu") == torch.device("cpu")


def test_training_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """``Trainer`` and ``tiger_pipeline.train`` run on the card unless given
    ``device="cpu"``, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TIGERConfig()
    cfg = dataclasses.replace(cfg, trainer=dataclasses.replace(
        cfg.trainer, ckpt_dir=str(tmp_path / "ckpt"), epochs=1))
    z = np.zeros((2, 80), np.int32)
    arrays = TigerArrays(z, z + 1, np.ones((2, 4), np.int32), np.arange(2, dtype=np.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg.trainer, model=TIGER(cfg), loss_fn=tiger_pipeline.loss_fn,
                train_data=arrays.arrays)
    with pytest.raises(RuntimeError, match="CUDA"):
        tiger_pipeline.train(cfg, arrays, arrays)
    with pytest.raises(RuntimeError, match="CUDA"):
        tiger_pipeline.evaluate(cfg, tiger_pipeline.TIGERArtifacts({}, None), arrays)
    trainer = Trainer(cfg.trainer, model=TIGER(cfg), loss_fn=tiger_pipeline.loss_fn,
                      train_data=arrays.arrays, device="cpu")
    assert next(trainer.model.parameters()).device == torch.device("cpu")


def test_sasrec_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """``sasrec_pipeline.train`` / ``evaluate`` and ``sasrec_model_fn`` run on
    the card unless given ``device="cpu"``, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SASRecConfig(d=8, num_blocks=1, max_len=6)
    cfg = dataclasses.replace(cfg, trainer=dataclasses.replace(
        cfg.trainer, ckpt_dir=str(tmp_path / "ckpt"), epochs=1))
    data = InteractionData(np.arange(1, 4, dtype=np.int32), ["a", "b", "c"],
                           [np.array([1, 2, 3, 4], np.int32)] * 3)
    ckpt = str(tmp_path / "served")
    save_best(SASRec(4, cfg).state_dict(), ckpt)
    with pytest.raises(RuntimeError, match="CUDA"):
        sasrec_pipeline.train(cfg, data)
    with pytest.raises(RuntimeError, match="CUDA"):
        sasrec_pipeline.evaluate(cfg, sasrec_pipeline.SASRecArtifacts({}, 4, None), data)
    with pytest.raises(RuntimeError, match="CUDA"):
        model_fn.sasrec_model_fn(ckpt, data, cfg)
    fn = model_fn.sasrec_model_fn(ckpt, data, cfg, device="cpu")
    assert len(fn([1], 2)) == 2
    art = sasrec_pipeline.train(cfg, data, device="cpu")
    assert next(iter(art.params.values())).device == torch.device("cpu")


def test_semantic_id_chain_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """``rqvae_pipeline.train`` / ``infer`` and ``tiger_prefix_pipeline.train``
    / ``evaluate`` run on the card unless given ``device="cpu"``, and raise
    without one."""
    from genrec_tpu_torch.configs import RQVAEConfig, TIGERPrefixConfig, TrainerConfig
    from genrec_tpu_torch.models.rqvae import RQVAE
    from genrec_tpu_torch.pipelines import rqvae_pipeline, tiger_prefix_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trainer = TrainerConfig(epochs=1, batch_size=4, ckpt_dir=str(tmp_path / "ckpt"))
    cfg = RQVAEConfig(in_dim=8, layers=(8,), e_dim=4, num_emb_list=(4, 4), dropout=0.0,
                      sk_epsilons=(0.0, 0.01), kmeans_iters=2, trainer=trainer,
                      semantic_id_file=str(tmp_path / "codes.npy"))
    embs = np.random.default_rng(0).normal(size=(6, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        rqvae_pipeline.train(cfg, embs)
    sd = RQVAE(cfg).state_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        rqvae_pipeline.infer(cfg, rqvae_pipeline.RQVAEArtifacts(sd, sd, None, 0.0), embs)
    art = rqvae_pipeline.train(cfg, embs, device="cpu")
    assert next(iter(art.params.values())).device == torch.device("cpu")
    assert rqvae_pipeline.infer(cfg, art, embs, device="cpu").shape == (6, 3)

    pcfg = TIGERPrefixConfig(trainer=trainer)
    z = np.zeros((2, 80), np.int32)
    prof = (np.arange(1, 3, dtype=np.int32), np.zeros((2, 5, 768), np.float32))
    data = tiger_prefix_pipeline.attach_prof(
        TigerArrays(z, z + 1, np.ones((2, 4), np.int32), np.arange(1, 3, dtype=np.int32)),
        [prof] * 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        tiger_prefix_pipeline.train(pcfg, data, data)
    with pytest.raises(RuntimeError, match="CUDA"):
        tiger_prefix_pipeline.evaluate(pcfg, tiger_prefix_pipeline.TIGERPrefixArtifacts({}, None),
                                       data)


def test_dense_t5_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """``dense_t5_pipeline.train`` / ``evaluate`` and ``dense_t5_model_fn``
    run on the card unless given ``device="cpu"``, and raise without one."""
    from genrec_tpu_torch.configs import DenseT5Config, T5ArchConfig, TrainerConfig
    from genrec_tpu_torch.data.contracts import write_item_embs
    from genrec_tpu_torch.models.dense_t5 import DenseT5
    from genrec_tpu_torch.pipelines import dense_t5_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DenseT5Config(arch=T5ArchConfig(d_model=8, num_layers=1, num_heads=1, d_kv=8, d_ff=8),
                        input_emb_dim=4, target_emb_dim=4, max_seq_len=3,
                        trainer=TrainerConfig(epochs=1, batch_size=2,
                                              ckpt_dir=str(tmp_path / "ckpt")))
    data = InteractionData(np.arange(1, 4, dtype=np.int32), ["a", "b", "c"],
                           [np.array([1, 2, 3, 4], np.int32)] * 3)
    items = np.ones((5, 4), np.float32)
    users = np.ones((3, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        dense_t5_pipeline.train(cfg, data, items, users)
    art = dense_t5_pipeline.train(cfg, data, items, users, device="cpu")
    assert next(iter(art.params.values())).device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        dense_t5_pipeline.evaluate(cfg, art, data, items, users)
    ckpt, h5 = str(tmp_path / "served"), str(tmp_path / "items.h5")
    save_best(DenseT5(cfg).state_dict(), ckpt)
    write_item_embs(h5, items)
    with pytest.raises(RuntimeError, match="CUDA"):
        model_fn.dense_t5_model_fn(ckpt, h5, cfg)
    assert len(model_fn.dense_t5_model_fn(ckpt, h5, cfg, device="cpu")([1], 2)) == 2


def test_cli_defaults_to_the_card(monkeypatch, tmp_path):
    """``tiger`` and ``serve --tiger-ckpt`` without ``--device`` raise on a
    host without a card, before they train or listen."""
    from genrec_tpu_torch import cli
    from genrec_tpu_torch.backend import server
    from genrec_tpu_torch.serving import model_fn as served

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(tiger_pipeline, "main", lambda *a, **k: started.append("train"))
    monkeypatch.setattr(tiger_pipeline, "train", lambda *a, **k: started.append("train"))
    monkeypatch.setattr(server, "serve", lambda *a, **k: started.append("listen"))
    monkeypatch.setattr(server.BackendHTTPServer, "__init__",
                        lambda *a, **k: started.append("listen"))
    monkeypatch.setattr(served, "tiger_model_fn", lambda *a, **k: started.append("load"))
    codes = tmp_path / "data" / "course" / "course_rqvae_codes.npy"
    codes.parent.mkdir(parents=True)
    np.save(codes, np.zeros((3, 4), np.int64))
    for argv in (["tiger", "--data-dir", str(tmp_path / "data"), "--epochs", "1",
                  "--ckpt-dir", str(tmp_path / "ckpt")],
                 ["serve", "--data-dir", str(tmp_path / "data"), "--port", "0",
                  "--db", str(tmp_path / "app.db"), "--tiger-ckpt", str(tmp_path / "ckpt")]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    assert started == [] and not (tmp_path / "ckpt").exists()
    assert not (tmp_path / "app.db").exists()
