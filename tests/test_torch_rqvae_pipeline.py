"""The port's RQ-VAE pipeline (genrec_tpu_torch/pipelines/rqvae_pipeline.py)
against the JAX package's, on the CPU at a tiny size.

- ``infer`` from the same parameters (Flax → ``rqvae_params_from_flax``)
  writes JAX's code table exactly: the greedy codes, the grouped Sinkhorn
  repair of the last level, the 4th digit, codes.npy and its mapping JSON.
- ``train`` from the same initial weights (the reference pipeline's own
  init and k-means, converted) at dropout 0 gives per-epoch losses within
  1e-4 of the JAX trainer's (f32 forward, backward and AdamW, each summed
  in another order) and the same collision rate.
- End to end, mirroring tests/test_pipelines.py: the loss falls, the codes
  are unique after the 4th digit, the files and ``best_collision.pt`` are
  written, and ``main`` reads the item-embedding file.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu import configs as jconfigs
from genrec_tpu.models import rqvae as jax_rqvae
from genrec_tpu.pipelines import rqvae_pipeline as jax_pipeline
from genrec_tpu_torch import configs
from genrec_tpu_torch.convert import rqvae_params_from_flax
from genrec_tpu_torch.data import contracts, synthetic
from genrec_tpu_torch.models.rqvae import RQVAE
from genrec_tpu_torch.pipelines import rqvae_pipeline

ARCH = dict(in_dim=32, num_emb_list=(8, 8, 8), e_dim=8, layers=(32, 16), dropout=0.0,
            sk_epsilons=(0.01, 0.01, 0.01), sk_iters=20, kmeans_init=True, kmeans_iters=10)
TRAINER = dict(epochs=3, lr=1e-3, optimizer="adamw", weight_decay=1e-4,
               lr_scheduler="linear", warmup_epochs=1, grad_clip_norm=1.0, batch_size=32,
               seed=2024)


@pytest.fixture(scope="module")
def embs():
    return synthetic.make_item_embs(num_items=80, dim=32, num_topics=8, seed=3)[1:]


def _cfgs(path, **trainer):
    tr = dict(TRAINER, ckpt_dir=str(path / "ckpt"), **trainer)
    codes = str(path / "codes.npy")
    return (jconfigs.RQVAEConfig(**ARCH, semantic_id_file=codes,
                                 trainer=jconfigs.TrainerConfig(**tr)),
            configs.RQVAEConfig(**ARCH, semantic_id_file=codes,
                                trainer=configs.TrainerConfig(**tr)))


def _jax_initial_params(jcfg, embs):
    """The JAX pipeline's own initial parameters: init and k-means from
    PRNGKey(seed) (rqvae_pipeline.py:105-111)."""
    model = jax_rqvae.RQVAE(jcfg)
    key = jax.random.PRNGKey(jcfg.trainer.seed)
    params = model.init(key, jnp.zeros((1, jcfg.in_dim), jnp.float32))
    params = jax_rqvae.kmeans_init_codebooks(params, model, jnp.asarray(embs[:8192]), key)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("same_text", [False, True])
def test_infer_writes_jaxs_code_table_exactly(tmp_path, embs, same_text):
    """``same_text``: three items share one embedding (items with the same
    text), which no repair can split: the 4th digit numbers them."""
    if same_text:
        embs = embs.copy()
        embs[[11, 40, 63]] = embs[7]
    jcfg, tcfg = _cfgs(tmp_path / "jax")
    tcfg = dataclasses.replace(tcfg, semantic_id_file=str(tmp_path / "port" / "codes.npy"))
    params = _jax_initial_params(jcfg, embs)
    want = jax_pipeline.infer(jcfg, jax_pipeline.RQVAEArtifacts(params, params, None, 0.0),
                              item_embs=embs)
    sd = rqvae_params_from_flax(params, tcfg)
    got = rqvae_pipeline.infer(tcfg, rqvae_pipeline.RQVAEArtifacts(sd, sd, None, 0.0),
                               item_embs=embs, device="cpu")
    np.testing.assert_array_equal(got, want)
    # the table went through repair and the 4th digit: greedy codes collide
    model = RQVAE(tcfg)
    model.load_state_dict(sd)
    greedy = rqvae_pipeline._batched_indices(model, embs)
    assert len(np.unique(greedy, axis=0)) < len(greedy)
    assert (greedy[:, -1] != got[:, 2]).any() and (got[:, :2] == greedy[:, :2]).all()
    assert len(np.unique(got, axis=0)) == len(got)
    if same_text:
        assert sorted(got[[7, 11, 40, 63], 3]) == [0, 1, 2, 3]
    np.testing.assert_array_equal(np.load(tcfg.semantic_id_file), np.load(jcfg.semantic_id_file))
    mapping = [p.replace(".npy", "_mapping.json") for p in (tcfg.semantic_id_file,
                                                           jcfg.semantic_id_file)]
    assert json.load(open(mapping[0])) == json.load(open(mapping[1]))


def test_epoch_losses_match_the_jax_pipeline(tmp_path, embs, monkeypatch):
    jcfg, tcfg = _cfgs(tmp_path / "jax")
    tcfg = dataclasses.replace(tcfg, trainer=dataclasses.replace(
        tcfg.trainer, ckpt_dir=str(tmp_path / "port")))
    want = jax_pipeline.train(jcfg, item_embs=embs)
    params = _jax_initial_params(jcfg, embs)

    def build(cfg, e, device):
        model = RQVAE(cfg)
        model.load_state_dict(rqvae_params_from_flax(params, cfg))
        return model.to(device)

    monkeypatch.setattr(rqvae_pipeline, "build_model", build)
    got = rqvae_pipeline.train(tcfg, item_embs=embs, device="cpu")
    assert got.result.epochs_run == want.result.epochs_run == 3
    np.testing.assert_allclose(got.result.train_losses, want.result.train_losses, atol=1e-4)
    assert got.final_collision_rate == want.final_collision_rate


def test_rqvae_end_to_end(tmp_path, embs):
    """Mirrors tests/test_pipelines.py::test_rqvae_end_to_end, and ``main``."""
    _, cfg = _cfgs(tmp_path, epochs=8)
    art = rqvae_pipeline.train(cfg, item_embs=embs, device="cpu")
    assert min(art.result.train_losses) < art.result.train_losses[0]
    assert (tmp_path / "ckpt" / "best_collision.pt").exists()
    assert np.isfinite(art.final_collision_rate)
    codes = rqvae_pipeline.infer(cfg, art, item_embs=embs, device="cpu")
    assert codes.shape == (80, 4)
    assert len(np.unique(codes, axis=0)) == len(codes)
    assert (tmp_path / "codes.npy").exists()
    assert (tmp_path / "codes_mapping.json").exists()

    table = np.concatenate([np.zeros((1, 32), np.float32), embs])
    path = str(tmp_path / "data" / "course_item_embs.h5")
    contracts.write_item_embs(path, table)
    cfg = dataclasses.replace(cfg, data_path=path,
                              semantic_id_file=str(tmp_path / "main" / "codes.npy"),
                              trainer=dataclasses.replace(cfg.trainer, epochs=2))
    codes = rqvae_pipeline.main(cfg, device="cpu")
    assert codes.shape == (81, 4) and len(np.unique(codes, axis=0)) == 81
    np.testing.assert_array_equal(np.load(cfg.semantic_id_file), codes)


def test_collision_tracking_keeps_the_best_collision_params(tmp_path, embs):
    """The collision rate is read every ``epochs // 10`` epochs and at the
    last; ``params`` are the best-collision parameters of those reads."""
    _, cfg = _cfgs(tmp_path, epochs=4)
    art = rqvae_pipeline.train(cfg, item_embs=embs, device="cpu")
    saved = torch.load(tmp_path / "ckpt" / "best_collision.pt", weights_only=True)
    for k, v in art.params.items():
        assert torch.equal(saved[k], v), k
    model = RQVAE(cfg)
    model.load_state_dict(art.params)
    rate = jax_rqvae.collision_rate(rqvae_pipeline._batched_indices(model, embs))
    assert rate == art.final_collision_rate
