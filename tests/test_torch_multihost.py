"""The port's data-parallel training across two gloo ranks, after
`tests/test_multihost.py`.

Two processes run this file as a script, once per module, joined through a
``file://`` rendezvous; each runs every rank-side check and saves what it
computed. At dropout 0:

- one data-parallel Trainer step on a padded batch (the ranks hold 8 and 3
  valid rows) equals the single-device step on the whole batch: loss and
  every gradient;
- the TIGER pipeline with replicated datasets gives the one-rank run's
  per-epoch losses: both see the same global batches;
- in sharded-dataset mode (the default across ranks) each rank uploads only
  its rows and the batches come from the reference's
  ``_index_matrix_sharded``, whose batches depend on the data-axis size:
  the two ranks' losses equal the JAX Trainer's on a 2-device data axis in
  that mode, from the same initial weights;
- a checkpoint written by rank 0 and resumed on both ranks lands where an
  uninterrupted run lands;
- the row-sharded SASRecLarge trained on 1 × 2 and 2 × 1 meshes equals the
  one-rank model;
- the other four pipelines train under the same wiring, their replicas in
  step; TIGER-prefix streams, each rank fed its half of every batch, and
  gives the one-rank run's losses.

The rank processes import no JAX; the JAX side runs in the pytest process.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_parallel import spawn_ranks  # noqa: E402

WORLD = 2
ARCH = dict(vocab_size=64, num_layers=1, num_decoder_layers=1, d_model=32, d_ff=64,
            num_heads=2, d_kv=16, dropout_rate=0.0)
MAX_LEN = 6


def _tiger_arrays():
    from genrec_tpu_torch.data import datasets, synthetic, tiger_tokens

    corpus = synthetic.make_interactions(num_users=90, num_items=40, min_len=4, max_len=10,
                                         num_topics=4, seed=3)
    codes = synthetic.make_codes(40, seed=1)
    tr, te = tiger_tokens.build_tiger_splits(corpus.item_id_lists, corpus.user_ids, codes)
    return (datasets.build_tiger_arrays(tr, MAX_LEN, 4),
            datasets.build_tiger_arrays(te, MAX_LEN, 4, max_target_items=1))


def _tiger_cfg(ckpt_dir, **kw):
    from genrec_tpu_torch import configs

    base = dict(epochs=2, batch_size=32, eval_batch_size=32, lr=3e-3, ckpt_dir=str(ckpt_dir),
                early_stop_patience=10, seed=0)
    base.update(kw)
    return configs.TIGERConfig(arch=configs.T5ArchConfig(**ARCH), max_len=MAX_LEN,
                               trainer=configs.TrainerConfig(**base))


def _large_cfg(vocab):
    from genrec_tpu_torch import configs

    return configs.SASRecLargeConfig(
        max_len=8, num_blocks=1, num_heads=1, mlp_layer=16, dropout=0.0, num_neg_samples=4,
        embedding=configs.ShardedEmbeddingConfig(vocab_size=vocab, dim=8),
        trainer=configs.TrainerConfig(batch_size=16, lr=0.5))


# --------------------------------------------------------------------------
# rank side: run as ``python test_torch_multihost.py <rank> <world> <rdv> <out>``
# --------------------------------------------------------------------------

def _dp_step(out: pathlib.Path) -> dict:
    """One Trainer step of each rank's columns of a padded batch of 16 (11
    valid rows), and the single-device step on the whole batch."""
    from genrec_tpu_torch.models.tiger import TIGER
    from genrec_tpu_torch.parallel.auto import dp_shardings
    from genrec_tpu_torch.pipelines.tiger_pipeline import build_trainer, loss_fn
    from genrec_tpu_torch.train.trainer import Trainer

    tr, te = _tiger_arrays()
    cfg = _tiger_cfg(out / "step", batch_size=16, shard_dataset=False)
    trainer = build_trainer(cfg, tr, te, "cpu", dp_shardings(cfg.mesh))
    idx = torch.arange(16)
    idx[11:] = -1
    d = trainer.mesh.index("data")
    sl, vl = trainer.train_step(trainer.gather(trainer.train_data, idx[d * 8:(d + 1) * 8]), None)
    ref = TIGER(cfg, generator=torch.Generator().manual_seed(0)).train()
    loss, _ = loss_fn(ref, Trainer.gather(trainer.train_data, idx), None)
    loss.backward()
    return {"dp_sum_loss": sl.item(), "dp_valid": vl.item(),
            "dp_grads": {k: p.grad.numpy() for k, p in trainer.model.named_parameters()},
            "ref_loss": loss.item(),
            "ref_grads": {k: p.grad.numpy() for k, p in ref.named_parameters()}}


def _tiger_runs(out: pathlib.Path) -> dict:
    from genrec_tpu_torch.parallel.auto import dp_shardings
    from genrec_tpu_torch.pipelines import tiger_pipeline
    from genrec_tpu_torch.train.checkpoint import CheckpointStore

    tr, te = _tiger_arrays()
    res = {}
    art = tiger_pipeline.train(_tiger_cfg(out / "rep", shard_dataset=False), tr, te, "cpu")
    res["replicated"] = (art.result.train_losses, art.result.val_losses)

    cfg = _tiger_cfg(out / "sharded")
    trainer = tiger_pipeline.build_trainer(cfg, tr, te, "cpu", dp_shardings(cfg.mesh))
    trainer.model.load_state_dict(torch.load(out / "flax_init.pt"))
    res["sharded_rows"] = {k: len(v) for k, v in trainer.train_data.items()}
    r = trainer.fit()
    res["sharded"] = (r.train_losses, r.val_losses)

    tiger_pipeline.train(_tiger_cfg(out / "ckpt"), tr, te, "cpu")
    resumed = tiger_pipeline.train(_tiger_cfg(out / "ckpt", epochs=3, resume=True), tr, te, "cpu")
    full = tiger_pipeline.train(_tiger_cfg(out / "full", epochs=3), tr, te, "cpu")
    res["resumed"] = resumed.result.train_losses
    res["full"] = full.result.train_losses
    res["ckpt_keys"] = sorted(CheckpointStore(str(out / "ckpt")).restore_latest()["model"])
    res["best_keys"] = sorted(CheckpointStore(str(out / "ckpt")).restore_best())
    return res


def _large_runs() -> dict:
    """3 SGD steps of the row-sharded SASRecLarge on a 1 × 2 mesh (the table
    over 'model', psum and all_to_all) and a 2 × 1 mesh (rows over 'data'),
    each against the one-rank model on the whole batch."""
    from genrec_tpu_torch import configs
    from genrec_tpu_torch.models.sasrec_large import SASRecLarge, make_train_step
    from genrec_tpu_torch.parallel.mesh import make_mesh

    cfg = _large_cfg(2048)
    item_num = cfg.embedding.vocab_size - 1
    rng = np.random.default_rng(11)
    x = rng.integers(1, item_num + 1, size=(16, 8))
    x[:4, :3] = 0
    t = np.where(x == 0, 0, rng.integers(1, item_num + 1, size=(16, 8)))
    negs = [torch.tensor(rng.integers(1, item_num + 1, size=(16, 4))) for _ in range(3)]
    x, t = torch.tensor(x), torch.tensor(t)

    def run(mesh, impl, rows):
        model = SASRecLarge(item_num, cfg, mesh=mesh, lookup_impl=impl, alltoall_capacity=4.0,
                            generator=torch.Generator().manual_seed(0))
        # SGD: an update proportional to the gradient. Adam's first steps are
        # ±lr wherever a gradient is rounding noise (the key bias's is 0 in
        # exact arithmetic), which would compare noise, not the sharding
        opt = torch.optim.SGD(model.parameters(), lr=cfg.trainer.lr)
        step = make_train_step(model, opt, cfg, item_num)
        losses = [step(x[rows], t[rows], None, neg[rows]).item() for neg in negs]
        return losses, {k: v.numpy() for k, v in model.state_dict().items()}

    res = {"one": run(None, "psum", slice(None))}
    m12 = make_mesh(configs.MeshConfig(data_axis=1, model_axis=2))
    for impl in ("psum", "alltoall"):
        res[f"1x2_{impl}"] = run(m12, impl, slice(None))
    m21 = make_mesh(configs.MeshConfig(data_axis=2, model_axis=1))
    d = m21.index("data")
    res["2x1"] = run(m21, "psum", slice(d * 8, (d + 1) * 8))
    res["model_index"] = m12.index("model")
    return res


def _other_pipelines(out: pathlib.Path) -> dict:
    """SASRec, RQ-VAE, DenseT5 and TIGER-prefix, 2 epochs each at 2 ranks in
    the default (sharded-dataset) mode."""
    from genrec_tpu_torch import configs
    from genrec_tpu_torch.data import synthetic
    from genrec_tpu_torch.pipelines import dense_t5_pipeline, rqvae_pipeline, sasrec_pipeline

    def trainer(name, **kw):
        return configs.TrainerConfig(**dict(dict(epochs=2, batch_size=32, eval_batch_size=32,
                                                 lr=3e-3, ckpt_dir=str(out / name), seed=0,
                                                 early_stop_patience=10), **kw))

    corpus = synthetic.make_interactions(num_users=90, num_items=40, min_len=4, max_len=10,
                                         num_topics=4, seed=3)
    arts = {}
    arts["sasrec"] = sasrec_pipeline.train(configs.SASRecConfig(
        d=16, num_blocks=1, num_heads=1, mlp_layer=32, max_len=10, dropout=0.0,
        num_neg_samples=5, trainer=trainer("sasrec")), corpus, device="cpu")
    embs = synthetic.make_item_embs(num_items=80, dim=32, num_topics=8, seed=3)[1:]
    arts["rqvae"] = rqvae_pipeline.train(configs.RQVAEConfig(
        in_dim=32, num_emb_list=(8, 8, 8), e_dim=8, layers=(32, 16), dropout=0.0,
        sk_epsilons=(0.01, 0.01, 0.01), sk_iters=20, kmeans_iters=10,
        semantic_id_file=str(out / "codes.npy"),
        trainer=trainer("rqvae", optimizer="adamw", grad_clip_norm=1.0)), embs, device="cpu")
    arch = dict(d_model=32, num_layers=1, num_heads=2, d_kv=16, d_ff=64, dropout_rate=0.0)
    items = synthetic.make_item_embs(40, dim=32, num_topics=4, seed=7)
    users = synthetic.make_user_embs(corpus.num_users, dim=32, seed=2)
    arts["dense_t5"] = dense_t5_pipeline.train(configs.DenseT5Config(
        arch=configs.T5ArchConfig(**arch), input_emb_dim=32, target_emb_dim=32, max_seq_len=8,
        trainer=trainer("dense_t5")), corpus, items, users, device="cpu")
    arts["tiger_prefix"] = _tiger_prefix_run(out / "prefix", corpus)
    return {name: (a.result.train_losses, a.result.val_losses,
                   float(sum(v.double().sum() for v in a.result.final_params.values())))
            for name, a in arts.items()}


def _tiger_prefix_run(ckpt_dir: pathlib.Path, corpus):
    """TIGER-prefix's streamed ``train`` at dropout 0, 2 epochs at batch 32:
    under DDP each rank feeds its ``process_rows`` slice of every batch."""
    from genrec_tpu_torch import configs
    from genrec_tpu_torch.data import datasets, synthetic, tiger_tokens
    from genrec_tpu_torch.pipelines import tiger_prefix_pipeline

    codes = synthetic.make_codes(40, seed=1)
    tr, te = tiger_tokens.build_tiger_splits(corpus.item_id_lists, corpus.user_ids, codes)
    profs = [synthetic.make_prof_embs(corpus.num_users, 5, 16, seed=s) for s in (2, 3, 4)]
    trainer = configs.TrainerConfig(epochs=2, batch_size=32, eval_batch_size=32, lr=3e-3,
                                    ckpt_dir=str(ckpt_dir), seed=0, early_stop_patience=10)
    return tiger_prefix_pipeline.train(
        configs.TIGERPrefixConfig(arch=configs.T5ArchConfig(**ARCH), max_len=MAX_LEN,
                                  bert_dim=16, trainer=trainer),
        tiger_prefix_pipeline.attach_prof(datasets.build_tiger_arrays(tr, MAX_LEN, 4), profs),
        tiger_prefix_pipeline.attach_prof(
            datasets.build_tiger_arrays(te, MAX_LEN, 4, max_target_items=1), profs),
        device="cpu")


def _rank_main(rank: int, world: int, rdv: str, out: str) -> None:
    import torch.distributed as dist

    from genrec_tpu_torch.parallel.mesh import initialize_multihost

    torch.set_num_threads(1)
    initialize_multihost(f"file://{rdv}", world, rank, device="cpu")
    out = pathlib.Path(out)
    try:
        res = {"step": _dp_step(out), "tiger": _tiger_runs(out), "large": _large_runs(),
               "pipelines": _other_pipelines(out)}
        torch.save(res, out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# --------------------------------------------------------------------------
# pytest side
# --------------------------------------------------------------------------

def _flax_init(cfg):
    import jax
    import jax.numpy as jnp

    from genrec_tpu.configs import T5ArchConfig as JArch
    from genrec_tpu.configs import TIGERConfig as JTIGERConfig
    from genrec_tpu.models.tiger import TIGER as JTIGER

    jc = JTIGERConfig(arch=JArch(**ARCH), max_len=MAX_LEN)
    seq = cfg.max_len * cfg.code_dim
    params = JTIGER(jc).init(jax.random.PRNGKey(0), jnp.zeros((1, seq), jnp.int32),
                             jnp.ones((1, seq), jnp.int32), jnp.ones((1, cfg.code_dim), jnp.int32))
    return jc, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from genrec_tpu_torch.convert import tiger_params_from_flax

    out = tmp_path_factory.mktemp("multihost")
    cfg = _tiger_cfg(out)
    torch.save(tiger_params_from_flax(_flax_init(cfg)[1], cfg), out / "flax_init.pt")
    return spawn_ranks(__file__, WORLD, out)


def test_dp_step_equals_single_device_step(ranks):
    """The ranks' valid token counts differ (8 and 3 rows): the loss is
    scaled so that the mean over the 'data' group is the whole batch's
    gradient, as JAX's sum / valid over the global batch."""
    a, b = (r["step"] for r in ranks)
    assert a["dp_valid"] != b["dp_valid"]
    loss = (a["dp_sum_loss"] + b["dp_sum_loss"]) / (a["dp_valid"] + b["dp_valid"])
    np.testing.assert_allclose(loss, a["ref_loss"], rtol=1e-5)
    for k, g in a["ref_grads"].items():
        np.testing.assert_array_equal(a["dp_grads"][k], b["dp_grads"][k])
        np.testing.assert_allclose(a["dp_grads"][k], g, rtol=1e-5, atol=1e-8, err_msg=k)


def test_tiger_replicated_two_ranks_equal_one_rank(ranks, tmp_path):
    from genrec_tpu_torch.pipelines import tiger_pipeline

    tr, te = _tiger_arrays()
    one = tiger_pipeline.train(_tiger_cfg(tmp_path, shard_dataset=False), tr, te, "cpu").result
    for r in ranks:
        np.testing.assert_allclose(r["tiger"]["replicated"][0], one.train_losses, rtol=1e-5)
        np.testing.assert_allclose(r["tiger"]["replicated"][1], one.val_losses, rtol=1e-5)
    assert one.train_losses[-1] < one.train_losses[0]


@pytest.mark.parametrize("n_real,d_axis,bsz,seed", [(90, 2, 32, 1), (61, 2, 16, 5),
                                                     (64, 4, 32, 0), (7, 1, 8, 3)])
def test_index_matrix_sharded_equals_the_reference(n_real, d_axis, bsz, seed):
    from genrec_tpu.train.trainer import Trainer as JTrainer
    from genrec_tpu_torch.train.trainer import Trainer

    n_loc = -(-n_real // d_axis)
    for shuffle in (False, True):
        np.testing.assert_array_equal(
            Trainer._index_matrix_sharded(n_real, n_loc, d_axis, bsz, shuffle=shuffle, seed=seed),
            JTrainer._index_matrix_sharded(n_real, n_loc, d_axis, bsz, shuffle=shuffle,
                                           seed=seed))


def test_tiger_sharded_two_ranks_equal_jax_on_two_devices(ranks, tmp_path):
    """Each rank holds its half of the train rows; the per-epoch losses
    equal the JAX Trainer's in sharded-dataset mode on a 2-device data
    axis from the same Flax weights, within the port's Trainer tolerance
    against JAX (tests/test_torch_trainer.py)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from genrec_tpu.configs import MeshConfig as JMesh
    from genrec_tpu.configs import TrainerConfig as JTrainerConfig
    from genrec_tpu.models.tiger import TIGER as JTIGER
    from genrec_tpu.parallel.mesh import make_mesh as jmake_mesh
    from genrec_tpu.pipelines.tiger_pipeline import _loss_fn
    from genrec_tpu.train.trainer import Trainer as JTrainer

    tr, te = _tiger_arrays()
    cfg = _tiger_cfg(tmp_path)
    jc, params = _flax_init(cfg)
    mesh = jmake_mesh(JMesh(data_axis=2, model_axis=1), devices=jax.devices()[:2])
    jcfg = JTrainerConfig(**dict(dataclasses.asdict(cfg.trainer), ckpt_dir=str(tmp_path / "j"),
                                 shard_dataset=True))
    jloss, jval = _loss_fn(JTIGER(jc))
    want = JTrainer(jcfg, init_params=params, loss_fn=jloss, eval_loss_fn=jval,
                    steps_per_epoch=-(-len(tr.input_ids) // jcfg.batch_size),
                    logger_name="tiger_jax_dp", batch_sharding=NamedSharding(mesh, P("data")),
                    replicate_sharding=NamedSharding(mesh, P()), train_data=tr.arrays,
                    val_data=te.arrays).fit()
    n = len(tr.input_ids)
    for r in ranks:
        assert set(r["tiger"]["sharded_rows"].values()) == {-(-n // 2)}
        np.testing.assert_allclose(r["tiger"]["sharded"][0], want.train_losses, atol=1e-4)
        np.testing.assert_allclose(r["tiger"]["sharded"][1], want.val_losses, atol=1e-4)
    assert ranks[0]["tiger"]["sharded"] == ranks[1]["tiger"]["sharded"]


def test_checkpoint_by_rank_zero_resumes_on_both_ranks(ranks):
    for r in ranks:
        t = r["tiger"]
        assert len(t["resumed"]) == 1
        np.testing.assert_allclose(t["resumed"][-1], t["full"][-1], rtol=1e-6)
        assert t["ckpt_keys"] == t["best_keys"]
        assert not any(k.startswith("module.") for k in t["ckpt_keys"])


@pytest.mark.parametrize("run", ["1x2_psum", "1x2_alltoall", "2x1"])
def test_sasrec_large_two_ranks_equal_one_rank(ranks, run):
    """3 SGD steps: the per-step losses and the parameters after them
    (each rank's block of the table) equal the one-rank model's."""
    for r in ranks:
        losses, state = r["large"][run]
        one_losses, one = r["large"]["one"]
        np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
        assert losses[-1] < losses[0]
        m = r["large"]["model_index"] if run.startswith("1x2") else 0
        for k, v in state.items():
            want = one[k]
            if k == "item_table" and run.startswith("1x2"):
                want = want[m * 1024:(m + 1) * 1024]
            np.testing.assert_allclose(v, want, rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["sasrec", "rqvae", "dense_t5", "tiger_prefix"])
def test_other_pipelines_train_data_parallel(ranks, name):
    """Finite losses, the same on both ranks, and replicas in step."""
    a, b = (r["pipelines"][name] for r in ranks)
    assert np.isfinite(a[0] + a[1]).all() and len(a[0]) == 2
    assert a == b


def test_tiger_prefix_two_ranks_stream_as_one_rank(ranks, tmp_path):
    """Each rank streams its half of every batch (dropout 0): the two
    ranks' per-epoch losses equal a one-rank run's."""
    from genrec_tpu_torch.data import synthetic

    corpus = synthetic.make_interactions(num_users=90, num_items=40, min_len=4, max_len=10,
                                         num_topics=4, seed=3)
    one = _tiger_prefix_run(tmp_path, corpus).result
    train, val, _ = ranks[0]["pipelines"]["tiger_prefix"]
    np.testing.assert_allclose(train, one.train_losses, rtol=1e-5)
    np.testing.assert_allclose(val, one.val_losses, rtol=1e-5)
