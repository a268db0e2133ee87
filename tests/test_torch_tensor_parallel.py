"""Dense tensor parallelism of the port over a 2 × 2 mesh of four gloo ranks:
T5's heads and d_ff and the parity SASRec's item table split over 'model',
against the one-device modules, the port's model-axis-1 runs and the JAX
package (whose own test, `tests/test_parallel.py:340`, shows that its TP
run equals its DP run within rtol 2e-4).

The four ranks are processes that run this file as a script, once per
module, as `test_torch_parallel.py`'s do (``spawn_ranks``). Rank r sits at
(r // 2, r % 2): ranks 0 and 1 hold one data row, each with half the heads
and half of d_ff. The rank processes import no JAX; JAX runs here, in the
pytest process, on the Flax weights the ranks load.
"""

from __future__ import annotations

import dataclasses
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_parallel import spawn_ranks  # noqa: E402

WORLD = 4
ARCH = dict(vocab_size=64, num_layers=1, num_decoder_layers=1, d_model=32, d_ff=64,
            num_heads=2, d_kv=16, dropout_rate=0.0)
MAX_LEN = 6
L = 12                  # the module checks' sequence length
SAS = dict(d=16, num_blocks=1, num_heads=1, mlp_layer=32, max_len=10, dropout=0.0,
           num_neg_samples=5)
SAS_ITEMS = 699         # a 700-row table: divides the model axis
# the clip under SGD, whose step the norm scales (Adam's would hide it)
CLIP = dict(grad_clip_norm=0.5, optimizer="sgd", lr=1.0)


def _tiger_arrays():
    from genrec_tpu_torch.data import datasets, synthetic, tiger_tokens

    corpus = synthetic.make_interactions(num_users=90, num_items=40, min_len=4, max_len=10,
                                         num_topics=4, seed=3)
    codes = synthetic.make_codes(40, seed=1)
    tr, te = tiger_tokens.build_tiger_splits(corpus.item_id_lists, corpus.user_ids, codes)
    return (datasets.build_tiger_arrays(tr, MAX_LEN, 4),
            datasets.build_tiger_arrays(te, MAX_LEN, 4, max_target_items=1))


def _trainer_kw(ckpt_dir, **kw):
    return dict(dict(epochs=2, batch_size=32, eval_batch_size=32, lr=3e-3,
                     ckpt_dir=str(ckpt_dir), early_stop_patience=10, seed=0,
                     shard_dataset=False), **kw)


def _tiger_cfg(ckpt_dir, mesh=(2, 2), arch=None, **kw):
    from genrec_tpu_torch import configs

    return configs.TIGERConfig(
        arch=configs.T5ArchConfig(**(arch or ARCH)), max_len=MAX_LEN,
        mesh=configs.MeshConfig(data_axis=mesh[0], model_axis=mesh[1]),
        trainer=configs.TrainerConfig(**_trainer_kw(ckpt_dir, **kw)))


def _batch(seed=0, bsz=6):
    """A TIGER batch: left-padded inputs, labels with an ignored tail."""
    r = np.random.default_rng(seed)
    seq = MAX_LEN * 4
    ii = r.integers(1, 33, size=(bsz, seq)).astype(np.int64)
    am = (np.arange(seq)[None, :] >= r.integers(0, seq // 2, size=bsz)[:, None]).astype(np.int64)
    lab = r.integers(1, 33, size=(bsz, 8)).astype(np.int64)
    lab[-1, 4:] = -100
    return ii * am, am, lab


def _sas_seqs(b=4, seed=0):
    """Left-padded histories and their shifted targets."""
    r = np.random.default_rng(seed)
    x = r.integers(1, SAS_ITEMS + 1, size=(b, SAS["max_len"] + 1)).astype(np.int64)
    x[0, :3] = 0
    return x[:, :-1], np.where(x[:, :-1] == 0, 0, x[:, 1:])


# --------------------------------------------------------------------------
# rank side: run as ``python test_torch_tensor_parallel.py <rank> <world> <rdv> <out>``
# --------------------------------------------------------------------------

def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _grads(model, mesh, specs):
    from genrec_tpu_torch.parallel.tensor import gather_state

    return gather_state({k: p.grad for k, p in model.named_parameters()}, mesh, specs)


def _module_checks(mesh) -> dict:
    """T5Attention (encoder self-attention with the bidirectional bias and a
    key mask, causal decoder self-attention, cross-attention) and
    T5FeedForward at dropout 0.1 from one seeded generator, cut over
    'model', against the same modules whole: outputs, the inputs' and every
    parameter's gathered gradient (rel_embedding's included)."""
    from torch import nn

    from genrec_tpu_torch import configs
    from genrec_tpu_torch.models.t5 import (AttnSpec, RelativePositionBias, T5Attention,
                                            T5FeedForward, _causal_bias)
    from genrec_tpu_torch.parallel.auto import param_shardings
    from genrec_tpu_torch.parallel.tensor import shard_model_

    cfg = configs.T5ArchConfig(**dict(ARCH, dropout_rate=0.1))

    def build():
        torch.manual_seed(0)
        g = torch.Generator().manual_seed(1)
        enc = nn.ModuleDict({"self_attn": T5Attention(cfg), "ff": T5FeedForward(cfg),
                             "rel_bias": RelativePositionBias(cfg, True)})
        dec = nn.ModuleDict({"self_attn": T5Attention(cfg), "cross_attn": T5Attention(cfg),
                             "rel_bias": RelativePositionBias(cfg, False)})
        root = nn.ModuleDict({"enc": enc, "dec": dec})
        for m in root.modules():
            if hasattr(m, "reset_parameters") and not isinstance(m, nn.Linear):
                m.reset_parameters(g)
        return root.train()

    r = np.random.default_rng(4)
    x0, y0, w = (torch.tensor(r.normal(size=(3, L, 32)), dtype=torch.float32) for _ in range(3))
    mask = torch.ones(3, L, dtype=torch.int64)
    mask[1, :5] = 0

    def run(root):
        x, y = x0.clone().requires_grad_(), y0.clone().requires_grad_()
        gen = torch.Generator().manual_seed(7)
        enc, dec = root["enc"], root["dec"]
        heads = enc["self_attn"].local_heads()
        outs = {
            "enc_self": enc["self_attn"](x, x, AttnSpec(
                enc["rel_bias"](L, L, heads)[0].contiguous(), mask), generator=gen),
            "dec_self": dec["self_attn"](y, y, AttnSpec(
                (dec["rel_bias"](L, L, heads)[0] + _causal_bias(L, "cpu")).contiguous(), None),
                generator=gen),
            "cross": dec["cross_attn"](y, x, AttnSpec(None, mask), generator=gen),
            "ff": enc["ff"](x, gen)}
        sum((o * w).sum() for o in outs.values()).backward()
        return outs, x.grad, y.grad

    whole = build()
    want, wx, wy = run(whole)
    tp = build()
    specs = param_shardings(mesh, tp)
    cut = shard_model_(tp, mesh, specs)
    got, gx, gy = run(tp)
    grads = _grads(tp, mesh, specs)
    try:  # the KV-cache path of a cut attention
        tp["dec"]["self_attn"](y0, y0, None)
        decode = "ran"
    except ValueError as err:
        decode = str(err)
    return {"cut": sorted(cut), "heads": tp["enc"]["self_attn"].local_heads(), "decode": decode,
            "out_err": {k: _rel_err(got[k].detach(), want[k].detach()) for k in want},
            "grad_err": dict({k: _rel_err(grads[k], p.grad)
                              for k, p in whole.named_parameters()},
                             x=_rel_err(gx, wx), y=_rel_err(gy, wy))}


def _tiger_step(mesh, arch, **flags) -> dict:
    """One TIGER loss and backward at dropout 0.1, cut over 'model' and
    whole, from one generator seed: the losses and the largest relative
    gradient difference; the generators' end states equal."""
    from genrec_tpu_torch import configs
    from genrec_tpu_torch.models.tiger import TIGER
    from genrec_tpu_torch.parallel.auto import param_shardings
    from genrec_tpu_torch.parallel.tensor import shard_model_
    from genrec_tpu_torch.pipelines.tiger_pipeline import loss_fn

    cfg = configs.TIGERConfig(arch=configs.T5ArchConfig(**dict(arch, dropout_rate=0.1, **flags)),
                              max_len=MAX_LEN)
    ii, am, lab = (torch.tensor(a) for a in _batch(1))
    batch = dict(input_ids=ii, attention_mask=am, labels=lab,
                 valid=torch.ones(len(ii), dtype=torch.bool))
    out = {}
    for name in ("whole", "tp"):
        model = TIGER(cfg, generator=torch.Generator().manual_seed(2)).train()
        specs = param_shardings(mesh, model) if name == "tp" else {}
        cut = shard_model_(model, mesh, specs)
        gen = torch.Generator().manual_seed(3)
        loss, _ = loss_fn(model, batch, gen)
        loss.backward()
        out[name] = (loss.item(), _grads(model, mesh, specs), gen.get_state(), sorted(cut))
    (lw, gw, sw, _), (lt, gt, st, cut) = out["whole"], out["tp"]
    return {"loss": (lt, lw), "cut": cut, "grad_err": max(_rel_err(gt[k], g)
                                                          for k, g in gw.items()),
            "generator_equal": torch.equal(sw, st), "specs": param_shardings(mesh, TIGER(cfg))}


def _flax_tiger_step(mesh, out) -> dict:
    """The Flax weights cut over 'model': the loss and gathered gradients at
    dropout 0 on ``_batch(5)``."""
    from genrec_tpu_torch import configs
    from genrec_tpu_torch.models.tiger import TIGER
    from genrec_tpu_torch.parallel.auto import param_shardings
    from genrec_tpu_torch.parallel.tensor import shard_model_
    from genrec_tpu_torch.pipelines.tiger_pipeline import loss_fn

    model = TIGER(configs.TIGERConfig(arch=configs.T5ArchConfig(**ARCH), max_len=MAX_LEN))
    model.load_state_dict(torch.load(out / "flax_tiger.pt"))
    specs = param_shardings(mesh, model)
    shard_model_(model, mesh, specs)
    ii, am, lab = (torch.tensor(a) for a in _batch(5))
    loss, _ = loss_fn(model.train(), dict(input_ids=ii, attention_mask=am, labels=lab,
                                          valid=torch.ones(len(ii), dtype=torch.bool)), None)
    loss.backward()
    return {"loss": loss.item(), "grads": {k: v.numpy() for k, v in
                                          _grads(model, mesh, specs).items()}}


class _FlaxInit:
    """``tiger_pipeline.TIGER`` built with the Flax initial weights while
    inside the block, so that ``tiger_pipeline.train`` starts where JAX's
    ``tiger_pipeline.train`` starts."""

    def __init__(self, out):
        self.state = torch.load(out / "flax_tiger.pt")

    def __enter__(self):
        from genrec_tpu_torch.pipelines import tiger_pipeline

        self.cls = cls = tiger_pipeline.TIGER
        state = self.state

        def build(cfg, generator=None):
            model = cls(cfg)
            model.load_state_dict(state)
            return model

        tiger_pipeline.TIGER = build

    def __exit__(self, *exc):
        from genrec_tpu_torch.pipelines import tiger_pipeline

        tiger_pipeline.TIGER = self.cls


def _tiger_runs(out) -> dict:
    """``tiger_pipeline.train`` from the Flax weights at dropout 0 on the
    2 × 2 mesh and on the 4 × 1 mesh (model axis 1), with and without the
    clip; a config whose model axis divides neither its 3 heads nor its
    d_ff of 63; a 1-epoch run resumed to 2 epochs on the 2 × 2 mesh (its
    epoch-1 checkpoint copied for a one-device resume in the pytest
    process)."""
    import torch.distributed as dist

    from genrec_tpu_torch.pipelines import tiger_pipeline
    from genrec_tpu_torch.train.checkpoint import CheckpointStore

    tr, te = _tiger_arrays()
    res = {}
    with _FlaxInit(out):
        for name, mesh, kw in (("tp", (2, 2), {}), ("dp", (4, 1), {}),
                               ("tp_clip", (2, 2), CLIP), ("dp_clip", (4, 1), CLIP)):
            r = tiger_pipeline.train(_tiger_cfg(out / name, mesh, **kw), tr, te, "cpu").result
            res[name] = (r.train_losses, r.val_losses)
        art = tiger_pipeline.train(_tiger_cfg(out / "ck", epochs=1), tr, te, "cpu")
        if dist.get_rank() == 0:
            shutil.copytree(out / "ck", out / "ck_epoch1")
        dist.barrier()
        resumed = tiger_pipeline.train(_tiger_cfg(out / "ck", resume=True), tr, te, "cpu")
    res["resumed"] = resumed.result.train_losses
    res["best_shapes"] = {k: tuple(v.shape) for k, v in art.params.items()}
    res["ckpt_shapes"] = {k: tuple(v.shape) for k, v in
                          CheckpointStore(str(out / "ck")).restore_latest()["model"].items()}
    odd = dict(ARCH, num_heads=3, d_ff=63)
    for name, mesh in (("odd_tp", (2, 2)), ("odd_dp", (4, 1))):
        r = tiger_pipeline.train(_tiger_cfg(out / name, mesh, arch=odd), tr, te, "cpu").result
        res[name] = (r.train_losses, r.val_losses)
    return res


def _sasrec_checks(mesh, out) -> dict:
    """The parity SASRec with a 700-row table cut over 'model' from the Flax
    weights: losses, gradients and scores at dropout 0 on given negatives;
    ``sasrec_pipeline.train`` cut and with the table left whole on the same
    mesh; a 701-row table's specs."""
    from genrec_tpu_torch import configs
    from genrec_tpu_torch.data import synthetic
    from genrec_tpu_torch.models.sasrec import SASRec, eval_loss, train_loss
    from genrec_tpu_torch.parallel.auto import param_shardings
    from genrec_tpu_torch.parallel.tensor import shard_model_
    from genrec_tpu_torch.pipelines import sasrec_pipeline

    cfg = configs.SASRecConfig(**SAS)
    model = SASRec(SAS_ITEMS, cfg)
    model.load_state_dict(torch.load(out / "flax_sasrec.pt"))
    specs = param_shardings(mesh, model)
    cut = shard_model_(model, mesh, specs)
    x, t = (torch.tensor(a) for a in _sas_seqs())
    neg, neg1 = torch.load(out / "sas_negs.pt")  # JAX's draws
    loss, _ = train_loss(model.train(), x, t, None, cfg, SAS_ITEMS, neg=neg)
    loss.backward()
    with torch.no_grad():
        s, _ = eval_loss(model.eval(), x, t[:, -1], None, cfg, SAS_ITEMS, neg=neg1)
        pred = model.predict(x)
    res = {"cut": sorted(cut), "rows": model.item_emb.weight.shape[0], "loss": loss.item(),
           "eval": s.item(), "predict": pred.numpy(),
           "grads": {k: v.numpy() for k, v in _grads(model, mesh, specs).items()},
           "specs_701": param_shardings(mesh, SASRec(SAS_ITEMS + 1, cfg))}

    corpus = synthetic.make_interactions(num_users=80, num_items=SAS_ITEMS, min_len=4,
                                         max_len=12, seed=2)  # 699 items: a 700-row table
    pcfg = configs.SASRecConfig(**dict(SAS, dropout=0.1), mesh=configs.MeshConfig(2, 2),
                                trainer=configs.TrainerConfig(**_trainer_kw(out / "sas")))
    res["pipeline_item_num"] = corpus.max_item_id
    res["pipeline_tp"] = sasrec_pipeline.train(pcfg, corpus, "cpu").result.train_losses
    keep = sasrec_pipeline.param_shardings
    sasrec_pipeline.param_shardings = lambda mesh, model: None  # the table left whole
    try:
        res["pipeline_whole"] = sasrec_pipeline.train(
            dataclasses.replace(pcfg, trainer=configs.TrainerConfig(
                **_trainer_kw(out / "sas_whole"))), corpus, "cpu").result.train_losses
    finally:
        sasrec_pipeline.param_shardings = keep
    return res


def _rank_main(rank: int, world: int, rdv: str, out: str) -> None:
    import torch.distributed as dist

    from genrec_tpu_torch import configs
    from genrec_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    torch.set_num_threads(1)
    initialize_multihost(f"file://{rdv}", world, rank, device="cpu")
    out = pathlib.Path(out)
    try:
        mesh = make_mesh(configs.MeshConfig(data_axis=2, model_axis=2))
        res = {"modules": _module_checks(mesh),
               "step": {name: _tiger_step(mesh, arch, **flags) for name, arch, flags in (
                   ("plain", ARCH, {}), ("remat", ARCH, dict(remat=True)),
                   ("attn_remat_dropout", ARCH, dict(attn_remat_dropout=True)),
                   ("heads3", dict(ARCH, num_heads=3), {}))},
               "flax": _flax_tiger_step(mesh, out), "runs": _tiger_runs(out),
               "sasrec": _sasrec_checks(mesh, out)}
        torch.save(res, out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# --------------------------------------------------------------------------
# pytest side
# --------------------------------------------------------------------------

def _jax_tiger_cfg(ckpt_dir, **kw):
    from genrec_tpu import configs as jc

    return jc.TIGERConfig(arch=jc.T5ArchConfig(**ARCH), max_len=MAX_LEN,
                          trainer=jc.TrainerConfig(**_trainer_kw(ckpt_dir, **kw)))


def _flax_tiger(cfg):
    """The Flax weights JAX's ``tiger_pipeline.train`` starts from."""
    import jax
    import jax.numpy as jnp

    from genrec_tpu.models.tiger import TIGER as JTIGER

    seq = cfg.max_len * cfg.code_dim
    jm = JTIGER(cfg)
    return jm, jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(cfg.trainer.seed), jnp.zeros((1, seq), jnp.int32),
        jnp.ones((1, seq), jnp.int32), jnp.ones((1, cfg.code_dim), jnp.int32)))


SAS_KEY = 3


def _flax_sasrec():
    """(model, config, Flax weights, the train loss's and the validation
    loss's negatives as JAX's losses draw them from ``SAS_KEY``)."""
    import jax
    import jax.numpy as jnp

    from genrec_tpu import configs as jc
    from genrec_tpu.models import sasrec as jsasrec
    from genrec_tpu.ops.negative_sampling import sample_negatives

    jcfg = jc.SASRecConfig(**SAS)
    jm = jsasrec.SASRec(item_num=SAS_ITEMS, cfg=jcfg)
    key = jax.random.PRNGKey(SAS_KEY)
    x = jnp.asarray(_sas_seqs()[0], jnp.int32)
    negs = (sample_negatives(jax.random.split(key)[1], x, SAS_ITEMS, SAS["num_neg_samples"]),
            sample_negatives(key, x, SAS_ITEMS, 1)[:, 0])
    return jm, jcfg, jm.init(key, x), [torch.tensor(np.asarray(n), dtype=torch.int64)
                                      for n in negs]


def _jax_side(out) -> dict:
    """What the ranks are held against, computed while they run: Flax
    TIGER's loss and gradients on ``_batch(5)``, the Flax SASRec's losses,
    gradients and scores, and JAX's ``tiger_pipeline.train`` losses without
    and with the clip."""
    import jax
    import jax.numpy as jnp

    from genrec_tpu.models import sasrec as jsasrec
    from genrec_tpu.pipelines import tiger_pipeline as jpipe
    from genrec_tpu_torch import configs
    from genrec_tpu_torch.convert import sasrec_params_from_flax, tiger_params_from_flax

    res = {}
    jm, params = _flax_tiger(_jax_tiger_cfg(out))
    ii, am, lab = (jnp.asarray(a, jnp.int32) for a in _batch(5))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, ii, am, lab, deterministic=True)[0]))(params)
    res["tiger"] = (float(loss), tiger_params_from_flax(
        jax.tree_util.tree_map(np.asarray, grads), _tiger_cfg(out)))

    jm, jcfg, params, _ = _flax_sasrec()
    x, t = (jnp.asarray(a, jnp.int32) for a in _sas_seqs())
    key = jax.random.PRNGKey(SAS_KEY)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jsasrec.train_loss(jm, p, x, t, key, jcfg, SAS_ITEMS)[0]))(params)
    ev, _ = jsasrec.eval_loss(jm, params, x, t[:, -1], key, jcfg, SAS_ITEMS)
    res["sasrec"] = (float(loss), sasrec_params_from_flax(
        jax.tree_util.tree_map(np.asarray, grads), SAS_ITEMS, configs.SASRecConfig(**SAS)),
        float(ev), np.asarray(jm.apply(params, x, method=jsasrec.SASRec.predict)))

    tr, te = _tiger_arrays()
    for clip in (False, True):
        r = jpipe.train(_jax_tiger_cfg(out / f"jax_{clip}", **(CLIP if clip else {})),
                        tr, te).result
        res[f"pipeline_{clip}"] = (r.train_losses, r.val_losses)
    return res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the rank processes' directory, their results, :func:`_jax_side`)."""
    from genrec_tpu_torch import configs
    from genrec_tpu_torch.convert import sasrec_params_from_flax, tiger_params_from_flax

    out = tmp_path_factory.mktemp("tensor_parallel")
    _, params = _flax_tiger(_jax_tiger_cfg(out))
    torch.save(tiger_params_from_flax(params, _tiger_cfg(out)), out / "flax_tiger.pt")
    _, _, sparams, negs = _flax_sasrec()
    torch.save(sasrec_params_from_flax(sparams, SAS_ITEMS, configs.SASRecConfig(**SAS)),
               out / "flax_sasrec.pt")
    torch.save(negs, out / "sas_negs.pt")
    jx = {}
    res = spawn_ranks(__file__, WORLD, out, while_waiting=lambda: jx.update(_jax_side(out)))
    return out, res, jx


def test_layout_cuts_heads_and_d_ff(ranks):
    """Half the heads and half of d_ff on each rank of a data row; the
    relative-bias tables and norms stay whole."""
    _, res, _ = ranks
    for r, rank in enumerate(res):
        mod = rank["modules"]
        assert mod["heads"] == ((r % 2), 1)
        assert mod["cut"] == sorted(f"{s}.{m}.weight" for s, m in (
            ("enc.self_attn", "q"), ("enc.self_attn", "k"), ("enc.self_attn", "v"),
            ("enc.self_attn", "o"), ("enc.ff", "wi"), ("enc.ff", "wo"),
            *((f"dec.{a}", p) for a in ("self_attn", "cross_attn") for p in "qkvo")))
        assert len(rank["step"]["plain"]["cut"]) == 16  # 3 attentions x 4 + 2 x (wi, wo)
        assert "runs on the whole model" in mod["decode"], mod["decode"]


@pytest.mark.parametrize("module", ["enc_self", "dec_self", "cross", "ff"])
def test_t5_modules_equal_the_whole_module_at_dropout(ranks, module):
    """Outputs within 1e-6 and every gradient within 1e-5 of max, at dropout
    0.1: the masks drawn at full width and sliced drop what the whole
    module drops."""
    _, res, _ = ranks
    for rank in res:
        assert rank["modules"]["out_err"][module] <= 1e-6, rank["modules"]["out_err"]
        errs = rank["modules"]["grad_err"]
        assert max(errs.values()) <= 1e-5, errs
        assert set(errs) >= {"enc.rel_bias.rel_embedding", "dec.rel_bias.rel_embedding", "x"}


@pytest.mark.parametrize("name", ["plain", "remat", "attn_remat_dropout", "heads3"])
def test_tiger_step_equals_the_whole_model(ranks, name):
    """One TIGER loss and backward at dropout 0.1: plain, under remat (every
    rank recomputes through the collectives), under attn_remat_dropout (the
    mask drawn again at full width), and with 3 heads, which leave the
    attention whole and cut d_ff only."""
    _, res, _ = ranks
    for rank in res:
        step = rank["step"][name]
        lt, lw = step["loss"]
        assert abs(lt - lw) <= 1e-6 * abs(lw), (lt, lw)
        assert step["grad_err"] <= 1e-5, step["grad_err"]
        assert step["generator_equal"]
        if name == "heads3":
            assert all(".ff." in k for k in step["cut"]) and len(step["cut"]) == 4
            assert all(v == () for k, v in step["specs"].items() if "attn" in k)


def test_tiger_loss_and_grads_equal_flax(ranks):
    """The Flax weights cut over 'model' at dropout 0: loss and every
    gathered gradient against ``jax.value_and_grad`` of the Flax model."""
    _, res, jx = ranks
    loss, want = jx["tiger"]
    for rank in res:
        assert abs(rank["flax"]["loss"] - loss) <= 1e-5
        for k, g in rank["flax"]["grads"].items():
            np.testing.assert_allclose(g, want[k].numpy(), atol=5e-4 * max(
                1.0, float(want[k].abs().max())), err_msg=k)


@pytest.mark.parametrize("clip", [False, True])
def test_tiger_pipeline_tp_equals_model_axis_1_and_jax(ranks, clip):
    """Per-epoch train and validation losses of ``tiger_pipeline.train`` on
    the 2 × 2 mesh against the port's 4 × 1 run and JAX's
    ``tiger_pipeline.train`` (8 emulated devices, data-parallel) from the
    same Flax weights and the same global batches, rtol 2e-4; with the
    clip (under SGD), the norm is the whole model's."""
    _, res, jx = ranks
    train_losses, val_losses = jx[f"pipeline_{clip}"]
    tag = "_clip" if clip else ""
    for rank in res:
        tp, dp = rank["runs"]["tp" + tag], rank["runs"]["dp" + tag]
        np.testing.assert_allclose(tp[0], dp[0], rtol=2e-4)
        np.testing.assert_allclose(tp[1], dp[1], rtol=2e-4)
        np.testing.assert_allclose(tp[0], train_losses, rtol=2e-4)
        np.testing.assert_allclose(tp[1], val_losses, rtol=2e-4)
    assert res[0]["runs"]["tp"][0] != res[0]["runs"]["tp_clip"][0]  # the clip acts


def test_axis_dividing_neither_heads_nor_d_ff_trains_replicated(ranks):
    _, res, _ = ranks
    for rank in res:
        tp, dp = rank["runs"]["odd_tp"], rank["runs"]["odd_dp"]
        np.testing.assert_allclose(tp[0], dp[0], rtol=1e-6)
        np.testing.assert_allclose(tp[1], dp[1], rtol=1e-6)


def test_tp_checkpoint_resumes_on_the_mesh_and_loads_on_one_rank(ranks):
    """The checkpoint holds whole tensors: a 1-epoch run resumed to epoch 2
    on the 2 × 2 mesh gives the uninterrupted run's epoch 2, and a
    one-device Trainer resumes from the same epoch-1 checkpoint to the same
    epoch-2 loss."""
    from genrec_tpu_torch.models.tiger import TIGER
    from genrec_tpu_torch.pipelines import tiger_pipeline

    out, res, _ = ranks
    whole = {k: tuple(v.shape) for k, v in TIGER(_tiger_cfg(out)).state_dict().items()}
    for rank in res:
        runs = rank["runs"]
        assert runs["best_shapes"] == whole and runs["ckpt_shapes"] == whole
        assert len(runs["resumed"]) == 1
        np.testing.assert_allclose(runs["resumed"][0], runs["tp"][0][1], rtol=1e-5)
    tr, te = _tiger_arrays()
    cfg = _tiger_cfg(out / "ck_epoch1", mesh=(-1, 1), resume=True)
    one = tiger_pipeline.build_trainer(cfg, tr, te, "cpu").fit()
    assert one.epochs_run == 2 and len(one.train_losses) == 1
    np.testing.assert_allclose(one.train_losses[0], res[0]["runs"]["tp"][0][1], rtol=2e-4)


def test_sasrec_row_sharded_table_equals_flax(ranks):
    """The 700-row table split 350 + 350: the train loss on given
    negatives, every gathered gradient, the validation loss and the
    full-vocabulary scores against the Flax model at dropout 0."""
    _, res, jx = ranks
    loss, want, ev, pred = jx["sasrec"]
    for rank in res:
        s = rank["sasrec"]
        assert s["rows"] == 350 and s["cut"] == ["item_emb.weight"]
        assert abs(s["loss"] - loss) <= 1e-5 and abs(s["eval"] - ev) <= 1e-4
        np.testing.assert_allclose(s["predict"], pred, atol=1e-5)
        for k, g in s["grads"].items():
            np.testing.assert_allclose(g, want[k].numpy(), atol=5e-4 * float(
                want[k].abs().max()) + 1e-7, err_msg=k)


def test_sasrec_pipeline_cut_table_equals_whole_table(ranks):
    """``sasrec_pipeline.train`` at dropout 0.1 on the 2 × 2 mesh: the
    table cut over 'model' gives the losses of the table left whole (the
    same batches, negatives and masks); a 701-row table stays whole."""
    _, res, _ = ranks
    for rank in res:
        s = rank["sasrec"]
        assert (s["pipeline_item_num"] + 1) % 2 == 0
        np.testing.assert_allclose(s["pipeline_tp"], s["pipeline_whole"], rtol=1e-5)
        assert s["specs_701"]["item_emb.weight"] == ()
        assert all(v == () for v in s["specs_701"].values())


def test_param_shardings_is_none_without_a_model_axis():
    from genrec_tpu_torch import configs
    from genrec_tpu_torch.models.tiger import TIGER
    from genrec_tpu_torch.parallel.auto import param_shardings
    from genrec_tpu_torch.parallel.mesh import Mesh

    model = TIGER(configs.TIGERConfig(arch=configs.T5ArchConfig(**ARCH), max_len=MAX_LEN))
    assert param_shardings(None, model) is None
    assert param_shardings(Mesh(("data", "model"), (4, 1), (0, 0), (None, None)), model) is None
    specs = param_shardings(Mesh(("data", "model"), (1, 4), (0, 0), (None, None)), model)
    assert all(v == () for k, v in specs.items() if "attn" in k)  # 2 heads, 4 ranks
    assert specs["model.encoder.blocks.0.ff.wi.weight"] == ("model", None)


def test_nccl_is_never_rerouted_to_gloo():
    """NCCL runs on the card only: asked for on the CPU it raises, and the
    card's default stays NCCL (a failed start is never retried on gloo)."""
    from genrec_tpu_torch.parallel.mesh import initialize_multihost

    with pytest.raises(ValueError, match="NCCL runs on the card only"):
        initialize_multihost("file:///nonexistent", 2, 0, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="backend 'mpi'"):
        initialize_multihost("file:///nonexistent", 2, 0, device="cpu", backend="mpi")
