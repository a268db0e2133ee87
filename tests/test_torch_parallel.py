"""The port's distributed layer on a 2 × 2 mesh of four gloo ranks, against
the JAX package's on a 2 × 2 mesh of the emulated CPU devices
(`tests/test_parallel.py`, all but its tensor-parallel test, which
`test_torch_tensor_parallel.py` holds).

The four ranks are processes that run this file as a script, once per
module: each joins a group through a ``file://`` rendezvous, runs every
rank-side check and saves what it computed; the tests then compare each
rank's share with the JAX result's matching block. Rank r sits at
(r // 2, r % 2) = (data index, model index). The rank processes import no
JAX: JAX runs here, in the pytest process.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
V, D = 64, 16          # the lookups' table
TOPK_V = 256           # sharded top-k and SASRecLarge evaluation


def _lookup_inputs():
    rng = np.random.default_rng(0)
    return {
        "table": np.arange(V * D, dtype=np.float32).reshape(V, D),
        "ids": rng.integers(0, V, size=32).astype(np.int32),        # over 'data'
        "gtable": rng.normal(size=(32, 8)).astype(np.float32),
        "gids": np.array([1, 1, 5, 31, 0, 16, 16, 16], np.int32),   # replicated
        "ids2d": (np.arange(16, dtype=np.int32).reshape(4, 4) * 3) % V,
        "w2d": rng.normal(size=(4, 4, D)).astype(np.float32),
        "atable": rng.normal(size=(V, 8)).astype(np.float32),
        "aids": np.concatenate([np.full(4, 7), rng.integers(0, V, size=12)]).astype(np.int32),
        "aw": rng.normal(size=(16, 8)).astype(np.float32),
        "perm": rng.permutation(V)[:32].astype(np.int32),
    }


def _topk_inputs():
    rng = np.random.default_rng(5)
    return (rng.normal(size=(TOPK_V, 8)).astype(np.float32),
            rng.normal(size=(8, 8)).astype(np.float32))


def _ring_inputs():
    rng = np.random.default_rng(9)
    q, k, v, w = (rng.normal(size=(2, 2, 32, 16)).astype(np.float32) for _ in range(4))
    x = rng.normal(size=(4, 2, 16, 16)).astype(np.float32)
    return q, k, v, w, x


def _large_cfg(vocab, port_configs):
    return port_configs.SASRecLargeConfig(
        max_len=8, num_blocks=1, num_heads=1, mlp_layer=16, dropout=0.0, num_neg_samples=4,
        embedding=port_configs.ShardedEmbeddingConfig(vocab_size=vocab, dim=8),
        trainer=port_configs.TrainerConfig(batch_size=16))


def _cp_ids():
    rng = np.random.default_rng(13)
    ids = rng.integers(1, 511, size=(4, 16)).astype(np.int64)
    ids[0, :5] = 0
    return ids, rng.integers(1, 512, size=(4, 4)).astype(np.int64)


def _large_batch(item_num):
    rng = np.random.default_rng(3)
    x = rng.integers(1, item_num, size=(16, 8)).astype(np.int64)
    t = rng.integers(1, item_num, size=(16, 8)).astype(np.int64)
    x[:, :2] = 0
    t[:, :2] = 0
    neg = rng.integers(1, item_num + 1, size=(16, 4)).astype(np.int64)
    return x, t, neg


# --------------------------------------------------------------------------
# rank side: run as ``python test_torch_parallel.py <rank> <world> <rdv> <out>``
# --------------------------------------------------------------------------

def _rank_checks(rank: int, out_dir: str) -> dict:
    import torch.distributed as dist

    from genrec_tpu_torch import configs
    from genrec_tpu_torch.models.sasrec_large import (SASRecLarge, sharded_topk_scores,
                                                      train_loss_sampled)
    from genrec_tpu_torch.ops.attention import _xla_attention
    from genrec_tpu_torch.ops.embedding import (alltoall_embedding_lookup,
                                                sharded_embedding_lookup)
    from genrec_tpu_torch.ops.ring_attention import ring_attention
    from genrec_tpu_torch.parallel.mesh import (all_reduce_sum, make_global_array, make_mesh,
                                                process_rows)
    from genrec_tpu_torch.parallel.sharding import shard_batch, shard_params

    res = {}
    mesh = make_mesh(configs.MeshConfig(data_axis=2, model_axis=2))
    d, m = mesh.index("data"), mesh.index("model")
    dgroup = mesh.group("data")
    res["coord"] = (d, m)
    res["data_ranks"] = dist.get_process_group_ranks(dgroup)
    res["model_ranks"] = dist.get_process_group_ranks(mesh.group("model"))
    res["shape"] = dict(mesh.shape)

    sp = shard_params({"item_table": torch.arange(64 * 4.0).reshape(64, 4),
                       "blocks.0.ff.wi.weight": torch.ones(6, 3),
                       "blocks.1.ff.wi.weight": torch.ones(5, 3),  # 5 rows: replicated
                       "x.ff.wo.weight": torch.arange(12.0).reshape(3, 4)}, mesh)
    res["shard_params"] = {k: v.numpy() for k, v in sp.items()}
    res["shard_batch"] = shard_batch({"x": torch.arange(8), "y": torch.ones(8, 2)},
                                     mesh)["x"].numpy()

    inp = _lookup_inputs()
    rows = lambda a: a[d * (len(a) // 2):(d + 1) * (len(a) // 2)]  # noqa: E731  this data index's

    def shard(a):
        return torch.tensor(a[m * (len(a) // 2):(m + 1) * (len(a) // 2)])

    # psum lookup: forward on ids over 'data'; gradients on replicated ids,
    # on ids over 'data' (reduced over the data group) and on 2-D ids
    res["psum_fwd"] = sharded_embedding_lookup(
        shard(inp["table"]), torch.tensor(rows(inp["ids"])), mesh).numpy()
    gt = shard(inp["gtable"]).requires_grad_()
    gids = torch.tensor(inp["gids"])
    (sharded_embedding_lookup(gt, gids, mesh)
     * torch.arange(len(gids), dtype=torch.float32)[:, None]).sum().backward()
    res["psum_grad_replicated"] = gt.grad.numpy()
    t2d = shard(inp["gtable"]).requires_grad_()
    e2 = sharded_embedding_lookup(t2d, torch.tensor(inp["ids2d"]) % 32, mesh)
    (e2 * torch.tensor(inp["w2d"][..., :8])).sum().backward()
    res["psum_2d"], res["psum_2d_grad"] = e2.detach().numpy(), t2d.grad.numpy()

    def psum_loss(t, ids):
        return (sharded_embedding_lookup(t, ids, mesh) * torch.tensor(rows(inp["aw"]))).sum()

    def a2a_loss(t, ids, c):
        e, ok = alltoall_embedding_lookup(t, ids, mesh, capacity_factor=c)
        return (e * torch.tensor(rows(inp["aw"]))).sum(), ok

    aids = torch.tensor(rows(inp["aids"]))
    t1 = shard(inp["atable"]).requires_grad_()
    psum_loss(t1, aids).backward()
    res["psum_grad_dp"] = all_reduce_sum(t1.grad, dgroup).numpy()
    t2 = shard(inp["atable"]).requires_grad_()
    loss, ok = a2a_loss(t2, aids, 8.0)
    loss.backward()
    res["a2a_grad_dp"] = all_reduce_sum(t2.grad, dgroup).numpy()
    res["a2a_grad_ok"] = ok.numpy()

    perm = torch.tensor(rows(inp["perm"]))
    out, ok = alltoall_embedding_lookup(shard(inp["table"]), perm, mesh, capacity_factor=4.0)
    res["a2a_fwd"], res["a2a_fwd_ok"] = out.numpy(), ok.numpy()
    res["a2a_fwd_psum"] = sharded_embedding_lookup(shard(inp["table"]), perm, mesh).numpy()

    # overflow: every id on shard 0; capacity 0.5 of 8 ids over 2 owners = 2 slots
    ones = torch.ones(16, 4).requires_grad_()
    zeros = torch.zeros(8, dtype=torch.int64)
    e, ok = alltoall_embedding_lookup(ones, zeros, mesh, capacity_factor=0.5)
    e.sum().backward()
    res["overflow_rows"], res["overflow_ok"] = e.detach().numpy(), ok.numpy()
    res["overflow_grad"] = all_reduce_sum(ones.grad, dgroup).numpy()
    e, ok = alltoall_embedding_lookup(shard(inp["table"]), torch.zeros(16, dtype=torch.int64),
                                      mesh, capacity_factor=1.0)
    res["flagged_rows"], res["flagged_ok"] = e.numpy(), ok.numpy()

    # SASRecLarge: sharded gradients against use_sharded=False on the whole batch
    cfg = _large_cfg(4096, configs)
    item_num = cfg.embedding.vocab_size - 1
    x, t, neg = (torch.tensor(a) for a in _large_batch(item_num))
    rep = SASRecLarge(item_num, cfg, use_sharded=False,
                      generator=torch.Generator().manual_seed(0)).train()
    loss_rep, _ = train_loss_sampled(rep, x, t, None, cfg, item_num, neg=neg)
    loss_rep.backward()
    res["large_rep_loss"] = loss_rep.item()
    res["large_rep_grads"] = {k: p.grad.numpy() for k, p in rep.named_parameters()}
    for impl in ("psum", "alltoall"):
        model = SASRecLarge(item_num, cfg, mesh=mesh, lookup_impl=impl, alltoall_capacity=8.0,
                            generator=torch.Generator().manual_seed(0)).train()
        loss, valid = train_loss_sampled(model, rows(x), rows(t), None, cfg, item_num,
                                         neg=rows(neg))
        loss.backward()
        res[f"large_{impl}_loss"] = all_reduce_sum(loss.detach(), model.batch_group()).item()
        res[f"large_{impl}_valid"] = valid.item()
        res[f"large_{impl}_grads"] = {
            k: all_reduce_sum(p.grad, model.batch_group()).numpy()
            for k, p in model.named_parameters()}

    # sharded top-k, and SASRecLarge's evaluation through either lookup
    table, h = _topk_inputs()
    vals, idx = sharded_topk_scores(shard(table), torch.tensor(rows(h)), 10, mesh)
    res["topk"] = (vals.numpy(), idx.numpy())
    cfg = _large_cfg(TOPK_V, configs)
    xs = torch.tensor(rows(_large_batch(TOPK_V - 1)[0]))
    for impl in ("psum", "alltoall"):
        model = SASRecLarge(TOPK_V - 1, cfg, mesh=mesh, lookup_impl=impl, alltoall_capacity=4.0,
                            generator=torch.Generator().manual_seed(2)).eval()
        res[f"eval_{impl}"] = tuple(a.numpy() for a in model.predict_topk(xs, 10))

    # ring attention: the sequence over 4 ranks, then data x ctx on the 2 x 2 mesh
    ring_mesh = make_mesh(configs.MeshConfig(data_axis=4, model_axis=1))
    q, k, v, w, xq = (torch.tensor(a) for a in _ring_inputs())
    blk = slice(rank * 8, (rank + 1) * 8)
    for causal in (False, True):
        qs, ks, vs = (a[:, :, blk].clone().requires_grad_() for a in (q, k, v))
        out = ring_attention(qs, ks, vs, ring_mesh, axis_name="data", causal=causal)
        (out * w[:, :, blk]).sum().backward()
        res[f"ring_{causal}"] = (out.detach().numpy(), qs.grad.numpy(), ks.grad.numpy(),
                                 vs.grad.numpy())
        res[f"ring_plain_{causal}"] = _xla_attention(q, k, v, None, causal)[:, :, blk].numpy()
    xb = xq[d * 2:(d + 1) * 2, :, m * 8:(m + 1) * 8]
    res["ring_dp_cp"] = ring_attention(xb, xb, xb, mesh, axis_name="model", causal=True).numpy()

    # SASRecLarge over a data x ctx mesh: rows over 'data', positions over 'ctx'
    cp_mesh = make_mesh(configs.MeshConfig(data_axis=2, model_axis=2, axis_names=("data", "ctx")))
    c = cp_mesh.index("ctx")
    ccfg = dataclasses.replace(_large_cfg(512, configs), max_len=16, num_heads=2)
    ids, cneg = (torch.tensor(a) for a in _cp_ids())
    full = SASRecLarge(511, ccfg, use_sharded=False, generator=torch.Generator().manual_seed(4))
    cp = SASRecLarge(511, ccfg, mesh=cp_mesh, use_sharded=False, ctx_axis="ctx",
                     generator=torch.Generator().manual_seed(4))
    rows2, pos = slice(d * 2, (d + 1) * 2), slice(c * 8, (c + 1) * 8)
    for model, x, n in ((full, ids, ids.numel()), (cp, ids[rows2, pos], ids.numel())):
        out = model(x)
        ((out ** 2).sum() / n).backward()
        res[f"cp_{'full' if model is full else 'ring'}"] = (
            out.detach().numpy(), {k: all_reduce_sum(p.grad, model.batch_group()).numpy()
                                   for k, p in model.named_parameters()})
    res["cp_topk"] = tuple(a.numpy() for a in cp.predict_topk(ids[rows2, pos], 5))
    res["cp_loss"] = all_reduce_sum(train_loss_sampled(
        cp, ids[rows2, pos], ids[rows2, pos], None, ccfg, 511, neg=cneg[rows2])[0].detach(),
        cp.batch_group()).item()
    res["cp_drawn_loss"] = all_reduce_sum(train_loss_sampled(
        cp, ids[rows2, pos], ids[rows2, pos], torch.Generator().manual_seed(d), ccfg,
        511)[0].detach(), cp.batch_group()).item()

    # the rows a per-rank loader reads
    res["rows_32"], res["rows_30"] = process_rows(mesh, 32), process_rows(mesh, 30)
    arr = np.arange(30 * 2).reshape(30, 2)
    res["global_array"] = make_global_array(arr, mesh, device="cpu").numpy()
    res["local_array"] = make_global_array(arr[:3], mesh, process_local=True, device="cpu").numpy()

    res["tp"] = _tensor_parallel_runs(os.path.join(out_dir, "tp"))
    return res


def _tensor_parallel_runs(out: str) -> dict:
    """TIGER and the parity SASRec trained by their pipelines on the 2 × 2
    mesh, tensor-parallel, and with model axis 1: TIGER on the 4 × 1 mesh
    (replicated datasets and dropout 0, so both see the same global
    batches), SASRec on the same 2 × 2 mesh with its table left whole (its
    negatives are drawn per data index, so the data axis must match)."""
    from genrec_tpu_torch import configs
    from genrec_tpu_torch.data import datasets, synthetic, tiger_tokens
    from genrec_tpu_torch.pipelines import sasrec_pipeline, tiger_pipeline

    trainer = dict(epochs=1, batch_size=16, eval_batch_size=16, lr=3e-3, seed=0,
                   shard_dataset=False)
    corpus = synthetic.make_interactions(num_users=40, num_items=699, min_len=4, max_len=8,
                                         seed=2)
    codes = synthetic.make_codes(699, seed=1)
    tr, te = tiger_tokens.build_tiger_splits(corpus.item_id_lists, corpus.user_ids, codes)
    tr, te = (datasets.build_tiger_arrays(tr, 4, 4),
              datasets.build_tiger_arrays(te, 4, 4, max_target_items=1))
    arch = configs.T5ArchConfig(num_layers=1, num_decoder_layers=1, d_model=32, d_ff=64,
                                num_heads=2, d_kv=16, dropout_rate=0.0)
    res = {}
    for mesh in ((2, 2), (4, 1)):
        cfg = configs.TIGERConfig(arch=arch, max_len=4, mesh=configs.MeshConfig(*mesh),
                                  trainer=configs.TrainerConfig(
                                      ckpt_dir=os.path.join(out, f"tiger{mesh}"), **trainer))
        res[f"tiger{mesh}"] = tiger_pipeline.train(cfg, tr, te, "cpu").result.train_losses
    keep = sasrec_pipeline.param_shardings
    for name in ("cut", "whole"):
        cfg = configs.SASRecConfig(d=16, num_blocks=1, num_heads=1, mlp_layer=32, max_len=8,
                                   mesh=configs.MeshConfig(2, 2), trainer=configs.TrainerConfig(
                                       ckpt_dir=os.path.join(out, f"sasrec_{name}"), **trainer))
        if name == "whole":
            sasrec_pipeline.param_shardings = lambda mesh, model: None
        try:
            res[f"sasrec_{name}"] = sasrec_pipeline.train(cfg, corpus,
                                                          "cpu").result.train_losses
        finally:
            sasrec_pipeline.param_shardings = keep
    res["item_num"] = corpus.max_item_id
    return res


def _rank_main(rank: int, world: int, rdv: str, out: str) -> None:
    import torch.distributed as dist

    from genrec_tpu_torch.parallel.mesh import initialize_multihost

    torch.set_num_threads(1)
    initialize_multihost(f"file://{rdv}", world, rank, device="cpu")
    try:
        torch.save(_rank_checks(rank, out), os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(script: str, world: int, out: pathlib.Path, timeout: int = 240,
                while_waiting=None) -> list:
    """Run ``script`` as ``world`` gloo ranks sharing a ``file://`` rendezvous
    under ``out``; returns each rank's saved results. A rank that fails ends
    the others at once (they would wait in a collective); its output is in
    the assertion message. ``while_waiting()``, when given, runs in this
    process while the ranks run."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    logs = [out / f"rank{r}.log" for r in range(world)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, script, str(r), str(world), str(out / "rdv"), str(out)],
                env=env, stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        if while_waiting is not None:
            while_waiting()
        while any(p.poll() is None for p in procs):
            if any(p.poll() for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{logs[r].read_text()[-4000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# --------------------------------------------------------------------------
# pytest side
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(__file__, WORLD, tmp_path_factory.mktemp("parallel"))


@pytest.fixture(scope="module")
def jmesh():
    import jax

    from genrec_tpu.configs import MeshConfig as JMeshConfig
    from genrec_tpu.parallel.mesh import make_mesh as jmake_mesh

    return jmake_mesh(JMeshConfig(data_axis=2, model_axis=2), devices=jax.devices()[:4])


def _jput(x, mesh, *spec):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(x, NamedSharding(mesh, P(*spec)))


def _rows(a, d):
    n = len(a) // 2
    return a[d * n:(d + 1) * n]


def _shard(a, m):
    n = len(a) // 2
    return a[m * n:(m + 1) * n]


def test_mesh_coordinates_follow_jax_layout(ranks, jmesh):
    for r, res in enumerate(ranks):
        d, m = res["coord"]
        assert (d, m) == divmod(r, 2) and res["shape"] == {"data": 2, "model": 2}
        assert jmesh.devices[d, m].id == r
        assert res["data_ranks"] == [m, m + 2] and res["model_ranks"] == [2 * d, 2 * d + 1]


def test_make_mesh_without_a_group():
    """One process, no group: the 1 × 1 mesh with no groups (every
    collective the identity); axes that do not multiply to the world size
    raise as JAX's do; ``dp_shardings`` gives None."""
    from genrec_tpu_torch.configs import MeshConfig
    from genrec_tpu_torch.parallel.auto import dp_shardings
    from genrec_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig())
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group("data") is None
    assert mesh.group_over(("data", "model")) is None
    with pytest.raises(AssertionError, match="mesh 2x1 != 1 devices"):
        make_mesh(MeshConfig(data_axis=2))
    assert dp_shardings(MeshConfig()) is None


def _jax_model_params(name):
    """(Flax variables, torch module on meta, converter rename) of a small
    configuration of each model the rules cover."""
    import jax
    import jax.numpy as jnp

    from genrec_tpu import configs as jc
    from genrec_tpu_torch import configs as pc
    from genrec_tpu_torch import convert

    arch = dict(vocab_size=64, num_layers=1, num_decoder_layers=1, d_model=16, d_ff=32,
                num_heads=2, d_kv=8, dropout_rate=0.0)
    key = jax.random.PRNGKey(0)
    with torch.device("meta"):
        if name == "tiger":
            from genrec_tpu.models.tiger import TIGER as J
            from genrec_tpu_torch.models.tiger import TIGER
            z = jnp.zeros((1, 8), jnp.int32)
            params = J(jc.TIGERConfig(arch=jc.T5ArchConfig(**arch), max_len=2)).init(
                key, z, z + 1, jnp.ones((1, 4), jnp.int32))
            return params, TIGER(pc.TIGERConfig(arch=pc.T5ArchConfig(**arch), max_len=2)), None
        if name == "sasrec":
            from genrec_tpu.models.sasrec import SASRec as J
            from genrec_tpu_torch.models.sasrec import SASRec
            c = dict(d=8, num_blocks=1, num_heads=1, mlp_layer=16, max_len=8)
            params = J(item_num=20, cfg=jc.SASRecConfig(**c)).init(key, jnp.ones((1, 8), int))
            return params, SASRec(20, pc.SASRecConfig(**c)), convert._SASREC_BLOCK_NAMES
        if name == "sasrec_large":
            from genrec_tpu.models.sasrec_large import SASRecLarge as J
            from genrec_tpu_torch.models.sasrec_large import SASRecLarge
            from jax.sharding import Mesh
            one = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
            jm = J(item_num=63, cfg=_large_cfg(64, jc), mesh=one, use_sharded=False)
            params = jm.init(key, jnp.ones((1, 8), jnp.int32))
            return (params, SASRecLarge(63, _large_cfg(64, pc), use_sharded=False),
                    convert._SASREC_BLOCK_NAMES)
        if name == "rqvae":
            from genrec_tpu.models.rqvae import RQVAE as J
            from genrec_tpu_torch.models.rqvae import RQVAE
            c = dict(in_dim=16, num_emb_list=(8, 8), e_dim=4, layers=(8,), sk_epsilons=(0.0, 0.0))
            params = J(jc.RQVAEConfig(**c)).init(key, jnp.ones((2, 16)))
            rename = {"Dense_0": "layers.0", "Dense_1": "layers.1",
                      "codebook_0": "codebooks.0", "codebook_1": "codebooks.1"}
            return params, RQVAE(pc.RQVAEConfig(**c)), rename
        from genrec_tpu.models.dense_t5 import DenseT5 as J
        from genrec_tpu_torch.models.dense_t5 import DenseT5
        c = dict(input_emb_dim=12, target_emb_dim=12, max_seq_len=4)
        params = J(jc.DenseT5Config(arch=jc.T5ArchConfig(**arch), **c)).init(
            key, jnp.ones((1, 5, 12)), jnp.ones((1, 5), jnp.int32))
        return params, DenseT5(pc.DenseT5Config(arch=pc.T5ArchConfig(**arch), **c)), None


@pytest.mark.parametrize("name", ["tiger", "sasrec", "sasrec_large", "rqvae", "dense_t5"])
def test_partition_rules_match_jax_on_converter_names(name):
    """Each Flax leaf's JAX spec equals the port's spec of the tensor the
    converter maps it to; a Dense kernel (in, out) is a torch weight (out,
    in), so its spec is reversed."""
    import jax
    from jax.sharding import PartitionSpec as P

    from genrec_tpu.parallel import sharding as jsh
    from genrec_tpu_torch import convert
    from genrec_tpu_torch.parallel.sharding import DEFAULT_RULES, match_partition_rules

    params, module, rename = _jax_model_params(name)
    jspecs = jsh.match_partition_rules(jsh.DEFAULT_RULES, params)
    flat = {jsh._path_str(p): s for p, s in jax.tree_util.tree_leaves_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, P))}
    named = dict(module.state_dict())
    port = match_partition_rules(DEFAULT_RULES, named)
    assert len(flat) == len(port)
    split = 0
    for path, spec in flat.items():
        key = convert._torch_key(path, rename)
        want = tuple(spec)[::-1] if path.endswith("/kernel") else tuple(spec)
        assert port[key] == want, (path, key, spec, port[key])
        split += "model" in want
    assert split > 0 or name in ("rqvae",), name


def test_shard_params_takes_the_rank_block(ranks):
    for res in ranks:
        d, m = res["coord"]
        sp = res["shard_params"]
        np.testing.assert_array_equal(sp["item_table"],
                                      np.arange(64 * 4.0).reshape(64, 4)[m * 32:(m + 1) * 32])
        np.testing.assert_array_equal(sp["blocks.0.ff.wi.weight"], np.ones((3, 3)))
        np.testing.assert_array_equal(sp["blocks.1.ff.wi.weight"], np.ones((5, 3)))
        np.testing.assert_array_equal(res["shard_batch"], np.arange(8)[d * 4:(d + 1) * 4])
        # wo (3, 4): its 'model' dimension 4 splits; d_model 3 stays whole
        np.testing.assert_array_equal(sp["x.ff.wo.weight"],
                                      np.arange(12.0).reshape(3, 4)[:, m * 2:(m + 1) * 2])


def test_psum_lookup_forward_is_exact(ranks, jmesh):
    from genrec_tpu.ops.embedding import sharded_embedding_lookup as jlookup

    inp = _lookup_inputs()
    want = np.asarray(jlookup(_jput(inp["table"], jmesh, "model", None),
                              _jput(inp["ids"], jmesh, "data"), jmesh))
    for res in ranks:
        d, _ = res["coord"]
        np.testing.assert_array_equal(res["psum_fwd"], _rows(want, d))
        np.testing.assert_array_equal(res["psum_fwd"], inp["table"][_rows(inp["ids"], d)])


def test_psum_lookup_grad_replicated_ids(ranks, jmesh):
    import jax
    import jax.numpy as jnp

    from genrec_tpu.ops.embedding import sharded_embedding_lookup as jlookup

    inp = _lookup_inputs()
    ids = jnp.asarray(inp["gids"])

    def loss(t):
        e = jlookup(_jput(t, jmesh, "model", None), ids, jmesh, data_axis=None)
        return jnp.sum(e * jnp.arange(len(ids))[:, None])

    want = np.asarray(jax.grad(loss)(jnp.asarray(inp["gtable"])))
    dense = np.zeros_like(inp["gtable"])
    np.add.at(dense, inp["gids"], np.arange(8, dtype=np.float32)[:, None])
    for res in ranks:
        _, m = res["coord"]
        np.testing.assert_allclose(res["psum_grad_replicated"], _shard(want, m), rtol=1e-6)
        np.testing.assert_allclose(res["psum_grad_replicated"], _shard(dense, m), rtol=1e-6)


def test_psum_lookup_2d_ids(ranks):
    """(4, 4) ids, replicated: (4, 4, D) rows, exact, and each rank's block
    of the dense scatter-add gradient."""
    inp = _lookup_inputs()
    ids = inp["ids2d"] % 32
    dense = np.zeros_like(inp["gtable"])
    np.add.at(dense, ids.reshape(-1), inp["w2d"][..., :8].reshape(-1, 8))
    for res in ranks:
        _, m = res["coord"]
        assert res["psum_2d"].shape == (4, 4, 8)
        np.testing.assert_array_equal(res["psum_2d"], inp["gtable"][ids])
        np.testing.assert_allclose(res["psum_2d_grad"], _shard(dense, m), rtol=1e-6)


def _jax_a2a_grads(jmesh):
    import jax
    import jax.numpy as jnp

    from genrec_tpu.ops.embedding import alltoall_embedding_lookup as ja2a
    from genrec_tpu.ops.embedding import sharded_embedding_lookup as jlookup

    inp = _lookup_inputs()
    ids = _jput(inp["aids"], jmesh, "data")
    w = jnp.asarray(inp["aw"])

    def loss_psum(t):
        return jnp.sum(jlookup(_jput(t, jmesh, "model", None), ids, jmesh) * w)

    def loss_a2a(t):
        e, ok = ja2a(_jput(t, jmesh, "model", None), ids, jmesh, capacity_factor=8.0)
        return jnp.sum(e * w), ok

    table = jnp.asarray(inp["atable"])
    g_psum = np.asarray(jax.jit(jax.grad(loss_psum))(table))
    (_, ok), g_a2a = jax.jit(jax.value_and_grad(loss_a2a, has_aux=True))(table)
    return g_psum, np.asarray(g_a2a), np.asarray(ok)


def test_psum_lookup_grad_ids_over_data(ranks, jmesh):
    g_psum, _, _ = _jax_a2a_grads(jmesh)
    for res in ranks:
        _, m = res["coord"]
        np.testing.assert_allclose(res["psum_grad_dp"], _shard(g_psum, m), rtol=1e-6)


def test_alltoall_grads_equal_psum_grads(ranks, jmesh):
    g_psum, g_a2a, ok = _jax_a2a_grads(jmesh)
    assert ok.all()
    for res in ranks:
        d, m = res["coord"]
        assert res["a2a_grad_ok"].all()
        np.testing.assert_allclose(res["a2a_grad_dp"], res["psum_grad_dp"], rtol=1e-6)
        np.testing.assert_allclose(res["a2a_grad_dp"], _shard(g_a2a, m), rtol=1e-6)


def test_alltoall_forward_equals_psum(ranks, jmesh):
    from genrec_tpu.ops.embedding import alltoall_embedding_lookup as ja2a

    inp = _lookup_inputs()
    want, ok = ja2a(_jput(inp["table"], jmesh, "model", None), _jput(inp["perm"], jmesh, "data"),
                    jmesh, capacity_factor=4.0)
    for res in ranks:
        d, _ = res["coord"]
        assert res["a2a_fwd_ok"].all() and np.asarray(ok).all()
        np.testing.assert_array_equal(res["a2a_fwd"], res["a2a_fwd_psum"])
        np.testing.assert_array_equal(res["a2a_fwd"], _rows(np.asarray(want), d))


def test_alltoall_overflow_reads_zero_and_gets_no_gradient(ranks, jmesh):
    """All ids on shard 0 at capacity 0.5: the dropped ids read zero rows,
    their ``ok`` flags are JAX's, and the table gradient counts one row per
    kept id, on row 0 only."""
    import jax
    import jax.numpy as jnp

    from genrec_tpu.ops.embedding import alltoall_embedding_lookup as ja2a

    ids = _jput(jnp.zeros((16,), jnp.int32), jmesh, "data")

    def loss(t):
        e, ok = ja2a(_jput(t, jmesh, "model", None), ids, jmesh, capacity_factor=0.5)
        return jnp.sum(e), ok

    (_, jok), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.ones((32, 4)))
    jok, jgrad = np.asarray(jok), np.asarray(jgrad)
    kept = 0
    for res in ranks:
        d, m = res["coord"]
        np.testing.assert_array_equal(res["overflow_ok"], _rows(jok, d))
        assert (res["overflow_rows"][~res["overflow_ok"]] == 0).all()
        assert (res["overflow_rows"][res["overflow_ok"]] == 1).all()
        np.testing.assert_allclose(res["overflow_grad"], _shard(jgrad, m), rtol=1e-6)
        kept += res["overflow_ok"].sum() if m == 0 else 0
    assert 0 < kept < 16
    assert jgrad.sum() == kept * 4 and (jgrad[1:] == 0).all()


def test_alltoall_overflow_flagged(ranks, jmesh):
    from genrec_tpu.ops.embedding import alltoall_embedding_lookup as ja2a

    inp = _lookup_inputs()
    _, jok = ja2a(_jput(inp["table"], jmesh, "model", None),
                  _jput(np.zeros(32, np.int32), jmesh, "data"), jmesh, capacity_factor=1.0)
    for res in ranks:
        d, _ = res["coord"]
        ok = res["flagged_ok"]
        assert not ok.all() and ok.any()
        np.testing.assert_array_equal(ok, _rows(np.asarray(jok), d))
        np.testing.assert_array_equal(res["flagged_rows"][ok],
                                      np.broadcast_to(inp["table"][0], (ok.sum(), D)))
        assert (res["flagged_rows"][~ok] == 0).all()


@pytest.mark.parametrize("dim,c", [(64, 2.0), (64, 1.5), (1, 1.0), (8, 1.7), (8, 1.8)])
def test_preferred_lookup_equals_jax(dim, c):
    from genrec_tpu.configs import ShardedEmbeddingConfig as J
    from genrec_tpu_torch.configs import ShardedEmbeddingConfig

    assert ShardedEmbeddingConfig(dim=dim).preferred_lookup(c) == J(dim=dim).preferred_lookup(c)


@pytest.mark.parametrize("impl", ["psum", "alltoall"])
def test_sasrec_large_sharded_grads_equal_replicated(ranks, impl):
    """The row-sharded SASRecLarge on the 2 × 2 mesh (rows over 'data',
    table over 'model') against ``use_sharded=False`` on the whole batch:
    the loss, every tower gradient and each rank's block of the table
    gradient within rtol 1e-5."""
    for res in ranks:
        _, m = res["coord"]
        assert res[f"large_{impl}_valid"] == 16 * 6
        np.testing.assert_allclose(res[f"large_{impl}_loss"], res["large_rep_loss"], rtol=1e-5)
        for k, g in res[f"large_{impl}_grads"].items():
            want = res["large_rep_grads"][k]
            if k == "item_table":
                want = _shard(want, m)
            np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-7, err_msg=k)


def _assert_topk(vals, idx, want_v, want_i, scores):
    """Values within f32 rounding; ids equal wherever the neighbouring values
    differ; each id's own score is its value (ties may come in any order)."""
    np.testing.assert_allclose(vals, want_v, rtol=1e-6, atol=1e-6)
    gap = np.diff(want_v, axis=1)
    clear = np.ones_like(want_i, bool)
    clear[:, 1:] &= np.abs(gap) > 1e-5
    clear[:, :-1] &= np.abs(gap) > 1e-5
    np.testing.assert_array_equal(idx[clear], want_i[clear])
    np.testing.assert_allclose(np.take_along_axis(scores, idx, 1), vals, rtol=1e-6, atol=1e-6)


def test_sharded_topk_equals_full_topk_and_jax(ranks, jmesh):
    from genrec_tpu.models.sasrec_large import sharded_topk_scores as jtopk

    table, h = _topk_inputs()
    jv, ji = jtopk(_jput(table, jmesh, "model", None), _jput(h, jmesh, "data", None), 10, jmesh)
    scores = h.astype(np.float64) @ table.T.astype(np.float64)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :10]
    for res in ranks:
        d, _ = res["coord"]
        vals, idx = res["topk"]
        _assert_topk(vals, idx, _rows(np.asarray(jv), d), _rows(np.asarray(ji), d),
                     _rows(scores, d))
        _assert_topk(vals, idx, _rows(np.take_along_axis(scores, order, 1), d),
                     _rows(order, d), _rows(scores, d))


def test_alltoall_evaluation_equals_psum(ranks):
    for res in ranks:
        for a, b in zip(res["eval_alltoall"], res["eval_psum"]):
            np.testing.assert_array_equal(a, b)


def _jax_ring_reference(causal):
    import jax
    import jax.numpy as jnp

    from genrec_tpu.ops.attention import _xla_attention

    q, k, v, w, _ = (jnp.asarray(a) for a in _ring_inputs())

    def loss(q_, k_, v_):
        return jnp.sum(_xla_attention(q_, k_, v_, None, causal) * w)

    out = _xla_attention(q, k, v, None, causal)
    return [np.asarray(out)] + [np.asarray(g) for g in jax.grad(loss, (0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_equals_dense(ranks, causal):
    """The sequence over 4 ranks (8 tokens each): out and the q, k, v
    gradients of each rank's block equal dense attention's, JAX's and the
    port's plain path, within 1e-5."""
    want = _jax_ring_reference(causal)
    for r, res in enumerate(ranks):
        blk = slice(r * 8, (r + 1) * 8)
        for got, w in zip(res[f"ring_{causal}"], want):
            np.testing.assert_allclose(got, w[:, :, blk], atol=1e-5)
        np.testing.assert_allclose(res[f"ring_{causal}"][0], res[f"ring_plain_{causal}"],
                                   atol=1e-5)


def test_ring_attention_data_x_ctx_mesh(ranks):
    """Batch over 'data', sequence over 'model' (as JAX's ``axis_name='model',
    batch_axis='data'``), causal."""
    from genrec_tpu.ops.attention import _xla_attention

    x = _ring_inputs()[4]
    want = np.asarray(_xla_attention(x, x, x, None, True))
    for res in ranks:
        d, m = res["coord"]
        np.testing.assert_allclose(res["ring_dp_cp"], want[d * 2:(d + 1) * 2, :, m * 8:(m + 1) * 8],
                                   atol=1e-5)


def test_sasrec_large_ctx_axis_equals_single_path(ranks):
    """``ctx_axis``: the sequence over 'ctx' (the ring in every block), the
    rows over 'data': each rank's output block, the gradients summed over
    the ranks, ``predict_topk`` (the last positions' features sent from the
    last ctx rank) and the sampled loss equal the one-rank model's."""
    from genrec_tpu_torch import configs
    from genrec_tpu_torch.models.sasrec_large import SASRecLarge, train_loss_sampled

    ccfg = dataclasses.replace(_large_cfg(512, configs), max_len=16, num_heads=2)
    ids, neg = (torch.tensor(a) for a in _cp_ids())
    full = SASRecLarge(511, ccfg, use_sharded=False, generator=torch.Generator().manual_seed(4))
    want_v, want_i = full.predict_topk(ids, 5)
    want_loss = train_loss_sampled(full, ids, ids, None, ccfg, 511, neg=neg)[0].item()
    for r, res in enumerate(ranks):
        d, c = divmod(r, 2)
        out_full, g_full = res["cp_full"]
        out, g = res["cp_ring"]
        np.testing.assert_allclose(out, out_full[d * 2:(d + 1) * 2, c * 8:(c + 1) * 8], atol=1e-5)
        for k, v in g_full.items():
            np.testing.assert_allclose(g[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(res["cp_topk"][0], want_v[d * 2:(d + 1) * 2], atol=1e-5)
        np.testing.assert_array_equal(res["cp_topk"][1], want_i[d * 2:(d + 1) * 2])
        np.testing.assert_allclose(res["cp_loss"], want_loss, rtol=1e-5)
        assert np.isfinite(res["cp_drawn_loss"])
    assert len({res["cp_drawn_loss"] for res in ranks}) == 1


def test_sasrec_large_bf16_table_equals_jax():
    """The bf16 table (JAX stores it so for the 10M-row configuration):
    rows upcast to f32 before every product, as JAX promotes them, so the
    sampled scores and the top-k equal JAX's within f32 rounding; the table
    gradient, bf16 in both, within bf16 rounding."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from genrec_tpu import configs as jc
    from genrec_tpu.models.sasrec_large import SASRecLarge as J
    from genrec_tpu_torch import configs as pc
    from genrec_tpu_torch.convert import sasrec_large_params_from_flax
    from genrec_tpu_torch.models.sasrec_large import SASRecLarge

    def cfg(mod):
        c = _large_cfg(256, mod)
        return dataclasses.replace(c, embedding=dataclasses.replace(c.embedding, dtype="bfloat16"))

    one = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jm = J(item_num=255, cfg=cfg(jc), mesh=one, use_sharded=False)
    x, t, neg = _large_batch(255)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    assert params["params"]["item_table"].dtype == jnp.bfloat16
    model = SASRecLarge(255, cfg(pc)).train()
    model.load_state_dict(sasrec_large_params_from_flax(params, 255, cfg(pc)))
    assert model.item_table.dtype == torch.bfloat16

    def jloss(p):
        ps, ns = jm.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(neg),
                          method=J.sampled_scores)
        return jnp.sum(ps) + jnp.sum(ns * 0.5), (ps, ns)

    (_, (jps, jns)), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    ps, ns = model.sampled_scores(torch.tensor(x), torch.tensor(t), torch.tensor(neg))
    assert ps.dtype == ns.dtype == torch.float32
    (ps.sum() + (ns * 0.5).sum()).backward()
    np.testing.assert_allclose(ps.detach().numpy(), np.asarray(jps), atol=1e-5)
    np.testing.assert_allclose(ns.detach().numpy(), np.asarray(jns), atol=1e-5)
    g, want = model.item_table.grad.float().numpy(), np.asarray(jg["params"]["item_table"],
                                                               np.float32)
    np.testing.assert_allclose(g, want, atol=2 ** -7 * np.abs(want).max())
    jv, ji = jm.apply(params, jnp.asarray(x), 5, method=J.predict_topk)
    v, i = model.eval().predict_topk(torch.tensor(x), 5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_process_rows_and_make_global_array(ranks):
    arr = np.arange(30 * 2).reshape(30, 2)
    for res in ranks:
        d, _ = res["coord"]
        assert res["rows_32"] == (16 * d, 16 * d + 16)
        assert res["rows_30"] == (15 * d, 15 * d + 15)
        np.testing.assert_array_equal(res["global_array"], arr[15 * d:15 * d + 15])
        np.testing.assert_array_equal(res["local_array"], arr[:3])


def test_tensor_parallel_train_gives_the_model_axis_1_losses(ranks):
    """A model axis of 2 trains (TIGER's heads and d_ff, the parity SASRec's
    700-row table split over it) to the losses of model axis 1."""
    for res in ranks:
        tp = res["tp"]
        assert tp["item_num"] == 699
        np.testing.assert_allclose(tp["tiger(2, 2)"], tp["tiger(4, 1)"], rtol=2e-4)
        np.testing.assert_allclose(tp["sasrec_cut"], tp["sasrec_whole"], rtol=2e-4)
        assert np.isfinite(tp["tiger(2, 2)"] + tp["sasrec_cut"]).all()
