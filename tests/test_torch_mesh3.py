"""The port's three-axis mesh: ``SASRecLarge`` on a 2 × 2 × 2 ("data", "ctx",
"model") mesh of eight gloo ranks, after the reference's
``tests/test_long_context.py::test_cp_composes_with_sharded_table``.

Each rank holds one of the two batch rows ('data'), half of the 512
positions ('ctx', where attention runs as a ring) and half of the 512-row
item table ('model', read through the psum lookup). Every rank's output
block equals JAX's unsharded model's within 3e-5, and the gradients of
``sum(out²) / (B·L)``, summed over the (data, ctx) group, equal the
one-device port's within 5e-5 abs / 5e-4 rel, the table's rows included.
``group_over`` gives each axis's, each pair's and the world's ranks.

The ranks run this file as a script (``spawn_ranks`` of
``test_torch_parallel.py``) and import no JAX; the JAX side runs in the
pytest process.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_parallel import spawn_ranks  # noqa: E402

SHAPE, NAMES = (2, 2, 2), ("data", "ctx", "model")
B, L, VOCAB = 2, 512, 512


def _cfg(configs):
    """The reference test's configuration, in ``configs`` (either package's)."""
    return dataclasses.replace(
        configs.long_context_sasrec_config(max_len=L, dim=16), num_blocks=1, num_heads=2,
        mlp_layer=32, embedding=configs.ShardedEmbeddingConfig(vocab_size=VOCAB, dim=16))


def _ids():
    return np.random.default_rng(2).integers(1, VOCAB - 1, size=(B, L)).astype(np.int32)


def _loss(out):
    return (out ** 2).sum() / (B * L)


# --------------------------------------------------------------------------
# rank side: run as ``python test_torch_mesh3.py <rank> <world> <rdv> <out>``
# --------------------------------------------------------------------------

def _rank_main(rank: int, world: int, rdv: str, out: str) -> None:
    import torch.distributed as dist

    from genrec_tpu_torch import configs
    from genrec_tpu_torch.models.sasrec_large import SASRecLarge
    from genrec_tpu_torch.parallel.mesh import (all_reduce_sum, initialize_multihost,
                                                make_named_mesh)
    from genrec_tpu_torch.parallel.sharding import shard_tensor

    torch.set_num_threads(1)
    initialize_multihost(f"file://{rdv}", world, rank, device="cpu")
    try:
        mesh = make_named_mesh(SHAPE, NAMES)
        res = {"coord": tuple(mesh.index(a) for a in NAMES), "shape": mesh.shape}
        for k in (1, 2, 3):
            for axes in itertools.combinations(NAMES, k):
                res[axes] = dist.get_process_group_ranks(mesh.group_over(axes))
        state = torch.load(os.path.join(out, "state.pt"))
        model = SASRecLarge(VOCAB - 1, _cfg(configs), mesh=mesh, use_sharded=True,
                            lookup_impl="psum", ctx_axis="ctx").eval()
        state["item_table"] = shard_tensor(state["item_table"], ("model", None), mesh)
        model.load_state_dict(state)
        d, c = mesh.index("data"), mesh.index("ctx")
        n = L // SHAPE[1]
        ids = torch.from_numpy(_ids()[d:d + 1, c * n:(c + 1) * n]).long()
        y = model(ids)
        _loss(y).backward()
        res["out"] = y.detach().numpy()
        res["grads"] = {k: all_reduce_sum(p.grad, model.batch_group()).numpy()
                        for k, p in model.named_parameters()}
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# --------------------------------------------------------------------------
# pytest side
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's unsharded output, the one-device port's gradients, the ranks'
    results): the ranks start from JAX's initial weights."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from genrec_tpu import configs as jc
    from genrec_tpu.models.sasrec_large import SASRecLarge as JSASRecLarge
    from genrec_tpu_torch import configs
    from genrec_tpu_torch.convert import sasrec_large_params_from_flax
    from genrec_tpu_torch.models.sasrec_large import SASRecLarge

    out = tmp_path_factory.mktemp("mesh3")
    ids = jnp.asarray(_ids())
    one = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    ref = JSASRecLarge(item_num=VOCAB - 1, cfg=_cfg(jc), mesh=one, use_sharded=False)
    params = ref.init(jax.random.PRNGKey(0), ids)
    want = np.asarray(jax.jit(lambda p, x: ref.apply(p, x))(params, ids))
    state = sasrec_large_params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                          VOCAB - 1, _cfg(configs))
    torch.save(state, out / "state.pt")
    ranks = spawn_ranks(__file__, int(np.prod(SHAPE)), out, timeout=180)

    model = SASRecLarge(VOCAB - 1, _cfg(configs), use_sharded=False).eval()
    model.load_state_dict(state)
    y = model(torch.from_numpy(_ids()).long())
    _loss(y).backward()
    np.testing.assert_allclose(y.detach().numpy(), want, atol=3e-5, rtol=3e-5)
    return want, {k: p.grad.numpy() for k, p in model.named_parameters()}, ranks


def test_group_over_three_axes(runs):
    """Rank r sits at its row-major coordinate; each group holds the ranks
    that differ from it along the asked axes only."""
    grid = np.arange(8).reshape(SHAPE)
    for r, res in enumerate(runs[2]):
        coord = tuple(int(i) for i in np.unravel_index(r, SHAPE))
        assert res["coord"] == coord and res["shape"] == dict(zip(NAMES, SHAPE))
        for k in (1, 2, 3):
            for axes in itertools.combinations(NAMES, k):
                sel = tuple(slice(None) if n in axes else i for n, i in zip(NAMES, coord))
                assert res[axes] == sorted(grid[sel].ravel().tolist()), (r, axes)


def test_sasrec_large_on_data_ctx_model_equals_jax_unsharded(runs):
    want, _, ranks = runs
    n = L // SHAPE[1]
    for res in ranks:
        d, c, _ = res["coord"]
        np.testing.assert_allclose(res["out"], want[d:d + 1, c * n:(c + 1) * n],
                                   atol=3e-5, rtol=3e-5)


def test_gradients_summed_over_the_ranks_equal_one_device(runs):
    _, grads, ranks = runs
    rows = VOCAB // SHAPE[2]
    for res in ranks:
        m = res["coord"][2]
        for k, g in grads.items():
            if k == "item_table":
                g = g[m * rows:(m + 1) * rows]
            np.testing.assert_allclose(res["grads"][k], g, atol=5e-5, rtol=5e-4, err_msg=k)
