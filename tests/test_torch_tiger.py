"""The port's TIGER generation and serving (genrec_tpu_torch/models/tiger.py,
genrec_tpu_torch/serving/model_fn.py) against the JAX package's.

Weights come from the Flax init and pass through the converter. ``generate``
runs at B=2 and 20 beams in the none, level and trie modes, against JAX with
``fused_attention`` "off" and "on" (Pallas in interpret mode): tokens equal,
scores within 1e-4 (log-probabilities summed over 4 steps of an f32 model
whose logits agree to about 1e-6). Then both ``tiger_model_fn``s serve the
same checkpoint, each from its own format, and must return identical item
lists.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.configs import TIGERConfig as JaxTIGERConfig
from genrec_tpu.data.synthetic import make_codes as jax_make_codes
from genrec_tpu.models import tiger as jax_tiger
from genrec_tpu.serving.model_fn import tiger_model_fn as jax_tiger_model_fn
from genrec_tpu.train.checkpoint import CheckpointStore
from genrec_tpu_torch.configs import TIGERConfig
from genrec_tpu_torch.convert import tiger_params_from_flax
from genrec_tpu_torch.data.contracts import read_codes, write_codes
from genrec_tpu_torch.data.synthetic import make_codes
from genrec_tpu_torch.models.tiger import TIGER, generate, make_constraint
from genrec_tpu_torch.serving.model_fn import tiger_model_fn
from genrec_tpu_torch.train.checkpoint import restore_best, save_best

N_ITEMS = 120
BEAMS = 20
SEQ = TIGERConfig().max_len * TIGERConfig().code_dim


@pytest.fixture(scope="module")
def codes():
    c = make_codes(N_ITEMS)
    np.testing.assert_array_equal(c, jax_make_codes(N_ITEMS))
    return c


@pytest.fixture(scope="module")
def flax_params():
    model = jax_tiger.TIGER(JaxTIGERConfig())
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, SEQ), jnp.int32),
                        jnp.ones((1, SEQ), jnp.int32), jnp.ones((1, 4), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_cfg(mode, fused="off"):
    base = JaxTIGERConfig(constrained_decoding=mode)
    return dataclasses.replace(base, arch=dataclasses.replace(base.arch,
                                                              fused_attention=fused))


@pytest.mark.parametrize("fused", ["off", "on"])
@pytest.mark.parametrize("mode", ["none", "level", "trie"])
def test_generate_matches_jax(flax_params, codes, mode, fused):
    r = np.random.default_rng(0)
    table = codes[1:] + np.arange(4)[None, :] * 8 + 1
    ii = np.zeros((2, SEQ), np.int32)
    ii[0, -12:] = table[r.integers(0, N_ITEMS, size=3)].reshape(-1)
    ii[1] = table[r.integers(0, N_ITEMS, size=20)].reshape(-1)
    am = (ii != 0).astype(np.int32)

    jcfg = _jax_cfg(mode, fused)
    jm = jax_tiger.TIGER(jcfg)
    jc = jax_tiger.make_constraint(jcfg, codes)
    jt, js = jax.jit(lambda p, a, b: jax_tiger.generate(jm, p, a, b, num_beams=BEAMS,
                                                        constraint=jc))(
        flax_params, jnp.asarray(ii), jnp.asarray(am))

    cfg = TIGERConfig(constrained_decoding=mode)
    model = TIGER(cfg)
    model.load_state_dict(tiger_params_from_flax(flax_params))
    model.eval()
    tt, ts = generate(model, torch.from_numpy(ii), torch.from_numpy(am), num_beams=BEAMS,
                      constraint=make_constraint(cfg, codes))
    assert tt.shape == (2, BEAMS, cfg.max_gen_len)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)


def test_served_items_match_jax(flax_params, codes, tmp_path):
    codes_path = str(tmp_path / "codes" / "course_rqvae_codes.npy")
    write_codes(codes_path, codes)
    np.testing.assert_array_equal(read_codes(codes_path), codes)

    jax_dir, port_dir = str(tmp_path / "jax_ckpt"), str(tmp_path / "port_ckpt")
    store = CheckpointStore(jax_dir)
    store.save_best({"params": flax_params})
    store.wait()
    save_best(tiger_params_from_flax(flax_params), port_dir)

    jcfg = _jax_cfg("level", "on")  # the slice's configuration; serving forces trie
    jfn = jax_tiger_model_fn(jax_dir, codes_path, cfg=jcfg)
    store.close()
    fn = tiger_model_fn(port_dir, codes_path, device="cpu")
    r = np.random.default_rng(5)
    histories = [[], [7], [int(i) for i in r.integers(1, N_ITEMS + 1, size=3)],
                 [int(i) for i in r.integers(1, N_ITEMS + 1, size=20)],
                 [int(i) for i in r.integers(1, N_ITEMS + 1, size=25)] + [0, 9999]]
    for hist in histories:
        for top_k in (5, 10):
            got = fn(hist, top_k)
            assert got == jfn(hist, top_k), hist
            assert len(got) <= top_k and not set(got) & set(hist)
            assert all(1 <= i <= N_ITEMS for i in got)


def test_checkpoint_round_trip(tmp_path, flax_params):
    assert restore_best(str(tmp_path / "absent")) is None
    assert tiger_model_fn(str(tmp_path / "absent"), _write_any_codes(tmp_path),
                          device="cpu") is None
    sd = tiger_params_from_flax(flax_params)
    save_best(sd, str(tmp_path / "c"))
    back = restore_best(str(tmp_path / "c"))
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def _write_any_codes(tmp_path):
    path = str(tmp_path / "codes.npy")
    write_codes(path, make_codes(10), write_mapping_json=False)
    return path
