"""The port's T5 encoder-decoder (genrec_tpu_torch/models/t5.py) and weight
converter against the JAX package's Flax model at TIGERConfig defaults.

The Flax model runs with ``fused_attention`` "off" (the XLA composition) and
"on" (the Pallas kernel in interpret mode); the port computes the same
function on both. Weights come from the Flax init and pass through
``convert.tiger_params_from_flax``; inputs are made with numpy from a seed.
Tolerance: atol 1e-4 on hidden states and logits (two layers of f32 matmuls,
softmax and RMS norm, each summed in another order on each side).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.configs import TIGERConfig as JaxTIGERConfig
from genrec_tpu.models import t5 as jax_t5
from genrec_tpu.models.tiger import TIGER as JaxTIGER
from genrec_tpu_torch.configs import T5ArchConfig, TIGERConfig
from genrec_tpu_torch.convert import tiger_params_from_flax
from genrec_tpu_torch.models import t5
from genrec_tpu_torch.models.tiger import TIGER

ATOL = 1e-4
BSZ = 3
SEQ = TIGERConfig().max_len * TIGERConfig().code_dim


@pytest.fixture(scope="module")
def inputs():
    r = np.random.default_rng(0)
    ii = r.integers(1, 33, size=(BSZ, SEQ)).astype(np.int32)
    pad = np.array([SEQ, 50, 0])          # row 0 fully padded (an empty history)
    am = (np.arange(SEQ)[None, :] >= pad[:, None]).astype(np.int32)
    ii = ii * am
    lab = r.integers(1, 33, size=(BSZ, 4)).astype(np.int32)
    lab[1, 2:] = -100
    return ii, am, lab


@pytest.fixture(scope="module")
def flax_params(inputs):
    ii, am, lab = inputs
    params = JaxTIGER(JaxTIGERConfig()).init(jax.random.PRNGKey(0), jnp.asarray(ii),
                                              jnp.asarray(am), jnp.asarray(lab))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def port(flax_params):
    model = TIGER(TIGERConfig())
    model.load_state_dict(tiger_params_from_flax(flax_params), strict=True)
    return model.eval()


def _jax_model(mode):
    base = JaxTIGERConfig()
    return JaxTIGER(dataclasses.replace(
        base, arch=dataclasses.replace(base.arch, fused_attention=mode)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_configs_compare_field_for_field():
    from genrec_tpu import configs as jconfigs
    from genrec_tpu_torch import configs as tconfigs

    jc, tc = JaxTIGERConfig(), TIGERConfig()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    for name in ("SASRecConfig", "ShardedEmbeddingConfig", "SASRecLargeConfig", "RQVAEConfig",
                 "TIGERPrefixConfig", "DenseT5Config"):
        j, t = getattr(jconfigs, name)(), getattr(tconfigs, name)()
        assert type(t).__name__ == name and dataclasses.asdict(j) == dataclasses.asdict(t)
    for args in ((), (4096, 16)):
        assert (dataclasses.asdict(jconfigs.long_context_sasrec_config(*args))
                == dataclasses.asdict(tconfigs.long_context_sasrec_config(*args)))
    for c in (0.5, 1.9, 2.0):
        for dim in (1, 64):
            emb = dict(dim=dim)
            assert (jconfigs.ShardedEmbeddingConfig(**emb).preferred_lookup(c)
                    == tconfigs.ShardedEmbeddingConfig(**emb).preferred_lookup(c))


def test_converter_fills_every_parameter(flax_params, port):
    m = flax_params["params"]["model"]
    sd = port.state_dict()
    np.testing.assert_array_equal(sd["model.shared.weight"].numpy(), m["shared"]["embedding"])
    np.testing.assert_array_equal(
        sd["model.decoder.blocks.1.cross_attn.q.weight"].numpy(),
        m["decoder"]["block_1"]["cross_attn"]["q"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["model.encoder.blocks.0.ff.wi.weight"].numpy(),
        m["encoder"]["block_0"]["ff"]["wi"]["kernel"].T)
    np.testing.assert_array_equal(sd["model.encoder.rel_bias.rel_embedding"].numpy(),
                                  m["encoder"]["rel_bias"]["rel_embedding"])
    # round trip: every Flax leaf comes back out of the loaded module unchanged
    leaves = jax.tree_util.tree_flatten_with_path(flax_params)[0]
    assert len(leaves) == len(sd)
    for path, leaf in leaves:
        names = [str(p.key) for p in path]
        parts = []
        for n in names[1:]:
            if n.startswith("block_"):
                parts += ["blocks", n[len("block_"):]]
            else:
                parts.append("weight" if n in ("kernel", "embedding") else n)
        key = ".".join(parts)
        want = leaf.T if names[-1] == "kernel" else leaf
        np.testing.assert_array_equal(sd[key].numpy(), want, err_msg=key)


def test_converter_is_strict(flax_params):
    def edited(fn):
        tree = jax.tree_util.tree_map(lambda x: x, flax_params)  # a copy of the dicts
        fn(tree["params"]["model"])
        return tree

    def drop_leaf(m):
        del m["decoder"]["block_0"]["cross_norm"]

    def add_leaf(m):
        m["encoder"]["block_0"]["extra"] = {"kernel": np.zeros((64, 64), np.float32)}

    def bad_shape(m):
        m["encoder"]["block_1"]["self_attn"]["o"]["kernel"] = np.zeros((64, 32), np.float32)

    def stray_block(m):
        m["encoder"]["block_2"] = m["encoder"]["block_1"]

    with pytest.raises(KeyError, match="unfilled"):
        tiger_params_from_flax(edited(drop_leaf))
    with pytest.raises(KeyError, match="no counterpart"):
        tiger_params_from_flax(edited(add_leaf))
    with pytest.raises(ValueError, match="shape"):
        tiger_params_from_flax(edited(bad_shape))
    with pytest.raises(KeyError, match="no counterpart"):
        tiger_params_from_flax(edited(stray_block))
    with pytest.raises(KeyError, match="params"):
        tiger_params_from_flax(flax_params["params"])


@pytest.mark.parametrize("bidirectional", [True, False])
def test_bucket_tables_equal(bidirectional):
    a = T5ArchConfig()
    rel = np.arange(-300, 301, dtype=np.int32)
    kw = dict(bidirectional=bidirectional, num_buckets=a.relative_attention_num_buckets,
              max_distance=a.relative_attention_max_distance)
    want = np.asarray(jax_t5.relative_position_bucket(jnp.asarray(rel), **kw))
    got = t5.relative_position_bucket(_t(rel), **kw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["off", "on"])
def test_encode_matches_flax(flax_params, port, inputs, mode):
    ii, am, _ = inputs
    want = _jax_model(mode).apply(flax_params, jnp.asarray(ii), jnp.asarray(am),
                                  method=JaxTIGER.encode)
    with torch.no_grad():
        got = port.encode(_t(ii), _t(am))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("num_beams", [None, 3])
def test_decode_step_matches_flax(flax_params, port, inputs, num_beams):
    """One decode step over a 3-token prefix from precomputed cross K/V,
    with the beams folded into cross-attention's query axis or not."""
    ii, am, _ = inputs
    jm = _jax_model("off")
    rows = BSZ * (num_beams or 1)
    prefix = np.random.default_rng(1).integers(0, 33, size=(rows, 3)).astype(np.int32)
    prefix[:, 0] = 0

    enc = jm.apply(flax_params, jnp.asarray(ii), jnp.asarray(am), method=JaxTIGER.encode)
    kvs = jm.apply(flax_params, enc, method=JaxTIGER.precompute_cross_kv)
    want = jm.apply(flax_params, jnp.asarray(prefix), kvs, jnp.asarray(am), num_beams,
                    method=JaxTIGER.decode_step)
    with torch.no_grad():
        kv_t = port.precompute_cross_kv(port.encode(_t(ii), _t(am)))
        for (kj, vj), (kt, vt) in zip(kvs, kv_t):
            np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=ATOL)
            np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)
        got = port.decode_step(_t(prefix), kv_t, _t(am), num_beams)
    assert got.shape == (rows, TIGERConfig().arch.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("mode", ["off", "on"])
def test_loss_and_logits_match_flax(flax_params, port, inputs, mode):
    """The deterministic teacher-forced forward: encoder, full-sequence
    decoder with causal self-attention and cross-attention, tied logits."""
    ii, am, lab = inputs
    loss_j, logits_j = _jax_model(mode).apply(flax_params, jnp.asarray(ii), jnp.asarray(am),
                                              jnp.asarray(lab), deterministic=True)
    with torch.no_grad():
        loss_t, logits_t = port(_t(ii), _t(am), _t(lab))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=ATOL)
    assert abs(float(loss_t) - float(loss_j)) < ATOL


def test_shift_right_and_cross_entropy_match_flax():
    r = np.random.default_rng(2)
    lab = r.integers(1, 33, size=(4, 5)).astype(np.int32)
    lab[0, 3:] = -100
    lab[2, 1:] = -100
    np.testing.assert_array_equal(t5.shift_right(_t(lab), 0, 0).numpy(),
                                  np.asarray(jax_t5.shift_right(jnp.asarray(lab), 0, 0)))
    logits = r.normal(size=(4, 5, 64)).astype(np.float32)
    want = jax_t5.cross_entropy_with_ignore(jnp.asarray(logits), jnp.asarray(lab))
    got = t5.cross_entropy_with_ignore(_t(logits), _t(lab))
    assert abs(float(got) - float(want)) < 1e-5
