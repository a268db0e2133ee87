"""The port's beam search (genrec_tpu_torch/ops/beam_search.py) against the
JAX package's, on a fixed logits table made with numpy from a seed.

``decode_fn`` reads next-token logits from the table by step and last token,
plus a term of the whole prefix, so beams diverge and reorder. Many
candidates tie exactly at −1e30 or −2e30 (beams 1.. start at −1e30; masked
tokens add −1e30), so tokens must match exactly, which needs the port's
stable sorts. Scores: atol 1e-5 (f32 log-softmax sums on both sides).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.configs import TIGERConfig as JaxTIGERConfig
from genrec_tpu.models.tiger import make_constraint as jax_make_constraint
from genrec_tpu.ops.beam_search import beam_search as jax_beam_search
from genrec_tpu_torch.configs import TIGERConfig
from genrec_tpu_torch.data.synthetic import make_codes
from genrec_tpu_torch.models.tiger import make_constraint
from genrec_tpu_torch.ops.beam_search import beam_search

B, BEAMS, MAX_LEN, V = 3, 12, 5, 64
EOS = 31


def _tables(eos_bias: float):
    r = np.random.default_rng(0)
    step_tab = r.normal(scale=2.0, size=(MAX_LEN - 1, V, V)).astype(np.float32)
    prefix_tab = r.normal(scale=0.5, size=(V, V)).astype(np.float32)
    step_tab[1, :, EOS] += eos_bias   # make eos likely at the second step
    return step_tab, prefix_tab


def _decode_fns(step_tab, prefix_tab):
    jst, jpt = jnp.asarray(step_tab), jnp.asarray(prefix_tab)
    tst, tpt = torch.from_numpy(step_tab), torch.from_numpy(prefix_tab)

    def jax_fn(tokens, step):
        key = jnp.sum(tokens[:, :step + 1], axis=-1) % V
        return jst[step][tokens[:, step]] + jpt[key]

    def torch_fn(tokens, step):
        key = tokens[:, :step + 1].sum(dim=-1) % V
        return tst[step][tokens[:, step]] + tpt[key]

    return jax_fn, torch_fn


def _constraints(mode):
    codes = make_codes(60)
    jc = jax_make_constraint(JaxTIGERConfig(constrained_decoding=mode), codes)
    tc = make_constraint(TIGERConfig(constrained_decoding=mode), codes)
    return jc, tc


@pytest.mark.parametrize("mode", ["none", "level", "trie"])
@pytest.mark.parametrize("eos", [None, EOS])
def test_beam_search_matches_jax(mode, eos):
    step_tab, prefix_tab = _tables(eos_bias=6.0)
    jax_fn, torch_fn = _decode_fns(step_tab, prefix_tab)
    jc, tc = _constraints(mode)
    kw = dict(decoder_start=0, pad_token=0, eos_token=eos)
    jt, js = jax_beam_search(jax_fn, B, BEAMS, MAX_LEN, V, constraint=jc, **kw)
    tt, ts = beam_search(torch_fn, B, BEAMS, MAX_LEN, V, constraint=tc, device="cpu", **kw)
    assert tt.shape == (B, BEAMS, MAX_LEN) and ts.shape == (B, BEAMS)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    assert (np.diff(ts.numpy(), axis=1) <= 0).all()  # best first


def test_eos_freezes_beams():
    """A beam that emits eos is frozen: it extends with pad at zero cost.
    The table makes eos likely at the second step, so some kept beams hold it."""
    step_tab, prefix_tab = _tables(eos_bias=6.0)
    _, torch_fn = _decode_fns(step_tab, prefix_tab)
    tt, ts = beam_search(torch_fn, B, BEAMS, MAX_LEN, V, eos_token=EOS, device="cpu")
    frozen = tt[:, :, 2] == EOS
    assert frozen.any()
    assert (tt[:, :, 3:][frozen] == 0).all()
    # no eos: the same beams would have had to keep paying for tokens
    tt0, ts0 = beam_search(torch_fn, B, BEAMS, MAX_LEN, V, eos_token=None, device="cpu")
    assert not torch.equal(tt, tt0)


def test_constraint_spec_moves_to_device():
    _, tc = _constraints("trie")
    moved = tc.to("cpu")
    assert dataclasses.asdict(moved).keys() == dataclasses.asdict(tc).keys()
    assert moved.trie_allowed.dtype == torch.bool and moved.trie_children.dtype == torch.int64
    assert moved.trie_allowed.shape == moved.trie_children.shape and moved.token_base == 1
