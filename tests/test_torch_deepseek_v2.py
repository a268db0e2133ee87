"""DeepSeek-V2 as a semantic-ID recommender (``models/deepseek_v2.py``)
against the plain reference (``reference/deepseek_v2.py``), on seeded
weights at a tiny size on the CPU: hidden 64, 4 heads, latent 16, rope 8,
nope 16, v 16, one dense and two MoE layers of 8 experts (top-2, one
shared), a 512-token vocabulary, YaRN on. No JAX.

The program runs in float32 here, so it is held to the reference at f32
rounding: logits within 2e-5 absolute (they reach about 7), sequence
scores within 5e-5 (sums of four log-probabilities near -6). The weights
are drawn at N(0, 0.2²), so that attention and routing are far from
uniform and every part of a layer moves the logits.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from genrec_tpu_torch.configs import DeepSeekV2Config
from genrec_tpu_torch.models import deepseek_v2 as ds
from genrec_tpu_torch.reference import deepseek_v2 as ref
from genrec_tpu_torch.utils import profiling

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
            num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
            n_shared_experts=1, n_routed_experts=8, num_experts_per_tok=2, kv_lora_rank=16,
            qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16, initializer_range=0.2,
            bos_token_id=0, eos_token_id=1, codebook_size=16, sid_base=512 - 64)
LOGIT_ATOL, SCORE_ATOL = 2e-5, 5e-5
B, L, BEAMS = 3, 10, 5


def _setup(dtype="float32", seed=0):
    cfg = DeepSeekV2Config(dtype=dtype, **TINY)
    d = dataclasses.asdict(cfg)
    weights = ref.make_weights(d, torch.Generator().manual_seed(seed), "cpu", ds.compute_dtype(cfg))
    model = ds.DeepSeekV2(cfg, device="meta")
    model.load_state_dict(weights, assign=True, strict=True)
    return cfg, d, weights, model


def _prompts(seed=1):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(2, TINY["sid_base"], (B, L), generator=g)
    mask = torch.ones((B, L), dtype=torch.long)
    mask[1, :3] = 0  # left padding
    mask[2, :6] = 0
    return ids, mask


def _codes(n=40, seed=0):
    r = np.random.default_rng(seed)
    codes = np.concatenate([r.integers(0, 16, (n, 3)), np.zeros((n, 1), np.int64)], 1)
    return np.unique(codes, axis=0)


def test_the_model_holds_the_weights_it_was_given_in_their_dtype():
    """Built on ``meta`` and loaded with ``assign``: every parameter is the
    tensor handed in (no copy, so no float32 copy of bf16 weights)."""
    _, _, weights, model = _setup("bfloat16")
    params = dict(model.named_parameters())
    assert set(params) == set(weights)
    for name, p in params.items():
        assert p.data_ptr() == weights[name].data_ptr() and p.dtype == torch.bfloat16, name


def test_yarn_frequencies_and_softmax_scale_have_their_closed_form():
    """DeepSeek-V2-Lite's: rope 64 over θ 10,000, factor 40 from 4,096
    positions, β 32 and 1: the correction range is dims 10..23 (of 32), the
    extrapolated frequencies below it, the interpolated ones above it, a
    linear ramp between; scale 192^-1/2 · (0.1 · 0.707 · ln 40 + 1)²."""
    cfg = DeepSeekV2Config()
    got = ds.yarn_inv_freq(cfg, "cpu").double()
    low, high = 10, 23
    want = []
    for i in range(32):
        extra, inter = 10000.0 ** (-2 * i / 64), 10000.0 ** (-2 * i / 64) / 40
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(inter * ramp + extra * (1 - ramp))
    torch.testing.assert_close(got, torch.tensor(want, dtype=torch.float64), rtol=2e-6, atol=0)
    torch.testing.assert_close(ref.yarn_table(dataclasses.asdict(cfg))[0], got.float(),
                               rtol=2e-6, atol=0)
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert ds.softmax_scale(cfg) == pytest.approx(192 ** -0.5 * mscale ** 2, rel=1e-12)
    assert ref.softmax_scale(dataclasses.asdict(cfg)) == pytest.approx(ds.softmax_scale(cfg))
    assert ds.rope_attention_factor(cfg) == pytest.approx(1.0)


@pytest.mark.parametrize("key,value", [
    ("q_lora_rank", 1536), ("topk_method", "group_limited_greedy"),
    ("scoring_func", "sigmoid"), ("norm_topk_prob", True), ("tie_word_embeddings", True),
    ("hidden_act", "gelu"), ("attention_bias", True),
    ("rope_scaling", {"type": "linear", "factor": 2.0})])
def test_a_configuration_it_does_not_compute_is_refused(key, value):
    """The model and the reference refuse a published key's value that they
    would otherwise ignore (building another model than the file says)."""
    cfg = DeepSeekV2Config(**{**TINY, key: value})
    with pytest.raises(ValueError, match=key):
        ds.DeepSeekV2(cfg, device="meta")
    ids, mask = _prompts()
    with pytest.raises(ValueError, match=key):
        ref.forward(dataclasses.asdict(cfg), {}, ids, mask)


def test_full_forward_logits_equal_the_reference():
    _, d, weights, model = _setup()
    ids, mask = _prompts()
    with torch.no_grad():
        got = model(ids, mask)
    want = ref.forward(d, weights, ids, mask)
    real = mask.bool()
    torch.testing.assert_close(got[real], want[real], rtol=0, atol=LOGIT_ATOL)
    assert want.abs().max() > 3  # logits far from flat


def test_a_padded_row_gives_its_unpadded_rows_logits():
    _, _, _, model = _setup()
    ids, mask = _prompts()
    with torch.no_grad():
        padded = model(ids, mask)[2, 6:]
        alone = model(ids[2:, 6:], mask[2:, 6:])[0]
    torch.testing.assert_close(padded, alone, rtol=0, atol=LOGIT_ATOL)


def test_prefill_then_cached_decode_equal_the_full_forward_under_reorders():
    """Each decode step's logits, for beams that a random reorder shuffles
    within their prompt, equal the reference's full forward over the
    prompt and that beam's tokens so far, at its last position."""
    cfg, d, weights, model = _setup()
    ids, mask = _prompts()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        first, cache = model.prefill(ids, mask, BEAMS)
        want = ref.forward(d, weights, ids, mask, torch.full((B, 1), L - 1))[:, 0]
        torch.testing.assert_close(first, want, rtol=0, atol=LOGIT_ATOL)
        seqs = torch.zeros((B * BEAMS, 0), dtype=torch.long)
        for slot in range(cfg.code_dim - 1):
            if slot:
                parents = torch.stack([torch.randperm(BEAMS, generator=g) for _ in range(B)])
                flat = (parents + torch.arange(B)[:, None] * BEAMS).reshape(-1)
                cache.reorder(flat)
                seqs = seqs[flat]
            tok = torch.randint(cfg.sid_base, cfg.vocab_size, (B * BEAMS,), generator=g)
            seqs = torch.cat([seqs, tok[:, None]], 1)
            got = model.decode_next(tok, slot, cache)
            full = torch.cat([ids.repeat_interleave(BEAMS, 0), seqs], 1)
            fmask = torch.cat([mask.repeat_interleave(BEAMS, 0), torch.ones_like(seqs)], 1)
            at = torch.full((B * BEAMS, 1), full.shape[1] - 1)
            want = ref.forward(d, weights, full, fmask, at)[:, 0]
            torch.testing.assert_close(got, want, rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_grouped_experts_equal_the_reference_loop(seed):
    """The MoE layer (two grouped GEMMs over rows sorted by expert, the
    weighted sum, the shared expert) against the reference's loop over the
    experts, on rows whose top-2 and third gate probabilities lie apart."""
    cfg, d, weights, model = _setup(seed=seed)
    moe = model.layers[1].mlp
    x = torch.randn((64, cfg.hidden_size), generator=torch.Generator().manual_seed(seed))
    probs = (x @ moe.gate.weight.t()).softmax(-1).sort(-1, descending=True).values
    x = x[(probs[:, 1] - probs[:, 2]) > 1e-3]
    with torch.no_grad():
        got = moe(x)
    want = ref.moe(d, ref._layer(weights, 1, torch.float32), x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert len(x) > 48


def test_generate_scores_equal_teacher_forcing_and_its_best_the_plain_search():
    cfg, d, weights, model = _setup()
    ids, mask = _prompts()
    codes = _codes()
    tok, score = ds.generate(model, ids, mask, num_beams=BEAMS,
                             constraint=ds.make_constraint(cfg, codes))
    trie = ref.item_trie(codes)
    assert tok.shape == (B, BEAMS, cfg.max_gen_len) and (tok[:, :, 0] == cfg.bos_token_id).all()
    torch.testing.assert_close(score, ref.sequence_scores(d, weights, ids, mask, tok, trie),
                               rtol=0, atol=SCORE_ATOL)
    r_tok, r_score = ref.beam_search(d, weights, ids, mask, BEAMS, trie)
    torch.testing.assert_close(score[:, 0], r_score[:, 0], rtol=0, atol=SCORE_ATOL)
    assert torch.equal(tok[:, 0], r_tok[:, 0])
    items = {tuple(r) for r in (cfg.sid_base + np.arange(4) * cfg.codebook_size + codes).tolist()}
    assert all(tuple(s) in items for s in tok[:, :, 1:].reshape(-1, cfg.code_dim).tolist())


def test_bf16_logits_stay_near_the_float32_reference():
    """At bf16 (the card's dtype) the median logit lies within 3% of the
    logits' spread from the reference's (bf16 rounding gives about 0.8%);
    a routing flip at a near-tie moves a few rows further, so the median."""
    _, d, weights, model = _setup("bfloat16")
    ids, mask = _prompts()
    with torch.no_grad():
        got = model(ids, mask)
    assert got.dtype == torch.bfloat16
    want = ref.forward(d, weights, ids, mask)
    real = mask.bool()
    err = (got.float() - want)[real].abs()
    assert 0 < err.median() < 0.03 * want[real].std()


def test_spans_and_counters_under_a_profiler():
    cfg, _, _, model = _setup()
    ids, mask = _prompts()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        ds.generate(model, ids, mask, num_beams=BEAMS, constraint=ds.make_constraint(cfg, _codes()))
    reg = profiling.recorded()
    moe_passes = 2 * cfg.code_dim  # two MoE layers, prefill and three decode steps
    assert reg["lm.prefill"]["count"] == 1 and reg["mla.decode"]["count"] == 3 * 3
    assert reg["moe.route"]["count"] == reg["moe.experts"]["count"] == moe_passes
    real = int(mask.sum())
    assert reg["moe.rows"]["count"] == 2 * 2 * (real + 3 * B * BEAMS)
    assert 0 < reg["moe.busiest"]["count"] <= reg["moe.rows"]["count"]
    assert reg["mla.cache.positions"]["count"] == 3 * sum(B * L + B * BEAMS * (s + 1)
                                                          for s in range(3))
    profiling.reset()
