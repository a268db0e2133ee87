"""Incremental decoding: ``models/t5.py``'s ``DecodeCache``, ``start_decode``
and ``decode_next`` (the decoder over one new position a step, the earlier
positions' self-attention K/V from the cache) and ``ops/beam_search.py``'s
``reorder`` callback, against the port's own teacher-forced ``decode`` over
the whole prefix, which is the mathematics the cache must keep.

TIGER (``TIGERConfig()``: 2 decoder layers, 4 heads) and TIGER-prefix
(``TIGERPrefixConfig()``: 4 decoder layers, 8 heads), random weights from a
seeded generator, 3 students × 4 beams, one history full and one of a single
token. Between steps the cache is reordered by parents that repeat and are
not the identity, and the token rows follow them, as in beam search; one
beam emits eos and pads after it. f32: the logits within 1e-5 (they are of
order 1-6; the two routes differ only in the order of f32 sums, 1.7e-6 at
most here). bf16: within 2⁻⁸ (bf16's unit roundoff) of the largest |logit|.
On the CPU the two routes give equal logits; the teacher-forced one runs
kernel #1's plain bf16 version over all positions and the cached one
``dot_product_attention`` over one, so where the GEMMs sum in another order
a bf16-rounded projection output can land one rounding apart.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from genrec_tpu_torch import configs
from genrec_tpu_torch.data.synthetic import make_codes
from genrec_tpu_torch.models import tiger_prefix as tp
from genrec_tpu_torch.models.tiger import TIGER, generate, make_constraint
from genrec_tpu_torch.ops.beam_search import beam_search
from genrec_tpu_torch.utils import profiling

B, K = 3, 4
F32_ATOL = 1e-5
BF16_REL = 2.0 ** -8


def _model(kind: str, dtype: str = "float32"):
    gen = torch.Generator().manual_seed(0)
    if kind == "tiger":
        cfg = configs.TIGERConfig(arch=configs.T5ArchConfig(dtype=dtype),
                                  constrained_decoding="trie")
        return cfg, TIGER(cfg, generator=gen).eval()
    base = configs.TIGERPrefixConfig()
    cfg = dataclasses.replace(base, arch=dataclasses.replace(base.arch, dtype=dtype))
    return cfg, tp.TIGERPrefix(cfg, generator=gen).eval()


def _inputs(kind: str, cfg, seed: int = 0):
    """(input_ids, attention_mask, prof vectors or ()): row 0 a full
    history, row 2 a single token."""
    r = np.random.default_rng(seed)
    seq = cfg.max_len * cfg.code_dim
    ids = torch.from_numpy(r.integers(1, 33, size=(B, seq)))
    mask = (torch.arange(seq)[None, :] >= torch.tensor([0, seq // 3, seq - 1])[:, None]).long()
    prof = () if kind == "tiger" else tuple(
        torch.from_numpy(r.normal(0, 0.5, size=(B, 5, cfg.bert_dim)).astype(np.float32))
        for _ in range(3))
    return ids, mask, prof


def _encoded(kind: str, cfg, model):
    ids, mask, prof = _inputs(kind, cfg)
    if kind == "tiger":
        return model.encode(ids, mask), mask
    return model.encode_with_prefix(ids, mask, *prof)


def _parents(r, step: int) -> torch.Tensor:
    """Flat parents b·K + beam: beams 0 and 1 both take beam 0 (repeated),
    beam 2 takes the last (never the identity), beam 3 any."""
    beams = r.integers(0, K, size=(B, K))
    beams[:, :2], beams[:, 2] = 0, K - 1 - step % 2
    return torch.from_numpy((np.arange(B)[:, None] * K + beams).reshape(-1))


def _walk(kind: str, dtype: str):
    """Each step's cached logits beside the teacher-forced ones at the last
    position, over a beam-search-like walk of reorders."""
    cfg, model = _model(kind, dtype)
    a, steps = cfg.arch, cfg.max_gen_len - 1
    r = np.random.default_rng(1)
    out = []
    with torch.no_grad():
        enc, mask = _encoded(kind, cfg, model)
        t5 = model.model
        cache = t5.start_decode(t5.precompute_cross_kv(enc), mask, K, steps)
        enc_rows, mask_rows = enc.repeat_interleave(K, 0), mask.repeat_interleave(K, 0)
        tokens = torch.full((B * K, cfg.max_gen_len), a.pad_token_id, dtype=torch.int64)
        tokens[:, 0] = a.decoder_start_token_id
        for step in range(steps):
            got = t5.decode_next(tokens[:, step], step, cache)
            want = t5.decode(tokens[:, :step + 1], enc_rows, mask_rows)[:, -1]
            out.append((got, want, tokens[:, :step + 1].clone()))
            parents = _parents(r, step)
            cache.reorder(parents)
            tokens = tokens[parents]
            new = torch.from_numpy(r.integers(1, 33, size=B * K))
            if step == 0:
                new[::K] = a.eos_token_id  # beam 0 of each student emits eos ...
            frozen = (tokens[:, 1:step + 1] == a.eos_token_id).any(dim=1)
            new[frozen] = a.pad_token_id  # ... then pads
            tokens[:, step + 1] = new
    return out


@pytest.mark.parametrize("kind", ["tiger", "tiger_prefix"])
def test_each_cached_step_equals_the_teacher_forced_last_position_f32(kind):
    walk = _walk(kind, "float32")
    for step, (got, want, seen) in enumerate(walk):
        assert got.shape == want.shape == (B * K, 64)
        torch.testing.assert_close(got, want, rtol=0, atol=F32_ATOL, msg=f"step {step}")
    # the walk reached an eos followed by pads, on rows the reorders kept
    eos = configs.T5ArchConfig().eos_token_id
    last = walk[-1][2]
    assert ((last[:, 1] == eos) & (last[:, 2:] == 0).all(dim=1)).sum() >= B


@pytest.mark.parametrize("kind", ["tiger", "tiger_prefix"])
def test_each_cached_step_equals_the_teacher_forced_last_position_bf16(kind):
    for step, (got, want, _) in enumerate(_walk(kind, "bfloat16")):
        assert got.dtype == want.dtype == torch.float32  # the logits multiply in f32
        err = (got - want).abs().max().item()
        assert err <= BF16_REL * want.abs().max().item(), (step, err)


def test_decode_step_feeds_the_prefix_through_the_cache():
    """``decode_step`` over a prefix equals the teacher-forced last position."""
    cfg, model = _model("tiger")
    with torch.no_grad():
        enc, mask = _encoded("tiger", cfg, model)
        prefix = torch.from_numpy(np.random.default_rng(2).integers(1, 33, size=(B * K, 4)))
        prefix[:, 0] = 0
        got = model.decode_step(prefix, model.precompute_cross_kv(enc), mask, K)
        want = model.decode(prefix, enc.repeat_interleave(K, 0), mask.repeat_interleave(K, 0))
    torch.testing.assert_close(got, want[:, -1], rtol=0, atol=F32_ATOL)


def test_reorder_gathers_the_written_positions_into_the_spare():
    """After ``filled`` positions, ``reorder`` gathers those positions of
    every layer's K and V by the parents into the spare buffer, which
    becomes ``kv``; the positions not yet written are left alone."""
    cfg, model = _model("tiger")
    with torch.no_grad():
        enc, mask = _encoded("tiger", cfg, model)
        t5 = model.model
        cache = t5.start_decode(t5.precompute_cross_kv(enc), mask, K, cfg.max_gen_len - 1)
        tokens = torch.from_numpy(np.random.default_rng(3).integers(1, 33, size=(B * K, 2)))
        for step in range(2):
            t5.decode_next(tokens[:, step], step, cache)
    assert cache.filled == 2
    old_kv, old_spare = cache.kv, cache.spare
    old_spare[..., 2:, :] = 7.0
    parents = torch.tensor([1, 1, 0, 3, 4, 4, 4, 5, 11, 8, 8, 9])
    want = old_kv[..., :2, :].index_select(2, parents)
    cache.reorder(parents)
    assert cache.kv is old_spare and cache.spare is old_kv
    assert torch.equal(cache.kv[..., :2, :], want)
    assert (cache.kv[..., 2:, :] == 7.0).all()


@pytest.fixture
def registry():
    profiling.reset()
    yield profiling
    profiling.reset()


@pytest.mark.parametrize("kind", ["tiger", "tiger_prefix"])
def test_the_counters_read_cached_over_attended_keys_per_layer(kind, registry):
    """0 of 1 key position per layer at step 0; 6 of 10 over max_gen_len 5
    (1 + 2 + 3 + 4 attended, 0 + 1 + 2 + 3 from the cache); no entry
    without a recording profiler."""
    cfg, model = _model(kind)
    layers, steps = cfg.arch.num_decoder_layers, cfg.max_gen_len - 1
    with torch.no_grad():
        enc, mask = _encoded(kind, cfg, model)
        t5 = model.model
        cache = t5.start_decode(t5.precompute_cross_kv(enc), mask, K, steps)
        tokens = torch.zeros((B * K, cfg.max_gen_len), dtype=torch.int64)
        t5.decode_next(tokens[:, 0], 0, cache)
        assert registry.recorded() == {}
        with profile(activities=[ProfilerActivity.CPU]):
            t5.decode_next(tokens[:, 0], 0, cache)
            first = registry.recorded()
            for step in range(1, steps):
                t5.decode_next(tokens[:, step], step, cache)
    assert first["beam.decode.cached"]["count"] == 0
    assert first["beam.decode.keys"]["count"] == layers
    got = registry.recorded()
    assert got["beam.decode.cached"]["count"] == 6 * layers
    assert got["beam.decode.keys"]["count"] == 10 * layers
    assert got["beam.decode.keys"]["seconds"] == got["beam.decode.cached"]["seconds"] == 0


def _plain_search(kind: str, cfg, model, constraint):
    """Beam search over the teacher-forced decoder re-run on the whole prefix
    at every step, with no cache and no reorder."""
    a = cfg.arch
    ids, mask, prof = _inputs(kind, cfg)
    with torch.no_grad():
        if kind == "tiger":
            enc = model.encode(ids, mask)
        else:
            enc, mask = model.encode_with_prefix(ids, mask, *prof)
        enc_rows, mask_rows = enc.repeat_interleave(K, 0), mask.repeat_interleave(K, 0)

        def decode_fn(tokens, step):
            return model.model.decode(tokens[:, :step + 1], enc_rows, mask_rows)[:, -1]

        return beam_search(decode_fn, B, K, cfg.max_gen_len, a.vocab_size,
                           decoder_start=a.decoder_start_token_id, pad_token=a.pad_token_id,
                           eos_token=a.eos_token_id, constraint=constraint, device="cpu")


@pytest.mark.parametrize("kind", ["tiger", "tiger_prefix"])
def test_generate_equals_the_search_over_the_prefix_re_run(kind):
    cfg, model = _model(kind)
    constraint = make_constraint(cfg, make_codes(60)) if kind == "tiger" else None
    ids, mask, prof = _inputs(kind, cfg)
    if kind == "tiger":
        got = generate(model, ids, mask, num_beams=K, constraint=constraint)
    else:
        got = tp.generate(model, ids, mask, *prof, num_beams=K)
    want = _plain_search(kind, cfg, model, constraint)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=F32_ATOL)


V, MAX_LEN, EOS = 64, 5, 31


@pytest.mark.parametrize("mode", ["none", "trie"])
@pytest.mark.parametrize("eos", [None, EOS])
def test_reorder_lets_per_row_state_follow_its_beam(mode, eos):
    """A ``decode_fn`` that keeps each row's running token sum as its own
    state, moved by ``reorder``, searches exactly as one that sums the
    token buffer's prefix afresh at every step; ``reorder`` is called after
    every step but the last, with one flat parent per beam inside its own
    sample."""
    r = np.random.default_rng(0)
    step_tab = torch.from_numpy(r.normal(scale=2.0, size=(MAX_LEN - 1, V, V)).astype(np.float32))
    prefix_tab = torch.from_numpy(r.normal(scale=0.5, size=(V, V)).astype(np.float32))
    step_tab[1, :, EOS] += 6.0  # eos likely at the second step
    n, beams = 3, 12
    constraint = make_constraint(configs.TIGERConfig(constrained_decoding=mode), make_codes(60))
    kw = dict(decoder_start=0, pad_token=0, eos_token=eos, constraint=constraint, device="cpu")

    def fresh(tokens, step):
        return step_tab[step][tokens[:, step]] + prefix_tab[tokens[:, :step + 1].sum(-1) % V]

    state, calls = [torch.zeros(n * beams, dtype=torch.int64)], []

    def cached(tokens, step):
        state[0] = state[0] + tokens[:, step]
        return step_tab[step][tokens[:, step]] + prefix_tab[state[0] % V]

    def reorder(parents):
        calls.append(parents)
        state[0] = state[0][parents]

    want = beam_search(fresh, n, beams, MAX_LEN, V, **kw)
    got = beam_search(cached, n, beams, MAX_LEN, V, reorder=reorder, **kw)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    assert len(calls) == MAX_LEN - 2
    for parents in calls:
        assert parents.shape == (n * beams,)
        assert (parents // beams == torch.arange(n * beams) // beams).all()
