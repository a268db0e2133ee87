"""The yardstick's counts on known shapes."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench import cell as cells, corpus, counts, readings
from h100bench.reference import model as ref


def test_attention_bound_counts_each_argument_once():
    site = dict(hb=8, h=2, b=4, lq=3, lk=5, d=16, pos_bias=True, kv_mask=True, dropout=True)
    f = 4
    fwd_bytes = (8 * 3 * 16 + 2 * 8 * 5 * 16) * f + 2 * 3 * 5 * f + 4 * 5 * f + 8 * 3 * 5 * f \
        + 8 * 3 * 16 * f
    assert counts.attention_bound_s(site, False) == pytest.approx(
        max(fwd_bytes / counts.HBM_BYTES_PER_S, 4 * 8 * 3 * 5 * 16 / counts.TF32_FLOPS))
    bwd_bytes = fwd_bytes + (8 * 3 * 16 + 2 * 8 * 5 * 16) * f + 2 * 3 * 5 * f
    assert counts.attention_bound_s(site, True) == pytest.approx(
        max(bwd_bytes / counts.HBM_BYTES_PER_S, 10 * 8 * 3 * 5 * 16 / counts.TF32_FLOPS))
    big = dict(site, hb=8 * 1024, b=4 * 1024, lq=156, lk=156, d=128, dropout=False)
    flops = 4 * big["hb"] * 156 * 156 * 128
    assert counts.attention_bound_s(big, False) >= flops / counts.TF32_FLOPS


def test_training_sites_are_the_launches_of_a_step():
    cfg = cells.find_cell("tiger_prefix.train_b1024").config
    sites = counts.attention_sites(cfg, 1024, 83, 156, dropout=True)
    assert len(sites) == 2 + 2 * 4  # #1 and #2 ten times a step, as the smoke counts
    assert sum(s["pos_bias"] for s in sites) == 6  # six dbias reductions


def test_the_roofline_share_is_100_when_the_kernels_take_the_bound():
    c = cells.find_cell("tiger.recommend_b4096")
    sites = counts.attention_sites(c.config, 4096, 80, 0, dropout=False, decoder=False)
    bound = sum(counts.attention_bound_s(s, False) for s in sites)
    tr = {"steps": 3, "launches": [6, 0, 0],
          "ops": {"t5_attention_fwd_kernel<2>": 3 * bound, "gemm": 1.0}}
    ctx = {"cell": c, "trace": tr}
    assert readings.t5_roofline(ctx, backward=False) == pytest.approx(100.0)
    tr["ops"]["t5_attention_fwd_kernel<2>"] *= 4
    assert readings.t5_roofline(ctx, backward=False) == pytest.approx(25.0)
    tr["launches"] = [5, 0, 0]  # not the launches the shapes call for: nothing to read
    assert readings.t5_roofline(ctx, backward=False) is None


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_forward_flops_equal_a_count_of_the_reference_on_real_tokens():
    """With no padding, the model FLOPs are the reference forward's matrix
    products, less the upper half of the causal self-attention (counted
    once) and less nothing else."""
    cfg = cells.find_cell("tiger_prefix.train_b1024").config
    a = cfg["arch"]
    B, L, T = 2, cfg["max_len"] * cfg["code_dim"], 12
    p = corpus.make_weights(1, ref.param_spec(cfg), "cpu")
    batch = {"input_ids": torch.randint(1, 33, (B, L), dtype=torch.int32),
             "attention_mask": torch.ones(B, L, dtype=torch.int32),
             "labels": torch.randint(1, 33, (B, T), dtype=torch.int32),
             "valid": torch.ones(B, dtype=torch.bool)}
    for i in (1, 2, 3):
        batch[f"prof_lvl{i}"] = torch.randn(B, cfg["num_prof_vectors"], cfg["bert_dim"])
    got = _counted(lambda: ref.loss(ref.Precision(), cfg, p, batch, None))
    inner = a["num_heads"] * a["d_kv"]
    causal_upper = a["num_decoder_layers"] * 4 * inner * (T * T - T * (T + 1) / 2) * B
    want = counts.forward_flops(cfg, np.full(B, L), np.full(B, T))
    assert want == pytest.approx(got - causal_upper, rel=1e-12)
    assert counts.train_step_flops(cfg, {k: v.numpy() for k, v in batch.items()}) == \
        pytest.approx(3 * want)


def test_padding_is_not_counted():
    cfg = cells.find_cell("tiger.recommend_b4096").config
    full = counts.recommend_flops(cfg, np.array([80, 80]), 20)
    half = counts.recommend_flops(cfg, np.array([80, 40]), 20)
    assert half < full
    assert counts.forward_flops(cfg, np.array([0]), np.array([0])) == 0.0
