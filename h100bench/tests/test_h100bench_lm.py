"""The DeepSeek-V2 cell (``deepseek_v2_lite.recommend_b256``): found by its
files alone, its counts against ``torch``'s FLOP counter, whole runs on the
CPU at a tiny size (hidden 64, 3 layers of 8 experts, a 512-token
vocabulary, float32) that come out correct, and not correct with each
fault of ``faults_lm`` planted, and its readers with nothing to read."""

import ast
import dataclasses
import os
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench import cell as cells, check, check_lm, counts_lm, faults_lm, run
from h100bench.reference import deepseek_v2 as ref

CELL = "deepseek_v2_lite.recommend_b256"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY_CONFIG = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                   moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
                   num_key_value_heads=4, n_shared_experts=1, n_routed_experts=8,
                   num_experts_per_tok=2, kv_lora_rank=16, qk_rope_head_dim=8,
                   qk_nope_head_dim=16, v_head_dim=16, initializer_range=0.2, bos_token_id=0,
                   eos_token_id=1, codebook_size=16, sid_base=512 - 64, dtype="float32")
TINY_TRAFFIC = dict(pool=32, batch=8, num_beams=4, items=200, min_items=2, max_items=7,
                    max_len=4, num_topics=4, instruction_tokens=6, sample_students=4,
                    warmup_batches=1, trace_batches=1)


def _tiny_cell():
    c = cells.find_cell(CELL)
    return dataclasses.replace(c, config=dict(c.config, **TINY_CONFIG),
                               traffic=dict(c.traffic, **TINY_TRAFFIC))


def _line(cell, trace=False, seed=2 ** 31 + 17):
    r = cells.runner(cell.traffic["kind"]).run(cell, seed, 0.2, trace, "cpu", time.perf_counter())
    return run.result_line(cell, r, trace, {"platform": "cpu"}), r


def test_the_cell_is_found_by_its_files():
    c = cells.find_cell(CELL)
    assert c.config["model"] == "deepseek_v2_lite" and c.traffic["kind"] == "recommend_lm"
    assert c.chips == 1 and set(c.limits) == {"score_gap", "score_gap_p75", "best_gap"}
    assert {m["name"] for m in c.end_to_end} == {"recs_per_s", "recommend_ms_p95", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "lm_recommend_mfu", "moe_expert_roofline.recommend_lm", "moe_imbalance.recommend_lm",
        "prefill_ms.recommend_lm", "moe_ms.recommend_lm", "mla_decode_ms.recommend_lm",
        "device_idle_pct.recommend_lm"}


def test_the_configuration_holds_the_published_config():
    cat = {"attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
           "hidden_size": 2048, "intermediate_size": 10944, "kv_lora_rank": 512,
           "max_position_embeddings": 163840, "model_type": "deepseek_v2",
           "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1,
           "n_routed_experts": 64, "n_shared_experts": 2, "norm_topk_prob": False,
           "num_attention_heads": 16, "num_experts_per_tok": 6, "num_hidden_layers": 27,
           "num_key_value_heads": 16, "q_lora_rank": None, "qk_nope_head_dim": 128,
           "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06, "rope_theta": 10000,
           "routed_scaling_factor": 1, "scoring_func": "softmax", "seq_aux": True,
           "tie_word_embeddings": False, "topk_group": 1, "topk_method": "greedy",
           "v_head_dim": 128, "vocab_size": 102400}
    c = cells.find_cell(CELL).config
    assert {k: c[k] for k in cat} == cat and c["reduced"] == []
    assert c["rope_scaling"]["factor"] == 40 and c["sid_base"] + 4 * 256 == c["vocab_size"]
    spec = ref.param_spec(c)
    assert sum(int(torch.tensor(s).prod()) for _, s, _ in spec) == pytest.approx(15.7e9, rel=0.01)


def test_the_new_yardstick_files_import_nothing_of_the_port():
    for rel in ("counts_lm.py", "check_lm.py", "reference/deepseek_v2.py"):
        tree = ast.parse(open(os.path.join(ROOT, "h100bench", rel)).read())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) \
                    else [node.module or ""]
                assert not any(n.split(".")[0] in ("genrec_tpu_torch", "genrec_tpu", "jax")
                               for n in names), (rel, names)


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("length", [3, 6])
def test_counts_agree_with_torchs_flop_counter(length):
    """The reference computes every score of the attention's square and
    masks it; the counts take each causal pair once: the difference is the
    square's upper half, exactly."""
    cfg = dict(cells.find_cell(CELL).config, **TINY_CONFIG)
    w = ref.make_weights(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    nh, per_key = cfg["num_attention_heads"], 2 * (cfg["qk_nope_head_dim"]
                                                  + cfg["qk_rope_head_dim"] + cfg["v_head_dim"])

    def counted(n):
        ids = torch.randint(2, 448, (1, n), generator=torch.Generator().manual_seed(n))
        at = torch.full((1, 1), n - 1)
        return _flops(lambda: ref.forward(cfg, w, ids, torch.ones_like(ids), at))

    def upper(n):
        return cfg["num_hidden_layers"] * nh * per_key * (n * n - n * (n + 1) // 2)

    assert counted(length) == counts_lm.prefill_flops(cfg, [length]) + upper(length)
    # a decode row: the token one more prompt position adds (the head is at
    # the last position in both), and the head at it
    rows = [counted(length + s + 1) - upper(length + s + 1) - counted(length + s)
            + upper(length + s) + counts_lm.head_flops(cfg) for s in range(cfg["code_dim"] - 1)]
    assert counts_lm.decode_flops(cfg, [length], 2) == 2 * sum(rows)


def test_the_expert_bound_takes_the_larger_of_products_and_bytes():
    cfg = cells.find_cell(CELL).config
    rows = 6 * 5120
    flops = 2 * rows * 2048 * 2816
    nbytes = 2 * (64 * 2048 * 2816 + rows * 2048 + rows * 2816)
    assert counts_lm.expert_launch_bound_s(cfg, rows, "gate_up") == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))
    assert counts_lm.batch_expert_launches(cfg) == 26 * 4 * 2


def test_a_tiny_run_is_correct_and_traced():
    line, r = _line(_tiny_cell(), trace=True)
    assert line["correct"], line["check"]
    assert line["check"]["score_gap"]["value"] < 1e-4
    assert line["check"]["score_gap_p75"]["value"] < 1e-4
    # the profiled stretch reads nothing without a card: only the window's rate
    assert set(line["metrics"]) == {"lm_recommend_mfu"}
    assert line["metrics"]["lm_recommend_mfu"]["value"] > 0 and r.window["batches"] >= 1


@pytest.mark.parametrize("shift,rows,fails", [
    (0.1, slice(None), "score_gap_p75"),  # every sequence a little: a precision fault
    (1.0, slice(0, 3), "score_gap"),  # a fifth of them far: a fault at the padding
])
def test_each_score_quantile_fails_its_kind_of_fault(shift, rows, fails):
    r = torch.linspace(-40.0, -20.0, 16 * 20, dtype=torch.float64).view(16, 20)
    p = r.clone()
    p[rows] += shift
    numbers = check_lm.recommendation(p, r, r)
    numbers.pop("_notes")
    correct, shown = check.judge(numbers, cells.find_cell(CELL).limits)
    assert not correct
    assert [n for n, c in shown.items() if c["value"] > c["limit"]] == [fails]


@pytest.mark.parametrize("fault", faults_lm.FAULTS)
def test_each_planted_fault_comes_out_not_correct(fault):
    with faults_lm.planted(fault):
        line, _ = _line(_tiny_cell())
    assert not line["correct"], (fault, line["check"])


def test_readers_return_none_without_their_counters():
    from genrec_tpu_torch.utils import profiling

    profiling.reset()  # the program's registry as a run without a trace leaves it
    c = cells.find_cell(CELL)
    ctx = {"cell": c, "window": {"seconds": 0.0}, "spans": {}, "trace": None, "setup_s": 1.0}
    for m in c.per_layer:
        assert cells.reader(m["name"])(ctx) is None, m["name"]
    ctx["trace"] = {"busy_s": 0.5, "window_s": 1.0, "steps": 1, "ops": {}, "idle": {}}
    for name in ("moe_expert_roofline.recommend_lm", "moe_imbalance.recommend_lm",
                 "prefill_ms.recommend_lm"):
        assert cells.reader(name)(ctx) is None, name
