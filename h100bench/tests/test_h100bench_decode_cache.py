"""The reader of ``decode_cache_hit_pct.recommend`` (the program's counters
``beam.decode.cached`` over ``beam.decode.keys``): 60.0 from a registry
holding both, nothing without them, untraced or from a program that keeps
no such counters, and 60.0 from a traced run of the cell on the CPU; and on
the card, at the cell's own size, that every sequence the incremental
decoder returns scores as the reference's teacher-forced re-decode of its
own tokens."""

import time

import pytest

from h100bench import cell as cells, program_spans, run

SERVE = "tiger.recommend_b4096"
NAME = "decode_cache_hit_pct.recommend"


def _entry(count):
    return {"count": count, "seconds": 0.0, "max_s": 0.0, "drained": 0}


# 16 batches, 4 decode steps, 2 decoder layers: 16 · (1 + 2 + 3 + 4) · 2 keys
FILLED = {"generate.encode": {"count": 16, "seconds": 0.08, "max_s": 0.01, "drained": 0},
          "beam.decode.keys": _entry(320), "beam.decode.cached": _entry(192)}


def _ctx(trace=True):
    return {"cell": None, "window": {}, "spans": {}, "setup_s": 1.0,
            "trace": {"steps": 16, "busy_s": 1.0, "window_s": 1.0} if trace else None}


@pytest.fixture
def profiling():
    from genrec_tpu_torch.utils import profiling

    profiling.reset()
    yield profiling
    profiling.reset()


def test_the_metric_is_declared_for_the_recommendation_cell():
    declared = {m["name"]: m for m in cells.load_benchmark()["per_layer"]}
    m = declared[NAME]
    assert m["workloads"] == [SERVE] and m["source"] == "host_clock"
    assert m["moves"] == "recs_per_s" and m["layer"] == "generate and beam search"
    assert NAME in {x["name"] for x in cells.find_cell(SERVE).per_layer}


def test_the_reader_reads_cached_over_keys(profiling, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: dict(FILLED))
    assert cells.reader(NAME)(_ctx()) == pytest.approx(60.0)


@pytest.mark.parametrize("left_out", [("beam.decode.keys", "beam.decode.cached"),
                                      ("beam.decode.keys",), ("beam.decode.cached",)])
def test_the_reader_reads_nothing_without_the_counters(left_out, profiling, monkeypatch):
    monkeypatch.setattr(profiling, "recorded",
                        lambda: {k: v for k, v in FILLED.items() if k not in left_out})
    assert cells.reader(NAME)(_ctx()) is None


def test_the_reader_reads_nothing_untraced_or_without_the_registry(profiling, monkeypatch):
    read = cells.reader(NAME)
    monkeypatch.setattr(profiling, "recorded", lambda: dict(FILLED))
    assert read(_ctx(trace=False)) is None
    monkeypatch.delattr(profiling, "recorded")
    assert read(_ctx()) is None
    monkeypatch.delitem(__import__("sys").modules, program_spans.MODULE)
    assert read(_ctx()) is None


def test_a_traced_run_reads_six_of_ten(tiny, profiling):
    cell, r = run.run_cell(SERVE, 2 ** 31 + 29, 0.3, True, "cpu", time.perf_counter(),
                           tiny[SERVE])
    ctx = {"cell": cell, "window": r.window, "spans": r.spans, "setup_s": r.setup_s,
           "trace": {"steps": tiny[SERVE]["trace_batches"]}}
    assert cells.reader(NAME)(ctx) == pytest.approx(60.0)
    reg = profiling.recorded()
    layers = cell.config["arch"]["num_decoder_layers"]
    assert reg["beam.decode.keys"]["count"] == 10 * layers * reg["generate.encode"]["count"]


@pytest.mark.card
def test_every_sequence_at_the_cells_size_scores_as_its_re_decode(card):
    """4,096 students × 20 beams under the trie at ``TIGERConfig()``: each
    returned sequence's score within 2e-4 (the cell's ``score_gap`` limit)
    of the reference's teacher-forced score of its own tokens."""
    import torch

    from genrec_tpu_torch.models.tiger import generate, make_constraint
    from h100bench import corpus
    from h100bench.reference import model as ref
    from h100bench.runners import free, program_config, program_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    seed = 2 ** 31 + 23
    cell = cells.find_cell(SERVE)
    cfg, t = cell.config, cell.traffic
    B, K = t["batch"], t["num_beams"]
    hist, codes = corpus.serving_histories(seed, cfg, t)
    weights = corpus.make_weights(seed, ref.param_spec(cfg), card)
    pcfg = program_config(cfg, B, "")
    model = program_model(cfg, pcfg, weights, card).eval()
    constraint = make_constraint(pcfg, codes[1:]).to(card)
    batch = {k: torch.as_tensor(v[:B]).to(card) for k, v in hist.items()}
    toks, scores = generate(model, batch["input_ids"], batch["attention_mask"], num_beams=K,
                            constraint=constraint)
    del model, constraint
    free(card)
    trie = ref.trie_tables(codes[1:], cfg["arch"]["vocab_size"], cfg["codebook_size"], card)
    want = ref.sequence_scores(cfg, weights, batch, toks, trie)
    assert toks.shape == (B, K, cfg["max_gen_len"])
    assert bool((scores > -1e29).all()), "a sequence left the trie"
    gap = float((scores.double() - want.double()).abs().max())
    print(f"score gap over {B * K} sequences: {gap:.3e}")
    assert gap < 2e-4
