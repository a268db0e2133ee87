"""The readers of the program's own spans (``program_spans`` and its
``metrics/*``): nothing untraced or without the registry, the right value a
step or a batch from a registry the test fills (a retried stretch
included), every reader filled by a traced run of each cell on the CPU; and
on the card, that every synchronising call of a streamed step and of a
batch falls inside a span named ``*.wait``."""

import sys
import time
import traceback
import warnings

import pytest

from h100bench import cell as cells, program_spans, run

TRAIN = "tiger_prefix.train_b1024"
SERVE = "tiger.recommend_b4096"
TRAIN_METRICS = {"fetch_ms.train": 22.0, "upload_ms.train": 30.0, "stage_ms.train": 10.0,
                 "forward_ms.train": 100.0, "backward_ms.train": 50.0,
                 "optimizer_ms.train": 20.0, "host_wait_ms.train": 5.0,
                 "host_paced_pct.train": 25.0}
SERVE_METRICS = {"encode_ms.recommend": 10.0, "search_ms.recommend": 40.0,
                 "decode_ms.recommend": 20.0, "select_ms.recommend": 10.0,
                 "host_wait_ms.recommend": 1.0, "host_paced_pct.recommend": 25.0}
METRICS = {**TRAIN_METRICS, **SERVE_METRICS}


def _entry(count, seconds, drained=0):
    return {"count": count, "seconds": seconds, "max_s": seconds / count, "drained": drained}


# a 10-step stretch and a 16-batch one, each retried once: the counts doubled
FILLED = {
    TRAIN: {"train.fetch": _entry(22, 0.44), "train.upload": _entry(20, 0.6),
            "train.upload.wait": _entry(18, 0.1), "train.upload.stage": _entry(20, 0.2),
            "train.forward": _entry(20, 2.0, drained=5), "train.backward": _entry(20, 1.0),
            "train.optimizer": _entry(20, 0.4)},
    SERVE: {"generate.encode": _entry(32, 0.32), "beam.search": _entry(32, 1.28),
            "beam.search.wait": _entry(32, 0.032), "beam.decode": _entry(128, 0.64, drained=32),
            "beam.select": _entry(128, 0.32)},
}


def _filled(name):
    return dict(FILLED[TRAIN if name in TRAIN_METRICS else SERVE])


def _ctx(trace=True):
    return {"cell": None, "window": {}, "spans": {}, "setup_s": 1.0,
            "trace": {"steps": 10, "busy_s": 1.0, "window_s": 1.0} if trace else None}


@pytest.fixture
def profiling():
    from genrec_tpu_torch.utils import profiling

    profiling.reset()
    yield profiling
    profiling.reset()


def test_the_metrics_are_declared_for_their_one_cell():
    bench = cells.load_benchmark()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in METRICS:
        cell = TRAIN if name in TRAIN_METRICS else SERVE
        m = declared[name]
        assert m["workloads"] == [cell] and m["source"] == "host_clock"
        assert m["moves"] == ("train_examples_per_s" if cell == TRAIN else "recs_per_s")
        assert name in {x["name"] for x in cells.find_cell(cell).per_layer}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_a_reader_reads_nothing_untraced_or_without_the_registry(name, profiling, monkeypatch):
    read = cells.reader(name)
    monkeypatch.setattr(profiling, "recorded", lambda: _filled(name))
    assert read(_ctx(trace=False)) is None
    monkeypatch.setattr(profiling, "recorded", lambda: {})
    assert read(_ctx()) is None  # a run whose spans never ran
    monkeypatch.delattr(profiling, "recorded")
    assert read(_ctx()) is None  # a program without the registry
    monkeypatch.delitem(sys.modules, program_spans.MODULE)
    assert read(_ctx()) is None  # nor the module


@pytest.mark.parametrize("name", sorted(METRICS))
def test_a_reader_divides_by_the_steps_or_batches_recorded(name, profiling, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: _filled(name))
    assert cells.reader(name)(_ctx()) == pytest.approx(METRICS[name])


@pytest.mark.parametrize("name", ["host_wait_ms.train", "host_wait_ms.recommend"])
def test_no_wait_recorded_reads_zero(name, profiling, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: {
        k: v for k, v in _filled(name).items() if not k.endswith(".wait")})
    assert cells.reader(name)(_ctx()) == 0.0


@pytest.mark.parametrize("name", [TRAIN, SERVE])
def test_a_traced_run_fills_every_reader(name, tiny, profiling):
    """On the CPU the stretch holds no device time (so the trace reads None
    and is tried three times): the registry still fills, and each reader,
    given a trace, reads a value (but the pinned fill's, which only the
    card's route makes); the spans nest as the program nests them."""
    cell, r = run.run_cell(name, 2 ** 31 + 17, 0.3, True, "cpu", time.perf_counter(), tiny[name])
    reg = profiling.recorded()
    per = tiny[name]["trace_steps" if name == TRAIN else "trace_batches"]
    unit = program_spans.TRAIN_UNIT if name == TRAIN else program_spans.RECOMMEND_UNIT
    assert reg[unit]["count"] == 3 * per
    ctx = {"cell": cell, "window": r.window, "spans": r.spans, "setup_s": r.setup_s,
           "trace": {"steps": per}}
    values = {m["name"]: cells.reader(m["name"])(ctx) for m in cell.per_layer
              if m["name"] in METRICS}
    assert set(values) == set(TRAIN_METRICS if name == TRAIN else SERVE_METRICS)
    if name == TRAIN:
        assert values.pop("stage_ms.train") is None  # the CPU route stages nothing
        assert values["host_paced_pct.train"] == 0  # no card
    assert all(v is not None and v >= 0 for v in values.values()), values
    wait = "host_wait_ms.train" if name == TRAIN else "host_wait_ms.recommend"
    assert values[wait] == 0  # the host waits on nothing on the CPU
    if name == SERVE:
        assert values["decode_ms.recommend"] + values["select_ms.recommend"] \
            <= values["search_ms.recommend"]
        assert reg["beam.decode"]["count"] == (cell.config["max_gen_len"] - 1) * 3 * per


def _synchronising_calls(work, profiling):
    """The open spans at each synchronising CUDA call that ``work`` makes,
    under the profiler and ``torch.cuda.set_sync_debug_mode("warn")``, each
    with the frames that made it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seen, working = [], [False]

    def hook(message, category, filename, lineno, file=None, line=None):
        if working[0] and "synchronizing" in str(message):
            where = [f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno} {f.name}"
                     for f in traceback.extract_stack()[-6:-1]]
            seen.append((profiling.open_spans(), where, str(message)))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            working[0] = True  # what the mode's own switch reports is not the work's
            try:
                work()
            finally:
                working[0] = False
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    return seen


@pytest.mark.card
def test_every_host_wait_on_the_card_is_a_wait_span(card, profiling):
    import torch

    from genrec_tpu_torch.data import datasets
    from genrec_tpu_torch.models.tiger import generate, make_constraint
    from genrec_tpu_torch.pipelines.tiger_prefix_pipeline import loss_fn
    from genrec_tpu_torch.train.trainer import Trainer
    from h100bench import corpus
    from h100bench.reference import model as ref
    from h100bench.runners import program_config, program_model
    from h100bench.runners import train as train_runner

    seed = 2 ** 31 + 5
    cell = cells.find_cell(TRAIN)
    cfg, t = cell.config, cell.traffic
    arrays, weights, gen_seed, shuffle = train_runner.inputs(cell, seed, card)
    n, B = len(arrays["input_ids"]), t["batch"]
    pcfg = program_config(cfg, B, "")
    trainer = Trainer(pcfg.trainer, model=program_model(cfg, pcfg, weights, card),
                      loss_fn=loss_fn, steps_per_epoch=-(-n // B), device=card)
    gen = torch.Generator(device=card).manual_seed(gen_seed)
    stream = trainer._epoch_batches(
        1, lambda e: datasets.iterate_batches(arrays, B, shuffle=True, seed=shuffle + e))

    def step():
        batch, _ = next(stream)
        trainer.train_step(batch, gen)

    for _ in range(3):  # kernels built, both upload slots used once
        step()
    train_calls = _synchronising_calls(step, profiling)
    assert profiling.recorded()["train.forward"]["count"] == 1
    del trainer, stream

    cell = cells.find_cell(SERVE)
    cfg, t = cell.config, cell.traffic
    hist, codes = corpus.serving_histories(seed, cfg, t)
    weights = corpus.make_weights(seed, ref.param_spec(cfg), card)
    pcfg = program_config(cfg, t["batch"], "")
    model = program_model(cfg, pcfg, weights, card).eval()
    constraint = make_constraint(pcfg, codes[1:]).to(card)
    ids = torch.as_tensor(hist["input_ids"][:t["batch"]]).to(card)
    mask = torch.as_tensor(hist["attention_mask"][:t["batch"]]).to(card)

    def batch():
        generate(model, ids, mask, num_beams=t["num_beams"], constraint=constraint)

    batch()
    serve_calls = _synchronising_calls(batch, profiling)
    assert profiling.recorded()["generate.encode"]["count"] == 1

    calls = train_calls + serve_calls
    assert calls, "no synchronising call was reported"
    outside = [c for c in calls if not (c[0] and c[0][-1].endswith(".wait"))]
    assert not outside, outside
