"""The port's ``utils/profiling.py`` and the Trainer's ``profile_dir``, after
``genrec_tpu/utils/profiling.py`` and ``genrec_tpu/train/trainer.py``'s
hook: ``trace`` writing a Chrome-trace file that holds an ``annotate`` range,
the Trainer tracing only epoch ``min(first epoch of the fit + 1, epochs)``,
on resume too; and the port's own spans: off (a shared no-op, no range, no
registry entry) without a recording profiler, on under one (nested ranges in
the trace, counts and host seconds in the registry), one of each of the
Trainer's spans per streamed step and beam search's per decode step (no
``*.wait`` span on the CPU, where the host waits on nothing), and
generation's results unchanged by them.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import pytest
import torch

ARCH = dict(vocab_size=64, num_layers=1, num_decoder_layers=1, d_model=16, d_ff=32,
            num_heads=2, d_kv=8, dropout_rate=0.0)


def _trace_names(log_dir):
    """The event names of each trace file in ``log_dir``, oldest first."""
    files = sorted(glob.glob(os.path.join(log_dir, "*.pt.trace.json")), key=os.path.getmtime)
    out = []
    for f in files:
        with open(f) as fh:
            out.append([e.get("name", "") for e in json.load(fh)["traceEvents"]])
    return out


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    from genrec_tpu_torch.utils.profiling import annotate, trace

    with trace(str(tmp_path / "t"), create_perfetto_link=True):
        with annotate("port-annotation"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (names,) = _trace_names(tmp_path / "t")
    assert "port-annotation" in names
    assert any("mm" in n for n in names)


def _tiger_trainer(tmp_path, **kw):
    from genrec_tpu_torch import configs
    from genrec_tpu_torch.data import datasets, synthetic, tiger_tokens
    from genrec_tpu_torch.pipelines import tiger_pipeline

    corpus = synthetic.make_interactions(num_users=20, num_items=20, min_len=4, max_len=6,
                                         seed=1)
    tr, te = tiger_tokens.build_tiger_splits(corpus.item_id_lists, corpus.user_ids,
                                             synthetic.make_codes(20, seed=1))
    trainer = dict(dict(batch_size=32, eval_batch_size=32, ckpt_dir=str(tmp_path / "ck"),
                        profile_dir=str(tmp_path / "prof"), seed=0), **kw)
    cfg = configs.TIGERConfig(arch=configs.T5ArchConfig(**ARCH), max_len=3,
                              trainer=configs.TrainerConfig(**trainer))
    return tiger_pipeline.build_trainer(cfg, datasets.build_tiger_arrays(tr, 3, 4),
                                        datasets.build_tiger_arrays(te, 3, 4,
                                                                    max_target_items=1), "cpu")


def _epochs_traced(log_dir):
    return [sorted(n for n in names if n.startswith("train epoch ")) for names in
            _trace_names(log_dir)]


@pytest.mark.parametrize("epochs,resume_to,want", [
    (3, None, [["train epoch 2"]]),                     # the second epoch only
    (1, None, [["train epoch 1"]]),                     # one epoch: that one
    (2, 4, [["train epoch 2"], ["train epoch 4"]]),     # resumed at 3: its second, 4
])
def test_trainer_profiles_only_the_epoch_after_the_first(tmp_path, epochs, resume_to, want):
    """One trace file per fit, holding one epoch's range: the second epoch
    the fit runs, or its only one; the trace holds that epoch's train steps
    (their ``aten::`` calls)."""
    result = _tiger_trainer(tmp_path, epochs=epochs).fit()
    assert result.epochs_run == epochs
    if resume_to is not None:
        again = _tiger_trainer(tmp_path, epochs=resume_to, resume=True).fit()
        assert again.epochs_run == resume_to and len(again.train_losses) == resume_to - epochs
    assert _epochs_traced(tmp_path / "prof") == want
    for names in _trace_names(tmp_path / "prof"):
        assert any(n.startswith("aten::") for n in names)


def test_no_trace_without_profile_dir(tmp_path):
    _tiger_trainer(tmp_path, epochs=2, profile_dir=None).fit()
    assert not os.path.exists(tmp_path / "prof")


@pytest.fixture
def registry():
    from genrec_tpu_torch.utils import profiling

    profiling.reset()
    yield profiling
    profiling.reset()


def _chrome_events(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def test_a_span_without_a_profiler_is_a_shared_no_op(registry, monkeypatch):
    def no_range(name):
        raise AssertionError(f"a range was opened for {name}")

    monkeypatch.setattr(registry, "record_function", no_range)
    assert registry.span("a") is registry.span("b")
    with registry.span("a"):
        assert registry.open_spans() == []
        torch.ones(4) + 1
    assert registry.recorded() == {}


def test_nested_spans_under_the_profiler(registry, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with registry.span("outer"):
                torch.ones(64, 64) @ torch.ones(64, 64)
                with registry.span("outer.inner"):
                    assert registry.open_spans() == ["outer", "outer.inner"]
                    torch.ones(64, 64) @ torch.ones(64, 64)
    assert registry.open_spans() == []
    events = _chrome_events(prof, tmp_path)
    outer = [e for e in events if e["name"] == "outer"]
    inner = [e for e in events if e["name"] == "outer.inner"]
    assert len(outer) == len(inner) == 2
    for o, i in zip(sorted(outer, key=lambda e: e["ts"]), sorted(inner, key=lambda e: e["ts"])):
        assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    got = registry.recorded()
    assert set(got) == {"outer", "outer.inner"}
    assert got["outer"]["count"] == got["outer.inner"]["count"] == 2
    assert got["outer"]["seconds"] >= got["outer.inner"]["seconds"] > 0
    assert got["outer"]["seconds"] >= got["outer"]["max_s"] >= got["outer"]["seconds"] / 2
    assert got["outer"]["drained"] == 0  # no card
    got["outer"]["count"] = 99  # a copy
    assert registry.recorded()["outer"]["count"] == 2
    registry.reset()
    assert registry.recorded() == {}


def test_a_span_that_raises_is_closed_and_counted(registry):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with registry.span("fails"):
                raise ValueError("inside")
        assert registry.open_spans() == []
    assert registry.recorded()["fails"]["count"] == 1


def test_trace_switches_the_spans_on_only_inside(registry, tmp_path):
    from genrec_tpu_torch.utils.profiling import trace

    with registry.span("before"):
        with trace(str(tmp_path / "t")):
            with registry.span("inside"):
                pass
    with registry.span("after"):
        pass
    assert set(registry.recorded()) == {"inside"}
    (names,) = _trace_names(tmp_path / "t")
    assert "inside" in names and "before" not in names


@pytest.mark.parametrize("device,opens", [
    ("cpu", False), (torch.device("cpu"), False),   # the host waits on nothing
    ("cuda", True), (torch.device("cuda", 1), True),
])
def test_a_wait_span_opens_only_for_a_card(registry, device, opens):
    """No card is touched: the span only reads the device's type."""
    from torch.profiler import ProfilerActivity, profile

    with registry.wait_span("x.wait", device):
        pass
    assert registry.recorded() == {}  # off without a profiler, either way
    with profile(activities=[ProfilerActivity.CPU]):
        with registry.wait_span("x.wait", device):
            assert registry.open_spans() == (["x.wait"] if opens else [])
    assert registry.recorded().get("x.wait", {}).get("count", 0) == int(opens)


STEP_SPANS = ("train.fetch", "train.upload", "train.forward", "train.backward",
              "train.optimizer")


def _streamed_tiger(tmp_path, epochs, profile_dir=None):
    """A streaming Trainer of a tiny TIGER and its train-batch factory."""
    from genrec_tpu_torch import configs
    from genrec_tpu_torch.data import datasets, synthetic, tiger_tokens
    from genrec_tpu_torch.models.tiger import TIGER
    from genrec_tpu_torch.pipelines.tiger_pipeline import loss_fn
    from genrec_tpu_torch.train.trainer import Trainer

    corpus = synthetic.make_interactions(num_users=20, num_items=20, min_len=4, max_len=6,
                                         seed=1)
    tr, _ = tiger_tokens.build_tiger_splits(corpus.item_id_lists, corpus.user_ids,
                                            synthetic.make_codes(20, seed=1))
    arrays = datasets.build_tiger_arrays(tr, 3, 4).arrays
    batch = 16
    cfg = configs.TIGERConfig(arch=configs.T5ArchConfig(**dict(ARCH, dropout_rate=0.1)),
                              max_len=3,
                              trainer=configs.TrainerConfig(batch_size=batch, epochs=epochs,
                                                            ckpt_dir=str(tmp_path / "ck"),
                                                            profile_dir=profile_dir))
    steps = -(-len(arrays["input_ids"]) // batch)
    trainer = Trainer(cfg.trainer, model=TIGER(cfg), loss_fn=loss_fn, steps_per_epoch=steps,
                      device="cpu")
    return trainer, lambda e: datasets.iterate_batches(arrays, batch, shuffle=True, seed=e), steps


@pytest.mark.parametrize("how", ["profile_dir", "profiler"])
def test_a_streamed_fit_records_each_span_once_a_step(registry, tmp_path, how):
    """Each step of the traced epochs records one of each of the Trainer's
    spans; the factory's ``next`` runs once more an epoch, to find its end."""
    from torch.profiler import ProfilerActivity, profile

    epochs = 2
    if how == "profile_dir":  # the Trainer traces its second epoch
        trainer, factory, steps = _streamed_tiger(tmp_path, epochs, str(tmp_path / "prof"))
        trainer.fit(factory)
        traced = 1
    else:
        trainer, factory, steps = _streamed_tiger(tmp_path, epochs)
        with profile(activities=[ProfilerActivity.CPU]):
            trainer.fit(factory)
        traced = epochs
    got = registry.recorded()
    assert set(got) == set(STEP_SPANS)  # no wait, nor the card's pinned fill
    for name in STEP_SPANS[1:]:
        assert got[name]["count"] == steps * traced, name
        assert got[name]["seconds"] > 0
    assert got["train.fetch"]["count"] == (steps + 1) * traced


@pytest.mark.parametrize("mode", ["none", "level", "trie"])
def test_generate_records_its_spans_and_keeps_its_results(registry, mode):
    from torch.profiler import ProfilerActivity, profile

    from genrec_tpu_torch import configs
    from genrec_tpu_torch.data import synthetic
    from genrec_tpu_torch.models.tiger import TIGER, generate, make_constraint

    cfg = configs.TIGERConfig(arch=configs.T5ArchConfig(**ARCH), max_len=3, max_gen_len=5,
                              constrained_decoding=mode)
    codes = synthetic.make_codes(20, seed=1)
    model = TIGER(cfg, generator=torch.Generator().manual_seed(0)).eval()
    ids = torch.from_numpy(np.random.default_rng(0).integers(1, 33, size=(3, 12)))
    mask = torch.ones_like(ids)
    mask[0, :4] = 0
    constraint = make_constraint(cfg, codes)
    want = generate(model, ids, mask, num_beams=4, constraint=constraint)
    assert registry.recorded() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        got = generate(model, ids, mask, num_beams=4, constraint=constraint)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    counts = {k: v["count"] for k, v in registry.recorded().items()}
    # the one decoder layer attends 1 + 2 + 3 + 4 key positions, 0 + 1 + 2 + 3 cached
    assert counts == {"generate.encode": 1, "beam.search": 1, "beam.decode": 4,
                      "beam.select": 4, "beam.decode.keys": 10, "beam.decode.cached": 6}
    assert registry.recorded()["beam.decode.keys"]["seconds"] == 0
