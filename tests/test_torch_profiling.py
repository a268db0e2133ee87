"""The port's ``utils/profiling.py`` and the Trainer's ``profile_dir``, after
``genrec_tpu/utils/profiling.py`` and ``genrec_tpu/train/trainer.py``'s
hook: ``StepTimer`` against the JAX one (`tests/test_utils.py:51`'s case),
``trace`` writing a Chrome-trace file that holds an ``annotate`` range, and
the Trainer tracing only epoch ``min(first epoch of the fit + 1, epochs)``,
on resume too.
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


@pytest.mark.parametrize("sync", [None, "tensor", "tree"])
def test_step_timer_matches_jax(sync):
    from genrec_tpu.utils.profiling import StepTimer as JStepTimer
    from genrec_tpu_torch.utils.profiling import StepTimer

    value = {"tensor": torch.ones(3), "tree": {"a": torch.ones(2), "b": [torch.zeros(1)]},
             None: None}[sync]
    for timer in (JStepTimer(sync_every=2), StepTimer(sync_every=2)):
        assert timer.tick(10) is None
        stats = timer.tick(10, value if timer.__class__ is StepTimer else None)
        assert stats is not None and stats["steps"] == 2
        assert set(stats) == {"steps", "seconds", "steps_per_sec", "examples_per_sec"}
        assert stats["examples_per_sec"] > 0
        np.testing.assert_allclose(stats["examples_per_sec"], 20 / stats["seconds"])
        assert timer.history == [stats] and timer.tick(10) is None
        timer.reset()
        assert timer.history == [] and timer.tick(1) is None


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
