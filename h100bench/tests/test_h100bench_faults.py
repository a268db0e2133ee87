"""A run whose timed path is broken underneath comes out not correct: each
fault a cell can have, planted in the program, the rest of the run as it is
(on the CPU, at a small size, past the harness's look for a card)."""

import time

import pytest
import torch

from h100bench import run


def _correct(name, tiny, seed=11):
    cell, r = run.run_cell(name, seed, 0.5, False, "cpu", time.perf_counter(), tiny[name])
    line = run.result_line(cell, r, False, {"platform": "cpu"})
    return line["correct"], line["check"]


def test_sound_runs_are_correct(tiny):
    for name in tiny:
        ok, shown = _correct(name, tiny)
        assert ok, shown


TRAIN = "tiger_prefix.train_b1024"
SERVE = "tiger.recommend_b4096"


def test_training_step_that_leaves_its_state_unchanged(monkeypatch, tiny):
    from genrec_tpu_torch.train import optim

    monkeypatch.setattr(optim.TrainOptimizer, "step", lambda self: None)
    ok, shown = _correct(TRAIN, tiny)
    assert not ok and shown["update_gap"]["value"] == pytest.approx(1.0)


def test_training_on_half_the_batch(monkeypatch, tiny):
    from genrec_tpu_torch.pipelines import tiger_prefix_pipeline as tpp

    real = tpp.loss_fn

    def half(model, batch, generator):
        valid = batch["valid"].clone()
        valid[len(valid) // 2:] = False
        return real(model, dict(batch, valid=valid), generator)

    monkeypatch.setattr(tpp, "loss_fn", half)
    ok, shown = _correct(TRAIN, tiny)
    assert not ok, shown


def test_training_token_altered_in_the_upload(monkeypatch, tiny):
    from genrec_tpu_torch.train.trainer import Trainer

    real = Trainer._put

    def put(self, batch):
        out = real(self, batch)
        out["labels"] = out["labels"].clone()
        out["labels"][0, 0] = (out["labels"][0, 0] % 32) + 1
        return out

    monkeypatch.setattr(Trainer, "_put", put)
    ok, shown = _correct(TRAIN, tiny)
    assert not ok and shown["batch_mismatch"]["value"] > 0


def _patch_generate(monkeypatch, wrap):
    from genrec_tpu_torch.models import tiger

    real = tiger.generate
    monkeypatch.setattr(tiger, "generate", lambda *a, **k: wrap(real, *a, **k))


def test_recommendation_that_returns_its_state_unchanged(monkeypatch, tiny):
    first = []

    def stale(real, *a, **k):
        if not first:
            first.append(real(*a, **k))
        return first[0]

    _patch_generate(monkeypatch, stale)
    ok, shown = _correct(SERVE, tiny)
    assert not ok, shown


def test_recommendation_for_half_the_batch(monkeypatch, tiny):
    def half(real, model, ids, mask, **k):
        n = len(ids) // 2
        toks, scores = real(model, ids[:n], mask[:n], **k)
        return torch.cat([toks, toks]), torch.cat([scores, scores])

    _patch_generate(monkeypatch, half)
    ok, shown = _correct(SERVE, tiny)
    assert not ok, shown


def test_recommendation_token_altered(monkeypatch, tiny):
    def altered(real, *a, **k):
        toks, scores = real(*a, **k)
        toks = toks.clone()
        toks[:, 0, -1] = 25 + (toks[:, 0, -1] - 25 + 1) % 8
        return toks, scores

    _patch_generate(monkeypatch, altered)
    ok, shown = _correct(SERVE, tiny)
    assert not ok and shown["score_gap"]["value"] > 1.0
