"""Training cells: the program's ``Trainer`` on its streamed route, fed as
``tiger_prefix_pipeline.train`` feeds it.

Set-up makes the corpus and the weights from the seed, builds one Trainer
(model and Adam state) and drives it from the seed through its first
``checked_steps`` steps, keeping what each step received and what the
optimizer made of it, then on to ``warmup_steps`` steps in all. The window
then runs the same Trainer's steps back to back across epochs, each batch
put by the Trainer's own streamed route (``_epoch_batches``: the factory's
shuffled gather, the pinned copy and its asynchronous upload) and each step
by ``train_step``, with no loss read; it closes on a device synchronise.
Once it has closed and the program's state is freed, the reference follows
the checked steps from the same weights, batches and dropout generator.
"""

from __future__ import annotations

import tempfile
import time

import numpy as np
import torch

from h100bench import check, corpus, counts
from h100bench.runners import Run, free, memory_peak, program_config, program_model, quiet_window, sync
from h100bench.reference import model as ref
from h100bench.trace import Spans, profile_stretch


def epoch_rows(seed: int, n: int, batch: int) -> list:
    """The rows of each batch of an epoch shuffled with ``seed``, and which
    of them are real: ``datasets.iterate_batches``' order, worked out again."""
    idx = np.arange(n)
    np.random.default_rng(seed).shuffle(idx)
    out = []
    for start in range(0, n, batch):
        sel = idx[start:start + batch]
        valid = np.arange(batch) < len(sel)
        out.append((np.concatenate([sel, np.zeros(batch - len(sel), sel.dtype)]), valid))
    return out


def gathered(arrays, rows, valid, device):
    """The batch of ``rows`` on ``device``, as the reference is given it."""
    b = {k: torch.as_tensor(v[rows]).to(device) for k, v in arrays.items()}
    b["valid"] = torch.as_tensor(valid).to(device)
    return b


def inputs(cell, seed: int, device):
    """(arrays, weights, dropout generator's seed, shuffle seed) of a run:
    the training split with the major vectors on the host, the weights on
    ``device``; epoch e shuffles with seed shuffle + e."""
    cfg = cell.config
    arrays, _ = corpus.train_arrays(seed, cfg, cell.traffic)
    if cfg["model"] == "tiger_prefix":
        arrays.update(corpus.prof_vectors(seed, cfg, len(arrays["input_ids"]), device))
    weights = corpus.make_weights(seed, ref.param_spec(cfg), device)
    return arrays, weights, corpus.derived_seed(seed, 4), corpus.derived_seed(seed, 5) % 2 ** 31


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> Run:
    from genrec_tpu_torch.data import datasets
    from genrec_tpu_torch.ops import t5_attention as ta
    from genrec_tpu_torch.train.trainer import Trainer

    if cell.config["model"] == "tiger_prefix":
        from genrec_tpu_torch.pipelines.tiger_prefix_pipeline import loss_fn
    else:
        from genrec_tpu_torch.pipelines.tiger_pipeline import loss_fn
    cfg, t = cell.config, cell.traffic
    notes = [f"set-up: imports and start {time.perf_counter() - t0:.3f} s"]
    B = t["batch"]
    arrays, weights, gen_seed, shuffle = inputs(cell, seed, device)
    n = len(arrays["input_ids"])
    notes.append(f"set-up: data and weights at {time.perf_counter() - t0:.3f} s")
    steps_per_epoch = -(-n // B)
    ckpt = tempfile.TemporaryDirectory(prefix="h100bench_")
    pcfg = program_config(cfg, B, ckpt.name)
    model = program_model(cfg, pcfg, weights, device)
    trainer = Trainer(pcfg.trainer, model=model, loss_fn=loss_fn, steps_per_epoch=steps_per_epoch,
                      logger_name="h100bench", device=device)
    notes.append(f"set-up: model and Trainer at {time.perf_counter() - t0:.3f} s")
    gen = torch.Generator(device=device).manual_seed(gen_seed)

    def factory(epoch):
        return datasets.iterate_batches(arrays, B, shuffle=True, seed=shuffle + epoch)

    def batches():
        epoch = 1
        while True:
            yield from trainer._epoch_batches(epoch, factory)
            epoch += 1

    stream = batches()

    def one(spans):
        with spans("put"):
            batch, k = next(stream)
        with spans("step"):
            trainer.train_step(batch, gen)
        return k

    # the checked steps, through the window's own calls
    b1 = cfg["trainer"]["adam_betas"][0]
    received, losses, grads = [], [], None
    for i in range(t["checked_steps"]):
        batch, _ = next(stream)
        received.append({k: v.clone() for k, v in batch.items()})
        sum_loss, valid = trainer.train_step(batch, gen)
        losses.append(float(sum_loss / valid))
        notes.append(f"set-up: checked step {i + 1} at {time.perf_counter() - t0:.3f} s")
        if grads is None:
            state = trainer.opt.optimizer.state
            # an optimizer that kept no state got no gradient: it reads as 0
            grads = {k: (state[p]["exp_avg"].detach().clone() if "exp_avg" in state.get(p, {})
                         else torch.zeros_like(p)) / (1 - b1)
                     for k, p in model.named_parameters()}
    after = {k: p.detach().clone() for k, p in model.named_parameters()}
    for _ in range(t["warmup_steps"] - t["checked_steps"]):
        one(Spans())
    sync(device)
    setup_s = time.perf_counter() - t0
    notes.append(f"set-up: {t['warmup_steps']} steps by {setup_s:.3f} s")

    quiet_window()
    spans = Spans()
    steps = examples = 0
    start = time.perf_counter()
    deadline = start + seconds
    while time.perf_counter() < deadline:
        examples += one(spans)
        steps += 1
    sync(device)
    window_s = time.perf_counter() - start
    stretch = None
    if trace:
        before = (ta.launches, ta.bwd_launches, ta.dbias_reduce_launches)
        traced = Spans()
        stretch = profile_stretch(lambda: one(traced), t["trace_steps"], traced,
                                  lambda: sync(device), device)
        if stretch is not None:
            stretch["launches"] = [a - b for a, b in zip(
                (ta.launches, ta.bwd_launches, ta.dbias_reduce_launches), before)]
    peak = memory_peak(device)

    flops, epochs = 0.0, {}
    first = t["warmup_steps"]
    for s in range(first, first + steps):
        epoch, k = s // steps_per_epoch + 1, s % steps_per_epoch
        if epoch not in epochs:
            epochs[epoch] = epoch_rows(shuffle + epoch, n, B)
        rows, valid = epochs[epoch][k]
        flops += counts.train_step_flops(cfg, {"attention_mask": arrays["attention_mask"][rows],
                                               "labels": arrays["labels"][rows],
                                               "valid": valid})
    window = {"seconds": window_s, "steps": steps, "examples": examples, "flops": flops,
              "batch": B}

    # the check, once the program's state is freed
    prog = {"losses": losses, "grads": grads, "params": after, "start": weights}
    del trainer, model, stream, batch, state
    free(device)
    expected = [gathered(arrays, rows, valid, device)
                for rows, valid in epoch_rows(shuffle + 1, n, B)[:t["checked_steps"]]]
    out = ref.train_steps(cfg, weights, expected,
                          torch.Generator(device=device).manual_seed(gen_seed))
    numbers = check.training(prog, out, received, expected)
    notes.append(f"checked {len(losses)} steps: {numbers.pop('_notes')}; "
                 f"losses program {losses} reference {out['losses']}")
    ckpt.cleanup()
    return Run(setup_s=setup_s, window=window, spans=spans.seconds, trace=stretch,
               numbers=numbers, notes=notes, attempted=steps, failed=0,
               memory_peak_bytes=peak)
