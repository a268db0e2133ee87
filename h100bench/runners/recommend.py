"""Batch recommendation cells: ``generate(model, ids, mask, num_beams,
constraint=make_constraint(cfg, codes))``, as the pipeline's device-resident
evaluation batches it (``tiger_pipeline._evaluate_device_resident``).

The pool of students' histories is uploaded once. A closed loop keeps one
batch in flight: each batch request is an index gather from the pool on the
device, the program's ``generate``, and the tokens and scores copied back
into pinned host memory; it ends when they are there. The batches walk a
seeded permutation of the pool, ``pool / batch`` batches a round.

Once the window has closed and the program's state is freed, a sample of
the students served, drawn from the seed with the longest history in it, is
judged against the reference: its scores of the returned sequences and its
own beam search.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100bench import check, corpus, counts
from h100bench.runners import Run, free, memory_peak, program_config, program_model, quiet_window, sync
from h100bench.reference import model as ref
from h100bench.trace import Spans, profile_stretch


def judged_students(seed: int, hist, n: int) -> np.ndarray:
    """The pool rows judged after the window: ``n`` drawn from the seed, the
    first of the longest histories among them."""
    lengths = hist["attention_mask"].sum(axis=1)
    sample = corpus.rng(seed, 7).choice(len(lengths), n - 1, replace=False)
    return np.unique(np.append(sample, int(np.flatnonzero(lengths == lengths.max())[0])))


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> Run:
    from genrec_tpu_torch.ops import t5_attention as ta

    if cell.config["model"] == "tiger_prefix":
        raise NotImplementedError("recommendation cells of tiger_prefix need its prof vectors")
    from genrec_tpu_torch.models.tiger import generate, make_constraint

    cfg, t = cell.config, cell.traffic
    notes = [f"set-up: imports and start {time.perf_counter() - t0:.3f} s"]
    P, B, K = t["pool"], t["batch"], t["num_beams"]
    if P % B:
        raise ValueError("the pool must be a whole number of batches")
    hist, codes = corpus.serving_histories(seed, cfg, t)
    items = codes[1:]  # row 0 is the padding item
    weights = corpus.make_weights(seed, ref.param_spec(cfg), device)
    pcfg = program_config(cfg, B, "")
    model = program_model(cfg, pcfg, weights, device).eval()
    constraint = make_constraint(pcfg, items).to(device)
    notes.append(f"set-up: data, weights, model and trie at {time.perf_counter() - t0:.3f} s")
    pool_ids = torch.as_tensor(hist["input_ids"]).to(device)
    pool_mask = torch.as_tensor(hist["attention_mask"]).to(device)
    order_np = corpus.rng(seed, 6).permutation(P)
    order = torch.as_tensor(order_np).to(device)
    pinned = torch.device(device).type == "cuda"
    tok_host = torch.empty((B, K, cfg["max_gen_len"]), dtype=torch.int64, pin_memory=pinned)
    score_host = torch.empty((B, K), dtype=torch.float32, pin_memory=pinned)
    done = torch.cuda.Event() if pinned else None

    lengths = hist["attention_mask"].sum(axis=1)
    sample = judged_students(seed, hist, t["sample_students"])
    where = np.empty(P, dtype=np.int64)
    where[order_np] = np.arange(P)
    by_slot = {}
    for row in sample:
        slot, pos = divmod(int(where[row]), B)
        by_slot.setdefault(slot, []).append((int(row), pos))
    served = {}
    nb = P // B
    counter = [0]

    def one(spans):
        slot = counter[0] % nb
        counter[0] += 1
        with spans("generate"):
            idx = order[slot * B:(slot + 1) * B]
            toks, scores = generate(model, pool_ids.index_select(0, idx),
                                    pool_mask.index_select(0, idx), num_beams=K,
                                    constraint=constraint)
        with spans("readback"):
            tok_host.copy_(toks, non_blocking=pinned)
            score_host.copy_(scores, non_blocking=pinned)
            if pinned:
                done.record()
                done.synchronize()
        for row, pos in by_slot.get(slot, ()):
            served[row] = (tok_host[pos].clone(), score_host[pos].clone())

    for _ in range(t["warmup_batches"]):
        one(Spans())
    sync(device)
    setup_s = time.perf_counter() - t0
    notes.append(f"set-up: {t['warmup_batches']} batches by {setup_s:.3f} s")

    quiet_window()
    served.clear()
    spans = Spans()
    lat = []
    start = time.perf_counter()
    deadline = start + seconds
    end = start
    while end < deadline:
        b0 = time.perf_counter()
        one(spans)
        end = time.perf_counter()
        lat.append(end - b0)
    window_s = end - start
    stretch = None
    if trace:
        before = ta.launches
        traced = Spans()
        stretch = profile_stretch(lambda: one(traced), t["trace_batches"], traced,
                                  lambda: sync(device), device)
        if stretch is not None:
            stretch["launches"] = [ta.launches - before, 0, 0]
    peak = memory_peak(device)
    batches = len(lat)
    first = t["warmup_batches"]
    flops = sum(counts.recommend_flops(cfg, lengths[order_np[j * B:(j + 1) * B]], K)
                for j in ((first + i) % nb for i in range(batches)))
    window = {"seconds": window_s, "batches": batches, "students": batches * B,
              "latencies": lat, "flops": flops, "batch": B}

    judged = sorted(served)
    del model, constraint, pool_ids, pool_mask, order
    free(device)
    numbers = {}
    if judged:
        batch = {k: torch.as_tensor(v[judged]).to(device) for k, v in hist.items()}
        p_tok = torch.stack([served[r][0] for r in judged]).to(device)
        p_score = torch.stack([served[r][1] for r in judged]).to(device)
        trie = ref.trie_tables(items, cfg["arch"]["vocab_size"], cfg["codebook_size"], device)
        _, r_best = ref.beam_search(cfg, weights, batch, K, trie)
        r_score = ref.sequence_scores(cfg, weights, batch, p_tok, trie)
        numbers = check.recommendation(p_score, r_score, r_best)
    notes.append(f"judged {len(judged)} of {len(sample)} sampled students "
                 f"({len(judged) * K} served sequences)")
    return Run(setup_s=setup_s, window=window, spans=spans.seconds, trace=stretch,
               numbers=numbers, notes=notes, attempted=batches, failed=0,
               memory_peak_bytes=peak)
