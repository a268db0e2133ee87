"""Batch recommendation cells of a decoder-only MoE language model over
semantic IDs (DeepSeek-V2): ``generate(model, ids, mask, num_beams,
constraint=make_constraint(cfg, codes))`` from ``models/deepseek_v2.py``,
TIGER's contract.

A prompt is an instruction shared by every student (ids drawn from the
seed below the semantic-ID rows), then the tokens of the last ``max_len``
items of the student's history (the corpus's sequences and length
multiset, ``corpus.make_sequences``), left-padded to the longest possible
prompt. The pool of prompts is uploaded once, and the model's weights are
drawn on the card in the configuration's dtype (``reference/deepseek_v2``
``make_weights``) and handed to a model built on ``meta``, so no float32
copy of them exists anywhere. A closed loop keeps one batch in flight:
an index gather from the pool on the card, the program's ``generate``, and
the tokens and scores copied back into pinned host memory. The batches
walk a seeded permutation of the pool.

A traced run profiles ``trace_batches`` more batches and counts the
grouped-expert launches in the trace (``counts_lm.EXPERT_KERNELS``). Once
the window has closed, a sample of the students of its first batch, drawn
from the seed with the longest prompt among them, is judged against the reference in
float32 (``check_lm``): its teacher-forced scores of the returned
sequences and its own beam search.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from h100bench import check_lm, corpus, counts_lm
from h100bench.reference import deepseek_v2 as ref
from h100bench.runners import Run, free, memory_peak, quiet_window, sync
from h100bench.trace import STRETCH, Spans, _device_events, read_trace


def prompts(seed: int, cfg: dict, t: dict):
    """({input_ids, attention_mask} (pool, instruction + max_len·code_dim),
    left-padded, int64; the item code table (items + 1, code_dim), row 0
    the padding item)."""
    r = corpus.rng(seed, 1)
    k, dim = cfg["codebook_size"], cfg["code_dim"]
    codes = corpus.make_codes(r, t["items"], k, dim - 1)
    items, lengths = corpus.make_sequences(r, t["pool"], t)
    tok = (cfg["sid_base"] + np.arange(dim) * k + codes).astype(np.int64)
    n_hist = np.minimum(lengths - 1, t["max_len"])
    n_instr = t["instruction_tokens"]
    width = n_instr + t["max_len"] * dim
    ids = np.zeros((t["pool"], width), dtype=np.int64)
    for j in range(t["max_len"]):  # item j of the last max_len, right-aligned
        src = lengths - 1 - t["max_len"] + j
        picked = tok[items[np.arange(len(items)), np.clip(src, 0, None)]]
        ids[:, n_instr + j * dim:n_instr + (j + 1) * dim] = np.where((src >= 0)[:, None], picked, 0)
    start = width - n_instr - dim * n_hist  # the instruction just before the history
    ids[np.arange(t["pool"])[:, None], start[:, None] + np.arange(n_instr)[None, :]] = \
        corpus.rng(seed, 8).integers(0, cfg["sid_base"], n_instr)
    col = np.arange(width)[None, :]
    return {"input_ids": ids, "attention_mask": (col >= start[:, None]).astype(np.int64)}, codes


def judged_students(seed: int, rows: np.ndarray, lengths: np.ndarray, n: int) -> np.ndarray:
    """The students judged after the window: ``n`` of ``rows`` (the
    window's first batch, so every one is served in it) drawn from the
    seed, the first of their longest prompts among them."""
    sample = corpus.rng(seed, 7).choice(rows, n - 1, replace=False)
    longest = rows[np.flatnonzero(lengths[rows] == lengths[rows].max())[0]]
    return np.unique(np.append(sample, longest))


def program_config(cfg: dict):
    from genrec_tpu_torch.configs import DeepSeekV2Config

    names = {f.name for f in dataclasses.fields(DeepSeekV2Config)}
    return DeepSeekV2Config(**{k: v for k, v in cfg.items() if k in names})


def weights(seed: int, cfg: dict, device) -> dict:
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]
    gen = torch.Generator(device=device).manual_seed(corpus.derived_seed(seed, 3))
    return ref.make_weights(cfg, gen, device, dtype)


def program_model(cfg: dict, w: dict):
    """The program's model holding ``w`` (built on ``meta``, the tensors
    assigned, not copied)."""
    from genrec_tpu_torch.models.deepseek_v2 import DeepSeekV2

    model = DeepSeekV2(program_config(cfg), device="meta")
    model.load_state_dict(w, strict=True, assign=True)
    return model.eval()


def _stretch(step, n: int, spans: Spans, device):
    """``n`` of the window's batches under the profiler (see
    ``trace.profile_stretch``), with the grouped-expert launches' count
    and device seconds; None without device time (up to three tries)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    for _ in range(3):
        spans.profiling = True
        try:
            with profile(activities=acts) as prof:
                with torch.profiler.record_function(STRETCH):
                    for _ in range(n):
                        step()
                    sync(device)
        finally:
            spans.profiling = False
        out = read_trace(prof, set(spans.seconds))
        if out is not None:
            launches = [e for e in _device_events(prof)
                        if any(k in e.name for k in counts_lm.EXPERT_KERNELS)]
            out.update(steps=n, expert_launches=len(launches),
                       expert_s=sum(e.time_range.elapsed_us() for e in launches) / 1e6)
            return out
    return None


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> Run:
    from genrec_tpu_torch.models.deepseek_v2 import generate, make_constraint

    cfg, t = cell.config, cell.traffic
    notes = [f"set-up: imports and start {time.perf_counter() - t0:.3f} s"]
    P, B, K = t["pool"], t["batch"], t["num_beams"]
    if P % B:
        raise ValueError("the pool must be a whole number of batches")
    hist, codes = prompts(seed, cfg, t)
    items = codes[1:]  # row 0 is the padding item
    notes.append(f"set-up: prompts at {time.perf_counter() - t0:.3f} s")
    w = weights(seed, cfg, device)
    sync(device)
    notes.append(f"set-up: weights at {time.perf_counter() - t0:.3f} s")
    model = program_model(cfg, w)
    constraint = make_constraint(model.cfg, items).to(device)
    notes.append(f"set-up: model and trie at {time.perf_counter() - t0:.3f} s")
    pool_ids = torch.as_tensor(hist["input_ids"]).to(device)
    pool_mask = torch.as_tensor(hist["attention_mask"]).to(device)
    order_np = corpus.rng(seed, 6).permutation(P)
    order = torch.as_tensor(order_np).to(device)
    pinned = torch.device(device).type == "cuda"
    tok_host = torch.empty((B, K, cfg["code_dim"] + 1), dtype=torch.int64, pin_memory=pinned)
    score_host = torch.empty((B, K), dtype=torch.float32, pin_memory=pinned)
    done = torch.cuda.Event() if pinned else None

    lengths = hist["attention_mask"].sum(axis=1)
    nb = P // B
    first_slot = t["warmup_batches"] % nb
    sample = judged_students(seed, order_np[first_slot * B:(first_slot + 1) * B], lengths,
                             t["sample_students"])
    where = np.empty(P, dtype=np.int64)
    where[order_np] = np.arange(P)
    by_slot = {}
    for row in sample:
        slot, pos = divmod(int(where[row]), B)
        by_slot.setdefault(slot, []).append((int(row), pos))
    served = {}
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

    def batch_lengths(j):
        return lengths[order_np[(j % nb) * B:(j % nb + 1) * B]]

    for _ in range(t["warmup_batches"]):
        one(Spans())
    sync(device)
    setup_s = time.perf_counter() - t0
    notes.append(f"set-up: {t['warmup_batches']} batches by {setup_s:.3f} s")

    quiet_window()
    served.clear()
    spans = Spans()
    lat = []
    first = counter[0]
    start = time.perf_counter()
    deadline = start + seconds
    end = start
    while end < deadline:
        b0 = time.perf_counter()
        one(spans)
        end = time.perf_counter()
        lat.append(end - b0)
    window_s = end - start
    batches = len(lat)
    stretch = None
    if trace:
        traced = Spans()
        at = counter[0]
        stretch = _stretch(lambda: one(traced), t["trace_batches"], traced, device)
        if stretch is not None:
            stretch["expert_bound_s"] = sum(counts_lm.batch_expert_bound_s(
                cfg, int(batch_lengths(j).sum()), B, K) for j in range(at, counter[0]))
            stretch["expert_launches_want"] = (counts_lm.batch_expert_launches(cfg)
                                               * (counter[0] - at))
    peak = memory_peak(device)
    flops = sum(counts_lm.recommend_flops(cfg, batch_lengths(first + i), K)
                for i in range(batches))
    window = {"seconds": window_s, "batches": batches, "students": batches * B,
              "latencies": lat, "flops": flops, "batch": B}

    judged = sorted(served)
    del model, constraint, pool_ids, pool_mask, order
    free(device)
    numbers = {}
    if judged:
        ids = torch.as_tensor(hist["input_ids"][judged]).to(device)
        mask = torch.as_tensor(hist["attention_mask"][judged]).to(device)
        p_tok = torch.stack([served[r][0] for r in judged]).to(device)
        p_score = torch.stack([served[r][1] for r in judged]).to(device)
        trie = ref.item_trie(items)
        _, r_best = ref.beam_search(cfg, w, ids, mask, K, trie)
        r_score = ref.sequence_scores(cfg, w, ids, mask, p_tok, trie)
        numbers = check_lm.recommendation(p_score, r_score, r_best)
        notes.append(numbers.pop("_notes"))
    notes.append(f"judged {len(judged)} of {len(sample)} sampled students "
                 f"({len(judged) * K} served sequences)")
    return Run(setup_s=setup_s, window=window, spans=spans.seconds, trace=stretch,
               numbers=numbers, notes=notes, attempted=batches, failed=0,
               memory_peak_bytes=peak)
