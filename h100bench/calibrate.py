"""Readings of the correctness check's control and planted faults, at a
cell's own size, from which ``limits/<cell>.json`` are set.

    python3 -m h100bench.calibrate --workload <name> --seeds 11,12,13 [--out file]

For each seed it makes the cell's inputs and weights as a run does, works
out the plain reference in float32, and judges in the program's place:
- ``control``: the reference computed at TF32 (the nearest precision below
  the configuration's float32 with TF32 off);
- training faults: ``half_batch`` (the second half of each batch left out,
  the mean over the rest); a step that returns its state unchanged reads 1
  on ``update_gap`` by construction and needs no run;
- recommendation faults: ``half_batch`` (half the students given another
  student's list), ``token_altered`` (each student's best sequence with its
  last code token changed), ``stale`` (every student given the list of the
  batch before, another student's), ``not_best`` (each list without its
  best sequence).
The benchmark's own runs never run this; the sound program's readings are
the ``check`` numbers of those runs. One JSON line per seed and candidate.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from h100bench import cell as cells, check, corpus
from h100bench.runners import train as train_runner
from h100bench.runners.recommend import judged_students
from h100bench.reference import model as ref


def training(cell, seed: int, device):
    cfg, t = cell.config, cell.traffic
    arrays, weights, gen_seed, shuffle = train_runner.inputs(cell, seed, device)
    n = len(arrays["input_ids"])
    batches = [train_runner.gathered(arrays, rows, valid, device)
               for rows, valid in train_runner.epoch_rows(shuffle + 1, n, t["batch"])
               [:t["checked_steps"]]]

    def steps(precision="f32", batch_fn=None):
        gen = torch.Generator(device=device).manual_seed(gen_seed)
        return ref.train_steps(cfg, weights, batches, gen, precision, batch_fn)

    def half(batch):
        b = dict(batch)
        v = batch["valid"].clone()
        v[len(v) // 2:] = False
        b["valid"] = v
        return b

    truth = steps()
    for name, kw in (("control", {"precision": "tf32"}), ("half_batch", {"batch_fn": half})):
        cand = steps(**kw)
        cand["start"] = weights
        numbers = check.training(cand, truth, batches, batches)
        numbers["notes"] = numbers.pop("_notes")
        yield name, numbers


def recommendation(cell, seed: int, device):
    cfg, t = cell.config, cell.traffic
    hist, codes = corpus.serving_histories(seed, cfg, t)
    items = codes[1:]
    weights = corpus.make_weights(seed, ref.param_spec(cfg), device)
    K = t["num_beams"]
    sample = judged_students(seed, hist, t["sample_students"])
    batch = {k: torch.as_tensor(v[sample]).to(device) for k, v in hist.items()}
    trie = ref.trie_tables(items, cfg["arch"]["vocab_size"], cfg["codebook_size"], device)
    _, truth = ref.beam_search(cfg, weights, batch, K, trie)

    def judged(tokens, scores):
        rs = ref.sequence_scores(cfg, weights, batch, tokens, trie)
        return check.recommendation(scores, rs, truth)

    ctok, cscore = ref.beam_search(cfg, weights, batch, K, trie, precision="tf32")
    yield "control", judged(ctok, cscore)
    tok, score = ref.beam_search(cfg, weights, batch, K, trie)
    S = len(sample)
    shift = torch.roll(torch.arange(S, device=device), 1)
    half_idx = torch.where(torch.arange(S, device=device) < S // 2, shift,
                           torch.arange(S, device=device))
    yield "half_batch", judged(tok[half_idx], score[half_idx])
    bad = tok.clone()
    last = bad[:, 0, -1]
    lo = (cfg["code_dim"] - 1) * cfg["codebook_size"] + 1
    bad[:, 0, -1] = lo + (last - lo + 1) % cfg["codebook_size"]
    yield "token_altered", judged(bad, score)
    yield "stale", judged(tok[shift], score[shift])
    yield "not_best", judged(tok[:, 1:], score[:, 1:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = cells.find_cell(args.workload)
    kind = {"train": training, "recommend": recommendation}[cell.traffic["kind"]]
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        for name, numbers in kind(cell, seed, device):
            lines.append({"workload": args.workload, "seed": seed, "candidate": name,
                          "numbers": numbers})
            print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
