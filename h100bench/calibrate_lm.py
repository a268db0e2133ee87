"""Readings of the correctness check of a decoder-only MoE recommender cell
(DeepSeek-V2), for the control and the planted faults, at the cell's own
size, from which ``limits/<cell>.json`` are set.

    python3 -m h100bench.calibrate_lm --workload <name> --seeds 11,12,13 \
        [--candidates sound,control_bf16] [--out file]

For each seed it makes the cell's prompts and weights as a run does, takes
the students a run would judge (a sample of the window's first batch),
and judges in the program's place:
- ``sound``: the program's ``generate`` over that whole batch;
- ``control``: the reference's beam search with the operands of every
  matrix product rounded to float8 e4m3 (the precision below the
  configuration's bf16 products);
- ``control_bf16``: the reference's beam search with the weights and every
  activation in bf16, the softmaxes' and the log-softmax's outputs too (the
  program keeps f32 accumulation, residual, softmaxes and router);
- each fault of ``faults_lm``, planted in the program, over that batch.
Each is judged by ``check_lm`` against the float32 reference, with the
quantiles of the gaps and every sequence's score gap, sorted (``gaps``),
from which another quantile can be read. ``--candidates`` keeps only the
candidates named. The benchmark's own runs never run this. One JSON line
per seed and candidate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from h100bench import cell as cells, check_lm, corpus, faults_lm
from h100bench.reference import deepseek_v2 as ref
from h100bench.runners import free
from h100bench.runners import recommend_lm as runner


def candidates(cell, seed: int, device, keep=None):
    from genrec_tpu_torch.models.deepseek_v2 import generate, make_constraint

    cfg, t = cell.config, cell.traffic
    B, K = t["batch"], t["num_beams"]
    hist, codes = runner.prompts(seed, cfg, t)
    items = codes[1:]
    order = corpus.rng(seed, 6).permutation(t["pool"])
    first = (t["warmup_batches"] % (t["pool"] // B)) * B
    rows = order[first:first + B]
    lengths = hist["attention_mask"].sum(axis=1)
    sample = runner.judged_students(seed, rows, lengths, t["sample_students"])
    pos = torch.as_tensor([int((rows == s).nonzero()[0][0]) for s in sample], device=device)
    w = runner.weights(seed, cfg, device)
    ids_b = torch.as_tensor(hist["input_ids"][rows], device=device)
    mask_b = torch.as_tensor(hist["attention_mask"][rows], device=device)
    ids = torch.as_tensor(hist["input_ids"][sample], device=device)
    mask = torch.as_tensor(hist["attention_mask"][sample], device=device)
    trie = ref.item_trie(items)
    t0 = time.perf_counter()
    _, truth = ref.beam_search(cfg, w, ids, mask, K, trie)
    yield "reference_s", time.perf_counter() - t0

    def judged(tokens, scores):
        rs = ref.sequence_scores(cfg, w, ids, mask, tokens, trie)
        out = check_lm.recommendation(scores, rs, truth)
        out["gaps"] = sorted((scores.double() - rs.double()).abs().flatten().tolist())
        return out

    def wanted(name):
        return keep is None or name in keep

    def program():
        model = runner.program_model(cfg, w)
        out = generate(model, ids_b, mask_b, num_beams=K,
                       constraint=make_constraint(model.cfg, items).to(device))
        del model
        return out[0][pos], out[1][pos]

    if wanted("sound"):
        yield "sound", judged(*program())
    if wanted("control"):
        yield "control", judged(*ref.beam_search(cfg, w, ids, mask, K, trie, precision="fp8"))
    if wanted("control_bf16"):
        yield "control_bf16", judged(*ref.beam_search(cfg, w, ids, mask, K, trie,
                                                      precision="bf16"))
    for name in faults_lm.FAULTS:
        if not wanted(name):
            continue
        with faults_lm.planted(name):
            got = program()
        yield name, judged(*got)
        free(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--candidates", help="comma-separated candidates to run (default: all)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    ref.no_tf32()
    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = cells.find_cell(args.workload)
    lines = []
    keep = set(args.candidates.split(",")) if args.candidates else None
    for seed in (int(s) for s in args.seeds.split(",")):
        for name, numbers in candidates(cell, seed, device, keep):
            if isinstance(numbers, dict):
                numbers["notes"] = numbers.pop("_notes")
            lines.append({"workload": args.workload, "seed": seed, "candidate": name,
                          "numbers": numbers})
            print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
