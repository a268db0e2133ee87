#!/usr/bin/env python3
"""Chip smoke of the PyTorch / CUDA port (``genrec_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``genrec_tpu``. Phases, each of
which asserts; any failure exits non-zero and prints no result:

1. require a CUDA device; print the card's name and power limit;
2. build every kernel of the paths from ``genrec_tpu_torch/csrc`` (one nvcc
   per source, all four together, sm_90a);
3. hold each kernel against its plain PyTorch version on the card and time
   the kernel, the plain version and one PyTorch library call of the same
   function (CUDA events, and the profiler's device time): the T5 forward at
   the serving shapes, the three train shapes of ``TIGERConfig()`` at batch
   256, the encoder and cross-attention shapes of ``TIGERPrefixConfig()``
   (8 heads, 83 encoder tokens) and the encoder shape of ``DenseT5Config()``
   (4 heads over 21 right-padded positions, the mask at rate 0.3) with the
   f32 dropout mask and without it, DenseT5's B=1 request, and edge cases
   within 1e-5
   max abs (f32, another summation order), bit-identical between two calls,
   with its shared memory, blocks per SM, ptxas registers and spills and,
   stage by stage, its distance from the f64 forward; the T5 backward at the
   three train shapes of
   ``TIGERConfig()`` at batch 256, the two TIGER-prefix shapes, DenseT5's
   and edge cases within 1e-4·max|plain| +
   1e-5, bit-identical between two calls (dbias by an ordered reduction, no
   atomics), with its shared memory and blocks per SM and, stage by stage,
   where its distance from the f64 backward comes from; its dbias reduction
   kernel bit-equal to its plain version; the
   flash forward (out and lse within 1e-5) and its dq and dk/dv kernels
   (within 1e-4·max|plain| + 1e-5) at the long-context SASRec shapes (B·H
   128 at L=2048, 16 at L=4096, causal) and edge cases (a bias at D=64 and
   D=16, L=128, lq ≠ lk, D=128, a ragged D=24), out, lse, dq, dk and dv
   bit-identical between two calls at L=2048 and, on 8 flat rows of every
   case, their distance from the f64 forward and backward beside the plain
   f32 version's; every flash kernel's shared memory, blocks per SM,
   registers and spills (none at D=16); each flash kernel's f32 and 3xTF32
   bounds;
4. one train step of ``TIGERConfig()`` at B=16 and dropout 0 on the card
   against the same step on the CPU in f64 (see ``phase_train_step_parity``):
   loss within 1e-5, every gradient within the backward's bound;
5. drive the TIGER serving path: a TIGER at ``TIGERConfig()`` widths with
   seeded random weights, saved and served by ``tiger_model_fn`` on the card,
   a few requests, then one batched trie-constrained ``generate`` at B=256
   and 20 beams, compared on its first rows with the same call on the CPU;
6. drive the TIGER training path at full width: ``tiger_pipeline.train`` for
   3 epochs at batch 256 (dropout 0.1) on a 4096-user synthetic corpus, a
   resume to a 4th epoch, ``evaluate``; then one profiled train step;
7. drive the long-context SASRec (``long_context_sasrec_config(2048, 64)``,
   random weights): ``predict_topk`` over B=1 requests and a B=32 batch,
   held against the CPU; one B=2 train step against an f64 CPU step through
   the kernels' plain versions, with the card's ReLU decisions; 20 train
   steps at B=32 with a falling loss, 3 at L=4096 and B=16, 2 at the
   config's dropout 0.2 (no flash launch);
8. drive the semantic-ID chain at full width: RQ-VAE (``RQVAEConfig()``)
   trains 20 epochs on ``make_item_embs(700, 768)`` and writes the (700, 4)
   codes (greedy, grouped Sinkhorn repair, 4th digit), its greedy codes held
   against the CPU's, one step against an f64 CPU step with the card's codes;
   TIGER-prefix (``TIGERPrefixConfig()``) trains 3 epochs at batch 256 on a
   4096-user corpus tokenized with those codes and three prof-vector draws,
   ``evaluate`` with the level constraint and 20 beams; one profiled step and
   a B=16 step against an f64 CPU step;
9. drive DenseT5 at ``DenseT5Config()`` widths (6 layers, d_model 512, 4
   heads of 16, dropout 0.3) on the TIGER corpus with
   ``make_item_embs(700, 768)`` and ``make_user_embs(4096, 768)``: a B=16
   step against an f64 CPU step; ``train`` for 2 epochs at batch 256 (the
   validation loss must fall), ``evaluate``, and ``dense_t5_model_fn``
   requests from the best checkpoint, their top-10 lists equal to a CPU
   run's; 6 launches of #1 and #2 a step, 6 of #1 a request; a profiled step;
10. drive the parity SASRec: ``sasrec_pipeline.train`` (2 epochs) and
    ``evaluate`` on a 4096-user corpus, requests through ``sasrec_model_fn``
    (L=20: no flash launch);
11. ``[app]``: ``/api/v1/recommend/model`` through the stdlib HTTP server in
    a thread, backed on the card by the TIGER, DenseT5 and SASRec
    checkpoints of 6, 9 and 10: lists equal to the model fn's own, 2 and 6
    launches of #1 a TIGER and DenseT5 request, ids outside the catalog
    dropped as JAX drops them, HTTP and direct requests/s, device ms and
    busy share a request; ``make_sasrec_recommend_fn`` on an id past its
    table answers JAX's pinned list;
12. ``[dist]``, right after 6: the distributed layer over an NCCL group of
    one rank (the card is alone, and NCCL refuses two ranks on one card),
    joined through a ``file://`` rendezvous in the temporary directory, on
    the 1 × 1 mesh: TIGER at ``TIGERConfig()`` under DDP, one step against
    the single-device Trainer's step (loss and every gradient within the
    backward's bound, the largest difference printed; 6 + 6 launches of #1
    and #2 in each), one epoch of ``tiger_pipeline.train`` under the group
    whose loss equals the first epoch of 6, a profiled step of each;
    ``SASRecLargeConfig()``'s 10,000,000-row table, f32 and bf16: the psum
    and all_to_all lookups equal ``F.embedding`` exactly and are timed,
    ``predict_topk`` of both and of ``use_sharded=False`` equals a chunked
    top-k (values exact), 3 Adam steps at batch 4,096 through each give
    ``use_sharded=False``'s losses, with the peak memory and a profiled
    step; ring attention at M = 1 against the plain attention; the group
    is destroyed;
13. ``[cli]``: ``init-db``, ``view-db`` and ``serve --tiger-ckpt`` through
    ``cli``, in process and as a ``python3 -m genrec_tpu_torch.cli serve``
    subprocess answering the same lists (the card's machine has no h5py, so
    ``synth`` and the training subcommands, whose files are H5, are held by
    the CPU tests);
14. ``[bf16]`` kernels (right after 3): #1 and #2 with bf16 q, k, v and do
    against their plain bf16 versions at the TIGER, TIGER-prefix and DenseT5
    train shapes with the f32 dropout mask and without, and the serving
    shape: out within one bf16 ulp at max|plain|, dq/dk/dv within
    2^-8·max|plain|, dbias within 1e-4·max + 1e-5, every output at most
    1.25x as far from the f64 result as the plain bf16 version, two calls
    bit-identical; times beside bf16 SDPA, bounds at bf16 I/O, shared
    memory, blocks per SM, registers and local memory (none at D=16); the
    same checks, untimed, at D=64 and 128 (L=80), their launches counted
    apart;
15. ``[bf16]`` path (after 9): the T5 stack at ``arch.dtype="bfloat16"`` —
    a B=16 TIGER step against the CPU's bf16 step, 3 epochs of TIGER
    training and ``evaluate`` (Recall@10 at least half of 6's f32 figure),
    ``tiger_model_fn`` requests and a B=256 generate against the CPU, B=16
    TIGER-prefix and DenseT5 steps against the CPU, a profiled step;
16. ``[remat]``: a B=256 TIGER step at dropout 0.1 with each of ``remat``,
    ``attn_remat_dropout`` and ``ffn_remat_dropout`` and with all three,
    against the plain step from same-seeded CUDA generators (loss and
    gradients within 1e-6), with each step's peak memory and device ms;
17. ``[tp]``, right after 12: dense tensor parallelism over the mesh's
    'model' axis with two gloo ranks on ``cuda:0`` (this script started
    again as ``chip_smoke.py --tp-rank <rank> <world> <rdv> <out>``; the
    parent builds the kernels first) on the 1 × 2 mesh: a B=256 TIGER step
    at dropout 0.1, 2 heads and 128 of d_ff a rank, against the one-device
    step (loss and every gathered gradient within the backward's bound;
    kernels #1 and #2 6 + 6 times a rank at (2·256, L, 16)); one epoch of
    ``tiger_pipeline.train`` whose loss equals 6's first within rtol 2e-4,
    its checkpoint served whole on one device by ``tiger_model_fn`` with
    the lists of 12's one-device epoch checkpoint; the parity SASRec's
    700-row table cut in two against the whole table over 2 SGD steps, a
    701-row table left whole; a profiled step a rank. Any rank's failure
    fails the smoke;
18. ``[profile-dir]``: ``tiger_pipeline.train`` for 2 epochs with
    ``trainer.profile_dir``: one trace file, the second epoch's range only,
    #1 and #2 at 6 kernel events a step of that epoch, the reduction at 4;
19. ``[len-buckets]``, right after 6: ``tiger_pipeline.train`` at
    ``TIGERConfig(target_len_buckets=4)`` for 2 epochs at batch 256 and
    dropout 0.1 on the TIGER corpus of 6: the buckets' widths (44, 80, 120,
    156) and rows, 18 steps an epoch, 6 + 6 launches of #1 and #2 and 4 of
    the reduction a step plus validation, the (Lq, Lk) pairs of #1 and #2
    (44 and 120 among them), falling losses, examples/s beside 6's, a
    profiled step at each width; #1 and #2 against their plain versions at
    (4·256, 44 and 120, 16) decoder self-attention and (4·256, 44 → 80, 16)
    cross-attention, with the f32 dropout mask and without, at the
    tolerances of 3; one epoch of the first 64 rows at batch 16, 2 buckets
    and dropout 0 on the card and on the CPU, losses within 1e-4 relative;
20. ``[composite]``: the same at ``target_len_composite=4`` (width groups
    with half their slots filled by shorter rows): the widths that ran, the
    steps, launches, losses, examples/s, a profiled step at each width and
    the 64-row epoch against the CPU;
21. ``[data]``, before 4: the native batch packer built with g++ from
    ``genrec_tpu_torch/native/packer.cpp``; the TIGER, SASRec and DenseT5
    train arrays of the TIGER corpus bit-equal to the Python path's, each
    path's seconds;
22. print one JSON line of kernel records, the card line, and last the
    ``{"ok": true, "device": ...}`` line.

Kernel launch counts are set to 0 just before each of the paths 5-13 and
15-20 and read just after, and must equal what the path ran.

TF32 is off for matmuls and cuDNN throughout, so f32 means f32, and a bf16
GEMM sums in f32 (``allow_bf16_reduced_precision_reduction`` off), as XLA's
does.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5          # kernel vs plain version, max abs, f32
WIDE_TOL = 4 * TOL  # kernel #1 at D > 64 only: the scores reach |q·k| ≈ 50 at D = 128, where
                    # the f32 spacing is 3.8e-6; there the plain f32 version itself lies 1.1e-5
                    # from the f64 forward and the kernel 4.7e-6 (H100), so the two f32 results
                    # may differ by more than TOL; the smoke prints both distances from f64
BWD_REL = 1e-4      # backward: max abs <= BWD_REL * max|plain| + TOL (3xTF32 products, an
                    # online f32 delta, other summation orders: kernel #2 measured within
                    # 2.8e-6 of the max on an H100, where one TF32 pass on the scores gives
                    # 1.5e-3 against f64; see bwd_error_sources)
GEN_TOL = 1e-4      # batched generate scores, card vs CPU
LOSS_REL = 1e-6     # long-context step loss (~53, a sum of B·L·65 terms), card vs f64:
                    # relative, a few f32 epsilons (1.2e-7)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
TF32X3_OPS_PER_S = 495e12 / 3  # H100 SXM dense TF32 tensor cores, three passes a product
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
N_ITEMS = 700
TOP_K = 10
BATCH = 256
BEAMS = 20
TRAIN_USERS = 4096
TRAIN_EPOCHS = 3
STEP_B = 16
RQ_EPOCHS = 20          # RQ-VAE: the reference trains 100 epochs
DENSE_EPOCHS = 2        # DenseT5: the reference trains 100 epochs
GREEDY_MARGIN = 1e-4    # greedy codes, card vs CPU: rows whose top-2 margin exceeds this share
                        # of the row's scale must be equal
KERNEL_SOURCES = ("t5_attention_fwd", "t5_attention_bwd", "flash_attention_fwd",
                  "flash_attention_bwd")
LC_L, LC_B, LC_STEPS = 2048, 32, 20      # long-context SASRec: train and batched serve
LC_L2, LC_B2, LC_STEPS2 = 4096, 16, 3    # the longer history (kernels #4 and #6)
LC_PARITY_B = 2


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cpu_line() -> str:
    """The host CPU's model and the instruction set torch's CPU kernels use
    (the CPU's bf16 results depend on it)."""
    name = "unknown"
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as f:
            name = next((ln.split(":", 1)[1].strip() for ln in f
                         if ln.startswith("model name")), name)
    return f"{name}, {torch.backends.cpu.get_cpu_capability()}, {torch.get_num_threads()} threads"


def cuda_ms(fn, iters: int, windows: int = 5) -> float:
    """Time per call of ``fn`` (CUDA events): the median over ``windows`` of
    the mean over ``iters`` back-to-back calls, so that a window in which the
    shared host stalled does not move the reading."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def device_events(prof):
    """The profiler's device operations, without user-annotation ranges
    (such as ``Optimizer.step#Adam.step``), which span operations that are
    counted on their own."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn``: the durations of the device operations it
    ran, from torch.profiler, without the host's gaps between launches. At
    small shapes the CUDA-event time of back-to-back calls is the host's time
    per call; this is the card's. If three traces in a row hold no device
    events (it has happened on a fresh machine), the CUDA-event time per call
    stands in, and a line says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler has now and then returned a trace with no device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in device_events(prof))
        if us > 0:
            return us / iters / 1e3
    print("[profile] 3 traces held no device events: CUDA-event ms per call in place of "
          "device ms")
    return cuda_ms(fn, iters)


def attention_case(name, h, b, lq, lk, d, *, causal=False, bias=True, pad=True,
                   causal_in_bias=False, fully_masked=False, dropout=False, bias_offset=0.0,
                   prefix=0, rate=0.1, right_pad=False, seed=0):
    """Inputs of one kernel case, made from a seed with numpy, on the card.
    ``causal_in_bias`` folds the causal −1e9 into the bias, as the decoder
    passes it; ``bias_offset`` is added to every bias value (the softmax
    does not change; exp of an unshifted score would overflow); ``prefix``
    keys before the left-padded history are never masked, as TIGER-prefix's
    3 prefix tokens; ``right_pad`` pads the keys on the right, as DenseT5's
    user vector and items are (key 0 always valid); the dropout mask keeps
    each probability with 1 − ``rate`` and scales it by 1/(1 − rate) in f32."""
    r = np.random.default_rng(seed)
    dev = "cuda"
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    args = dict(qf=t(r.normal(size=(h * b, lq, d))), kf=t(r.normal(size=(h * b, lk, d))),
                vf=t(r.normal(size=(h * b, lk, d))), h=h, pos_bias=None, kv_mask=None,
                causal=causal, dropout_mask=None)
    if bias:
        args["pos_bias"] = t(r.normal(size=(h, lq, lk)))
    if pad:  # left padding, as the serving path pads histories, unless right_pad
        valid = r.integers(1, lk + 1, size=b)
        mask = (np.arange(lk)[None, :] >= lk - valid[:, None]).astype(np.int32)
        if right_pad:
            mask = mask[:, ::-1].copy()
        mask[:, :prefix] = 1
        if fully_masked:
            mask[0] = 0
        args["kv_mask"] = torch.from_numpy(mask).to(dev)
    if dropout:
        keep = r.random((h * b, lq, lk)) > rate
        args["dropout_mask"] = t(np.where(keep, 1.0 / (1.0 - rate), 0.0))
    if causal_in_bias:
        row = torch.arange(lq, device=dev)[:, None]
        col = torch.arange(lk, device=dev)[None, :]
        args["pos_bias"] = (args["pos_bias"] + torch.where(col > row, -1e9, 0.0)).contiguous()
    if bias_offset:
        args["pos_bias"] = (args["pos_bias"] + bias_offset).contiguous()
    return name, args


def sdpa_inputs(a):
    """The same function as one dense-mask scaled_dot_product_attention call
    (scale 1, additive mask), in a (H, B, L, D) view of the flat layout."""
    qf, kf, vf, h = a["qf"], a["kf"], a["vf"], a["h"]
    hb, lq, d = qf.shape
    lk = kf.shape[1]
    b = hb // h
    add = torch.zeros(h, b, lq, lk, device=qf.device)
    if a["pos_bias"] is not None:
        add = add + a["pos_bias"][:, None]
    if a["causal"]:
        row = torch.arange(lq, device=qf.device)[:, None]
        col = torch.arange(lk, device=qf.device)[None, :]
        add = add + torch.where(col > row + (lk - lq), -1e9, 0.0)
    if a["kv_mask"] is not None:
        add = add + ((1.0 - a["kv_mask"].float()) * -1e9)[None, :, None, :]
    return (qf.view(h, b, lq, d), kf.view(h, b, lk, d), vf.view(h, b, lk, d),
            add.to(qf.dtype))  # SDPA takes the mask in q's dtype


def _bound(nbytes: int, ops: int) -> tuple:
    """(ms, what bounds it): the larger of the bytes at the HBM rate and the
    f32 operations at the f32 rate outside the tensor cores."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_bound_ms(a) -> dict:
    """Least time on the card for the forward's work: each input read once
    and the output written once at the HBM rate, against the operations per
    score: 4·D for the products q·k and p·v, 7 for bias, mask, max,
    subtract, exp, sum and divide, 1 more with a dropout mask.

    Two bounds, as :func:`bwd_bound_ms` gives: ``"f32"`` counts every
    operation at the f32 rate outside the tensor cores; ``"tf32x3"`` counts
    the products at the 3xTF32 tensor-core rate (495/3 TFLOP/s), as kernel
    #1 computes them, and the rest at the f32 rate, the two pipes
    overlapping. Each is (ms, what bounds it)."""
    qf, kf, vf = a["qf"], a["kf"], a["vf"]
    hb, lq, d = qf.shape
    lk = kf.shape[1]
    nbytes = sum(x.numel() * x.element_size() for x in (qf, kf, vf, qf))  # out = q's size
    for key in ("pos_bias", "kv_mask", "dropout_mask"):
        if a[key] is not None:
            nbytes += a[key].numel() * 4  # the mask goes to the kernel as int32
    scores = hb * lq * lk
    rest = 7 + (1 if a["dropout_mask"] is not None else 0)
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "tensor cores": 4 * d * scores / TF32X3_OPS_PER_S * 1e3,
             "f32 operations": rest * scores / F32_OPS_PER_S * 1e3}
    by = max(times, key=times.get)
    return {"f32": _bound(nbytes, scores * (4 * d + rest)),
            "tf32x3": (times[by], "bytes" if by == "bytes" else "operations"),
            "bf16": _overlapped(times, 4 * d * scores)}


def _overlapped(times: dict, products: int) -> tuple:
    """(ms, what bounds it) with the products at the bf16 tensor-core rate,
    the rest of ``times`` as given, the pipes overlapping."""
    t = dict(times, **{"tensor cores": products / BF16_OPS_PER_S * 1e3})
    by = max(t, key=t.get)
    return t[by], "bytes" if by == "bytes" else "operations"


FWD_TRAIN = ("enc_train", "dec_self_train", "cross_train")
# TIGERPrefixConfig()'s new shapes for kernels #1 and #2 at batch 256 and 8 heads: the
# encoder's self-attention over 3 prefix + 80 history tokens, and the decoder's
# cross-attention from the 156-token train targets to them (name, Lq, Lk, bias, seed)
PREFIX_CASES = (("prefix_enc", 83, 83, True, 31), ("prefix_cross", 156, 83, False, 32))
PREFIX_SHAPES = tuple(c[0] for c in PREFIX_CASES)
# DenseT5Config() at batch 256: 4 heads of 16 over the user vector + 20 items, the keys
# right-padded, a bidirectional bias and no causal mask, the f32 dropout mask at rate 0.3;
# a served request is B = 1 (4 flat rows)
DENSE_L, DENSE_RATE = 21, 0.3
DENSE_SHAPES = ("dense_train", "dense_serve")


def ptxas_report(log: str, kernel: str) -> dict:
    """{mangled name: (registers, spill store bytes, spill load bytes)} of
    each instantiation of ``kernel`` in an ``nvcc -Xptxas -v`` log."""
    out, name, spill = {}, None, (None, None)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spill)
            name = None
    return out


def f64_forward(a):
    """The plain forward in f64 on the same inputs: the exact function."""
    from genrec_tpu_torch.ops import t5_attention as ta

    d = lambda x: None if x is None else x.double()  # noqa: E731
    return ta.t5_attention_reference(d(a["qf"]), d(a["kf"]), d(a["vf"]), a["h"],
                                     d(a["pos_bias"]), a["kv_mask"], causal=a["causal"],
                                     dropout_mask=d(a["dropout_mask"]))


def fwd_error_sources(a, got) -> dict:
    """Where kernel #1's distance from the exact forward comes from: max|x −
    f64| (absolute, as ``TOL`` is) for the kernel's output ``got``, the
    plain version in f32, and the f64 forward with one stage taken as the
    kernel takes it: ``scores_tf32x3`` q·kᵀ in 3xTF32 (``scores_tf32_one_pass``
    one TF32 pass), the rest exact; ``pv_tf32x3`` the exact p·dm rounded to
    f32, then ·V in 3xTF32. ``max_abs_f64`` is the f64 output's largest value."""
    from genrec_tpu_torch.ops import t5_attention as ta

    q, k, v, h = a["qf"], a["kf"], a["vf"], a["h"]
    kt = k.transpose(1, 2).contiguous()
    hb, lk = q.shape[0], k.shape[1]
    bias = None if a["pos_bias"] is None else a["pos_bias"].double()
    dm = None if a["dropout_mask"] is None else a["dropout_mask"].double()
    eye = torch.eye(lk, dtype=torch.float64, device=q.device).expand(hb, lk, lk)

    def probs(qk):  # p·dm in f64 from given score products: the port's own _probs
        p = ta._probs(qk.double(), eye, h, bias, a["kv_mask"], a["causal"])
        return p if dm is None else p * dm

    pd = probs(torch.bmm(q.double(), kt.double()))
    exact = torch.bmm(pd, v.double())
    err = lambda x: (x.double() - exact).abs().max().item()  # noqa: E731
    out = {"max_abs_f64": exact.abs().max().item(), "kernel": err(got),
           "plain_f32": err(ta.t5_attention_reference(
               q, k, v, h, a["pos_bias"], a["kv_mask"], causal=a["causal"],
               dropout_mask=a["dropout_mask"])),
           "pv_tf32x3": err(_bmm_tf32x3(pd.float(), v))}
    del pd
    one_pass = lambda x, y: torch.bmm(_tf32(x), _tf32(y))  # noqa: E731
    for key, mm in (("scores_tf32x3", _bmm_tf32x3), ("scores_tf32_one_pass", one_pass)):
        out[key] = err(torch.bmm(probs(mm(q, kt)), v.double()))
    del exact
    torch.cuda.empty_cache()
    return out


def fwd_case_check(name, a, *, repeat=False, detail=False) -> dict:
    """Kernel #1 against its plain version at one case (within ``TOL``, or
    ``WIDE_TOL`` at D > 64) and against the f64 forward; its time, device
    time, both bounds and SDPA's (without a dropout mask); with ``repeat``
    two calls bit-identical; with ``detail`` its shared memory, blocks per
    SM and where its distance from f64 comes from."""
    from genrec_tpu_torch.ops import t5_attention as ta

    kw = dict(causal=a["causal"], dropout_mask=a["dropout_mask"])
    args = (a["qf"], a["kf"], a["vf"], a["h"], a["pos_bias"], a["kv_mask"])
    rate = 0.1 if a["dropout_mask"] is not None else 0.0
    out = ta.fused_t5_attention_flat(*args, dropout_rate=rate, **kw)
    ref = ta.t5_attention_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all(), f"{name}: non-finite kernel output"
    err = (out - ref).abs().max().item()
    exact = f64_forward(a)
    err64, plain64 = [(x.double() - exact).abs().max().item() for x in (out, ref)]
    del exact
    tol = TOL if a["qf"].shape[2] <= 64 else WIDE_TOL
    assert err <= tol, f"{name}: kernel vs plain max abs {err} > {tol}"
    if repeat:
        again = ta.fused_t5_attention_flat(*args, dropout_rate=rate, **kw)
        assert torch.equal(out, again), f"{name}: two calls differ"
        print(f"[kernel] t5_attention_fwd {name}: out bit-identical between two calls")
    iters = 200 if name in ("serve", "bench", "dense_serve") else 20
    kernel = lambda: ta.fused_t5_attention_flat(*args, dropout_rate=rate, **kw)  # noqa: E731
    plain = lambda: ta.t5_attention_reference(*args, **kw)  # noqa: E731
    fns = [kernel, plain]
    if a["dropout_mask"] is None:  # no library call takes a given dropout mask
        q4, k4, v4, add = sdpa_inputs(a)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        fns.append(lambda: sdpa(q4, k4, v4, attn_mask=add, scale=1.0))
    ms, plain_ms, library_ms = [cuda_ms(f, iters) for f in fns] + [None] * (3 - len(fns))
    dev = [device_ms(f) for f in fns] + [None] * (3 - len(fns))
    bounds = attention_bound_ms(a)
    (bound_ms, bound_by), (f32_ms, f32_by) = bounds["tf32x3"], bounds["f32"]
    res = dict(max_abs_err=err, tol=tol, f64_err=err64, plain_f64_err=plain64,
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               bound_ms_f32=f32_ms, library_ms=library_ms, device_ms=dev[0],
               plain_device_ms=dev[1], library_device_ms=dev[2])
    print(f"[kernel] t5_attention_fwd {name} shape={tuple(a['qf'].shape)} "
          f"lk={a['kf'].shape[1]} dropout={a['dropout_mask'] is not None} "
          f"max_abs_err={err:.3e} (tolerance {tol:.0e}; against f64: kernel {err64:.3e}, "
          f"plain {plain64:.3e}) | per call (CUDA events): ms={ms:.5f} "
          f"plain_ms={plain_ms:.5f} library_ms={library_ms} | device only (profiler): "
          f"ms={dev[0]:.5f} plain_ms={dev[1]:.5f} library_ms={dev[2]} | "
          f"bound_ms={bound_ms:.6f} ({bound_by}, 3xTF32 products), f32-SIMT "
          f"{f32_ms:.6f} ({f32_by})")
    if detail:
        lq, lk, d = a["qf"].shape[1], a["kf"].shape[1], a["qf"].shape[2]
        smem, per_sm = ta.fwd_occupancy(lq, lk, d)
        res.update(smem_bytes=smem, blocks_per_sm=per_sm)
        print(f"[kernel] t5_attention_fwd {name}: {smem} bytes of shared memory per block, "
              f"{per_sm} blocks resident per SM")
        src = fwd_error_sources(a, out)
        res["error_sources"] = src
        print(f"[kernel] t5_attention_fwd {name} against the f64 forward (max|f64| "
              f"{src['max_abs_f64']:.4f}), max|x - f64|: " + "; ".join(
                  f"{key} {e:.3e}" for key, e in src.items() if key != "max_abs_f64"))
    return res


def phase_kernels():
    """Build every kernel; then kernel #1 against its plain version on the
    card (within ``TOL``) at the serving shapes, the three train shapes of
    TIGERConfig() at batch 256 with the f32 dropout mask and without it, and
    edge cases; the encoder and cross-attention shapes of
    TIGERPrefixConfig() (8 heads, 83 encoder tokens) at batch 256 with and
    without the mask; times, both bounds and SDPA beside each; bit-identical
    outputs of two calls at the encoder and decoder train shapes and the
    TIGER-prefix shapes; shared
    memory, blocks per SM, ptxas registers and spills; at the train shapes,
    the distance from the f64 forward and where it comes from. Returns the
    results by case and the ptxas report of #1's instantiations."""
    from genrec_tpu_torch.ops import _build
    from genrec_tpu_torch.ops import t5_attention as ta

    from genrec_tpu_torch.ops import attention as fa

    t0 = time.perf_counter()
    _build.build_all(KERNEL_SOURCES)  # one nvcc each, all together
    ta.load_kernel()
    ta.load_bwd_kernel()
    fa.load_fwd_kernel()
    fa.load_bwd_kernel()
    print(f"[build] {', '.join(KERNEL_SOURCES)} built and loaded in "
          f"{time.perf_counter() - t0:.3f} s")
    for name, (secs, log) in _build.build_log.items():
        print(f"[build] {name}: nvcc {secs:.3f} s\n{log.strip()}")
    log = _build.build_log.get("t5_attention_fwd")
    ptxas = ptxas_report(log[1], "t5_attention_fwd_kernel") if log else {}
    for fn, (regs, stores, loads) in ptxas.items():
        print(f"[build] ptxas {fn}: {regs} registers, {stores} bytes spill stores, "
              f"{loads} bytes spill loads")

    cases = [
        attention_case("serve", 4, 1, 80, 80, 16, seed=1),
        attention_case("bench", 4, BATCH, 80, 80, 16, seed=2),
        attention_case("causal", 2, 3, 12, 12, 8, causal=True, seed=3),
        attention_case("lq!=lk_causal", 2, 3, 12, 10, 8, causal=True, seed=4),
        attention_case("dropout_mask", 2, 3, 12, 10, 8, dropout=True, seed=5),
        attention_case("fully_masked_rows", 2, 3, 12, 10, 8, fully_masked=True, seed=6),
        attention_case("decoder_train_156", 4, 16, 156, 156, 16, causal=True, pad=False,
                       seed=7),
        attention_case("smem_over_48KB", 1, 2, 64, 400, 16, seed=8),
        # the train shapes of TIGERConfig() at batch 256, as the T5 passes them
        attention_case("enc_train", 4, BATCH, 80, 80, 16, dropout=True, seed=11),
        attention_case("dec_self_train", 4, BATCH, 156, 156, 16, pad=False, causal_in_bias=True,
                       dropout=True, seed=12),
        attention_case("cross_train", 4, BATCH, 156, 80, 16, bias=False, dropout=True, seed=13),
        attention_case("enc_train_no_dropout", 4, BATCH, 80, 80, 16, seed=11),
        attention_case("dec_self_train_no_dropout", 4, BATCH, 156, 156, 16, pad=False,
                       causal_in_bias=True, seed=12),
        attention_case("cross_train_no_dropout", 4, BATCH, 156, 80, 16, bias=False, seed=13),
        # TIGERPrefixConfig() at batch 256: 8 heads, 3 prefix + 80 history tokens
        *[attention_case(name + tail, 8, BATCH, lq, lk, 16, bias=bias, dropout=not tail,
                         prefix=3, seed=seed)
          for name, lq, lk, bias, seed in PREFIX_CASES for tail in ("", "_no_dropout")],
        # ragged edges: A fragments reloaded; a ragged D; padding query rows
        # (156 -> 160) under a bias that e^s would overflow; padding keys
        # beside a fully masked row (they must score -inf, not -1e9)
        attention_case("d128_80", 2, 3, 80, 80, 128, seed=20),
        attention_case("d72_lq!=lk_causal", 2, 3, 40, 56, 72, causal=True, seed=21),
        attention_case("bias+100_lq156", 2, 3, 156, 156, 16, bias_offset=100.0, seed=19),
        attention_case("fully_masked_lq156", 2, 3, 156, 156, 16, fully_masked=True, seed=22),
        # DenseT5Config(): 21 queries fill 2 strips of 16 and 21 keys 2 tiles of 8 and a
        # tail of 5; 84-byte bias rows; padding query rows 21 -> 32 under a bias that e^s
        # would overflow
        attention_case("dense_train", 4, BATCH, DENSE_L, DENSE_L, 16, dropout=True,
                       rate=DENSE_RATE, right_pad=True, seed=41),
        attention_case("dense_train_no_dropout", 4, BATCH, DENSE_L, DENSE_L, 16,
                       right_pad=True, seed=41),
        attention_case("dense_serve", 4, 1, DENSE_L, DENSE_L, 16, right_pad=True, seed=42),
        attention_case("bias+100_l21", 4, 3, DENSE_L, DENSE_L, 16, bias_offset=100.0,
                       right_pad=True, seed=43),
    ]
    results = {name: fwd_case_check(
        name, a, repeat=name in ("enc_train", "dec_self_train", *PREFIX_SHAPES, *DENSE_SHAPES),
        detail=name in (*FWD_TRAIN, "dense_train")) for name, a in cases}
    for name in (*FWD_TRAIN, "dense_train"):
        r, r0 = results[name], results[f"{name}_no_dropout"]
        print(f"[kernel] t5_attention_fwd {name}: device ms {r['device_ms']:.5f} with the dropout "
              f"mask (bound {r['bound_ms']:.5f}), {r0['device_ms']:.5f} without (bound "
              f"{r0['bound_ms']:.5f}) against SDPA's {r0['library_device_ms']}")
    return results, ptxas


def bwd_case(name, h, b, lq, lk, d, *, causal=False, bias=True, pad=True, causal_in_bias=False,
             fully_masked=False, dropout=True, bias_offset=0.0, prefix=0, rate=0.1,
             right_pad=False, seed=0):
    """Inputs of one backward case (the forward's inputs of
    :func:`attention_case` plus an output gradient), on the card."""
    name, a = attention_case(name, h, b, lq, lk, d, causal=causal, bias=bias, pad=pad,
                             causal_in_bias=causal_in_bias, fully_masked=fully_masked,
                             dropout=dropout, bias_offset=bias_offset, prefix=prefix,
                             rate=rate, right_pad=right_pad, seed=seed)
    r = np.random.default_rng(seed + 1000)
    a["do"] = torch.from_numpy(r.normal(size=(h * b, lq, d)).astype(np.float32)).cuda()
    return name, a


def bwd_bound_ms(a) -> dict:
    """Least time on the card for the backward's work: q, k, v, do, the bias,
    the key mask (int32) and the dropout mask read once, dq, dk, dv and dbias
    written once, at the HBM rate; against the operations per score: 10·D
    for the five products (q·k and do·v recomputed, ds·k, dsᵀ·q, (p·dm)ᵀ·do),
    7 for the softmax recompute (as the forward), 4 for ds = p·(dp − Σ dp·p),
    2 more with a dropout mask (dp·dm, p·dm) and 1 for the dbias sum.

    Two bounds: ``"f32"`` counts every operation at the f32 rate outside the
    tensor cores (the rule of the other kernels' rows); ``"tf32x3"`` counts
    the products at the 3xTF32 tensor-core rate (495/3 TFLOP/s), as kernel
    #2 computes them, and the rest at the f32 rate, the two pipes
    overlapping. Each is (ms, what bounds it)."""
    qf, kf = a["qf"], a["kf"]
    hb, lq, d = qf.shape
    lk = kf.shape[1]
    nbytes = 2 * sum(x.numel() * x.element_size()  # in and grad out
                     for x in (a["qf"], a["kf"], a["vf"]))
    nbytes += a["do"].numel() * a["do"].element_size()
    for key in ("kv_mask", "dropout_mask"):
        if a[key] is not None:
            nbytes += a[key].numel() * 4
    rest = 7 + 4
    if a["pos_bias"] is not None:
        nbytes += 2 * a["pos_bias"].numel() * 4  # bias in, dbias out
        rest += 1
    if a["dropout_mask"] is not None:
        rest += 2
    scores = hb * lq * lk
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    times = {"bytes": t_bytes, "tensor cores": 10 * d * scores / TF32X3_OPS_PER_S * 1e3,
             "f32 operations": rest * scores / F32_OPS_PER_S * 1e3}
    by = max(times, key=times.get)
    return {"f32": _bound(nbytes, scores * (10 * d + rest)),
            "tf32x3": (times[by], "bytes" if by == "bytes" else "operations"),
            "bf16": _overlapped(times, 10 * d * scores)}


def sdpa_backward(a):
    """The library yardstick of the backward: autograd through one
    scaled_dot_product_attention call (scale 1) whose additive mask holds the
    grad-requiring bias, without the dropout mask (no library call takes a
    given one). Returns a function that runs the backward alone, or None with
    the reason when this PyTorch refuses the mask gradient."""
    q4, k4, v4, _ = sdpa_inputs(a)
    h, lq, lk = q4.shape[0], q4.shape[2], k4.shape[2]
    leaves = [t.detach().clone().requires_grad_(True) for t in (q4, k4, v4)]
    bias = (a["pos_bias"] if a["pos_bias"] is not None
            else torch.zeros(h, lq, lk, device="cuda"))
    bias = bias[:, None].detach().to(q4.dtype).requires_grad_(True)
    add = bias
    if a["causal"]:
        row = torch.arange(lq, device="cuda")[:, None]
        col = torch.arange(lk, device="cuda")[None, :]
        add = add + torch.where(col > row + (lk - lq), -1e9, 0.0)
    if a["kv_mask"] is not None:
        add = add + ((1.0 - a["kv_mask"].float()) * -1e9)[None, :, None, :]
    add = add.to(q4.dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        out = sdpa(*leaves, attn_mask=add, scale=1.0)
        do = a["do"].view_as(out)
        grads = lambda: torch.autograd.grad(out, leaves + [bias], do,  # noqa: E731
                                            retain_graph=True)
        grads()
        torch.cuda.synchronize()
    except RuntimeError as e:  # the yardstick only: the port never calls it
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    return grads, None


TRAIN_SHAPES = ("enc_train", "dec_self_train", "cross_train")


def _tf32(x):
    """f32 rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero), as ``cvt.rna.tf32.f32`` and kernel #2's ``to_tf32`` round it."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _bmm_tf32x3(x, y):
    """x·y as kernel #2 takes a product: each operand split into a TF32 hi
    and lo, lo·hi + hi·lo + hi·hi summed in f32 (cuBLAS f32 products of TF32
    values, which are exact; TF32 is off)."""
    xh, yh = _tf32(x), _tf32(y)
    xl, yl = _tf32(x - xh), _tf32(y - yh)
    return torch.bmm(xl, yh) + torch.bmm(xh, yl) + torch.bmm(xh, yh)


def _scores_f64_from_products(a, qk, dov):
    """(ds, p·dm) of the plain backward in f64 from given score products
    q·kᵀ and do·vᵀ: the port's own ``_bwd_scores`` with the products as q
    and do against identity keys and values, so every step after the two
    products is exact."""
    from genrec_tpu_torch.ops import t5_attention as ta

    hb, lq, lk = qk.shape
    eye = torch.eye(lk, dtype=torch.float64, device=qk.device).expand(hb, lk, lk)
    bias = None if a["pos_bias"] is None else a["pos_bias"].double()
    return ta._bwd_scores(qk.double(), eye, eye, a["h"], bias, a["kv_mask"], dov.double(),
                          a["causal"], a["dropout_mask"])


def _online_delta_f32(s, dp):
    """delta = Σ_j p·dp·dm per query row as kernel #2's pass 1 takes it, in
    f32: lane t of a quad walks keys 2t and 2t + 1 of each 8-key tile with a
    running max m, l = Σ e^(s−m) and u = Σ e^(s−m)·dp (rescaled when m
    grows), then the four lanes combine (xor 1, then xor 2) and delta =
    u / max(l, 1e-30). ``s`` holds the scores with their −1e9 terms and
    ``dp`` the products times the dropout mask, (H·B, Lq, Lk) f32."""
    hb, lq, lk = s.shape
    lkp = -(-lk // 16) * 16
    s = torch.nn.functional.pad(s, (0, lkp - lk), value=-float("inf")).view(hb, lq, -1, 4, 2)
    dp = torch.nn.functional.pad(dp, (0, lkp - lk)).view(hb, lq, -1, 4, 2)
    m = torch.full((hb, lq, 4), -torch.finfo(torch.float32).max, device=s.device)
    l, u = torch.zeros_like(m), torch.zeros_like(m)
    for n in range(lkp // 8):
        x, y = s[:, :, n], dp[:, :, n]
        mx = torch.maximum(m, x.amax(dim=-1))
        scale = torch.exp(m - mx)
        e = torch.exp(x - mx[..., None])
        l = l * scale + e[..., 0] + e[..., 1]
        u = u * scale + e[..., 0] * y[..., 0] + e[..., 1] * y[..., 1]
        m = mx
    for off in (1, 2):
        perm = torch.arange(4, device=s.device) ^ off
        mo, lo, uo = m[..., perm], l[..., perm], u[..., perm]
        mx = torch.maximum(m, mo)
        a, b = torch.exp(m - mx), torch.exp(mo - mx)
        l, u, m = l * a + lo * b, u * a + uo * b, mx
    return u[..., 0] / torch.clamp(l[..., 0], min=1e-30)


BWD_GRADS = ("dq", "dk", "dv", "dbias")


def bwd_error_sources(a, got) -> dict:
    """Where kernel #2's distance from the exact backward comes from: per
    gradient, max|x − exact| / max|exact| against the f64 backward, for the
    kernel's gradients ``got``, the plain version in f32, and the f64
    backward with one stage taken as the kernel takes it:
    ``scores_tf32x3`` q·kᵀ and do·vᵀ in 3xTF32 (``scores_tf32_one_pass``:
    one TF32 pass), the rest exact; ``outputs_tf32x3`` the exact ds and p·dm
    rounded to f32, then ds·k, dsᵀ·q and (p·dm)ᵀ·do in 3xTF32 and dbias as
    the batch-order f32 sum of the reduction kernel; ``delta_online_f32``
    delta = Σ p·dp·dm from the kernel's online pass in f32, the rest exact."""
    from genrec_tpu_torch.ops import t5_attention as ta

    h = a["h"]
    q, k, v, do = (a[x] for x in ("qf", "kf", "vf", "do"))
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    f64 = lambda x, y: torch.bmm(x.double(), y.double())  # noqa: E731
    tf32x3 = lambda x, y: _bmm_tf32x3(x.float().contiguous(), y.float().contiguous())  # noqa: E731

    def grads(ds, pd, mm, batch_sum):
        hb, lq, lk = ds.shape
        dbias = (None if a["pos_bias"] is None
                 else batch_sum(ds.view(h, hb // h, lq, lk)))
        return (mm(ds, k), mm(ds.transpose(1, 2), q), mm(pd.transpose(1, 2), do), dbias)

    ds, pd = _scores_f64_from_products(a, f64(q, kt), f64(do, vt))
    exact = grads(ds, pd, f64, lambda x: x.sum(dim=1))

    def rel(xs):
        return {n: (x.double() - e).abs().max().item() / e.abs().max().item()
                for n, x, e in zip(BWD_GRADS, xs, exact) if e is not None}

    out = {"kernel": rel(got),
           "plain_f32": rel(ta.t5_attention_bwd_reference(
               q, k, v, h, a["pos_bias"], a["kv_mask"], do, causal=a["causal"],
               dropout_mask=a["dropout_mask"])),
           "outputs_tf32x3": rel(grads(ds.float(), pd.float(), tf32x3,
                                       lambda x: ta.dbias_reduce_reference(x.contiguous())))}
    # delta from the kernel's online pass in f32 over its f32 scores; p, dp exact
    hb, lq, lk = ds.shape
    s32 = _bmm_tf32x3(q, kt).view(h, hb // h, lq, lk)
    if a["pos_bias"] is not None:
        s32 = s32 + a["pos_bias"][:, None]
    if a["causal"]:
        row = torch.arange(lq, device=q.device)[:, None]
        col = torch.arange(lk, device=q.device)[None, :]
        s32 = s32 + torch.where(col > row + (lk - lq), -1e9, 0.0)
    if a["kv_mask"] is not None:
        s32 = s32 + ((1.0 - a["kv_mask"].float()) * -1e9)[None, :, None, :]
    dm = a["dropout_mask"]
    dp32 = _bmm_tf32x3(do, vt) * (1.0 if dm is None else dm)
    delta = _online_delta_f32(s32.reshape(hb, lq, lk), dp32).double()[..., None]
    del s32, dp32
    eye = torch.eye(lk, dtype=torch.float64, device=q.device).expand(hb, lk, lk)
    p = ta._probs(f64(q, kt), eye, h, None if a["pos_bias"] is None else a["pos_bias"].double(),
                  a["kv_mask"], a["causal"])
    dp = f64(do, vt) * (1.0 if dm is None else dm.double())
    out["delta_online_f32"] = rel(grads(p * (dp - delta), pd, f64, lambda x: x.sum(dim=1)))
    del p, dp, delta
    one_pass = lambda x, y: torch.bmm(_tf32(x), _tf32(y))  # noqa: E731
    for key, mm in (("scores_tf32x3", _bmm_tf32x3), ("scores_tf32_one_pass", one_pass)):
        ds, pd = _scores_f64_from_products(a, mm(q, kt), mm(do, vt))
        out[key] = rel(grads(ds, pd, f64, lambda x: x.sum(dim=1)))
    del ds, pd, exact
    torch.cuda.empty_cache()
    return out


def phase_dbias_reduce():
    """The backward's dbias reduction kernel against its plain version (the
    same in-order sum, so bit-equal) on a random scratch buffer of the
    decoder shape, (4 heads, 256 batch rows, 156, 156); times and bound."""
    from genrec_tpu_torch.ops import t5_attention as ta

    r = np.random.default_rng(21)
    part = torch.from_numpy(r.normal(size=(4, BATCH, 156, 156)).astype(np.float32)).cuda()
    got, want = ta.t5_attention_dbias_reduce(part), ta.dbias_reduce_reference(part)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "dbias reduction: kernel and plain in-order sum differ"
    err = (got - want).abs().max().item()
    fns = [lambda: ta.t5_attention_dbias_reduce(part), lambda: ta.dbias_reduce_reference(part),
           lambda: part.sum(dim=1)]
    ms, plain_ms, library_ms = [cuda_ms(f, 20) for f in fns]
    dev = [device_ms(f, 10) for f in fns]
    nbytes = (part.numel() + want.numel()) * 4
    bound_ms, bound_by = _bound(nbytes, part.numel() - want.numel())
    print(f"[kernel] t5_attention_dbias_reduce part={tuple(part.shape)} bit-equal to the plain "
          f"in-order sum | per call (CUDA events): ms={ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms={library_ms:.5f} (sum over dim 1) | device only (profiler): "
          f"ms={dev[0]:.5f} plain_ms={dev[1]:.5f} library_ms={dev[2]:.5f} | "
          f"bound_ms={bound_ms:.6f} ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, device_ms=dev[0],
                plain_device_ms=dev[1], library_device_ms=dev[2])


def bwd_case_check(name, a, *, repeat=False, detail=False) -> dict:
    """Kernel #2 (and its dbias reduction) against its plain version at one
    case (within ``BWD_REL``·max|plain| + ``TOL``); its time, device time,
    both bounds and the SDPA backward's (without a dropout mask); with
    ``repeat`` two calls bit-identical; with ``detail`` its shared memory,
    blocks per SM and where its distance from the f64 backward comes from."""
    from genrec_tpu_torch.ops import t5_attention as ta

    args = (a["qf"], a["kf"], a["vf"], a["h"], a["pos_bias"], a["kv_mask"], a["do"])
    kw = dict(causal=a["causal"], dropout_mask=a["dropout_mask"])
    got = ta.t5_attention_bwd(*args, **kw)
    want = ta.t5_attention_bwd_reference(*args, **kw)
    torch.cuda.synchronize()
    errs, abs_errs = [], []
    for gname, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert (g is None) == (w is None), f"{name}: {gname} given on one side only"
        if g is None:
            continue
        assert torch.isfinite(g).all(), f"{name}: non-finite {gname}"
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        assert err <= BWD_REL * scale + TOL, (
            f"{name}: {gname} kernel vs plain max abs {err} > {BWD_REL}*{scale}+{TOL}")
        errs.append(err / (scale + 1e-30))
        abs_errs.append(err)
    rel = max(errs)
    kernel = lambda: ta.t5_attention_bwd(*args, **kw)  # noqa: E731
    plain = lambda: ta.t5_attention_bwd_reference(*args, **kw)  # noqa: E731
    fns = [kernel, plain]
    lib_note = "a given dropout mask: no library call takes one"
    if a["dropout_mask"] is None:
        lib, why = sdpa_backward(a)
        lib_note = why or "SDPA backward, bias gradient through the additive mask"
        if lib is not None:
            fns.append(lib)
    if repeat:
        again = ta.t5_attention_bwd(*args, **kw)
        same = [g is None or torch.equal(g, h) for g, h in zip(got, again)]
        assert all(same), f"{name}: two calls differ in (dq, dk, dv, dbias): {same}"
        print(f"[kernel] t5_attention_bwd {name}: dq, dk, dv and dbias bit-identical "
              f"between two calls")
    iters = 20
    ms, plain_ms, library_ms = [cuda_ms(f, iters) for f in fns] + [None] * (3 - len(fns))
    dev = [device_ms(f, 10) for f in fns] + [None] * (3 - len(fns))
    bounds = bwd_bound_ms(a)
    (bound_ms, bound_by), (f32_ms, f32_by) = bounds["tf32x3"], bounds["f32"]
    res = dict(max_rel_err=rel, max_abs_err=max(abs_errs), ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               bound_ms_f32=f32_ms, library_ms=library_ms, device_ms=dev[0],
               plain_device_ms=dev[1], library_device_ms=dev[2])
    print(f"[kernel] t5_attention_bwd {name} q={tuple(a['qf'].shape)} "
          f"lk={a['kf'].shape[1]} dropout={a['dropout_mask'] is not None} "
          f"max_err/max|ref|={rel:.3e} | per call (CUDA events): ms={ms:.5f} "
          f"plain_ms={plain_ms:.5f} library_ms={library_ms} | device only (profiler): "
          f"ms={dev[0]:.5f} plain_ms={dev[1]:.5f} library_ms={dev[2]} | "
          f"bound_ms={bound_ms:.6f} ({bound_by}, 3xTF32 products), f32-SIMT "
          f"{f32_ms:.6f} ({f32_by}) | library: {lib_note}")
    if detail:
        lq, lk, d = a["qf"].shape[1], a["kf"].shape[1], a["qf"].shape[2]
        smem, per_sm = ta.bwd_occupancy(lq, lk, d)
        res.update(smem_bytes=smem, blocks_per_sm=per_sm)
        print(f"[kernel] t5_attention_bwd {name}: {smem} bytes of shared memory per block, "
              f"{per_sm} blocks resident per SM")
        src = bwd_error_sources(a, got)
        res["error_sources"] = src
        print(f"[kernel] t5_attention_bwd {name} against the f64 backward, max|x - f64| / "
              f"max|f64| of " + ", ".join(src["kernel"]) + ": " + "; ".join(
                  f"{key} " + " ".join(f"{e:.3e}" for e in errs.values())
                  for key, errs in src.items()))
    return res


def phase_bwd_kernels():
    """Kernel #2 against its plain version on the card, at the three train
    shapes of TIGERConfig() at batch 256, the encoder and cross-attention
    shapes of TIGERPrefixConfig() and edge cases; times and bounds;
    bit-identical results from two calls at the encoder and decoder shapes
    and the TIGER-prefix shapes;
    shared memory and blocks per SM; at the train shapes with dropout, the
    distance from the f64 backward and where it comes from."""
    from genrec_tpu_torch.ops import t5_attention as ta

    ta.load_bwd_kernel()
    cases = [
        bwd_case("enc_train", 4, BATCH, 80, 80, 16, seed=11),
        bwd_case("dec_self_train", 4, BATCH, 156, 156, 16, pad=False, causal_in_bias=True,
                 seed=12),
        bwd_case("cross_train", 4, BATCH, 156, 80, 16, bias=False, seed=13),
        bwd_case("enc_train_no_dropout", 4, BATCH, 80, 80, 16, dropout=False, seed=11),
        bwd_case("dec_self_train_no_dropout", 4, BATCH, 156, 156, 16, pad=False,
                 causal_in_bias=True, dropout=False, seed=12),
        bwd_case("cross_train_no_dropout", 4, BATCH, 156, 80, 16, bias=False, dropout=False,
                 seed=13),
        *[bwd_case(name + tail, 8, BATCH, lq, lk, 16, bias=bias, dropout=not tail, prefix=3,
                   seed=seed)
          for name, lq, lk, bias, seed in PREFIX_CASES for tail in ("", "_no_dropout")],
        bwd_case("lq!=lk_causal", 2, 3, 12, 10, 8, causal=True, dropout=False, seed=14),
        bwd_case("dropout_mask", 2, 3, 12, 10, 8, seed=15),
        bwd_case("fully_masked_rows", 2, 3, 12, 10, 8, fully_masked=True, seed=16),
        bwd_case("b1_causal_156", 4, 1, 156, 156, 16, causal=True, pad=False, seed=17),
        bwd_case("smem_over_48KB_no_bias", 1, 2, 64, 200, 16, bias=False, seed=18),
        # padding query rows (156 -> 160) under a bias that e^s would overflow
        bwd_case("bias+100_lq156", 2, 3, 156, 156, 16, bias_offset=100.0, seed=19),
        bwd_case("d128_80", 2, 3, 80, 80, 128, seed=20),  # A fragments reloaded
        bwd_case("d72_lq!=lk_causal", 2, 3, 40, 56, 72, causal=True, seed=21),  # ragged D
        # DenseT5Config() at batch 256 (see phase_kernels), with the rate-0.3 mask and without
        bwd_case("dense_train", 4, BATCH, DENSE_L, DENSE_L, 16, rate=DENSE_RATE, right_pad=True,
                 seed=41),
        bwd_case("dense_train_no_dropout", 4, BATCH, DENSE_L, DENSE_L, 16, dropout=False,
                 right_pad=True, seed=41),
        bwd_case("bias+100_l21", 4, 3, DENSE_L, DENSE_L, 16, bias_offset=100.0, right_pad=True,
                 seed=43),
    ]
    results = {name: bwd_case_check(
        name, a, repeat=name in ("enc_train", "dec_self_train", *PREFIX_SHAPES, "dense_train"),
        detail=name in (*TRAIN_SHAPES, "dense_train")) for name, a in cases}
    for name in (*TRAIN_SHAPES, "dense_train"):
        r0 = results[f"{name}_no_dropout"]
        print(f"[kernel] t5_attention_bwd {name} without dropout: kernel {r0['ms']:.5f} ms "
              f"(device {r0['device_ms']:.5f}) against SDPA backward {r0['library_ms']} ms "
              f"(device {r0['library_device_ms']})")
    return results


def flash_case(name, bh, lq, lk, d, *, causal, bias=False, seed=0):
    """Inputs of one flash-kernel case (flat (B·H, L, D) f32 on the card, made
    from a seed with numpy), with the plain forward's (out, lse) of the
    bias-free inputs and an output gradient for the backward kernels, which
    take no bias (a biased backward recomputes in plain torch)."""
    from genrec_tpu_torch.ops import attention as fa

    r = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(r.normal(size=shape).astype(np.float32)).cuda()

    a = dict(qf=t(bh, lq, d), kf=t(bh, lk, d), vf=t(bh, lk, d), causal=causal,
             bias=t(bh, lq, lk) if bias else None, do=t(bh, lq, d))
    a["out"], a["lse"] = fa.flash_attention_fwd_reference(a["qf"], a["kf"], a["vf"],
                                                          causal=causal)
    a["delta"] = fa._delta(a["do"], a["out"])
    return name, a


def _unmasked_scores(a) -> int:
    bh, lq, _ = a["qf"].shape
    lk = a["kf"].shape[1]
    return bh * (lq * (lq + 1) // 2 if a["causal"] else lq * lk)


def flash_bounds(a) -> dict:
    """Least time on the card for each flash kernel's work, from this run's
    inputs: each input read once and each output written once at the HBM
    rate, against the operations per unmasked score: forward 4·D products
    (q·k, p·v) and 5 more (max, subtract, exp, sum, rescale) + 1 with a bias;
    dq 6·D products (q·k, do·v, ds·k) and 4 more (exp, subtract, subtract,
    multiply); dk/dv 8·D products (q·k, do·v, p·do, ds·q) and 4 more.

    For each kernel two bounds, as :func:`bwd_bound_ms` gives: ``"f32"``
    counts every operation at the f32 rate outside the tensor cores;
    ``"tf32x3"`` counts the products at the 3xTF32 tensor-core rate (495/3
    TFLOP/s), as the backward kernels compute them, and the rest at the f32
    rate, the two pipes overlapping. Each is (ms, what bounds it)."""
    bh, lq, d = a["qf"].shape
    lk = a["kf"].shape[1]
    n = _unmasked_scores(a)
    qb, kb, rowb = bh * lq * d * 4, bh * lk * d * 4, bh * lq * 4
    bias_b = 0 if a["bias"] is None else a["bias"].numel() * 4
    work = {  # bytes, products per score, other operations per score
        "fwd": (2 * qb + 2 * kb + rowb + bias_b, 4 * d, 5 + (a["bias"] is not None)),
        "dq": (3 * qb + 2 * kb + 2 * rowb, 6 * d, 4),     # q, do, dq; k, v; lse, delta
        "dkv": (2 * qb + 4 * kb + 2 * rowb, 8 * d, 4),    # q, do; k, v, dk, dv; lse, delta
    }
    out = {}
    for key, (nbytes, prods, rest) in work.items():
        times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "tensor cores": n * prods / TF32X3_OPS_PER_S * 1e3,
                 "f32 operations": n * rest / F32_OPS_PER_S * 1e3}
        by = max(times, key=times.get)
        out[key] = {"f32": _bound(nbytes, n * (prods + rest)),
                    "tf32x3": (times[by], "bytes" if by == "bytes" else "operations")}
    return out


def _sdpa_fwd_bwd(a):
    """The library yardsticks: one scaled_dot_product_attention call on the
    same inputs ((B·H, 1, L, D) views, default scale 1/√D, is_causal or the
    bias as attn_mask), and autograd through it without the bias. Timed only;
    the port never calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (a[k][:, None] for k in ("qf", "kf", "vf"))
    mask = None if a["bias"] is None else a["bias"][:, None]
    fwd = lambda: sdpa(q4, k4, v4, attn_mask=mask, is_causal=a["causal"])  # noqa: E731
    leaves = [x.detach().clone().requires_grad_(True) for x in (q4, k4, v4)]
    out = sdpa(*leaves, is_causal=a["causal"])
    do = a["do"][:, None]
    bwd = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)  # noqa: E731
    return fwd, bwd


def _worst(got, want):
    """Largest max|kernel − plain| / max|plain| over matching tensors, and the
    largest max abs; raises past BWD_REL·max|plain| + TOL."""
    rel, absolute = 0.0, 0.0
    for g, w in zip(got, want):
        assert torch.isfinite(g).all(), "non-finite kernel output"
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        assert err <= BWD_REL * scale + TOL, f"max abs {err} > {BWD_REL}*{scale}+{TOL}"
        rel, absolute = max(rel, err / (scale + 1e-30)), max(absolute, err)
    return rel, absolute


FLASH_DS = (16, 32, 64, 128)  # the flash kernels' instantiations: D padded to these
FLASH_F64_BH = 8               # flat rows of each case held against the f64 forward, backward
FLASH_F64_RATIO = 1.25         # out, lse, dq, dk, dv: max distance from f64 <= this x the
# plain f32 version's, at every case. Both are f32-accurate; their largest errors, each at one
# element of 8 rows, differ by chance between two sound orders of work, so the ceiling is
# not 1. The kernels' worst is 1.13x (dq at small_128). ex2.approx on every tile, the
# diagonal's included, put dq at 1.33x at long_2048 and fails it.


def flash_bwd_build_report() -> dict:
    """Shared memory, blocks per SM (CUDA occupancy API), registers and local
    memory per thread (cudaFuncGetAttributes, from the loaded library, built
    now or earlier) of each instantiation of the flash backward kernels, and
    ptxas's spill bytes when this run built the library; the D=16 ones must
    use no local memory, so spill nothing. Returns {"dq": {D: {...}}, "dkv": {...}}."""
    from genrec_tpu_torch.ops import _build
    from genrec_tpu_torch.ops import attention as fa

    log = _build.build_log.get("flash_attention_bwd")
    out = {}
    for key, kernel in (("dq", "flash_bwd_dq_kernel"), ("dkv", "flash_bwd_dkv_kernel")):
        ptxas = ptxas_report(log[1], kernel) if log else {}
        out[key] = {}
        for d, nd in zip(FLASH_DS, (2, 4, 8, 16)):
            r = fa.bwd_occupancy(d)[key]
            found = [v for k, v in ptxas.items() if f"ILi{nd}E" in k]
            r["spill_stores"], r["spill_loads"] = found[0][1:] if found else (None, None)
            out[key][d] = r
            print(f"[flash] {kernel}<D={d}>: {r['smem_bytes']} bytes of shared memory per "
                  f"block, {r['blocks_per_sm']} blocks resident per SM, {r['registers']} "
                  f"registers, {r['local_bytes']} bytes of local memory per thread; ptxas "
                  f"spill stores/loads {r['spill_stores']}/{r['spill_loads']} bytes"
                  + ("" if log else " (library built before this run)"))
        assert out[key][16]["local_bytes"] == 0, f"{kernel}<D=16> uses local memory (spills)"
    return out


def flash_fwd_build_report() -> dict:
    """Shared memory, blocks per SM, registers and local memory per thread of
    each instantiation of the flash forward kernel (without and with a bias),
    as :func:`flash_bwd_build_report` gives them for the backward; the D=16
    ones must use no local memory. Returns {D: {...the bias-free build...,
    "bias": {...}}}."""
    from genrec_tpu_torch.ops import _build
    from genrec_tpu_torch.ops import attention as fa

    log = _build.build_log.get("flash_attention_fwd")
    ptxas = ptxas_report(log[1], "flash_fwd_kernel") if log else {}
    out = {}
    for d, nd in zip(FLASH_DS, (2, 4, 8, 16)):
        occ = fa.fwd_occupancy(d)
        for key, r in occ.items():
            found = [v for k, v in ptxas.items() if f"ILi{nd}ELb{int(key == 'bias')}E" in k]
            r["spill_stores"], r["spill_loads"] = found[0][1:] if found else (None, None)
            print(f"[flash] flash_fwd_kernel<D={d}, {key}>: {r['smem_bytes']} bytes of shared "
                  f"memory per block, {r['blocks_per_sm']} blocks resident per SM, "
                  f"{r['registers']} registers, {r['local_bytes']} bytes of local memory per "
                  f"thread; ptxas spill stores/loads {r['spill_stores']}/{r['spill_loads']} "
                  "bytes" + ("" if log else " (library built before this run)"))
        out[d] = {**occ["plain"], "bias": occ["bias"]}
    for key in ("plain", "bias"):
        r = out[16] if key == "plain" else out[16]["bias"]
        assert r["local_bytes"] == 0, f"flash_fwd_kernel<D=16, {key}> uses local memory (spills)"
    return out


def flash_fwd_f64_errors(a, rows: int = FLASH_F64_BH) -> dict:
    """max|x − f64| / max|f64| of the forward's out and lse on the first
    ``rows`` flat rows of a case: the kernel's and the plain f32 version's
    against the plain forward in f64 on the same inputs."""
    from genrec_tpu_torch.ops import attention as fa

    args = [None if a[k] is None else a[k][:rows].contiguous() for k in ("qf", "kf", "vf", "bias")]
    kw = dict(causal=a["causal"])
    exact = fa.flash_attention_fwd_reference(*[None if x is None else x.double() for x in args],
                                             **kw)
    runs = {"kernel": fa.flash_attention_fwd(*args, **kw),
            "plain_f32": fa.flash_attention_fwd_reference(*args, **kw)}
    out = {name: {g: (x.double() - e).abs().max().item() / e.abs().max().item()
                  for g, x, e in zip(("out", "lse"), xs, exact)}
           for name, xs in runs.items()}
    del exact, runs
    torch.cuda.empty_cache()
    return out


def flash_bwd_f64_errors(a, rows: int = FLASH_F64_BH) -> dict:
    """max|x − f64| / max|f64| of dq, dk and dv on the first ``rows`` flat rows
    of a case: the kernels' and the plain f32 versions' against the plain
    backward in f64 on the same inputs (lse and delta as the f32 values given)."""
    from genrec_tpu_torch.ops import attention as fa

    args = [a[k][:rows].contiguous() for k in ("qf", "kf", "vf", "do", "lse", "delta")]
    kw = dict(causal=a["causal"])
    exact = (fa.flash_attention_bwd_dq_reference(*[x.double() for x in args], **kw),
             *fa.flash_attention_bwd_dkv_reference(*[x.double() for x in args], **kw))
    runs = {"kernel": (fa.flash_attention_bwd_dq(*args, **kw),
                       *fa.flash_attention_bwd_dkv(*args, **kw)),
            "plain_f32": (fa.flash_attention_bwd_dq_reference(*args, **kw),
                          *fa.flash_attention_bwd_dkv_reference(*args, **kw))}
    out = {name: {g: (x.double() - e).abs().max().item() / e.abs().max().item()
                  for g, x, e in zip(("dq", "dk", "dv"), xs, exact)}
           for name, xs in runs.items()}
    del exact, runs
    torch.cuda.empty_cache()
    return out


def phase_flash(timed=True):
    """Kernels #3-#6 (the flash forward, dq and dk/dv kernels) against their
    plain versions on the card: the forward's out and lse within 1e-5 max
    abs, dq, dk and dv within 1e-4·max|plain| + 1e-5 (f32, other summation
    orders), at the long-context SASRec shapes (B·H = 32·4 at L=2048, 16 at
    L=4096; the plain version's score tensor at B·H = 64 would be 4.3 GB)
    and at edge cases (a bias at D=64 and at D=16, L=128, lq ≠ lk, D=128, a
    ragged D=24, D=30 staged 4 bytes at a time); out, lse, dq, dk and dv
    bit-identical between two calls at L=2048; at every case, on 8 flat rows,
    each kernel's distance from the f64 forward or backward within
    FLASH_F64_RATIO of the plain f32 version's; every flash kernel's shared
    memory, blocks per SM, registers and spills; then times of each kernel,
    its plain version and SDPA, and both bounds."""
    from genrec_tpu_torch.ops import attention as fa

    build = {**flash_bwd_build_report(), "fwd": flash_fwd_build_report()}
    cases = [
        flash_case("long_2048", LC_B * 4, LC_L, LC_L, 16, causal=True, seed=21),
        flash_case("long_4096", 16, LC_L2, LC_L2, 16, causal=True, seed=22),
        flash_case("bias_512_d64", 8, 512, 512, 64, causal=False, bias=True, seed=23),
        flash_case("bias_512_d16", 8, 512, 512, 16, causal=False, bias=True, seed=29),
        flash_case("small_128", 4, 128, 128, 16, causal=False, seed=24),
        flash_case("lq!=lk_256x512", 4, 256, 512, 16, causal=False, seed=25),
        flash_case("d128_256", 2, 256, 256, 128, causal=True, seed=26),
        flash_case("d24_causal_256", 4, 256, 256, 24, causal=True, seed=27),  # ragged D
        # D % 4 != 0: rows are not 16-byte aligned, so tiles are staged 4 bytes at a time
        flash_case("d30_causal_256", 4, 256, 256, 30, causal=True, seed=28),
    ]
    results = {}
    for name, a in cases:
        q, k, v, causal = a["qf"], a["kf"], a["vf"], a["causal"]
        bwd_in = (q, k, v, a["do"], a["lse"], a["delta"])
        fwd = lambda: fa.flash_attention_fwd(q, k, v, a["bias"], causal=causal)  # noqa: E731
        fwd_plain = lambda: fa.flash_attention_fwd_reference(  # noqa: E731
            q, k, v, a["bias"], causal=causal)
        dq = lambda: fa.flash_attention_bwd_dq(*bwd_in, causal=causal)  # noqa: E731
        dq_plain = lambda: fa.flash_attention_bwd_dq_reference(*bwd_in, causal=causal)  # noqa: E731
        dkv = lambda: fa.flash_attention_bwd_dkv(*bwd_in, causal=causal)  # noqa: E731
        dkv_plain = lambda: fa.flash_attention_bwd_dkv_reference(  # noqa: E731
            *bwd_in, causal=causal)
        got, want = fwd(), fwd_plain()
        torch.cuda.synchronize()
        errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
        assert all(torch.isfinite(g).all() for g in got), f"{name}: non-finite forward"
        assert max(errs) <= TOL, f"{name}: forward out/lse vs plain max abs {errs} > {TOL}"
        g_dq, w_dq = dq(), dq_plain()
        g_dkv, w_dkv = dkv(), dkv_plain()
        torch.cuda.synchronize()
        rel_dq, abs_dq = _worst([g_dq], [w_dq])
        rel_dkv, abs_dkv = _worst(g_dkv, w_dkv)
        r = dict(fwd_err=max(errs), dq_err=abs_dq, dkv_err=abs_dkv, dq_rel=rel_dq,
                 dkv_rel=rel_dkv, bounds=flash_bounds(a))
        print(f"[flash] {name} q={tuple(q.shape)} lk={k.shape[1]} causal={causal} "
              f"bias={a['bias'] is not None}: fwd out/lse max abs {errs[0]:.2e}/{errs[1]:.2e}; "
              f"dq max abs {abs_dq:.2e} (max|plain| {w_dq.abs().max().item():.3e}), dk/dv "
              f"{abs_dkv:.2e} (max|plain| {max(w.abs().max().item() for w in w_dkv):.3e})")
        if name == "long_2048":
            again = fwd()
            same = [torch.equal(x, y) for x, y in zip(got, again)]
            assert all(same), f"{name}: two forward calls differ in (out, lse): {same}"
            print(f"[flash] {name}: forward out and lse bit-identical between two calls")
            del again
            again_dq, again_dkv = dq(), dkv()
            same = [torch.equal(x, y) for x, y in zip((g_dq, *g_dkv), (again_dq, *again_dkv))]
            assert all(same), f"{name}: two calls differ in (dq, dk, dv): {same}"
            print(f"[flash] {name}: dq, dk and dv bit-identical between two calls")
            del again_dq, again_dkv
        del got, want, g_dq, w_dq, g_dkv, w_dkv
        f64 = r["fwd_f64_err"] = flash_fwd_f64_errors(a)
        print(f"[flash] {name}, first {FLASH_F64_BH} flat rows, max|x - f64| / max|f64| of "
              f"out, lse: " + "; ".join(f"{who} " + " ".join(f"{e:.3e}" for e in errs.values())
                                        for who, errs in f64.items()))
        for g, e in f64["kernel"].items():
            assert e <= FLASH_F64_RATIO * f64["plain_f32"][g], (
                f"{name}: forward {g} lies {e:.3e} from f64, the plain f32 version "
                f"{f64['plain_f32'][g]:.3e} (> {FLASH_F64_RATIO}x)")
        f64 = r["f64_err"] = flash_bwd_f64_errors(a)
        print(f"[flash] {name}, first {FLASH_F64_BH} flat rows, max|x - f64| / max|f64| of "
              f"dq, dk, dv: " + "; ".join(
                  f"{who} " + " ".join(f"{e:.3e}" for e in errs.values())
                  for who, errs in f64.items()))
        for g, e in f64["kernel"].items():
            assert e <= FLASH_F64_RATIO * f64["plain_f32"][g], (
                f"{name}: {g} lies {e:.3e} from f64, the plain f32 version "
                f"{f64['plain_f32'][g]:.3e} (> {FLASH_F64_RATIO}x)")
        if timed:
            lib_fwd, lib_bwd = _sdpa_fwd_bwd(a)
            iters = 5 if q.shape[1] >= 2048 else 20
            fns = {"fwd": fwd, "fwd_plain": fwd_plain, "fwd_library": lib_fwd, "dq": dq,
                   "dq_plain": dq_plain, "dkv": dkv, "dkv_plain": dkv_plain,
                   "bwd_plain": lambda: fa.flash_attention_bwd_reference(
                       q, k, v, a["out"], a["lse"], a["do"], causal=causal),
                   "bwd_library": lib_bwd}
            for key, fn in fns.items():
                r[key + "_ms"] = cuda_ms(fn, iters)
                r[key + "_device_ms"] = device_ms(fn, iters)
            torch.cuda.empty_cache()
            b = r["bounds"]

            def bound(key):
                (t3, by3), (t1, by1) = b[key]["tf32x3"], b[key]["f32"]
                return f"bound {t3:.4f} ({by3}, 3xTF32 products), f32 {t1:.4f} ({by1})"
            print(f"[flash]   per call ms (device ms): fwd {r['fwd_ms']:.4f} "
                  f"({r['fwd_device_ms']:.4f}), plain {r['fwd_plain_ms']:.4f} "
                  f"({r['fwd_plain_device_ms']:.4f}), SDPA {r['fwd_library_ms']:.4f} "
                  f"({r['fwd_library_device_ms']:.4f}), {bound('fwd')}")
            print(f"[flash]   dq {r['dq_ms']:.4f} ({r['dq_device_ms']:.4f}), plain "
                  f"{r['dq_plain_ms']:.4f}, {bound('dq')}; dk/dv {r['dkv_ms']:.4f} "
                  f"({r['dkv_device_ms']:.4f}), plain {r['dkv_plain_ms']:.4f}, {bound('dkv')}; "
                  f"whole plain backward {r['bwd_plain_ms']:.4f} "
                  f"({r['bwd_plain_device_ms']:.4f}), SDPA backward {r['bwd_library_ms']:.4f} "
                  f"({r['bwd_library_device_ms']:.4f})")
        results[name] = r
        torch.cuda.empty_cache()
    return results, build


def _flash_counts():
    from genrec_tpu_torch.ops import attention as fa

    return fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches


def _reset_flash_counts():
    from genrec_tpu_torch.ops import attention as fa

    fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0


def _lc_batch(rng, b, length, item_num):
    """Left-padded long histories (the first row full, the others with 1..L
    items) and their shifted targets, as int64 tensors on the CPU."""
    x = rng.integers(1, item_num + 1, size=(b, length + 1))
    for i in range(1, b):
        x[i, :int(rng.integers(0, length))] = 0
    inputs = x[:, :-1]
    targets = np.where(inputs == 0, 0, x[:, 1:])
    return torch.from_numpy(inputs), torch.from_numpy(targets)


def phase_sasrec_large_serve():
    """Serving the long-context SASRec (``long_context_sasrec_config(2048,
    64)``, random weights from a generator): ``predict_topk(k=10)`` over a few
    B=1 requests and one B=32 batch on the card, 2 forward-kernel launches
    per call (one per block); top-10 scores within GEN_TOL of the same call
    on the CPU (plain attention), ids equal where the CPU's scores are not
    tied within GEN_TOL."""
    from genrec_tpu_torch.configs import long_context_sasrec_config
    from genrec_tpu_torch.models.sasrec_large import SASRecLarge

    cfg = long_context_sasrec_config(LC_L, 64)
    item_num = cfg.embedding.vocab_size - 1
    cpu = SASRecLarge(item_num, cfg, use_sharded=False,
                      generator=torch.Generator().manual_seed(0)).eval()
    model = copy.deepcopy(cpu).to("cuda")
    rng = np.random.default_rng(5)
    requests = [_lc_batch(rng, 1, LC_L, item_num)[0] for _ in range(3)]
    batch = _lc_batch(rng, LC_B, LC_L, item_num)[0]

    # ---- the main path: counts at 0 just before, read just after ----
    _reset_flash_counts()
    with torch.no_grad():
        outs = []
        for ids in requests + [batch]:
            before = _flash_counts()[0]
            outs.append(model.predict_topk(ids.cuda(), TOP_K))
            torch.cuda.synchronize()
            assert _flash_counts()[0] - before == cfg.num_blocks, _flash_counts()
        n_req = 10
        t0 = time.perf_counter()
        for _ in range(n_req):
            model.predict_topk(requests[0].cuda(), TOP_K)[1].cpu()
        req_s = n_req / (time.perf_counter() - t0)
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            model.predict_topk(batch.cuda(), TOP_K)[1].cpu()
        batch_s = reps * LC_B / (time.perf_counter() - t0)
    counts = _flash_counts()
    # ---- end of the main path ----
    calls = len(requests) + 1 + n_req + reps
    assert counts == (cfg.num_blocks * calls, 0, 0), counts

    rows = 4
    with torch.no_grad():
        for ids, (vals, idx) in zip(requests + [batch[:rows]], outs[:-1] + [
                (outs[-1][0][:rows], outs[-1][1][:rows])]):
            logits = cpu(ids)[:, -1, :] @ cpu.item_table.T
            want, _ = torch.topk(logits, TOP_K)
            err = (vals.cpu() - want).abs().max().item()
            assert err <= GEN_TOL, f"top-{TOP_K} scores card vs CPU max abs {err}"
            # the card's ids score, on the CPU, as the CPU's own top-k does
            picked = torch.gather(logits, 1, idx.cpu())
            assert (picked - want).abs().max().item() <= GEN_TOL, "card ids are not a top-k"
    print(f"[sasrec-large serve] L={LC_L} d=64 H=4 items={item_num}: top-{TOP_K} of "
          f"{len(requests)} B=1 requests and the first {rows} rows of a B={LC_B} batch equal "
          f"the CPU run's within {GEN_TOL}; {cfg.num_blocks} forward launches per call")
    print(f"[sasrec-large serve] {req_s:.2f} requests/s at B=1, {batch_s:.1f} histories/s at "
          f"B={LC_B} (host clock, after warm-up)")
    profile_window(f"one long-context request (B=1, L={LC_L})",
                   lambda: model.predict_topk(requests[0].cuda(), TOP_K))
    profile_window(f"one long-context batch (B={LC_B}, L={LC_L})",
                   lambda: model.predict_topk(batch.cuda(), TOP_K))
    return dict(fwd=counts[0], req_s=req_s, batch_s=batch_s)


def phase_sasrec_large_train_parity():
    """One train step of the long-context SASRec at B=2, L=2048 and dropout
    0 on the card (flash kernels) against the same step on the CPU in f64,
    its attention forced through the flash Function (the kernels' plain
    versions, in f64): loss within LOSS_REL, every gradient within
    BWD_REL·max + TOL, on the same weights, inputs and negatives.

    As in :func:`phase_train_step_parity`, the f64 witness takes every ReLU
    decision of the blocks' feed-forwards as the card took it (ff_out is fed
    ff_in(x) times the card's recorded (ff_in(x) > 0) mask): the step has 2.1 M
    pre-activations, and one within an f32 rounding of 0 that the card's f32
    rounds to the other side moves a gradient by that position's whole
    contribution, past its bound. The decisions that differ are counted, and
    the distance from the f64 step with its own ReLU is printed, not held."""
    from genrec_tpu_torch.configs import long_context_sasrec_config
    from genrec_tpu_torch.models.sasrec_large import SASRecLarge, train_loss_sampled
    from genrec_tpu_torch.ops import attention as fa
    from genrec_tpu_torch.ops.negative_sampling import sample_negatives

    cfg = dataclasses.replace(long_context_sasrec_config(LC_L, 64), dropout=0.0)
    item_num = cfg.embedding.vocab_size - 1
    base = SASRecLarge(item_num, cfg, use_sharded=False,
                       generator=torch.Generator().manual_seed(1))
    inputs, targets = _lc_batch(np.random.default_rng(6), LC_PARITY_B, LC_L, item_num)
    neg = sample_negatives(torch.Generator().manual_seed(2), torch.cat([inputs, targets], 1),
                           item_num, cfg.num_neg_samples)
    out, pre = {}, {}  # pre: run -> block -> ff_in(x) (f64, on the CPU)
    for name, dev, dtype in (("card", "cuda", torch.float32),
                             ("cpu_f64_own_relu", "cpu", torch.float64),
                             ("cpu_f64", "cpu", torch.float64)):
        model = copy.deepcopy(base).to(dev, dtype).train()
        if dev == "cpu":
            for blk in model.blocks:
                blk.attn_fn = functools.partial(fa.multi_head_attention, force_kernel=True)
        seen, hooks, live = pre.setdefault(name, {}), [], {}
        for i, blk in enumerate(model.blocks):
            def keep(mod, args, h, i=i):  # returns None: the output stays as it is
                seen[i] = h.detach().double().cpu()
                live[i] = h
            hooks.append(blk.ff_in.register_forward_hook(keep))
            if name == "cpu_f64":  # the card's ReLU decisions; dropout is 0 here
                mask = (pre["card"][i] > 0).double()
                hooks.append(blk.ff_out.register_forward_pre_hook(
                    lambda mod, args, i=i, mask=mask: (live[i] * mask,)))
        before = _flash_counts()
        try:
            loss, _ = train_loss_sampled(model, inputs.to(dev), targets.to(dev), None, cfg,
                                         item_num, neg=neg.to(dev))
            loss.backward()
        finally:
            for hook in hooks:
                hook.remove()
        if dev == "cuda":
            torch.cuda.synchronize()
            got = tuple(x - y for x, y in zip(_flash_counts(), before))
            assert got == (cfg.num_blocks,) * 3, got
        out[name] = (loss.item(), {k: p.grad.double().cpu() for k, p in model.named_parameters()})
    flips = [(h > 0) != (pre["card"][i] > 0) for i, h in pre["cpu_f64_own_relu"].items()]
    near = [h[f].abs().max().item() for f, h in zip(flips, pre["cpu_f64_own_relu"].values())
            if f.any()]
    print(f"[sasrec-large train-step] ReLU decisions of the card's step against the f64 step's "
          f"own: {sum(int(f.sum()) for f in flips)} of {sum(f.numel() for f in flips)} differ, "
          f"the largest at |pre-activation| {max(near, default=0.0):.3e} (f64)")
    loss_ref, ref = out["cpu_f64"]
    loss_err = abs(out["card"][0] - loss_ref)
    assert loss_err <= LOSS_REL * abs(loss_ref), (
        f"long-context step loss card vs f64 CPU {loss_err} > {LOSS_REL}*{abs(loss_ref)}")
    worst = {}
    for witness in ("cpu_f64", "cpu_f64_own_relu"):
        worst[witness] = (0.0, "")
        for k, g_ref in out[witness][1].items():
            err, scale = (out["card"][1][k] - g_ref).abs().max().item(), g_ref.abs().max().item()
            if witness == "cpu_f64":
                assert err <= BWD_REL * scale + TOL, (
                    f"{k}: grad card vs f64 CPU {err} (max {scale})")
            worst[witness] = max(worst[witness], (err / (BWD_REL * scale + TOL), k))
    print(f"[sasrec-large train-step] B={LC_PARITY_B} L={LC_L} dropout 0: loss card "
          f"{out['card'][0]:.7f}, CPU f64 {loss_ref:.7f} (|diff| {loss_err:.2e}); {len(ref)} "
          f"gradients against the f64 step with the card's ReLU decisions, worst max_err at "
          f"{100 * worst['cpu_f64'][0]:.1f}% of its bound ({worst['cpu_f64'][1]}); printed, not "
          f"held, against the f64 step with its own ReLU: "
          f"{100 * worst['cpu_f64_own_relu'][0]:.1f}% ({worst['cpu_f64_own_relu'][1]})")


def _lc_train(cfg, batch_size, steps, seed):
    """``steps`` train steps of a fresh long-context SASRec on the card on one
    fixed batch, as the reference's single-chip run steps it, with fresh
    negatives and dropout each step from a generator on the card. The per-step
    loss moves by about ±1.5 with the fresh negatives, so the loss is also
    read before and after on one fixed set of negatives. Returns the
    per-step losses, that loss before and after, the ms per step over the
    steps after the first (host clock), the step and the fixed-negatives
    loss."""
    from genrec_tpu_torch.models.sasrec_large import (SASRecLarge, make_train_step,
                                                      train_loss_sampled)
    from genrec_tpu_torch.ops.negative_sampling import sample_negatives

    item_num = cfg.embedding.vocab_size - 1
    model = SASRecLarge(item_num, cfg, use_sharded=False,
                        generator=torch.Generator().manual_seed(seed)).to("cuda")
    opt = torch.optim.Adam(model.parameters(), lr=cfg.trainer.lr, betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(model, opt, cfg, item_num)
    inputs, targets = (t.cuda() for t in _lc_batch(np.random.default_rng(seed), batch_size,
                                                     cfg.max_len, item_num))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fixed_neg = sample_negatives(gen, torch.cat([inputs, targets], 1), item_num,
                                 cfg.num_neg_samples)

    def fixed_loss():
        model.eval()
        with torch.no_grad():
            return train_loss_sampled(model, inputs, targets, None, cfg, item_num,
                                      neg=fixed_neg)[0].item()

    before = fixed_loss()
    losses = [step(inputs, targets, gen)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        losses.append(step(inputs, targets, gen))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / max(steps - 1, 1) * 1e3
    losses = [x.item() for x in losses]
    after = fixed_loss()
    assert all(np.isfinite(losses + [before, after])), (losses, before, after)
    return dict(losses=losses, fixed=(before, after), ms=ms,
                step=lambda: step(inputs, targets, gen), fixed_loss=fixed_loss)


def phase_sasrec_large_train():
    """Training the long-context SASRec at full width on the card: 20 steps
    at B=32, L=2048, dropout 0 (kernels #3 and #5: 2 forward, 2 dq and 2
    dk/dv launches per step), the loss on fixed negatives falling; 3 steps at L=4096, B=16
    (#4 and #6); then 2 steps at the config's dropout 0.2, whose training
    forward takes the plain attention with dropout, as the reference routes
    it: no flash launch."""
    from genrec_tpu_torch.configs import long_context_sasrec_config

    cfg = dataclasses.replace(long_context_sasrec_config(LC_L, 64), dropout=0.0)
    # ---- the main path at L=2048: counts at 0 just before, read just after ----
    _reset_flash_counts()
    run = _lc_train(cfg, LC_B, LC_STEPS, seed=3)
    counts = _flash_counts()
    # ---- end ----
    losses, fixed, ms_step, step = run["losses"], run["fixed"], run["ms"], run["step"]
    probe = []
    for _ in range(4):  # 40 more steps, outside the counted path: the loss's course
        for _ in range(10):
            step()
        probe.append(round(run["fixed_loss"](), 4))
    print(f"[sasrec-large train] loss on fixed negatives after 30, 40, 50, 60 steps: {probe}")
    per_step = cfg.num_blocks  # and 2 more forwards for the fixed-negatives loss
    assert counts == (per_step * (LC_STEPS + 2), per_step * LC_STEPS, per_step * LC_STEPS), counts
    assert fixed[1] < fixed[0], fixed
    print(f"[sasrec-large train] B={LC_B} L={LC_L} d=64 H=4 dropout 0, {LC_STEPS} steps: losses "
          f"{[round(x, 4) for x in losses]}; loss on fixed negatives {fixed[0]:.4f} before, "
          f"{fixed[1]:.4f} after")
    print(f"[sasrec-large train] {ms_step:.2f} ms/step, {LC_B / ms_step * 1e3:.1f} examples/s, "
          f"{LC_B * LC_L / ms_step * 1e3:.0f} tokens/s (host clock, steps 2-{LC_STEPS}); "
          f"flash launches fwd/dq/dkv {counts}")
    torch.cuda.reset_peak_memory_stats()
    prof = profile_window(f"one long-context train step (B={LC_B}, L={LC_L})", step, top_n=12)
    busy = None if prof is None else prof[0] / 1e3 / ms_step
    if busy is not None:
        print(f"[sasrec-large train] device busy {prof[0] / 1e3:.3f} ms per step against "
              f"{ms_step:.2f} ms per step on the host clock without the profiler: "
              f"{100 * busy:.1f}% busy; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del step
    torch.cuda.empty_cache()

    cfg2 = dataclasses.replace(long_context_sasrec_config(LC_L2, 64), dropout=0.0)
    # ---- the main path at L=4096 ----
    _reset_flash_counts()
    run2 = _lc_train(cfg2, LC_B2, LC_STEPS2, seed=4)
    losses2, ms_step2 = run2["losses"], run2["ms"]
    counts2 = _flash_counts()
    # ---- end ----
    assert counts2 == (per_step * (LC_STEPS2 + 2), per_step * LC_STEPS2,
                       per_step * LC_STEPS2), counts2
    print(f"[sasrec-large train] B={LC_B2} L={LC_L2}, {LC_STEPS2} steps: losses "
          f"{[round(x, 4) for x in losses2]}, {ms_step2:.2f} ms/step (steps 2-{LC_STEPS2}); "
          f"flash launches fwd/dq/dkv {counts2}")
    torch.cuda.empty_cache()

    cfg3 = long_context_sasrec_config(LC_L, 64)
    assert cfg3.dropout == 0.2
    # ---- the main path at the config's dropout ----
    _reset_flash_counts()
    run3 = _lc_train(cfg3, LC_B, 2, seed=5)
    losses3, ms_step3 = run3["losses"], run3["ms"]
    counts3 = _flash_counts()
    # ---- end ----
    assert counts3 == (2 * per_step, 0, 0), counts3  # the fixed-negatives loss only
    print(f"[sasrec-large train] B={LC_B} L={LC_L} dropout {cfg3.dropout}, 2 steps: losses "
          f"{[round(x, 4) for x in losses3]}, {ms_step3:.2f} ms for step 2; flash launches "
          f"{counts3}: none in training (attention dropout takes the plain path, as in the "
          f"reference), {2 * per_step} in the two dropout-free reads of the fixed-negatives loss")
    torch.cuda.empty_cache()
    return dict(counts=[counts, counts2, counts3], ms_step=ms_step, busy=busy,
                examples_s=LC_B / ms_step * 1e3, ms_step_4096=ms_step2,
                ms_step_dropout=ms_step3)


def phase_sasrec(tmp):
    """The parity SASRec (``SASRecConfig()``: L 20, d 16, 1 head, dropout
    0.2) through ``sasrec_pipeline.train`` (2 epochs at batch 128) on a
    4096-user, 700-item synthetic corpus on the card, ``evaluate``, and a few
    requests through ``sasrec_model_fn``. Its attention is short (L=20), so
    it takes the plain path: no flash launch."""
    from genrec_tpu_torch.configs import SASRecConfig
    from genrec_tpu_torch.data.synthetic import make_interactions
    from genrec_tpu_torch.pipelines import sasrec_pipeline
    from genrec_tpu_torch.serving.model_fn import sasrec_model_fn

    data = make_interactions(num_users=TRAIN_USERS, num_items=N_ITEMS, seed=1)
    base = SASRecConfig()
    cfg = dataclasses.replace(base, trainer=dataclasses.replace(
        base.trainer, epochs=2, ckpt_dir=os.path.join(tmp, "sasrec_ckpt"), seed=0))
    # ---- the main path: counts at 0 just before, read just after ----
    _reset_flash_counts()
    art = sasrec_pipeline.train(cfg, data, device="cuda")
    metrics = sasrec_pipeline.evaluate(cfg, art, data, device="cuda")
    fn = sasrec_model_fn(cfg.trainer.ckpt_dir, data, cfg, device="cuda")
    served = [fn(h, TOP_K) for h in ([], [1, 2, 3], list(range(5, 40)))]
    torch.cuda.synchronize()
    counts = _flash_counts()
    # ---- end ----
    assert counts == (0, 0, 0), counts
    res = art.result
    assert res.epochs_run == 2 and all(np.isfinite(res.train_losses + res.val_losses))
    assert set(metrics) == {f"{m}@{k}" for m in ("Hit", "NDCG") for k in cfg.topk_list}
    for hist, items in zip(([], [1, 2, 3], list(range(5, 40))), served):
        assert len(items) == TOP_K and len(set(items)) == TOP_K, items
        assert all(1 <= i <= art.item_num for i in items), items
        assert not set(items) & set(hist[-cfg.max_len:]), (items, hist)
    print(f"[sasrec] SASRecConfig() 2 epochs at batch 128: train losses "
          f"{[round(x, 4) for x in res.train_losses]}, val "
          f"{[round(x, 4) for x in res.val_losses]}, "
          f"{res.steady_examples_per_sec:.1f} train examples/s (epoch 2, host clock); "
          + ", ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
    print(f"[sasrec] served {served[1]} for history [1, 2, 3]; flash launches {counts}")
    return data, cfg


APP_HISTORIES = ([], [3, 250, 612], list(range(101, 121)))   # empty, 3 and 20 items
APP_OOB = [0, N_ITEMS + 5, -3, 7, 12]   # ids outside (0, 700] besides 7 and 12
APP_PAIRS = 200   # timed HTTP requests and direct calls a model, alternated in pairs


def _post_model(port, history, top_k=TOP_K):
    """``POST /api/v1/recommend/model``: the answer's item ids."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v1/recommend/model",
                                 data=json.dumps({"history": history, "top_k": top_k}).encode(),
                                 method="POST", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200, r.status
        body = json.loads(r.read())
    assert body["success"] is True, body
    return [row["item_id"] for row in body["data"]]


def _p10_50_90(xs):
    return np.percentile(xs, [10, 50, 90]).tolist()


def _fmt(xs):
    return "/".join(f"{x:.3f}" for x in xs)


def _get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        assert r.status == 200, r.status
        return json.loads(r.read())


def phase_app(tmp, codes, items, sas_data, sas_cfg):
    """[app]: ``/api/v1/recommend/model`` in process, through the stdlib
    HTTP server on port 0, with card-backed model fns from the checkpoints
    the earlier phases saved: TIGER's from ``phase_train`` (its context built
    by ``cli.make_context``: ``serve --tiger-ckpt`` needs only the code
    file), DenseT5's from ``phase_dense_t5`` and SASRec's from
    ``phase_sasrec`` (their contexts by ``AppContext.create`` from the
    in-memory tables: the card's machine has no h5py for the H5 files
    ``make_context`` reads). For each model: the empty, 3-item and 20-item
    histories answer over HTTP the lists of the same fn called directly,
    with 2 launches of #1 a TIGER request, 6 a DenseT5 request and none of
    any kernel a SASRec request (L = 20: plain attention); a history with ids
    outside (0, 700] answers what the fn gives without them (JAX's
    ``tiger_model_fn``, ``dense_t5_model_fn`` and ``sasrec_model_fn`` drop
    them; tests/test_torch_tiger.py pins it); 200 requests over HTTP and 200
    direct calls, alternated in pairs, give the two rates and the spread of
    HTTP minus direct within a pair; a profiled request gives device ms and
    the busy share. ``/health`` and ``/api/v1/courses`` (the DB's
    ``class_index``) answer too. Then ``make_sasrec_recommend_fn`` on the
    card answers an id past the table as JAX's does: NaN logits, so the
    padding row and the history first, then the NaN ids in the order NumPy's
    argsort leaves them."""
    import threading

    from genrec_tpu_torch import cli
    from genrec_tpu_torch.backend.api import AppContext
    from genrec_tpu_torch.backend.config import Settings
    from genrec_tpu_torch.backend.server import BackendHTTPServer
    from genrec_tpu_torch.configs import DenseT5Config
    from genrec_tpu_torch.data.contracts import write_codes
    from genrec_tpu_torch.models.sasrec import SASRec
    from genrec_tpu_torch.ops import t5_attention as ta
    from genrec_tpu_torch.serving.app import make_sasrec_recommend_fn
    from genrec_tpu_torch.serving.model_fn import dense_t5_model_fn, sasrec_model_fn
    from genrec_tpu_torch.train.checkpoint import restore_best

    data_dir = os.path.join(tmp, "app_data")
    write_codes(os.path.join(data_dir, "course", "course_rqvae_codes.npy"), codes)
    db_path = os.path.join(tmp, "app.db")
    settings = Settings(database_path=db_path)
    tiger_args = cli.build_parser().parse_args(
        ["serve", "--data-dir", data_dir, "--db", db_path, "--port", "0",
         "--tiger-ckpt", os.path.join(tmp, "train_ckpt"), "--device", "cuda"])
    contexts = {"tiger": cli.make_context(tiger_args)}
    contexts["dense_t5"] = AppContext.create(settings=settings, model_recommend_fn=dense_t5_model_fn(
        os.path.join(tmp, "dense_ckpt"), items, cfg=DenseT5Config(), device="cuda"))
    contexts["sasrec"] = AppContext.create(settings=settings, model_recommend_fn=sasrec_model_fn(
        sas_cfg.trainer.ckpt_dir, sas_data, sas_cfg, device="cuda"))
    contexts["tiger"].db.executemany(
        "INSERT OR REPLACE INTO class_index (class_id, class_name, url) VALUES (?,?,?)",
        [(i, f"course {i}", f"u{i}") for i in range(1, N_ITEMS + 1)])
    per_request = {"tiger": 2, "dense_t5": 6, "sasrec": 0}
    out = {}
    for name, ctx in contexts.items():
        assert ctx.model_recommend_fn is not None, name
        fn = ctx.model_recommend_fn
        srv = BackendHTTPServer(ctx, "127.0.0.1", 0)
        thread = threading.Thread(target=srv.serve_forever, args=(0.05,), daemon=True)
        thread.start()
        port = srv.server_address[1]
        try:
            assert _get(port, "/health")["status"] == "healthy"
            courses = _get(port, "/api/v1/courses")["data"]
            assert len(courses) == N_ITEMS and courses[0] == {"item_id": 1, "name": "course 1",
                                                               "url": "u1"}, courses[:2]
            want = [fn(h, TOP_K) for h in APP_HISTORIES + (APP_OOB,)]
            want_oob = fn([i for i in APP_OOB if 0 < i <= N_ITEMS], TOP_K)
            # ---- the main path: counts at 0 just before, read just after ----
            ta.launches = ta.bwd_launches = ta.dbias_reduce_launches = 0
            _reset_flash_counts()
            got = []
            for hist in APP_HISTORIES + (APP_OOB,):
                before = ta.launches
                got.append(_post_model(port, hist))
                assert ta.launches - before == per_request[name], (name, ta.launches - before)
            # one HTTP request and one direct call a pair, their order swapped every
            # pair so that a drift of the shared host falls on both alike
            http_ms, direct_ms = [], []
            calls = {"http": (lambda: _post_model(port, APP_HISTORIES[2]), http_ms),
                     "direct": (lambda: fn(APP_HISTORIES[2], TOP_K), direct_ms)}
            for i in range(APP_PAIRS):
                for kind in (("http", "direct") if i % 2 == 0 else ("direct", "http")):
                    call, times = calls[kind]
                    t0 = time.perf_counter()
                    call()
                    times.append(1e3 * (time.perf_counter() - t0))
            counts = (ta.launches, ta.bwd_launches, ta.dbias_reduce_launches, _flash_counts())
            # ---- end ----
            n_http = len(got) + APP_PAIRS
            assert counts == (per_request[name] * (n_http + APP_PAIRS), 0, 0, (0, 0, 0)), \
                (name, counts)
            assert got == want, (name, got, want)
            assert got[-1] == want_oob, (name, got[-1], want_oob)
            for hist, items_ in zip(APP_HISTORIES, got):
                assert 1 <= len(items_) <= TOP_K and len(set(items_)) == len(items_), items_
                assert all(1 <= i <= N_ITEMS for i in items_), items_
                assert not set(items_) & set(hist), (items_, hist)
            http_s, direct_s = 1e3 * APP_PAIRS / sum(http_ms), 1e3 * APP_PAIRS / sum(direct_ms)
            gap_ms = np.subtract(http_ms, direct_ms)
            print(f"[app] {name}: HTTP lists equal the direct fn's for histories of 0, 3 and 20 "
                  f"items and {APP_OOB} (= the fn without the ids outside (0, {N_ITEMS}]): "
                  f"{got[2]}; launches (#1, #2, dbias, flash) {counts} over {n_http} HTTP "
                  f"requests and {APP_PAIRS} direct calls ({per_request[name]} of #1 each)")
            prof = profile_window(f"one {name} HTTP request (20-item history)",
                                  lambda: _post_model(port, APP_HISTORIES[2]))
            dprof = profile_window(f"one {name} direct call (20-item history)",
                                   lambda: fn(APP_HISTORIES[2], TOP_K))
            out[name] = dict(
                http_req_s=http_s, direct_req_s=direct_s, launches=counts[0], n_http=n_http,
                http_ms_p10_50_90=_p10_50_90(http_ms), direct_ms_p10_50_90=_p10_50_90(direct_ms),
                gap_ms_p10_50_90=_p10_50_90(gap_ms),
                device_ms=None if prof is None else prof[0] / 1e3,
                busy=None if prof is None else prof[0] / prof[1],
                direct_device_ms=None if dprof is None else dprof[0] / 1e3,
                direct_busy=None if dprof is None else dprof[0] / dprof[1])
            print(f"[app] {name}: {http_s:.2f} requests/s over HTTP, {direct_s:.2f} calling the "
                  f"fn directly ({APP_PAIRS} of each, alternated in pairs, host clock); ms a "
                  f"request p10/p50/p90: HTTP {_fmt(out[name]['http_ms_p10_50_90'])}, direct "
                  f"{_fmt(out[name]['direct_ms_p10_50_90'])}, HTTP minus direct within a pair "
                  f"{_fmt(out[name]['gap_ms_p10_50_90'])}; device {out[name]['device_ms']} ms "
                  f"per HTTP request, busy share {out[name]['busy']}")
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)
            assert not thread.is_alive()
    for ctx in contexts.values():
        ctx.db.close()

    # make_sasrec_recommend_fn on the card: an id past the table, and negative ids
    model = SASRec(sas_data.max_item_id, sas_cfg)
    model.load_state_dict(restore_best(sas_cfg.trainer.ckpt_dir))
    cpu_fn = make_sasrec_recommend_fn(copy.deepcopy(model).eval(), sas_cfg.max_len)
    card_fn = make_sasrec_recommend_fn(model.to("cuda").eval(), sas_cfg.max_len)
    n = sas_data.max_item_id + 1
    nan_logits = np.full(n, np.nan, np.float32)
    nan_logits[[0, 3]] = -1e9
    pinned = np.argsort(-nan_logits)[:TOP_K].tolist()
    assert set(pinned[:2]) == {0, 3}, pinned
    _reset_flash_counts()
    assert card_fn([3, n + 50], TOP_K) == pinned
    for hist in ([-1, 4], [-n, 2], [5, 9, 2]):
        assert card_fn(hist, TOP_K) == cpu_fn(hist, TOP_K), hist
    assert _flash_counts() == (0, 0, 0)
    print(f"[app] make_sasrec_recommend_fn on the card: [3, {n + 50}] -> {pinned} (JAX's "
          f"pinned list: NaN logits, nothing past the table put on the card); negative ids "
          f"[-1, 4], [-{n}, 2] and [5, 9, 2] give the CPU's lists")
    return out


def phase_cli(tmp, codes):
    """[cli]: the user's entry point on the card's machine, which has no
    h5py: every contract ``synth`` and the training subcommands write is H5,
    so they are held by the CPU tests (tests/test_torch_cli.py), and this
    phase runs what needs none. ``init-db`` and ``view-db`` through
    ``cli.main``; ``serve --tiger-ckpt`` (the code file and the checkpoint
    ``phase_train`` saved) in process through ``cli.make_context``, 2
    launches of #1 a request; then one ``python3 -m genrec_tpu_torch.cli
    serve`` subprocess on a free port, on the card by default: ``/health``
    polled for up to 60 s, the three histories answered with the in-process
    lists, and the process still alive when it is terminated."""
    import contextlib
    import io
    import socket
    import urllib.error

    from genrec_tpu_torch import cli
    from genrec_tpu_torch.data.contracts import write_codes
    from genrec_tpu_torch.ops import t5_attention as ta

    data_dir, db_path = os.path.join(tmp, "cli_data"), os.path.join(tmp, "cli_app.db")
    tiger_ckpt = os.path.join(tmp, "train_ckpt")
    write_codes(os.path.join(data_dir, "course", "course_rqvae_codes.npy"), codes)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["init-db", "--db", db_path])
        cli.main(["init-db", "--db", db_path])   # re-running never duplicates
        cli.main(["view-db", "--db", db_path])
        cli.main(["view-db", "--db", db_path, "--table", "students", "-n", "5"])
    text = buf.getvalue()
    rows = dict(re.findall(r"^(\w+)\s+(\d+) rows$", text, re.M))
    assert len(rows) == 13 and rows["students"] == "2" and rows["admin_profiles"] == "1", text
    assert '"student_id": "S002"' in text, text
    print(f"[cli] init-db twice and view-db: 13 tables, {rows['students']} students, "
          f"{rows['admin_profiles']} admin")

    args = cli.build_parser().parse_args(["serve", "--data-dir", data_dir, "--db", db_path,
                                          "--tiger-ckpt", tiger_ckpt, "--port", "0"])
    ctx = cli.make_context(args)   # --device unset: the card
    # ---- the main path: counts at 0 just before, read just after ----
    ta.launches = ta.bwd_launches = ta.dbias_reduce_launches = 0
    lists = [ctx.model_recommend_fn(h, TOP_K) for h in APP_HISTORIES]
    torch.cuda.synchronize()
    counts = (ta.launches, ta.bwd_launches, ta.dbias_reduce_launches)
    # ---- end ----
    ctx.db.close()
    assert counts == (2 * len(APP_HISTORIES), 0, 0), counts

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log_path = os.path.join(tmp, "serve.log")
    cmd = [sys.executable, "-m", "genrec_tpu_torch.cli", "serve", "--data-dir", data_dir,
           "--db", db_path, "--tiger-ckpt", tiger_ckpt, "--port", str(port)]
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        while True:
            assert proc.poll() is None, (f"serve exited with {proc.returncode}: "
                                         + open(log_path).read()[-3000:])
            try:
                assert _get(port, "/health")["status"] == "healthy"
                break
            except (urllib.error.URLError, ConnectionError):
                assert time.perf_counter() - t0 < 60, "serve: /health not up within 60 s"
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        served = [_post_model(port, h) for h in APP_HISTORIES]
        assert served == lists, (served, lists)
        assert proc.poll() is None, open(log_path).read()[-3000:]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    print(f"[cli] `python3 -m genrec_tpu_torch.cli serve --tiger-ckpt` answered /health "
          f"{up_s:.1f} s after start and the three histories with the in-process lists "
          f"({served[1]}); terminated with {proc.returncode}")
    return dict(fwd=counts[0], up_s=up_s)


def _history_batch(rng, n_rows, cfg, table):
    """Left-padded token rows of random histories of 1..max_len real items."""
    seq = cfg.max_len * cfg.code_dim
    ii = np.zeros((n_rows, seq), np.int32)
    for row in range(n_rows):
        items = rng.integers(1, N_ITEMS + 1, size=int(rng.integers(1, cfg.max_len + 1)))
        toks = table[items].reshape(-1)
        ii[row, seq - len(toks):] = toks
    return ii, (ii != 0).astype(np.int32)


def phase_serving(tmp):
    from genrec_tpu_torch.configs import TIGERConfig
    from genrec_tpu_torch.data import tiger_tokens
    from genrec_tpu_torch.data.contracts import write_codes
    from genrec_tpu_torch.data.synthetic import make_codes
    from genrec_tpu_torch.models import t5
    from genrec_tpu_torch.models.tiger import TIGER, generate, make_constraint
    from genrec_tpu_torch.ops import t5_attention as ta
    from genrec_tpu_torch.serving.model_fn import tiger_model_fn
    from genrec_tpu_torch.train.checkpoint import restore_best, save_best

    cfg = TIGERConfig(constrained_decoding="trie")
    codes = make_codes(N_ITEMS)
    codes_path = os.path.join(tmp, "codes", "course_rqvae_codes.npy")
    write_codes(codes_path, codes)
    ckpt = os.path.join(tmp, "ckpt")
    save_best(TIGER(cfg, generator=torch.Generator().manual_seed(0)).state_dict(), ckpt)
    table = tiger_tokens.codes_to_token_table(codes, cfg.codebook_size)
    rng = np.random.default_rng(0)

    # ---- the main path: counts at 0 just before, read just after ----
    ta.launches = ta.bwd_launches = ta.dbias_reduce_launches = 0
    fn = tiger_model_fn(ckpt, codes_path, device="cuda")
    histories = [[], [int(i) for i in rng.integers(1, N_ITEMS + 1, size=3)],
                 [int(i) for i in rng.choice(np.arange(1, N_ITEMS + 1), 20, replace=False)]]
    for hist in histories:
        before = ta.launches
        items = fn(hist, TOP_K)
        torch.cuda.synchronize()
        assert ta.launches - before == 2, f"{ta.launches - before} launches for one request"
        assert 1 <= len(items) <= TOP_K, items
        assert all(1 <= i <= N_ITEMS for i in items), items
        assert not set(items) & set(hist), (items, hist)
        assert len(set(items)) == len(items), items
        print(f"[serve] history of {len(hist)} items -> {items}")
    n_req = 20
    t0 = time.perf_counter()
    for _ in range(n_req):
        fn(histories[-1], TOP_K)
    req_s = n_req / (time.perf_counter() - t0)
    print(f"[serve] {req_s:.2f} requests/s (20-item history, {n_req} requests, host clock)")

    model = TIGER(cfg)
    model.load_state_dict(restore_best(ckpt))
    model.to("cuda").eval()
    constraint = make_constraint(cfg, codes).to("cuda")
    ii, am = _history_batch(rng, BATCH, cfg, table)
    ii_d, am_d = torch.from_numpy(ii).cuda(), torch.from_numpy(am).cuda()
    generate(model, ii_d, am_d, num_beams=BEAMS, constraint=constraint)  # warm-up
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        tokens, scores = generate(model, ii_d, am_d, num_beams=BEAMS, constraint=constraint)
    torch.cuda.synchronize()
    seqs_s = reps * BATCH / (time.perf_counter() - t0)
    launches, bwd_launches, reduce_launches = (ta.launches, ta.bwd_launches,
                                               ta.dbias_reduce_launches)
    # ---- end of the main path ----
    assert bwd_launches == reduce_launches == 0, (bwd_launches, reduce_launches)  # no backward
    print(f"[generate] B={BATCH} beams={BEAMS} trie: {seqs_s:.1f} seqs/s (host clock, "
          f"{reps} batches after one warm-up)")
    print(f"[launches] t5_attention_fwd: {launches} on the main path "
          f"({len(histories) + n_req} requests, {reps + 1} batched generates)")
    assert launches == 2 * (len(histories) + n_req + reps + 1), launches

    assert tokens.shape == (BATCH, BEAMS, cfg.max_gen_len), tokens.shape
    assert torch.isfinite(scores).all()
    # every beam that no constraint masked decodes to a row of the code table
    # (the trie holds row 0, the padding row, as the reference's does)
    code_rows = {tuple(map(int, t)) for t in table}
    real = scores > -1e29
    tok_np = tokens.cpu().numpy()
    for row, beam in zip(*np.nonzero(real.cpu().numpy())):
        assert tuple(map(int, tok_np[row, beam, 1:])) in code_rows, tok_np[row, beam]
    print(f"[generate] {int(real.sum())} unmasked beams, all decode to code-table rows")

    # the same rows on the CPU (plain attention): tokens equal, scores close
    cpu_model = TIGER(cfg)
    cpu_model.load_state_dict(restore_best(ckpt))
    cpu_model.eval()
    rows = 8
    ct, cs = generate(cpu_model, torch.from_numpy(ii[:rows]), torch.from_numpy(am[:rows]),
                      num_beams=BEAMS, constraint=make_constraint(cfg, codes))
    assert torch.equal(ct, tokens[:rows].cpu()), "card and CPU tokens differ"
    gen_err = (cs - scores[:rows].cpu()).abs().max().item()
    assert gen_err <= GEN_TOL, f"card vs CPU scores max abs {gen_err} > {GEN_TOL}"
    print(f"[generate] first {rows} rows: tokens equal to the CPU run, scores max abs "
          f"{gen_err:.3e}")

    # relative-position buckets on the card, bit for bit against the CPU
    a = cfg.arch
    rel = torch.arange(-300, 301)
    for bidirectional in (True, False):
        kw = dict(bidirectional=bidirectional, num_buckets=a.relative_attention_num_buckets,
                  max_distance=a.relative_attention_max_distance)
        on_card = t5.relative_position_bucket(rel.cuda(), **kw).cpu()
        assert torch.equal(on_card, t5.relative_position_bucket(rel, **kw)), bidirectional
    print("[buckets] relative-position buckets on the card equal the CPU's for -300..300")

    profile_window("one served request (20-item history)", lambda: fn(histories[-1], TOP_K))
    profile_window(f"one batched generate (B={BATCH})",
                   lambda: generate(model, ii_d, am_d, num_beams=BEAMS, constraint=constraint))
    return launches, req_s, seqs_s


def train_corpus():
    """The full-width training corpus: make_interactions(4096 users, 700
    items, 4..41 items each, seed 0) with make_codes(700); the longest train
    target is 39 items = 156 tokens."""
    from genrec_tpu_torch.configs import TIGERConfig
    from genrec_tpu_torch.data import datasets, tiger_tokens
    from genrec_tpu_torch.data.synthetic import make_codes, make_interactions

    cfg = TIGERConfig()
    corpus = make_interactions(num_users=TRAIN_USERS, num_items=N_ITEMS, min_len=4,
                               max_len=41, seed=0)
    codes = make_codes(N_ITEMS)
    tr_split, te_split = tiger_tokens.build_tiger_splits(corpus.item_id_lists,
                                                         corpus.user_ids, codes)
    tr = datasets.build_tiger_arrays(tr_split, cfg.max_len, cfg.code_dim)
    te = datasets.build_tiger_arrays(te_split, cfg.max_len, cfg.code_dim, max_target_items=1)
    assert tr.labels.shape[1] == 156, tr.labels.shape
    print(f"[data] {len(tr.input_ids)} train rows (targets up to {tr.labels.shape[1]} "
          f"tokens), {len(te.input_ids)} test rows, {N_ITEMS} items")
    return tr, te, codes


class _PlainAttention(torch.autograd.Function):
    """Kernels #1 and #2's plain versions as one autograd Function, without
    the wrapper's f32/bf16 check: they compute in f64 for f64 inputs. A mask
    to be drawn again (``redraw``) is drawn and kept."""

    @staticmethod
    def forward(ctx, qf, kf, vf, pos_bias, kv_mask, dmask, h, causal, redraw):
        from genrec_tpu_torch.ops import t5_attention as ta

        if redraw is not None:
            dmask = redraw.draw()
        ctx.save_for_backward(qf, kf, vf, pos_bias, kv_mask, dmask)
        ctx.h, ctx.causal = h, causal
        return ta.t5_attention_reference(qf, kf, vf, h, pos_bias, kv_mask, causal=causal,
                                         dropout_mask=dmask)

    @staticmethod
    def backward(ctx, do):
        from genrec_tpu_torch.ops import t5_attention as ta

        qf, kf, vf, pos_bias, kv_mask, dmask = ctx.saved_tensors
        grads = ta.t5_attention_bwd_reference(qf, kf, vf, ctx.h, pos_bias, kv_mask,
                                              do.contiguous(), causal=ctx.causal,
                                              dropout_mask=dmask)
        return (*grads, None, None, None, None, None)


def phase_train_step_parity(tr):
    """One train step of ``TIGERConfig()`` (ReLU feed-forward) at B=16 and
    dropout 0 on the card against an f64 CPU step: see :func:`t5_step_parity`."""
    import dataclasses

    from genrec_tpu_torch.configs import TIGERConfig
    from genrec_tpu_torch.models.tiger import TIGER
    from genrec_tpu_torch.pipelines.tiger_pipeline import loss_fn

    base = TIGERConfig()
    assert base.arch.feed_forward_proj == "relu", base.arch.feed_forward_proj
    cfg = dataclasses.replace(base, arch=dataclasses.replace(base.arch, dropout_rate=0.0))
    cpu = TIGER(cfg, generator=torch.Generator().manual_seed(1)).train()
    t5_step_parity("train-step", cpu, tr.arrays, loss_fn)


def t5_step_parity(tag, cpu, arrays, loss_fn):
    """One train step of a T5 model (TIGER or TIGER-prefix, ReLU feed-forward,
    dropout 0) on the first ``STEP_B`` rows of ``arrays``: loss and every
    gradient on the card (both kernels) against the same step on the CPU in
    f64 (the plain versions in f64). ``cpu`` holds the weights, on the CPU.

    The witness is f64 because ReLU's kink makes an f32 gradient
    discontinuous: two f32 runs that round one pre-activation near 0 to
    opposite signs differ by that token's whole contribution. The card's own
    f32 rounding can flip a decision against f64 as well (the step has 1.9 M
    feed-forward pre-activations, and some lie within an f32 rounding of 0), so
    the f64 witness takes every ReLU decision as the card took it: each
    feed-forward multiplies wi(x) by the card's recorded (wi(x) > 0) mask of
    that layer. The decisions that differ are counted with their largest
    |pre-activation| in f64; the f64 step with its own ReLU and the f32 CPU
    step are run as well and their distances printed, not held to the bound."""
    import copy

    from genrec_tpu_torch.models.t5 import T5FeedForward
    from genrec_tpu_torch.ops import t5_attention as ta

    rows = np.arange(STEP_B)
    out, pre = {}, {}  # pre: run -> feed-forward name -> wi(x), f64 on the CPU
    for name, dev, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                             ("cpu_f64_own_relu", "cpu", torch.float64),
                             ("cpu_f64", "cpu", torch.float64)):
        model = copy.deepcopy(cpu).to(dev, dtype)
        batch = {k: torch.from_numpy(v[rows]).to(dev, dtype if v.dtype.kind == "f" else None)
                 for k, v in arrays.items()}  # float inputs (prof vectors) in the step's type
        batch["valid"] = torch.ones(STEP_B, dtype=torch.bool, device=dev)
        ffs = {m: n for n, m in model.named_modules() if isinstance(m, T5FeedForward)}
        seen, wi = pre.setdefault(name, {}), {m.wi: n for m, n in ffs.items()}

        def keep(mod, args, h, seen=seen, wi=wi):  # returns None: the output stays as it is
            seen[wi[mod]] = h.detach().double().cpu()

        hooks = [m.register_forward_hook(keep) for m in wi]
        fused, ff_forward = ta._FusedT5Attention, T5FeedForward.forward
        if dtype == torch.float64:
            ta._FusedT5Attention = _PlainAttention
        if name == "cpu_f64":  # the card's ReLU decisions; dropout is 0 here
            card = {n: (h > 0).double() for n, h in pre["card"].items()}
            T5FeedForward.forward = lambda self, x, generator=None: self.wo(  # noqa: E731
                self.wi(x) * card[ffs[self]])
        try:
            loss, _ = loss_fn(model, batch, None)
            loss.backward()
        finally:
            ta._FusedT5Attention, T5FeedForward.forward = fused, ff_forward
            for hook in hooks:
                hook.remove()
        out[name] = (float(loss.detach()),
                     {k: p.grad.double().cpu() for k, p in model.named_parameters()})
    flips = [(h > 0) != (pre["card"][n] > 0) for n, h in pre["cpu_f64_own_relu"].items()]
    near = [h[f].abs().max().item() for f, h in zip(flips, pre["cpu_f64_own_relu"].values())
            if f.any()]
    n_pre = sum(f.numel() for f in flips)
    print(f"[{tag}] ReLU decisions of the card's step against the f64 step's own: "
          f"{sum(int(f.sum()) for f in flips)} of {n_pre} differ, the largest at "
          f"|pre-activation| {max(near, default=0.0):.3e} (f64)")
    loss_ref, ref = out["cpu_f64"]
    loss_err = abs(out["card"][0] - loss_ref)
    assert loss_err <= TOL, f"{tag} loss card vs f64 CPU {loss_err} > {TOL}"
    worst = {}
    for name, witness in (("card", "cpu_f64"), ("card_own", "cpu_f64_own_relu"),
                          ("cpu", "cpu_f64_own_relu")):
        got = out["card" if name == "card_own" else name][1]
        worst[name] = (0.0, "")
        for k, g_ref in out[witness][1].items():
            err, scale = (got[k] - g_ref).abs().max().item(), g_ref.abs().max().item()
            if name == "card":
                assert err <= BWD_REL * scale + TOL, (
                    f"{k}: grad card vs f64 CPU {err} (max {scale})")
            # relative to max(max|f64|, TOL): a gradient that is 0 in exact arithmetic
            # (the adapters' key bias shifts every score of a query alike) holds f32 noise
            worst[name] = max(worst[name], (err / max(scale, TOL), k))
    lt = f" Lt={arrays['labels'].shape[1]}" if "labels" in arrays else ""
    print(f"[{tag}] B={STEP_B}{lt} dropout 0 ReLU: loss card "
          f"{out['card'][0]:.7f}, "
          f"CPU f32 {out['cpu'][0]:.7f}, CPU f64 {loss_ref:.7f} (card |diff| {loss_err:.2e}); "
          f"{len(ref)} gradients against the f64 step with the card's ReLU decisions, worst "
          f"max_err/max(max|f64|, TOL): card {worst['card'][0]:.2e} ({worst['card'][1]}); "
          f"printed, not "
          f"held, against the f64 step with its own ReLU: card {worst['card_own'][0]:.2e} "
          f"({worst['card_own'][1]}), CPU f32 {worst['cpu'][0]:.2e} ({worst['cpu'][1]})")


def phase_train(tmp, tr, te, codes):
    """The training path at full width: tiger_pipeline.train for 3 epochs at
    batch 256 on the card, a resume to a 4th epoch, evaluate. Kernel launch
    counts are set to 0 just before and read just after."""
    import dataclasses

    from genrec_tpu_torch.configs import TIGERConfig
    from genrec_tpu_torch.data.datasets import num_batches
    from genrec_tpu_torch.ops import t5_attention as ta
    from genrec_tpu_torch.pipelines import tiger_pipeline

    base = TIGERConfig(constrained_decoding="trie")
    cfg = dataclasses.replace(base, trainer=dataclasses.replace(
        base.trainer, epochs=TRAIN_EPOCHS, batch_size=BATCH, eval_batch_size=BATCH,
        ckpt_dir=os.path.join(tmp, "train_ckpt"), seed=0))
    steps_per_epoch = num_batches(len(tr.input_ids), BATCH)
    val_batches = num_batches(len(te.input_ids), BATCH)

    # ---- the main path: counts at 0 just before, read just after ----
    ta.launches = ta.bwd_launches = ta.dbias_reduce_launches = 0
    art = tiger_pipeline.train(cfg, tr, te, device="cuda")
    res = art.result
    cfg2 = dataclasses.replace(cfg, trainer=dataclasses.replace(
        cfg.trainer, epochs=TRAIN_EPOCHS + 1, resume=True))
    art2 = tiger_pipeline.train(cfg2, tr, te, device="cuda")
    metrics = tiger_pipeline.evaluate(cfg2, art2, te, codes, device="cuda")
    torch.cuda.synchronize()
    fwd, bwd, reduce = ta.launches, ta.bwd_launches, ta.dbias_reduce_launches
    # ---- end of the main path ----

    losses = res.train_losses + art2.result.train_losses
    print(f"[train] losses by epoch (train): {[round(x, 5) for x in losses]}; val: "
          f"{[round(x, 5) for x in res.val_losses + art2.result.val_losses]}")
    assert all(np.isfinite(losses + res.val_losses + art2.result.val_losses)), losses
    assert res.epochs_run == TRAIN_EPOCHS and res.train_losses[-1] < res.train_losses[0], losses
    assert art2.result.epochs_run == TRAIN_EPOCHS + 1 and len(art2.result.train_losses) == 1
    print(f"[train] resume from the latest checkpoint ran epoch {art2.result.epochs_run} only")
    assert set(metrics) == {f"{m}@{k}" for m in ("Recall", "NDCG") for k in cfg.topk_list}
    print(f"[train] evaluate (trie, {max(max(cfg.topk_list), cfg.beam_size)} beams): "
          + ", ".join(f"{k}={v:.4f}" for k, v in metrics.items()))

    steps = res.steps_run + art2.result.steps_run
    assert steps == (TRAIN_EPOCHS + 1) * steps_per_epoch, steps
    want_fwd = 6 * steps + 6 * (TRAIN_EPOCHS + 1) * val_batches + 2 * val_batches
    print(f"[launches] training path: t5_attention_fwd {fwd} (want 6 x {steps} steps + 6 x "
          f"{(TRAIN_EPOCHS + 1) * val_batches} val batches + 2 x {val_batches} generate "
          f"batches = {want_fwd}), t5_attention_bwd {bwd} (want 6 x {steps} = {6 * steps}), "
          f"t5_attention_dbias_reduce {reduce} (want 4 x {steps} = {4 * steps}: the encoder's "
          f"and the decoder's self-attention, whose bias learns)")
    assert fwd == want_fwd and bwd == 6 * steps and reduce == 4 * steps, (fwd, bwd, reduce)

    ph = res.phase_seconds
    steady_steps = (res.epochs_run - 1) * steps_per_epoch
    ms_step = (ph["train"] - ph["first_epoch"]) / steady_steps * 1e3
    print(f"[train] B={BATCH}, {steps_per_epoch} steps/epoch: {res.steady_examples_per_sec:.1f} "
          f"train examples/s and {ms_step:.2f} ms/step over epochs 2-{res.epochs_run} (host "
          f"clock); first epoch {ph['first_epoch']:.2f} s, val {ph['val']:.2f} s, ckpt "
          f"{ph['ckpt']:.2f} s")

    # one step, profiled, on a fresh trainer (outside the counted main path)
    trainer = tiger_pipeline.build_trainer(cfg, tr, te, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = trainer.gather(trainer.train_data, torch.arange(BATCH, device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    prof = profile_window(f"one train step (B={BATCH}, Lt=156, dropout 0.1)",
                          lambda: trainer.train_step(batch, gen), top_n=12)
    busy = None
    if prof is not None:
        busy = prof[0] / 1e3 / ms_step
        print(f"[train] device busy {prof[0] / 1e3:.3f} ms per step against {ms_step:.2f} ms "
              f"per step on the host clock without the profiler: {100 * busy:.1f}% busy")
    print(f"[train] peak device memory over the profiled steps: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dict(fwd=fwd, bwd=bwd, reduce=reduce, examples_s=res.steady_examples_per_sec,
                ms_step=ms_step, busy=busy, train_losses=res.train_losses,
                recall10=metrics["Recall@10"], device_ms=None if prof is None else prof[0] / 1e3)


WIDTH_MODES = 4   # [len-buckets], [composite]: TIGERConfig's target_len_buckets / _composite
MODE_EPOCHS = 2   # [len-buckets], [composite]: epochs of the main path
MODE_SLICE = 64   # rows of the card-against-CPU epoch of each mode, at batch 16 and 2 widths
MODE_SLICE_B = 16
# the bucket widths the TIGER corpus gives at 4 buckets that the train shapes lack: (name,
# Lq, Lk, bias, causal bias, pad, seed); 44 and 120 rows fill 16-row strips partly
BUCKET_CASES = (("dec_self_44", 44, 44, True, True, False, 51),
                ("dec_self_120", 120, 120, True, True, False, 52),
                ("cross_44", 44, 80, False, False, True, 53),
                ("cross_120", 120, 80, False, False, True, 54))
BUCKET_SHAPES = tuple(c[0] for c in BUCKET_CASES)


@contextlib.contextmanager
def kernel_shapes():
    """The (Lq, Lk) of every launch of kernels #1 and #2 while inside, by
    kernel: a record beside the launch counts, which it does not change."""
    from genrec_tpu_torch.ops import t5_attention as ta

    seen = {"fwd": set(), "bwd": set()}
    launch, launch_bwd = ta._launch, ta._launch_bwd

    def fwd(qf, kf, *rest):
        seen["fwd"].add((qf.shape[1], kf.shape[1]))
        return launch(qf, kf, *rest)

    def bwd(qf, kf, *rest):
        seen["bwd"].add((qf.shape[1], kf.shape[1]))
        return launch_bwd(qf, kf, *rest)

    ta._launch, ta._launch_bwd = fwd, bwd
    try:
        yield seen
    finally:
        ta._launch, ta._launch_bwd = launch, launch_bwd


def _mode_cfg(tmp, ckpt, field, n, *, epochs, batch, dropout):
    """TIGERConfig() with ``field`` (target_len_buckets or
    target_len_composite) at ``n``, dropout ``dropout``, seed 0."""
    from genrec_tpu_torch.configs import TIGERConfig

    base = TIGERConfig()
    return dataclasses.replace(
        base, arch=dataclasses.replace(base.arch, dropout_rate=dropout), **{field: n},
        trainer=dataclasses.replace(base.trainer, epochs=epochs, batch_size=batch,
                                    eval_batch_size=batch, ckpt_dir=os.path.join(tmp, ckpt),
                                    seed=0))


def _slice_epoch_card_vs_cpu(tag, field, tmp, tr, te):
    """One epoch of ``tiger_pipeline.train`` on the first ``MODE_SLICE``
    rows of both splits at batch 16, 2 widths and dropout 0, on the card and
    on the CPU from the same seeded weights: the epoch's train and
    validation losses within 1e-4 relative."""
    from genrec_tpu_torch.data.datasets import TigerArrays
    from genrec_tpu_torch.pipelines import tiger_pipeline

    def head(a):
        return TigerArrays(*(x[:MODE_SLICE] for x in (a.input_ids, a.attention_mask, a.labels,
                                                       a.user_ids)))

    def epoch(dev):
        cfg = _mode_cfg(tmp, f"{tag}_slice_{dev}", field, 2, epochs=1, batch=MODE_SLICE_B,
                        dropout=0.0)
        r = tiger_pipeline.train(cfg, head(tr), head(te), device=dev).result
        return r.train_losses + r.val_losses

    card, cpu = epoch("cuda"), epoch("cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    print(f"[{tag}] {MODE_SLICE} rows, B={MODE_SLICE_B}, 2 widths, dropout 0, 1 epoch: train "
          f"and val loss card {[round(x, 7) for x in card]} CPU {[round(x, 7) for x in cpu]}, "
          f"largest relative difference {rel:.2e} (held at 1e-4)")
    assert rel <= 1e-4 and all(np.isfinite(card)), (tag, card, cpu)
    return rel


def phase_width_mode(tag, field, tmp, tr, te, train):
    """TIGER training in one of the trainer's width modes at full width:
    ``tiger_pipeline.train`` at ``field`` = 4 (target_len_buckets: each
    length bucket at its own decoder width; target_len_composite: width
    groups with half their rows drawn from shorter groups), batch 256,
    dropout 0.1, 2 epochs on the card. Kernel launch counts are set to 0
    just before and read just after; the (Lq, Lk) pairs of #1 and #2 are
    recorded. Then a profiled step at each width beside the flat step of
    ``[train]``, and the 64-row epoch against the CPU."""
    from genrec_tpu_torch.data import datasets
    from genrec_tpu_torch.data.datasets import num_batches
    from genrec_tpu_torch.ops import t5_attention as ta
    from genrec_tpu_torch.pipelines import tiger_pipeline
    from genrec_tpu_torch.train.trainer import Trainer

    cfg = _mode_cfg(tmp, f"{tag}_ckpt", field, WIDTH_MODES, epochs=MODE_EPOCHS, batch=BATCH,
                    dropout=0.1)
    if field == "target_len_buckets":
        buckets = datasets.bucket_by_target_len(tr.arrays, WIDTH_MODES, cfg.code_dim)
        widths = [b["labels"].shape[1] for b in buckets]
        rows = [len(b["labels"]) for b in buckets]
        per_epoch = [sum(num_batches(n, BATCH) for n in rows)] * MODE_EPOCHS
        print(f"[{tag}] bucket widths {widths} holding {rows} rows: "
              + " + ".join(str(num_batches(n, BATCH)) for n in rows)
              + f" = {per_epoch[0]} steps an epoch at B={BATCH} (flat: "
              f"{num_batches(len(tr.input_ids), BATCH)})")
        assert per_epoch[0] == 18, per_epoch
    else:
        row_w, widths = datasets.target_len_widths(tr.arrays, WIDTH_MODES, cfg.code_dim)
        plans = [Trainer._composite_plan(row_w, widths, BATCH, cfg.trainer.composite_mix,
                                         cfg.trainer.seed + e) for e in range(1, MODE_EPOCHS + 1)]
        per_epoch = [sum(len(m) for _, m in plan) for plan in plans]
        widths = sorted({w for plan in plans for w, _ in plan})  # a group may drain
        print(f"[{tag}] group widths {widths}; epoch 1's groups (width: rows, steps) "
              + ", ".join(f"{w}: {int((m >= 0).sum())}, {len(m)}" for w, m in plans[0])
              + f"; steps an epoch {per_epoch} at B={BATCH} (flat: "
              f"{num_batches(len(tr.input_ids), BATCH)})")
    val_batches = num_batches(len(te.input_ids), BATCH)

    # ---- the main path: counts at 0 just before, read just after ----
    ta.launches = ta.bwd_launches = ta.dbias_reduce_launches = 0
    with kernel_shapes() as seen:
        res = tiger_pipeline.train(cfg, tr, te, device="cuda").result
        torch.cuda.synchronize()
    fwd, bwd, reduce = ta.launches, ta.bwd_launches, ta.dbias_reduce_launches
    # ---- end of the main path ----

    steps = res.steps_run
    assert steps == sum(per_epoch), (steps, per_epoch)
    want_fwd = 6 * steps + 6 * MODE_EPOCHS * val_batches
    print(f"[launches] {tag} path: t5_attention_fwd {fwd} (want 6 x {steps} steps + 6 x "
          f"{MODE_EPOCHS * val_batches} val batches = {want_fwd}), t5_attention_bwd {bwd} "
          f"(want {6 * steps}), t5_attention_dbias_reduce {reduce} (want {4 * steps})")
    assert fwd == want_fwd and bwd == 6 * steps and reduce == 4 * steps, (fwd, bwd, reduce)
    ran = sorted({lq for lq, _ in seen["bwd"]})  # the decoder's widths, and the encoder's 80
    print(f"[{tag}] (Lq, Lk) of t5_attention_fwd: {sorted(seen['fwd'])}; of "
          f"t5_attention_bwd: {sorted(seen['bwd'])}")
    assert all((w, w) in seen["bwd"] and (w, 80) in seen["bwd"] for w in widths), seen
    assert set(ran) == set(widths) | {80}, (ran, widths)
    if field == "target_len_buckets":
        assert {44, 120} <= set(ran), ran
    # each (Lq, Lk) the path trained at is one that #1 and #2 are held at: the train shapes
    # (enc, dec_self and cross_train) or BUCKET_CASES
    compared = {(80, 80), (156, 156), (156, 80)} | {(c[1], c[2]) for c in BUCKET_CASES}
    assert seen["bwd"] <= compared, (seen["bwd"], compared)

    losses = res.train_losses
    print(f"[{tag}] losses by epoch (train): {[round(x, 5) for x in losses]}; val: "
          f"{[round(x, 5) for x in res.val_losses]}")
    assert all(np.isfinite(losses + res.val_losses)) and losses[1] < losses[0], losses
    ph = res.phase_seconds
    ms_step = (ph["train"] - ph["first_epoch"]) / per_epoch[-1] * 1e3
    card = card_line()
    print(f"[{tag}] on {card}: {res.steady_examples_per_sec:.1f} train examples/s and "
          f"{ms_step:.2f} ms/step over epoch 2 (host clock) against the flat [train] run's "
          f"{train['examples_s']:.1f} examples/s and {train['ms_step']:.2f} ms/step in this "
          f"process; first epoch {ph['first_epoch']:.2f} s")

    # one step at each width, profiled (outside the counted main path)
    trainer = tiger_pipeline.build_trainer(dataclasses.replace(cfg, target_len_buckets=1,
                                                               target_len_composite=0),
                                           tr, te, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    full = trainer.train_data
    lens = (tr.labels != -100).sum(axis=1)
    step_ms = {}
    for w in widths:  # B rows whose targets fit w, their labels cut to w
        idx = torch.from_numpy(np.flatnonzero(lens <= w)[-BATCH:]).cuda()
        batch = trainer.gather(full, idx)
        batch["labels"] = batch["labels"][:, :w].contiguous()
        prof = profile_window(f"[{tag}] one train step (B={BATCH}, Lt={w}, dropout 0.1)",
                              lambda: trainer.train_step(batch, gen), top_n=4)
        step_ms[w] = None if prof is None else prof[0] / 1e3
    print(f"[{tag}] on {card}: device ms of one step by decoder width: "
          + ", ".join(f"{w}: {v}" for w, v in step_ms.items())
          + f"; the flat step of [train] (Lt=156): {train['device_ms']}")
    slice_rel = _slice_epoch_card_vs_cpu(tag, field, tmp, tr, te)
    return dict(fwd=fwd, bwd=bwd, reduce=reduce, steps=steps, widths=widths, ran=ran,
                examples_s=res.steady_examples_per_sec, ms_step=ms_step, step_ms=step_ms,
                train_losses=losses, slice_rel=slice_rel)


def phase_bucket_kernels():
    """Kernels #1 and #2 against their plain versions at the bucket widths
    the train shapes lack (``BUCKET_CASES``, batch 256, 4 heads of 16), with
    the f32 dropout mask and without it: the existing tolerances, two calls
    bit-identical, times, bounds and SDPA."""
    fwd, bwd = {}, {}
    for name, lq, lk, bias, causal_bias, pad, seed in BUCKET_CASES:
        for tail in ("", "_no_dropout"):
            kw = dict(bias=bias, pad=pad, causal_in_bias=causal_bias, seed=seed)
            fwd[name + tail] = fwd_case_check(
                name + tail, attention_case(name + tail, 4, BATCH, lq, lk, 16,
                                            dropout=not tail, **kw)[1], repeat=not tail)
            bwd[name + tail] = bwd_case_check(
                name + tail, bwd_case(name + tail, 4, BATCH, lq, lk, 16, dropout=not tail,
                                      **kw)[1], repeat=not tail)
    card = card_line()
    for name in BUCKET_SHAPES:
        r, r0, b, b0 = fwd[name], fwd[name + "_no_dropout"], bwd[name], bwd[name + "_no_dropout"]
        print(f"[len-buckets] {name} on {card}: #1 device ms {r['device_ms']:.5f} with the mask (bound "
              f"{r['bound_ms']:.5f}), {r0['device_ms']:.5f} without against SDPA's "
              f"{r0['library_device_ms']}; #2 {b['device_ms']:.5f} (bound {b['bound_ms']:.5f}), "
              f"{b0['device_ms']:.5f} without against SDPA backward's {b0['library_device_ms']}")
    return fwd, bwd


def phase_data():
    """The native batch packer: built from ``genrec_tpu_torch/native/
    packer.cpp`` with g++ (it must be available here), and the TIGER, SASRec
    and DenseT5 train arrays of the TIGER corpus bit-equal to the Python
    path's, with each path's seconds."""
    from genrec_tpu_torch.configs import DenseT5Config, SASRecConfig, TIGERConfig
    from genrec_tpu_torch.data import datasets, native_packer, tiger_tokens
    from genrec_tpu_torch.data.synthetic import make_codes, make_interactions

    t0 = time.perf_counter()
    assert native_packer.available(), "the native packer did not build"
    ready_s = time.perf_counter() - t0
    built = native_packer.build_seconds
    print(f"[data] on {card_line()}: native packer "
          f"{os.path.relpath(native_packer.library_path(), HERE)}: "
          + ("built earlier" if built is None else f"g++ {built:.3f} s")
          + f", ready in {ready_s:.3f} s")
    corpus = make_interactions(num_users=TRAIN_USERS, num_items=N_ITEMS, min_len=4,
                               max_len=41, seed=0)
    split, _ = tiger_tokens.build_tiger_splits(corpus.item_id_lists, corpus.user_ids,
                                               make_codes(N_ITEMS))
    builds = {
        "tiger": lambda n: datasets.build_tiger_arrays(split, TIGERConfig().max_len, 4,
                                                       use_native=n),
        "sasrec": lambda n: datasets.build_sasrec_arrays(corpus, SASRecConfig().max_len,
                                                         "train", use_native=n),
        "dense_t5": lambda n: datasets.build_dense_t5_arrays(corpus, DenseT5Config().max_seq_len,
                                                             "train", use_native=n)}
    seconds = {}
    for name, build in builds.items():
        out = {}
        for native in (True, False):
            t0 = time.perf_counter()
            out[native] = build(native).arrays
            seconds[(name, native)] = time.perf_counter() - t0
        assert out[True].keys() == out[False].keys()
        for k, v in out[True].items():
            assert v.dtype == out[False][k].dtype and np.array_equal(v, out[False][k]), (name, k)
        print(f"[data] {name} train arrays "
              + ", ".join(f"{k} {tuple(v.shape)}" for k, v in out[True].items())
              + f": native and Python bit-equal; native {seconds[(name, True)]:.4f} s, Python "
              f"{seconds[(name, False)]:.4f} s")
    return dict(build_s=native_packer.build_seconds, ready_s=ready_s, seconds=seconds)


DIST_TOPK_B = 64       # [dist]: histories scored by predict_topk over the 10M-row table
DIST_STEPS = 3         # [dist]: train steps of each 10M-row run
RING_SHAPE = (8, 4, LC_L, 16)  # [dist]: ring attention at M = 1, (B, H, L, D)


def _grads_of(trainer):
    return {k: p.grad.detach().clone() for k, p in trainer.model.named_parameters()}


def _dist_tiger(tmp, tr, te, train):
    """TIGER at ``TIGERConfig()`` under DDP over the one-rank NCCL group: one
    step against the single-device Trainer's on the same batch and generator
    (loss and every gradient; launches of #1 and #2 equal), one epoch of
    ``tiger_pipeline.train`` under the group (the counted path), whose loss
    must equal the first epoch of ``[train]``'s, and one profiled step of
    each."""
    from genrec_tpu_torch.configs import TIGERConfig
    from genrec_tpu_torch.data.datasets import num_batches
    from genrec_tpu_torch.ops import t5_attention as ta
    from genrec_tpu_torch.parallel.auto import dp_shardings
    from genrec_tpu_torch.pipelines import tiger_pipeline

    base = TIGERConfig(constrained_decoding="trie")
    cfg = dataclasses.replace(base, trainer=dataclasses.replace(
        base.trainer, epochs=1, batch_size=BATCH, eval_batch_size=BATCH,
        ckpt_dir=os.path.join(tmp, "dist_ckpt"), seed=0))
    single = tiger_pipeline.build_trainer(cfg, tr, te, device="cuda")
    again = tiger_pipeline.build_trainer(cfg, tr, te, device="cuda")
    dp = tiger_pipeline.build_trainer(cfg, tr, te, device="cuda", mesh=dp_shardings(cfg.mesh))
    assert isinstance(dp._ddp, torch.nn.parallel.DistributedDataParallel)
    step = {}
    for name, trainer in (("single", single), ("again", again), ("dp", dp)):
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = trainer.gather(trainer.train_data, torch.arange(BATCH, device="cuda"))
        ta.launches = ta.bwd_launches = ta.dbias_reduce_launches = 0
        sl, vl = trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        step[name] = (sl.item() / vl.item(), _grads_of(trainer),
                      (ta.launches, ta.bwd_launches, ta.dbias_reduce_launches), batch, gen)
    (l1, g1, n1, b1, gen1), (l2, g2, n2, b2, gen2) = step["single"], step["dp"]
    worst, bitwise = {}, {}
    for other in ("dp", "again"):  # "again": the card's own spread between two equal steps
        lo, go = step[other][0], step[other][1]
        worst[other], bitwise[other] = (0.0, ""), lo == l1
        for k, g in g1.items():
            err, scale = (go[k] - g).abs().max().item(), g.abs().max().item()
            bitwise[other] = bitwise[other] and torch.equal(go[k], g)
            assert err <= BWD_REL * scale + TOL, f"{k}: {other} grad vs single {err} (max {scale})"
            worst[other] = max(worst[other], (err, k))
        assert abs(l1 - lo) <= 1e-6 * abs(l1), (other, l1, lo)
    assert n1 == n2 == step["again"][2] == (6, 6, 4), (n1, n2)
    print(f"[dist] TIGER B={BATCH} dropout {cfg.arch.dropout_rate}, DDP over NCCL at world size "
          f"1 against the single-device step (same batch, generator and weights): loss "
          f"{l2:.7f} vs {l1:.7f}, {len(g1)} gradients, largest |diff| {worst['dp'][0]:.3e} "
          f"({worst['dp'][1]}), bit-identical: {bitwise['dp']}; a second single-device step "
          f"against the first: largest |diff| {worst['again'][0]:.3e} ({worst['again'][1]}), "
          f"bit-identical: {bitwise['again']}; launches #1/#2/reduce {n2} a step, as "
          f"single-device {n1}")

    # ---- the [dist] TIGER path: counts at 0 just before, read just after ----
    ta.launches = ta.bwd_launches = ta.dbias_reduce_launches = 0
    art = tiger_pipeline.train(cfg, tr, te, device="cuda")
    torch.cuda.synchronize()
    fwd, bwd, reduce = ta.launches, ta.bwd_launches, ta.dbias_reduce_launches
    # ---- end ----
    steps, val_batches = art.result.steps_run, num_batches(len(te.input_ids), BATCH)
    assert steps == num_batches(len(tr.input_ids), BATCH), steps
    assert (fwd, bwd, reduce) == (6 * steps + 6 * val_batches, 6 * steps, 4 * steps), (
        fwd, bwd, reduce)
    loss, want = art.result.train_losses[0], train["train_losses"][0]
    assert abs(loss - want) <= 1e-5 * abs(want), (loss, want)
    print(f"[dist] tiger_pipeline.train under the group, 1 epoch ({steps} DDP steps): train loss "
          f"{loss:.7f} against [train]'s first epoch {want:.7f} (|diff| {abs(loss - want):.2e}); "
          f"launches #1 {fwd}, #2 {bwd}, reduce {reduce}")
    prof = {}
    for name, trainer, batch, gen in (("single", single, b1, gen1), ("dp", dp, b2, gen2)):
        prof[name] = profile_window(f"[dist] one TIGER train step, {name}",
                                    lambda: trainer.train_step(batch, gen), top_n=4)
    line = "; ".join(f"{k} {v[0] / 1e3:.3f} ms device of {v[1] / 1e3:.3f} ms host "
                     f"({100 * v[0] / v[1]:.1f}% busy)" for k, v in prof.items() if v)
    print(f"[dist] TIGER train step (profiler, 3 steps after a warm-up): {line}")
    return dict(fwd=fwd, bwd=bwd, reduce=reduce, max_grad_diff=worst["dp"][0], prof=prof)


def _chunked_topk_reference(h, table, k):
    """Top-k of h @ table.T by chunks of TOPK_CHUNK_ROWS rows upcast to f32,
    merged at the end: the (B, V) logits never exist whole."""
    from genrec_tpu_torch.models.sasrec_large import TOPK_CHUNK_ROWS

    vals, ids = [], []
    for lo in range(0, table.shape[0], TOPK_CHUNK_ROWS):
        v, i = torch.topk(h.float() @ table[lo:lo + TOPK_CHUNK_ROWS].float().T, k, dim=-1)
        vals.append(v)
        ids.append(i + lo)
    v, j = torch.topk(torch.cat(vals, 1), k, dim=-1)
    return v, torch.gather(torch.cat(ids, 1), 1, j)


def _dist_sasrec_large(mesh, dtype):
    """``SASRecLargeConfig()`` (10,000,000 rows, d 64, 2 blocks, batch 4,096,
    64 negatives, dropout 0.2) with its table in ``dtype`` on the 1 × 1 mesh:
    the psum and all_to_all lookups against ``F.embedding`` (exact) and
    timed; ``predict_topk`` of both lookups and of ``use_sharded=False``
    against a chunked top-k (values exact); then DIST_STEPS Adam steps from
    the same weights and generator through each, whose losses must be
    ``use_sharded=False``'s; peak memory and a profiled step."""
    from torch.nn import functional as F

    from genrec_tpu_torch.configs import SASRecLargeConfig, ShardedEmbeddingConfig
    from genrec_tpu_torch.models.sasrec_large import SASRecLarge, make_train_step
    from genrec_tpu_torch.ops.embedding import alltoall_embedding_lookup, sharded_embedding_lookup

    base = SASRecLargeConfig()
    cfg = dataclasses.replace(base, embedding=dataclasses.replace(base.embedding, dtype=dtype))
    assert isinstance(cfg.embedding, ShardedEmbeddingConfig) and cfg.embedding.vocab_size == 10**7
    item_num, bsz = cfg.embedding.vocab_size - 1, cfg.trainer.batch_size
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.device("cuda"):
        model = SASRecLarge(item_num, cfg, mesh=mesh, lookup_impl="psum",
                            generator=torch.Generator(device="cuda").manual_seed(0))
    table = model.item_table
    assert table.dtype == getattr(torch, dtype) and table.shape == (10**7, 64)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(21)
    x = rng.integers(1, item_num + 1, size=(bsz, cfg.max_len + 1))
    x[: bsz // 4, : cfg.max_len // 2] = 0  # a quarter of the rows left-padded
    inputs = torch.from_numpy(x[:, :-1]).cuda()
    targets = torch.from_numpy(np.where(x[:, :-1] == 0, 0, x[:, 1:])).cuda()

    with torch.no_grad():
        plain = F.embedding(inputs, table)
        e_psum = sharded_embedding_lookup(table, inputs, mesh)
        e_a2a, ok = alltoall_embedding_lookup(table, inputs, mesh, capacity_factor=2.0)
        assert torch.equal(e_psum, plain) and torch.equal(e_a2a, plain) and bool(ok.all())
        look_ms = {"F.embedding": cuda_ms(lambda: F.embedding(inputs, table), 50),
                   "psum": cuda_ms(lambda: sharded_embedding_lookup(table, inputs, mesh), 50),
                   "alltoall": cuda_ms(lambda: alltoall_embedding_lookup(
                       table, inputs, mesh, capacity_factor=2.0), 50)}

    model.eval()
    hist = inputs[:DIST_TOPK_B]
    with torch.no_grad():
        h_t = model(hist)[:, -1, :].contiguous()
        want_v, want_i = _chunked_topk_reference(h_t, table, TOP_K)
        topk = {}
        for impl, sharded in (("psum", True), ("alltoall", True), ("replicated", False)):
            model.lookup_impl, model.use_sharded = ("psum" if impl == "replicated" else impl,
                                                    sharded)
            v, i = model.predict_topk(hist, TOP_K)
            assert torch.equal(v, want_v), f"{dtype} {impl}: top-{TOP_K} values differ"
            clear = torch.ones_like(want_i, dtype=torch.bool)
            gap = (want_v[:, 1:] - want_v[:, :-1]).abs() > 0
            clear[:, 1:] &= gap
            clear[:, :-1] &= gap
            assert torch.equal(i[clear], want_i[clear]), f"{dtype} {impl}: top-{TOP_K} ids"
            topk[impl] = cuda_ms(lambda: model.predict_topk(hist, TOP_K), 3, windows=3)

    runs = {}
    for impl, sharded in (("replicated", False), ("psum", True), ("alltoall", True)):
        model.load_state_dict(init)
        model.lookup_impl, model.use_sharded = ("psum" if impl == "replicated" else impl, sharded)
        opt = torch.optim.Adam(model.parameters(), lr=cfg.trainer.lr, betas=(0.9, 0.999),
                               eps=1e-8)
        step = make_train_step(model, opt, cfg, item_num)
        gen = torch.Generator(device="cuda").manual_seed(5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [step(inputs, targets, gen) for _ in range(DIST_STEPS)]
        torch.cuda.synchronize()
        runs[impl] = ([v.item() for v in losses], (time.perf_counter() - t0) / DIST_STEPS * 1e3)
        if impl == "psum":
            prof = profile_window(f"[dist] one SASRecLargeConfig() step, {dtype} table, psum",
                                  lambda: step(inputs, targets, gen), top_n=6)
        del opt, step
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
    # psum reads and differentiates as F.embedding does: the same losses; all_to_all
    # sums a row's gradient in bucket order, which moves the later steps' losses
    want = runs["replicated"][0]
    rel = {"psum": 1e-6, "alltoall": 1e-5 if dtype == "float32" else 1e-3}
    for impl, tol in rel.items():
        got = runs[impl][0]
        assert all(abs(a - b) <= tol * abs(b) for a, b in zip(got, want)), (impl, got, want)
    assert all(np.isfinite(want))
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy = ("" if prof is None else f"; device {prof[0] / 1e3:.3f} ms of {prof[1] / 1e3:.3f} ms "
            f"host a psum step ({100 * prof[0] / prof[1]:.1f}% busy)")
    print(f"[dist] SASRecLargeConfig() {dtype} table (10,000,000 x 64) on the 1 x 1 mesh: "
          f"psum and all_to_all lookups of ({bsz}, {cfg.max_len}) ids equal F.embedding exactly; "
          f"lookup ms " + ", ".join(f"{k} {v:.4f}" for k, v in look_ms.items())
          + f"; predict_topk at B={DIST_TOPK_B} equal to the chunked top-{TOP_K} (values exact), "
          f"ms " + ", ".join(f"{k} {v:.2f}" for k, v in topk.items()))
    print(f"[dist] SASRecLargeConfig() {dtype}: {DIST_STEPS} Adam steps at B={bsz}, dropout "
          f"{cfg.dropout}, the same generator: losses " + "; ".join(
              f"{k} {[round(v, 6) for v in r[0]]} ({r[1]:.2f} ms/step host)"
              for k, r in runs.items())
          + busy + f"; peak device memory {peak:.2f} GiB")
    del model, init, table, plain, e_psum, e_a2a
    torch.cuda.empty_cache()
    return dict(look_ms=look_ms, topk_ms=topk, runs=runs, peak_gib=peak, prof=prof)


def _dist_ring(mesh):
    """Ring attention at M = 1 over the 'model' axis against the plain
    attention (``_xla_attention``), out and q/k/v gradients, causal."""
    from genrec_tpu_torch.ops.attention import _xla_attention
    from genrec_tpu_torch.ops.ring_attention import ring_attention

    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, w = (torch.randn(RING_SHAPE, generator=gen, device="cuda") for _ in range(4))
    outs = []
    for fn in (lambda a, b, c: ring_attention(a, b, c, mesh, axis_name="model", causal=True),
               lambda a, b, c: _xla_attention(a, b, c, None, True)):
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        out = fn(qs, ks, vs)
        (out * w).sum().backward()
        outs.append([out.detach()] + [t.grad for t in (qs, ks, vs)])
    errs = [(a - b).abs().max().item() for a, b in zip(*outs)]
    assert errs[0] <= TOL, f"ring out vs plain {errs[0]}"
    for name, err, ref in zip("qkv", errs[1:], outs[1][1:]):
        assert err <= BWD_REL * ref.abs().max().item() + TOL, f"ring d{name} {err}"
    print(f"[dist] ring attention at M=1, (B, H, L, D) {RING_SHAPE} causal, against the plain "
          f"attention: out max |diff| {errs[0]:.2e}, dq/dk/dv {errs[1]:.2e}/{errs[2]:.2e}/"
          f"{errs[3]:.2e}")
    return errs


def phase_dist(tmp, tr, te, train):
    """``[dist]``: the distributed layer over an NCCL group of one rank (the
    card is alone; NCCL refuses two ranks on one card): the group through a
    ``file://`` rendezvous, the 1 × 1 mesh; TIGER under DDP
    (:func:`_dist_tiger`); ``SASRecLargeConfig()``'s 10,000,000-row sharded
    table in f32 and bf16 (:func:`_dist_sasrec_large`); ring attention at
    M = 1 (:func:`_dist_ring`). The group is destroyed at the end, so that
    the later phases run on one device without one."""
    import torch.distributed as dist

    from genrec_tpu_torch.configs import MeshConfig
    from genrec_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    t0 = time.perf_counter()
    dev = initialize_multihost("file://" + os.path.join(tmp, "dist_rendezvous"), 1, 0)
    try:
        assert dist.get_backend() == "nccl" and dev == torch.device("cuda", 0), dev
        mesh = make_mesh(MeshConfig(data_axis=1, model_axis=1))
        out = {"tiger": _dist_tiger(tmp, tr, te, train)}
        for dtype in ("float32", "bfloat16"):
            out[dtype] = _dist_sasrec_large(mesh, dtype)
        out["ring"] = _dist_ring(mesh)
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    print(f"[dist] phase {out['seconds']:.1f} s")
    return out


TP_WORLD = 2          # [tp]: gloo ranks sharing cuda:0, the 1 x 2 mesh
TP_SAS_STEPS = 2      # [tp]: parity SASRec SGD steps on the cut table
TP_TIMEOUT_S = 600    # [tp]: both ranks must end within this


def _tp_cfg(tmp, name):
    """``TIGERConfig()`` (trie) on the 1 × 2 mesh at batch 256, one epoch,
    replicated datasets: the global batches of ``[train]``'s first epoch."""
    from genrec_tpu_torch.configs import MeshConfig, TIGERConfig

    base = TIGERConfig(constrained_decoding="trie")
    return dataclasses.replace(base, mesh=MeshConfig(data_axis=1, model_axis=TP_WORLD),
                               trainer=dataclasses.replace(
                                   base.trainer, epochs=1, batch_size=BATCH,
                                   eval_batch_size=BATCH, ckpt_dir=os.path.join(tmp, name),
                                   seed=0, shard_dataset=False))


class _RecordShapes:
    """Inside the block, the q and k shapes of each call of kernel #1's and
    #2's wrappers, appended to ``calls`` as (name, q shape, k shape)."""

    def __init__(self, ta, calls):
        self.ta, self.calls = ta, calls

    def __enter__(self):
        ta, calls = self.ta, self.calls
        self.fwd, self.bwd = ta.t5_attention_fwd, ta.t5_attention_bwd

        def wrap(name, fn):
            def call(qf, kf, *a, **kw):
                calls.append((name, tuple(qf.shape), tuple(kf.shape)))
                return fn(qf, kf, *a, **kw)
            return call

        ta.t5_attention_fwd, ta.t5_attention_bwd = wrap("fwd", self.fwd), wrap("bwd", self.bwd)

    def __exit__(self, *exc):
        self.ta.t5_attention_fwd, self.ta.t5_attention_bwd = self.fwd, self.bwd


def _tp_sasrec(mesh):
    """The parity SASRec at ``SASRecConfig()`` on a 699-item catalog (a
    700-row table, 350 rows a rank) against the same model whole on this
    rank: ``TP_SAS_STEPS`` SGD steps of ``train_loss`` (dropout and
    negatives from same-seeded CUDA generators), losses, gathered gradients
    and parameters; and the specs of a 701-row table."""
    from genrec_tpu_torch.configs import SASRecConfig
    from genrec_tpu_torch.models.sasrec import SASRec, train_loss
    from genrec_tpu_torch.parallel.auto import param_shardings
    from genrec_tpu_torch.parallel.tensor import gather_state, shard_model_

    cfg = SASRecConfig()
    items = N_ITEMS - 1
    rng = np.random.default_rng(5)
    x = rng.integers(1, items + 1, size=(cfg.trainer.batch_size, cfg.max_len))
    x[:8, :5] = 0
    t = np.where(x == 0, 0, rng.integers(1, items + 1, size=x.shape))
    x, t = torch.from_numpy(x).cuda(), torch.from_numpy(t).cuda()
    runs = {}
    for name in ("whole", "cut"):
        model = SASRec(items, cfg, generator=torch.Generator().manual_seed(0)).cuda().train()
        specs = param_shardings(mesh, model) if name == "cut" else {}
        cut = shard_model_(model, mesh, specs)
        # SGD: an update proportional to the gradient (Adam's first steps are
        # ±lr wherever a gradient is rounding noise)
        opt = torch.optim.SGD(model.parameters(), lr=0.5)
        gen = torch.Generator(device="cuda").manual_seed(0)
        losses, grads = [], []
        for _ in range(TP_SAS_STEPS):
            opt.zero_grad()
            loss, _ = train_loss(model, x, t, gen, cfg, items)
            loss.backward()
            grads.append(gather_state({k: p.grad for k, p in model.named_parameters()},
                                      mesh, specs))
            opt.step()
            losses.append(loss.item())
        params = gather_state({k: p.detach() for k, p in model.named_parameters()}, mesh, specs)
        runs[name] = (losses, grads, params, sorted(cut), model.item_emb.weight.shape[0])
    (lw, gw, pw, _, _), (lc, gc, pc, cut, rows) = runs["whole"], runs["cut"]
    worst = (0.0, "")
    for step in range(TP_SAS_STEPS):
        assert abs(lc[step] - lw[step]) <= BWD_REL * abs(lw[step]) + TOL, (step, lc, lw)
        for k, g in gw[step].items():
            err, scale = (gc[step][k] - g).abs().max().item(), g.abs().max().item()
            assert err <= BWD_REL * scale + TOL, f"step {step} {k}: {err} (max {scale})"
            worst = max(worst, (err, f"step {step} {k}"))
    for k, p in pw.items():
        err = (pc[k] - p).abs().max().item()
        assert err <= BWD_REL * p.abs().max().item() + TOL, f"{k}: {err}"
    whole_701 = param_shardings(mesh, SASRec(N_ITEMS, cfg))
    return dict(losses=lc, whole_losses=lw, cut=cut, rows=rows, worst=worst,
                specs_701=whole_701["item_emb.weight"])


def tp_rank_main(rank: int, world: int, rdv: str, out: str) -> int:
    """One ``[tp]`` rank (``chip_smoke.py --tp-rank <rank> <world> <rdv>
    <out>``): joins a gloo group of ``world`` ranks on ``cuda:0`` through
    the ``file://`` rendezvous ``rdv`` and runs, on the 1 × ``world`` mesh,
    a TIGER step (counts, shapes and gathered gradients), a profiled step,
    one epoch of ``tiger_pipeline.train`` (the counted path) and
    :func:`_tp_sasrec`; saves what it found to ``<out>/rank<rank>.pt`` for
    the parent to hold."""
    import torch.distributed as dist

    from genrec_tpu_torch.ops import t5_attention as ta
    from genrec_tpu_torch.parallel.auto import dp_shardings
    from genrec_tpu_torch.parallel.mesh import initialize_multihost
    from genrec_tpu_torch.parallel.tensor import gather_state
    from genrec_tpu_torch.pipelines import tiger_pipeline

    set_precision()
    dev = initialize_multihost("file://" + rdv, world, rank, backend="gloo")
    try:
        data = torch.load(os.path.join(out, "data.pt"), weights_only=False)
        tr, te, tmp = data["tr"], data["te"], data["tmp"]
        cfg = _tp_cfg(tmp, "tp_step_ckpt")
        mesh = dp_shardings(cfg.mesh)
        res = {"backend": dist.get_backend(), "device": str(dev),
               "model_index": mesh.index("model")}
        trainer = tiger_pipeline.build_trainer(cfg, tr, te, device="cuda", mesh=mesh)
        res["cut"] = sorted(trainer._cut)
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = trainer.gather(trainer.train_data, torch.arange(BATCH, device="cuda"))
        calls = []
        with _RecordShapes(ta, calls):
            ta.launches = ta.bwd_launches = ta.dbias_reduce_launches = 0
            sl, vl = trainer.train_step(batch, gen)
            torch.cuda.synchronize()
            res["step_launches"] = (ta.launches, ta.bwd_launches, ta.dbias_reduce_launches)
        res["step_calls"] = calls
        res["step_loss"] = sl.item() / vl.item()
        grads = gather_state({k: p.grad for k, p in trainer.model.named_parameters()}, mesh,
                             trainer._specs)
        if rank == 0:
            res["step_grads"] = {k: v.cpu() for k, v in grads.items()}
        res["prof"] = profile_window(
            f"[tp] rank {rank}: one TIGER train step (B={BATCH}, dropout 0.1, 2 of 4 heads and "
            f"128 of d_ff 256, gloo on the card)", lambda: trainer.train_step(batch, gen), top_n=6)
        del trainer, batch, grads
        torch.cuda.empty_cache()

        # ---- the [tp] path: counts at 0 just before, read just after ----
        ta.launches = ta.bwd_launches = ta.dbias_reduce_launches = 0
        art = tiger_pipeline.train(_tp_cfg(tmp, "tp_ckpt"), tr, te, device="cuda")
        torch.cuda.synchronize()
        res["epoch_launches"] = (ta.launches, ta.bwd_launches, ta.dbias_reduce_launches)
        # ---- end ----
        res["epoch_loss"] = art.result.train_losses[0]
        res["epoch_steps"] = art.result.steps_run
        res["epoch_s"] = art.result.phase_seconds["train"]
        res["sasrec"] = _tp_sasrec(mesh)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def _run_tp_ranks(out: str) -> list:
    """Start ``TP_WORLD`` rank processes of this script on the card, wait
    for all (a rank that fails ends the others at once: they would wait in
    a collective), relay their ``[`` lines and return their results."""
    logs = [os.path.join(out, f"rank{r}.log") for r in range(TP_WORLD)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r), str(TP_WORLD),
                 os.path.join(out, "rendezvous"), out], cwd=HERE, stdout=f,
                stderr=subprocess.STDOUT))
    deadline = time.monotonic() + TP_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        with open(log) as f:
            text = f.read()
        for line in text.splitlines():
            if line.startswith("["):
                print(f"[tp] rank {r}: {line}")
        assert p.returncode == 0, f"[tp] rank {r} exited {p.returncode}:\n{text[-4000:]}"
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(TP_WORLD)]


def phase_tp(tmp, tr, te, train):
    """``[tp]``: dense tensor parallelism over the 'model' axis on the card.
    Two gloo ranks share ``cuda:0`` (NCCL refuses two ranks on one card) on
    the 1 × 2 mesh, each with 2 of ``TIGERConfig()``'s 4 heads (kernels #1
    and #2 at (2·256, L, 16)) and 128 of its 256 d_ff: a B=256 step at
    dropout 0.1 against the one-device step from same-seeded CUDA
    generators (loss and every gathered gradient within the backward's
    bound, 6 + 6 launches a rank); one epoch of ``tiger_pipeline.train``
    whose loss equals ``[train]``'s first within rtol 2e-4, and whose
    checkpoint, loaded whole on one device, serves ``tiger_model_fn``
    requests with the lists of ``[dist]``'s one-device epoch checkpoint;
    the parity SASRec's 700-row table cut in two (:func:`_tp_sasrec`); a
    profiled step a rank. Gloo moves the tensors through the host, so the
    times say what one card does with two ranks, not what TP costs over
    NVLink."""
    from genrec_tpu_torch.data.datasets import num_batches
    from genrec_tpu_torch.ops import t5_attention as ta
    from genrec_tpu_torch.pipelines import tiger_pipeline
    from genrec_tpu_torch.serving.model_fn import tiger_model_fn

    t0 = time.perf_counter()
    ta.load_kernel()  # built here: the ranks load the same libraries
    ta.load_bwd_kernel()
    out = os.path.join(tmp, "tp")
    os.makedirs(out)
    torch.save({"tr": tr, "te": te, "tmp": tmp}, os.path.join(out, "data.pt"))

    single = tiger_pipeline.build_trainer(_tp_cfg(tmp, "tp_single_ckpt"), tr, te, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = single.gather(single.train_data, torch.arange(BATCH, device="cuda"))
    sl, vl = single.train_step(batch, gen)
    ref_loss, ref_grads = sl.item() / vl.item(), _grads_of(single)
    del single, batch

    ranks = _run_tp_ranks(out)

    steps, val_batches = num_batches(len(tr.input_ids), BATCH), num_batches(len(te.input_ids),
                                                                            BATCH)
    assert [r["backend"] for r in ranks] == ["gloo"] * TP_WORLD, ranks
    assert [r["device"] for r in ranks] == ["cuda:0"] * TP_WORLD
    assert sorted(r["model_index"] for r in ranks) == list(range(TP_WORLD))
    cfg = _tp_cfg(tmp, "")
    a = cfg.arch
    n_attn = a.num_layers + 2 * a.num_decoder_layers
    for r, res in enumerate(ranks):
        assert len(res["cut"]) == 4 * n_attn + 2 * (a.num_layers + a.num_decoder_layers), res["cut"]
        assert res["step_launches"] == (6, 6, 4), res["step_launches"]
        hb = a.num_heads // TP_WORLD * BATCH
        for name, q, k in res["step_calls"]:
            assert q[0] == hb and q[2] == a.d_kv and k[0] == hb, (name, q, k)
        print(f"[tp] rank {r} (model index {res['model_index']}, {res['backend']} on "
              f"{res['device']}): {len(res['cut'])} tensors cut; one step: #1/#2/reduce "
              f"launches {res['step_launches']}, kernel calls (q, k): "
              + ", ".join(f"{n} {q}/{k}" for n, q, k in res["step_calls"]))
    loss, grads = ranks[0]["step_loss"], ranks[0]["step_grads"]
    worst = (0.0, "")
    for k, g in ref_grads.items():
        g = g.cpu()
        err, scale = (grads[k] - g).abs().max().item(), g.abs().max().item()
        assert err <= BWD_REL * scale + TOL, f"[tp] {k}: grad vs single {err} (max {scale})"
        worst = max(worst, (err, k))
    for res in ranks:
        assert abs(res["step_loss"] - ref_loss) <= BWD_REL * abs(ref_loss) + TOL, (
            res["step_loss"], ref_loss)
    print(f"[tp] TIGER B={BATCH} dropout {cfg.arch.dropout_rate} on the 1 x {TP_WORLD} mesh "
          f"against the one-device step (same batch, generator seed and weights): loss "
          f"{loss:.7f} vs {ref_loss:.7f} (|diff| {abs(loss - ref_loss):.2e}), {len(grads)} "
          f"gathered gradients, largest |diff| {worst[0]:.3e} ({worst[1]})")

    want = train["train_losses"][0]
    for r, res in enumerate(ranks):
        fwd, bwd, red = res["epoch_launches"]
        assert res["epoch_steps"] == steps, res["epoch_steps"]
        assert (fwd, bwd, red) == (6 * steps + 6 * val_batches, 6 * steps, 4 * steps), (
            fwd, bwd, red)
        assert abs(res["epoch_loss"] - want) <= 2e-4 * abs(want), (res["epoch_loss"], want)
        print(f"[tp] rank {r}: tiger_pipeline.train, 1 epoch ({steps} steps, {res['epoch_s']:.2f} "
              f"s): train loss {res['epoch_loss']:.7f} against [train]'s first epoch {want:.7f} "
              f"(rel {abs(res['epoch_loss'] - want) / want:.2e}); launches #1 {fwd}, #2 {bwd}, "
              f"reduce {red}")

    codes_path = os.path.join(tmp, "codes", "course_rqvae_codes.npy")
    fns = {name: tiger_model_fn(os.path.join(tmp, ckpt), codes_path, device="cuda")
           for name, ckpt in (("tp", "tp_ckpt"), ("dist", "dist_ckpt"))}
    before = ta.launches
    for hist in APP_HISTORIES:
        lists = {name: fn(hist, TOP_K) for name, fn in fns.items()}
        assert lists["tp"] == lists["dist"], lists
        print(f"[tp] the TP checkpoint on one device, history of {len(hist)} items -> "
              f"{lists['tp']} (the [dist] epoch's checkpoint: the same)")
    torch.cuda.synchronize()
    assert ta.launches - before == 2 * len(fns) * len(APP_HISTORIES), ta.launches - before

    for r, res in enumerate(ranks):
        s = res["sasrec"]
        assert s["rows"] == N_ITEMS // TP_WORLD and s["cut"] == ["item_emb.weight"], s
        assert s["specs_701"] == (), s["specs_701"]
        print(f"[tp] rank {r}: parity SASRec, 699 items (700 rows, {s['rows']} a rank), "
              f"{TP_SAS_STEPS} SGD steps: losses {[round(x, 7) for x in s['losses']]} against "
              f"whole {[round(x, 7) for x in s['whole_losses']]}, largest gradient |diff| "
              f"{s['worst'][0]:.3e} ({s['worst'][1]}); 700 items (701 rows): table whole")
    prof = [res["prof"] for res in ranks]
    line = "; ".join(f"rank {r} {p[0] / 1e3:.3f} ms device of {p[1] / 1e3:.3f} ms host"
                     for r, p in enumerate(prof) if p)
    print(f"[tp] TIGER TP train step (profiler, 3 steps after a warm-up, both ranks at once on "
          f"one card, gloo through the host): {line or 'not measured'}")
    seconds = time.perf_counter() - t0
    print(f"[tp] phase {seconds:.1f} s")
    return dict(fwd=sum(r["epoch_launches"][0] for r in ranks),
                bwd=sum(r["epoch_launches"][1] for r in ranks),
                reduce=sum(r["epoch_launches"][2] for r in ranks),
                max_grad_diff=worst[0], prof=prof, seconds=seconds)


def phase_profile_dir(tmp, tr, te):
    """``[profile-dir]``: ``tiger_pipeline.train`` at ``TIGERConfig()`` for 2
    epochs with ``trainer.profile_dir`` set. The Trainer traces the second
    epoch only: one Chrome-trace file, its "train epoch 2" range and no
    other epoch's, kernel #1 and #2 at 6 launches a step of one epoch and
    the dbias reduction at 4."""
    import glob

    from genrec_tpu_torch.configs import TIGERConfig
    from genrec_tpu_torch.data.datasets import num_batches
    from genrec_tpu_torch.ops import t5_attention as ta
    from genrec_tpu_torch.pipelines import tiger_pipeline

    prof_dir = os.path.join(tmp, "profile")
    base = TIGERConfig(constrained_decoding="trie")
    cfg = dataclasses.replace(base, trainer=dataclasses.replace(
        base.trainer, epochs=2, batch_size=BATCH, eval_batch_size=BATCH,
        ckpt_dir=os.path.join(tmp, "profile_ckpt"), seed=0, profile_dir=prof_dir))
    steps, val_batches = num_batches(len(tr.input_ids), BATCH), num_batches(len(te.input_ids),
                                                                            BATCH)
    # ---- the [profile-dir] path: counts at 0 just before, read just after ----
    ta.launches = ta.bwd_launches = ta.dbias_reduce_launches = 0
    art = tiger_pipeline.train(cfg, tr, te, device="cuda")
    torch.cuda.synchronize()
    fwd, bwd, reduce = ta.launches, ta.bwd_launches, ta.dbias_reduce_launches
    # ---- end ----
    assert (fwd, bwd, reduce) == (12 * steps + 12 * val_batches, 12 * steps, 8 * steps), (
        fwd, bwd, reduce)
    files = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    count = {k: sum(k in n for n in kernels) for k in (
        "t5_attention_fwd_kernel", "t5_attention_bwd_kernel", "t5_attention_dbias_reduce_kernel")}
    epochs = sorted({n for n in names if n.startswith("train epoch ")})
    print(f"[profile-dir] tiger_pipeline.train, 2 epochs of {steps} steps with profile_dir: "
          f"{os.path.basename(files[0])} ({os.path.getsize(files[0]) / 2**20:.1f} MiB, "
          f"{len(events)} events, {len(kernels)} kernels); ranges {epochs}; kernel events "
          f"{count} (want 6, 6 and 4 x {steps}); losses {art.result.train_losses}")
    assert epochs == ["train epoch 2"], epochs
    assert count == {"t5_attention_fwd_kernel": 6 * steps, "t5_attention_bwd_kernel": 6 * steps,
                     "t5_attention_dbias_reduce_kernel": 4 * steps}, count
    return dict(fwd=fwd, bwd=bwd, reduce=reduce, kernels=count)


def _greedy_margins(model, embs):
    """For each row, the smallest gap between its two nearest codes over the
    levels of the greedy assignment, relative to the row's largest distance
    at that level (the model's own device and type)."""
    from genrec_tpu_torch.models.rqvae import _sq_distances

    with torch.no_grad():
        residual = model.encode(torch.from_numpy(embs))
        rel = torch.full((len(embs),), float("inf"), dtype=torch.float64)
        for level in range(len(model.cfg.num_emb_list)):
            cb = model.codebook(level)
            d = _sq_distances(residual, cb).double()
            two = d.topk(2, dim=1, largest=False).values
            rel = torch.minimum(rel, (two[:, 1] - two[:, 0]) / d.abs().amax(1).clamp(min=1e-30))
            residual = residual - cb[d.argmin(1)]
    return rel.numpy()


def phase_rqvae(tmp):
    """The RQ-VAE path at ``RQVAEConfig()`` widths (in 768, layers (256, 128),
    e_dim 32, 3 codebooks of 8, k-means 50, Sinkhorn 50, 30 repair rounds) on
    ``make_item_embs(700, 768)`` rows 1..700 at batch 64: ``train`` for up to
    ``RQ_EPOCHS`` epochs (the reconstruction loss must fall), ``infer``
    (greedy codes, grouped Sinkhorn repair, the 4th digit, codes.npy). The
    card's greedy codes are held against the CPU's; one train step against
    an f64 CPU step. Returns the (700, 4) codes."""
    import dataclasses
    import logging

    from genrec_tpu_torch.configs import RQVAEConfig
    from genrec_tpu_torch.data.synthetic import make_item_embs
    from genrec_tpu_torch.models.rqvae import RQVAE, collision_rate
    from genrec_tpu_torch.ops import t5_attention as ta
    from genrec_tpu_torch.pipelines import rqvae_pipeline
    from genrec_tpu_torch.train.trainer import Trainer

    # JAX's rule, on which farthest-point init and code assignment depend: the
    # first index on a tie, here on the card (a long row reduces across blocks)
    ties = torch.tensor([[3.0, 1.0, 1.0, 5.0, 5.0], [2.0] * 5], device="cuda")
    assert torch.argmin(ties, 1).tolist() == [1, 0] and torch.argmax(ties, 1).tolist() == [3, 0]
    flat = torch.zeros(1 << 20, device="cuda")
    flat[[5000, 700_000]] = 1.0
    assert int(torch.argmax(flat)) == 5000 and int(torch.argmin(1.0 - flat)) == 5000
    assert int(torch.argmin(flat)) == 0
    print("[rqvae] torch.argmin / argmax on the card take the first index on ties")

    base = RQVAEConfig()
    assert (base.in_dim, base.layers, base.e_dim, base.num_emb_list, base.kmeans_iters,
            base.sk_iters, base.collision_repair_iters, base.trainer.batch_size) == (
        768, (256, 128), 32, (8, 8, 8), 50, 50, 30, 64), base
    cfg = dataclasses.replace(
        base, semantic_id_file=os.path.join(tmp, "rqvae", "course_rqvae_codes.npy"),
        trainer=dataclasses.replace(base.trainer, epochs=RQ_EPOCHS,
                                    ckpt_dir=os.path.join(tmp, "rqvae_ckpt")))
    embs = make_item_embs(N_ITEMS, cfg.in_dim)[1:]  # row 0 is the padding row
    rounds = []

    class _Rounds(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("Collision-repair iter"):
                rounds.append(record.getMessage())

    handler = _Rounds()
    logging.getLogger("rqvae").addHandler(handler)
    # ---- the main path: counts at 0 just before, read just after ----
    ta.launches = ta.bwd_launches = ta.dbias_reduce_launches = 0
    try:
        t0 = time.perf_counter()
        art = rqvae_pipeline.train(cfg, embs, device="cuda")
        t1 = time.perf_counter()
        codes = rqvae_pipeline.infer(cfg, art, embs, device="cuda")
        t2 = time.perf_counter()
    finally:
        logging.getLogger("rqvae").removeHandler(handler)
    counts = (ta.launches, ta.bwd_launches, ta.dbias_reduce_launches)
    # ---- end of the main path ----
    assert counts == (0, 0, 0), counts  # plain tensor code: no kernel of the port runs here
    res = art.result
    losses = res.train_losses
    assert all(np.isfinite(losses)), losses
    # the loss the training lowers: reconstruction, over all 700 items in eval mode,
    # before training (k-means init) and after its last epoch. The total adds
    # 0.1 x the quantization loss, which grows with the latent's scale on this data (the
    # port's per-epoch losses equal the reference's in tests/test_torch_rqvae_pipeline.py),
    # so it can rise and stop early
    recon = {}
    for name, state in (("init", rqvae_pipeline.build_model(cfg, embs, "cuda").state_dict()),
                        ("last", res.final_params), ("best_collision", art.params)):
        m = RQVAE(cfg)
        m.load_state_dict(state)
        m.to("cuda").eval()
        with torch.no_grad():
            x = torch.from_numpy(embs).cuda()
            out, rq_loss, _ = m(x, use_sk=False)
            recon[name] = float(m.compute_loss(out, rq_loss, x)[1])
    print(f"[rqvae] total loss by epoch (train): {[round(x, 5) for x in losses]}, "
          f"{res.epochs_run} epochs run (early stop after {cfg.trainer.early_stop_patience} "
          f"without a lower total); reconstruction MSE over the {len(embs)} items: "
          + ", ".join(f"{k} {v:.5f}" for k, v in recon.items()))
    assert recon["last"] < 0.5 * recon["init"], recon  # a real fall, not a drift
    assert codes.shape == (N_ITEMS, 4), codes.shape
    assert len(np.unique(codes, axis=0)) == N_ITEMS, "codes collide after the 4th digit"
    mapping = cfg.semantic_id_file.replace(".npy", "_mapping.json")
    np.testing.assert_array_equal(np.load(cfg.semantic_id_file), codes)
    with open(mapping) as f:
        assert len(json.load(f)) == N_ITEMS
    rate = collision_rate(codes[:, :3])
    steps, ph = res.steps_run, res.phase_seconds
    ms_step = (ph["train"] - ph["first_epoch"]) / (steps - steps // res.epochs_run) * 1e3
    print(f"[rqvae] train {res.epochs_run} epochs ({steps} steps at B={cfg.trainer.batch_size}) in "
          f"{t1 - t0:.2f} s with k-means and the collision reads; {ms_step:.2f} ms/step over "
          f"epochs 2-{res.epochs_run} (host clock); best collision rate during training "
          f"{art.final_collision_rate:.4f}; "
          f"infer {t2 - t1:.2f} s: {len(rounds)} repair rounds, collision rate before the 4th "
          f"digit {rate:.4f}, 4th digit up to {int(codes[:, 3].max())}; codes {codes.shape} "
          f"unique, codes.npy and its mapping written")

    # the card's greedy codes against the CPU's from the same parameters
    card_model = RQVAE(cfg)
    card_model.load_state_dict(art.params)
    card = rqvae_pipeline._batched_indices(card_model.to("cuda").eval(), embs)
    cpu_model = RQVAE(cfg)
    cpu_model.load_state_dict(art.params)
    cpu = rqvae_pipeline._batched_indices(cpu_model.eval(), embs)
    clear = _greedy_margins(cpu_model, embs) > GREEDY_MARGIN
    differ = (card != cpu).any(axis=1)
    assert not (differ & clear).any(), (
        f"greedy codes differ card vs CPU on {int((differ & clear).sum())} rows whose top-2 "
        f"margin exceeds {GREEDY_MARGIN} of the row's scale")
    print(f"[rqvae] greedy codes card vs CPU: {int(differ.sum())} of {N_ITEMS} rows differ; "
          f"{int((~clear).sum())} rows have a top-2 distance margin within {GREEDY_MARGIN} of "
          f"their scale at some level; every other row is equal")

    # one step, profiled, on a fresh trainer (outside the counted main path)
    trainer = Trainer(cfg.trainer, model=rqvae_pipeline.build_model(cfg, embs, "cuda"),
                      loss_fn=rqvae_pipeline.loss_fn, train_data={"x": embs}, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = trainer.gather(trainer.train_data,
                           torch.arange(cfg.trainer.batch_size, device="cuda"))
    prof = profile_window(f"one RQ-VAE train step (B={cfg.trainer.batch_size}, Sinkhorn "
                          f"{len(cfg.num_emb_list)} x {cfg.sk_iters} iterations)",
                          lambda: trainer.train_step(batch, gen), top_n=8)
    busy = None
    if prof is not None:
        busy = prof[0] / 1e3 / ms_step
        print(f"[rqvae] device busy {prof[0] / 1e3:.3f} ms per step against {ms_step:.2f} ms per "
              f"step on the host clock without the profiler: {100 * busy:.1f}% busy")
    rqvae_step_parity(cfg, art.params, embs)
    return codes, dict(ms_step=ms_step, infer_s=t2 - t1, rounds=len(rounds), rate=rate,
                       losses=losses, recon=recon, busy=busy)


def rqvae_step_parity(cfg, params, embs):
    """One RQ-VAE train step at ``RQVAEConfig()`` widths and dropout 0 on 64
    rows, the last 4 padding (row 0, masked), as the trainer's last batch at
    700 items: loss and every gradient on the card against the same step on
    the CPU in f64 that takes the card's code assignments (Sinkhorn's argmax
    at each level) and the card's ReLU decisions, within the TIGER step's
    bound. The f64 step with its own assignments and ReLU is printed, not held."""
    import copy
    import dataclasses

    from genrec_tpu_torch.models.layers import MLPStack
    from genrec_tpu_torch.models.rqvae import RQVAE
    from genrec_tpu_torch.pipelines.rqvae_pipeline import loss_fn

    cpu = RQVAE(dataclasses.replace(cfg, dropout=0.0))
    cpu.load_state_dict(params)
    cpu.train()
    b = cfg.trainer.batch_size
    valid = np.arange(b) < b - 4
    x = np.where(valid[:, None], embs[:b], embs[0])
    out, pre, idx = {}, {}, {}
    assign, stack_forward = RQVAE.assign, MLPStack.forward
    for name, dev, dtype in (("card", "cuda", torch.float32),
                             ("cpu_f64_own", "cpu", torch.float64),
                             ("cpu_f64", "cpu", torch.float64)):
        model = copy.deepcopy(cpu).to(dev, dtype)
        batch = {"x": torch.from_numpy(x).to(dev, dtype),
                 "valid": torch.from_numpy(valid).to(dev)}
        hidden = {layer: f"{i}.{j}" for i, stack in enumerate((model.encoder, model.decoder))
                  for j, layer in enumerate(stack.layers[:-1])}
        seen, got = pre.setdefault(name, {}), idx.setdefault(name, {})

        def keep(mod, args, h, seen=seen, hidden=hidden):
            seen[hidden[mod]] = h.detach().double().cpu()

        def recording(self, d, level, use_sk, got=got, forced=name == "cpu_f64"):
            i = idx["card"][level].to(d.device) if forced else assign(self, d, level, use_sk)
            got[level] = i.cpu()
            return i

        hooks = [layer.register_forward_hook(keep) for layer in hidden]
        RQVAE.assign = recording
        if name == "cpu_f64":  # the card's ReLU decisions; dropout is 0 here
            masks = {n: (h > 0).double() for n, h in pre["card"].items()}

            def card_relu(self, x, generator=None, *, deterministic=False, hidden=hidden):
                for layer in self.layers:
                    x = layer(x)
                    if layer in hidden:
                        x = x * masks[hidden[layer]]
                return x

            MLPStack.forward = card_relu
        try:
            loss, _ = loss_fn(model, batch, None)
            loss.backward()
        finally:
            RQVAE.assign, MLPStack.forward = assign, stack_forward
            for hook in hooks:
                hook.remove()
        out[name] = (float(loss.detach()),
                     {k: p.grad.double().cpu() for k, p in model.named_parameters()})
    codes_differ = sum(int((idx["card"][lv] != idx["cpu_f64_own"][lv]).sum())
                       for lv in idx["card"])
    flips = sum(int(((h > 0) != (pre["card"][n] > 0)).sum())
                for n, h in pre["cpu_f64_own"].items())
    loss_ref, ref = out["cpu_f64"]
    loss_err = abs(out["card"][0] - loss_ref)
    assert loss_err <= TOL, f"rqvae step loss card vs f64 CPU {loss_err} > {TOL}"
    worst = {}
    for name, witness in (("card", "cpu_f64"), ("card_own", "cpu_f64_own")):
        worst[name] = (0.0, "")
        for k, g_ref in out[witness][1].items():
            g = out["card"][1][k]
            err, scale = (g - g_ref).abs().max().item(), g_ref.abs().max().item()
            if name == "card":
                assert err <= BWD_REL * scale + TOL, f"{k}: grad card vs f64 CPU {err} (max {scale})"
            worst[name] = max(worst[name], (err / max(scale, TOL), k))
    print(f"[rqvae-step] B={b} (4 padding rows) dropout 0, Sinkhorn assignment: loss card "
          f"{out['card'][0]:.7f}, CPU f64 {loss_ref:.7f} (|diff| {loss_err:.2e}); {len(ref)} "
          f"gradients against the f64 step with the card's codes and ReLU decisions, worst "
          f"max_err/max(max|f64|, TOL) {worst['card'][0]:.2e} ({worst['card'][1]}); the f64 "
          f"step's own "
          f"codes differ in {codes_differ} of {3 * b} assignments and {flips} ReLU decisions, "
          f"worst against it {worst['card_own'][0]:.2e} ({worst['card_own'][1]}), printed, "
          f"not held")


def prefix_corpus(codes):
    """The TIGER-prefix corpus: make_interactions(4096 users, 700 items, 4..41
    items each, seed 0) tokenized with ``[rqvae]``'s codes (row 0, the padding
    item, set to zeros), and three make_prof_embs(4096, 5, 768) draws (seeds
    2, 3, 4) standing in for prof_lvl{1,2,3}."""
    from genrec_tpu_torch.configs import TIGERPrefixConfig
    from genrec_tpu_torch.data import datasets, tiger_tokens
    from genrec_tpu_torch.data.synthetic import make_interactions, make_prof_embs
    from genrec_tpu_torch.pipelines.tiger_prefix_pipeline import attach_prof

    cfg = TIGERPrefixConfig()
    corpus = make_interactions(num_users=TRAIN_USERS, num_items=N_ITEMS, min_len=4,
                               max_len=41, seed=0)
    table = np.concatenate([np.zeros((1, codes.shape[1]), codes.dtype), codes])
    tr_split, te_split = tiger_tokens.build_tiger_splits(corpus.item_id_lists,
                                                         corpus.user_ids, table)
    profs = [make_prof_embs(TRAIN_USERS, cfg.num_prof_vectors, cfg.bert_dim, seed=s)
             for s in (2, 3, 4)]
    tr = attach_prof(datasets.build_tiger_arrays(tr_split, cfg.max_len, cfg.code_dim), profs)
    te = attach_prof(datasets.build_tiger_arrays(te_split, cfg.max_len, cfg.code_dim,
                                                 max_target_items=1), profs)
    print(f"[tiger-prefix] {len(tr['input_ids'])} train rows (targets up to "
          f"{tr['labels'].shape[1]} tokens), {len(te['input_ids'])} test rows, prof vectors "
          f"{tr['prof_lvl1'].shape[1:]} x 3 levels")
    return tr, te


def phase_tiger_prefix(tmp, tr, te):
    """The TIGER-prefix path at ``TIGERPrefixConfig()`` widths (d_model 128,
    2 + 4 layers, 8 heads of 16, d_ff 256, bert_dim 768, 5 vectors a level,
    80 history tokens, dropout 0.1) on ``[rqvae]``'s codes: ``train`` for
    ``TRAIN_EPOCHS`` epochs at batch 256 on device-resident data, then
    ``evaluate`` with the level constraint and 20 beams. Kernel launch counts
    are set to 0 just before and read just after. Then one profiled train
    step and one B=16 step against an f64 CPU step."""
    import dataclasses

    from genrec_tpu_torch.configs import TIGERPrefixConfig
    from genrec_tpu_torch.data.datasets import num_batches
    from genrec_tpu_torch.models.tiger_prefix import TIGERPrefix
    from genrec_tpu_torch.ops import t5_attention as ta
    from genrec_tpu_torch.pipelines import tiger_prefix_pipeline as tpp
    from genrec_tpu_torch.train.trainer import Trainer

    base = TIGERPrefixConfig()
    a = base.arch
    assert (a.d_model, a.num_layers, a.num_decoder_layers, a.num_heads, a.d_kv, a.d_ff,
            a.dropout_rate, base.bert_dim, base.num_prof_vectors, base.max_len,
            base.constrained_decoding) == (128, 2, 4, 8, 16, 256, 0.1, 768, 5, 20, "level"), base
    cfg = dataclasses.replace(base, trainer=dataclasses.replace(
        base.trainer, epochs=TRAIN_EPOCHS, batch_size=BATCH, eval_batch_size=BATCH,
        ckpt_dir=os.path.join(tmp, "prefix_ckpt"), seed=0))
    steps_per_epoch = num_batches(len(tr["input_ids"]), BATCH)
    val_batches = num_batches(len(te["input_ids"]), BATCH)

    # ---- the main path: counts at 0 just before, read just after ----
    ta.launches = ta.bwd_launches = ta.dbias_reduce_launches = 0
    art = tpp.train(cfg, tr, te, device="cuda")
    metrics = tpp.evaluate(cfg, art, te, device="cuda")
    torch.cuda.synchronize()
    fwd, bwd, reduce = ta.launches, ta.bwd_launches, ta.dbias_reduce_launches
    # ---- end of the main path ----

    res = art.result
    print(f"[tiger-prefix] losses by epoch (train): {[round(x, 5) for x in res.train_losses]}; "
          f"val: {[round(x, 5) for x in res.val_losses]}")
    assert all(np.isfinite(res.train_losses + res.val_losses)), res.train_losses
    assert res.epochs_run == TRAIN_EPOCHS and res.train_losses[-1] < res.train_losses[0]
    assert set(metrics) == {f"{m}@{k}" for m in ("Recall", "NDCG") for k in cfg.topk_list}
    beams = max(max(cfg.topk_list), cfg.beam_size)
    assert beams == BEAMS
    print(f"[tiger-prefix] evaluate (level, {beams} beams): "
          + ", ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
    steps = res.steps_run
    assert steps == TRAIN_EPOCHS * steps_per_epoch, steps
    # per train step: #1 in the 2 encoder self-, 4 decoder self- and 4 cross-attentions,
    # #2 in each of their backwards, the dbias reduction in the 6 self-attentions' (their
    # bias learns); validation's forwards 10 of #1 a batch; generate 2 (the encoder)
    want_fwd = 10 * steps + 10 * TRAIN_EPOCHS * val_batches + 2 * val_batches
    print(f"[launches] TIGER-prefix path: t5_attention_fwd {fwd} (want 10 x {steps} steps + 10 "
          f"x {TRAIN_EPOCHS * val_batches} val batches + 2 x {val_batches} generate batches = "
          f"{want_fwd}), t5_attention_bwd {bwd} (want 10 x {steps} = {10 * steps}), "
          f"t5_attention_dbias_reduce {reduce} (want 6 x {steps} = {6 * steps})")
    assert fwd == want_fwd and bwd == 10 * steps and reduce == 6 * steps, (fwd, bwd, reduce)

    ph = res.phase_seconds
    steady_steps = (res.epochs_run - 1) * steps_per_epoch
    ms_step = (ph["train"] - ph["first_epoch"]) / steady_steps * 1e3
    print(f"[tiger-prefix] B={BATCH}, {steps_per_epoch} steps/epoch: "
          f"{res.steady_examples_per_sec:.1f} train examples/s and {ms_step:.2f} ms/step over "
          f"epochs 2-{res.epochs_run} (host clock); first "
          f"epoch {ph['first_epoch']:.2f} s, val {ph['val']:.2f} s, ckpt {ph['ckpt']:.2f} s")

    # one step, profiled, on a fresh trainer (outside the counted main path)
    trainer = Trainer(cfg.trainer, model=tpp.build_model(cfg), loss_fn=tpp.loss_fn,
                      train_data=tr, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = trainer.gather(trainer.train_data, torch.arange(BATCH, device="cuda"))
    prof = profile_window(f"one TIGER-prefix train step (B={BATCH}, Lenc=83, "
                          f"Lt={tr['labels'].shape[1]}, dropout 0.1)",
                          lambda: trainer.train_step(batch, gen), top_n=12)
    busy = None
    if prof is not None:
        busy = prof[0] / 1e3 / ms_step
        print(f"[tiger-prefix] device busy {prof[0] / 1e3:.3f} ms per step against {ms_step:.2f} "
              f"ms per step on the host clock without the profiler: {100 * busy:.1f}% busy")

    cfg0 = dataclasses.replace(base, arch=dataclasses.replace(base.arch, dropout_rate=0.0))
    t5_step_parity("tiger-prefix-step",
                   TIGERPrefix(cfg0, generator=torch.Generator().manual_seed(1)).train(),
                   tr, tpp.loss_fn)
    return dict(fwd=fwd, bwd=bwd, reduce=reduce, examples_s=res.steady_examples_per_sec,
                ms_step=ms_step, busy=busy, device_ms=None if prof is None else prof[0] / 1e3,
                metrics=metrics)


def dense_corpus():
    """DenseT5's data: the TIGER corpus, make_interactions(4096 users, 700
    items, 4..41 items each, seed 0), with make_item_embs(700, 768) and
    make_user_embs(4096, 768) as the item and user-profile tables."""
    from genrec_tpu_torch.configs import DenseT5Config
    from genrec_tpu_torch.data.synthetic import make_interactions, make_item_embs, make_user_embs

    cfg = DenseT5Config()
    corpus = make_interactions(num_users=TRAIN_USERS, num_items=N_ITEMS, min_len=4,
                               max_len=41, seed=0)
    return (corpus, make_item_embs(N_ITEMS, cfg.input_emb_dim),
            make_user_embs(TRAIN_USERS, cfg.input_emb_dim))


def _dense_query_scores(model, items, hist):
    """Cosine scores (N_items + 1,) of one served history, computed as
    ``dense_t5_model_fn`` computes them (zero profile vector), on the
    model's device, returned on the CPU."""
    from genrec_tpu_torch.configs import DenseT5Config

    dev = next(model.parameters()).device
    ln = DenseT5Config().max_seq_len
    ids = [i for i in hist if 0 < i <= N_ITEMS][-ln:]
    seq = np.zeros((1, ln + 1, items.shape[1]), np.float32)
    seq[0, 1:1 + len(ids)] = items[np.asarray(ids, np.int64)]
    mask = (np.arange(ln + 1)[None, :] <= len(ids)).astype(np.int32)
    table = torch.from_numpy(items).to(dev)
    table = table / torch.clamp(torch.linalg.vector_norm(table, dim=1, keepdim=True), min=1e-8)
    pred = model.generate(torch.from_numpy(seq).to(dev), torch.from_numpy(mask).to(dev))
    return (pred @ table.T)[0].cpu()


def phase_dense_t5(tmp, corpus, items, users):
    """The DenseT5 path at ``DenseT5Config()`` widths (6 layers, d_model 512,
    4 heads of 16, d_ff 256, 768-dimensional inputs and targets, 20 items
    after the user vector, dropout 0.3, τ 0.07): (a) a B=16 step at dropout
    0 against an f64 CPU step; (b) ``train`` for ``DENSE_EPOCHS`` epochs at
    batch 256; (c) ``evaluate``; (d) ``dense_t5_model_fn`` answering B=1
    requests from (b)'s best checkpoint, held against a CPU run; (e) the
    launches of #1, #2 and the dbias reduction, counted from 0 around each
    of (b), (c) and (d) and around one train step; (f) a profiled step."""
    import dataclasses

    from genrec_tpu_torch.configs import DenseT5Config
    from genrec_tpu_torch.data.datasets import build_dense_t5_arrays, num_batches
    from genrec_tpu_torch.models.dense_t5 import DenseT5
    from genrec_tpu_torch.ops import t5_attention as ta
    from genrec_tpu_torch.pipelines import dense_t5_pipeline as dtp
    from genrec_tpu_torch.serving.model_fn import dense_t5_model_fn
    from genrec_tpu_torch.train.checkpoint import restore_best
    from genrec_tpu_torch.train.trainer import Trainer

    base = DenseT5Config()
    a = base.arch
    assert (a.d_model, a.num_layers, a.num_heads, a.d_kv, a.d_ff, a.dropout_rate,
            base.input_emb_dim, base.target_emb_dim, base.max_seq_len, base.temperature) == (
        512, 6, 4, 16, 256, DENSE_RATE, 768, 768, DENSE_L - 1, 0.07), base
    cfg = dataclasses.replace(base, trainer=dataclasses.replace(
        base.trainer, epochs=DENSE_EPOCHS, batch_size=BATCH, eval_batch_size=BATCH,
        ckpt_dir=os.path.join(tmp, "dense_ckpt"), seed=0))
    tr = build_dense_t5_arrays(corpus, base.max_seq_len, "train")
    te = build_dense_t5_arrays(corpus, base.max_seq_len, "test")
    steps_per_epoch = num_batches(len(tr.history_ids), BATCH)
    val_batches = num_batches(len(te.history_ids), BATCH)
    print(f"[dense-t5] {len(tr.history_ids)} train rows ({steps_per_epoch} steps an epoch), "
          f"{len(te.history_ids)} test rows, item table {items.shape}, user table "
          f"{users.shape}")

    # (a) one step at dropout 0 against the f64 CPU step, tables in the step's type
    cfg0 = dataclasses.replace(base, arch=dataclasses.replace(a, dropout_rate=0.0))

    def parity_loss(model, batch, generator):
        p = next(model.parameters())
        tables = [torch.from_numpy(t).to(p.device, p.dtype) for t in (items, users)]
        return dtp.make_loss_fn(cfg0, *tables)(model, batch, generator)

    t5_step_parity("dense-t5-step", DenseT5(cfg0, generator=torch.Generator().manual_seed(1))
                   .train(), tr.arrays, parity_loss)

    # (b) training, counts at 0 just before and read just after
    ta.launches = ta.bwd_launches = ta.dbias_reduce_launches = 0
    art = dtp.train(cfg, corpus, items, users, device="cuda")
    torch.cuda.synchronize()
    train_counts = (ta.launches, ta.bwd_launches, ta.dbias_reduce_launches)
    res = art.result
    print(f"[dense-t5] losses by epoch (train): {[round(x, 5) for x in res.train_losses]}; "
          f"val: {[round(x, 5) for x in res.val_losses]}")
    assert all(np.isfinite(res.train_losses + res.val_losses)), res.train_losses
    assert res.epochs_run == DENSE_EPOCHS and res.val_losses[-1] < res.val_losses[0], res
    steps = res.steps_run
    assert steps == DENSE_EPOCHS * steps_per_epoch, steps
    # #1 in the 6 encoder self-attentions of each step and validation batch; #2 and the
    # dbias reduction in each of their backwards (every layer's bias learns)
    want = (6 * steps + 6 * DENSE_EPOCHS * val_batches, 6 * steps, 6 * steps)
    print(f"[launches] DenseT5 training: (t5_attention_fwd, t5_attention_bwd, "
          f"t5_attention_dbias_reduce) = {train_counts} (want 6 x {steps} steps + 6 x "
          f"{DENSE_EPOCHS * val_batches} val batches, 6 x {steps}, 6 x {steps} = {want})")
    assert train_counts == want, (train_counts, want)
    ph = res.phase_seconds
    steady_steps = (res.epochs_run - 1) * steps_per_epoch
    ms_step = (ph["train"] - ph["first_epoch"]) / steady_steps * 1e3
    print(f"[dense-t5] B={BATCH}, {steps_per_epoch} steps/epoch: "
          f"{res.steady_examples_per_sec:.1f} train examples/s and {ms_step:.2f} ms/step over "
          f"epochs 2-{res.epochs_run} (host clock); first epoch {ph['first_epoch']:.2f} s, "
          f"val {ph['val']:.2f} s, ckpt {ph['ckpt']:.2f} s")

    # (c) evaluate
    ta.launches = ta.bwd_launches = ta.dbias_reduce_launches = 0
    metrics = dtp.evaluate(cfg, art, corpus, items, users, device="cuda")
    torch.cuda.synchronize()
    eval_counts = (ta.launches, ta.bwd_launches, ta.dbias_reduce_launches)
    eval_batches = num_batches(len(te.history_ids), cfg.trainer.eval_batch_size)
    assert set(metrics) == {f"{m}@{k}" for m in ("Recall", "NDCG") for k in cfg.topk_list}
    assert all(0.0 <= v <= 1.0 for v in metrics.values()), metrics
    print(f"[dense-t5] evaluate: " + ", ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
    print(f"[launches] DenseT5 evaluate: {eval_counts} ({eval_counts[0] / eval_batches:g} of #1 "
          f"per batch of {cfg.trainer.eval_batch_size}, {eval_batches} batches)")
    assert eval_counts == (6 * eval_batches, 0, 0), eval_counts

    # (d) serving from (b)'s best checkpoint, B = 1
    rng = np.random.default_rng(5)
    histories = [[], [int(i) for i in rng.integers(1, N_ITEMS + 1, size=3)],
                 [int(i) for i in rng.choice(np.arange(1, N_ITEMS + 1), 20, replace=False)],
                 [0, N_ITEMS + 3, -2] + [int(i) for i in rng.integers(1, N_ITEMS + 1, size=25)]]
    ta.launches = ta.bwd_launches = ta.dbias_reduce_launches = 0
    fn = dense_t5_model_fn(cfg.trainer.ckpt_dir, items, cfg=cfg, device="cuda")
    served = []
    for hist in histories:
        before = ta.launches
        got = fn(hist, TOP_K)
        torch.cuda.synchronize()
        assert ta.launches - before == 6, f"{ta.launches - before} launches for one request"
        valid_hist = {i for i in hist if 0 < i <= N_ITEMS}
        assert len(got) == TOP_K == len(set(got)), got
        assert all(1 <= i <= N_ITEMS for i in got) and not set(got) & valid_hist, (got, hist)
        served.append(got)
        print(f"[dense-t5 serve] history of {len(hist)} ids -> {got}")
    n_req = 20
    t0 = time.perf_counter()
    for _ in range(n_req):
        fn(histories[2], TOP_K)
    torch.cuda.synchronize()
    req_s = n_req / (time.perf_counter() - t0)
    serve_counts = (ta.launches, ta.bwd_launches, ta.dbias_reduce_launches)
    print(f"[dense-t5 serve] {req_s:.2f} requests/s (20-item history, {n_req} requests, host "
          f"clock); launches {serve_counts} over {len(histories) + n_req} requests")
    assert serve_counts == (6 * (len(histories) + n_req), 0, 0), serve_counts

    # the CPU on the same weights: the same top-10 lists, scores within GEN_TOL
    cpu_fn = dense_t5_model_fn(cfg.trainer.ckpt_dir, items, cfg=cfg, device="cpu")
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = DenseT5(cfg)
        models[dev].load_state_dict(restore_best(cfg.trainer.ckpt_dir))
        models[dev].to(dev).eval()
    worst = 0.0
    for hist, got in zip(histories, served):
        assert cpu_fn(hist, TOP_K) == got, (hist, got)
        card_s, cpu_s = (_dense_query_scores(models[d], items, hist) for d in ("cuda", "cpu"))
        worst = max(worst, (card_s[got] - cpu_s[got]).abs().max().item())
    assert worst <= GEN_TOL, f"DenseT5 top-10 scores card vs CPU max abs {worst} > {GEN_TOL}"
    print(f"[dense-t5 serve] {len(histories)} requests: top-{TOP_K} lists equal to the CPU "
          f"run's, their scores within {worst:.3e}")

    # (e) one train step's launches, (f) its profile: a fresh trainer, outside (b)-(d)
    items_d, users_d = (torch.from_numpy(t).cuda() for t in (items, users))
    trainer = Trainer(dataclasses.replace(cfg.trainer, ckpt_dir=os.path.join(tmp, "dense_prof")),
                      model=dtp.build_model(cfg), loss_fn=dtp.make_loss_fn(cfg, items_d, users_d),
                      train_data=tr.arrays, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = trainer.gather(trainer.train_data, torch.arange(BATCH, device="cuda"))
    ta.launches = ta.bwd_launches = ta.dbias_reduce_launches = 0
    trainer.train_step(batch, gen)
    torch.cuda.synchronize()
    step_counts = (ta.launches, ta.bwd_launches, ta.dbias_reduce_launches)
    print(f"[launches] one DenseT5 train step: {step_counts} (want (6, 6, 6)); per evaluate "
          f"batch {eval_counts[0] // eval_batches}; per request 6")
    assert step_counts == (6, 6, 6), step_counts
    prof = profile_window(f"one DenseT5 train step (B={BATCH}, L={DENSE_L}, dropout "
                          f"{DENSE_RATE})", lambda: trainer.train_step(batch, gen), top_n=12)
    busy = None
    if prof is not None:
        busy = prof[0] / 1e3 / ms_step
        print(f"[dense-t5] device busy {prof[0] / 1e3:.3f} ms per step against {ms_step:.2f} ms "
              f"per step on the host clock without the profiler: {100 * busy:.1f}% busy")
    profile_window("one DenseT5 request (20-item history)", lambda: fn(histories[2], TOP_K))
    fwd = train_counts[0] + eval_counts[0] + serve_counts[0]
    return dict(fwd=fwd, bwd=train_counts[1], reduce=train_counts[2],
                fwd_by_path={"train": train_counts[0], "evaluate": eval_counts[0],
                             "serve": serve_counts[0]},
                examples_s=res.steady_examples_per_sec, ms_step=ms_step, busy=busy,
                device_ms=None if prof is None else prof[0] / 1e3, metrics=metrics, req_s=req_s)


# ---------------------------------------------------------------------------
# [bf16]: kernels #1 and #2 at a bf16 compute dtype, and the T5 stack's bf16 path
# ---------------------------------------------------------------------------

BF16_BWD_REL = 2.0 ** -8   # kernel #2 at bf16: dq, dk, dv within this x max|plain|
BF16_LOSS_REL, BF16_OUT_REL, BF16_GRAD_REL = 5e-3, 2.0 ** -6, 3e-2  # bf16 steps: card vs CPU,
# the bounds of tests/test_torch_bf16.py (loss, logits or prediction, each gradient's
# relative Frobenius error, taken against 1e-3 of the whole gradient's norm at least); a
# gradient that bf16 rounding alone moves farther from the f64 step than BF16_GRAD_REL / 2
# on the CPU is held within twice that distance instead: two bf16 steps that round apart
# lie up to about twice as far from each other as each from f64 (TIGER-prefix's adapters
# and DenseT5's norms lie 5-6% from f64 on both sides on an H100)
BF16_GEN_REL, BF16_GEN_MARGIN = 2.0 ** -8, 0.05  # bf16 generate, card vs CPU: the score of
# every sequence that both beam searches return within BF16_GEN_REL x max|score| (a bf16
# rounding of the largest score: the two sides round their bf16 activations after sums taken
# in other orders, and a flipped rounding moves a log-probability), or within twice the CPU's
# bf16 distance from an f32 call on the same weights where that is larger, as the gradients
# above (the CPU's bf16 rounding depends on its instruction set); each side's top sequence
# among the other's beams; top beams equal on rows whose margin over the second beam exceeds
# BF16_GEN_MARGIN. Scores are matched by sequence, not by rank: where two candidates for the
# last beam slots round apart, the searches keep different prefixes, and the same rank then
# holds different sequences whose scores differ by the gap between them, not by rounding
# (name, heads, batch, Lq, Lk, keyword arguments of bwd_case): the TIGER, TIGER-prefix and
# DenseT5 train shapes at batch 256, each with the f32 dropout mask and without, and the
# serving shape (B = 1, forward only, no mask)
BF16_CASES = (
    ("enc_train", 4, BATCH, 80, 80, dict(seed=11)),
    ("dec_self_train", 4, BATCH, 156, 156, dict(pad=False, causal_in_bias=True, seed=12)),
    ("cross_train", 4, BATCH, 156, 80, dict(bias=False, seed=13)),
    ("prefix_enc", 8, BATCH, 83, 83, dict(prefix=3, seed=31)),
    ("prefix_cross", 8, BATCH, 156, 83, dict(bias=False, prefix=3, seed=32)),
    ("dense_train", 4, BATCH, DENSE_L, DENSE_L, dict(rate=DENSE_RATE, right_pad=True,
                                                      seed=41)),
    ("serve", 4, 1, 80, 80, dict(seed=1)),
)
# the wider instantiations of the bf16 entries (no model of the repo runs them): D = 64 and
# 128 at L = 80 over 4 heads of 64 rows, with the f32 dropout mask and without; checked as
# BF16_CASES are, not timed, their launches counted apart
BF16_WIDE_CASES = (
    ("d64_l80", 4, 64, 80, 80, dict(d=64, seed=61)),
    ("d128_l80", 4, 64, 80, 80, dict(d=128, seed=62)),
)
BF16_DS = (16, 64, 128)  # widths whose bf16 kernels' registers and local memory are printed


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x| > 0: 2^(⌊log2 |x|⌋ − 7), bf16 having 8 significant bits."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def _f64(x):
    return None if x is None else x.double()


def phase_bf16_kernels():
    """``[bf16]`` kernels #1 and #2 with bf16 q, k, v (and do) against their
    plain versions on the same bf16 inputs on the card, at ``BF16_CASES``:
    out within one bf16 ulp at max|plain| (the kernel rounds each tile's
    unnormalised e^(s − m)·dm to bf16 before P·V, the plain version the
    normalised probability, as the reference does: two rounding points a
    rounding apart), dq, dk and dv within ``BF16_BWD_REL``·max|plain|, dbias
    (f32) within ``BWD_REL``·max|plain| + ``TOL``; the distance of out, dq,
    dk and dv from the f64 result (the same bf16 inputs in f64) at most
    ``FLASH_F64_RATIO`` times the plain bf16 version's (dbias's is printed:
    it is the f32 reduction kernel's in-order sum over the batch, unchanged
    and bit-reproducible, about twice as far from f64 as torch's pairwise
    sum in the plain version, at 1e-5 of values up to 30); two calls
    bit-identical. Times (CUDA events and the profiler's device time) of the
    kernel, the plain version and one bf16 SDPA call (forward, and forward
    with backward through the bias, where no dropout mask is given), the
    bounds at bf16 I/O, shared memory and blocks per SM. ``BF16_WIDE_CASES``
    (D = 64 and 128) are checked the same way, untimed, their launches
    counted apart. The kernels' registers and local memory per thread
    (cudaFuncGetAttributes) at ``BF16_DS``: none local at D = 16. Every
    failure is collected and raised at the end, with all the lines
    printed."""
    from genrec_tpu_torch.ops import _build
    from genrec_tpu_torch.ops import t5_attention as ta

    bf = torch.bfloat16
    for src in ("t5_attention_fwd", "t5_attention_bwd"):
        log = _build.build_log.get(src)
        for fn, (n, stores, loads) in (ptxas_report(log[1], f"{src}_bf16_kernel")
                                       if log else {}).items():
            print(f"[bf16] ptxas {fn}: {n} registers, {stores} bytes spill stores, {loads} "
                  f"bytes spill loads")
    fails, fwd, bwd = [], {}, {}
    attrs = {d: ta.bf16_kernel_attributes(d) for d in BF16_DS}
    for d, at in attrs.items():
        print(f"[bf16] D={d}: " + "; ".join(
            f"t5_attention_{k}_bf16 {r['registers']} registers, {r['local_bytes']} bytes of "
            f"local memory per thread" for k, r in at.items()))
    for k, r in attrs[16].items():
        if r["local_bytes"]:
            fails.append(f"t5_attention_{k}_bf16 at D=16 uses {r['local_bytes']} bytes of "
                         f"local memory (spills)")
    regs = {f"t5_attention_{k}": (r["registers"], r["local_bytes"])
            for k, r in attrs[16].items()}
    wide = [0, 0]  # launches of the BF16_WIDE_CASES, forward and backward
    for name, h, b, lq, lk, kw in BF16_CASES + BF16_WIDE_CASES:
        kw = dict(kw)
        d = kw.pop("d", 16)
        timed = d == 16
        counts = (ta.bf16_launches, ta.bf16_bwd_launches)
        for drop in (False,) if name == "serve" else (True, False):
            key = name if drop or name == "serve" else f"{name}_no_dropout"
            _, a = bwd_case(key, h, b, lq, lk, d, dropout=drop, **kw)
            for t in ("qf", "kf", "vf", "do"):
                a[t] = a[t].to(bf)
            rate = kw.get("rate", 0.1) if drop else 0.0
            args = (a["qf"], a["kf"], a["vf"], h, a["pos_bias"], a["kv_mask"])
            fkw = dict(causal=a["causal"], dropout_mask=a["dropout_mask"])
            kernel = lambda: ta.fused_t5_attention_flat(*args, dropout_rate=rate, **fkw)  # noqa
            plain = lambda: ta.t5_attention_reference(*args, **fkw)  # noqa: E731
            out, ref, again = kernel(), plain(), kernel()
            exact = f64_forward(a)
            torch.cuda.synchronize()
            scale = ref.float().abs().max().item()
            err = (out.float() - ref.float()).abs().max().item()
            e64, p64 = [(x.double() - exact).abs().max().item() for x in (out, ref)]
            del exact
            if out.dtype != bf or not torch.isfinite(out.float()).all():
                fails.append(f"{key}: kernel #1 out {out.dtype}, finite "
                             f"{bool(torch.isfinite(out.float()).all())}")
            if err > bf16_ulp(scale):
                fails.append(f"{key}: #1 out vs plain {err} > one bf16 ulp at {scale}")
            if e64 > FLASH_F64_RATIO * p64:
                fails.append(f"{key}: #1 out {e64} from f64 > {FLASH_F64_RATIO} x plain's {p64}")
            if not torch.equal(out, again):
                fails.append(f"{key}: #1 two calls differ")
            fns = [kernel, plain]
            if not drop:  # no library call takes a given dropout mask
                q4, k4, v4, add = sdpa_inputs(a)
                sdpa = torch.nn.functional.scaled_dot_product_attention
                fns.append(lambda: sdpa(q4, k4, v4, attn_mask=add, scale=1.0))
            iters = 200 if name == "serve" else 20
            ms = [cuda_ms(f, iters) for f in fns] if timed else []
            dev = [device_ms(f) for f in fns] if timed else []
            ms, dev = (x + [None] * (3 - len(x)) for x in (ms, dev))
            bounds = attention_bound_ms(a)
            r = fwd[key] = dict(max_abs_err=err, ulp=bf16_ulp(scale), f64_err=e64,
                                plain_f64_err=p64, ms=ms[0], plain_ms=ms[1], library_ms=ms[2],
                                device_ms=dev[0], plain_device_ms=dev[1],
                                library_device_ms=dev[2], bound_ms=bounds["bf16"][0],
                                bound_by=bounds["bf16"][1])
            print(f"[bf16] t5_attention_fwd_bf16 {key} q={tuple(a['qf'].shape)} lk={lk} "
                  f"dropout={drop}: max_abs_err={err:.3e} (one bf16 ulp at max|plain| "
                  f"{scale:.3f}: {r['ulp']:.3e}); from f64: kernel {e64:.3e}, plain bf16 "
                  f"{p64:.3e} | per call (CUDA events): ms={ms[0]} plain_ms={ms[1]} "
                  f"sdpa_bf16_ms={ms[2]} | device only: ms={dev[0]} plain_ms={dev[1]} "
                  f"sdpa_bf16_ms={dev[2]} | bound_ms={r['bound_ms']:.6f} ({r['bound_by']}, "
                  f"bf16 I/O, products at the bf16 rate)")
            if name == "serve":
                continue

            bargs = args + (a["do"],)
            kernel = lambda: ta.t5_attention_bwd(*bargs, **fkw)  # noqa: E731
            plain = lambda: ta.t5_attention_bwd_reference(*bargs, **fkw)  # noqa: E731
            got, want, again = kernel(), plain(), kernel()
            exact = ta.t5_attention_bwd_reference(
                *(_f64(x) for x in args[:3]), h, _f64(a["pos_bias"]), a["kv_mask"],
                _f64(a["do"]), causal=a["causal"], dropout_mask=_f64(a["dropout_mask"]))
            torch.cuda.synchronize()
            errs, rels = {}, []
            for gname, g, w, x in zip(BWD_GRADS, got, want, exact):
                if g is None:
                    continue
                dt = torch.float32 if gname == "dbias" else bf
                scale = w.float().abs().max().item()
                tol = BWD_REL * scale + TOL if gname == "dbias" else BF16_BWD_REL * scale
                e = (g.float() - w.float()).abs().max().item()
                e64, p64 = [(y.double() - x).abs().max().item() for y in (g, w)]
                errs[gname] = (e, tol, e64, p64)
                rels.append(e / scale)
                if g.dtype != dt or not torch.isfinite(g).all():
                    fails.append(f"{key}: #2 {gname} {g.dtype}, want {dt}, finite "
                                 f"{bool(torch.isfinite(g).all())}")
                if e > tol:
                    fails.append(f"{key}: #2 {gname} vs plain {e} > {tol}")
                if gname != "dbias" and e64 > FLASH_F64_RATIO * p64:
                    fails.append(f"{key}: #2 {gname} {e64} from f64 > {FLASH_F64_RATIO} x "
                                 f"plain's {p64}")
            del exact
            if not all(g is None or torch.equal(g, y) for g, y in zip(got, again)):
                fails.append(f"{key}: #2 two calls differ")
            fns = [kernel, plain]
            if not drop and timed:
                lib, why = sdpa_backward(a)
                if lib is not None:
                    fns.append(lib)
                else:
                    print(f"[bf16] {key}: SDPA backward refused: {why}")
            ms = [cuda_ms(f, 20) for f in fns] if timed else []
            dev = [device_ms(f, 10) for f in fns] if timed else []
            ms, dev = (x + [None] * (3 - len(x)) for x in (ms, dev))
            bounds = bwd_bound_ms(a)
            r = bwd[key] = dict(max_abs_err=max(e[0] for e in errs.values()),
                                max_rel_err=max(rels), errs=errs, ms=ms[0], plain_ms=ms[1],
                                library_ms=ms[2], device_ms=dev[0], plain_device_ms=dev[1],
                                library_device_ms=dev[2], bound_ms=bounds["bf16"][0],
                                bound_by=bounds["bf16"][1])
            print(f"[bf16] t5_attention_bwd_bf16 {key} dropout={drop}: "
                  + "; ".join(f"{g} err {e:.3e} (tol {t:.3e}) from f64 kernel {k64:.3e} "
                              f"plain {p64:.3e}" for g, (e, t, k64, p64) in errs.items())
                  + f" | per call (CUDA events): ms={ms[0]} plain_ms={ms[1]} "
                  f"sdpa_bf16_ms={ms[2]} | device only: ms={dev[0]} plain_ms={dev[1]} "
                  f"sdpa_bf16_ms={dev[2]} | bound_ms={r['bound_ms']:.6f} ({r['bound_by']})")
            if drop and name != "serve":
                smem, per_sm = ta.fwd_occupancy(lq, lk, d, bf)
                bsmem, bper_sm = ta.bwd_occupancy(lq, lk, d, bf)
                fwd[key].update(smem_bytes=smem, blocks_per_sm=per_sm)
                bwd[key].update(smem_bytes=bsmem, blocks_per_sm=bper_sm)
                print(f"[bf16] {key}: #1 {smem} bytes of shared memory a block, {per_sm} blocks "
                      f"an SM; #2 {bsmem} bytes, {bper_sm} blocks an SM")
        if not timed:
            wide[0] += ta.bf16_launches - counts[0]
            wide[1] += ta.bf16_bwd_launches - counts[1]
    dec = fwd["dec_self_train"]
    mb = lambda n: n / 1e6  # noqa: E731
    hb, lq, d = 4 * BATCH, 156, 16
    print(f"[bf16] bytes at dec_self_train ({hb}, {lq}, {d}): q, k, v and out "
          f"{mb(4 * hb * lq * d * 2):.1f} MB in bf16 against {mb(4 * hb * lq * d * 4):.1f} MB in "
          f"f32; the f32 dropout mask {mb(hb * lq * lq * 4):.1f} MB either way; #1's bound "
          f"{dec['bound_ms']:.4f} ms with the mask, "
          f"{fwd['dec_self_train_no_dropout']['bound_ms']:.4f} ms without")
    print(f"[bf16] {', '.join(c[0] for c in BF16_WIDE_CASES)}: {wide[0]} launches of "
          f"t5_attention_fwd_bf16 and {wide[1]} of t5_attention_bwd_bf16, counted apart from "
          f"the [bf16] path's")
    if not all(wide):
        fails.append(f"the D > 16 cases launched the bf16 entries {wide} times")
    assert not fails, "[bf16] kernels:\n" + "\n".join(fails)
    print(f"[bf16] kernels #1 and #2 in bf16 hold at {len(fwd)} forward and {len(bwd)} backward "
          f"cases")
    return fwd, bwd, dict(regs, wide_launches=wide, attributes=attrs)


def _rel_frobenius(got, want, floor: float) -> float:
    return (got - want).norm().item() / max(want.norm().item(), floor)


def bf16_step_parity(tag, make, arrays, loss_fn):
    """One train step at ``STEP_B`` rows and dropout 0 of a bf16-config model
    (``make("bfloat16")``) on the card against the same step on the CPU
    (kernels #1 and #2's plain versions), held at the bounds of
    ``tests/test_torch_bf16.py``: loss, the model's output (logits or
    prediction) and every gradient. An f64 CPU step of the f32-config model
    with the same weights (``make("float32")`` in f64, the plain versions in
    f64) is the exact step; both bf16 steps' distances from it are printed."""
    from genrec_tpu_torch.ops import t5_attention as ta

    rows = np.arange(STEP_B)
    out = {}
    for name, dev, cdt, dtype in (("card", "cuda", "bfloat16", torch.float32),
                                  ("cpu", "cpu", "bfloat16", torch.float32),
                                  ("f64", "cpu", "float32", torch.float64)):
        model = make(cdt).to(dev, dtype)
        batch = {k: torch.from_numpy(v[rows]).to(dev, dtype if v.dtype.kind == "f" else None)
                 for k, v in arrays.items()}
        batch["valid"] = torch.ones(STEP_B, dtype=torch.bool, device=dev)
        seen = []
        hook = model.register_forward_hook(
            lambda m, args, o: seen.append(o[1].detach().double().cpu()))  # returns None
        fused = ta._FusedT5Attention
        if dtype == torch.float64:
            ta._FusedT5Attention = _PlainAttention
        try:
            loss, _ = loss_fn(model, batch, None)
            loss.backward()
        finally:
            ta._FusedT5Attention = fused
            hook.remove()
        out[name] = (float(loss.detach()), seen[-1],
                     {k: p.grad.double().cpu() for k, p in model.named_parameters()})
    fails, dist, per_leaf = [], {}, {}
    for name, witness in (("card", "cpu"), ("card_f64", "f64"), ("cpu_f64", "f64")):
        (lg, og, gg), (lw, ow, gw) = out[name.split("_")[0]], out[witness]
        floor = 1e-3 * torch.stack([w.norm() for w in gw.values()]).norm().item()
        per_leaf[name] = {k: _rel_frobenius(gg[k], gw[k], floor) for k in gw}
        worst = max((e, k) for k, e in per_leaf[name].items())
        dist[name] = (abs(lg - lw) / abs(lw), (og - ow).abs().max().item() / ow.abs().max().item(),
                      worst)
    loss_rel, out_rel, (grad_rel, leaf) = dist["card"]
    if loss_rel > BF16_LOSS_REL:
        fails.append(f"loss {out['card'][0]} vs CPU {out['cpu'][0]}")
    if out_rel > BF16_OUT_REL:
        fails.append(f"output max err / max|CPU| {out_rel}")
    widened = 0
    for k, e in per_leaf["card"].items():
        bound = max(BF16_GRAD_REL, 2 * per_leaf["cpu_f64"][k])
        widened += bound > BF16_GRAD_REL
        if e > bound:
            fails.append(f"gradient {k} relative Frobenius {e} > {bound}")
    print(f"[{tag}] B={STEP_B} bf16 dropout 0: loss card {out['card'][0]:.6f}, CPU "
          f"{out['cpu'][0]:.6f}, f64 {out['f64'][0]:.6f}; card vs CPU: loss rel "
          f"{loss_rel:.2e} (bound {BF16_LOSS_REL}), output max err/max {out_rel:.2e} (bound "
          f"{BF16_OUT_REL:.2e}), worst gradient rel. Frobenius {grad_rel:.2e} ({leaf}; bound "
          f"{max(BF16_GRAD_REL, 2 * per_leaf['cpu_f64'][leaf]):.2e}; {widened} of "
          f"{len(per_leaf['card'])} leaves held at twice the CPU's distance from f64); from the "
          f"f64 step (printed, not held): card loss "
          f"{dist['card_f64'][0]:.2e}, output {dist['card_f64'][1]:.2e}, gradient "
          f"{dist['card_f64'][2][0]:.2e} ({dist['card_f64'][2][1]}); CPU loss "
          f"{dist['cpu_f64'][0]:.2e}, output {dist['cpu_f64'][1]:.2e}, gradient "
          f"{dist['cpu_f64'][2][0]:.2e} ({dist['cpu_f64'][2][1]})")
    assert not fails, f"[{tag}] card vs CPU at bf16: " + "; ".join(fails)
    return dist


def _beam_scores_by_sequence(tok_a, score_a, tok_b, score_b):
    """Two beam searches' ``(B, beams, len)`` tokens and ``(B, beams)``
    scores, best first: the largest |score difference| over the sequences
    that both return in a row (masked beams, at -1e30, left out), how many
    beams of ``b`` are such sequences, and on how many rows each side's top
    sequence is among the other's beams."""
    worst, shared, tops = 0.0, 0, 0
    for ta_, sa, tb, sb in zip(tok_a, score_a, tok_b, score_b):
        a = {tuple(t.tolist()): s.item() for t, s in zip(ta_, sa) if s > -1e29}
        b = {tuple(t.tolist()): s.item() for t, s in zip(tb, sb) if s > -1e29}
        common = a.keys() & b.keys()
        shared += len(common)
        worst = max([worst] + [abs(a[k] - b[k]) for k in common])
        tops += tuple(ta_[0].tolist()) in b and tuple(tb[0].tolist()) in a
    return worst, shared, tops


def phase_bf16(tmp, tr, te, codes, train, prefix_data, dense_data):
    """``[bf16]``: the T5 stack at ``arch.dtype="bfloat16"``. (a) a B=16
    TIGER step on the card against the CPU's bf16 step (:func:`bf16_step_parity`);
    (b) ``tiger_pipeline.train`` for 3 epochs at batch 256 on ``[train]``'s
    corpus (a falling loss) and ``evaluate``, whose Recall@10 must reach half
    of ``[train]``'s f32 figure (a guard against a broken path, not a quality
    claim); (c) ``tiger_model_fn`` requests from (b)'s checkpoint and a B=256,
    20-beam ``generate`` held against the CPU's bf16 call on its first rows;
    (d) one B=16 bf16 step each of ``TIGERPrefixConfig()`` and
    ``DenseT5Config()`` against the CPU; (e) one profiled bf16 TIGER train
    step beside ``[train]``'s f32 step. The launch counts are set to 0 before
    (b) and read after (c): kernels #1 and #2 run in bf16 only, as often as
    the path ran them."""
    import dataclasses

    from genrec_tpu_torch.configs import DenseT5Config, TIGERConfig, TIGERPrefixConfig
    from genrec_tpu_torch.data.contracts import write_codes
    from genrec_tpu_torch.data.datasets import build_dense_t5_arrays, num_batches
    from genrec_tpu_torch.data import tiger_tokens
    from genrec_tpu_torch.models.dense_t5 import DenseT5
    from genrec_tpu_torch.models.tiger import TIGER, generate, make_constraint
    from genrec_tpu_torch.models.tiger_prefix import TIGERPrefix
    from genrec_tpu_torch.ops import t5_attention as ta
    from genrec_tpu_torch.pipelines import dense_t5_pipeline as dtp
    from genrec_tpu_torch.pipelines import tiger_pipeline
    from genrec_tpu_torch.pipelines import tiger_prefix_pipeline as tpp
    from genrec_tpu_torch.serving.model_fn import tiger_model_fn

    def with_dtype(cfg, dtype, **arch):
        return dataclasses.replace(cfg, arch=dataclasses.replace(cfg.arch, dtype=dtype, **arch))

    def maker(cls, cfg0):  # the same weights at either compute dtype
        state = cls(cfg0, generator=torch.Generator().manual_seed(1)).state_dict()

        def make(dtype):
            model = cls(with_dtype(cfg0, dtype))
            model.load_state_dict(state)
            return model.train()
        return make

    # (a)
    dist = {"tiger": bf16_step_parity(
        "bf16-step", maker(TIGER, with_dtype(TIGERConfig(), "float32", dropout_rate=0.0)),
        tr.arrays, tiger_pipeline.loss_fn)}

    # (b) and (c), the main path: counts at 0 just before, read just after
    base = with_dtype(TIGERConfig(constrained_decoding="trie"), "bfloat16")
    cfg = dataclasses.replace(base, trainer=dataclasses.replace(
        base.trainer, epochs=TRAIN_EPOCHS, batch_size=BATCH, eval_batch_size=BATCH,
        ckpt_dir=os.path.join(tmp, "bf16_ckpt"), seed=0))
    codes_path = os.path.join(tmp, "bf16_codes", "course_rqvae_codes.npy")
    write_codes(codes_path, codes)
    steps_per_epoch = num_batches(len(tr.input_ids), BATCH)
    val_batches = num_batches(len(te.input_ids), BATCH)
    ta.launches = ta.bwd_launches = ta.bf16_launches = ta.bf16_bwd_launches = 0
    ta.dbias_reduce_launches = 0
    art = tiger_pipeline.train(cfg, tr, te, device="cuda")
    metrics = tiger_pipeline.evaluate(cfg, art, te, codes, device="cuda")
    torch.cuda.synchronize()
    train_counts = (ta.bf16_launches, ta.bf16_bwd_launches, ta.dbias_reduce_launches)
    fn = tiger_model_fn(cfg.trainer.ckpt_dir, codes_path, cfg=cfg, device="cuda")
    rng = np.random.default_rng(5)
    histories = [[], [int(i) for i in rng.integers(1, N_ITEMS + 1, size=3)],
                 [int(i) for i in rng.choice(np.arange(1, N_ITEMS + 1), 20, replace=False)]]
    served = [fn(hist, TOP_K) for hist in histories]
    model = TIGER(cfg)
    model.load_state_dict(art.params)
    model.to("cuda").eval()
    table = tiger_tokens.codes_to_token_table(codes, cfg.codebook_size)
    ii, am = _history_batch(rng, BATCH, cfg, table)
    constraint = make_constraint(cfg, codes).to("cuda")
    tokens, scores = generate(model, torch.from_numpy(ii).cuda(), torch.from_numpy(am).cuda(),
                              num_beams=BEAMS, constraint=constraint)
    torch.cuda.synchronize()
    fwd, bwd, reduce = ta.bf16_launches, ta.bf16_bwd_launches, ta.dbias_reduce_launches
    f32_fwd, f32_bwd = ta.launches, ta.bwd_launches
    # ---- end of the main path ----

    res = art.result
    print(f"[bf16] train (bf16) losses by epoch: {[round(x, 5) for x in res.train_losses]}; "
          f"val: {[round(x, 5) for x in res.val_losses]}; f32 [train]: "
          f"{[round(x, 5) for x in train['train_losses']]}")
    assert all(np.isfinite(res.train_losses + res.val_losses)), res.train_losses
    assert res.epochs_run == TRAIN_EPOCHS and res.train_losses[-1] < res.train_losses[0]
    recall, recall32 = metrics["Recall@10"], train["recall10"]
    print(f"[bf16] evaluate (trie, 20 beams): " + ", ".join(f"{k}={v:.4f}"
                                                            for k, v in metrics.items())
          + f"; Recall@10 {recall:.4f} against [train]'s f32 {recall32:.4f} (held at >= half)")
    assert recall >= 0.5 * recall32, (recall, recall32)
    steps = res.steps_run
    want = (6 * steps + 6 * TRAIN_EPOCHS * val_batches + 2 * val_batches, 6 * steps, 4 * steps)
    print(f"[launches] bf16 training path: t5_attention_fwd_bf16 {train_counts[0]}, "
          f"t5_attention_bwd_bf16 {train_counts[1]}, dbias reduce {train_counts[2]} (want "
          f"{want}: 6 and 6 a step of {steps}, 6 a val batch of {TRAIN_EPOCHS} x "
          f"{val_batches}, 2 a generate batch of {val_batches})")
    assert train_counts == want, (train_counts, want)
    n_req = len(histories) + 1  # the requests and the batched generate, 2 launches each
    assert (fwd - train_counts[0], bwd - train_counts[1]) == (2 * n_req, 0), (fwd, bwd)
    assert f32_fwd == f32_bwd == 0, (f32_fwd, f32_bwd)  # nothing went through the f32 kernels
    for hist, items in zip(histories, served):
        assert 1 <= len(items) <= TOP_K and not set(items) & set(hist), (hist, items)
        print(f"[bf16] served history of {len(hist)} items -> {items}")

    rows = 8
    cpu = TIGER(cfg)
    cpu.load_state_dict(art.params)
    cpu.eval()
    ct, cs = generate(cpu, torch.from_numpy(ii[:rows]), torch.from_numpy(am[:rows]),
                      num_beams=BEAMS, constraint=make_constraint(cfg, codes))
    gt, gs = tokens[:rows].cpu(), scores[:rows].cpu()
    f32 = TIGER(with_dtype(cfg, "float32"))  # the same weights computed in f32: the witness
    f32.load_state_dict(art.params)
    f32.eval()
    ft, fs = generate(f32, torch.from_numpy(ii[:rows]), torch.from_numpy(am[:rows]),
                      num_beams=BEAMS, constraint=make_constraint(cfg, codes))
    gen_err, shared, tops = _beam_scores_by_sequence(ct, cs, gt, gs)
    cpu_f32, cpu_f32_shared, _ = _beam_scores_by_sequence(ct, cs, ft, fs)
    card_f32, card_f32_shared, _ = _beam_scores_by_sequence(gt, gs, ft, fs)
    by_rank = (cs - gs).abs().max().item()
    gen_tol = max(BF16_GEN_REL * cs[cs > -1e29].abs().max().item(), 2 * cpu_f32)
    margin = (cs[:, 0] - cs[:, 1]).numpy()
    clear = margin > BF16_GEN_MARGIN
    same = (ct[:, 0] == gt[:, 0]).all(dim=1).numpy()
    print(f"[bf16] generate B={BATCH} beams={BEAMS}: first {rows} rows against the CPU's bf16 "
          f"call: {shared} of {gs.numel()} beams hold a sequence the other side returned too; "
          f"their scores max abs {gen_err:.3e} (bound {gen_tol:.3e}: the larger of "
          f"{BF16_GEN_REL} x max|score| and twice the CPU's distance from f32; rank by rank, "
          f"printed, not held: {by_rank:.3e}); each side's top sequence among the other's beams "
          f"on {tops} of {rows} rows; top sequence equal on {int(same.sum())} of {rows} rows, on "
          f"{int((same & clear).sum())} of the {int(clear.sum())} whose margin exceeds "
          f"{BF16_GEN_MARGIN}")
    print(f"[bf16] against the CPU's f32 call on the same weights (by sequence): CPU bf16 "
          f"{cpu_f32:.3e} ({cpu_f32_shared} beams shared), card bf16 {card_f32:.3e} "
          f"({card_f32_shared} shared)")
    assert gen_err <= gen_tol and tops == rows and same[clear].all(), (
        gen_err, gen_tol, tops, same, margin)
    st, ss = generate(model, torch.from_numpy(ii[:rows]).cuda(), torch.from_numpy(am[:rows]).cuda(),
                      num_beams=BEAMS, constraint=constraint)
    small = _beam_scores_by_sequence(st.cpu(), ss.cpu(), gt, gs)
    print(f"[bf16] the card's own {rows}-row call against its B={BATCH} call (printed, not "
          f"held): scores rank by rank max abs {(ss.cpu() - gs).abs().max().item():.3e}; "
          f"{small[1]} beams shared, their scores max abs {small[0]:.3e}")

    # (d)
    ptr, _ = prefix_data
    dist["tiger_prefix"] = bf16_step_parity(
        "bf16-prefix-step",
        maker(TIGERPrefix, with_dtype(TIGERPrefixConfig(), "float32", dropout_rate=0.0)),
        ptr, tpp.loss_fn)
    corpus, items, users = dense_data
    dcfg0 = with_dtype(DenseT5Config(), "float32", dropout_rate=0.0)

    def dense_loss(model, batch, generator):
        p = next(model.parameters())
        tables = [torch.from_numpy(t).to(p.device, p.dtype) for t in (items, users)]
        return dtp.make_loss_fn(dcfg0, *tables)(model, batch, generator)

    dist["dense_t5"] = bf16_step_parity(
        "bf16-dense-t5-step", maker(DenseT5, dcfg0),
        build_dense_t5_arrays(corpus, dcfg0.max_seq_len, "train").arrays, dense_loss)

    # (e) one step, profiled, beside [train]'s f32 step (outside the counted path)
    trainer = tiger_pipeline.build_trainer(cfg, tr, te, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = trainer.gather(trainer.train_data, torch.arange(BATCH, device="cuda"))
    prof = profile_window(f"one bf16 train step (B={BATCH}, Lt=156, dropout 0.1)",
                          lambda: trainer.train_step(batch, gen), top_n=12)
    device = None if prof is None else prof[0] / 1e3
    print(f"[bf16] train step device ms: bf16 {device} against f32 {train['device_ms']} "
          f"([train]'s profiled step)")
    return dict(fwd=fwd, bwd=bwd, reduce=reduce, device_ms=device, recall10=recall,
                fwd_by_path={"train": train_counts[0], "serve": fwd - train_counts[0]},
                dist=dist, train_losses=res.train_losses)


REMAT_FLAGS = (("plain", {}), ("remat", dict(remat=True)),
               ("attn_remat_dropout", dict(attn_remat_dropout=True)),
               ("ffn_remat_dropout", dict(ffn_remat_dropout=True)),
               ("all three", dict(remat=True, attn_remat_dropout=True, ffn_remat_dropout=True)))


def phase_remat(tr):
    """``[remat]``: one train step of ``TIGERConfig()`` (f32) at B=256 and
    dropout 0.1 with each rematerialisation flag and with all three, against
    the plain step, every step from a CUDA generator of the same seed: loss
    and every gradient within 1e-6 (whether bit-equal is printed); each
    step's peak device memory above its start, after a reset (``remat`` and
    ``attn_remat_dropout`` must peak below the plain step), its device ms and
    its launches of #1 and #2 (block remat runs #1 again in the backward)."""
    import dataclasses

    from genrec_tpu_torch.configs import TIGERConfig
    from genrec_tpu_torch.models.tiger import TIGER
    from genrec_tpu_torch.ops import t5_attention as ta
    from genrec_tpu_torch.pipelines.tiger_pipeline import loss_fn

    base = TIGERConfig()
    assert base.arch.dropout_rate == 0.1, base.arch
    state = TIGER(base, generator=torch.Generator().manual_seed(3)).state_dict()
    batch = {k: torch.from_numpy(v[:BATCH]).cuda() for k, v in tr.arrays.items()}
    batch["valid"] = torch.ones(BATCH, dtype=torch.bool, device="cuda")
    out = {}
    for name, flags in REMAT_FLAGS:
        # block remat runs #1 again in the backward: 12 launches a step instead of 6
        want = (12 if flags.get("remat") else 6, 6)
        model = TIGER(dataclasses.replace(base, arch=dataclasses.replace(base.arch, **flags)))
        model.load_state_dict(state)
        model.to("cuda").train()

        def step(model=model):
            model.zero_grad(set_to_none=True)
            loss, _ = loss_fn(model, batch, torch.Generator(device="cuda").manual_seed(7))
            loss.backward()
            return loss

        step()  # warm-up
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ta.launches = ta.bwd_launches = 0
        loss = float(step())
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - start
        counts = (ta.launches, ta.bwd_launches)
        grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        ms = device_ms(step, 5)
        out[name] = dict(loss=loss, grads=grads, peak=peak, counts=counts, want=want,
                         device_ms=ms)
        del model
        torch.cuda.empty_cache()
    plain = out["plain"]
    for name, r in out.items():
        err = max((g - plain["grads"][k]).abs().max().item() for k, g in r["grads"].items())
        same = r["loss"] == plain["loss"] and all(
            torch.equal(g, plain["grads"][k]) for k, g in r["grads"].items())
        want = r["want"]
        r.update(grad_err=err, bit_equal=same)
        diff = abs(r["loss"] - plain["loss"])
        print(f"[remat] {name}: loss {r['loss']:.7f} (|diff| {diff:.2e}), "
              f"gradients max |diff| {err:.2e}, bit-equal to the plain step: {same}; peak "
              f"{r['peak'] / 2**20:.1f} MiB above the step's start; device "
              f"{r['device_ms']:.3f} ms a step; launches #1 {r['counts'][0]}, #2 "
              f"{r['counts'][1]} (want {want[0]}, {want[1]})")
        assert diff <= 1e-6 and err <= 1e-6, (name, r["loss"], err)
        assert r["counts"] == want, (name, r["counts"], want)
    for name in ("remat", "attn_remat_dropout"):
        assert out[name]["peak"] < plain["peak"], (name, out[name]["peak"], plain["peak"])
    return {k: dict(peak_mib=v["peak"] / 2**20, device_ms=v["device_ms"],
                    bit_equal=v["bit_equal"], grad_err=v["grad_err"]) for k, v in out.items()}


def profile_window(label, work, reps: int = 3, top_n: int = 6):
    """Device busy time against host wall time over ``reps`` calls of
    ``work`` (torch.profiler, after one warm-up), and the ``top_n`` device
    operations that take it. Returns the busy and wall microseconds per call,
    or None when the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    work()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            work()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, n_kernels = {}, 0
    for e in device_events(prof):
        n_kernels += 1
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    if not by_name:
        print(f"[profile] {label}: no device events recorded; busy share not measured")
        return None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    print(f"[profile] {label}: wall {wall_us / reps:.1f} us, device busy "
          f"{busy_us / reps:.1f} us ({100 * busy_us / wall_us:.1f}%), "
          f"{n_kernels / reps:.0f} device ops per call")
    for name, us in top:
        print(f"[profile]   {us / reps:9.1f} us/call  {name[:100]}")
    return busy_us / reps, wall_us / reps


def flash_records(flash, build, lc_serve, lc_train):
    """The JSON records of kernels #3-#6 (three CUDA kernels), timed at the
    long-context train shape (B·H 128, L 2048, D 16, causal); launches from
    the long-context serving and training paths. As in the T5 records,
    ``bound_ms`` counts the products at the 3xTF32 tensor-core rate (also
    under ``bound_tf32x3_ms``) and ``bound_ms_f32`` every operation at the
    f32 SIMT rate."""
    at_2048, at_4096 = flash["long_2048"], flash["long_4096"]
    runs = dict(zip(("train_2048", "train_4096", "train_dropout"), lc_train["counts"]))
    kernels = (  # name, result key, source, Pallas kernels replaced, index into the counts
        ("flash_attention_fwd", "fwd", "flash_attention_fwd.cu",
         "genrec_tpu/ops/attention.py:69 (_flash_kernel) and :117 (_flash_fwd_kernel_blocked)", 0),
        ("flash_attention_bwd_dq", "dq", "flash_attention_bwd.cu",
         "genrec_tpu/ops/attention.py:251 (_flash_bwd_dq_kernel) and :354 "
         "(_flash_bwd_dq_kernel_blocked)", 1),
        ("flash_attention_bwd_dkv", "dkv", "flash_attention_bwd.cu",
         "genrec_tpu/ops/attention.py:292 (_flash_bwd_dkv_kernel) and :391 "
         "(_flash_bwd_dkv_kernel_blocked)", 2))
    recs = []
    for name, key, src, replaces, i in kernels:
        by_path = {"serve": lc_serve["fwd"] if i == 0 else 0,
                   **{path: counts[i] for path, counts in runs.items()}}
        lib = "fwd_library" if key == "fwd" else "bwd_library"
        bounds = at_2048["bounds"][key]
        rec = {
            "name": name, "route": "cuda", "source": f"genrec_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r[f"{key}_err"] for r in flash.values()),
            "ms": at_2048[f"{key}_ms"], "plain_ms": at_2048[f"{key}_plain_ms"],
            "bound_ms": bounds["tf32x3"][0], "bound_by": bounds["tf32x3"][1],
            "bound_ms_f32": bounds["f32"][0], "bound_by_f32": bounds["f32"][1],
            "bound_tf32x3_ms": bounds["tf32x3"][0],
            "library_ms": at_2048[f"{lib}_ms"], "shape": "q/k/v (32*4, 2048, 16) f32, causal",
            "device_ms": at_2048[f"{key}_device_ms"],
            "plain_device_ms": at_2048[f"{key}_plain_device_ms"],
            "library_device_ms": at_2048[f"{lib}_device_ms"],
            "library_note": ("SDPA forward" if key == "fwd"
                             else "SDPA backward: dq, dk and dv in one call"),
            "ms_4096": at_4096[f"{key}_ms"], "device_ms_4096": at_4096[f"{key}_device_ms"],
            "bound_ms_4096": at_4096["bounds"][key]["tf32x3"][0],
            "bound_ms_f32_4096": at_4096["bounds"][key]["f32"][0]}
        if key in build:
            d16 = build[key][16]
            f64 = at_2048["fwd_f64_err" if key == "fwd" else "f64_err"]
            rec.update(smem_bytes_d16=d16["smem_bytes"], blocks_per_sm_d16=d16["blocks_per_sm"],
                       registers_d16=d16["registers"], local_bytes_d16=d16["local_bytes"],
                       f64_err_slice=f64["kernel"], plain_f64_err_slice=f64["plain_f32"])
        recs.append(rec)
    return recs


def bf16_records(fwd, bwd, regs, path):
    """The JSON records of kernels #1 and #2's bf16 entry points, timed at
    the TIGER encoder train shape without the dropout mask (#1, as the f32
    record's ``bench``) and the decoder self-attention with it (#2, as the
    f32 record); launches from the ``[bf16]`` path (those of the D = 64 and
    128 cases apart, ``launches_wide``). ``bound_ms`` counts the products at
    the bf16 tensor-core rate and q, k, v, out, do, dq, dk and dv at 2 bytes."""
    enc, dec, dec0 = fwd["enc_train_no_dropout"], bwd["dec_self_train"], bwd[
        "dec_self_train_no_dropout"]
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms", "library_device_ms",
            "max_abs_err")
    fwd_rec = {
        "name": "t5_attention_fwd_bf16", "route": "cuda",
        "source": "genrec_tpu_torch/csrc/t5_attention_fwd.cu",
        "replaces": "genrec_tpu/ops/t5_attention.py:115 (_fwd_kernel at a bf16 compute dtype)",
        "launches": path["fwd"], "launches_by_path": path["fwd_by_path"],
        "max_abs_err": max(r["max_abs_err"] for r in fwd.values()),
        "ms": enc["ms"], "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"],
        "library_ms": enc["library_ms"], "device_ms": enc["device_ms"],
        "library_device_ms": enc["library_device_ms"],
        "shape": "q/k/v (4*256, 80, 16) bf16, bias (4, 80, 80) f32, mask (256, 80)",
        "library_note": "SDPA forward in bf16 with the dense additive mask, scale 1, without "
                        "a dropout mask (no library call takes a given one)",
        "registers_d16": regs["t5_attention_fwd"][0],
        "local_bytes_d16": regs["t5_attention_fwd"][1], "launches_wide": regs["wide_launches"][0],
        **{f"{k}_{m}": r.get(m) for k, r in fwd.items() for m in keys + (
            "f64_err", "plain_f64_err", "smem_bytes", "blocks_per_sm")},
    }
    bwd_rec = {
        "name": "t5_attention_bwd_bf16", "route": "cuda",
        "source": "genrec_tpu_torch/csrc/t5_attention_bwd.cu",
        "replaces": "genrec_tpu/ops/t5_attention.py:129 (_bwd_kernel at a bf16 compute dtype)",
        "launches": path["bwd"], "launches_by_path": {"train": path["bwd"]},
        "max_abs_err": max(r["max_abs_err"] for r in bwd.values()),
        "max_rel_err": max(r["max_rel_err"] for r in bwd.values()),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"],
        "library_ms": dec0["library_ms"], "ms_no_dropout": dec0["ms"],
        "device_ms": dec["device_ms"], "library_device_ms": dec0["library_device_ms"],
        "shape": "decoder self-attention: q/k/v/do (4*256, 156, 16) bf16, bias (4, 156, 156) "
                 "f32 with the causal mask folded in, f32 dropout mask (1024, 156, 156); ms "
                 "includes the f32 dbias reduction",
        "library_note": "SDPA backward in bf16 at the same shape without the dropout mask, "
                        "beside ms_no_dropout",
        "registers_d16": regs["t5_attention_bwd"][0],
        "local_bytes_d16": regs["t5_attention_bwd"][1], "launches_wide": regs["wide_launches"][1],
        **{f"{k}_{m}": r.get(m) for k, r in bwd.items() for m in keys + (
            "max_rel_err", "smem_bytes", "blocks_per_sm")},
    }
    return [fwd_rec, bwd_rec]


def set_precision() -> None:
    """TF32 off, so f32 means f32, and a bf16 GEMM summing in f32, as XLA's
    does (the library leaves this to its caller)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the card only",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--tp-rank"]:
        return tp_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    sys.path.insert(0, HERE)
    set_precision()
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}; bf16 reduced-precision reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}; host CPU "
          f"{cpu_line()}")
    t_start = time.perf_counter()
    results, ptxas = phase_kernels()
    bwd = phase_bwd_kernels()
    reduce = phase_dbias_reduce()
    bf16_fwd, bf16_bwd, bf16_regs = phase_bf16_kernels()
    flash, flash_build = phase_flash()
    data = phase_data()
    tr, te, codes = train_corpus()
    phase_train_step_parity(tr)
    with tempfile.TemporaryDirectory() as tmp:
        launches, req_s, seqs_s = phase_serving(tmp)
        train = phase_train(tmp, tr, te, codes)
        len_buckets = phase_width_mode("len-buckets", "target_len_buckets", tmp, tr, te, train)
        bucket_fwd, bucket_bwd = phase_bucket_kernels()
        composite = phase_width_mode("composite", "target_len_composite", tmp, tr, te, train)
        dist_run = phase_dist(tmp, tr, te, train)
        tp_run = phase_tp(tmp, tr, te, train)
        prof_dir = phase_profile_dir(tmp, tr, te)
        rq_codes, rqvae = phase_rqvae(tmp)
        prefix_data = prefix_corpus(rq_codes)
        prefix = phase_tiger_prefix(tmp, *prefix_data)
        corpus, items, users = dense_corpus()
        dense = phase_dense_t5(tmp, corpus, items, users)
        bf16 = phase_bf16(tmp, tr, te, codes, train, prefix_data, (corpus, items, users))
        remat = phase_remat(tr)
        lc_serve = phase_sasrec_large_serve()
        phase_sasrec_large_train_parity()
        sas_data, sas_cfg = phase_sasrec(tmp)
        app = phase_app(tmp, codes, items, sas_data, sas_cfg)
        cli_run = phase_cli(tmp, codes)
        lc_train = phase_sasrec_large_train()
    assert launches > 0 and train["fwd"] > 0 and train["bwd"] > 0
    assert dist_run["tiger"]["fwd"] > 0 and dist_run["tiger"]["bwd"] > 0
    assert tp_run["fwd"] > 0 and tp_run["bwd"] > 0 and tp_run["reduce"] > 0
    assert prof_dir["fwd"] > 0 and prof_dir["bwd"] > 0 and prof_dir["reduce"] > 0
    for mode in (len_buckets, composite):
        assert mode["fwd"] > 0 and mode["bwd"] > 0 and mode["reduce"] > 0
    modes = {"len_buckets": len_buckets, "composite": composite}
    assert prefix["fwd"] > 0 and prefix["bwd"] > 0 and prefix["reduce"] > 0
    assert dense["fwd"] > 0 and dense["bwd"] > 0 and dense["reduce"] > 0
    assert bf16["fwd"] > 0 and bf16["bwd"] > 0 and bf16["reduce"] > 0
    app_fwd = app["tiger"]["launches"] + app["dense_t5"]["launches"]
    assert app_fwd > 0 and cli_run["fwd"] > 0
    assert lc_serve["fwd"] > 0 and all(n > 0 for n in lc_train["counts"][0])
    assert all(n > 0 for n in lc_train["counts"][1])
    bench = results["bench"]
    d16 = [v for k, v in ptxas.items() if "ILi2E" in k]  # the D = 16 build: ND = 2 steps
    fwd_record = {
        "name": "t5_attention_fwd", "route": "cuda",
        "source": "genrec_tpu_torch/csrc/t5_attention_fwd.cu",
        "replaces": "genrec_tpu/ops/t5_attention.py:115",
        "launches": (launches + train["fwd"] + prefix["fwd"] + dense["fwd"] + app_fwd
                     + cli_run["fwd"] + dist_run["tiger"]["fwd"] + tp_run["fwd"]
                     + prof_dir["fwd"] + len_buckets["fwd"] + composite["fwd"]),
        "launches_by_path": {"serve": launches, "train": train["fwd"],
                             **{k: m["fwd"] for k, m in modes.items()},
                             "dist": dist_run["tiger"]["fwd"], "tp": tp_run["fwd"],
                             "profile_dir": prof_dir["fwd"],
                             "tiger_prefix": prefix["fwd"],
                             **{f"dense_t5_{k}": n for k, n in dense["fwd_by_path"].items()},
                             "app": app_fwd, "cli": cli_run["fwd"]},
        "max_abs_err": max(r["max_abs_err"] for r in results.values()),
        "ms": bench["ms"], "plain_ms": bench["plain_ms"], "bound_ms": bench["bound_ms"],
        "bound_by": bench["bound_by"], "bound_ms_f32": bench["bound_ms_f32"],
        "library_ms": bench["library_ms"],
        "shape": "q/k/v (4*256, 80, 16) f32, bias (4, 80, 80), mask (256, 80)",
        "library_note": "SDPA forward with the dense additive mask, scale 1, without a dropout "
                        "mask (no library call takes a given one); bound_ms counts the products "
                        "at the 3xTF32 tensor-core rate, bound_ms_f32 every operation at the f32 "
                        "SIMT rate",
        "device_ms": bench["device_ms"], "library_device_ms": bench["library_device_ms"],
        "serve_ms": results["serve"]["ms"], "serve_device_ms": results["serve"]["device_ms"],
        "serve_bound_ms": results["serve"]["bound_ms"],
        "registers_d16": d16[0][0] if d16 else None,
        "spill_bytes_d16": d16[0][1] + d16[0][2] if d16 else None,
        **{f"{k}_{m}": results[k][m] for k in FWD_TRAIN
           for m in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_ms_f32", "smem_bytes",
                     "blocks_per_sm", "f64_err", "plain_f64_err")},
        **{f"{k}_no_dropout_{m}": results[f"{k}_no_dropout"][m] for k in FWD_TRAIN
           for m in ("ms", "device_ms", "bound_ms", "bound_ms_f32", "library_ms",
                     "library_device_ms")},
        **{f"{k}_{m}": results[k][m] for k in PREFIX_SHAPES
           for m in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_ms_f32", "max_abs_err")},
        **{f"{k}_no_dropout_{m}": results[f"{k}_no_dropout"][m] for k in PREFIX_SHAPES
           for m in ("ms", "device_ms", "bound_ms", "library_ms", "library_device_ms")},
        "prefix_shapes": "prefix_enc: q/k/v (8*256, 83, 16), bias (8, 83, 83), mask (256, 83) "
                         "with 3 prefix ones; prefix_cross: q (8*256, 156, 16), k/v (8*256, 83, "
                         "16), mask (256, 83); f32 dropout mask unless _no_dropout",
        **{f"{k}_{m}": results[k][m] for k in DENSE_SHAPES
           for m in ("ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms", "bound_ms_f32",
                     "max_abs_err", "library_ms", "library_device_ms")},
        **{f"dense_train_no_dropout_{m}": results["dense_train_no_dropout"][m]
           for m in ("ms", "device_ms", "bound_ms", "library_ms", "library_device_ms")},
        "dense_shapes": "dense_train: q/k/v (4*256, 21, 16), bias (4, 21, 21), right-padded "
                        "mask (256, 21), f32 dropout mask at rate 0.3 (none in _no_dropout); "
                        "dense_serve: q/k/v (4*1, 21, 16), no dropout mask",
        **{f"{k}_{m}": bucket_fwd[k][m] for k in BUCKET_SHAPES
           for m in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_ms_f32", "max_abs_err")},
        **{f"{k}_no_dropout_{m}": bucket_fwd[f"{k}_no_dropout"][m] for k in BUCKET_SHAPES
           for m in ("ms", "device_ms", "bound_ms", "library_ms", "library_device_ms")},
        "bucket_shapes": "dec_self_44/120: q/k/v (4*256, 44 or 120, 16), bias with the causal "
                         "mask folded in; cross_44/120: q (4*256, 44 or 120, 16), k/v (4*256, "
                         "80, 16), mask (256, 80); f32 dropout mask unless _no_dropout",
    }
    dec, dec0 = bwd["dec_self_train"], bwd["dec_self_train_no_dropout"]
    bwd_record = {
        "name": "t5_attention_bwd", "route": "cuda",
        "source": "genrec_tpu_torch/csrc/t5_attention_bwd.cu",
        "replaces": "genrec_tpu/ops/t5_attention.py:129",
        "launches": (train["bwd"] + prefix["bwd"] + dense["bwd"] + dist_run["tiger"]["bwd"]
                     + tp_run["bwd"] + prof_dir["bwd"] + len_buckets["bwd"] + composite["bwd"]),
        "launches_by_path": {"serve": 0, "train": train["bwd"], "tiger_prefix": prefix["bwd"],
                             **{k: m["bwd"] for k, m in modes.items()},
                             "dense_t5_train": dense["bwd"], "app": 0, "cli": 0,
                             "dist": dist_run["tiger"]["bwd"], "tp": tp_run["bwd"],
                             "profile_dir": prof_dir["bwd"]},
        "max_abs_err": max(r["max_abs_err"] for r in bwd.values()),
        "max_rel_err": max(r["max_rel_err"] for r in bwd.values()),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"], "bound_ms_f32": dec["bound_ms_f32"],
        "library_ms": dec0["library_ms"], "ms_no_dropout": dec0["ms"],
        "shape": "decoder self-attention: q/k/v/do (4*256, 156, 16) f32, bias (4, 156, 156) "
                 "with the causal mask folded in, f32 dropout mask (1024, 156, 156); ms "
                 "includes the dbias reduction",
        "library_note": "SDPA backward at the same shape without the dropout mask "
                        "(no library call takes a given one), beside ms_no_dropout; "
                        "bound_ms counts the products at the 3xTF32 tensor-core rate, "
                        "bound_ms_f32 every operation at the f32 SIMT rate",
        "device_ms": dec["device_ms"], "device_ms_no_dropout": dec0["device_ms"],
        "library_device_ms": dec0["library_device_ms"],
        "smem_bytes": dec["smem_bytes"], "blocks_per_sm": dec["blocks_per_sm"],
        "dbias_reduce_launches": train["reduce"], "dbias_reduce_ms": reduce["ms"],
        "dbias_reduce_device_ms": reduce["device_ms"],
        **{f"{k}_{m}": bwd[k][m] for k in ("enc_train", "cross_train")
           for m in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_ms_f32", "blocks_per_sm")},
        **{f"{k}_no_dropout_{m}": bwd[f"{k}_no_dropout"][m] for k in ("enc_train", "cross_train")
           for m in ("ms", "device_ms", "library_ms", "library_device_ms")},
        **{f"{k}_{m}": bwd[k][m] for k in PREFIX_SHAPES
           for m in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_ms_f32", "max_rel_err")},
        **{f"{k}_no_dropout_{m}": bwd[f"{k}_no_dropout"][m] for k in PREFIX_SHAPES
           for m in ("ms", "device_ms", "bound_ms", "library_ms", "library_device_ms")},
        "dbias_reduce_launches_by_path": {"train": train["reduce"],
                                          **{k: m["reduce"] for k, m in modes.items()},
                                          "tiger_prefix": prefix["reduce"],
                                          "dense_t5_train": dense["reduce"],
                                          "dist": dist_run["tiger"]["reduce"],
                                          "tp": tp_run["reduce"],
                                          "profile_dir": prof_dir["reduce"]},
        **{f"dense_train_{m}": bwd["dense_train"][m]
           for m in ("ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms", "bound_ms_f32",
                     "max_rel_err", "smem_bytes", "blocks_per_sm")},
        **{f"dense_train_no_dropout_{m}": bwd["dense_train_no_dropout"][m]
           for m in ("ms", "device_ms", "bound_ms", "library_ms", "library_device_ms")},
        **{f"{k}_{m}": bucket_bwd[k][m] for k in BUCKET_SHAPES
           for m in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_ms_f32", "max_rel_err")},
        **{f"{k}_no_dropout_{m}": bucket_bwd[f"{k}_no_dropout"][m] for k in BUCKET_SHAPES
           for m in ("ms", "device_ms", "bound_ms", "library_ms", "library_device_ms")},
    }
    reduce_record = {
        "name": "t5_attention_dbias_reduce", "route": "cuda",
        "source": "genrec_tpu_torch/csrc/t5_attention_bwd.cu",
        "replaces": "genrec_tpu/ops/t5_attention.py:157 (the dbias sum of _bwd_kernel)",
        "launches": (train["reduce"] + prefix["reduce"] + dense["reduce"]
                     + dist_run["tiger"]["reduce"] + tp_run["reduce"] + prof_dir["reduce"]
                     + len_buckets["reduce"] + composite["reduce"]),
        "launches_by_path": {"serve": 0, "train": train["reduce"],
                             **{k: m["reduce"] for k, m in modes.items()},
                             "tiger_prefix": prefix["reduce"], "dense_t5_train": dense["reduce"],
                             "app": 0, "cli": 0, "dist": dist_run["tiger"]["reduce"],
                             "tp": tp_run["reduce"], "profile_dir": prof_dir["reduce"]},
        "max_abs_err": reduce["max_abs_err"], "ms": reduce["ms"], "plain_ms": reduce["plain_ms"],
        "bound_ms": reduce["bound_ms"], "bound_by": reduce["bound_by"],
        "library_ms": reduce["library_ms"], "device_ms": reduce["device_ms"],
        "shape": "scratch (4, 256, 156, 156) f32 -> dbias (4, 156, 156)",
        "library_note": "one sum over dim 1 (another summation order)",
    }
    print(f"[summary] TIGER: {req_s:.2f} requests/s, {seqs_s:.1f} seqs/s, "
          f"{train['examples_s']:.1f} train examples/s, {train['ms_step']:.2f} ms/train step, "
          f"train step device busy share {train['busy']}; long-context SASRec: "
          f"{lc_serve['req_s']:.2f} requests/s, {lc_serve['batch_s']:.1f} histories/s at "
          f"B={LC_B}, {lc_train['ms_step']:.2f} ms/train step at B={LC_B}, "
          f"{lc_train['examples_s']:.1f} examples/s, busy share {lc_train['busy']}; RQ-VAE: "
          f"{rqvae['ms_step']:.2f} ms/train step at B=64, busy share {rqvae['busy']}, infer "
          f"{rqvae['infer_s']:.2f} s, "
          f"{rqvae['rounds']} repair rounds, collision rate before the 4th digit "
          f"{rqvae['rate']:.4f}; TIGER-prefix: {prefix['examples_s']:.1f} train examples/s, "
          f"{prefix['ms_step']:.2f} ms/train step, device {prefix['device_ms']} ms/step, busy "
          f"share {prefix['busy']}, Recall@10 {prefix['metrics']['Recall@10']:.4f}; DenseT5: "
          f"{dense['examples_s']:.1f} train examples/s, {dense['ms_step']:.2f} ms/train step, "
          f"device {dense['device_ms']} ms/step, busy share {dense['busy']}, "
          f"{dense['req_s']:.2f} requests/s, Recall@10 {dense['metrics']['Recall@10']:.4f}; "
          + "; ".join(f"app {k}: {v['http_req_s']:.2f} requests/s over HTTP against "
                      f"{v['direct_req_s']:.2f} direct, HTTP minus direct p10/p50/p90 "
                      f"{_fmt(v['gap_ms_p10_50_90'])} ms, device {v['device_ms']} ms a request, "
                      f"busy share {v['busy']}" for k, v in app.items())
          + f"; cli serve up in {cli_run['up_s']:.1f} s"
          + "; dist: SASRecLargeConfig() step " + ", ".join(
              f"{k} {dist_run[k]['runs']['psum'][1]:.2f} ms host, peak "
              f"{dist_run[k]['peak_gib']:.2f} GiB" for k in ("float32", "bfloat16"))
          + f", phase {dist_run['seconds']:.1f} s"
          + f"; tp: phase {tp_run['seconds']:.1f} s, step device ms per rank "
          + ", ".join("not measured" if p is None else f"{p[0] / 1e3:.3f}"
                      for p in tp_run["prof"])
          + f"; bf16 TIGER: train step device {bf16['device_ms']} ms against f32 "
          f"{train['device_ms']} ms, Recall@10 {bf16['recall10']:.4f}; remat peak MiB / device "
          "ms: " + ", ".join(f"{k} {v['peak_mib']:.1f} / {v['device_ms']:.3f}"
                             for k, v in remat.items())
          + "; " + "; ".join(
              f"{k}: {m['examples_s']:.1f} train examples/s against flat "
              f"{train['examples_s']:.1f}, {m['steps']} steps in {MODE_EPOCHS} epochs, step "
              f"device ms by width {m['step_ms']}" for k, m in modes.items())
          + f"; native packer g++ {data['build_s']} s, "
          + ", ".join(f"{k} {'native' if n else 'Python'} {v:.4f} s"
                      for (k, n), v in data["seconds"].items())
          + f"; script {time.perf_counter() - t_start:.1f} s")
    kernels = [fwd_record, bwd_record, reduce_record,
               *bf16_records(bf16_fwd, bf16_bwd, bf16_regs, bf16)] + flash_records(
                   flash, flash_build, lc_serve, lc_train)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
