#!/usr/bin/env python3
"""Chip smoke of the PyTorch / CUDA port (``genrec_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``genrec_tpu``. Phases, each of
which asserts; any failure exits non-zero and prints no result:

1. require a CUDA device; print the card's name and power limit;
2. build every kernel of the paths from ``genrec_tpu_torch/csrc`` (one nvcc
   per source, all together, sm_90a);
3. hold each kernel against its plain PyTorch version on the card and time
   the kernel, the plain version and one PyTorch library call of the same
   function (CUDA events, and the profiler's device time): the forward at the
   serving shapes and small edge cases within 1e-5 max abs (f32, another
   summation order); the backward at the three train shapes of
   ``TIGERConfig()`` at batch 256 and edge cases within 1e-4·max|plain| +
   1e-5 (dbias sums by atomics in an order that changes between runs);
4. one train step of ``TIGERConfig()`` at B=16 and dropout 0 on the card
   against the same step on the CPU in f64 (see ``phase_train_step_parity``):
   loss within 1e-5, every gradient within the backward's bound;
5. drive the serving path: a TIGER at ``TIGERConfig()`` widths with seeded
   random weights, saved and served by ``tiger_model_fn`` on the card, a few
   requests, then one batched trie-constrained ``generate`` at B=256 and 20
   beams, compared on its first rows with the same call on the CPU;
6. drive the training path at full width: ``tiger_pipeline.train`` for 3
   epochs at batch 256 (dropout 0.1) on a 4096-user synthetic corpus, a
   resume to a 4th epoch, ``evaluate``; then one profiled train step.
   Kernel launch counts are set to 0 just before each of the paths 5 and 6
   and read just after, and must equal what the path ran;
7. print one JSON line of kernel records, the card line, and last the
   ``{"ok": true, "device": ...}`` line.

TF32 is off for matmuls and cuDNN throughout, so f32 means f32.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5          # kernel vs plain version, max abs, f32
BWD_REL = 1e-4      # backward: max abs <= BWD_REL * max|plain| + TOL (f32, other
                    # summation orders, dbias by atomics in a varying order)
GEN_TOL = 1e-4      # batched generate scores, card vs CPU
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
N_ITEMS = 700
TOP_K = 10
BATCH = 256
BEAMS = 20
TRAIN_USERS = 4096
TRAIN_EPOCHS = 3
STEP_B = 16


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    per call; this is the card's."""
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
    raise AssertionError("the profiler recorded no device time in 3 tries")


def attention_case(name, h, b, lq, lk, d, *, causal=False, bias=True, pad=True,
                   fully_masked=False, dropout=False, seed=0):
    """Inputs of one kernel case, made from a seed with numpy, on the card."""
    r = np.random.default_rng(seed)
    dev = "cuda"
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    args = dict(qf=t(r.normal(size=(h * b, lq, d))), kf=t(r.normal(size=(h * b, lk, d))),
                vf=t(r.normal(size=(h * b, lk, d))), h=h, pos_bias=None, kv_mask=None,
                causal=causal, dropout_mask=None)
    if bias:
        args["pos_bias"] = t(r.normal(size=(h, lq, lk)))
    if pad:  # left padding, as the serving path pads histories
        valid = r.integers(1, lk + 1, size=b)
        mask = (np.arange(lk)[None, :] >= lk - valid[:, None]).astype(np.int32)
        if fully_masked:
            mask[0] = 0
        args["kv_mask"] = torch.from_numpy(mask).to(dev)
    if dropout:
        keep = r.random((h * b, lq, lk)) > 0.1
        args["dropout_mask"] = t(np.where(keep, 1.0 / 0.9, 0.0))
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
    return (qf.view(h, b, lq, d), kf.view(h, b, lk, d), vf.view(h, b, lk, d), add)


def attention_bound_ms(a) -> tuple:
    """Least time on the card for the kernel's work: each input read once and
    the output written once at the HBM rate, against the f32 operations
    (2·D for q·k and 2·D for p·v per score, plus 7 for bias, mask, max,
    subtract, exp, sum and divide) at the f32 rate outside the tensor cores."""
    qf, kf, vf = a["qf"], a["kf"], a["vf"]
    hb, lq, d = qf.shape
    lk = kf.shape[1]
    nbytes = sum(x.numel() * x.element_size() for x in (qf, kf, vf, qf))  # out = q's size
    for key in ("pos_bias", "kv_mask", "dropout_mask"):
        if a[key] is not None:
            nbytes += a[key].numel() * 4  # the mask goes to the kernel as int32
    ops = hb * lq * lk * (4 * d + 7 + (1 if a["dropout_mask"] is not None else 0))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels():
    from genrec_tpu_torch.ops import _build
    from genrec_tpu_torch.ops import t5_attention as ta

    t0 = time.perf_counter()
    _build.build_all(["t5_attention_fwd", "t5_attention_bwd"])  # one nvcc each, together
    ta.load_kernel()
    ta.load_bwd_kernel()
    print(f"[build] t5_attention_fwd and t5_attention_bwd built and loaded in "
          f"{time.perf_counter() - t0:.3f} s")
    for name, (secs, log) in _build.build_log.items():
        print(f"[build] {name}: nvcc {secs:.3f} s\n{log.strip()}")

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
    ]
    results = {}
    for name, a in cases:
        kw = dict(causal=a["causal"], dropout_mask=a["dropout_mask"])
        args = (a["qf"], a["kf"], a["vf"], a["h"], a["pos_bias"], a["kv_mask"])
        rate = 0.1 if a["dropout_mask"] is not None else 0.0
        out = ta.fused_t5_attention_flat(*args, dropout_rate=rate, **kw)
        ref = ta.t5_attention_reference(*args, **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all(), f"{name}: non-finite kernel output"
        err = (out - ref).abs().max().item()
        assert err <= TOL, f"{name}: kernel vs plain max abs {err} > {TOL}"
        iters = 200 if name in ("serve", "bench") else 20
        kernel = lambda: ta.fused_t5_attention_flat(*args, dropout_rate=rate, **kw)  # noqa: E731
        plain = lambda: ta.t5_attention_reference(*args, **kw)  # noqa: E731
        fns = [kernel, plain]
        if a["dropout_mask"] is None:  # no library call takes a given dropout mask
            q4, k4, v4, add = sdpa_inputs(a)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            fns.append(lambda: sdpa(q4, k4, v4, attn_mask=add, scale=1.0))
        ms, plain_ms, library_ms = [cuda_ms(f, iters) for f in fns] + [None] * (3 - len(fns))
        dev = [device_ms(f) for f in fns] + [None] * (3 - len(fns))
        bound_ms, bound_by = attention_bound_ms(a)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms, device_ms=dev[0],
                             plain_device_ms=dev[1], library_device_ms=dev[2])
        print(f"[kernel] t5_attention_fwd {name} shape={tuple(a['qf'].shape)} "
              f"lk={a['kf'].shape[1]} max_abs_err={err:.3e} | per call (CUDA events): "
              f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms} | device only "
              f"(profiler): ms={dev[0]:.5f} plain_ms={dev[1]:.5f} library_ms={dev[2]} | "
              f"bound_ms={bound_ms:.6f} ({bound_by})")
    return results


def bwd_case(name, h, b, lq, lk, d, *, causal=False, bias=True, pad=True, causal_in_bias=False,
             fully_masked=False, dropout=True, seed=0):
    """Inputs of one backward case (the forward's inputs plus an output
    gradient), on the card. ``causal_in_bias`` folds the causal −1e9 into the
    bias, as the decoder passes it."""
    name, a = attention_case(name, h, b, lq, lk, d, causal=causal, bias=bias, pad=pad,
                             fully_masked=fully_masked, dropout=dropout, seed=seed)
    r = np.random.default_rng(seed + 1000)
    a["do"] = torch.from_numpy(r.normal(size=(h * b, lq, d)).astype(np.float32)).cuda()
    if causal_in_bias:
        row = torch.arange(lq, device="cuda")[:, None]
        col = torch.arange(lk, device="cuda")[None, :]
        a["pos_bias"] = (a["pos_bias"] + torch.where(col > row, -1e9, 0.0)).contiguous()
    return name, a


def bwd_bound_ms(a) -> tuple:
    """Least time on the card for the backward's work: q, k, v, do, the bias,
    the key mask (int32) and the dropout mask read once, dq, dk, dv and dbias
    written once, at the HBM rate; against the f32 operations per score at
    the f32 rate outside the tensor cores: 10·D for the five products
    (q·k and do·v recomputed, ds·k, dsᵀ·q, (p·dm)ᵀ·do), 7 for the softmax
    recompute (as the forward), 4 for ds = p·(dp − Σ dp·p), 2 more with a
    dropout mask (dp·dm, p·dm) and 1 for the dbias sum."""
    qf, kf = a["qf"], a["kf"]
    hb, lq, d = qf.shape
    lk = kf.shape[1]
    nbytes = 2 * sum(x.numel() * 4 for x in (a["qf"], a["kf"], a["vf"]))  # in and grad out
    nbytes += a["do"].numel() * 4
    for key in ("kv_mask", "dropout_mask"):
        if a[key] is not None:
            nbytes += a[key].numel() * 4
    per_score = 10 * d + 7 + 4
    if a["pos_bias"] is not None:
        nbytes += 2 * a["pos_bias"].numel() * 4  # bias in, dbias out
        per_score += 1
    if a["dropout_mask"] is not None:
        per_score += 2
    ops = hb * lq * lk * per_score
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
    bias = bias[:, None].detach().clone().requires_grad_(True)
    add = bias
    if a["causal"]:
        row = torch.arange(lq, device="cuda")[:, None]
        col = torch.arange(lk, device="cuda")[None, :]
        add = add + torch.where(col > row + (lk - lq), -1e9, 0.0)
    if a["kv_mask"] is not None:
        add = add + ((1.0 - a["kv_mask"].float()) * -1e9)[None, :, None, :]
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


def phase_bwd_kernels():
    """Kernel #2 against its plain version on the card, at the three train
    shapes of TIGERConfig() at batch 256 and at edge cases; times and bound."""
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
        bwd_case("lq!=lk_causal", 2, 3, 12, 10, 8, causal=True, dropout=False, seed=14),
        bwd_case("dropout_mask", 2, 3, 12, 10, 8, seed=15),
        bwd_case("fully_masked_rows", 2, 3, 12, 10, 8, fully_masked=True, seed=16),
        bwd_case("b1_causal_156", 4, 1, 156, 156, 16, causal=True, pad=False, seed=17),
        bwd_case("smem_over_48KB_no_bias", 1, 2, 64, 200, 16, bias=False, seed=18),
    ]
    results = {}
    for name, a in cases:
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
        iters = 20
        ms, plain_ms, library_ms = [cuda_ms(f, iters) for f in fns] + [None] * (3 - len(fns))
        dev = [device_ms(f, 10) for f in fns] + [None] * (3 - len(fns))
        bound_ms, bound_by = bwd_bound_ms(a)
        results[name] = dict(max_rel_err=rel, max_abs_err=max(abs_errs), ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms, device_ms=dev[0],
                             plain_device_ms=dev[1], library_device_ms=dev[2])
        print(f"[kernel] t5_attention_bwd {name} q={tuple(a['qf'].shape)} "
              f"lk={a['kf'].shape[1]} dropout={a['dropout_mask'] is not None} "
              f"max_err/max|ref|={rel:.3e} | per call (CUDA events): ms={ms:.5f} "
              f"plain_ms={plain_ms:.5f} library_ms={library_ms} | device only (profiler): "
              f"ms={dev[0]:.5f} plain_ms={dev[1]:.5f} library_ms={dev[2]} | "
              f"bound_ms={bound_ms:.6f} ({bound_by}) | library: {lib_note}")
    return results


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
    ta.launches = ta.bwd_launches = 0
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
    launches, bwd_launches = ta.launches, ta.bwd_launches
    # ---- end of the main path ----
    assert bwd_launches == 0, bwd_launches  # serving runs no backward
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
    the wrapper's f32-only check: they compute in f64 for f64 inputs."""

    @staticmethod
    def forward(ctx, qf, kf, vf, pos_bias, kv_mask, dmask, h, causal):
        from genrec_tpu_torch.ops import t5_attention as ta

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
        return (*grads, None, None, None, None)


def phase_train_step_parity(tr):
    """One train step of ``TIGERConfig()`` (ReLU feed-forward) at B=16 and
    dropout 0: loss and every gradient on the card (both kernels) against the
    same step on the CPU in f64 (the plain versions in f64).

    The witness is f64 because ReLU's kink makes an f32 gradient
    discontinuous: two f32 runs that round one pre-activation near 0 to
    opposite signs differ by that token's whole contribution. The f32 CPU
    step is run as well and its distance from the f64 step printed, not
    held to the bound."""
    import copy
    import dataclasses

    from genrec_tpu_torch.configs import TIGERConfig
    from genrec_tpu_torch.models.tiger import TIGER
    from genrec_tpu_torch.ops import t5_attention as ta
    from genrec_tpu_torch.pipelines.tiger_pipeline import loss_fn

    base = TIGERConfig()
    cfg = dataclasses.replace(base, arch=dataclasses.replace(base.arch, dropout_rate=0.0))
    cpu = TIGER(cfg, generator=torch.Generator().manual_seed(1)).train()
    rows = np.arange(STEP_B)
    out = {}
    for name, dev, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                             ("cpu_f64", "cpu", torch.float64)):
        model = copy.deepcopy(cpu).to(dev, dtype)
        batch = {k: torch.from_numpy(v[rows]).to(dev) for k, v in tr.arrays.items()}
        batch["valid"] = torch.ones(STEP_B, dtype=torch.bool, device=dev)
        fused = ta._FusedT5Attention
        if dtype == torch.float64:
            ta._FusedT5Attention = _PlainAttention
        try:
            loss, _ = loss_fn(model, batch, None)
            loss.backward()
        finally:
            ta._FusedT5Attention = fused
        out[name] = (float(loss.detach()),
                     {k: p.grad.double().cpu() for k, p in model.named_parameters()})
    loss_ref, ref = out["cpu_f64"]
    loss_err = abs(out["card"][0] - loss_ref)
    assert loss_err <= TOL, f"train step loss card vs f64 CPU {loss_err} > {TOL}"
    worst = {}
    for name in ("card", "cpu"):
        worst[name] = (0.0, "")
        for k, g_ref in ref.items():
            err, scale = (out[name][1][k] - g_ref).abs().max().item(), g_ref.abs().max().item()
            if name == "card":
                assert err <= BWD_REL * scale + TOL, (
                    f"{k}: grad card vs f64 CPU {err} (max {scale})")
            worst[name] = max(worst[name], (err / (scale + 1e-30), k))
    print(f"[train-step] B={STEP_B} Lt=156 dropout 0 ReLU: loss card {out['card'][0]:.7f}, "
          f"CPU f32 {out['cpu'][0]:.7f}, CPU f64 {loss_ref:.7f} (card |diff| {loss_err:.2e}); "
          f"{len(ref)} gradients against the f64 step, worst max_err/max|f64|: card "
          f"{worst['card'][0]:.2e} ({worst['card'][1]}), CPU f32 {worst['cpu'][0]:.2e} "
          f"({worst['cpu'][1]}; printed, not held)")


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
    ta.launches = ta.bwd_launches = 0
    art = tiger_pipeline.train(cfg, tr, te, device="cuda")
    res = art.result
    cfg2 = dataclasses.replace(cfg, trainer=dataclasses.replace(
        cfg.trainer, epochs=TRAIN_EPOCHS + 1, resume=True))
    art2 = tiger_pipeline.train(cfg2, tr, te, device="cuda")
    metrics = tiger_pipeline.evaluate(cfg2, art2, te, codes, device="cuda")
    torch.cuda.synchronize()
    fwd, bwd = ta.launches, ta.bwd_launches
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
          f"batches = {want_fwd}), t5_attention_bwd {bwd} (want 6 x {steps} = {6 * steps})")
    assert fwd == want_fwd and bwd == 6 * steps, (fwd, bwd)

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
    return dict(fwd=fwd, bwd=bwd, examples_s=res.steady_examples_per_sec, ms_step=ms_step,
                busy=busy)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    t_start = time.perf_counter()
    results = phase_kernels()
    bwd = phase_bwd_kernels()
    tr, te, codes = train_corpus()
    phase_train_step_parity(tr)
    with tempfile.TemporaryDirectory() as tmp:
        launches, req_s, seqs_s = phase_serving(tmp)
        train = phase_train(tmp, tr, te, codes)
    assert launches > 0 and train["fwd"] > 0 and train["bwd"] > 0
    bench = results["bench"]
    fwd_record = {
        "name": "t5_attention_fwd", "route": "cuda",
        "source": "genrec_tpu_torch/csrc/t5_attention_fwd.cu",
        "replaces": "genrec_tpu/ops/t5_attention.py:115",
        "launches": launches + train["fwd"],
        "launches_by_path": {"serve": launches, "train": train["fwd"]},
        "max_abs_err": max(r["max_abs_err"] for r in results.values()),
        "ms": bench["ms"], "plain_ms": bench["plain_ms"], "bound_ms": bench["bound_ms"],
        "bound_by": bench["bound_by"], "library_ms": bench["library_ms"],
        "shape": "q/k/v (4*256, 80, 16) f32, bias (4, 80, 80), mask (256, 80)",
        "device_ms": bench["device_ms"],
        "serve_ms": results["serve"]["ms"], "serve_device_ms": results["serve"]["device_ms"],
        "serve_bound_ms": results["serve"]["bound_ms"],
    }
    dec, dec0 = bwd["dec_self_train"], bwd["dec_self_train_no_dropout"]
    bwd_record = {
        "name": "t5_attention_bwd", "route": "cuda",
        "source": "genrec_tpu_torch/csrc/t5_attention_bwd.cu",
        "replaces": "genrec_tpu/ops/t5_attention.py:129",
        "launches": train["bwd"], "launches_by_path": {"serve": 0, "train": train["bwd"]},
        "max_abs_err": max(r["max_abs_err"] for r in bwd.values()),
        "max_rel_err": max(r["max_rel_err"] for r in bwd.values()),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"], "library_ms": dec0["library_ms"],
        "shape": "decoder self-attention: q/k/v/do (4*256, 156, 16) f32, bias (4, 156, 156) "
                 "with the causal mask folded in, f32 dropout mask (1024, 156, 156)",
        "library_note": "SDPA backward at the same shape without the dropout mask "
                        "(no library call takes a given one); the kernel there: "
                        f"{dec0['ms']:.5f} ms",
        "device_ms": dec["device_ms"],
        **{f"{k}_{m}": bwd[k][m] for k in ("enc_train", "cross_train")
           for m in ("ms", "device_ms", "plain_ms", "bound_ms")},
        **{f"{k}_no_dropout_library_ms": bwd[f"{k}_no_dropout"]["library_ms"]
           for k in ("enc_train", "cross_train")},
    }
    print(f"[summary] {req_s:.2f} requests/s, {seqs_s:.1f} seqs/s, "
          f"{train['examples_s']:.1f} train examples/s, {train['ms_step']:.2f} ms/train step, "
          f"train step device busy share {train['busy']}, "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [fwd_record, bwd_record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
