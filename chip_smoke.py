#!/usr/bin/env python3
"""Chip smoke of the PyTorch / CUDA port (``genrec_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``genrec_tpu``. Phases, each of
which asserts; any failure exits non-zero and prints no result:

1. require a CUDA device; print the card's name and power limit;
2. build every kernel of the path from ``genrec_tpu_torch/csrc`` (nvcc, sm_90a);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it and at small edge cases, within 1e-5 max
   abs (f32, another summation order); time the kernel, the plain version and
   one PyTorch library call of the same function (CUDA events);
4. drive the serving path: a TIGER at ``TIGERConfig()`` widths with seeded
   random weights, saved and served by ``tiger_model_fn`` on the card, a few
   requests, then one batched trie-constrained ``generate`` at B=256 and 20
   beams, compared on its first rows with the same call on the CPU. Kernel
   launch counts are set to 0 just before this phase and read just after;
5. print one JSON line of kernel records, the card line, and last the
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
GEN_TOL = 1e-4      # batched generate scores, card vs CPU
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
N_ITEMS = 700
TOP_K = 10
BATCH = 256
BEAMS = 20


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn``: the durations of the device operations it
    ran, from torch.profiler, without the host's gaps between launches. At
    small shapes the CUDA-event time of back-to-back calls is the host's time
    per call; this is the card's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    assert us > 0, "the profiler recorded no device time"
    return us / iters / 1e3


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
    ta.load_kernel()
    print(f"[build] t5_attention_fwd built and loaded in {time.perf_counter() - t0:.3f} s")
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
    ta.launches = 0
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
    launches = ta.launches
    # ---- end of the main path ----
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


def profile_window(label, work, reps: int = 3):
    """Device busy time against host wall time over ``reps`` calls of
    ``work`` (torch.profiler, after one warm-up), and the kernels that take it."""
    from torch.autograd import DeviceType
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
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    if not by_name:
        print(f"[profile] {label}: no device events recorded; busy share not measured")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"[profile] {label}: wall {wall_us / reps:.1f} us, device busy "
          f"{busy_us / reps:.1f} us ({100 * busy_us / wall_us:.1f}%), "
          f"{n_kernels / reps:.0f} device ops per call")
    for name, us in top:
        print(f"[profile]   {us / reps:9.1f} us/call  {name[:100]}")


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
    with tempfile.TemporaryDirectory() as tmp:
        launches, req_s, seqs_s = phase_serving(tmp)
    bench = results["bench"]
    record = {
        "name": "t5_attention_fwd", "route": "cuda",
        "source": "genrec_tpu_torch/csrc/t5_attention_fwd.cu",
        "replaces": "genrec_tpu/ops/t5_attention.py:115",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in results.values()),
        "ms": bench["ms"], "plain_ms": bench["plain_ms"], "bound_ms": bench["bound_ms"],
        "bound_by": bench["bound_by"], "library_ms": bench["library_ms"],
        "shape": "q/k/v (4*256, 80, 16) f32, bias (4, 80, 80), mask (256, 80)",
        "device_ms": bench["device_ms"],
        "serve_ms": results["serve"]["ms"], "serve_device_ms": results["serve"]["device_ms"],
        "serve_bound_ms": results["serve"]["bound_ms"],
    }
    print(f"[summary] {req_s:.2f} requests/s, {seqs_s:.1f} seqs/s, "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
