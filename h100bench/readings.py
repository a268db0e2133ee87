"""Arithmetic the metric readers (``metrics/<name>.py``) share. Each takes
the run's context: ``window`` (what the window ran, its seconds, its model
FLOPs), ``spans`` (host seconds of each span in the window), ``trace`` (the
profiled stretch's reading, or None), ``cell`` and ``setup_s``. A reading
that finds nothing to read gives None."""

from __future__ import annotations

from typing import Optional

from h100bench import counts


def per_second(ctx, key: str) -> Optional[float]:
    w = ctx["window"]
    return w[key] / w["seconds"] if key in w and w["seconds"] > 0 else None


def span_ms(ctx, *names: str) -> Optional[float]:
    """Mean host milliseconds a step or batch spent in ``names``, together."""
    spans = ctx["spans"]
    if not all(spans.get(n) for n in names):
        return None
    return 1e3 * sum(sum(spans[n]) for n in names) / len(spans[names[0]])


def device_ms(ctx) -> Optional[float]:
    """Device busy milliseconds a step or batch over the traced stretch."""
    tr = ctx["trace"]
    return None if tr is None else 1e3 * tr["busy_s"] / tr["steps"]


def idle_pct(ctx) -> Optional[float]:
    tr = ctx["trace"]
    return None if tr is None else 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu(ctx) -> Optional[float]:
    """Model FLOPs of the window over its wall time, as a share of the
    card's float32 peak."""
    rate = per_second(ctx, "flops")
    return None if rate is None else 100.0 * rate / counts.F32_FLOPS


def t5_roofline(ctx, backward: bool) -> Optional[float]:
    """Summed least time of the fused T5 attention's launches in the traced
    stretch over their summed device time (kernels named ``t5_attention``),
    when the program's launch counters show exactly the launches the cell's
    shapes call for."""
    tr = ctx["trace"]
    if tr is None or "launches" not in tr:
        return None
    cfg, t = ctx["cell"].config, ctx["cell"].traffic
    enc = cfg["max_len"] * cfg["code_dim"] + (3 if cfg["model"] == "tiger_prefix" else 0)
    if backward:
        sites = counts.attention_sites(cfg, t["batch"], enc, (t["max_items"] - 2) * cfg["code_dim"],
                                       dropout=cfg["arch"]["dropout_rate"] > 0)
        want = [len(sites), len(sites), sum(s["pos_bias"] for s in sites)]
        bound = sum(counts.attention_bound_s(s, False) + counts.attention_bound_s(s, True)
                    for s in sites)
    else:
        sites = counts.attention_sites(cfg, t["batch"], enc, 0, dropout=False, decoder=False)
        want = [len(sites), 0, 0]
        bound = sum(counts.attention_bound_s(s, False) for s in sites)
    if list(tr["launches"]) != [w * tr["steps"] for w in want]:
        return None
    spent = sum(v for k, v in tr["ops"].items() if "t5_attention" in k)
    return 100.0 * bound * tr["steps"] / spent if spent > 0 else None
