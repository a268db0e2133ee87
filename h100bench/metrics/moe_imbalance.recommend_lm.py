"""MoE experts: the busiest expert's rows over the mean expert's, summed over the layer-passes of the traced stretch (the program's counters moe.busiest and moe.rows); 1 is even; nothing where the program keeps no such counters."""

from h100bench import program_spans


def read(ctx):
    reg = program_spans.registry(ctx)
    if not reg or not reg.get("moe.rows", {}).get("count") or "moe.busiest" not in reg:
        return None
    mean = reg["moe.rows"]["count"] / ctx["cell"].config["n_routed_experts"]
    return reg["moe.busiest"]["count"] / mean
