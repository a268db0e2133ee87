"""Kernels: the grouped-expert GEMMs' summed least time (counts_lm) over their summed device time in the traced stretch, %; read only when the trace holds one launch per MoE layer, pass and projection."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or "expert_launches" not in tr or not tr["expert_s"]:
        return None
    if tr["expert_launches"] != tr["expert_launches_want"]:
        return None
    return 100.0 * tr["expert_bound_s"] / tr["expert_s"]
