"""Generate and beam search: share of the decoder's self-attention key positions read from its K/V cache, % (the program's counters beam.decode.cached over beam.decode.keys), traced stretch; nothing where the program keeps no such counters."""

from h100bench import program_spans


def read(ctx):
    reg = program_spans.registry(ctx)
    if not reg or not reg.get("beam.decode.keys", {}).get("count") \
            or "beam.decode.cached" not in reg:
        return None
    return 100.0 * reg["beam.decode.cached"]["count"] / reg["beam.decode.keys"]["count"]
