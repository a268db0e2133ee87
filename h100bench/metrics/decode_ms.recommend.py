"""Generate and beam search: host ms a batch in the spans beam.decode (each step's decoder call), traced stretch."""

from h100bench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, program_spans.RECOMMEND_UNIT, "beam.decode")
