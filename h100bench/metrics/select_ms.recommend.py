"""Generate and beam search: host ms a batch in the spans beam.select (each step's log-softmax, masks, sort and gathers), traced stretch."""

from h100bench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, program_spans.RECOMMEND_UNIT, "beam.select")
