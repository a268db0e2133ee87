"""Generate and beam search: host ms a batch in the span beam.search (all of beam_search), traced stretch."""

from h100bench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, program_spans.RECOMMEND_UNIT, "beam.search")
