"""Recommend dispatch: host ms a batch in the span generate.encode (the encoder and the cross K/V), traced stretch."""

from h100bench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, program_spans.RECOMMEND_UNIT, "generate.encode")
