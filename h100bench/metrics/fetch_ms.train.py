"""Trainer streamed route: host ms a step in the span train.fetch (the factory's next batch: its gather), traced stretch."""

from h100bench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, program_spans.TRAIN_UNIT, "train.fetch")
