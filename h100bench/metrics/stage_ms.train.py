"""Trainer streamed route: host ms a step in the span train.upload.stage (the pinned fill), traced stretch."""

from h100bench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, program_spans.TRAIN_UNIT, "train.upload.stage")
