"""Trainer streamed route: host ms a step in the span train.upload (all of _put: the wait on the slot's last copy, the pinned fill, the copies' enqueue), traced stretch."""

from h100bench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, program_spans.TRAIN_UNIT, "train.upload")
