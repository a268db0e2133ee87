"""Trainer dispatch: host ms a step in the span train.optimizer (zero_grad and the Adam update), traced stretch."""

from h100bench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, program_spans.TRAIN_UNIT, "train.optimizer")
