"""Trainer dispatch: host ms a step in put and step together (step: train_step's enqueue of forward, backward and update)."""

from h100bench import readings


def read(ctx):
    return readings.span_ms(ctx, "put", "step")
