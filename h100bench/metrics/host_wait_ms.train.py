"""Trainer dispatch: host ms a step in the program's waits on the card (spans named *.wait, nested in the others), traced stretch."""

from h100bench import program_spans


def read(ctx):
    return program_spans.wait_ms(ctx, program_spans.TRAIN_UNIT)
