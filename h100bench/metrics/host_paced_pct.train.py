"""Device: share of train.forward entries at which the card had finished all queued work, so waited on the host, %; traced stretch (the profiler slows the host)."""

from h100bench import program_spans


def read(ctx):
    return program_spans.drained_pct(ctx, program_spans.TRAIN_UNIT)
