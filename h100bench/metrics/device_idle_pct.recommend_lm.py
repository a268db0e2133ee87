"""Device: share of the traced stretch of LM recommendation with no operation on the card, %."""

from h100bench import readings


def read(ctx):
    return readings.idle_pct(ctx)
