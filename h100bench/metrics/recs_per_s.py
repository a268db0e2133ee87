"""End to end: students whose top lists reached host memory in the window over its wall time."""

from h100bench import readings


def read(ctx):
    return readings.per_second(ctx, "students")
