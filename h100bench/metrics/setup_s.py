"""End to end: seconds from process start to the first timed step or batch: imports, data, weights, kernel build or load, warm-up."""


def read(ctx):
    return ctx["setup_s"]
