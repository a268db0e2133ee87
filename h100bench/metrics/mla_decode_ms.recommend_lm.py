"""MLA latent attention: host ms a batch in the program's span mla.decode (the absorbed attention over the latent cache at each decode step), traced stretch."""

from h100bench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "lm.prefill", "mla.decode")
