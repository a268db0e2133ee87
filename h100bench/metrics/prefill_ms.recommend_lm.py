"""LM prefill: host ms a batch in the program's span lm.prefill (the prompt's pass and its latent cache written), traced stretch."""

from h100bench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "lm.prefill", "lm.prefill")
