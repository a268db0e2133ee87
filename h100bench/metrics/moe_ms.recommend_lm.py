"""MoE experts: host ms a batch in the program's spans moe.route, moe.experts and moe.combine, over the prefill and the decode steps, traced stretch."""

from h100bench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "lm.prefill", "moe.route", "moe.experts", "moe.combine")
