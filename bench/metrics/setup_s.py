"""Seconds from the start of the process to the window: imports, the
card, kernel builds, weights, warm-up (and, in a batch job, the job's
prefill)."""


def read(ctx):
    return ctx["setup_s"]
