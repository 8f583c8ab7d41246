"""Share of the traced window in which no device operation ran
(torch.profiler's CUDA events), in %."""


def read(ctx):
    if ctx["trace"] is None:
        return None
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
