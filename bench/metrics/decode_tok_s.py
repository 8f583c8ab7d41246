"""Every token generated in the window, over the window's time (host
clock)."""


def read(ctx):
    run = ctx["run"]
    if "tokens" not in run:
        return None
    return run["tokens"] / run["window_s"]
