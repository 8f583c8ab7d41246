"""The engine's dispatch counter (``engine.dispatches`` of
``engine.stats()``) over the window, per generated token."""


def read(ctx):
    run = ctx["run"]
    if not run.get("tokens") or "dispatches" not in run:
        return None
    return run["dispatches"] / run["tokens"]
