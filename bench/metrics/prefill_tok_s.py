"""Prompt tokens of every document whose ``prefill_fn`` call ended in
the window, over the window's time (host clock)."""


def read(ctx):
    run = ctx["run"]
    if not run.get("docs"):
        return None
    return sum(d["length"] for d in run["docs"]) / run["window_s"]
