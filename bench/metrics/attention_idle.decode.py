"""Idle device time in gaps that open inside one of the program's
``attn`` spans (norm1, attention, residual), over the traced window, in
%.  None where the program records no such span."""


def read(ctx):
    trace = ctx["trace"]
    names = {name for name, _, _ in ctx["run"].get("spans") or ()}
    if trace is None or "attn" not in names:
        return None
    idle = trace["idle"].get("attn", (0, 0.0))[1]
    return 100.0 * idle / trace["window_s"]
