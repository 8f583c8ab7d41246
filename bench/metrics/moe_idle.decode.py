"""Idle device time in gaps that open inside one of the program's MoE
spans (``moe.route``, ``moe.dispatch``, ``moe.experts``,
``moe.combine``) or its capacity readback (``sync.moe_capacity``), over
the traced window, in %.  None where the program records no such span."""


def _moe(name):
    return name.startswith("moe.") or name == "sync.moe_capacity"


def read(ctx):
    trace = ctx["trace"]
    names = {name for name, _, _ in ctx["run"].get("spans") or ()}
    if trace is None or not any(_moe(n) for n in names):
        return None
    idle = sum(s for label, (_, s) in trace["idle"].items() if _moe(label))
    return 100.0 * idle / trace["window_s"]
