"""Model operations of every token a row processed in the window (those
it generated, and the prompt of a request admitted inside it), attention
at its cache position (flops.decode_flops), over the window's time and the
card's bf16 peak, in %."""

import flops
import peaks


def read(ctx):
    run = ctx["run"]
    if not len(run.get("positions", ())):
        return None
    dm = ctx["dims"]
    base = flops.decode_flops(dm, 0)
    per_key = flops.decode_flops(dm, 1) - base
    pos = run["positions"]
    ops = len(pos) * base + per_key * float(pos.sum())
    return 100.0 * ops / (run["window_s"] * peaks.BF16_FLOPS)
