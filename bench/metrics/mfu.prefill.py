"""Model operations of the window's documents (flops.prefill_flops) over
the window's time and the card's bf16 peak, in %."""

import flops
import peaks


def read(ctx):
    run = ctx["run"]
    if not run.get("docs"):
        return None
    ops = sum(flops.prefill_flops(ctx["dims"], d["length"])
              for d in run["docs"])
    return 100.0 * ops / (run["window_s"] * peaks.BF16_FLOPS)
