"""The 90th percentile, over every document of the window, of the time
from the ``prefill_fn`` call to its logits on the host (host clock,
synchronised by the copy)."""

import numpy as np


def read(ctx):
    run = ctx["run"]
    if not run.get("docs"):
        return None
    return 1000.0 * float(np.percentile(
        [d["ttft_s"] for d in run["docs"]], 90))
