"""Least time of the window's paged decode attentions
(flops.paged_decode_s: each token a row processed in the window reads
its row's valid keys and values once, in every attention layer) over
the device time of the kernels named below, in %.  The sum over tokens
equals the sum over launches: at H / K query heads a key head, the
least time is the bytes' in every launch."""

import flops
import devtrace

KERNELS = ("paged_decode",)


def read(ctx):
    run, dm = ctx["run"], ctx["dims"]
    if "positions" not in run or ctx["trace"] is None:
        return None
    n = flops.n_layers(dm, mixer="attn")
    took = devtrace.kernel_seconds(ctx["trace"], KERNELS)
    if not n or took <= 0:
        return None
    least = n * flops.paged_decode_s(dm, run["positions"])
    return 100.0 * least / took
