"""Least time of the window's routed expert GEMMs (flops.grouped_gemm_s:
each document's S·k routed rows through every MoE layer's three
GEMMs) over the device time of the kernels named below, in %."""

import flops
import devtrace

KERNELS = ("branch_matmul",)


def read(ctx):
    run, dm = ctx["run"], ctx["dims"]
    if not run.get("docs") or ctx["trace"] is None:
        return None
    n = flops.n_layers(dm, channel="moe")
    took = devtrace.kernel_seconds(ctx["trace"], KERNELS)
    if not n or took <= 0:
        return None
    least = sum(n * flops.grouped_gemm_s(dm, d["length"] * dm.k)
                for d in run["docs"])
    return 100.0 * least / took
