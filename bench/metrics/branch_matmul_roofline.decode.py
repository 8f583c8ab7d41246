"""Least time of the window's expert GEMMs at decode
(flops.grouped_gemm_s: every row of the batch routes k pairs each
decode step, through every MoE layer's three GEMMs) over the device
time of the kernels named below, in %.  The steps are the engine's
``engine.fused_iterations`` counter over the window; a prefill chunk
that a request admitted inside the window runs is not among them."""

import flops
import devtrace

KERNELS = ("branch_matmul",)


def read(ctx):
    run, dm = ctx["run"], ctx["dims"]
    if "positions" not in run or ctx["trace"] is None:
        return None
    n = flops.n_layers(dm, channel="moe")
    took = devtrace.kernel_seconds(ctx["trace"], KERNELS)
    calls = run["decode_steps"]
    if not n or not calls or took <= 0:
        return None
    least = calls * n * flops.grouped_gemm_s(dm, run["experts_rows"] * dm.k)
    return 100.0 * least / took
