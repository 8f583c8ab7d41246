"""Least time of the window's SSD scans (flops.ssd_scan_s, one a Mamba
layer a document) over the device time of the kernels named below, in
%."""

import flops
import devtrace

KERNELS = ("ssd_scan_",)


def read(ctx):
    run, dm = ctx["run"], ctx["dims"]
    if not run.get("docs") or ctx["trace"] is None:
        return None
    n = flops.n_layers(dm, mixer="mamba")
    took = devtrace.kernel_seconds(ctx["trace"], KERNELS)
    if not n or took <= 0:
        return None
    least = sum(n * flops.ssd_scan_s(dm, d["length"]) for d in run["docs"])
    return 100.0 * least / took
