"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic mix,
traffic driver, limits and metrics are found by name from
``BENCHMARK.json`` (:mod:`harness`).  The
run builds the port's model with weights drawn on the card from the
seed, warms every shape of the cell's traffic, measures for ``--seconds``
(under the profiler with ``--trace 1``), then frees the program and
holds what the window produced against the plain fp32 reference
(:mod:`reference`).  It prints each compared number beside its limit as
the last lines of standard error, and one JSON object as the last line
of standard output: with ``--trace 0`` the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, the device's busy and window
seconds and the trace's breakdown.

Without a card (or with fewer than the cell asks for), or when JAX or
the JAX package was loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from contextlib import contextmanager  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import harness  # noqa: E402


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device,
             look: bool = False) -> "tuple[dict, list[str], dict]":
    """One run of ``workload`` on ``device``; returns the result object,
    the lines that show each compared number beside its limit, and the
    driver's record (with ``look``, also each compared answer, the
    reference's router margins there and the reference's logits, under
    ``"look"``)."""
    import torch

    import devtrace
    import driving
    import stack
    from reference import compare

    c = harness.cell(root, workload)
    run_cfg, traffic, driver = c["config"]["run"], c["traffic"], c["driver"]
    dm = stack.Dims(run_cfg)
    device = torch.device(device)
    on_card = device.type == "cuda"
    api, params = driving.build(run_cfg, seed, device)
    tracer = devtrace.Traced(on_card) if trace else None
    spans = driving.Spans(trace)
    window = tracer.window if trace else devtrace.untraced
    marks = {}

    @contextmanager
    def timed_window():
        """The driver's window, noting when set-up ended."""
        with window() as w:
            marks["setup_end"] = time.perf_counter()
            yield w

    record = driver.run(api, params, dm, traffic, seed, seconds, spans,
                        timed_window)
    setup_s = marks["setup_end"] - T_START
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del api, params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    summary = None
    if trace:
        summary = devtrace.summarize(
            tracer.events, tracer.start_ns, tracer.end_ns,
            spans.events + record.get("spans", []))
    margins = [] if look else None
    ref = compare.reference_logits(run_cfg, seed, record, driver, device,
                                   margins=margins)
    per = driver.items(record, ref)
    checks = harness.checks(driver.summary(record, per), c["limits"])
    if look:
        record["look"] = (per, margins, ref)
    else:
        del ref
    correct = record["failed"] == 0 and all(
        harness.within(v) for v in checks.values())
    ctx = {"run": record, "dims": dm, "trace": summary, "setup_s": setup_s}
    metrics = harness.read_metrics(
        root, c["per_layer"] if trace else c["end_to_end"], ctx)
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card
           else device.type,
           "count": int(c["workload"]["chips"]),
           "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    result = {"correct": correct, "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics,
              "device": dev}
    if summary is not None:
        result["breakdown"] = devtrace.breakdown(summary)
    result["checks"] = checks             # last: each number, its limit
    lines = [f"{workload} seed {seed}: {record['attempted']} attempted, "
             f"{record['failed']} failed, window "
             f"{record['window_s']!r} s, setup {setup_s!r} s"]
    lines[0] += record.get("about", "")
    lines += harness.checks_text(checks)
    return result, lines, record


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = harness.checkout_root()
    harness.setup_environment(root)
    cell = harness.cell(root, args.workload)
    chips = int(cell["workload"]["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}; peaks used: bf16 989.4e12 FLOP/s, "
          f"fp32 67e12 FLOP/s, HBM 3.35e12 B/s", file=sys.stderr)
    result, lines, _ = run_cell(root, args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda")
    found = harness.forbidden_modules()
    if found:
        print(f"no result: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 4
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
