"""The benchmark's lookup by name, its environment and its checks.

Everything a cell needs is found by the names in ``BENCHMARK.json``:

* a configuration ``<name>`` is ``configs/<name>.json`` (the file the
  manifest's entry names);
* a traffic mix ``<name>`` is ``traffic/<name>.json``: parameters,
  whose ``driver`` key names the code that generates the requests from
  the seed and drives one entry point, ``drivers/<driver>.py`` (what a
  driver provides: :mod:`driving`);
* a per-layer metric ``<name>`` is ``metrics/<name>.py``, a reader with
  ``read(ctx) -> float | None``;
* the limits of ``correct`` in a cell ``<name>`` are
  ``limits/<name>.json``.

So a later change adds a configuration, a mix of a kind the benchmark
drives already (a data file), a new kind of traffic (a driver), or a
metric by adding files and manifest entries, never by editing one of
these modules.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent

#: top-level module names that may never be loaded by a run: JAX and the
#: JAX package the port was made from (``repro_torch`` is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def checkout_root(bench: Path = BENCH) -> Path:
    return bench.parent


def setup_environment(root: Path) -> None:
    """Fixed cache directories inside the checkout, so only a cell's first
    run there builds; nothing under a fixed path outside it."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def load_manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(root: Path, workload: str) -> dict:
    """The cell ``workload`` with its configuration, traffic, driver,
    limits and metrics resolved: ``{"workload", "config", "traffic",
    "driver", "limits", "end_to_end", "per_layer"}``; a metric with no
    ``workloads`` key applies to every cell that reports what it
    moves."""
    m = load_manifest(root)
    w = find(m["workloads"], workload, "workload")
    c = find(m["configs"], w["config"], "configuration")
    config = json.loads((root / c["file"]).read_text())
    traffic_path = root / "bench" / "traffic" / f"{w['traffic']}.json"
    traffic = json.loads(traffic_path.read_text())

    def applies(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    e2e = [x for x in m["end_to_end"] if applies(x)]
    names = {x["name"] for x in e2e}
    per_layer = [x for x in m["per_layer"]
                 if x["moves"] in names and applies(x)]
    limits = json.loads((root / "bench" / "limits" / f"{workload}.json")
                        .read_text())
    return {"workload": w, "config": config, "traffic": traffic,
            "driver": load_driver(root, traffic["driver"]),
            "limits": limits, "end_to_end": e2e, "per_layer": per_layer}


def _load(path: Path, prefix: str):
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(root: Path, name: str):
    """The reader module ``bench/metrics/<name>.py``."""
    return _load(root / "bench" / "metrics" / f"{name}.py", "bench_metric_")


def load_driver(root: Path, name: str):
    """The traffic driver ``bench/drivers/<name>.py``."""
    return _load(root / "bench" / "drivers" / f"{name}.py", "bench_driver_")


def read_metrics(root: Path, metrics: list, ctx: dict) -> dict:
    """``{name: {"value", "unit"}}`` for every metric whose reader found
    something to read; a reader returning None is left out."""
    out = {}
    for m in metrics:
        value = load_metric(root, m["name"]).read(ctx)
        if value is None:
            continue
        value = float(value)
        if not math.isfinite(value):
            raise ValueError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> "list[str]":
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def checks(numbers: dict, limits: dict) -> dict:
    """Each limited number beside its limit; a number the run could not
    read (no answer of its kind in the window) is None."""
    return {k: {"value": numbers.get(k), "limit": limits[k]}
            for k in limits}


def within(check: dict) -> bool:
    return check["value"] is not None and check["value"] <= check["limit"]


def checks_text(checks: dict) -> "list[str]":
    return [f"{name}: {c['value']!r} limit {c['limit']!r} "
            f"({'ok' if within(c) else 'OVER'})"
            for name, c in checks.items()]
