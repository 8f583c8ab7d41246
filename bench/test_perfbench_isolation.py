"""Nothing the benchmark runs loads JAX or the JAX package, and its
reference loads nothing of the port: each checked in a fresh process,
top-level module names compared whole."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

_PROBE = """
import importlib, json, sys
sys.path[:0] = [{bench!r}, {src!r}]
for name in {mods!r}:
    importlib.import_module(name)
import importlib.util, pathlib
for folder in ("metrics", "drivers"):
    for path in sorted(pathlib.Path({bench!r}, folder).glob({glob!r})):
        name = "m_" + path.stem.replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

RUN_MODULES = ["run", "harness", "driving", "stack", "devtrace", "flops",
               "peaks", "calibrate", "reference.model", "reference.compare",
               "repro_torch.models", "repro_torch.runtime.engine",
               "repro_torch.runtime.config", "repro_torch.runtime.telemetry",
               "torch.profiler"]
REFERENCE_MODULES = ["reference.model", "reference.compare", "stack",
                     "flops", "peaks"]


def _tops(mods, files=True):
    """Top-level names loaded by importing ``mods`` (and every metric
    reader and traffic driver) in a fresh interpreter."""
    code = _PROBE.format(bench=str(BENCH), src=str(ROOT / "src"), mods=mods,
                         glob="*.py" if files else "no-such-file")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    tops = _tops(RUN_MODULES)
    assert "repro_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops


def test_reference_loads_nothing_of_the_port():
    tops = _tops(REFERENCE_MODULES, files=False)
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, tops


def test_forbidden_names_compared_whole():
    import harness

    sys.modules.setdefault("repro_torch_probe_only", sys)
    assert "repro_torch_probe_only" not in harness.forbidden_modules()
    assert set(harness.forbidden_modules()) <= set(harness.FORBIDDEN)


def test_no_card_no_result():
    """Without a card the run exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "dbrx-batch-decode", "--seed", str(2 ** 31 + 1),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == "", out
