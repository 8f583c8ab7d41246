"""``examples/torch_parallax_analysis.py`` on the CPU against
``examples/parallax_analysis.py``, each in a child process.

Both plan dbrx-132b's reduced DAG with the full config's FLOP metadata.
Sections (a)-(d) must agree line for line: the first ten regions'
verdicts and the region counts, the branch-layer structure and balanced
group widths, the arena counts and sizes, and the schedule under the
three budgets.  The port adds one line naming its device.
"""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout.splitlines()


def _sections(lines):
    """Section title -> its lines."""
    out, title = {}, None
    for line in lines:
        if line.startswith("== ("):
            title = line
            out[title] = []
        elif title is not None and line.strip():
            out[title].append(line)
    return out


def test_torch_parallax_analysis_matches_jax_example():
    pytest.importorskip("jax")
    port = _run([os.path.join("examples", "torch_parallax_analysis.py"),
                 "--device", "cpu"])
    ref = _run([os.path.join("examples", "parallax_analysis.py")])
    assert port[0] == "device: cpu"
    got, want = _sections(port), _sections(ref)
    assert [t[:6] for t in got] == ["== (a)", "== (b)", "== (c)", "== (d)"]
    assert got == want
    assert sum(line.startswith("  budget") for line in got[list(got)[3]]) \
        == 3
