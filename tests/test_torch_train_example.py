"""``examples/torch_train_small.py`` on the CPU, in a child process.

The example trains reduced stablelm-3b on the synthetic stream, asserts
the loss falls below 0.7x its first value (as the JAX example does),
and restores its checkpoint bit for bit.  20 steps here (the example's
200 run on the card in ``chip_smoke.py``): the loss falls by more than
30 % within the first 20 (to 0.33x its first value on the CPU).  The
child takes one intra-op thread: under xdist, with several workers
sharing a few cores, torch's default of one thread a core slows its
backward passes ~100x.
"""

import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_torch_train_small_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_train_small.py"), "20",
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout
    first, last = map(float, re.search(r"final: (\S+) -> (\S+) ",
                                       out).groups())
    assert last < 0.7 * first and "on cpu" in out
    assert "restored step=20" in out and "bit-identical" in out
