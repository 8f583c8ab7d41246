"""``examples/torch_serve_requests.py`` on the CPU against
``examples/serve_requests.py``, each in a child process.

The JAX example serves h2o-danube-3-4b (reduced) from
``jax.random.key(0)``; the test writes those weights as an npz checkpoint
and the port's example serves them (``--ckpt``).  Equal in the two
outputs: the per-request peak and the budget (§3.3's
``request_peak_bytes``), the number of requests served, each request's
token count, the peak cache bytes and the slab reuses.  The first six
tokens of each stream are equal, or where they part, the two tokens'
logits at that step (the port's ``prefill_fn`` on the prompt and the
common prefix) lie within the repository's fp32 tolerance of each other:
a near tie that two summation orders break apart.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "h2o-danube-3-4b"
FP32 = 2e-5


def _run(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def _report(out):
    """(summary lines, {request: (n tokens, first six)})."""
    keep = [line for line in out.splitlines() if line.startswith(
        ("arch=", "peak cache")) or re.match(r"\d+/9 requests", line)]
    summary = [re.sub(r" in \S+s$", "", line) for line in keep]
    reqs = {int(m[1]): (int(m[2]), [int(t) for t in m[3].split(",")])
            for m in re.finditer(r"req (\d+): (\d+) tokens, first 6 = "
                                 r"\[([^\]]*)\]", out)}
    return summary, reqs


def test_torch_serve_requests_matches_jax_example(tmp_path):
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro.training.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training.checkpoint import load_checkpoint

    japi = jax_build_model(jax_get_config(ARCH).reduced())
    save_checkpoint(tmp_path, japi.init(jax.random.key(0)))
    port = _run([os.path.join("examples", "torch_serve_requests.py"),
                 "--device", "cpu", "--ckpt", str(tmp_path)])
    ref = _run([os.path.join("examples", "serve_requests.py")])
    assert "device: cpu" in port
    assert "memory-budget admission held" in port
    got, got_reqs = _report(port)
    want, want_reqs = _report(ref)
    assert len(got) == 3 and got == want
    assert sorted(got_reqs) == sorted(want_reqs) == list(range(9))

    cfg = get_config(ARCH).reduced()
    api = build_model(cfg, device="cpu")
    params = load_checkpoint(tmp_path, cfg, api.init(None))[0]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 16) for _ in range(9)]
    for rid, (n, toks) in got_reqs.items():
        n_ref, ref_toks = want_reqs[rid]
        assert n == n_ref == 32, rid
        if toks == ref_toks:
            continue
        step = next(i for i, (a, b) in enumerate(zip(toks, ref_toks))
                    if a != b)
        seq = np.concatenate([prompts[rid], toks[:step]])[None]
        with torch.no_grad():
            logits = api.prefill_fn(params, {
                "tokens": torch.tensor(seq, dtype=torch.int32)})[0]
        a, b = logits[toks[step]].item(), logits[ref_toks[step]].item()
        assert abs(a - b) <= FP32 * (1 + abs(a)), (rid, step, a, b)
