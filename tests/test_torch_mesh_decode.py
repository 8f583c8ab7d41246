"""The port's decode step over DTensor caches on a one-rank mesh.

Reduced stablelm-3b and whisper-tiny (fp32) take one decode step with
their params and caches as DTensors (``param_pspecs``,
``launch.dryrun.cache_pspecs``) under ``set_mesh``, against the same
step off the mesh, in a child process (a process holds one default
process group):

* on the CPU (gloo) the step goes through ``attention.decode_on_shards``
  (one call a decoder layer, two a Whisper layer: self and cross), whose
  plain merge agrees with the off-mesh step within fp32 1e-5;
* on the card (NCCL) each of those calls launches the
  ``decode_attention`` kernel once, counted by the kernel's own counter,
  and the step agrees with the off-mesh one within fp32 1e-5.

This file imports no JAX, so the card's machine collects it.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PER_LAYER = {"stablelm-3b": 1, "whisper-tiny": 2}


def _run(device):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_dist_child.py"),
         "mesh_decode", device], capture_output=True, text=True,
        timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_mesh_decode_matches_off_mesh():
    for arch, r in _run("cpu").items():
        assert r["mesh_calls"] == PER_LAYER[arch] * r["layers"], arch
        assert r["launches"] == 0, arch
        assert r["err"] <= 1e-5, (arch, r["err"])


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="the decode_attention kernel needs a CUDA card")
def test_mesh_decode_launches_the_kernel_on_the_card():
    for arch, r in _run("cuda").items():
        n = PER_LAYER[arch] * r["layers"]
        assert r["mesh_calls"] == n and r["launches"] == n, (arch, r)
        assert r["err"] <= 1e-5, (arch, r["err"])
