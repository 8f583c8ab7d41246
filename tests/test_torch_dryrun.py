"""The port's dry-run (``repro_torch.launch.dryrun``) on reduced configs.

One child process runs ``run_case`` for every (arch x shape) on a 2x2
fake mesh, plus prefill and decode under ``--opt``; a JAX child (four
host devices) lowers and compiles JAX's ``plan_entry`` for the same
``--opt`` cases.  The two run side by side.  Checked:

* every record's keys, and its status: ``ok``, or ``skipped`` exactly
  for JAX's ``LONG_SKIP``;
* ``argument_size_bytes`` against an independent count from the specs
  (parameters, optimizer state, batch and caches, each leaf's local
  shard);
* under ``--opt`` (both sides cast every floating leaf to bf16, O1) the
  prefill and decode argument bytes against XLA's
  ``argument_size_in_bytes``.  XLA drops the inputs a step never reads
  (Whisper's decode reads no encoder weight, Mamba2's decode no
  ``cache_len``): the JAX child finds them by dead-code elimination of
  the step's jaxpr, and the test subtracts them.  The port's Whisper
  caches hold ``cross_pos`` / ``cross_len`` beside JAX's, which the test
  adds.  Train differs by design (the port stores weights in the model
  dtype beside fp32 masters), so it is held to the count only.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
#: the --opt cases held to XLA's argument bytes
JAX_ARCHS = ("dbrx-132b", "jamba-v0.1-52b", "mamba2-370m", "stablelm-3b",
             "whisper-tiny")
MESH = {"data": 2, "model": 2}
KEYS = {"arch", "shape", "mesh", "variant", "status", "lower_s",
        "compile_s", "chips", "memory_analysis", "cost_analysis",
        "flops_accounting", "collective_bytes", "collective_counts",
        "roofline", "per_device_gb"}


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    cases = [f"{a}:{s}" for a in sorted(ARCHS) for s in SHAPES]
    cases += [f"{a}:{s}:opt" for a in sorted(ARCHS)
              for s in ("prefill_32k", "decode_32k")]
    jcases = [f"{a}:{s}" for a in JAX_ARCHS
              for s in ("prefill_32k", "decode_32k")]
    port = subprocess.Popen(
        [sys.executable, str(TESTS / "torch_dist_child.py"), "dryrun",
         str(d / "port.json")] + cases, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    jax = subprocess.Popen(
        [sys.executable, str(TESTS / "jax_dist_child.py"), "args",
         str(d / "jax.json")] + jcases,
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for p in (port, jax):
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-3000:]
    recs = json.loads((d / "port.json").read_text())
    by = {(r["arch"], r["shape"], "opt" in r["variant"]): r for r in recs}
    return by, json.loads((d / "jax.json").read_text())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_records(runs, arch):
    from repro_torch.launch.dryrun import LONG_SKIP
    by, _ = runs
    for shape in SHAPES:
        rec = by[(arch, shape, False)]
        if shape == "long_500k" and arch in LONG_SKIP:
            assert rec["status"] == "skipped"
            assert rec["reason"] == LONG_SKIP[arch]
            continue
        assert rec["status"] == "ok", rec.get("traceback")
        assert KEYS <= set(rec), KEYS - set(rec)
        assert rec["mesh"] == "pod2x2" and rec["chips"] == 4
        assert rec["flops_accounting"] == "counted"
        assert rec["compile_s"] == 0.0
        mem = rec["memory_analysis"]
        assert set(mem) == {"argument_size_bytes", "output_size_bytes",
                            "temp_size_bytes"}
        assert mem["argument_size_bytes"] > 0 and mem["temp_size_bytes"] > 0
        assert rec["cost_analysis"]["flops"] > 0
        rl = rec["roofline"]
        assert rl["chips"] == 4 and rl["flops_per_device"] == \
            rec["cost_analysis"]["flops"]
        cb = rec["collective_bytes"]
        if cb:
            assert cb["total"] == sum(v for k, v in cb.items()
                                      if k != "total")
            assert set(rec["collective_counts"]) == set(cb) - {"total"}


def _local_bytes(t, spec, dtype=None):
    from repro_torch.utils.sharding import local_shape
    item = (dtype or t.dtype).itemsize
    return int(np.prod(local_shape(tuple(t.shape), spec, MESH))) * item


def _expected_args(arch, shape_name, opt):
    """The case's per-device argument bytes, from the shapes and the
    specs alone."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.dryrun import (LONG_SWA_VARIANT, _prune,
                                           _swa_variant, cache_pspecs)
    from repro_torch.models import build_model
    from repro_torch.utils import sharding as sh
    cfg = get_config(arch).reduced()
    shape = INPUT_SHAPES[shape_name].reduced()
    if shape_name == "long_500k" and arch in LONG_SWA_VARIANT:
        cfg = _swa_variant(cfg)
    mode = FakeTensorMode()
    with mode:
        api = build_model(cfg, device="cpu")
        params = api.init(None)
        if opt:
            sh.cast_abstract_params(params, getattr(torch, cfg.dtype))
    specs = (sh.inference_param_pspecs if opt else sh.param_pspecs)(
        params, MESH)
    named = dict(params.named_parameters())
    total = sum(_local_bytes(t, specs[n]) for n, t in named.items())
    b_specs = api.batch_pspecs(shape)
    total += sum(_local_bytes(t, _prune(b_specs[k], set(MESH)))
                 for k, t in api.input_specs(shape, mode).items())
    if shape.kind == "train":
        mdt = torch.bfloat16 if cfg.param_count() > 2e11 else torch.float32
        for n, t in named.items():
            if t.dtype != torch.float32:      # else its own master
                total += _local_bytes(t, specs[n], torch.float32)
            total += 2 * _local_bytes(t, specs[n], mdt)
        total += 4                            # step
    elif shape.kind == "decode":
        ring = shape_name == "long_500k" and cfg.sliding_window > 0
        with mode:
            caches = api.init_caches(shape.global_batch, shape.seq_len,
                                     ring=ring)
        c_specs = cache_pspecs(caches, MESH, shape_name == "long_500k",
                               opt=opt)
        total += _tree_bytes(caches, c_specs)
    return total


def _tree_bytes(tree, specs):
    if isinstance(tree, dict):
        return sum(_tree_bytes(tree[k], specs[k]) for k in tree)
    if isinstance(tree, list):
        return sum(_tree_bytes(t, s) for t, s in zip(tree, specs))
    return _local_bytes(tree, specs) if isinstance(tree, torch.Tensor) \
        else 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_argument_bytes_from_specs(runs, arch):
    from repro_torch.launch.dryrun import LONG_SKIP
    by, _ = runs
    for key in [(arch, s, False) for s in SHAPES] + \
            [(arch, s, True) for s in ("prefill_32k", "decode_32k")]:
        rec = by[key]
        if key[1] == "long_500k" and arch in LONG_SKIP:
            continue
        assert rec["memory_analysis"]["argument_size_bytes"] == \
            _expected_args(*key), key


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_opt_argument_bytes_equal_jax(runs, arch, shape):
    by, jx = runs
    got = by[(arch, shape, True)]["memory_analysis"]["argument_size_bytes"]
    j = jx[f"{arch}:{shape}"]
    assert j["xla"] == j["leaves"] - j["dead"]
    port_only = 0
    if arch == "whisper-tiny" and shape == "decode_32k":
        cfg = get_config(arch).reduced()
        B = INPUT_SHAPES[shape].reduced().global_batch
        port_only = 4 * cfg.encoder_seq + 4 * B   # cross_pos, cross_len
    assert got == j["leaves"] + port_only
    if (arch, shape) in (("whisper-tiny", "decode_32k"),
                         ("mamba2-370m", "decode_32k")):
        assert j["dead"] > 0
    else:
        assert j["dead"] == 0 and got == j["xla"]
