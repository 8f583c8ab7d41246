"""The port stands alone: no JAX, no ``repro``, no silent CPU fallback.

* An AST scan of ``src/repro_torch/`` (the training side among it:
  ``training/``, ``data/``, ``launch/train.py``), ``chip_smoke.py``,
  ``tests/torch_graph_zoo.py``, ``examples/torch_*.py`` and
  ``benchmarks/torch_*.py`` finds no import of ``jax`` or of the JAX
  package ``repro``.
* A subprocess imports every module of ``repro_torch``, and the torch
  graph zoo, with ``jax`` and ``repro`` blocked in ``sys.modules``.
* ``build_model``, the trainer (``launch.train``), ``ContinuousEngine``
  (paged or dense),
  ``ServingEngine``, ``PlanExecutor`` (every mode, ``parallax-hetero``
  too), ``HeteroExecutor`` and ``ArenaExecutor`` run on
  ``cuda`` by default and raise without a card unless ``device="cpu"``
  is passed.
* The kernel wrappers take their plain versions for CPU tensors only: on
  any other device they launch the kernel or raise.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
ZOO = ROOT / "tests" / "torch_graph_zoo.py"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_repro_import_in_the_port():
    package = sorted(PKG.rglob("*.py"))
    drivers = ([ROOT / "chip_smoke.py", ZOO]
               + sorted((ROOT / "examples").glob("torch_*.py"))
               + sorted((ROOT / "benchmarks").glob("torch_*.py")))
    assert len(package) > 40
    scanned = {f.relative_to(PKG).as_posix() for f in package}
    assert {"training/optimizer.py", "training/train_step.py",
            "training/checkpoint.py", "data/pipeline.py",
            "launch/train.py"} <= scanned
    assert {"torch_serve_requests.py", "torch_parallax_analysis.py",
            "torch_quickstart.py", "torch_kernel_variants.py"} \
        <= {f.name for f in drivers}
    bad = [(f.name, m) for f in package + drivers
           for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in %r: sys.modules[name] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import torch_graph_zoo\n"
        "assert not any(k.split('.')[0] in %r and sys.modules[k]\n"
        "               for k in list(sys.modules))\n"
        "print(len(mods))\n" % (FORBIDDEN, FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(PKG.parent), str(ZOO.parent)]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.split()[-1]) >= 40


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main, serve
    from repro_torch.models import build_model
    from repro_torch.runtime.config import EngineConfig
    from repro_torch.runtime.engine import ContinuousEngine, ServingEngine

    cfg = get_config("stablelm-3b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg, device="cuda")
    api = build_model(cfg, device="cpu")
    assert api.device == torch.device("cpu")
    params = api.init(torch.Generator().manual_seed(0))
    config = EngineConfig(hbm_budget=1 << 28, max_context=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousEngine(api, params, config=config)
    ContinuousEngine(api, params, config=config, device="cpu")
    dense = EngineConfig(hbm_budget=1 << 28, max_context=16, paged=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousEngine(api, params, config=dense)
    assert ContinuousEngine(api, params, config=dense,
                            device="cpu").caches[0]["k"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(api, params)
    ServingEngine(api, params, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve("stablelm-3b", n_requests=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve("stablelm-3b", n_requests=1, engine_mode="round")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--requests", "1", "--engine", "round"])


def test_trainer_raises_without_a_card(no_card, capsys):
    from repro_torch.launch.train import main, train

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train("stablelm-3b", steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "stablelm-3b", "--steps", "1"])
    losses = main(["--arch", "stablelm-3b", "--steps", "2", "--batch", "2",
                   "--seq", "8", "--device", "cpu"])
    assert len(losses) == 2 and "on cpu" in capsys.readouterr().out


def test_planner_entry_points_raise_without_a_card(no_card):
    import torch_graph_zoo as tz
    from repro_torch.core import (ArenaExecutor, ParallaxConfig,
                                  PlanExecutor, compile_plan)

    g, make = tz.multihead_graph()
    plan = compile_plan(g, ParallaxConfig(budget=1 << 30))
    for mode in ("reference", "sequential", "parallax", "parallax-hetero"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PlanExecutor(plan, mode)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PlanExecutor(plan, mode, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ArenaExecutor(plan)
    from repro_torch.hetero import HeteroExecutor, heterogenize

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HeteroExecutor(heterogenize(plan))
    for mode in ("parallax", "parallax-hetero"):
        ex = PlanExecutor(plan, mode, device="cpu")
        out = ex(make(np.random.default_rng(0))).outputs[g.outputs[0]]
        assert out.device == torch.device("cpu")
    assert ArenaExecutor(plan, device="cpu").device == torch.device("cpu")


def test_serve_cli_on_cpu(capsys):
    """The continuous engine (paged and ``--no-paged``) and ``--engine
    round`` serve on the CPU with the same streams; the hardening
    options stay the continuous engine's, as in the JAX entry point."""
    from repro_torch.launch.serve import main

    args = ["--device", "cpu", "--requests", "3", "--max-new", "4",
            "--max-batch", "2", "--hbm-budget", "256M"]
    streams = []
    for extra in ([], ["--no-paged"], ["--engine", "round"]):
        main(args + extra)
        out = capsys.readouterr().out
        assert "3/3 requests" in out and "on cpu" in out, extra
        assert ("round engine" in out) == ("round" in extra)
        streams.append([line.split("->")[1] for line in out.splitlines()
                        if line.startswith("req ")])
    assert streams[0] == streams[1] == streams[2]
    with pytest.raises(ValueError, match="continuous engine only"):
        main(args + ["--engine", "round", "--fault-seed", "1"])


def test_serve_cli_on_cpu_mamba2(capsys, monkeypatch):
    """``--arch mamba2-370m`` serves on the CPU through every engine with
    one set of streams, the reset dispatch counted; the host tier flag is
    accepted and stays off (per-row state), the fault plane recovers."""
    from repro_torch.launch.serve import main

    args = ["--arch", "mamba2-370m", "--device", "cpu", "--requests", "3",
            "--max-new", "4", "--max-batch", "2", "--hbm-budget", "256M"]
    streams = []
    for extra in ([], ["--no-paged"], ["--engine", "round"],
                  ["--megastep", "1"], ["--host-pool", "1M"]):
        main(args + extra)
        out = capsys.readouterr().out
        assert "3/3 requests" in out and "host tier" not in out, extra
        streams.append([line.split("->")[1] for line in out.splitlines()
                        if line.startswith("req ")])
    assert all(s == streams[0] for s in streams)
    main(args + ["--fault-seed", "3"])
    assert "degraded activations" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "mamba2-370m", "--requests", "1"])


def _paged_args(device):
    rng = np.random.default_rng(0)
    B, H, K, D, bs, bpr = 2, 4, 2, 16, 4, 3
    pool = torch.tensor(rng.standard_normal((B * bpr + 1, bs, K, D)),
                        dtype=torch.float32, device=device)
    q = torch.tensor(rng.standard_normal((B, H, D)), dtype=torch.float32,
                     device=device)
    tables = torch.arange(B * bpr, dtype=torch.int32,
                          device=device).reshape(B, bpr)
    lens = torch.tensor([0, bpr * bs - 1], dtype=torch.int32, device=device)
    new = torch.ones(B, 1, K, D, device=device)
    return q, pool, tables, lens, new


def _dense_args(device):
    """decode_attention on the model's cache layout, flash_attention on
    (B, H, S, D)."""
    rng = np.random.default_rng(2)
    B, H, K, T, D = 2, 4, 2, 12, 16
    q = torch.tensor(rng.standard_normal((B, H, D)), dtype=torch.float32,
                     device=device)
    cache = torch.tensor(rng.standard_normal((B, T, K, D)),
                         dtype=torch.float32, device=device)
    pos = torch.arange(T, dtype=torch.int32, device=device)
    lens = torch.tensor([3, T - 1], dtype=torch.int32, device=device)
    qs = torch.tensor(rng.standard_normal((B, H, T, D)),
                      dtype=torch.float32, device=device)
    kv = cache.transpose(1, 2)
    return (q, kv, kv, pos, lens), (qs, kv, kv)


def _ssd_args(device):
    """ssd_scan in the models' layout: b=1, S=16, H=4, G=2, P=8, N=4."""
    rng = np.random.default_rng(3)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(rng.standard_normal((1, 16, 4, 8)), **f32),
            torch.tensor(rng.uniform(0.01, 0.2, (1, 16, 4)), **f32),
            -torch.tensor(rng.uniform(0.5, 2.0, 4), **f32),
            torch.tensor(rng.standard_normal((1, 16, 2, 4)), **f32),
            torch.tensor(rng.standard_normal((1, 16, 2, 4)), **f32))


def _branch_args(device):
    rng = np.random.default_rng(1)
    xs = [torch.tensor(rng.standard_normal((8, 16), dtype=np.float32),
                       device=device) for _ in range(3)]
    ws = [torch.tensor(rng.standard_normal((16, 4), dtype=np.float32),
                       device=device) for _ in range(3)]
    return xs, ws


def test_wrappers_take_the_plain_path_only_on_cpu(monkeypatch):
    import importlib

    from repro_torch.kernels import _build
    from repro_torch.kernels.branch_matmul import (branch_matmul_plain,
                                                   grouped_branch_matmul)
    from repro_torch.kernels.branch_matmul import launches as bm_launches
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.decode_attention import launches as da_launches
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention import launches as fa_launches
    from repro_torch.kernels.paged_attention import (
        launches, paged_append, paged_decode_attention,
        paged_decode_attention_plain)
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.ssd_scan import launches as ss_launches
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    def no_build(name):
        raise AssertionError(f"CPU tensors must not build {name}")

    bm = importlib.import_module(
        "repro_torch.kernels.branch_matmul.branch_matmul")
    da = importlib.import_module(
        "repro_torch.kernels.decode_attention.decode_attention")
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    ss = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
    for module in (pa, bm, da, fa, ss, _build):
        monkeypatch.setattr(module, "load", no_build)
    before = dict(launches)
    bm_before = dict(bm_launches)
    new_before = (dict(da_launches), dict(fa_launches))
    dec, fl = _dense_args("cpu")
    assert torch.equal(decode_attention(*dec), decode_attention_plain(*dec))
    assert torch.equal(flash_attention(*fl), flash_attention_plain(*fl))
    assert (da_launches, fa_launches) == new_before
    ss_before = dict(ss_launches)
    args = _ssd_args("cpu")
    assert torch.equal(ssd_scan(*args, chunk=8), ssd_scan_plain(*args, 8))
    assert ss_launches == ss_before
    q, pool, tables, lens, new = _paged_args("cpu")
    got = paged_decode_attention(q, pool, pool, tables, lens)
    torch.testing.assert_close(
        got, paged_decode_attention_plain(q, pool, pool, tables, lens))
    paged_append(pool, pool.clone(), new, new, tables, lens,
                 torch.ones(2, dtype=torch.int32))
    xs, ws = _branch_args("cpu")
    got = grouped_branch_matmul(xs, ws)
    want = branch_matmul_plain(torch.stack(xs), torch.stack(ws))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert launches == before and bm_launches == bm_before
    # any other device: the kernel or an error, never the plain version
    with pytest.raises(ValueError, match="no kernel"):
        grouped_branch_matmul(*_branch_args("meta"))
    q, pool, tables, lens, new = _paged_args("meta")
    with pytest.raises(ValueError, match="no kernel"):
        paged_decode_attention(q, pool, pool, tables, lens)
    dec, fl = _dense_args("meta")
    with pytest.raises(ValueError, match="no kernel"):
        decode_attention(*dec)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(*fl)
    with pytest.raises(ValueError, match="no kernel"):
        paged_append(pool, pool, new, new, tables, lens, lens)
    with pytest.raises(ValueError, match="no kernel"):
        ssd_scan(*_ssd_args("meta"), chunk=8)


@pytest.mark.cuda
def test_wrappers_launch_their_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels.branch_matmul import (branch_matmul,
                                                   branch_matmul_plain)
    from repro_torch.kernels.branch_matmul import launches as bm_launches
    from repro_torch.kernels.paged_attention import (launches, paged_append,
                                                     paged_decode_attention)

    xs, ws = _branch_args("cuda")
    x, w = torch.stack(xs), torch.stack(ws)
    n = bm_launches["branch_matmul"]
    got = branch_matmul(x, w)
    torch.cuda.synchronize()
    assert bm_launches["branch_matmul"] == n + 1
    torch.testing.assert_close(got, branch_matmul_plain(x, w), rtol=0,
                               atol=2e-5)
    q, pool, tables, lens, new = _paged_args("cuda")
    before = dict(launches)
    paged_append(pool, pool.clone(), new, new, tables, lens, lens)
    paged_decode_attention(q, pool, pool, tables, lens)
    torch.cuda.synchronize()
    assert launches["paged_append"] == before["paged_append"] + 1
    assert launches["paged_decode_attention"] == \
        before["paged_decode_attention"] + 1
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain)
    from repro_torch.kernels.decode_attention import launches as da_launches
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention import launches as fa_launches

    dec, fl = _dense_args("cuda")
    n_da, n_fa = (da_launches["decode_attention"],
                  fa_launches["flash_attention"])
    got_d, got_f = decode_attention(*dec), flash_attention(*fl)
    torch.cuda.synchronize()
    assert da_launches["decode_attention"] == n_da + 1
    assert fa_launches["flash_attention"] == n_fa + 1
    torch.testing.assert_close(got_d, decode_attention_plain(*dec),
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got_f, flash_attention_plain(*fl),
                               rtol=2e-5, atol=2e-5)
    from repro_torch.kernels.ssd_scan import launches as ss_launches
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    args = _ssd_args("cuda")
    n_ss = ss_launches["ssd_scan"]
    got_s = ssd_scan(*args, chunk=8)
    torch.cuda.synchronize()
    assert ss_launches["ssd_scan"] == n_ss + 1
    torch.testing.assert_close(got_s, ssd_scan_plain(*args, chunk=8),
                               rtol=2e-4, atol=2e-4)
