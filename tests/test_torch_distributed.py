"""The port's distributed layer against the JAX package's.

* Twins of ``tests/test_utils.py`` at its tolerances: the collective
  accounting (``utils.hlo``) on a recorded dispatch trace with one
  collective of each kind (a fake 4-rank group, in a child process),
  the H100 roofline, the sharding rules, ``attend_chunked`` against
  JAX's at 2e-5 and the chunked flag's loss.  JAX's
  ``test_convert_artifact_wrapped_dedup`` has no twin: it tests an
  XLA:CPU artifact that eager torch does not make.
* ``param_pspecs``, ``inference_param_pspecs`` and ``cache_pspecs``
  against JAX's for every leaf of every architecture, full and reduced,
  on abstract 16x16 and 2x16x16 meshes, on the trailing dims (JAX's
  stacked layers lead with scan dims; the port keeps one module per
  layer).
* ``moe_ep`` in both regimes on a 4-rank gloo group, meshes (1, 4) and
  (2, 2), against JAX's ``moe_ep`` with four host devices (both in
  child processes): fp32 2e-5 on outputs and aux loss, equal drops.
* ``runtime_flags.shard_ssm_heads`` on the same four ranks: the Mamba2
  block's scan split over ``model`` heads, its output as off the mesh.
* ``maybe_shard`` and the ``shard_*`` helpers are the identity off-mesh.

Every case that back-propagates pins torch to one thread.
"""

import os
import pathlib
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.utils import roofline as troof  # noqa: E402
from repro_torch.utils.sharding import P, spec_for  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    env.update(extra)
    return env


# -- the dispatch trace's collective accounting ------------------------------

@pytest.fixture(scope="module")
def recorded():
    import json
    proc = subprocess.run([sys.executable, str(TESTS / "torch_dist_child.py"),
                           "trace"], capture_output=True, text=True,
                          timeout=300, env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_collective_bytes_per_type(recorded):
    cb = recorded["bytes"]
    for kind, nbytes in recorded["expected"].items():
        assert cb[kind] == nbytes, kind
    assert cb["all-gather"] == 32 * 1024 * 2      # the gathered result
    assert cb["total"] == sum(v for k, v in cb.items() if k != "total")
    assert "collective-permute" not in cb


def test_collective_counts(recorded):
    assert recorded["counts"] == {"all-gather": 1, "all-reduce": 1,
                                  "reduce-scatter": 1, "all-to-all": 1}


def test_op_histogram(recorded):
    ops = recorded["ops"]
    assert ops["add"] == 1 and ops["wait_tensor"] == 4
    assert ops["all_gather_into_tensor"] == 1


# -- roofline ----------------------------------------------------------------

def test_roofline_terms_and_dominant():
    assert troof.PEAK_FLOPS == 989.4e12
    assert troof.HBM_BW == 3.35e12 and troof.NVLINK_BW == 450e9
    rl = troof.roofline(flops_per_device=989.4e12,
                        bytes_per_device=3.35e12,
                        collective_bytes_per_device=225e9, chips=256,
                        model_flops=989.4e12 * 256 * 0.5)
    np.testing.assert_allclose(rl.compute_s, 1.0)
    np.testing.assert_allclose(rl.memory_s, 1.0)
    np.testing.assert_allclose(rl.collective_s, 0.5)
    assert rl.dominant in ("compute", "memory")
    np.testing.assert_allclose(rl.useful_flops_ratio, 0.5)
    assert set(rl.row()) >= {"compute_s", "memory_s", "collective_s",
                             "dominant", "useful_flops_ratio"}


def test_model_flops_estimate_kinds():
    from repro.configs import get_config as jget
    from repro.utils.roofline import model_flops_estimate as jmf
    cfg = get_config("qwen2-72b")
    tr = troof.model_flops_estimate(cfg, INPUT_SHAPES["train_4k"])
    pf = troof.model_flops_estimate(cfg, INPUT_SHAPES["prefill_32k"])
    dc = troof.model_flops_estimate(cfg, INPUT_SHAPES["decode_32k"])
    assert tr == pytest.approx(6 * cfg.active_param_count() * 256 * 4096)
    assert pf == pytest.approx(2 * cfg.active_param_count() * 32 * 32768)
    assert dc == pytest.approx(2 * cfg.active_param_count() * 128)
    from repro.configs import INPUT_SHAPES as JSHAPES
    for name in INPUT_SHAPES:
        assert troof.model_flops_estimate(cfg, INPUT_SHAPES[name]) == \
            jmf(jget("qwen2-72b"), JSHAPES[name])


def test_moe_active_params_much_smaller():
    kimi = get_config("kimi-k2-1t-a32b")
    assert kimi.param_count() > 0.9e12
    assert kimi.active_param_count() < 0.05 * kimi.param_count()


def test_no_tpu_constant_in_the_port():
    src = (ROOT / "src" / "repro_torch" / "utils" / "roofline.py").read_text()
    for tpu in ("197e12", "819e9", "v5e", "TPU", "ICI"):
        assert tpu not in src


# -- sharding rules ----------------------------------------------------------

def _spec(name, shape, axes=("data", "model"),
          sizes={"data": 16, "model": 16}):
    return spec_for(name, shape, axes, sizes)


def test_param_rules_basic():
    assert _spec("layers.0.attn.wq", (1024, 2048)) == P("data", "model")
    assert _spec("layers.0.attn.wo", (2048, 1024)) == P("model", "data")
    # a leading dim is padded with None, as JAX pads its scan dims
    assert _spec("layers.0.attn.wq", (8, 1024, 2048)) == \
        P(None, "data", "model")


def test_param_rules_divisibility_fallback():
    # vocab 51865 not divisible by 16 -> replicated on that dim
    assert _spec("embed", (51865, 384)) == P(None, "data")
    assert _spec("embed", (51200, 384)) == P("model", "data")


def test_moe_expert_rule_needs_moe_path():
    assert _spec("layers.3.moe.w_gate", (16, 1024, 512)) == \
        P("model", "data", None)
    assert _spec("layers.3.mlp.w_gate", (16, 1024, 512)) == \
        P(None, "data", "model")
    # a shared expert's 2-D weights take the dense rule
    assert _spec("layers.3.moe.shared.w_gate", (1024, 512)) == \
        P("data", "model")


def test_unknown_params_replicated():
    assert _spec("whatever", (7, 9)) == P()


def test_placements_order_and_local_shape():
    from repro_torch.utils.sharding import local_shape
    mesh = {"pod": 2, "data": 16, "model": 16}
    assert local_shape((64, 4096), P(("pod", "data"), "model"), mesh) == \
        (2, 256)
    with pytest.raises(ValueError):
        local_shape((8, 4096), P(("pod", "data"), None), mesh)


def test_opt_state_pspecs_and_tree_bytes():
    from repro_torch.utils.sharding import opt_state_pspecs, tree_bytes
    specs = {"layers.0.attn.wq": P("data", "model")}
    assert opt_state_pspecs(None, specs) == {
        "master": specs, "m": specs, "v": specs, "step": P()}
    tree = {"a": torch.zeros(3), "b": [torch.zeros(2, dtype=torch.bfloat16)]}
    assert tree_bytes(tree) == 3 * 4 + 2 * 2


# -- chunked attention --------------------------------------------------------

@pytest.mark.parametrize("window", [0, 24])
def test_attend_chunked_exact(window):
    from repro.models.attention import attend_chunked as jchunked
    from repro_torch.models.attention import (attend, attend_chunked,
                                              causal_mask)
    B, S, H, K, D = 2, 64, 4, 2, 16
    rng = np.random.default_rng(window)
    q, k, v = (rng.standard_normal((B, S, n, D)).astype(np.float32)
               for n in (H, K, K))
    want = np.asarray(jchunked(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, window=window,
                               chunk_q=16, chunk_k=32))
    tq, tk, tv = map(torch.tensor, (q, k, v))
    got = attend_chunked(tq, tk, tv, causal=True, window=window,
                         chunk_q=16, chunk_k=32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    ref = attend(tq, tk, tv, causal_mask(S, S, 0, window))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_attend_chunked_gradient_matches_plain():
    from repro_torch.models.attention import (attend, attend_chunked,
                                              causal_mask)
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 32, n, 8, generator=g, requires_grad=True)
               for n in (4, 2, 2))
    out = attend_chunked(q, k, v, window=12, chunk_q=8, chunk_k=16)
    gc = torch.autograd.grad(out.square().sum(), (q, k, v))
    ref = attend(q, k, v, causal_mask(32, 32, 0, 12))
    gr = torch.autograd.grad(ref.square().sum(), (q, k, v))
    for a, b in zip(gc, gr):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-5)


def test_chunked_flag_preserves_model_forward():
    from repro.models import build_model as jbuild
    from repro.configs import get_config as jget
    from repro_torch.models import build_model, runtime_flags
    from repro_torch.models.bridge import params_from_numpy
    torch.set_num_threads(1)
    jcfg = jget("stablelm-3b").reduced()
    japi = jbuild(jcfg)
    jparams = japi.init(jax.random.key(0))
    toks = jax.random.randint(jax.random.key(1), (1, 32), 0,
                              jcfg.vocab_size)
    jbatch = {"tokens": toks, "labels": toks}
    want = float(japi.loss_fn(jparams, jbatch)[0])

    cfg = get_config("stablelm-3b").reduced()
    api = build_model(cfg, device="cpu")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    batch = {k: torch.tensor(np.asarray(v)) for k, v in jbatch.items()}
    base = float(api.loss_fn(params, batch)[0])
    try:
        runtime_flags.chunked_attention = True
        runtime_flags.chunk_q, runtime_flags.chunk_k = 8, 16
        chunked = float(api.loss_fn(params, batch)[0])
    finally:
        runtime_flags.chunked_attention = False
        runtime_flags.chunk_q, runtime_flags.chunk_k = 512, 1024
    np.testing.assert_allclose(chunked, want, rtol=1e-5)
    np.testing.assert_allclose(chunked, base, rtol=1e-5)


# -- specs against JAX's, every leaf of every architecture ------------------

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _jmesh(sizes):
    return SimpleNamespace(axis_names=tuple(sizes),
                           devices=np.empty(tuple(sizes.values())))


def _jax_dryrun():
    """``repro.launch.dryrun`` sets XLA_FLAGS when imported: restore it,
    so no later child process of this worker inherits 512 devices."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdry


def _key(e):
    return str(e.key) if hasattr(e, "key") else str(e.idx)


def _jax_named(cfg, tree, is_leaf):
    """JAX pytree -> {the port's name: leaf}, stacked layers unstacked
    (a stacked leaf stands for each of its layers)."""
    from repro_torch.models import transformer
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    out = {}
    if cfg.is_encoder_decoder:
        for path, leaf in flat:
            names = [_key(e) for e in path]
            if names[0] in ("encoder", "decoder", "self"):
                n = cfg.encoder_layers if names[0] == "encoder" \
                    else cfg.num_layers
                for i in range(n):
                    out[".".join([names[0], str(i)] + names[1:])] = leaf
            else:
                out[".".join(names)] = leaf
        return out
    _, prefix, period, n_rep = transformer.structure(cfg)
    for path, leaf in flat:
        names = [_key(e) for e in path]
        if names[0] == "prefix":
            out[".".join(["layers", names[1]] + names[2:])] = leaf
        elif names[0] == "period":
            j = int(names[1])
            for r in range(n_rep):
                out[".".join(["layers", str(prefix + r * period + j)]
                             + names[2:])] = leaf
        else:
            out[".".join(names)] = leaf
    return out


def _trailing(jspec, pspec, ndim):
    j = (None,) * ndim + tuple(jspec)
    p = (None,) * ndim + tuple(pspec)
    return j[-ndim:] if ndim else (), p[-ndim:] if ndim else ()


def _fake_model(cfg):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import build_model
    mode = FakeTensorMode()
    with mode:
        return build_model(cfg, device="cpu"), mode


#: JAX's stacked shared expert (Kimi K2) has three dims and takes the
#: expert rule by arity; the port's is 2-D and takes the dense rule
def _jax_arity_artifact(cfg, name):
    from repro_torch.models import transformer
    if ".moe.shared." not in name:
        return False
    prefix = transformer.structure(cfg)[1]
    return int(name.split(".")[1]) >= prefix


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_cache_pspecs_equal_jax(arch):
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro.utils import sharding as jsh
    from repro_torch.launch.dryrun import cache_pspecs, _swa_variant
    from repro_torch.utils import sharding as tsh
    jdry = _jax_dryrun()
    for reduced in (False, True):
        cfg, jcfg = get_config(arch), jget(arch)
        if reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        japi = jbuild(jcfg)
        aparams = jsh.abstract_params(japi)
        api, mode = _fake_model(cfg)
        with mode:
            params = api.init(None)
        named = dict(params.named_parameters())
        for mtag, sizes in MESHES.items():
            jm = _jmesh(sizes)
            for fn in ("param_pspecs", "inference_param_pspecs"):
                js = _jax_named(cfg, getattr(jsh, fn)(aparams, jm),
                                lambda x: isinstance(x, JP))
                ts = getattr(tsh, fn)(params, sizes)
                assert set(js) == set(ts) == set(named), (arch, fn)
                bad = {n for n in ts
                       if _trailing(js[n], ts[n], named[n].ndim)[0]
                       != _trailing(js[n], ts[n], named[n].ndim)[1]}
                expect = {n for n in ts if _jax_arity_artifact(cfg, n)}
                assert bad == expect, (arch, reduced, mtag, fn,
                                       sorted(bad - expect)[:5])
            for shape in ("decode_32k", "long_500k"):
                long = shape == "long_500k"
                c, jc = cfg, jcfg
                if long and arch in jdry.LONG_SKIP:
                    continue
                if long and arch in jdry.LONG_SWA_VARIANT:
                    c, jc = _swa_variant(cfg), jdry._swa_variant(jcfg)
                shp = INPUT_SHAPES[shape]
                if reduced:
                    shp = shp.reduced()
                ring = long and c.sliding_window > 0
                jcaches = jax.eval_shape(lambda: jbuild(jc).init_caches(
                    shp.global_batch, shp.seq_len, jnp.bfloat16, ring=ring))
                api_c, mode_c = _fake_model(c)
                with mode_c:
                    caches = api_c.init_caches(shp.global_batch,
                                               shp.seq_len, ring=ring)
                for opt in (False, True):
                    js = _jax_named(c, jdry.cache_pspecs(jcaches, jm, long,
                                                         opt=opt),
                                    lambda x: isinstance(x, JP))
                    ts = _port_named(cache_pspecs(caches, sizes, long,
                                                  opt=opt))
                    tl = _port_named(caches)
                    extra = {n for n in ts if n.startswith("cross_p")
                             or n.startswith("cross_len")}
                    assert set(js) == set(ts) - extra, (arch, shape)
                    for n in extra:
                        assert ts[n] == P(None)
                    for n in js:
                        j, p = _trailing(js[n], ts[n], tl[n].ndim)
                        assert j == p, (arch, reduced, mtag, shape, opt, n,
                                        js[n], ts[n])


def _port_named(tree, prefix=""):
    """The port's cache tree (a layer list, or Whisper's dict) -> {JAX's
    dotted name: leaf}, tensors only."""
    if isinstance(tree, list):
        out = {}
        for i, sub in enumerate(tree):
            out.update(_port_named(sub, f"{prefix}{i}." if prefix
                                   else f"layers.{i}."))
        return out
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if isinstance(v, list):
                out.update(_port_named(v, f"{prefix}{k}."))
            else:
                out.update(_port_named(v, f"{prefix}{k}"))
        return out
    if isinstance(tree, (torch.Tensor, tuple)):         # a tensor or a P
        return {prefix: tree}
    return {}                                   # no spec: the tile int


# -- moe_ep on four ranks against JAX's ---------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    rng = np.random.default_rng(0)
    dm, f, E = 256, 128, 8
    inp = {"p_router": rng.standard_normal((dm, E)).astype(np.float32) / 16,
           "p_w_gate": rng.standard_normal((E, dm, f)).astype(np.float32)
           / 16,
           "p_w_up": rng.standard_normal((E, dm, f)).astype(np.float32) / 16,
           "p_w_down": rng.standard_normal((E, f, dm)).astype(np.float32)
           / 11}
    for case, T, cf in (("rep", 12, 1.25), ("a2a", 64, 1.25),
                        ("drop", 64, 0.5)):
        inp[f"x_{case}"] = rng.standard_normal((T, dm)).astype(np.float32)
        inp[f"cf_{case}"] = np.float32(cf)
    np.savez(d / "in.npz", **inp)
    jproc = subprocess.Popen(
        [sys.executable, str(TESTS / "jax_dist_child.py"), "moe_ep",
         str(d / "in.npz"), str(d / "jax.npz")],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stderr=subprocess.PIPE, text=True)
    port = _free_port()
    ranks = [subprocess.Popen(
        [sys.executable, str(TESTS / "torch_dist_child.py"), "moe_ep",
         str(r), "4", str(port), str(d / "in.npz"), str(d / "torch.npz")],
        env=_env(), stderr=subprocess.PIPE, text=True) for r in range(4)]
    errs = [p.communicate(timeout=600)[1] for p in ranks + [jproc]]
    for p, e in zip(ranks + [jproc], errs):
        assert p.returncode == 0, e[-3000:]
    return np.load(d / "jax.npz"), np.load(d / "torch.npz")


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
@pytest.mark.parametrize("case,regime", [("rep", "replicated"),
                                         ("a2a", "a2a"), ("drop", "a2a")])
def test_moe_ep_matches_jax(moe_runs, case, regime, mesh):
    jr, tr = moe_runs
    k = f"{case}_{mesh}"
    assert str(tr[f"regime_{k}"]) == regime
    np.testing.assert_allclose(tr[f"aux_{k}"], jr[f"aux_{k}"], rtol=2e-5,
                               atol=2e-5)
    assert tr[f"drop_{k}"] == jr[f"drop_{k}"]
    if case == "drop":
        assert jr[f"drop_{k}"] > 0
    # JAX's send_meta.at[di, pi].set(...) writes -1 for every dropped
    # pair to slot (0, 0): where the last dropped pair comes after the
    # pair kept there, JAX loses that pair too.  The port keeps it
    # (Switch semantics: only pairs over capacity drop), so the outputs
    # differ at exactly those tokens and agree at every other.
    clob = jr[f"clobbered_{k}"]
    y, want = tr[f"y_{k}"], jr[f"y_{k}"]
    differ = np.nonzero(np.abs(y - want).max(-1) > 2e-5)[0]
    np.testing.assert_array_equal(differ, clob)
    keep = np.setdiff1d(np.arange(len(y)), clob)
    np.testing.assert_allclose(y[keep], want[keep], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_shard_ssm_heads_matches_off_mesh(moe_runs, mesh):
    """``runtime_flags.shard_ssm_heads`` (JAX's O6) splits the full-sequence
    scan's heads over ``model`` and leaves the block's output as it was
    off the mesh, at fp32 2e-5; with the flag off every rank scans all
    heads."""
    _, tr = moe_runs
    H, ways = int(tr[f"ssm_H_{mesh}"]), int(mesh.split("x")[1])
    assert list(tr[f"ssm_heads_off_{mesh}"]) == [H]
    assert list(tr[f"ssm_heads_on_{mesh}"]) == [H // ways]
    want = tr[f"ssm_y_{mesh}"]
    for on in ("off", "on"):
        np.testing.assert_allclose(tr[f"ssm_y_{on}_{mesh}"], want,
                                   rtol=2e-5, atol=2e-5)


def test_moe_ep_one_rank_is_moe_ragged():
    """On a (1, 1) mesh both regimes are ``moe_ragged`` exactly
    (dropless, one rank, the same buckets and kernel)."""
    proc = subprocess.run(
        [sys.executable, "-c", _ONE_RANK], capture_output=True, text=True,
        timeout=300, env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-1] == "ok"


_ONE_RANK = """
import dataclasses, torch
torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.moe import MoE, moe_ep, moe_ragged
mesh = make_host_mesh(backend="gloo")
cfg = get_config("kimi-k2-1t-a32b").reduced()
cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
    cfg.moe, num_experts=8, num_experts_per_tok=2))
g = torch.Generator().manual_seed(0)
p = MoE(cfg, g, "cpu", torch.float32)
for T, regime in ((5, "replicated"), (48, "a2a")):
    x = torch.randn(T, cfg.d_model, generator=g)
    st = {}
    y, aux = moe_ep(p, cfg, x, mesh, stats=st)
    y2, aux2 = moe_ragged(p, cfg, x)
    assert st["regime"] == regime and int(st["dropped"]) == 0
    assert torch.equal(y, y2) and torch.equal(aux, aux2), T
print("ok")
"""


# -- off-mesh identity --------------------------------------------------------

def test_maybe_shard_identity_off_mesh():
    from repro_torch.models import sharding as sh
    x = torch.randn(2, 8, 4)
    assert sh.active_axes() == () and sh.spec("data") is None
    assert sh.maybe_shard(x, sh.DP_AXES, "model", None) is x
    for fn in (sh.shard_batch_seq, sh.shard_batch, sh.shard_decode):
        assert fn(x) is x
    assert sh.shard_kv_cache(x[..., None], True).shape == (2, 8, 4, 1)
    assert sh.model_ways() == 1
