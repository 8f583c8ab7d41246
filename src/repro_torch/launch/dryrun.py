"""Multi-pod dry-run: dispatch every (architecture x input shape) on the
production mesh with fake-tensor stand-ins (no allocation).

Port of ``repro.launch.dryrun``::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b \\
        --shape train_4k [--multi-pod] [--variant swa] [--opt]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

JAX lowers and compiles each case with ``ShapeDtypeStruct`` stand-ins
and reads XLA's analyses.  The torch meaning: params, optimizer state,
batch and caches are DTensors of fake tensors (shapes, no storage) on a
fake mesh (``launch.mesh``), placed by the sharding rules
(``utils.sharding``, ``ModelAPI.batch_pspecs``, :func:`cache_pspecs`);
one ``train_step`` (``training.make_train_step``), ``prefill_fn`` or
``decode_fn`` is dispatched under ``models.sharding.set_mesh`` and
DTensor's ``implicit_replication()``, and a dispatch trace
(``utils.hlo.DispatchTrace``) records what rank 0 runs on its local
shards.  Fake tensors carry device ``"cpu"``, so the model takes its
plain path, as JAX's dry-run lowers the jnp path and not Pallas: the
dry-run allocates nothing and launches no kernel, on any device.  That is
its design, not a fallback.

DTensor's own meta ops (its sharding propagation runs each op once over
the global shapes) are not recorded (``utils.hlo``).

Per case it records, per device:

* ``argument_size_bytes``: the local-shard bytes of every input (each
  storage once: an fp32 parameter is its own master in the optimizer
  state), exact;
* ``output_size_bytes``: the local bytes of the outputs that are not
  inputs updated in place;
* ``temp_size_bytes``: the peak of live local bytes allocated during the
  call (outputs included);
* FLOPs of the local ops (``torch.utils.flop_counter``'s formulas) and
  the bytes they read and write;
* collective bytes and counts by JAX's op names;
* ``lower_s``, the recorded dispatch's wall time (``compile_s`` 0: eager
  torch compiles nothing).

Records go to ``benchmarks/artifacts/dryrun_torch/<arch>__<shape>__<mesh>
[__<variant>].json`` with JAX's keys where they have a meaning and
``flops_accounting: "counted"`` (every layer is dispatched, so nothing is
extrapolated).  Dropped from JAX's record: ``cpu_bf16_convert_artifact
_bytes`` and ``per_device_gb_tpu_corrected`` (an XLA:CPU artifact eager
torch does not make), ``generated_code_size_bytes`` (no code is
generated) and the rolled-scan raw FLOPs (no scan).

The beyond-paper optimizations of ``--opt`` (JAX's EXPERIMENTS.md §Perf):

* O1 — every floating parameter cast to ``cfg.dtype`` for serving
  (``utils.sharding.cast_abstract_params``);
* O2 — the serving MoE layout, experts over ``model`` and the FFN hidden
  dim over the data axes (``inference_param_pspecs``);
* O3 — flash-decode cache sequence sharding over an idle ``model`` axis
  (:func:`cache_pspecs`), merged by ``attention``'s distributed decode;
* O4 — cache donation: no counterpart, eager torch has no donation (the
  port's decode updates its caches in place already);
* O5 — ``runtime_flags.chunked_attention`` (``attention.attend_chunked``);
* O6 — ``runtime_flags.shard_ssm_heads``, opt-in with ``REPRO_SSM_HEADS=1``
  as in JAX (measured and refuted there);
* O7 — 8 microbatches per train step, each rank slicing its own rows.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCHS, INPUT_SHAPES, InputShape, get_config
from repro_torch.device import torch_dtype
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model, runtime_flags
from repro_torch.models.sharding import set_mesh
from repro_torch.training import OptConfig, init_opt_state, make_train_step
from repro_torch.utils.hlo import (DispatchTrace, collective_bytes,
                                   collective_counts)
from repro_torch.utils.roofline import model_flops_estimate, roofline
from repro_torch.utils.sharding import (P, abstract_params, axis_sizes,
                                        cast_abstract_params, distribute,
                                        inference_param_pspecs,
                                        param_pspecs, shard_module)

ARTIFACTS = Path(__file__).resolve().parents[3] / "benchmarks" / \
    "artifacts" / "dryrun_torch"

# long_500k applicability (DESIGN.md §4): native sub-quadratic archs run
# as-is; pure-dense archs run the sliding-window VARIANT; the rest skip.
LONG_NATIVE = {"mamba2-370m", "jamba-v0.1-52b", "h2o-danube-3-4b"}
LONG_SWA_VARIANT = {"qwen2-72b", "yi-34b", "stablelm-3b"}
LONG_SKIP = {"whisper-tiny": "decoder context 448 / encoder 1500 frames",
             "qwen2-vl-2b": "full attention, no SWA variant assigned",
             "dbrx-132b": "full attention, no SWA variant assigned",
             "kimi-k2-1t-a32b": "full attention, no SWA variant assigned"}

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _swa_variant(cfg):
    return dataclasses.replace(cfg, sliding_window=4096,
                               notes=cfg.notes + " [SWA variant w=4096]")


def _prune(spec, axes):
    """Axis names not in this mesh dropped (e.g. "pod" on one pod)."""
    def fix(entry):
        if entry is None:
            return None
        if isinstance(entry, str):
            return entry if entry in axes else None
        sub = tuple(a for a in entry if a in axes)
        return sub if len(sub) > 1 else (sub[0] if sub else None)
    return P(*[fix(e) for e in spec])


def _zip_tensors(tree, specs, fn):
    """``fn(tensor, spec)`` over nested dicts / lists; others kept."""
    if isinstance(tree, dict):
        return {k: _zip_tensors(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_tensors(v, s, fn) for v, s in zip(tree, specs)]
    return fn(tree, specs) if isinstance(tree, torch.Tensor) else tree


_fake = []


def shared_fake_mode():
    """The process's ``FakeTensorMode``: one for every case, since the
    models' per-shape tables (``functools.lru_cache`` tables of positions
    and slot ids) keep the tensors they made."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if not _fake:
        _fake.append(FakeTensorMode())
    return _fake[0]


def plan_entry(cfg, shape: InputShape, mesh, fake_mode, opt=False):
    """Build ``(step_fn, args)`` for one dry-run case: the entry point and
    its DTensor arguments of ``fake_mode``'s fake tensors.

    ``opt=True`` enables the beyond-paper optimizations (module
    docstring): O1 bf16 serving params, O2 expert-only MoE sharding at
    inference, O3 flash-decode KV sequence sharding, O7 microbatches."""
    long_context = shape.name == "long_500k"
    api = build_model(cfg, device="cpu", distributed=True, mesh=mesh)
    params = abstract_params(api, fake_mode)
    if opt and shape.kind != "train":
        cast_abstract_params(params, torch_dtype(cfg.dtype))    # O1
        p_specs = inference_param_pspecs(params, mesh)          # O2
    else:
        p_specs = param_pspecs(params, mesh)
    axes = set(mesh.mesh_dim_names)
    b_specs = {k: _prune(s, axes) for k, s in
               api.batch_pspecs(shape).items()}
    with fake_mode:
        shard_module(params, p_specs, mesh)
        batch = {k: distribute(v, b_specs[k], mesh)
                 for k, v in api.input_specs(shape, fake_mode).items()}
        if shape.kind == "train":
            opt_cfg = OptConfig(
                moment_dtype="bfloat16" if cfg.param_count() > 2e11
                else "float32")
            # O7: gradient accumulation divides activation memory
            step = make_train_step(api, opt_cfg,
                                   microbatches=8 if opt else 1)
            # the state's DTensors mirror the parameter specs
            # (utils.sharding.opt_state_pspecs)
            return step, (params, init_opt_state(params, opt_cfg), batch)
        if shape.kind == "prefill":
            return api.prefill_fn, (params, batch)
        ring = long_context and cfg.sliding_window > 0
        caches = api.init_caches(shape.global_batch, shape.seq_len,
                                 torch_dtype(cfg.dtype), ring=ring)
        c_specs = cache_pspecs(caches, mesh, long_context, opt=opt)
        caches = _zip_tensors(caches, c_specs,
                              lambda t, s: distribute(t, s, mesh))
        return api.decode_fn, (params, caches, batch)


def cache_pspecs(caches, mesh, long_context, opt=False):
    """KV/state cache sharding by leaf name (DESIGN.md §5), over the
    port's cache structure (a list of per-layer dicts; Whisper's dict of
    per-layer self caches and stacked cross K/V).

    Trailing-dims rules; Whisper's stacked cross K/V lead with its
    layers, padded with None.  Axes that do not divide a dim are dropped
    (replicated) — e.g. batch 1 on long_500k.  Leaves the rules do not
    name (``pos``, Whisper's ``cross_pos`` / ``cross_len``) are
    replicated; the ``tile`` ints get no spec.

    ``opt=True`` (§Perf O3, flash-decode): when the KV-head count does
    not divide the model axis (GQA kv=8 on a 16-way axis would replicate
    the cache), shard the cache *sequence* over the model axis instead;
    the decode step merges the partial softmax statistics across the
    sequence shards (distributed flash-decode)."""
    axes = tuple(mesh.mesh_dim_names) if not isinstance(mesh, dict) \
        else tuple(mesh)
    sizes = axis_sizes(mesh)

    def div(axis, dim):
        n = 1
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            n *= sizes[a]
        return dim % n == 0

    dp = tuple(a for a in ("pod", "data") if a in axes)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)

    def rule_for(name, shape):
        if name in ("k", "v", "cross_k", "cross_v"):
            # (..., B, T, K, D)
            B, T, K, D = shape[-4:]
            k_ax = "model" if div("model", K) else None
            seq_ax = None
            if long_context and T > 4096 and div("data", T):
                seq_ax = "data"
            if opt and k_ax is None and div("model", T):
                # O3: flash-decode sequence sharding over the idle axis
                seq_ax = (("data", "model") if seq_ax == "data"
                          and div("model", T // sizes["data"]) else
                          ("model" if seq_ax is None else seq_ax))
            b_ax = dp if (dp and B > 1 and div(dp, B)
                          and seq_ax in (None, "model")) else None
            if b_ax is not None and seq_ax == "model":
                b_ax = tuple(a for a in ("pod", "data")
                             if a in axes and div(a, B)) or None
                if isinstance(b_ax, tuple) and len(b_ax) == 1:
                    b_ax = b_ax[0]
            return (b_ax, seq_ax, k_ax, None)
        if name == "state":                    # (..., B, H, P, N)
            B, H, _, _ = shape[-4:]
            return (dp if (dp and B > 1 and div(dp, B)) else None,
                    "model" if div("model", H) else None, None, None)
        if name == "conv":                     # (..., B, W, C)
            B, _, C = shape[-3:]
            return (dp if (dp and B > 1 and div(dp, B)) else None, None,
                    "model" if div("model", C) else None)
        if name == "pos":
            return (None,)
        return tuple([None] * len(shape))

    def per_leaf(tree, name=""):
        if isinstance(tree, dict):
            return {k: per_leaf(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [per_leaf(v, name) for v in tree]
        if not isinstance(tree, torch.Tensor):
            return None
        rule = rule_for(name, tuple(tree.shape))
        return P(*((None,) * (tree.ndim - len(rule)) + tuple(rule)))

    return per_leaf(caches)


def _locals(tree):
    """Every local tensor of the arguments (a DTensor's shard)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten

    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    out = []
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.nn.Module):
            out += _locals(t)
        elif isinstance(t, torch.Tensor):
            out.append(t.to_local() if isinstance(t, DTensor) else t)
    return out


def _storage_bytes(tensors, skip=()):
    seen, total = set(skip), 0
    for t in tensors:
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def measure(fn, args, mesh, fake_mode, train: bool):
    """Dispatch ``fn(*args)`` under the mesh and record it.  Returns
    (trace, argument bytes, output bytes, seconds)."""
    from torch.distributed.tensor.experimental import implicit_replication

    arg_locals = _locals(list(args))
    grad = torch.enable_grad() if train else torch.no_grad()
    with fake_mode, set_mesh(mesh), implicit_replication(), grad:
        t0 = time.time()
        with DispatchTrace(known=arg_locals) as trace:
            out = fn(*args)
        seconds = time.time() - t0
    arg_keys = {t.untyped_storage()._cdata for t in arg_locals}
    out_bytes = _storage_bytes(_locals(out), skip=arg_keys)
    return trace, _storage_bytes(arg_locals), out_bytes, seconds


def run_case(arch: str, shape_name, multi_pod: bool = False,
             variant: str = "", save: bool = True, opt: bool = False,
             *, mesh=None, reduced: bool = False) -> dict:
    """One (arch x shape) case on the production mesh (or ``mesh``, a
    fake ``DeviceMesh``); ``shape_name`` is a name of ``INPUT_SHAPES`` or
    an ``InputShape``; ``reduced`` takes the arch's and the shape's smoke
    sizes (the tests')."""
    cfg = get_config(arch)
    shape = (INPUT_SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    if reduced:
        cfg, shape = cfg.reduced(), shape.reduced()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_tag = ("pod2x16x16" if multi_pod else "pod16x16") \
        if tuple(mesh.shape) in ((16, 16), (2, 16, 16)) else \
        "pod" + "x".join(str(n) for n in mesh.shape)
    if opt:
        variant = (variant + "+opt").lstrip("+")
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_tag,
           "variant": variant, "status": "ok"}

    if shape.name == "long_500k":
        if arch in LONG_SKIP:
            rec.update(status="skipped", reason=LONG_SKIP[arch])
            if save:
                _save(rec)
            print(f"[skip] {arch} x {shape.name}: {LONG_SKIP[arch]}")
            return rec
        if arch in LONG_SWA_VARIANT:
            cfg = _swa_variant(cfg)
            variant = ("swa+opt" if opt else "swa")
            rec["variant"] = variant
    if variant.startswith("swa") and cfg.sliding_window == 0:
        cfg = _swa_variant(cfg)

    chips = mesh.size()
    runtime_flags.chunked_attention = opt                      # O5
    runtime_flags.shard_ssm_heads = (                          # O6
        opt and os.environ.get("REPRO_SSM_HEADS", "0") == "1")
    try:
        fn, args = plan_entry(cfg, shape, mesh, shared_fake_mode(),
                              opt=opt)
        trace, arg_bytes, out_bytes, t_lower = measure(
            fn, args, mesh, shared_fake_mode(), shape.kind == "train")
    except Exception as e:  # a failure here is a bug in our sharding
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if save:
            _save(rec)
        print(f"[FAIL] {arch} x {shape.name} ({mesh_tag}): {e}")
        return rec
    finally:
        runtime_flags.chunked_attention = False
        runtime_flags.shard_ssm_heads = False

    mem = {"argument_size_bytes": arg_bytes,
           "output_size_bytes": out_bytes,
           "temp_size_bytes": trace.peak_bytes}
    coll = collective_bytes(trace)
    mf = model_flops_estimate(cfg, shape)
    rl = roofline(trace.flops, trace.bytes_accessed, coll.get("total", 0),
                  chips, model_flops=mf)
    rec.update(
        lower_s=round(t_lower, 2), compile_s=0.0, chips=chips,
        memory_analysis=mem,
        cost_analysis={"flops": trace.flops,
                       "bytes_accessed": trace.bytes_accessed},
        flops_accounting="counted",
        collective_bytes=coll, collective_counts=collective_counts(trace),
        roofline=rl.row(),
    )
    per_dev_gb = (mem["argument_size_bytes"]
                  + mem["temp_size_bytes"]) / 2**30
    rec["per_device_gb"] = round(per_dev_gb, 3)
    print(f"[ok] {arch} x {shape.name} ({mesh_tag}"
          f"{'/' + variant if variant else ''}): dispatch {t_lower:.1f}s, "
          f"{per_dev_gb:.2f} GiB/dev, dominant={rl.dominant}, "
          f"terms=({rl.compute_s:.4f}, {rl.memory_s:.4f}, "
          f"{rl.collective_s:.4f})s, useful={rl.useful_flops_ratio:.2f}")
    if save:
        _save(rec)
    return rec


def _save(rec):
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    tag = "__".join(x for x in (rec["arch"], rec["shape"], rec["mesh"],
                                rec.get("variant", "")) if x)
    (ARTIFACTS / f"{tag}.json").write_text(json.dumps(rec, indent=2))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="", choices=["", "swa"])
    ap.add_argument("--opt", action="store_true",
                    help="beyond-paper serving optimizations (§Perf)")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) for the chosen mesh")
    args = ap.parse_args()

    if args.all:
        failures = 0
        for arch in sorted(ARCHS):
            for shape in SHAPES:
                rec = run_case(arch, shape, args.multi_pod, opt=args.opt)
                failures += rec["status"] == "error"
        raise SystemExit(1 if failures else 0)

    if not args.arch or not args.shape:
        raise SystemExit("need --arch and --shape (or --all)")
    rec = run_case(args.arch, args.shape, args.multi_pod, args.variant,
                   opt=args.opt)
    raise SystemExit(1 if rec["status"] == "error" else 0)


if __name__ == "__main__":
    main()
