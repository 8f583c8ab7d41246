"""Child processes for the port's distributed tests (NOT a pytest file).

A process has one default process group, so every test that needs one
runs here:

    python torch_dist_child.py trace
        a fake 4-rank group, a 2x2 mesh: one collective of each kind under
        ``utils.hlo.DispatchTrace``; prints {"bytes", "counts", "ops",
        "expected"} as JSON on the last line.
    python torch_dist_child.py moe_ep <rank> <world> <port> <in.npz> <out>
        one rank of a gloo group: ``models.moe.moe_ep`` on meshes (1, 4)
        and (2, 2), every case of <in.npz>, and a reduced mamba2-370m
        ``mamba_block`` with ``runtime_flags.shard_ssm_heads`` off and on
        (:func:`ssm_heads`); rank 0 writes <out>.npz.
    python torch_dist_child.py mesh_decode <cpu|cuda>
        a one-rank mesh (gloo on the CPU, NCCL on the card): one decode
        step of reduced stablelm-3b and whisper-tiny with DTensor params
        and caches, against the same step off the mesh; prints {arch:
        {"err", "launches", "mesh_calls", "layers"}} as JSON on the last
        line (``mesh_calls``: calls of ``attention.decode_on_shards``).
    python torch_dist_child.py dryrun <out.json> <arch:shape[:opt]> ...
        a fake 4-rank group, a 2x2 mesh: ``launch.dryrun.run_case`` on the
        reduced configs; writes the records to <out.json>.
"""

import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)


def trace():
    import torch.distributed._functional_collectives as funcol

    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.utils.hlo import (DispatchTrace, collective_bytes,
                                       collective_counts, op_histogram)

    mesh = make_fake_mesh((2, 2), ("data", "model"))
    g = (mesh, 1)
    x = torch.ones(16, 1024, dtype=torch.bfloat16)
    with DispatchTrace() as tr:
        a = funcol.all_gather_tensor(x, 0, g)                # (32, 1024)
        b = funcol.all_reduce(torch.ones(256), "sum", g)      # f32[256]
        c = funcol.reduce_scatter_tensor(x[:8, :512].contiguous(), "sum",
                                         0, g)                # (4, 512)
        d = funcol.all_to_all_single(torch.ones(8, 2), None, None, g)
        for t in (a, b, c, d):
            funcol.wait_tensor(t)
        torch.ones(3) + 1
    print(json.dumps({
        "bytes": collective_bytes(tr), "counts": collective_counts(tr),
        "ops": dict(op_histogram(tr, 50)),
        "expected": {"all-gather": 32 * 1024 * 2, "all-reduce": 256 * 4,
                     "reduce-scatter": 4 * 512 * 2,
                     "all-to-all": 8 * 2 * 4}}))


def moe_ep(rank, world, port, src, out):
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.bridge import load_arrays
    from repro_torch.models.moe import MoE, moe_ep
    from repro_torch.models.sharding import psum

    data = np.load(src)
    make_host_mesh(backend="gloo", init_method=f"tcp://localhost:{port}",
                   rank=rank, world_size=world)
    meshes = {"1x4": init_device_mesh("cpu", (1, 4),
                                      mesh_dim_names=("data", "model")),
              "2x2": init_device_mesh("cpu", (2, 2),
                                      mesh_dim_names=("data", "model"))}
    results = {}
    for case in [k[2:] for k in data.files if k.startswith("x_")]:
        cf = float(data[f"cf_{case}"])
        cfg = get_config("dbrx-132b").reduced()
        cfg = dataclasses.replace(
            cfg, dtype="float32", moe=dataclasses.replace(
                cfg.moe, num_experts=8, num_experts_per_tok=2,
                capacity_factor=cf))
        p = MoE(cfg, None, "cpu", torch.float32)
        load_arrays(p, {k: data[f"p_{k}"] for k in
                        ("router", "w_gate", "w_up", "w_down")})
        x = torch.tensor(data[f"x_{case}"])
        for tag, mesh in meshes.items():
            stats = {}
            y, aux = moe_ep(p, cfg, x, mesh, stats=stats)
            dropped = psum(stats["dropped"].float(), mesh,
                           mesh.mesh_dim_names)
            results[f"y_{case}_{tag}"] = y.numpy()
            results[f"aux_{case}_{tag}"] = np.float32(aux)
            results[f"drop_{case}_{tag}"] = np.float32(dropped)
            results[f"regime_{case}_{tag}"] = np.array(stats["regime"])
    for tag, mesh in meshes.items():
        ssm_heads(mesh, tag, results)
    if rank == 0:
        np.savez(out, **results)
    torch.distributed.destroy_process_group()


def ssm_heads(mesh, tag, results):
    """A reduced mamba2-370m ``mamba_block`` (fp32, seeded alike on every
    rank) with params and batch as DTensors on ``mesh``, the flag off and
    on, against the block off the mesh.  Records each run's output and
    the heads its ``ssd_scan`` call was given on this rank."""
    import dataclasses

    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.models import runtime_flags, ssm
    from repro_torch.models.sharding import set_mesh
    from repro_torch.utils.sharding import (P, distribute, param_pspecs,
                                            shard_module)

    cfg = dataclasses.replace(get_config("mamba2-370m").reduced(),
                              dtype="float32")
    gen = torch.Generator().manual_seed(7)
    p = ssm.Mamba(cfg, gen, "cpu", torch.float32)
    x = torch.randn((2, 4 * cfg.ssm.chunk, cfg.d_model), generator=gen)
    heads = []
    scan = ssm.ssd_scan

    def counted(xs, *a, **k):
        heads.append(xs.shape[2])
        return scan(xs, *a, **k)
    ssm.ssd_scan = counted
    try:
        with torch.no_grad():
            results[f"ssm_y_{tag}"] = ssm.mamba_block(p, cfg, x).numpy()
            shard_module(p, param_pspecs(p, mesh), mesh)
            dx = distribute(x, P("data", None, None), mesh)
            for flag in (False, True):
                heads.clear()
                runtime_flags.shard_ssm_heads = flag
                with set_mesh(mesh), implicit_replication():
                    y = ssm.mamba_block(p, cfg, dx)
                y = y.full_tensor() if isinstance(y, DTensor) else y
                on = "on" if flag else "off"
                results[f"ssm_y_{on}_{tag}"] = y.numpy()
                results[f"ssm_heads_{on}_{tag}"] = np.array(heads)
    finally:
        runtime_flags.shard_ssm_heads = False
        ssm.ssd_scan = scan
    results[f"ssm_H_{tag}"] = np.int64(p.A_log.shape[0])


def mesh_decode(device):
    import dataclasses

    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (launches,
                                                      reset_launches)
    from repro_torch.launch.dryrun import _zip_tensors, cache_pspecs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention, build_model
    from repro_torch.models.sharding import set_mesh
    from repro_torch.utils.sharding import (P, distribute, param_pspecs,
                                            shard_module)

    mesh = make_host_mesh(backend="nccl" if device == "cuda" else "gloo")
    calls = []
    on_shards = attention.decode_on_shards

    def counted(*a, **k):
        calls.append(1)
        return on_shards(*a, **k)
    attention.decode_on_shards = counted
    B, T, n = 2, 32, 20
    results = {}
    for arch in ("stablelm-3b", "whisper-tiny"):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        gen = torch.Generator(device=device).manual_seed(0)
        api = build_model(cfg, device=device, distributed=True, mesh=mesh)
        params = api.init(gen)
        caches = api.init_caches(B, T)

        def filled(t, _):
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen, device=device))
            elif t.ndim == 1 and t.shape[0] == T:         # a self cache's pos
                t.copy_(torch.where(torch.arange(T, device=device) < n,
                                    torch.arange(T, device=device), -1))
            return t
        _zip_tensors(caches, caches, filled)
        twin = _zip_tensors(caches, caches, lambda t, _: t.clone())
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, 1),
                                         generator=gen, device=device,
                                         dtype=torch.int32),
                 "cache_len": torch.tensor(n, dtype=torch.int32,
                                           device=device)}
        with torch.no_grad():
            want, _ = api.decode_fn(params, twin, batch)
            shard_module(params, param_pspecs(params, mesh), mesh)
            specs = cache_pspecs(caches, mesh, long_context=False)
            caches = _zip_tensors(caches, specs,
                                  lambda t, s: distribute(t, s, mesh))
            dbatch = {k: distribute(v, P(*[None] * v.ndim), mesh)
                      for k, v in batch.items()}
            reset_launches()
            calls.clear()
            with set_mesh(mesh), implicit_replication():
                got, _ = api.decode_fn(params, caches, dbatch)
            if device == "cuda":
                torch.cuda.synchronize()
        launched = launches["decode_attention"]
        if isinstance(got, DTensor):
            got = got.full_tensor()
        results[arch] = {"err": (got - want).abs().max().item(),
                         "launches": launched, "mesh_calls": len(calls),
                         "layers": cfg.num_layers}
    print(json.dumps(results))
    torch.distributed.destroy_process_group()


def dryrun(out, cases):
    from repro_torch.launch.dryrun import run_case
    from repro_torch.launch.mesh import make_fake_mesh

    mesh = make_fake_mesh((2, 2), ("data", "model"))
    recs = []
    for c in cases:
        arch, shape, *opt = c.split(":")
        recs.append(run_case(arch, shape, save=False, opt=bool(opt),
                             mesh=mesh, reduced=True))
    with open(out, "w") as f:
        json.dump(recs, f)


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "trace":
        trace()
    elif mode == "moe_ep":
        moe_ep(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
               sys.argv[5], sys.argv[6])
    elif mode == "mesh_decode":
        mesh_decode(sys.argv[2])
    elif mode == "dryrun":
        dryrun(sys.argv[2], sys.argv[3:])
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    sys.stdout.flush()
    os._exit(0)
