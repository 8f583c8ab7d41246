"""JAX side of the port's distributed tests (NOT a pytest file).

Runs with ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (the
parent sets it) so JAX sees four CPU devices:

    python jax_dist_child.py moe_ep <in.npz> <out.npz>
        ``repro.models.moe.moe_ep`` on meshes (1, 4) and (2, 2) for every
        case of <in.npz>: outputs, aux loss and the (token, choice) pairs
        the a2a regime drops (JAX's cumsum rule on each rank's tokens).
    python jax_dist_child.py args <out.json> <arch:shape> ...
        ``argument_size_in_bytes`` of JAX's dry-run ``plan_entry`` with
        ``opt=True`` on a (2, 2) mesh, reduced config and shape, beside
        the local bytes of every input leaf and of those the step never
        reads.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

assert len(jax.devices()) == 4, jax.devices()


def _mesh(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def moe_ep(src, out):
    from repro.configs import get_config
    from repro.models.moe import moe_ep, route

    data = np.load(src)
    res = {}
    for case in [k[2:] for k in data.files if k.startswith("x_")]:
        cf = float(data[f"cf_{case}"])
        cfg = get_config("dbrx-132b").reduced()
        cfg = dataclasses.replace(
            cfg, dtype="float32", moe=dataclasses.replace(
                cfg.moe, num_experts=8, num_experts_per_tok=2,
                capacity_factor=cf))
        p = {k: jnp.asarray(data[f"p_{k}"])
             for k in ("router", "w_gate", "w_up", "w_down")}
        x = jnp.asarray(data[f"x_{case}"])
        for tag, shape in (("1x4", (1, 4)), ("2x2", (2, 2))):
            mesh = _mesh(shape)
            with jax.sharding.set_mesh(mesh):
                y, aux = jax.jit(lambda p, x: moe_ep(p, cfg, x, mesh))(p, x)
            res[f"y_{case}_{tag}"] = np.asarray(y)
            res[f"aux_{case}_{tag}"] = np.float32(aux)
            # the a2a regime's drops: each rank routes its token block
            m = cfg.moe
            T, n = x.shape[0], 4
            drops, clobbered = 0, []
            if T % n == 0 and T // n >= 8:
                T_loc, k = T // n, m.num_experts_per_tok
                E_loc = m.num_experts // shape[1]
                kcap = int(max(1, T_loc * k * m.capacity_factor
                               // shape[1]))
                for r in range(n):
                    _, idx, _ = route(p, cfg, x[r * T_loc:(r + 1) * T_loc])
                    dest = np.asarray(idx).reshape(-1) // E_loc
                    onehot = np.eye(shape[1], dtype=np.int64)[dest]
                    pos = (np.cumsum(onehot, 0) * onehot).sum(-1) - 1
                    drops += int((pos >= kcap).sum())
                    # JAX's send_meta.at[di, pi].set(...) writes -1 for
                    # every dropped pair to slot (0, 0): when the last of
                    # them comes after the pair kept there, that pair is
                    # lost too (its token's output misses it)
                    dropped = np.nonzero(pos >= kcap)[0]
                    first0 = np.nonzero(dest == 0)[0]
                    if len(dropped) and len(first0) \
                            and dropped[-1] > first0[0]:
                        clobbered.append(r * T_loc + first0[0] // k)
            res[f"drop_{case}_{tag}"] = np.float32(drops)
            res[f"clobbered_{case}_{tag}"] = np.array(clobbered, np.int64)
    np.savez(out, **res)


def args(out, cases):
    from repro.configs import INPUT_SHAPES, get_config
    from repro.launch.dryrun import plan_entry

    mesh = _mesh((2, 2))
    res = {}
    for c in cases:
        arch, shape = c.split(":")
        cfg = get_config(arch).reduced()
        shp = INPUT_SHAPES[shape].reduced()
        with jax.sharding.set_mesh(mesh):
            fn, a, in_sh, out_sh, donate = plan_entry(cfg, shp, mesh,
                                                      opt=True)
            compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                               donate_argnums=donate).lower(*a).compile()
        # every input leaf's local bytes, and those of the leaves the
        # step never reads (XLA drops them from its arguments)
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        leaves = jax.tree.leaves(a)
        specs = jax.tree.leaves(in_sh, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        local = []
        for leaf, spec in zip(leaves, specs):
            shape = list(leaf.shape)
            for d, e in enumerate(spec):
                for ax in (() if e is None else
                           (e,) if isinstance(e, str) else e):
                    shape[d] //= sizes[ax]
            local.append(int(np.prod(shape)) * leaf.dtype.itemsize)
        from jax._src.interpreters import partial_eval as pe
        jaxpr = jax.make_jaxpr(fn)(*a).jaxpr
        _, used = pe.dce_jaxpr(jaxpr, [True] * len(jaxpr.outvars))
        dead = sum(b for u, b in zip(used, local) if not u)
        res[c] = {"xla": int(compiled.memory_analysis()
                             .argument_size_in_bytes),
                  "leaves": sum(local), "dead": dead}
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    if sys.argv[1] == "moe_ep":
        moe_ep(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "args":
        args(sys.argv[2], sys.argv[3:])
    else:
        raise SystemExit(f"unknown mode {sys.argv[1]!r}")
