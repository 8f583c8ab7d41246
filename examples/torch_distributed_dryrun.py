"""Distributed dry-run walk-through on the PyTorch port: one (arch x
shape) on the production mesh, showing everything the launcher derives
automatically.

    PYTHONPATH=src python examples/torch_distributed_dryrun.py [arch] \\
        [shape] [--multi-pod] [--opt]

Runs as a process of its own: the fake 256- or 512-rank process group of
the production mesh is process-global.  Nothing is allocated and no
kernel is launched; the numbers are rank 0's local shards, and the
roofline terms are modelled from the H100 data sheet, not measured.
"""

import sys

sys.path.insert(0, "src")

from repro_torch.launch.dryrun import run_case  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.utils.roofline import CARD  # noqa: E402

args = [a for a in sys.argv[1:] if not a.startswith("--")]
arch = args[0] if args else "h2o-danube-3-4b"
shape = args[1] if len(args) > 1 else "decode_32k"
multi_pod = "--multi-pod" in sys.argv
opt = "--opt" in sys.argv

mesh = make_production_mesh(multi_pod=multi_pod)
print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
      f"({mesh.size()} cards)\n")

rec = run_case(arch, shape, multi_pod, opt=opt, save=False, mesh=mesh)
if rec["status"] != "ok":
    raise SystemExit(rec)

print("\nmemory_analysis (per device):")
for k, v in rec["memory_analysis"].items():
    print(f"  {k:38s} {v/2**30:10.3f} GiB")
print(f"  {'per_device_gb (arguments + temp)':38s} "
      f"{rec['per_device_gb']:10.3f} GiB of 80 GB")
print("\ncollective schedule (per-device bytes by op):")
for k, v in sorted(rec["collective_bytes"].items()):
    print(f"  {k:20s} {v/2**20:12.2f} MiB  "
          f"(x{rec['collective_counts'].get(k, 0)} ops)")
rl = rec["roofline"]
print(f"\nroofline ({CARD}, data sheet): compute {rl['compute_s']:.4f}s | "
      f"memory {rl['memory_s']:.4f}s | collective {rl['collective_s']:.4f}s "
      f"-> {rl['dominant']}-bound")
print(f"useful FLOPs ratio (6·N_active·D / counted): "
      f"{rl['useful_flops_ratio']:.2f}")
