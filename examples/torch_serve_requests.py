"""Serving driver of the PyTorch port: batched requests through the round
engine with the paper's §3.3 greedy memory admission (the twin of
``examples/serve_requests.py``).

    python3 examples/torch_serve_requests.py [arch]                # card
    python3 examples/torch_serve_requests.py [arch] --device cpu   # CPU
    python3 examples/torch_serve_requests.py --ckpt DIR            # weights

A deliberately tight KV budget forces the admission controller to split
the request wave into memory-safe rounds: watch the round structure and
slab-pool reuse in the output.  The weights are random, from
``torch.Generator`` seed 0, unless ``--ckpt`` names an npz checkpoint in
the JAX package's layout (``training.checkpoint``; either package writes
it), which makes the streams comparable with the JAX example's.  The
card is the default; without one the script raises unless ``--device
cpu`` is given, and its report names the device it ran on.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime.config import EngineConfig  # noqa: E402
from repro_torch.runtime.engine import Request, ServingEngine  # noqa: E402
from repro_torch.runtime.kv_cache import request_peak_bytes  # noqa: E402
from repro_torch.training.checkpoint import load_checkpoint  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="h2o-danube-3-4b")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ckpt", default=None,
                    help="npz checkpoint directory to take the weights from")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    api = build_model(cfg, device=args.device)
    device = api.device
    params = api.init(torch.Generator(device=device).manual_seed(0))
    if args.ckpt:
        load_checkpoint(args.ckpt, cfg, params)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}")

    per_req = request_peak_bytes(cfg, 48)
    budget = int(per_req * 3.2 / 0.6)   # roughly 3 concurrent requests fit
    print(f"arch={args.arch}: per-request peak {per_req/1024:.1f} KiB, "
          f"budget {budget/1024:.1f} KiB (margin 40%) -> "
          "expect ~3-wide admission rounds\n")

    engine = ServingEngine(api, params, device=device, config=EngineConfig(
        hbm_budget=budget, max_batch=6, max_context=None))
    rng = np.random.default_rng(0)
    for i in range(9):
        engine.submit(Request(
            id=i, prompt=rng.integers(0, cfg.vocab_size, 16).astype(np.int32),
            max_new_tokens=32))

    t0 = time.time()
    done = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    for rid in sorted(done):
        c = done[rid]
        print(f"req {rid}: {len(c.tokens)} tokens, first 6 = {c.tokens[:6]}")
    print(f"\n{len(done)}/9 requests in {time.time()-t0:.2f}s")
    print(f"peak cache {engine.kv.peak_bytes/1024:.1f} KiB <= "
          f"budget {engine.kv.budget/1024:.1f} KiB  "
          f"(slab reuses: {engine.kv.pool.reuse_count})")
    if engine.kv.peak_bytes > engine.kv.budget:
        raise AssertionError("admission violated!")
    print("memory-budget admission held: no OOM possible (paper §3.3)")
    return done


if __name__ == "__main__":
    main()
