"""Training entry point.

Port of ``repro.launch.train``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
        --steps 100 [--full] [--batch 8] [--seq 128] [--ckpt out/] \\
        [--device cuda]

Random weights from seed 0, the synthetic n-gram stream
(``data.SyntheticTokens``), AdamW on fp32 masters with a linear warmup
of ``min(20, steps // 5 + 1)`` steps, one train step a batch, and an
optional npz checkpoint in the JAX package's layout at the end.
``--reduced`` (the default) trains the arch's smoke config; ``--full``
its published widths.  An encoder-decoder arch (whisper) gets stub
audio frames (``models.stub_audio_frontend``, ``cfg.encoder_seq`` of
them) beside each batch, which the JAX entry point does not supply.
``--device`` defaults to ``cuda`` and the run fails without a card
unless ``--device cpu`` is given.  The JAX entry point shards over a
mesh; the port trains on one device.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import SyntheticTokens, to_device
from repro_torch.models import build_model, stub_audio_frontend
from repro_torch.training import OptConfig, init_opt_state, make_train_step
from repro_torch.training.checkpoint import save_checkpoint


def train(arch: str, steps: int = 100, batch: int = 8, seq: int = 128,
          reduced: bool = True, lr: float = 3e-3, ckpt: "str | None" = None,
          log_every: int = 10, seed: int = 0, device=None, on_step=None):
    """Train ``arch`` for ``steps`` steps; returns the losses.

    ``on_step(step, params, opt_state, metrics)``, if given, runs after
    every step with the metrics as Python floats (``seconds``: the step's
    wall time, ended by reading the loss back)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    api = build_model(cfg, device=device)
    gen = torch.Generator(device=api.device).manual_seed(seed)
    params = api.init(gen)
    opt_cfg = OptConfig(lr=lr, warmup_steps=min(20, steps // 5 + 1))
    opt_state = init_opt_state(params, opt_cfg)
    step_fn = make_train_step(api, opt_cfg)

    data = SyntheticTokens(cfg.vocab_size, seq, batch, seed=seed)
    losses = []
    t0 = time.time()
    for step, host_batch in zip(range(steps), data):
        t_step = time.perf_counter()
        batch_arrays = to_device(host_batch, api.device)
        if cfg.is_encoder_decoder:
            batch_arrays["frames"] = stub_audio_frontend(
                gen, cfg, batch, cfg.encoder_seq)
        params, opt_state, metrics = step_fn(params, opt_state,
                                             batch_arrays)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["seconds"] = time.perf_counter() - t_step
        losses.append(metrics["loss"])
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:4d}  loss {metrics['loss']:7.4f}  "
                  f"grad_norm {metrics['grad_norm']:8.3f}  "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if on_step is not None:
            on_step(step, params, opt_state, metrics)
    if ckpt:
        save_checkpoint(ckpt, cfg, params, opt_state, step=steps,
                        metadata={"arch": arch, "final_loss": losses[-1]})
        print(f"checkpoint written to {ckpt}")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the run fails without a card "
                         "unless 'cpu' is given")
    args = ap.parse_args(argv)
    losses = train(args.arch, args.steps, args.batch, args.seq,
                   args.reduced, args.lr, args.ckpt, device=args.device)
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} on "
          f"{torch.device(args.device)}")
    return losses


if __name__ == "__main__":
    main()
