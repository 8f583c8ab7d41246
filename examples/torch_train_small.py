"""Train a small LM for a few hundred steps on the synthetic pipeline,
then round-trip a checkpoint (the twin of ``examples/train_small.py``).

    python3 examples/torch_train_small.py [steps]                # on the card
    python3 examples/torch_train_small.py [steps] --device cpu   # plain PyTorch

Uses the reduced stablelm-3b config (fp32, 2 layers, d_model 256, vocab
512; the full config trains through ``python -m repro_torch.launch.train
--full``).  Loss should fall from ~ln(512) = 6.2 to ~2 within 100 steps
on the synthetic n-gram stream; the script asserts it falls below 0.7x
its first value.  Then it restores the checkpoint (written in the JAX
package's npz layout, into a temporary directory unless ``--ckpt`` is
given) into a freshly initialised model and optimizer state and checks
that parameters, fp32 masters, moments and step come back bit for bit.

The card is the default; without one the script raises unless
``--device cpu`` is given.
"""

import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import OptConfig, init_opt_state  # noqa: E402
from repro_torch.training.checkpoint import load_checkpoint  # noqa: E402

ARCH = "stablelm-3b"


def round_trip(ckpt, device, params, opt_state):
    """Restore ``ckpt`` into a fresh model and optimizer state; raise
    unless everything equals the trained ``params`` / ``opt_state`` bit
    for bit.  Returns the checkpoint's meta."""
    cfg = get_config(ARCH).reduced()
    api = build_model(cfg, device=device)
    fresh = api.init(torch.Generator(device=api.device).manual_seed(1))
    state = init_opt_state(fresh, OptConfig())
    fresh, state, meta = load_checkpoint(ckpt, cfg, fresh, state)
    trained = dict(params.named_parameters())
    for name, p in fresh.named_parameters():
        if not torch.equal(p, trained[name]):
            raise AssertionError(f"checkpoint round trip: param {name}")
        for k in ("master", "m", "v"):
            if not torch.equal(state[k][name], opt_state[k][name]):
                raise AssertionError(f"checkpoint round trip: {k} {name}")
    if int(state["step"]) != int(opt_state["step"]):
        raise AssertionError("checkpoint round trip: step")
    return meta


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", type=int, nargs="?", default=200)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one)")
    args = ap.parse_args(argv)

    final = {}

    def keep(step, params, opt_state, metrics):
        final.update(params=params, opt_state=opt_state)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = args.ckpt or tmp
        losses = train(ARCH, steps=args.steps, batch=8, seq=64,
                       reduced=True, lr=3e-3, ckpt=ckpt,
                       device=args.device, on_step=keep)
        print(f"\nfinal: {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"({100 * (1 - losses[-1] / losses[0]):.0f}% reduction) on "
              f"{final['params'].embed.device}")
        if not losses[-1] < losses[0] * 0.7:
            raise AssertionError("training failed to learn")
        print("checkpoint round-trip check:")
        meta = round_trip(ckpt, args.device, **final)
    print(f"restored step={meta['step']} final_loss={meta['final_loss']:.3f}"
          f"; params, masters, moments and step bit-identical")
    return losses


if __name__ == "__main__":
    main()
