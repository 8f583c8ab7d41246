"""Readings that the limits of ``correct`` are set from (on the card).

    python3 bench/calibrate.py --workload <name> --seconds <s> \
        --seeds <n> ... [--control-seeds <n> ...]

For every seed, one run of the cell as ``run.py`` makes it (window of
``--seconds``), printing the compared numbers of the program and, per
compared answer, its error beside the reference's smallest router
margin there (the look at near-tied routing).  For each control seed,
also the same numbers of two variants of the reference put in the
program's place on the same inputs (for a served model, at the same
prompts and served tokens, read by the token the variant ranks first):
the control, every served-dtype weight rounded to float8 e4m3 (one
scale an output channel), and the witness, activations rounded to bf16
where the served model holds them, with each answer's error for the
look.  One JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

import harness  # noqa: E402
import run  # noqa: E402


def _look(record, per, margins):
    """Each compared answer's error beside its smallest router margin
    (and, for a document, its length); for a row of served tokens, its
    mean gap where every layer's margin exceeds 0.1 and where one does
    not."""
    out = []
    for c, item, m in zip(record["check"], per, margins):
        if isinstance(item, tuple):
            out.append([len(c["tokens"]), round(item[0], 5),
                        round(item[1], 4),
                        None if m is None else round(float(m.min()), 4)])
        else:
            tied = m <= 0.1
            out.append([round(float(item.mean()), 5),
                        round(float(item[~tied].mean()), 5)
                        if (~tied).any() else None,
                        round(float(item[tied].mean()), 5)
                        if tied.any() else None,
                        int(tied.sum()), len(item)])
    return out


def _rounded(per):
    return [[round(x, 5) for x in e] if isinstance(e, tuple)
            else round(float(e.mean()), 5) for e in per]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=())
    args = p.parse_args(argv)
    root = harness.checkout_root()
    harness.setup_environment(root)
    import torch

    from reference import compare

    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 3
    cell = harness.cell(root, args.workload)
    cfg, driver = cell["config"]["run"], cell["driver"]
    for seed in args.seeds:
        result, lines, record = run.run_cell(
            root, args.workload, seed, args.seconds, False, "cuda",
            look=True)
        per, margins, ref = record["look"]
        print("\n".join(lines), file=sys.stderr, flush=True)
        print(json.dumps({"seed": seed, "side": "program",
                          "attempted": result["attempted"],
                          **{k: v["value"] for k, v in
                             result["checks"].items()},
                          **{k: v["value"] for k, v in
                             result["metrics"].items()}}), flush=True)
        print(json.dumps({"seed": seed, "side": "look",
                          "items": _look(record, per, margins)}),
              flush=True)
        if seed in args.control_seeds:
            for side, quant in (("control", "fp8"), ("witness", "bf16")):
                other = compare.reference_logits(cfg, seed, record, driver,
                                                 "cuda", quant=quant)
                items = driver.control_items(record, ref, other)
                del other
                print(json.dumps({"seed": seed, "side": side,
                                  **driver.summary(record, items),
                                  "items": _rounded(items)}), flush=True)
        del record, ref, per
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
