"""The comparison that decides ``correct``, against the fp32 reference.

What is compared depends on the answers a traffic driver collects: the
driver (``drivers/<name>.py``) names the reference's inputs, the
per-answer comparison and the summary numbers (see :mod:`driving`).
This module holds the arithmetic they share and runs the reference:

* :func:`logit_errors` — ||program - reference|| / ||reference|| over
  the vocabulary, and max |program - reference| in units of the
  reference's RMS;
* :func:`gaps` — how far a token's reference logit lies below the
  reference's best, in units of that position's reference standard
  deviation (0 where they agree).

Besides the program's numbers, the same numbers of two variants of the
reference put in the program's place: the control (``fp8``: every
served-dtype weight matrix rounded to float8 e4m3), which has to fail,
and the witness (``bf16``: activations rounded to bf16 where the served
model holds them), which shows what bf16 rounding alone does.
"""

from __future__ import annotations

import torch

from reference import model


def logit_errors(prog, ref) -> "tuple[float, float]":
    p, r = prog.float().cpu(), ref.float().cpu()
    d = p - r
    rms = r.square().mean().sqrt()
    return (float(d.norm() / r.norm()), float(d.abs().max() / rms))


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(n,) reference gap of ``tokens`` at each of ref's n rows."""
    ref = ref.float()
    picked = ref.gather(1, tokens.to(ref.device).long()[:, None])[:, 0]
    return ((ref.max(-1).values - picked) / ref.std(-1)).cpu()


def served_positions(prompt, served):
    """The sequence the served tokens were produced from and the
    positions whose logits produced them."""
    prompt = torch.as_tensor(prompt, dtype=torch.long)
    served = torch.as_tensor(served, dtype=torch.long)
    seq = torch.cat([prompt, served[:-1]])
    pos = torch.arange(len(prompt) - 1, len(seq))
    return seq, pos


def reference_logits(run_cfg, seed, record, driver, device, quant=None,
                     margins=None):
    seqs, pos = driver.reference_inputs(record)
    return model.logits(run_cfg, seed, seqs, pos, device, quant=quant,
                        margins=margins)


def numbers(run_cfg, seed, record, driver, device, ref=None) -> dict:
    """The cell's compared numbers for the program's outputs."""
    if ref is None:
        ref = reference_logits(run_cfg, seed, record, driver, device)
    return driver.summary(record, driver.items(record, ref))


def control_numbers(run_cfg, seed, record, driver, device,
                    ref=None) -> dict:
    """The same numbers for the control put in the program's place,
    read at the same inputs (for served tokens, by the token the control
    ranks first)."""
    if ref is None:
        ref = reference_logits(run_cfg, seed, record, driver, device)
    other = reference_logits(run_cfg, seed, record, driver, device,
                             quant="fp8")
    return driver.summary(record, driver.control_items(record, ref, other))
