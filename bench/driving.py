"""What every traffic driver shares: the port built from the seed, the
benchmark's own host spans, and the seeded sample of compared answers.

A driver is ``drivers/<name>.py``, found by the ``driver`` key of a
traffic file (:func:`harness.load_driver`).  It provides:

* ``run(api, params, dm, traffic, seed, seconds, spans, window)`` — set
  up the entry point it drives, warm every shape the mix uses, measure
  for ``seconds`` inside ``window()``, and return a record of plain
  numbers and host arrays (so the program's state is dropped when it
  returns, before the reference runs).  The record has ``kind`` (the
  driver's name), ``window_s``, ``attempted``, ``failed`` and
  ``check`` (the sampled answers), and may carry ``spans``: more host
  spans (name, start_ns, end_ns on the epoch clock) to label idle gaps,
  and ``about``: a few words for the run's line on standard error;
* ``reference_inputs(record)`` — for each compared answer, the token
  sequence the reference runs whole and the positions whose logits it
  returns;
* ``items(record, ref)`` and ``control_items(record, ref, other)`` —
  per compared answer, what is compared: the program's answers, or
  another precision's logits at the same positions, held against the
  reference's;
* ``summary(record, items)`` — the compared numbers, by name, each
  with a limit in ``limits/<workload>.json``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np

import stack


class Spans:
    """The benchmark's own host spans (epoch ns, the profiler's clock)
    around its calls into the program; off unless tracing."""

    def __init__(self, on: bool):
        self.on = on
        self.events: "list[tuple[str, int, int]]" = []

    @contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.events.append((name, t0, time.time_ns()))


def port_config(run: dict):
    """The port's ``ModelConfig`` for a configuration's ``"run"``."""
    from repro_torch.configs import ModelConfig, MoEConfig, SSMConfig

    kw = {k: v for k, v in run.items() if k not in ("moe", "ssm")}
    return ModelConfig(moe=MoEConfig(**run.get("moe", {})),
                       ssm=SSMConfig(**run.get("ssm", {})), **kw)


def build(run: dict, seed: int, device):
    """The port's model API and its parameters, filled from the seed."""
    from repro_torch.models import build_model

    dm = stack.Dims(run)
    api = build_model(port_config(run), device=device)
    params = api.init(None)           # zeros, filled in place below
    stack.fill(params, dm, seed, device)
    return api, params


def sample(seed: int, n_items: int, n: int, longest: int) -> "list[int]":
    """``n`` item indices drawn from the seed, ``longest`` among them."""
    rest = [i for i in range(n_items) if i != longest]
    rng = np.random.default_rng([seed, 3])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return sorted([longest] + [rest[j] for j in pick])
