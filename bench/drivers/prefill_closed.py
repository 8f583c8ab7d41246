"""One client, closed loop: documents back to back through
``api.prefill_fn``, B = 1, each returning its last position's logits
(its time to first token).

Traffic keys: ``length`` = {lo, hi, multiple, strata}.  The lengths are
``strata`` quantiles of a log-uniform law on [lo, hi], rounded to
``multiple``; a seed replays consecutive random permutations of that
set, so every seed does the same work in another order.  Token ids are
uniform over the vocabulary.

Compared answers: one document of each length in the window, drawn from
the seed (so the longest is among them and each length stratum has its
answer).  Each is held against the reference by two errors of its
logits (:func:`reference.compare.logit_errors`).  The compared numbers
are the lower quartile of each error over the shorter half of the
lengths and over the longer half, apart: a routing decision tied to
within bf16's rounding flips some documents' answers whole, and the
lower quartile stands a flip in up to five of a half's eight documents,
while a fault that every document of a half shows (say, every document
over 4096 tokens) moves that half's number (the look is in PERF.md).
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from reference import compare


def doc_lengths(traffic: dict) -> "list[int]":
    lo, hi = traffic["length"]["lo"], traffic["length"]["hi"]
    n, mult = traffic["length"]["strata"], traffic["length"]["multiple"]
    out = []
    for i in range(n):
        x = lo * (hi / lo) ** ((i + 0.5) / n)
        out.append(int(min(hi, max(lo, mult * round(x / mult)))))
    return out


def doc_order(traffic: dict, seed: int, count: int) -> "list[int]":
    """The first ``count`` document lengths of the seed's replay."""
    lengths = doc_lengths(traffic)
    rng = np.random.default_rng([seed, 1])
    out = []
    while len(out) < count:
        out += [lengths[j] for j in rng.permutation(len(lengths))]
    return out[:count]


def doc_tokens(seed: int, i: int, length: int, vocab: int) -> np.ndarray:
    return np.random.default_rng([seed, 2, i]).integers(
        0, vocab, length).astype(np.int32)


def halves(traffic: dict) -> "tuple[set, set]":
    """The shorter and the longer half of the mix's distinct lengths."""
    lengths = sorted(set(doc_lengths(traffic)))
    return set(lengths[:len(lengths) // 2]), set(lengths[len(lengths) // 2:])


def check_sample(seed: int, lengths: "list[int]") -> "list[int]":
    """One document index of each distinct length, drawn from the
    seed, in the order of their lengths."""
    rng = np.random.default_rng([seed, 3])
    out = []
    for length in sorted(set(lengths)):
        same = [i for i, n in enumerate(lengths) if n == length]
        out.append(same[int(rng.integers(len(same)))])
    return out


def run(api, params, dm, traffic, seed, seconds, spans, window):
    V = dm.V

    def call(tokens):
        with spans("prefill_fn"):
            logits = api.prefill_fn(params, {"tokens": tokens[None]})
            return logits[0].cpu()    # the host has the logits: synced

    for length in sorted(set(doc_lengths(traffic)), reverse=True):
        call(np.random.default_rng([seed, 4, length]).integers(
            0, V, length).astype(np.int32))
    if api.device.type == "cuda":
        torch.cuda.synchronize(api.device)
    order = doc_order(traffic, seed, 100_000)
    docs, outs = [], []
    with window() as t_window:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            i = len(docs)
            tokens = doc_tokens(seed, i, order[i], V)
            ta = time.perf_counter()
            out = call(tokens)
            tb = time.perf_counter()
            docs.append({"length": order[i], "start_s": ta - t0,
                         "ttft_s": tb - ta})
            outs.append(out)
        t_window["end"] = time.perf_counter()
    short, _ = halves(traffic)
    picked = check_sample(seed, [d["length"] for d in docs])
    return {
        "kind": "prefill_closed",
        "window_s": t_window["end"] - t0,
        "attempted": len(docs), "failed": 0,
        "docs": docs,
        "check": [{"tokens": doc_tokens(seed, i, order[i], V),
                   "logits": outs[i],
                   "half": "short" if order[i] in short else "long"}
                  for i in picked],
    }


def reference_inputs(record):
    seqs = [torch.as_tensor(c["tokens"]) for c in record["check"]]
    return seqs, [torch.tensor([len(s) - 1]) for s in seqs]


def items(record, ref):
    """(l2, max) of each compared document's logits."""
    return [compare.logit_errors(c["logits"], r[0])
            for c, r in zip(record["check"], ref)]


def control_items(record, ref, other):
    return [compare.logit_errors(o[0], r[0]) for o, r in zip(other, ref)]


def _q1(values):
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=4, method="inclusive")[0]


def summary(record, per_item) -> dict:
    out = {}
    for half in ("short", "long"):
        got = [e for c, e in zip(record["check"], per_item)
               if c["half"] == half]
        if got:
            out[f"q1_err_l2.{half}"] = _q1([e[0] for e in got])
            out[f"q1_err_max.{half}"] = _q1([e[1] for e in got])
    return out
