"""Host-side execution of dynamic (control-flow) subgraphs.

The §3.4 classification forces control-flow operators into Split-Merge
singleton branches; the heterogeneous runtime executes them as *dynamic
regions* on the host: each region is a subgraph captured on first use
into its own callable, cached under a *shape bucket* so repeated
invocations — including ones whose dynamic dims vary within a bucket —
reuse one capture.

Capture
-------

The first call of a (region, bucket) runs the region eagerly on the real
inputs and returns that result; it then traces the region once more with
``make_fx`` on fake tensors of the same shapes into an aten graph, which
every later call of the bucket replays.  The eager run comes first so
every constant the region's node fns read (the exporter's per-device
copies) exists before the trace; the trace turns those into constants of
the graph.  A replay runs the aten ops the eager run dispatched, so it
equals the eager run bit for bit.

Buckets
-------

* ``"exact"`` (default) — the bucket is the concrete shape tuple.
  Captures are shared across calls with identical shapes; new shapes
  capture fresh.  Always bit-exact.
* ``"pow2"`` — every dimension rounds up to the next power of two; inputs
  are zero-padded to the bucket and outputs sliced back.  One capture
  serves all shapes in the bucket, at the price of padded FLOPs.  Only
  sound for *pad-safe* regions (shape-preserving, element-independent:
  each output element depends only on the matching input element), so it
  is opt-in per cache.

Regions whose fns perform data-dependent Python control flow (a Python
``if`` on a tensor's value) or call numpy cannot be traced on fake
tensors; the cache runs the eager callable for that entry from then on
— that *is* the paper's CPU fallback, and it is recorded in
``eager_fallbacks`` for inspection.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..core.executor import make_subgraph_fn
from ..core.graph import Graph


def shape_bucket(shape: tuple, mode: str = "exact") -> tuple:
    """Bucket key of one concrete shape."""
    if mode == "exact":
        return tuple(int(d) for d in shape)
    if mode == "pow2":
        return tuple(1 if d <= 1 else 1 << (int(d) - 1).bit_length()
                     for d in shape)
    raise ValueError(f"unknown bucket mode {mode!r}")


def _pad_to(a: torch.Tensor, bucket: tuple) -> torch.Tensor:
    """Zero-pad ``a`` at the end of every dimension up to ``bucket``."""
    pads = []
    for s, b in zip(reversed(a.shape), reversed(bucket)):
        pads += [0, b - s]
    if not any(pads):
        return a
    return F.pad(a, pads)


@dataclass
class _Entry:
    fn: object                    # captured aten graph, or None (eager)
    eager: object                 # always-valid eager callable
    in_ids: "tuple[int, ...]"
    out_ids: "tuple[int, ...]"


class DynamicRegionCache:
    """Per-subgraph capture cache for host-side dynamic regions.

    Keyed on ``(region nodes, input shape buckets, dtypes, devices)``.
    Counters:

    * ``compile_count`` — cache entries built (distinct region/bucket),
    * ``trace_count``   — traces performed (Python body runs on fakes),
    * ``hit_count``     — calls served by an existing entry,
    * ``eager_fallbacks`` — entries demoted to eager execution.
    """

    def __init__(self, graph: Graph, bucket: str = "exact"):
        shape_bucket((1,), bucket)  # validate mode eagerly
        self.graph = graph
        self.bucket = bucket
        self._entries: "dict[tuple, _Entry]" = {}
        self.compile_count = 0
        self.trace_count = 0
        self.hit_count = 0
        self.eager_fallbacks = 0

    def _capture(self, ent: _Entry, args: tuple) -> None:
        """Trace ``ent.eager`` on fake tensors shaped like ``args``; on
        success later calls replay the graph, else the entry stays eager
        for good."""
        from torch.fx.experimental.proxy_tensor import make_fx

        def traced(*a):
            self.trace_count += 1   # Python body runs only while tracing
            return ent.eager(*a)

        try:
            ent.fn = make_fx(traced, tracing_mode="fake",
                             _allow_non_fake_inputs=True)(*args)
        except Exception:
            # The eager run on these very inputs has just succeeded, so
            # a failure here is the trace's: data-dependent Python
            # control flow (GuardOnDataDependentSymNode), a fake tensor
            # handed to numpy, or any other op without a fake kernel.
            # Demote this entry to eager host execution (the CPU
            # fallback).
            self.eager_fallbacks += 1

    def _entry(self, node_ids: "tuple[int, ...]",
               args: tuple) -> "tuple[_Entry, bool]":
        """The entry of a region at these inputs, and whether it is new."""
        key = (tuple(node_ids),
               tuple((shape_bucket(a.shape, self.bucket), a.dtype, a.device)
                     for a in args))
        ent = self._entries.get(key)
        if ent is not None:
            self.hit_count += 1
            return ent, False
        eager, in_ids, out_ids = make_subgraph_fn(self.graph,
                                                  list(node_ids))
        ent = _Entry(None, eager, tuple(in_ids), tuple(out_ids))
        self._entries[key] = ent
        self.compile_count += 1
        return ent, True

    def run(self, node_ids: "tuple[int, ...]", args: tuple) -> tuple:
        """Execute a region; returns outputs in ``entry.out_ids`` order.
        ``args`` are tensors (numpy arrays are taken as CPU tensors)."""
        args = tuple(torch.as_tensor(a) for a in args)
        shapes = tuple(tuple(a.shape) for a in args)
        ent, new = self._entry(node_ids, args)
        call_args = args
        if self.bucket == "pow2":
            call_args = tuple(_pad_to(a, shape_bucket(s, "pow2"))
                              for a, s in zip(args, shapes))
        if ent.fn is not None:
            outs = ent.fn(*call_args)
        else:
            outs = ent.eager(*call_args)
            if new:
                self._capture(ent, call_args)
        if self.bucket == "pow2":
            # Pad-safe contract: outputs are shape-preserving w.r.t. the
            # primary input — slice each back to its pre-pad extent.
            ref = shapes[0] if shapes else ()
            outs = tuple(o[tuple(slice(0, d) for d in ref)]
                         if tuple(o.shape) != ref and o.ndim == len(ref)
                         else o for o in outs)
        return tuple(outs)
