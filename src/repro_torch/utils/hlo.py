"""Per-device accounting of one dispatched step: the counterpart of
``repro.utils.hlo``.

The JAX package parses the optimised HLO of a compiled SPMD module for
its collectives.  Torch has no HLO: the port reads a *dispatch trace*
instead.  :class:`DispatchTrace` is a ``TorchDispatchMode`` that sees
every op a rank runs on its local shards — a DTensor op is handed on to
DTensor (``NotImplemented``), whose local ops and collectives come back
through the mode — and records:

* every ``_c10d_functional`` collective (``all_gather_into_tensor``,
  ``all_reduce``, ``reduce_scatter_tensor``, ``all_to_all_single`` and
  their ``_coalesced`` forms) with its result bytes on the local shard,
  JAX's convention ("sum of result shapes": for an all-gather the
  gathered size, the volume received);
* the FLOPs of each local op, by ``torch.utils.flop_counter``'s formulas
  on the local shapes (``FlopCounterMode`` itself would see the
  DTensor-level op, over global shapes);
* the bytes each local op reads and writes (every tensor operand and
  result once; views, metadata ops and collectives excluded): the memory
  term of an unfused eager run, where XLA's ``bytes accessed`` counts
  fused HLO ops;
* the live bytes of the storages allocated during the trace, and their
  peak (storages alive before it, such as the arguments, are not
  counted).

DTensor derives each op's output shape by running it on fake tensors of
the *global* shapes (``ShardingPropagator._propagate_tensor_meta_non
_cached``); those shadow ops come through the mode too.  While the trace
is active that method is wrapped, and nothing it runs is recorded.

:func:`collective_bytes`, :func:`collective_counts` and
:func:`op_histogram` return JAX's keys (``all-gather``, ``all-reduce``,
``reduce-scatter``, ``all-to-all``, ``collective-permute``, ``total``);
torch's functional collectives have no permute, so
``collective-permute`` never appears.  JAX's
``bf16_convert_artifact_bytes`` measures an XLA:CPU artifact (bf16 dot
operands hoisted to fp32 out of layer scans) that eager torch does not
make: it has no counterpart.
"""

from __future__ import annotations

import weakref
from collections import Counter, defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

#: ``_c10d_functional`` op name -> JAX's collective name
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

#: ops that move or describe no data
_FREE = {"wait_tensor", "empty", "empty_strided", "empty_like", "detach",
         "alias", "view", "_unsafe_view", "as_strided", "expand", "t",
         "transpose", "permute", "unsqueeze", "squeeze", "select", "slice",
         "split", "split_with_sizes", "unbind", "lift_fresh",
         "device", "sym_size", "sym_stride", "sym_numel"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class DispatchTrace(TorchDispatchMode):
    """Records the local ops of a rank (see the module docstring).

    ``known``: tensors whose storages exist before the trace (arguments),
    never counted as allocated."""

    def __init__(self, known=()):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        self._dtensor = DTensor
        self._flops = flop_registry
        self._known = {self._key(t) for t in known}
        self._live: dict = {}
        self.ops: Counter = Counter()
        self.collectives: list = []          # (kind, result bytes)
        self.flops = 0
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._shadow = 0

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator

        meta = ShardingPropagator._propagate_tensor_meta_non_cached
        self._meta = meta

        def shadow(prop, op_schema):
            self._shadow += 1
            try:
                return meta(prop, op_schema)
            finally:
                self._shadow -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = shadow
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator

        ShardingPropagator._propagate_tensor_meta_non_cached = self._meta
        return super().__exit__(*exc)

    @staticmethod
    def _key(t):
        return t.untyped_storage()._cdata

    def _free(self, key, nbytes):
        if self._live.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def _alloc(self, t):
        key = self._key(t)
        if key in self._known or key in self._live:
            return
        st = t.untyped_storage()
        nbytes = st.nbytes()
        self._live[key] = nbytes
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented          # DTensor runs the local ops
        out = func(*args, **kwargs)
        if self._shadow:                   # global-shape meta propagation
            return out
        packet = func._overloadpacket
        name = packet.__name__
        self.ops[name] += 1
        outs = [t for t in _tensors(out) if t.device.type != "meta"]
        for t in outs:
            self._alloc(t)
        ns = func.namespace
        if ns == "_c10d_functional":
            kind = _KINDS.get(name)
            if kind is not None:
                self.collectives.append(
                    (kind, sum(_nbytes(t) for t in outs)))
            return out
        if packet in self._flops:
            self.flops += self._flops[packet](*args, **kwargs,
                                              out_val=out)
        if name not in _FREE and ns != "prim":
            self.bytes_accessed += sum(
                _nbytes(t) for t in _tensors((args, kwargs)) + outs)
        return out


def collective_bytes(trace: DispatchTrace) -> "dict[str, int]":
    """Per-collective-op-type byte totals (plus 'total')."""
    out: dict[str, int] = defaultdict(int)
    for kind, nbytes in trace.collectives:
        out[kind] += nbytes
        out["total"] += nbytes
    return dict(out)


def collective_counts(trace: DispatchTrace) -> "dict[str, int]":
    out: dict[str, int] = defaultdict(int)
    for kind, _ in trace.collectives:
        out[kind] += 1
    return dict(out)


def op_histogram(trace: DispatchTrace, top: int = 20):
    """Most frequent local ops — remat/redundancy smell test (§Perf)."""
    return trace.ops.most_common(top)
