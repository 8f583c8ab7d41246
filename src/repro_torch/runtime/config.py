"""EngineConfig — the single source of truth for serving-engine knobs.

Before this module existed the same knob lived in up to three places
with hand-maintained agreement: a positional engine kwarg, a
``PARALLAX_*`` env var resolved by a per-knob helper, and a serve.py
argparse flag.  :class:`EngineConfig` consolidates all of them into one
frozen dataclass with a single documented precedence rule, resolved
once at construction time:

    explicit value  >  env var  >  default

"Explicit" means *any* value passed to the constructor, including
falsy ones — ``EngineConfig(host_pool=0)`` disables the host KV tier
even when ``PARALLAX_HOST_POOL`` is set (the PR-8 semantics), and
``fault_seed=None`` explicitly disarms fault injection under a set
``PARALLAX_FAULT_SEED``.  Omitting the field entirely (the ``UNSET``
sentinel default) is what falls through to the env var and then the
field default.

Every field carries its env var, CLI help text, and parse function in
``dataclasses.field(metadata=...)``, so the serve.py flags are
*generated* from this class (:meth:`EngineConfig.add_cli_args`) and can
never drift from the constructor again.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field, fields

from repro_torch.core.scheduler import (MEM_BUDGET_ENV, _parse_bytes,
                                  query_available_memory)
from .faults import FAULT_SEED_ENV

MEGASTEP_ENV = "PARALLAX_MEGASTEP"
MEGASTEP_DEFAULT = 8
HOST_POOL_ENV = "PARALLAX_HOST_POOL"
PREFIX_CACHE_ENV = "PARALLAX_PREFIX_CACHE"


class _Unset:
    """Sentinel: field not passed — resolve via env var, then default."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "UNSET"


UNSET = _Unset()


def _parse_int(text: str) -> int:
    return int(text)


def _parse_opt_int(text: str) -> "int | None":
    if text.lower() in ("none", ""):
        return None
    return int(text)


def _parse_bool(text: str) -> bool:
    t = text.strip().lower()
    if t in ("1", "true", "yes", "on"):
        return True
    if t in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"expected a boolean, got {text!r}")


def _knob(default, *, env=None, parse=None, help="", unit=""):
    """A config field: UNSET-by-default so explicit/env/default are
    distinguishable, with the env var + CLI metadata riding along."""
    return field(default=UNSET,
                 metadata={"default": default, "env": env, "parse": parse,
                           "help": help, "unit": unit})


@dataclass(frozen=True)
class EngineConfig:
    """Resolved serving-engine configuration.

    Construct with any subset of fields; after ``__post_init__`` every
    field holds a concrete validated value (no sentinels escape).  Byte
    -count fields (``hbm_budget``, ``host_pool``) also accept strings
    with K/M/G/T suffixes, e.g. ``EngineConfig(hbm_budget="512M")``.
    """

    # --- memory ----------------------------------------------------------
    hbm_budget: int = _knob(
        None, env=MEM_BUDGET_ENV, parse=_parse_bytes, unit="bytes",
        help="device KV budget in bytes before the safety margin "
             "(K/M/G/T suffixes ok); default probes /proc/meminfo")
    margin: float = _knob(
        0.4, parse=float,
        help="fraction of hbm_budget held back from the KV pool")
    host_pool: int = _knob(
        0, env=HOST_POOL_ENV, parse=_parse_bytes, unit="bytes",
        help="host KV spill tier capacity in bytes (K/M/G/T suffixes "
             "ok); 0 disables the tier, explicit 0 beats the env var")
    # --- batching / context ----------------------------------------------
    max_batch: int = _knob(
        8, parse=_parse_int,
        help="slot-table capacity: max concurrently active requests")
    max_context: "int | None" = _knob(
        64, parse=_parse_opt_int,
        help="per-request context cap (prompt + generated tokens); "
             "'none' = dynamic per-round bucketing (round engine only)")
    prefill_chunk: int = _knob(
        16, parse=_parse_int,
        help="prompt tokens prefilled per chunked-prefill dispatch")
    block_size: int = _knob(
        16, parse=_parse_int,
        help="KV block granularity in tokens (paged pool slab size)")
    # --- scheduling -------------------------------------------------------
    megastep: int = _knob(
        MEGASTEP_DEFAULT, env=MEGASTEP_ENV, parse=_parse_int,
        help="decode iterations fused per megastep dispatch "
             "(1 disables fusion)")
    paged: bool = _knob(
        True, parse=None,
        help="physically paged block pool (dense per-slot caches when "
             "off)")
    prefix_sharing: bool = _knob(
        True, parse=None,
        help="share identical prompt-prefix blocks across live requests "
             "(paged only)")
    prefix_cache: bool = _knob(
        False, env=PREFIX_CACHE_ENV, parse=_parse_bool,
        help="retain finished requests' published prompt blocks in a "
             "persistent radix cache (LRU-evicted under pressure) so "
             "later identical prefixes skip prefill entirely "
             "(paged attention-only archs; needs prefix_sharing)")
    max_queue: "int | None" = _knob(
        None, parse=_parse_opt_int,
        help="admission-queue bound: submits beyond it are rejected "
             "(None = unbounded)")
    # --- robustness -------------------------------------------------------
    fault_seed: "int | None" = _knob(
        None, env=FAULT_SEED_ENV, parse=_parse_opt_int,
        help="seed for the fault-injection plane (None disarms; "
             "explicit None beats the env var)")
    dispatch_retries: int = _knob(
        2, parse=_parse_int,
        help="re-dispatch attempts after a poisoned/failed decode "
             "dispatch before degrading rows")
    retry_backoff_s: float = _knob(
        0.001, parse=float,
        help="base sleep between dispatch retry attempts (seconds)")

    def __post_init__(self):
        for f in fields(self):
            value = getattr(self, f.name)
            meta = f.metadata
            if value is UNSET:
                env_name = meta["env"]
                raw = os.environ.get(env_name) if env_name else None
                if raw is not None and raw != "":
                    try:
                        value = meta["parse"](raw)
                    except ValueError:
                        raise ValueError(
                            f"{env_name}={raw!r}: expected "
                            f"{meta['unit'] or f.name} "
                            f"({meta['help']})") from None
                else:
                    value = meta["default"]
            elif isinstance(value, str) and meta["parse"] is not None:
                # CLI/str passthrough: "512M" budgets, "none" seeds, ...
                value = meta["parse"](value)
            object.__setattr__(self, f.name, value)
        # hbm_budget's default is machine-probed, not a literal
        if self.hbm_budget is None:
            object.__setattr__(self, "hbm_budget", query_available_memory())
        self._validate()

    def _validate(self):
        def bad(msg):
            raise ValueError(f"EngineConfig: {msg}")

        if self.hbm_budget <= 0:
            bad(f"hbm_budget must be > 0 bytes, got {self.hbm_budget}")
        if not 0.0 <= self.margin < 1.0:
            bad(f"margin must be in [0, 1), got {self.margin}")
        if self.host_pool < 0:
            bad(f"host_pool must be >= 0 bytes, got {self.host_pool}")
        for name in ("max_batch", "prefill_chunk", "block_size",
                     "megastep"):
            if getattr(self, name) < 1:
                bad(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.max_context is not None and self.max_context < 1:
            bad(f"max_context must be >= 1 or None, "
                f"got {self.max_context}")
        if self.max_queue is not None and self.max_queue < 0:
            bad(f"max_queue must be >= 0 or None, got {self.max_queue}")
        if self.dispatch_retries < 0:
            bad(f"dispatch_retries must be >= 0, "
                f"got {self.dispatch_retries}")
        if self.retry_backoff_s < 0:
            bad(f"retry_backoff_s must be >= 0, got {self.retry_backoff_s}")

    # --- CLI generation ---------------------------------------------------

    @classmethod
    def add_cli_args(cls, parser: argparse.ArgumentParser,
                     exclude: tuple = ()) -> None:
        """Add one generated flag per config field (``--max-batch``,
        ``--host-pool``, boolean ``--paged/--no-paged``, ...).  Flags
        default to *absent* so the config's own precedence applies:
        an omitted flag falls through to the env var, then the field
        default."""
        group = parser.add_argument_group(
            "engine config (omitted flags fall back to PARALLAX_* env "
            "vars, then defaults; see runtime/config.py)")
        for f in fields(cls):
            if f.name in exclude:
                continue
            meta = f.metadata
            flag = "--" + f.name.replace("_", "-")
            help_text = meta["help"]
            if meta["env"]:
                help_text += f" [env {meta['env']}]"
            help_text += f" [default {meta['default']}]"
            if meta["parse"] in (None, _parse_bool):  # boolean knob
                group.add_argument(
                    flag, action=argparse.BooleanOptionalAction,
                    default=None, help=help_text)
            else:
                group.add_argument(
                    flag, type=str, metavar=f.name.upper(),
                    default=None, help=help_text)

    @classmethod
    def from_cli_args(cls, args: argparse.Namespace,
                      **overrides) -> "EngineConfig":
        """Build a config from a parsed namespace produced by
        :meth:`add_cli_args`.  Flags left at their ``None`` argparse
        default are treated as UNSET (env then default); ``overrides``
        force explicit values regardless of flags."""
        kwargs = {}
        for f in fields(cls):
            value = getattr(args, f.name, None)
            if value is not None:
                kwargs[f.name] = value
        kwargs.update(overrides)
        return cls(**kwargs)

    @classmethod
    def field_specs(cls):
        """(name, env, default, help) rows — docs and tests introspect
        the knob table through this instead of private metadata."""
        return [(f.name, f.metadata["env"], f.metadata["default"],
                 f.metadata["help"]) for f in fields(cls)]
