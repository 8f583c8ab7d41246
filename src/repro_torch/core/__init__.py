"""Parallax core for the PyTorch port: the §3.3 scheduler and the §3.2
slab pool that serving needs.  The planner, its executors and the rest
of the arena arrive with the planner slice."""

from .arena import SlabPool
from .scheduler import (Schedule, ScheduledLayer, greedy_select,
                        incremental_select, memory_budget,
                        query_available_memory, schedule_layers)

__all__ = [n for n in dir() if not n.startswith("_")]
