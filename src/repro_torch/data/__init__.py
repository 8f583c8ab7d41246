"""Synthetic training data (a copy of ``repro.data``)."""

from .pipeline import SyntheticTokens, to_device

__all__ = ["SyntheticTokens", "to_device"]
