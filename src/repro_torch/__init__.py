"""Parallax serving on PyTorch and CUDA: the port of :mod:`repro` (JAX on
a TPU) to an NVIDIA H100.

The package mirrors ``repro``'s layout module for module.  It imports
torch, numpy and the standard library only — never jax, never ``repro``.
Entry points (``models.build_model``, ``runtime.engine.ContinuousEngine``,
``launch.serve``) run on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""
