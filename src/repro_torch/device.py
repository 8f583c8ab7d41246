"""Device and dtype policy shared by the port's entry points.

``resolve_device`` is the one place that decides where the port runs:
``None`` means ``cuda``, and asking for ``cuda`` on a machine without a
card raises — nothing falls back to the CPU silently.  On the card it
also switches on deterministic mode before the first cuBLAS call, so
greedy streams stay bit-identical across megastep lengths and prefix
sharing (the same contract the JAX reference keeps on its backend).
"""

from __future__ import annotations

import os

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(dtype) -> torch.dtype:
    """``cfg.dtype`` string (or a torch dtype) -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}; have "
                         f"{sorted(DTYPES)}") from None


def deterministic() -> None:
    """Deterministic cuBLAS workspaces and kernels, TF32 off for fp32.

    ``CUBLAS_WORKSPACE_CONFIG`` is read when cuBLAS initialises, so this
    must run before the first matrix product on the card."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``.  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the card by "
                "default; pass device='cpu' to run its plain PyTorch "
                "path on the CPU")
        deterministic()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
