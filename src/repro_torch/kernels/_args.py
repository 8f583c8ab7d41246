"""Argument checks shared by the kernel wrappers.

Every wrapper runs its plain PyTorch version for CPU tensors and
otherwise hands raw pointers to a CUDA kernel, which checks nothing
itself: the device, type, shape and layout of each argument are checked
here, in Python, before a launch.
"""

from __future__ import annotations

import contextlib

import torch
import torch.utils.deterministic

NEG_INF = -1e30
#: the kernels' ``dtype`` codes
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rows(x, B: int, like: torch.Tensor) -> torch.Tensor:
    """Scalar or (B,) -> contiguous (B,) int32 on ``like``'s device."""
    x = torch.as_tensor(x, dtype=torch.int32, device=like.device)
    if x.ndim > 1:
        raise ValueError(f"expected a scalar or (B,) vector, got shape "
                         f"{tuple(x.shape)}")
    return x.reshape(-1).expand(B).contiguous()


def check_cuda(name: str, tensors: dict, dtype: torch.dtype) -> None:
    """All ``tensors`` contiguous on one device; ``dtype`` a kernel
    type."""
    device = next(iter(tensors.values())).device
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got "
                        f"{dtype}")


def aligned16(tensors, *extents) -> int:
    """1 if every tensor's data and every extent (strides, a row length),
    in elements, lie on 16 bytes: the kernels then load 16-byte vectors,
    else element by element."""
    item = tensors[0].element_size()
    return int(all(t.data_ptr() % 16 == 0 for t in tensors)
               and all(e * item % 16 == 0 for e in extents))


#: per (device, stream): the decode kernels' arrival counters, zero
#: between launches (each launch leaves them as it found them)
_counters: dict = {}


def arrival_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zero int32 counters for a launch on ``device``'s
    current stream.  Launches on one stream run in order, so they share
    one buffer; another stream gets its own."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


@contextlib.contextmanager
def unfilled():
    """Allocations inside skip deterministic mode's NaN fill of new memory
    (a memset as large as the tensor, on the stream before the kernel).
    For kernel outputs only: the kernel writes every element."""
    saved = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.utils.deterministic.fill_uninitialized_memory = saved
