"""The JAX package's public name for :func:`ssd_scan`.

``ssd_scan_op`` takes the models' layout, as the JAX op does, but is the
wrapper itself: nothing is repeated or transposed, since the kernel
reads the groups and the chunks by strides.  The models call
:func:`ssd_scan` directly."""

from __future__ import annotations

from .ssd_scan import ssd_scan as ssd_scan_op

__all__ = ["ssd_scan_op"]
