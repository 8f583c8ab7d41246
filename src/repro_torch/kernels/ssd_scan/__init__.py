from .ops import ssd_scan_op
from .ref import segsum, ssd_chunked, ssd_scan_ref
from .ssd_scan import launches, reset_launches, ssd_scan, ssd_scan_plain

__all__ = ["launches", "reset_launches", "segsum", "ssd_chunked",
           "ssd_scan", "ssd_scan_op", "ssd_scan_plain", "ssd_scan_ref"]
