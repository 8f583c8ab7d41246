"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a``.  Libraries go to ``build/kernels/`` at the repository root
and carry a hash of their source in the file name — the ``.cu`` file and
every ``csrc/`` header it includes with ``#include "..."`` — so an edited
source or header rebuilds and a stale library is never loaded.  Nothing is built when a
module is imported: the first launch builds, or :func:`build` builds
several sources at once, one ``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of every kernel entry point: argtypes, so pointers and the
# stream go through as 64-bit values (ctypes would pass ints as 32-bit)
SIGNATURES = {
    "paged_decode_attention": (_P,) * 8 + (_I,) * 7 + (_F, _I, _I, _P),
    "paged_append": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _I, _P),
    "branch_matmul": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "decode_attention": (_P,) * 8 + (_I,) * 6 + (_L,) * 3
    + (_I, _F, _I, _I, _P),
    "flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _I, _F, _I, _P),
    "ssd_scan": (_P, _P, _P, _P, _P, _P) + (_I,) * 7 + (_L,) * 12 + (_P,),
}
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

_loaded: "dict[str, ctypes.CDLL]" = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _sources(path: Path, seen: "dict[Path, bytes]") -> None:
    """``path`` and, recursively, the local headers it includes."""
    if path in seen:
        return
    seen[path] = path.read_bytes()
    for inc in _INCLUDE.findall(seen[path]):
        _sources(path.parent / inc.decode(), seen)


def library_path(name: str) -> Path:
    seen: "dict[Path, bytes]" = {}
    _sources(CSRC / f"{name}.cu", seen)
    h = hashlib.sha1()
    for path in sorted(seen):
        h.update(path.name.encode() + b"\0" + seen[path])
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=tuple(SIGNATURES)) -> float:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all in parallel.  Returns the seconds
    taken; raises with the compiler's output if any build fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)       # atomic: concurrent builders race
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
