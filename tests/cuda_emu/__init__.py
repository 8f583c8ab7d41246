"""Build the port's decode kernels for the CPU with g++.

The CUDA sources in ``src/repro_torch/csrc/`` are rewritten in two small
ways — a ``kernel<<<grid, block, smem, stream>>>(args)`` launch becomes a
call of ``emu::launch``, and shared memory becomes one static buffer —
and compiled against the stand-in headers in ``include/``, which run
every CUDA thread of a block as a ``std::thread``.  The libraries keep
the kernels' C interface, so a test calls them with CPU tensors exactly
as the wrappers call the real ones on the card.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

INCLUDE = Path(__file__).resolve().parent / "include"
CSRC = Path(__file__).resolve().parents[2] / "src" / "repro_torch" / "csrc"
_LAUNCH = re.compile(r"<<<(.*?)>>>\(", re.S)


def available() -> bool:
    return shutil.which("g++") is not None


def _kernel_name_start(text: str, end: int) -> int:
    """Start of the kernel name (with its template arguments) that ends
    just before ``end``."""
    j = end
    depth = 0
    while True:
        j -= 1
        c = text[j]
        if c == ">":
            depth += 1
        elif c == "<":
            depth -= 1
        elif depth == 0 and not (c.isalnum() or c in "_:"):
            return j + 1


def transform(text: str) -> str:
    """CUDA source -> the C++ the stand-in headers compile."""
    text = text.replace("extern __shared__ float4 smem4[];",
                        "float4* smem4 = emu::shared_mem;")
    text = re.sub(r"__shared__ (\w+) (\w+);", r"static \1 \2;", text)
    out, i = [], 0
    while (m := _LAUNCH.search(text, i)) is not None:
        end = m.start()
        while text[end - 1].isspace():
            end -= 1
        start = _kernel_name_start(text, end)
        k, depth = m.end(), 1                # the argument list's ')'
        while depth:
            depth += {"(": 1, ")": -1}.get(text[k], 0)
            k += 1
        out.append(text[i:start])
        out.append(f"emu::launch({m.group(1)}, [&] {{ {text[start:end]}"
                   f"({text[m.end():k - 1]}); }})")
        i = k
    out.append(text[i:])
    return "".join(out)


def build(names, out_dir: Path, sources: Path = CSRC) -> dict:
    """Compile ``<name>.cu`` of ``sources`` for each name, in parallel;
    returns {name: CDLL}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in sources.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (out_dir / f.name).write_text(transform(f.read_text()))
    procs = {}
    for name in names:
        procs[name] = subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-ffp-contract=off", "-I", str(INCLUDE), "-o",
             str(out_dir / f"lib{name}.so"), "-x", "c++",
             str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: g++ exited {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    return libs
