"""Build the port's CUDA kernels for the CPU with g++.

The CUDA sources in ``src/repro_torch/csrc/`` are rewritten in four
small ways — a ``kernel<<<grid, block, smem, stream>>>(args)`` launch
becomes a call of ``emu::launch`` (which is handed the kernel, to check
its shared-memory opt-in), shared memory becomes one static buffer,
inline-PTX ``cp.async`` copies, commits and waits become the stand-in's
``cuda_pipeline.h`` calls, and inline-PTX ``ldmatrix`` and ``mma.sync``
(m16n8k16, bf16 in, fp32 out) become the stand-in's warp exchanges — and
compiled against the stand-in headers in ``include/``, which run
every CUDA thread of a block as a ``std::thread`` and the blocks of a
grid in reverse launch order.  The libraries keep
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
# inline PTX of cp.async: [dst], [src], copy size, source bytes (the rest
# zero-filled); commit_group; wait_group N
_CP_ASYNC = re.compile(
    r'asm volatile\("cp\.async\.c[ag]\.shared\.global \[%0\], \[%1\], '
    r'(\d+), %2;\\n"\s*::\s*"r"\(smem_u32\((\w+)\)\),\s*"l"\((\w+)\),'
    r'\s*"r"\((\w+)\)\);')
_CP_COMMIT = re.compile(r'asm volatile\("cp\.async\.commit_group;\\n" ::\);')
_CP_WAIT = re.compile(
    r'asm volatile\("cp\.async\.wait_group %0;\\n" :: "n"\((\w+)\)\);')
# inline PTX of ldmatrix.x4 (or .x4.trans) into r[0..3] from smem_u32(p),
# and of mma.sync m16n8k16 bf16 -> f32 with c as both addend and result
_LDMATRIX = re.compile(
    r'asm volatile\(\s*"ldmatrix\.sync\.aligned\.m8n8\.x4(\.trans)?'
    r'\.shared\.b16 [^"]*"(?:\s*"[^"]*")*\s*:\s*"=r"\((\w+)\[0\]\).*?'
    r'"r"\(smem_u32\((\w+)\)\)\);', re.S)
_MMA = re.compile(
    r'asm volatile\(\s*"mma\.sync\.aligned\.m16n8k16\.row\.col\.f32\.bf16'
    r'\.bf16\.f32 ".*?"\+f"\((\w+)\[0\]\).*?"r"\((\w+)\[0\]\).*?'
    r'"r"\((\w+)\), "r"\((\w+)\)\);', re.S)


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
    text = text.replace(
        "extern __shared__ __align__(16) float smem[];",
        "float* smem = reinterpret_cast<float*>(emu::shared_mem);")
    text = re.sub(r"__shared__ (\w+) (\w+(\[[^\]]*\])?);", r"static \1 \2;",
                  text)
    text = _LDMATRIX.sub(
        lambda m: f"__emu_ldmatrix_x4({m.group(2)}, {m.group(3)}, "
                  f"{'true' if m.group(1) else 'false'});", text)
    text = _MMA.sub(r"__emu_mma_m16n8k16_bf16(\1, \2, \3, \4);", text)
    if _CP_ASYNC.search(text):
        text = _CP_ASYNC.sub(r"__pipeline_memcpy_async(\2, \3, \1, \1 - \4);",
                             text)
        text = _CP_COMMIT.sub("__pipeline_commit();", text)
        text = _CP_WAIT.sub(r"__pipeline_wait_prior(\1);", text)
        text = text.replace(
            "static_cast<uint32_t>(__cvta_generic_to_shared(p))", "0")
        text = '#include <cuda_pipeline.h>\n' + text
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
        name = text[start:end]
        out.append(f"emu::launch({m.group(1)}, reinterpret_cast<const "
                   f"void*>(&{name}), [&] {{ {name}"
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
