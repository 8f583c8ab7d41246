"""The design choices of two hand-written kernels, timed against their
alternatives on one NVIDIA GPU.

    python3 benchmarks/torch_kernel_variants.py      # from the repository root

Needs a card and ``nvcc``.  Each variant is the kernel's source in
``src/repro_torch/csrc/`` with one choice undone by a textual patch (the
script stops if the patch no longer applies), compiled with the port's own
flags into ``build/variants/`` and put in place of the shipped library for
its measurement.  Times are medians of CUDA events with the L2 cache flushed
(``chip_smoke.median_ms``); every comparison runs in this one process, on
this one card.

- ``flash_attention`` bf16, P V as one bf16 product instead of two (P's
  high and low parts): kernel time at the stablelm-3b prefill shape, and
  ``prefill_fn``'s bf16 logits against the plain version's, the check that
  ``chip_smoke.py`` holds at 2e-2 (same weights and tokens as there);
- ``flash_attention`` with 8 warps (128 query rows) a block instead of 4;
- ``branch_matmul``: block tile, depth and ring length, each of ``TILES``
  at the planner's two fp32 sites, beside ``torch.bmm``, and whether the
  result equals ``torch.bmm`` bit for bit;
- ``branch_matmul``'s output allocated with deterministic mode's NaN fill
  (``torch.empty`` as it comes) against without it (the shipped
  ``kernels._args.unfilled``).
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")
OUT = os.path.join(ROOT, "build", "variants")

# flash_attention: P V as one product of P rounded to bf16; the row sum adds
# the rounded weights, as they are multiplied
ONE_P_PRODUCT = (
    ("""      p_lo[j / 2][(j % 2) * 2] = as_u32(__floats2bfloat162_rn(
          p[0] - __low2float(r0), p[1] - __high2float(r0)));
      p_lo[j / 2][(j % 2) * 2 + 1] = as_u32(__floats2bfloat162_rn(
          p[2] - __low2float(r8), p[3] - __high2float(r8)));
      l_r[0] += p[0] + p[1];
      l_r[1] += p[2] + p[3];
""", """      l_r[0] += __low2float(r0) + __high2float(r0);
      l_r[1] += __low2float(r8) + __high2float(r8);
"""),
    ("""        mma(o[2 * dp], p_lo[kk], vf[0], vf[1]);
        mma(o[2 * dp + 1], p_lo[kk], vf[2], vf[3]);
""", ""),
)
EIGHT_WARPS = (("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),)
# branch_matmul tiles: BM, BN, BK, TM, TN, STAGES (the shipped two first)
TILES = ((64, 64, 16, 8, 4, 3), (32, 64, 32, 4, 4, 2), (32, 64, 16, 4, 8, 3),
         (32, 64, 16, 4, 4, 3), (32, 32, 16, 4, 4, 3), (64, 64, 16, 4, 4, 3),
         (64, 64, 16, 4, 8, 3), (128, 64, 16, 8, 4, 3),
         (64, 128, 16, 8, 4, 3))


def patched(name, patches):
    """``csrc/<name>.cu`` with each (old, new) replaced once."""
    with open(os.path.join(CSRC, f"{name}.cu")) as f:
        src = f.read()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}.cu: a patch no longer applies:\n"
                               f"{old}")
        src = src.replace(old, new)
    return src


def tile_harness():
    """A library with ``variant(x, w, out, G, M, K, N, tile, stream)``
    launching the fp32 kernel at ``TILES[tile]``."""
    cases = "".join(
        f"    case {i}: return launch<float, Tile<{', '.join(map(str, t))}>>"
        f"(x, w, out, G, M, K, N, vec, s);\n" for i, t in enumerate(TILES))
    return (f'#include "{os.path.join(CSRC, "branch_matmul.cu")}"\n'
            'extern "C" int variant(const void* x, const void* w, void* out,'
            ' int G, int M, int K, int N, int tile, void* stream) {\n'
            '  cudaStream_t s = static_cast<cudaStream_t>(stream);\n'
            '  const int vec = K % 4 == 0 && N % 4 == 0;\n'
            '  switch (tile) {\n' + cases + '  }\n  return -1;\n}\n')


def build(sources):
    """Compile {name: source text} in parallel; returns {name: CDLL}."""
    from repro_torch.kernels import _build

    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o",
             os.path.join(OUT, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
    return libs


@contextlib.contextmanager
def library(name, lib):
    """The wrappers launch ``lib`` for kernel ``name`` inside."""
    from repro_torch.kernels import _build

    shipped = _build.load(name)
    fn = getattr(lib, name)
    fn.argtypes = _build.SIGNATURES[name]
    fn.restype = ctypes.c_int
    _build._loaded[name] = lib
    try:
        yield
    finally:
        _build._loaded[name] = shipped


def flash_variants(libs, device, flush):
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(2)
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=torch.bfloat16,
                            device=device)
               for s in ((cs.FA_B, cs.H, cs.FA_S, cs.D),) * 3)
    want = fa.flash_attention_plain(q, k, v, True, 0)
    shipped = fa.flash_attention(q, k, v, causal=True, window=0)
    times = {}
    variants = {"one P product": "flash_one_p_product",
                "8 warps": "flash_8_warps"}
    for label in ("shipped", "one P product", "8 warps", "shipped"):
        ctx = (library("flash_attention", libs[variants[label]])
               if label in variants else contextlib.nullcontext())
        with ctx:
            got = fa.flash_attention(q, k, v, causal=True, window=0)
            ms = cs.median_ms(lambda: fa.flash_attention(q, k, v),
                              flush)
        e = (got.float() - want.float()).abs().max().item()
        times.setdefault(label, []).append(ms)
        print(f"flash_attention bf16 B={cs.FA_B} H=K={cs.H} S={cs.FA_S} "
              f"D={cs.D} causal, {label}: {ms:.4f} ms, max abs err {e:.3e}"
              f" vs plain", flush=True)
    sdpa = cs.median_ms(lambda: cs.sdpa_flash(q, k, v, True, 0), flush)
    print(f"flash_attention: SDPA {sdpa:.4f} ms; shipped twice "
          f"{times['shipped']} (bit-identical to the first launch: "
          f"{torch.equal(shipped, got)})", flush=True)


def prefill_variants(libs, device):
    """stablelm-3b bf16 prefill_fn logits, normwise from the plain
    version's, as chip_smoke.prefill_phase computes them."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import build_model

    cfg = get_config("stablelm-3b")
    api = build_model(cfg, device=device)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.tensor(
        rng.integers(0, cfg.vocab_size, (cs.PREFILL_B, cs.PREFILL_S)),
        dtype=torch.int32, device=device)}
    mod = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    kernel = mod.flash_attention
    with torch.no_grad():
        mod.flash_attention = flash_attention_plain
        try:
            plain = api.prefill_fn(params, batch)
        finally:
            mod.flash_attention = kernel
        for label, lib in (("shipped", None),
                           ("one P product", libs["flash_one_p_product"])):
            ctx = (contextlib.nullcontext() if lib is None
                   else library("flash_attention", lib))
            with ctx:
                logits = api.prefill_fn(params, batch)
            print(f"prefill_fn stablelm-3b bf16 B={cs.PREFILL_B} "
                  f"S={cs.PREFILL_S}, {label}: normwise "
                  f"{cs.normwise(logits, plain):.4e} from the plain version "
                  f"(chip_smoke.py holds it at {cs.PREFILL_TOL})",
                  flush=True)
    del api, params
    torch.cuda.empty_cache()


def gemm_variants(harness, device, flush):
    from repro_torch.kernels import branch_matmul as bm

    fn = harness.variant
    fn.argtypes = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 5 \
        + (ctypes.c_void_p,)
    fn.restype = ctypes.c_int
    mod = importlib.import_module(
        "repro_torch.kernels.branch_matmul.branch_matmul")
    rng = np.random.default_rng(1)
    for site, (G, M, K, N) in cs.BM_SITES.items():
        x = torch.tensor(rng.standard_normal((G, M, K), dtype=np.float32),
                         device=device)
        w = torch.tensor(rng.standard_normal((G, K, N), dtype=np.float32)
                         / np.float32(2 * np.sqrt(K)), device=device)
        want = torch.bmm(x, w)
        out = torch.empty_like(want)
        stream = torch.cuda.current_stream(device).cuda_stream
        bmm_ms = cs.median_ms(lambda: torch.bmm(x, w), flush)
        row = [f"torch.bmm {bmm_ms:.4f}"]
        for i, tile in enumerate(TILES):
            def launch():
                return fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), G, M,
                          K, N, i, stream)
            if launch() != 0:
                raise RuntimeError(f"tile {tile}: launch failed")
            torch.cuda.synchronize()
            row.append(f"{tile} {cs.median_ms(launch, flush):.4f}"
                       f"{'' if torch.equal(out, want) else ' (differs)'}")
        wrapper_ms = cs.median_ms(lambda: bm.branch_matmul(x, w), flush)
        unfilled = mod.unfilled
        mod.unfilled = contextlib.nullcontext
        try:
            filled_ms = cs.median_ms(lambda: bm.branch_matmul(x, w), flush)
        finally:
            mod.unfilled = unfilled
        row += [f"wrapper {wrapper_ms:.4f}",
                f"wrapper with the NaN fill {filled_ms:.4f}"]
        print(f"branch_matmul fp32 {site} G={G} M={M} K={K} N={N}, ms "
              f"(tile BM, BN, BK, TM, TN, stages; bit-identical to torch.bmm"
              f" unless marked): " + "; ".join(row), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.device import deterministic

    deterministic()
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    libs = build({
        "flash_one_p_product": patched("flash_attention", ONE_P_PRODUCT),
        "flash_8_warps": patched("flash_attention", EIGHT_WARPS),
        "branch_matmul_tiles": tile_harness()})
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    flash_variants(libs, device, flush)
    gemm_variants(libs["branch_matmul_tiles"], device, flush)
    prefill_variants(libs, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
