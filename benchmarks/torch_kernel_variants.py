"""The design choices of the hand-written kernels, timed against their
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
  result equals ``torch.bmm`` bit for bit; in bf16 (the tensor-core
  kernel), each of ``BF16_TILES`` (rows 16, 64 or 128, depth, ring
  length, warps) at the MoE shapes — dbrx-132b and kimi-k2 gate/up at a
  decode step (capacity 8) and at a prefill (T = 2048), with the per-group
  row counts of a top-k routing (router logits skewed per expert, so
  groups are uneven as in ``chip_smoke.py``'s prefill) — beside the
  shipped tile for that capacity, ``torch.bmm`` and the routed-work
  bound, and whether each equals the shipped kernel bit for bit (each
  must: every tile runs the same m16n8k16 steps in the same order);
- ``branch_matmul``'s output allocated with deterministic mode's NaN fill
  (``torch.empty`` as it comes) against without it (the shipped
  ``kernels._args.unfilled``);
- the decode kernels (``decode_attention`` and ``paged_decode_attention``,
  one header ``decode_tile.cuh``): one split length ``kSplitTiles`` for
  every launch shape, at ``SPLIT_TILES``, a lane group folding one
  contiguous run of a split instead of every groups-th chunk, no cap on
  registers (the shipped kernels ask for 3 or 4 blocks an SM where their
  registers allow), one head a block (MHA) in blocks of 4 warps instead of
  8, with chunks of 4 positions or of 2 at 8 blocks an SM, the splits
  merged by a second kernel instead of the last block to finish, and the
  output and scratch allocated with the NaN fill, each at the three shapes
  ``chip_smoke.py`` times (the dense path's main shape, T=4096,
  h2o-danube's GQA window case at T=8192), beside SDPA, and whether each
  variant equals the shipped kernel bit for bit (it must, except another
  split length or chunk order);
- ``ssd_scan`` (``SSD_VARIANTS``): the state pass run by the last
  chunk-state block of each (batch, head) instead of a launch of its own,
  32-row query tiles instead of 64, d_state slices of 16, 32 or 128
  columns (of the state read in) instead of 64, one ring stage (load,
  wait, compute) or three instead of two, and the output kernel's
  registers capped for 2 blocks an SM instead of 3, at the three
  shapes
  ``chip_smoke.py`` times (the mamba2-370m prefill shape, a long prompt at
  b=1, S=8192, and jamba's N=16, H=128), beside the plain version, and
  whether each equals the shipped kernel bit for bit (each must: no
  variant changes a summation order); and the shipped call's device time
  split over its four kernels (``torch.profiler``);
- ``paged_append`` at the decode shape (``chip_smoke.append_case``, bf16):
  16-byte vectors where the pools and the rows lie on 16 bytes instead of
  one element a thread, and blocks of 32 or 128 threads instead of 64,
  pools bit-identical.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib
import os
import re
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
# bf16 tiles: BM, BN, BK, warps over rows, warps over columns, stages,
# blocks an SM (the shipped three first: decode, 64 rows, 128 rows)
BF16_TILES = ((16, 128, 64, 1, 4, 4, 2), (64, 128, 32, 2, 2, 4, 4),
              (128, 128, 32, 2, 4, 4, 2), (16, 128, 64, 1, 4, 3, 3),
              (16, 128, 128, 1, 4, 2, 2), (16, 64, 64, 1, 4, 4, 4),
              (64, 128, 32, 2, 2, 3, 4), (64, 128, 64, 2, 2, 3, 2),
              (128, 128, 32, 2, 4, 3, 2), (128, 128, 64, 2, 4, 3, 2),
              (64, 128, 32, 1, 2, 4, 4), (64, 128, 64, 1, 2, 3, 2),
              (128, 128, 32, 2, 2, 4, 2), (128, 128, 64, 2, 2, 3, 2),
              (128, 256, 32, 2, 4, 3, 1), (256, 128, 32, 4, 2, 3, 1))
# MoE shapes: label, experts, top-k, T, K, N (gate/up; down swaps K, N)
MOE_SHAPES = (("dbrx decode", 16, 4, 8, 6144, 10752),
              ("kimi decode", 384, 8, 8, 7168, 2048),
              ("dbrx prefill", 16, 4, 2048, 6144, 10752),
              ("kimi prefill", 384, 8, 2048, 7168, 2048))
ROUTER_SKEW = 0.5          # std of a per-expert bias on the router logits


# the decode kernels: one split length for every launch shape (the
# shipped one has 16 tiles for MHA blocks, 32 for GQA); each lane group
# folding one contiguous run of the split instead of every groups-th
# chunk; no register cap; the splits merged by a second kernel
SPLIT_TILES = (8, 16, 32)
SPLIT_LINE = "  static constexpr int kSplitTiles = kOneHead ? 16 : 32;"
CONTIGUOUS_RUNS = (
    ("""    // group grp folds chunks grp, grp + NG, ... of U positions
    const int stride = U * NG;
    const int j0 = grp * U;
    const int n_chunks = (P + stride - 1) / stride;   // the same for all""",
     """    // group grp folds positions [grp R, grp R + R) in chunks of U
    const int R = (P + NG - 1) / NG;
    const int stride = U;
    const int j0 = grp * R;
    const int j_end = min(j0 + R, P);
    const int n_chunks = (R + U - 1) / U;"""),
    ("load_chunk<T>(a, rows, k, v, j0, P, lg, D, aligned);",
     "load_chunk<T>(a, rows, k, v, j0, j_end, lg, D, aligned);"),
    ("j0 + (c + 1) * stride, P, lg, D,",
     "j0 + (c + 1) * stride, j_end, lg, D,"),
    ("j0 + (c + 2) * stride, P, lg, D,",
     "j0 + (c + 2) * stride, j_end, lg, D,"),
)
# one head a block (MHA): 4 warps as the other shapes, with chunks of 4
# positions (4 blocks an SM) or of 2 (8 blocks an SM)
MHA_WARPS = "  static constexpr int kWarps = kOneHead ? 8 : 4;"
MHA_CHUNK = "  static constexpr int kChunk = kOneHead ? 2 : "
MHA_BLOCKS = "  static constexpr int kMinBlocks = kOneHead ? 3 : "
MHA_AS_OTHERS = (
    (MHA_WARPS, "  static constexpr int kWarps = 4;"),
    (MHA_CHUNK, "  static constexpr int kChunk = "),
    (MHA_BLOCKS, "  static constexpr int kMinBlocks = "))
MHA_NARROW = (
    (MHA_WARPS, "  static constexpr int kWarps = 4;"),
    (MHA_BLOCKS, "  static constexpr int kMinBlocks = kOneHead ? 8 : "))
NO_REGISTER_CAP = (("""__launch_bounds__(decode_tile::Shape<NV, GC>::kThreads,
                                  decode_tile::Shape<NV, GC>::kMinBlocks)""",
                    "__launch_bounds__("
                    "decode_tile::Shape<NV, GC>::kThreads)"),)
SECOND_KERNEL = ((
    """  if (w.n_split == 1) return;

  // the last block of this (row, head chunk) to arrive merges the splits
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counters + w.counter, 1) == w.n_split - 1;
    if (last) counters[w.counter] = 0;          // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j = threadIdx.x; j < w.gn * D; j += blockDim.x) {""",
    """}

// the splits of one (row, head chunk) merged by a second kernel; grid
// (1, K * head chunks, B)
template <typename T>
__global__ void __launch_bounds__(128)
decode_combine_kernel(T* __restrict__ out, const float* __restrict__ scratch,
                      int H, int D, int G, int GC, int n_split) {
  const int n_hc = (G + GC - 1) / GC;
  const int kh = blockIdx.y / n_hc;
  const int hc = blockIdx.y - kh * n_hc;
  Where w;
  w.gn = min(GC, G - hc * GC);
  w.n_split = n_split;
  const size_t bh0 = (size_t)blockIdx.z * H + kh * G + hc * GC;
  const size_t n_rows = (size_t)gridDim.z * H * n_split;
  const float* ml = scratch;
  const float* acc = scratch + 2 * n_rows;
  for (int j = threadIdx.x; j < w.gn * D; j += blockDim.x) {"""),)
COMBINE_LAUNCH = ((
    """    return static_cast<int>(cudaGetLastError());
  });""",
    """    if (grid.x > 1)
      decode_tile::decode_combine_kernel<T>
          <<<dim3(1, grid.y, grid.z), 128, 0, stream>>>(
              static_cast<T*>(out), scratch, H, D, H / K, GC, grid.x);
    return static_cast<int>(cudaGetLastError());
  });"""),)
DECODE = ("decode_attention", "paged_decode_attention")

# ssd_scan: each choice of the shipped design undone on its own
# the state pass run by the last chunk-state block of each (batch, head)
# to arrive, on counters in device memory that each launch leaves at zero,
# instead of a launch of its own
FUSED_PASS = (
    ("// grid (nc * head-dim tiles, H, b).  MN: d_state rows per thread",
     "__device__ int arrivals[1 << 16];\n\n"
     "// grid (nc * head-dim tiles, H, b).  MN: d_state rows per thread"),
    ("""        if (p < P) sc[(long long)n * P + p] = acc[m][q];
      }
    }
  }
}
""", """        if (p < P) sc[(long long)n * P + p] = acc[m][q];
      }
    }
  }
  if (g.nc == 1) return;
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = arrivals + b * g.H + h;
    last = atomicAdd(counter, 1) == g.nc * npt - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (g.N * g.P % 4 == 0)
    state_pass<float4>(g, b, h, tid, kThreads);
  else
    state_pass<float>(g, b, h, tid, kThreads);
}
"""),
    ("  if (g.nc > 1) {", "  if (false) {"),
)
SSD_VARIANTS = {
    "state pass by the last state block": FUSED_PASS,
    "query tile 32": (("constexpr int TQ = 64;", "constexpr int TQ = 32;"),),
    "N slice 16": (("constexpr int NS = 64;", "constexpr int NS = 16;"),),
    "N slice 32": (("constexpr int NS = 64;", "constexpr int NS = 32;"),),
    "N slice 128": (("constexpr int NS = 64;", "constexpr int NS = 128;"),),
    "one ring stage": (("constexpr int kStages = 2;",
                        "constexpr int kStages = 1;"),),
    "three ring stages": (("constexpr int kStages = 2;",
                           "constexpr int kStages = 3;"),),
    "registers for 2 output blocks an SM": (
        ("constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 2;"),),
}
# paged_append: a 16-byte vector a thread where everything lies on 16
# bytes; other block sizes
APPEND_VARIANTS = {
    "16-byte vectors": (("""
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)""", """
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t row = (size_t)KD * (dtype == 0 ? 4 : 2);
  if (((size_t)k_pool | (size_t)v_pool | (size_t)k_new | (size_t)v_new
       | row) % 16 == 0)
    return launch<uint4>(k_pool, v_pool, k_new, v_new, tb, ln, nv, B, C,
                         (int)(row / 16), bs, bpr, scratch, s);
  if (dtype == 0)"""),),
    "32 threads": (("constexpr int kThreads = 64;",
                    "constexpr int kThreads = 32;"),),
    "128 threads": (("constexpr int kThreads = 64;",
                     "constexpr int kThreads = 128;"),),
}


def patched(name, patches, suffix=".cu"):
    """``csrc/<name><suffix>`` with each (old, new) replaced once."""
    with open(os.path.join(CSRC, f"{name}{suffix}")) as f:
        src = f.read()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}.cu: a patch no longer applies:\n"
                               f"{old}")
        src = src.replace(old, new)
    return src


def tile_harness():
    """A library with ``variant(x, w, out, G, M, K, N, tile, stream)``
    launching the fp32 kernel at ``TILES[tile]``, and ``variant_bf16(x,
    w, out, counts, G, M, K, N, tile, stream)`` the bf16 kernel at
    ``BF16_TILES[tile]``."""
    cases = "".join(
        f"    case {i}: return launch<Tile<{', '.join(map(str, t))}>>"
        f"(x, w, out, nullptr, G, M, K, N, vec, s);\n"
        for i, t in enumerate(TILES))
    bf16_cases = "".join(
        f"    case {i}: return tc::launch<tc::Tile<"
        f"{', '.join(map(str, t))}>>(x, w, out, c, G, M, K, N, vec, s);\n"
        for i, t in enumerate(BF16_TILES))
    return (f'#include "{os.path.join(CSRC, "branch_matmul.cu")}"\n'
            'extern "C" int variant(const void* x, const void* w, void* out,'
            ' int G, int M, int K, int N, int tile, void* stream) {\n'
            '  cudaStream_t s = static_cast<cudaStream_t>(stream);\n'
            '  const int vec = K % 4 == 0 && N % 4 == 0;\n'
            '  switch (tile) {\n' + cases + '  }\n  return -1;\n}\n'
            'extern "C" int variant_bf16(const void* x, const void* w, '
            'void* out, const void* counts, int G, int M, int K, int N, '
            'int tile, void* stream) {\n'
            '  cudaStream_t s = static_cast<cudaStream_t>(stream);\n'
            '  const int* c = static_cast<const int*>(counts);\n'
            '  const int vec = K % 8 == 0 && N % 8 == 0;\n'
            '  switch (tile) {\n' + bf16_cases + '  }\n  return -1;\n}\n')


def build(sources):
    """Compile {name: source text, or {file name: text} whose first file
    is the one compiled (the others are the headers it includes, in its
    own directory)} in parallel; returns {name: CDLL}."""
    from repro_torch.kernels import _build

    procs = {}
    for name, src in sources.items():
        files = src if isinstance(src, dict) else {f"{name}.cu": src}
        where = os.path.join(OUT, name)
        os.makedirs(where, exist_ok=True)
        for file, text in files.items():
            with open(os.path.join(where, file), "w") as f:
                f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o",
             os.path.join(where, f"lib{name}.so"),
             os.path.join(where, next(iter(files)))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(OUT, name, f"lib{name}.so"))
    return libs


def decode_sources(header_patches=(), cu_patches=()):
    """Both decode kernels' sources with the patches applied, each with
    its copy of the patched header."""
    header = patched("decode_tile", header_patches, suffix=".cuh")
    return {f"{name}.cu": patched(name, cu_patches) for name in DECODE}, \
        header


def variant_lib(label, name):
    """The library name of decode kernel ``name`` in variant ``label``."""
    return name + "_" + "".join(c if c.isalnum() else "_" for c in label)


def decode_variant_sources():
    """{variant label: {library name: files}} for the decode kernels."""
    out = {}
    for tiles in SPLIT_TILES:
        out[f"split {tiles} tiles"] = ((
            (SPLIT_LINE, f"  static constexpr int kSplitTiles = {tiles};"),),
            ())
    out["contiguous runs"] = (CONTIGUOUS_RUNS, ())
    out["no register cap"] = ((), NO_REGISTER_CAP)
    out["MHA 4 warps, chunks of 4"] = (MHA_AS_OTHERS, ())
    out["MHA 4 warps, chunks of 2, 8 blocks an SM"] = (MHA_NARROW, ())
    out["second combine kernel"] = (SECOND_KERNEL, COMBINE_LAUNCH)
    sources = {}
    for label, (hp, cp) in out.items():
        cus, header = decode_sources(hp, cp)
        for name in DECODE:
            sources[(label, name)] = {f"{name}.cu": cus[f"{name}.cu"],
                                      "decode_tile.cuh": header}
    return sources


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


def moe_gemm_variants(harness, device, flush):
    """Each of ``BF16_TILES`` at ``MOE_SHAPES`` (gate/up) with a top-k
    routing's counts, against the shipped kernel's bits and time."""
    from repro_torch.kernels import branch_matmul as bm
    from repro_torch.models.moe import Buckets

    fn = harness.variant_bf16
    fn.argtypes = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5 \
        + (ctypes.c_void_p,)
    fn.restype = ctypes.c_int
    gen = torch.Generator(device=device).manual_seed(5)
    stream = torch.cuda.current_stream(device).cuda_stream
    for label, E, k, T, K, N in MOE_SHAPES:
        logits = torch.randn((T, E), generator=gen, device=device) \
            + ROUTER_SKEW * torch.randn((E,), generator=gen, device=device)
        b = Buckets(torch.topk(logits, k, -1).indices, E)
        M = b.cap
        counts = b.counts.clamp(max=M).int()
        x = torch.randn((E, M, K), generator=gen, device=device,
                        dtype=torch.bfloat16)
        w = torch.randn((E, K, N), generator=gen, device=device,
                        dtype=torch.bfloat16).mul_(1 / (2 * np.sqrt(K)))
        want = bm.branch_matmul(x, w, counts)
        out = torch.empty_like(want)
        bound, by = cs.gemm_routed_bound(M, K, N, torch.bfloat16, counts)
        shipped = cs.median_ms(lambda: bm.branch_matmul(x, w, counts), flush,
                               10)
        bmm = cs.median_ms(lambda: torch.bmm(x, w), flush, 10)
        row = [f"shipped {shipped:.4f}", f"torch.bmm {bmm:.4f}",
               f"routed-work bound {bound:.5f} ({by})"]
        for i, tile in enumerate(BF16_TILES):
            def launch():
                return fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                          counts.data_ptr(), E, M, K, N, i, stream)
            if launch() != 0:
                raise RuntimeError(f"bf16 tile {tile}: launch failed")
            torch.cuda.synchronize()
            row.append(f"{tile} {cs.median_ms(launch, flush, 10):.4f}"
                       f"{'' if torch.equal(out, want) else ' (DIFFERS)'}")
        print(f"branch_matmul bf16 {label} gate/up G={E} M={M} K={K} N={N}"
              f", counts {int(counts.min())}-{int(counts.max())} "
              f"({int(counts.sum())} routed rows, {int((counts > 0).sum())}"
              f" groups with a row), ms (tile BM, BN, BK, warps over rows, "
              f"over columns, stages, blocks an SM; bit-identical to the "
              f"shipped kernel unless marked): " + "; ".join(row),
              flush=True)
        del x, w, want, out
        torch.cuda.empty_cache()


def decode_shapes(device):
    """(label, dense inputs, paged inputs) at chip_smoke.py's three timed
    shapes: every row at 100 of 160 slots (the dense main path; the paged
    case is the kernel phase's ragged main-path case), T=4096 full, and
    h2o-danube's GQA window case at T=8192."""
    rng = np.random.default_rng(2)
    gen = torch.Generator(device=device).manual_seed(1)
    dn = cs.DANUBE
    bf = torch.bfloat16
    T = cs.MAX_CONTEXT
    q, k, v, _ = cs.dense_decode_case(rng, cs.B, cs.H, cs.H, cs.D, T, bf,
                                      device)
    at100 = torch.full((cs.B,), 100, dtype=torch.int32, device=device)
    yield ("main path", (q, k, v, torch.arange(T, dtype=torch.int32,
                                              device=device), at100, 0),
           (*cs.decode_case(rng, cs.H, bf, device), 0))
    for label, H_, K, D_, T, window in (
            (f"T={cs.DA_LONG_T} full", cs.H, cs.H, cs.D, cs.DA_LONG_T, 0),
            (f"GQA {dn['H']}/{dn['K']} D={dn['D']} T=8192 "
             f"window={dn['window']}", dn["H"], dn["K"], dn["D"], 8192,
             dn["window"])):
        full = np.full(cs.B, T - 1, np.int32)
        q, k, v, lens = cs.dense_decode_case(rng, cs.B, H_, K, D_, T, bf,
                                             device, lens=full)
        yield (label, (q, k, v, torch.arange(T, dtype=torch.int32,
                                             device=device), lens, window),
               (*cs.long_paged_case(gen, H_, K, D_, T // cs.BS, bf,
                                    device), window))


def decode_variants(libs, device, flush):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa

    mods = [importlib.import_module(f"repro_torch.kernels.{m}")
            for m in ("decode_attention.decode_attention",
                      "paged_attention.paged_attention")]
    labels = sorted({label for label, _ in libs}, key=str)

    @contextlib.contextmanager
    def variant(label):
        with contextlib.ExitStack() as stack:
            if label == "NaN-filled output and scratch":
                for mod in mods:
                    stack.enter_context(_swap(mod, "unfilled",
                                              contextlib.nullcontext))
            elif label != "shipped":
                for name in DECODE:
                    stack.enter_context(library(name, libs[(label, name)]))
            yield

    order = ["shipped", *labels, "NaN-filled output and scratch", "shipped"]
    for shape, dense, paged in decode_shapes(device):
        q, k, v, pos, lens, window = dense
        sdpa = cs.median_ms(lambda: cs.sdpa_decode(q, k, v, pos, lens,
                                                   window), flush)
        ref = {"dense": da.decode_attention(q, k, v, pos, lens,
                                            window=window, tile=cs.BS),
               "paged": pa.paged_decode_attention(*paged[:5],
                                                  window=paged[5])}
        runs = {
            "dense": lambda: da.decode_attention(q, k, v, pos, lens,
                                                 window=window, tile=cs.BS),
            "paged": lambda: pa.paged_decode_attention(*paged[:5],
                                                       window=paged[5])}
        row = []
        for label in order:
            with variant(label):
                for kind, run in runs.items():
                    same = torch.equal(run(), ref[kind])
                    ms = cs.median_ms(run, flush)
                    row.append(f"{kind} {label} {ms:.4f}"
                               f"{'' if same else ' (differs)'}")
        bound = cs.dense_decode_bound(q, k, pos, lens, window)[0]
        pbound = cs.decode_bound(paged[0], paged[1], paged[4], paged[5])[0]
        print(f"decode bf16 {shape}, ms (bit-identical to the shipped "
              f"kernel unless marked): " + "; ".join(row)
              + f"; SDPA {sdpa:.4f}; bound dense {bound:.5f}, paged "
              f"{pbound:.5f}", flush=True)
        del dense, paged, ref, runs
        torch.cuda.empty_cache()


def device_split(fn, n=20):
    """Mean device microseconds per call of ``fn``, by kernel name, from
    ``torch.profiler`` over n calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"(\w+)_kernel\b", e.name)
            name = m.group(1) if m else e.name
            split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / n
    return split


def ssd_variants(libs, device, flush):
    """Every ssd_scan variant beside the shipped kernel, in turns (shipped
    first and last), at chip_smoke.py's three timed shapes; and the
    shipped call's device time split by kernel."""
    from repro_torch.kernels import ssd_scan as ss

    rng = np.random.default_rng(4)
    order = ["shipped", *SSD_VARIANTS, "shipped"]
    for label, b, S, H, G, L, N, strided in cs.SSD_CASES:
        if label.startswith("odd"):
            continue
        args = cs.ssd_inputs(rng, b, S, H, G, N, device, strided)
        ref = ss.ssd_scan(*args, L)
        row = []
        for name in order:
            ctx = (contextlib.nullcontext() if name == "shipped"
                   else library("ssd_scan", libs[variant_lib(name,
                                                             "ssd_scan")]))
            with ctx:
                same = torch.equal(ss.ssd_scan(*args, L), ref)
                ms = cs.median_ms(lambda: ss.ssd_scan(*args, L), flush)
            row.append(f"{name} {ms:.4f}{'' if same else ' (differs)'}")
        plain = cs.median_ms(lambda: ss.ssd_scan_plain(*args, L), flush)
        print(f"ssd_scan {label} b={b} S={S} H={H} L={L} P={cs.SSD_P} N={N},"
              f" ms (bit-identical to the shipped kernel unless marked): "
              + "; ".join(row) + f"; plain {plain:.4f}; bound "
              f"{cs.ssd_bound(b, S, H, G, N)[0]:.5f}", flush=True)
        split = device_split(lambda: ss.ssd_scan(*args, L))
        print(f"ssd_scan {label}: device us per call by kernel (profiler, "
              f"L2 warm): " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in split.items()),
              flush=True)
        del args, ref
        torch.cuda.empty_cache()


def append_variants(libs, device, flush):
    """paged_append at the decode shape (bf16), each variant beside the
    shipped kernel, pools compared bit for bit."""
    from repro_torch.kernels import paged_attention as pa

    rng = np.random.default_rng(0)
    k1, v1, kn, vn, tables, lens, nv = cs.append_case(rng, torch.bfloat16,
                                                      device)
    want = [k1.clone(), v1.clone()]
    pa.paged_append(*want, kn, vn, tables, lens, nv)
    row = []
    for name in ["shipped", *APPEND_VARIANTS, "shipped"]:
        ctx = (contextlib.nullcontext() if name == "shipped"
               else library("paged_append",
                            libs[variant_lib(name, "paged_append")]))
        with ctx:
            got = [k1.clone(), v1.clone()]
            pa.paged_append(*got, kn, vn, tables, lens, nv)
            same = torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
            ms = cs.median_ms(lambda: pa.paged_append(
                *got, kn, vn, tables, lens, nv), flush)
        row.append(f"{name} {ms:.4f}{'' if same else ' (differs)'}")
    print(f"paged_append bf16 B={cs.B} C=1 K={cs.H} D={cs.D}, ms (pools "
          f"bit-identical to the shipped kernel's unless marked): "
          + "; ".join(row), flush=True)


@contextlib.contextmanager
def _swap(obj, attr, value):
    saved = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, saved)


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
    decode = decode_variant_sources()
    libs = build({
        "flash_one_p_product": patched("flash_attention", ONE_P_PRODUCT),
        "flash_8_warps": patched("flash_attention", EIGHT_WARPS),
        "branch_matmul_tiles": tile_harness(),
        **{variant_lib(label, name): files
           for (label, name), files in decode.items()},
        **{variant_lib(label, name): patched(name, patches)
           for name, variants in (("ssd_scan", SSD_VARIANTS),
                                  ("paged_append", APPEND_VARIANTS))
           for label, patches in variants.items()}})
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    ssd_variants(libs, device, flush)
    append_variants(libs, device, flush)
    decode_variants({key: libs[variant_lib(*key)] for key in decode}, device,
                    flush)
    flash_variants(libs, device, flush)
    gemm_variants(libs["branch_matmul_tiles"], device, flush)
    moe_gemm_variants(libs["branch_matmul_tiles"], device, flush)
    prefill_variants(libs, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
