"""Operations and bytes of the served models, counted from shapes.

The count is of the work the algorithm needs, the same whatever
implements it: matmuls at 2 operations a multiply-add, causal attention
over the (query, key) pairs at or before each query, the SSD at
4·H·P·N a position, routed expert rows only (each token's top-k pairs),
never padded or capacity rows.  Elementwise passes and norms are left
out of the model count.
"""

from __future__ import annotations

from peaks import BF16_FLOPS, FP32_FLOPS, HBM_BYTES_S


def layer_token_flops(dm, i: int) -> float:
    """Operations a token costs in layer i, attention's core aside."""
    d = dm.d
    mixer, channel = dm.mixer(i), dm.channel(i)
    if mixer == "attn":
        n = 2 * d * (dm.H + 2 * dm.K) * dm.D + 2 * dm.H * dm.D * d
    else:
        proj = 2 * dm.di + 2 * dm.G * dm.N + dm.Hm
        n = (2 * d * proj + 2 * dm.Kw * dm.conv_dim
             + 4 * dm.Hm * dm.P * dm.N + 2 * dm.di * d)
    if channel == "moe":
        n += 2 * d * dm.E + dm.k * 3 * 2 * d * dm.f
    elif channel == "dense":
        n += 3 * 2 * d * dm.d_ff
    return float(n)


def n_layers(dm, mixer=None, channel=None) -> int:
    return sum(1 for m, c in dm.plan()
               if (mixer is None or m == mixer)
               and (channel is None or c == channel))


def token_flops(dm) -> float:
    return sum(layer_token_flops(dm, i) for i in range(dm.L))


def prefill_flops(dm, S: int) -> float:
    """One sequence of S tokens, the LM head at its last position only."""
    attn = 4 * dm.H * dm.D * S * (S + 1) / 2 * n_layers(dm, "attn")
    return S * token_flops(dm) + attn + 2 * dm.d * dm.V


def decode_flops(dm, cache_len: int) -> float:
    """One generated token at position ``cache_len`` (it attends to
    cache_len + 1 keys), with its LM head."""
    attn = 4 * dm.H * dm.D * (cache_len + 1) * n_layers(dm, "attn")
    return token_flops(dm) + attn + 2 * dm.d * dm.V


def _least(ops: float, nbytes: float, peak: float) -> float:
    return max(ops / peak, nbytes / HBM_BYTES_S)


def grouped_gemm_s(dm, rows: int, elt: int = 2) -> float:
    """Least time of one MoE layer's three expert GEMMs over ``rows``
    routed (token, expert) pairs: each routed row's operations; its
    input, output and the weights of the experts with a row read once
    (every expert, where rows >= experts)."""
    E_used = min(dm.E, rows)
    d, f = dm.d, dm.f
    gate = _least(2 * rows * d * f,
                  elt * (rows * d + E_used * d * f + rows * f), BF16_FLOPS)
    down = _least(2 * rows * f * d,
                  elt * (rows * f + E_used * f * d + rows * d), BF16_FLOPS)
    return 2 * gate + down


def ssd_scan_s(dm, S: int) -> float:
    """Least time of one SSD scan of S positions (fp32): 4·S·H·P·N
    operations on the CUDA cores; x, dt, B, C, A read once and y
    written once."""
    ops = 4 * S * dm.Hm * dm.P * dm.N
    nbytes = 4 * (2 * S * dm.Hm * dm.P + S * dm.Hm + 2 * S * dm.G * dm.N
                  + dm.Hm)
    return _least(ops, nbytes, FP32_FLOPS)


def flash_s(dm, S: int, elt: int = 2) -> float:
    """Least time of one causal attention over S positions: 4·H·D
    operations per (query, key) pair at or before the query; q, k, v
    read and o written once."""
    ops = 4 * dm.H * dm.D * S * (S + 1) / 2
    nbytes = elt * S * (2 * dm.H + 2 * dm.K) * dm.D
    return _least(ops, nbytes, BF16_FLOPS)


def paged_decode_s(dm, cache_lens, elt: int = 2) -> float:
    """Least time of one decode attention over rows at ``cache_lens``
    (active rows): each row's valid keys and values (cache_len + 1
    positions, the new token's included) read once, its query read and
    output written once."""
    pos = sum(int(c) + 1 for c in cache_lens)
    ops = 4 * dm.H * dm.D * pos
    nbytes = elt * (2 * dm.K * dm.D * pos
                    + 2 * dm.H * dm.D * len(cache_lens))
    return _least(ops, nbytes, BF16_FLOPS)
