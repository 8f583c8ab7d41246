"""Feed-forward blocks: SwiGLU (llama family) and plain GELU (whisper).

Port of ``repro.models.mlp``; weights in the JAX layout (d_in, d_out).
"""

from __future__ import annotations

import torch
from torch import nn

from .common import activation, dense_init, param


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, act: str, gen, device,
                 dtype):
        super().__init__()
        self.act = act
        if act == "silu":  # SwiGLU: gate + up + down
            self.w_gate = param(dense_init(gen, (d_model, d_ff), device,
                                           dtype))
            self.w_up = param(dense_init(gen, (d_model, d_ff), device,
                                         dtype))
            self.w_down = param(dense_init(gen, (d_ff, d_model), device,
                                           dtype))
        else:
            self.w_gate = None
            self.w_up = param(dense_init(gen, (d_model, d_ff), device,
                                         dtype))
            self.b_up = param(torch.zeros(d_ff, device=device, dtype=dtype))
            self.w_down = param(dense_init(gen, (d_ff, d_model), device,
                                           dtype))
            self.b_down = param(torch.zeros(d_model, device=device,
                                            dtype=dtype))


def mlp(params: MLP, x):
    f = activation(params.act)
    if params.w_gate is not None:
        return (f(x @ params.w_gate) * (x @ params.w_up)) @ params.w_down
    h = f(x @ params.w_up + params.b_up)
    return h @ params.w_down + params.b_down
