"""STE interaction transformer over the 42 joint tokens (counterpart of
``dir_tpu/models/transformer.py``).

Kept from the reference: only blocks 1..depth-1 execute (block 0 is
never built here), one shared ``spatial_norm`` (eps 1e-6) runs after
every block, the block norms use eps 1e-6 and the head norm 1e-5, and
GELU is exact. LayerNorms compute in at least fp32 and return the trunk
dtype.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dir_tpu_torch.models.layers import linear


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype) -> torch.Tensor:
    ct = torch.promote_types(x.dtype, torch.float32)
    return F.layer_norm(x.to(ct), ln.normalized_shape, ln.weight.to(ct),
                        ln.bias.to(ct), ln.eps).to(dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(linear(x, self.fc1, self.dtype), approximate="none")
        return linear(x, self.fc2, self.dtype)


class Attention(nn.Module):
    """Standard multi-head self-attention, written out as matmuls."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.num_heads
        qkv = linear(x, self.qkv, self.dtype).reshape(b, n, 3,
                                                      self.num_heads, hd)
        q, k, v = qkv.unbind(dim=2)                    # (B, N, H, D)
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * hd ** -0.5
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, c)
        return linear(out, self.proj, self.dtype)


class Block(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 2.0,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(_layer_norm(x, self.norm1, self.dtype))
        return x + self.mlp(_layer_norm(x, self.norm2, self.dtype))


class STE(nn.Module):
    """Spatial transformer encoder over joint tokens."""

    def __init__(self, num_joints: int = 42, in_chans: int = 128,
                 out_dim: int = 64, depth: int = 4, num_heads: int = 4,
                 mlp_ratio: float = 2.0, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.spatial_pos_embed = nn.Parameter(
            torch.zeros(1, num_joints, in_chans))
        self.STEblocks = nn.ModuleDict(
            {str(i): Block(in_chans, num_heads, mlp_ratio, dtype)
             for i in range(1, depth)})
        self.spatial_norm = nn.LayerNorm(in_chans, eps=1e-6)
        self.head = nn.Sequential(nn.LayerNorm(in_chans, eps=1e-5),
                                  nn.Linear(in_chans, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, J2, C)
        x = x + self.spatial_pos_embed
        for block in self.STEblocks.values():
            x = _layer_norm(block(x), self.spatial_norm, self.dtype)
        x = _layer_norm(x, self.head[0], self.dtype)
        return linear(x, self.head[1], self.dtype)
