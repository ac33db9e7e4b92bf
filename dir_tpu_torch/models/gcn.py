"""Semantic graph convolutions over the 21-joint hand skeleton
(counterpart of ``ResSimplePGCN`` in ``dir_tpu/models/gcn.py``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from dir_tpu_torch.models.layers import BatchNorm1d, bn_tokens

# 21-joint hand skeleton edges.
HAND_EDGES = (
    (0, 1), (1, 2), (2, 3), (3, 4),
    (0, 5), (5, 6), (6, 7), (7, 8),
    (0, 9), (9, 10), (10, 11), (11, 12),
    (0, 13), (13, 14), (14, 15), (15, 16),
    (0, 17), (17, 18), (18, 19), (19, 20),
)


def hand_adjacency(num_joints: int = 21) -> np.ndarray:
    """Symmetric binary one-hop adjacency of the skeleton, no self loops."""
    adj = np.zeros((num_joints, num_joints), np.float32)
    for i, j in HAND_EDGES:
        adj[i, j] = 1.0
        adj[j, i] = 1.0
    return adj


class PGraphConv(nn.Module):
    """Two-branch graph conv with per-node weights and a learned edge
    softmax: branch 0 over self loops, branch 1 over one-hop neighbours."""

    def __init__(self, in_features: int, out_features: int,
                 adjacency: np.ndarray, dtype=torch.float32):
        super().__init__()
        j = adjacency.shape[0]
        self.dtype = dtype
        self.W = nn.Parameter(torch.zeros(2, j, in_features, out_features))
        self.e_0 = nn.Parameter(torch.ones(1, j))
        flat_idx = np.nonzero(adjacency.reshape(-1) > 0)[0]
        self.e_1 = nn.Parameter(torch.ones(1, len(flat_idx)))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.register_buffer("flat_idx", torch.from_numpy(flat_idx),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, J, C)
        j = self.W.shape[1]
        dev = x.device
        # Edge-score softmax in fp32 with the -9e15 mask (single-edge rows
        # and the mask constant are ill-conditioned in bf16).
        neg = torch.full((j * j,), -9e15, dtype=torch.float32, device=dev)
        a0 = neg.clone()
        a0[torch.arange(j, device=dev) * (j + 1)] = self.e_0[0].float()
        a1 = neg.clone()
        a1[self.flat_idx] = self.e_1[0].float()
        a0 = torch.softmax(a0.reshape(j, j), dim=1).to(self.dtype)
        a1 = torch.softmax(a1.reshape(j, j), dim=1).to(self.dtype)

        w = self.W.to(self.dtype)
        x = x.to(self.dtype)
        h0 = torch.einsum("bjc,jcd->bjd", x, w[0])
        h1 = torch.einsum("bjc,jcd->bjd", x, w[1])
        out = (torch.einsum("jk,bkd->bjd", a0, h0)
               + torch.einsum("jk,bkd->bjd", a1, h1))
        return out + self.bias


class GraphConvBlock(nn.Module):
    """PGraphConv -> BatchNorm1d -> ReLU."""

    def __init__(self, in_features: int, out_features: int,
                 adjacency: np.ndarray, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.gconv = PGraphConv(in_features, out_features, adjacency, dtype)
        self.bn = BatchNorm1d(out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(bn_tokens(self.gconv(x).to(self.dtype), self.bn))


class ResSimplePGCN(nn.Module):
    """Constant-width stack of GraphConvBlocks (no residual connection,
    despite the name, as in the reference)."""

    def __init__(self, hidden_dim: int, num_layers: int = 4,
                 adjacency: np.ndarray | None = None, dtype=torch.float32):
        super().__init__()
        adj = hand_adjacency() if adjacency is None else adjacency
        self.gconv_layers = nn.ModuleList(
            GraphConvBlock(hidden_dim, hidden_dim, adj, dtype)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.gconv_layers:
            x = layer(x)
        return x
