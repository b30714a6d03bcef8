"""GraphSAGE over the network-topology probe graph, as PyTorch modules.

The port of dragonfly2_tpu/models/graphsage.py. A GraphSAGE encoder embeds
every host of the dense padded ``TopoGraph``; a pairwise head scores
(child, parent) candidates by predicted bandwidth.

Numerics follow the flax modules, so that weights carried over from the JAX
package give the same embeddings and scores: compute in bfloat16 with
float32 parameters; a Dense casts input, kernel and bias to bf16 and adds
the bias after the product; GELU is the tanh form (flax ``nn.gelu``);
LayerNorm takes its statistics in f32 with eps 1e-6; embeddings are
L2-normalised in f32. Module and parameter names follow the flax tree
(``encoder.SAGELayer_0.msg_nbr``, ``head.layers_0``) so that
models/weights.py maps one onto the other by name alone.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from dragonfly2_tpu_torch.models.features import EDGE_FEATURE_DIM, FEATURE_DIM, NODE_FEATURE_DIM
from dragonfly2_tpu_torch.observability.tracing import stage
from dragonfly2_tpu_torch.ops import sage_message
from dragonfly2_tpu_torch.ops.gelu import gelu


class TopoGraph(NamedTuple):
    """Dense padded topology graph (numpy arrays or tensors).

    node_feats: [N, F] float32 host features (models.features.NODE_FEATURE_NAMES)
    neighbors:  [N, K] int32 neighbor indices (padded slots point at 0)
    mask:       [N, K] float32 1.0 for real edges
    edge_feats: [N, K, E] float32 probe stats (rtt mean/std/min, probe count)
    """

    node_feats: np.ndarray | torch.Tensor
    neighbors: np.ndarray | torch.Tensor
    mask: np.ndarray | torch.Tensor
    edge_feats: np.ndarray | torch.Tensor

    def to(self, device: str | torch.device) -> "TopoGraph":
        """The same graph as tensors on ``device``."""
        return TopoGraph(*(torch.as_tensor(a).to(device) for a in self))


class GELU(nn.Module):
    """``gelu`` as a module, for the head's ``nn.Sequential``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x)


def _spread(x: torch.Tensor) -> bool:
    """x is a DTensor on a mesh of more than one device."""
    return isinstance(x, DTensor) and x.device_mesh.size() > 1


class _SumPartials(torch.autograd.Function):
    """Identity on a DTensor; its gradient's partial sums (``Partial``
    placements) are summed here, in the gradient's dtype, into the input's
    own placements, before the casts behind it in the backward round them."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        ctx.placements = t.placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        if any(p.is_partial() for p in g.placements):
            g = g.redistribute(placements=ctx.placements)
        return g


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=bf16, param_dtype=f32)``: bf16 product, then a
    bf16 bias add. ``weight`` is [out, in], the transpose of flax's kernel.

    On a mesh of more than one device DTensor takes a sum over a sharded
    dim (the product's contraction over "model" shards; a weight or bias
    gradient over "data" rows) as one partial sum per shard, in the
    operand's dtype: in bf16 each partial rounds before their sum does,
    where one device rounds the whole sum once (the mesh's gradient norm
    parted from one process by 8e-3 at a (1, 4) mesh, JAX's by 2e-4). There
    the product runs in f32 on the bf16-rounded operands, every partial sum
    is taken in f32, and each result rounds to bf16 once, where one
    device's does: the product, the bias add, each gradient.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if not _spread(x):
            y = F.linear(x.to(dt), self.weight.to(dt))
            return y if self.bias is None else y + self.bias.to(dt)
        y = F.linear(x.to(dt).float(), _SumPartials.apply(self.weight.to(dt).float()))
        if any(p.is_partial() for p in y.placements):
            y = y.redistribute(placements=[Replicate() if p.is_partial() else p for p in y.placements])
        y = y.to(dt)
        if self.bias is None:
            return y
        return (y.float() + _SumPartials.apply(self.bias.to(dt).float())).to(dt)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=bf16)``: eps 1e-6, mean and E[x²] in f32,
    the scale folded into the rsqrt, the result cast to bf16."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(features, eps=1e-6)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mu = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mu) * mul + self.bias).to(self.compute_dtype)


class SAGELayer(nn.Module):
    """One GraphSAGE layer with the pre-projection decomposition of the JAX
    package: W·[h_nbr; h_self; e] = Wn·h_nbr + Ws·h_self + We·e, so the node
    projections run at [N, H] and only the edge term is per edge."""

    def __init__(self, in_features: int, features: int, edge_dim: int = EDGE_FEATURE_DIM,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.msg_nbr = Dense(in_features, features, bias=False, dtype=dtype)
        self.msg_self = Dense(in_features, features, dtype=dtype)
        self.msg_edge = Dense(edge_dim, features, bias=False, dtype=dtype)
        self.Dense_0 = Dense(in_features, features, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(features, dtype=dtype)

    def forward(self, h: torch.Tensor, g: TopoGraph, graph: sage_message.Graph | None = None) -> torch.Tensor:
        """``graph``: g's side of the fused op, prepared once an encoder call
        (``GraphSAGE.forward`` passes one; a layer called alone makes its own)."""
        h = h.to(self.dtype)
        u = self.msg_nbr(h)
        s = self.msg_self(h)
        graph = graph or sage_message.Graph(g.edge_feats, g.neighbors, g.mask)
        if graph.takes(u, s, self.msg_edge.weight):
            # the card: the message path as one op, K3 forward and K4 backward
            with stage("gnn.sage.message"):
                agg = sage_message.fused(u, s, self.msg_edge.weight, graph)
        else:
            v = self.msg_edge(g.edge_feats.to(self.dtype))
            agg = sage_message.message_path(u, s, v, g.neighbors, g.mask)  # [N, F]
        out = gelu(self.Dense_0(h) + agg)
        return self.LayerNorm_0(out)


class GraphSAGE(nn.Module):
    """Encoder: TopoGraph -> L2-normalised per-node embeddings [N, embed_dim] (f32)."""

    def __init__(self, hidden: int = 256, embed_dim: int = 128, num_layers: int = 3,
                 node_dim: int = NODE_FEATURE_DIM, edge_dim: int = EDGE_FEATURE_DIM,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_layers = num_layers
        self.Dense_0 = Dense(node_dim, hidden, dtype=dtype)
        for i in range(num_layers):
            self.add_module(f"SAGELayer_{i}", SAGELayer(hidden, hidden, edge_dim, dtype))
        self.Dense_1 = Dense(hidden, embed_dim, dtype=dtype)

    def forward(self, g: TopoGraph) -> torch.Tensor:
        h = self.Dense_0(g.node_feats)
        # the fused op's side of g, checked, cast and (K4's index) built once for every layer
        graph = sage_message.Graph(g.edge_feats, g.neighbors, g.mask)
        for i in range(self.num_layers):
            h = getattr(self, f"SAGELayer_{i}")(h, g, graph)
        z = self.Dense_1(h).float()
        return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-6)


class TopoScorer(nn.Module):
    """GraphSAGE encoder + pairwise (child, parent) bandwidth head.

    forward(g, child_idx[B], parent_idx[B], pair_feats[B, Fp]) -> [B] in
    (0, 1): predicted normalized bandwidth, one batched call per round.
    The head's children are named ``layers_0`` .. ``layers_4`` as flax's
    ``nn.Sequential`` names them (the GELUs take 1 and 3).
    """

    def __init__(self, hidden: int = 256, embed_dim: int = 128, num_layers: int = 3,
                 head_hidden: int = 256, node_dim: int = NODE_FEATURE_DIM,
                 edge_dim: int = EDGE_FEATURE_DIM, pair_dim: int = FEATURE_DIM,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        # the flax module's fields, for whoever rebuilds or describes the model
        self.hidden, self.embed_dim, self.num_layers = hidden, embed_dim, num_layers
        self.head_hidden, self.dtype = head_hidden, dtype
        self.encoder = GraphSAGE(hidden, embed_dim, num_layers, node_dim, edge_dim, dtype)
        self.head = nn.Sequential(OrderedDict([
            ("layers_0", Dense(3 * embed_dim + pair_dim, head_hidden, dtype=dtype)),
            ("layers_1", GELU()),
            ("layers_2", Dense(head_hidden, head_hidden // 2, dtype=dtype)),
            ("layers_3", GELU()),
            ("layers_4", Dense(head_hidden // 2, 1, dtype=dtype)),
        ]))

    def forward(self, g: TopoGraph, child_idx: torch.Tensor, parent_idx: torch.Tensor,
                pair_feats: torch.Tensor) -> torch.Tensor:
        z = self.encoder(g)  # [N, D] float32
        zc = z.index_select(0, child_idx)
        zp = z.index_select(0, parent_idx)
        x = torch.cat([zc, zp, zc * zp, pair_feats.float()], dim=-1).to(self.dtype)
        return torch.sigmoid(self.head(x).float().squeeze(-1))

    def embed(self, g: TopoGraph) -> torch.Tensor:
        return self.encoder(g)
