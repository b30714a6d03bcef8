"""Seeded inputs of every cell: the synthetic cluster, its probe-graph
snapshots, scheduling rounds and the model's weights.

The benchmark's own frozen copy of the port's synthetic cluster
(``trainer/synthetic.make_cluster``): the same latent model (hosts in
datacentres, log-normal upload capacity, 5% seed peers, probe graphs that
are 75% intra-datacentre with RTTs from the datacentre's base, observed
bandwidth throttled by cross-datacentre RTT and parent load), drawn in bulk
with a ``torch.Generator`` on the device instead of a per-host numpy loop.
So the numbers differ from the port's generator and the distribution does
not. Later changes to the port's generator do not move the benchmark.

Imports torch alone: nothing of the program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.topo_scorer import param_shapes


class Graph(NamedTuple):
    node_feats: torch.Tensor  # [N, Fn] f32
    neighbors: torch.Tensor  # [N, K] int32, padded slots point at 0
    mask: torch.Tensor  # [N, K] f32, 1 for a probed edge
    edge_feats: torch.Tensor  # [N, K, 4] f32: rtt mean, std, min (/100 ms), probes (/30)


class Pairs(NamedTuple):
    child: torch.Tensor  # [P] int32
    parent: torch.Tensor  # [P] int32
    feats: torch.Tensor  # [P, Fp] f32
    label: torch.Tensor  # [P] f32 normalised observed bandwidth


class Cluster(NamedTuple):
    graph: Graph
    pairs: Pairs
    idc: torch.Tensor  # [N] datacentre of each host
    capacity: torch.Tensor  # [N] latent upload capacity
    rtt: torch.Tensor  # [N, K] probe mean RTT in seconds, before masking


def generator(seed: int, device: torch.device | str, stream: int) -> torch.Generator:
    """A generator for one input stream of ``seed``: the streams (cluster,
    weights, snapshots, rounds, batches) do not share numbers."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 16 + stream) % (2**63))
    return g


def _distinct_in_group(idc: torch.Tensor, count: int, g: torch.Generator) -> torch.Tensor:
    """For each host, ``count`` distinct other hosts of its datacentre
    ([N, count]); rows whose datacentre is smaller repeat their last pick,
    which the caller masks away by degree."""
    n, dev = idc.shape[0], idc.device
    order = torch.argsort(idc * n + torch.arange(n, device=dev))  # hosts grouped by datacentre
    sizes = torch.bincount(idc, minlength=int(idc.max()) + 1)
    starts = torch.cumsum(sizes, 0) - sizes
    pos = torch.empty(n, dtype=torch.long, device=dev)
    pos[order] = torch.arange(n, device=dev) - starts[idc[order]]  # rank inside the group
    m = sizes[idc]  # [N] group size
    width = int(sizes.max())
    keys = torch.rand(n, width - 1, generator=g, device=dev)
    cols = torch.arange(width - 1, device=dev)
    keys = torch.where(cols[None, :] < (m - 1)[:, None], keys, torch.full_like(keys, 2.0))
    take = min(count, width - 1)
    pick = torch.topk(keys, take, dim=1, largest=False).indices  # distinct ranks in [0, m-1)
    pick = pick + (pick >= pos[:, None]).long()  # skip the host itself
    pick = torch.minimum(pick, (m - 1).clamp(min=0)[:, None])
    return order[(starts[idc][:, None] + pick).clamp(max=n - 1)]


def pair_features(cl_idc, capacity, node_feats, child, parent, g, num_features: int):
    """Observed pair features and bandwidth labels for (child, parent) rows."""
    rows, dev = child.shape[0], child.device

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    same = (cl_idc[child] == cl_idc[parent]).float()
    rtt_penalty = torch.where(same > 0, torch.ones_like(same), 0.35 + 0.2 * rand(rows))
    load = node_feats[parent, 2]
    bw = capacity[parent] * rtt_penalty * (1.0 - 0.5 * load)
    bw = (bw * (1 + 0.08 * randn(rows))).clamp(0, 1)
    f = torch.zeros(rows, num_features, device=dev)
    f[:, 0] = rand(rows)
    f[:, 1] = node_feats[parent, 1]
    f[:, 2] = 1.0 - load
    f[:, 3] = node_feats[parent, 0]
    f[:, 4] = same
    f[:, 5] = same * (0.6 + 0.4 * rand(rows))
    f[:, 6] = torch.where(same > 0, 0.03, 0.5) * (1 + 0.2 * randn(rows))
    f[:, 7] = (0.2 + 0.3 * rand(rows)).clamp(0, 1)
    history = rand(rows) < 0.6
    f[:, 8] = torch.where(history, (bw * (1 + 0.25 * randn(rows))).clamp(0, 1), torch.zeros_like(bw))
    f[:, 9] = rand(rows) * 0.4
    f[:, 10] = rand(rows)
    f[:, 11] = 0.3 + 0.4 * rand(rows)
    f[:, 12] = load
    f[:, 13] = 0.0
    f[:, 14] = 1.0
    f[:, 15:] = rand(rows, num_features - 15)
    return f, bw


def _edge_feats(rtt_mean: torch.Tensor, mask: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    dev = rtt_mean.device
    rtt_std = rtt_mean * (0.05 + 0.2 * torch.rand(rtt_mean.shape, generator=g, device=dev))
    probes = torch.randint(3, 30, rtt_mean.shape, generator=g, device=dev).float()
    e = torch.stack([rtt_mean / 0.1, rtt_std / 0.1, (rtt_mean - rtt_std).clamp(min=0) / 0.1, probes / 30.0], -1)
    return e * mask[..., None]


def _degree_mask(n: int, k: int, g: torch.Generator, dev) -> torch.Tensor:
    deg = torch.randint(max(4, k // 2), k + 1, (n,), generator=g, device=dev)
    return (torch.arange(k, device=dev)[None, :] < deg[:, None]).float()


def make_cluster(c: dict, seed: int, device) -> Cluster:
    """The cluster of config ``c`` (keys ``hosts``, ``probe_neighbors``,
    ``intra_idc_share``, ``idcs``, ``pair_pool``, widths) from ``seed``."""
    n, k, idcs = c["hosts"], c["probe_neighbors"], c["idcs"]
    fn, fp = c["node_features"], c["pair_features"]
    g = generator(seed, device, 0)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=device)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    idc = torch.randint(0, idcs, (n,), generator=g, device=device)
    capacity = torch.exp(0.8 * randn(n))
    capacity = capacity / capacity.max()
    is_seed = (rand(n) < 0.05).float()
    capacity = torch.maximum(capacity, is_seed * 0.9)

    intra = _distinct_in_group(idc, int(k * c["intra_idc_share"]), g)
    others = torch.randint(0, n, (n, k - intra.shape[1]), generator=g, device=device)
    nbrs = torch.cat([intra, others], 1)
    mask = _degree_mask(n, k, g, device)
    neighbors = torch.where(mask > 0, nbrs, torch.zeros_like(nbrs)).int()
    same = idc[nbrs] == idc[:, None]
    base = 0.002 + 0.004 * rand(idcs)
    rtt = torch.where(same, base[idc][:, None].expand(n, k), 0.03 + 0.05 * rand(n, k))
    rtt = rtt * (1 + 0.1 * randn(n, k))
    edge_feats = _edge_feats(rtt, mask, g)

    nf = torch.zeros(n, fn, device=device)
    upload_success = (0.6 + 0.4 * capacity + 0.1 * randn(n)).clamp(0, 1)
    nf[:, 0] = is_seed
    nf[:, 1] = upload_success
    nf[:, 2] = (rand(n) * (1.2 - capacity)).clamp(0, 1)
    nf[:, 3] = 0.3 + 0.4 * rand(n)
    nf[:, 4] = 0.2 + 0.5 * rand(n)
    nf[:, 5] = (capacity + 0.2 * randn(n)).clamp(0, 1)
    nf[:, 6] = 0.5 * rand(n)
    nf[:, 7] = 0.3 + 0.3 * rand(n)
    nf[:, 8] = (idc % 16).float() / 16.0
    nf[:, 9] = (idc // 16 + idc % 7).float() / 8.0
    nf[:, 10] = nf[:, 8]
    nf[:, 11:] = rand(n, fn - 11) * 0.1

    child = torch.randint(0, n, (c["pair_pool"],), generator=g, device=device)
    parent = torch.randint(0, n, (c["pair_pool"],), generator=g, device=device)
    feats, label = pair_features(idc, capacity, nf, child, parent, g, fp)
    graph = Graph(nf, neighbors, mask, edge_feats)
    return Cluster(graph, Pairs(child.int(), parent.int(), feats, label), idc, capacity, rtt)


def snapshot_ring(cl: Cluster, seed: int, count: int, rtt_jitter: float, redraw_share: float) -> list[Graph]:
    """``count`` later probe-graph snapshots of the cluster: every probed
    edge's RTT re-measured (the mean jittered by ``rtt_jitter``, the
    spread and probe count drawn anew) and ``redraw_share`` of the hosts
    with a new probe degree, so that edges appear and drop out."""
    g0 = cl.graph
    n, k = g0.neighbors.shape
    dev = g0.neighbors.device
    g = generator(seed, dev, 2)
    ring = []
    for _ in range(count):
        redraw = torch.rand(n, generator=g, device=dev) < redraw_share
        mask = torch.where(redraw[:, None], _degree_mask(n, k, g, dev), g0.mask)
        rtt = cl.rtt * (1 + rtt_jitter * torch.randn(n, k, generator=g, device=dev))
        ring.append(Graph(g0.node_feats, g0.neighbors, mask, _edge_feats(rtt, mask, g)))
    return ring


def make_rounds(cl: Cluster, seed: int, rounds: int, candidates: int, num_features: int):
    """``rounds`` scheduling rounds of one child and ``candidates`` parents
    each: (child [R, C], parent [R, C], pair feats [R, C, Fp])."""
    n = cl.graph.node_feats.shape[0]
    dev = cl.graph.node_feats.device
    g = generator(seed, dev, 3)
    child = torch.randint(0, n, (rounds, 1), generator=g, device=dev).expand(rounds, candidates).reshape(-1)
    parent = torch.randint(0, n, (rounds * candidates,), generator=g, device=dev)
    feats, _ = pair_features(cl.idc, cl.capacity, cl.graph.node_feats, child, parent, g, num_features)
    return (child.reshape(rounds, candidates).int(), parent.reshape(rounds, candidates).int(),
            feats.reshape(rounds, candidates, num_features))


def make_weights(widths: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Float32 parameters keyed by flax path: kernels lecun-normal (a normal
    cut at two deviations, variance 1 / fan-in), biases 0.02 of that
    normal, LayerNorm scales 1 plus 0.02 of it. One draw for all leaves."""
    shapes = param_shapes(widths)
    total = sum(math.prod(s) for s in shapes.values())
    g = generator(seed, device, 1)
    u = torch.rand(total, generator=g, device=device, dtype=torch.float64)
    lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2.0, 2.0))
    x = (math.sqrt(2) * torch.erfinv(2 * (lo + u * (hi - lo)) - 1)).float()  # N(0, 1) cut at +-2
    std_cut = 0.87962566103423978  # deviation of that cut normal
    out, at = {}, 0
    for name, shape in shapes.items():
        size = math.prod(shape)
        t = x[at : at + size].reshape(shape) / std_cut
        at += size
        if name.endswith("/kernel"):
            t = t * math.sqrt(1.0 / shape[0])
        elif name.endswith("/scale"):
            t = 1.0 + 0.02 * t
        else:
            t = 0.02 * t
        out[name] = t.contiguous()
    return out


def batch_rows(seed_stream: torch.Generator, pool_rows: int, batch: int, steps: int, device) -> list[torch.Tensor]:
    """Each step's pool rows as the trainer draws them: ``randint`` over the
    pool with the trainer's generator, one draw per step."""
    return [torch.randint(0, pool_rows, (batch,), generator=seed_stream, device=device) for _ in range(steps)]
