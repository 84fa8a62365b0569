"""Exact linear-sum assignment on the tensors' device (counterpart of
ops/hungarian.py): shortest augmenting paths with dual potentials
(Jonker-Volgenant / Crouse, the algorithm scipy uses), batched over images.

The loops have fixed bounds, so there is no per-image Python loop and no
host round trip: target row i's Dijkstra search scans at most i + 1 query
columns (i are assigned, the next one found free ends it), and its
augmenting path has at most i + 1 edges. Images whose search has ended sit
out the remaining iterations under a mask. Ties break to the lowest index,
as ``jnp.argmin`` does.
"""
from __future__ import annotations

import torch


def hungarian(cost):
    """Solve min-cost assignments for a batch of (Q, T) costs, Q >= T.

    Args:
        cost: (B, Q, T) floating costs, queries x targets.
    Returns:
        (B, T) int64: the optimal query index for each target.
    """
    B, Q, T = cost.shape
    costT = cost.transpose(1, 2)  # (B, T, Q): rows are targets
    dev, dtype = cost.device, cost.dtype
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)  # a fill: no host copy
    ar_b = torch.arange(B, device=dev)
    ar_t = torch.arange(T, device=dev)
    u = torch.zeros(B, T, dtype=dtype, device=dev)
    v = torch.zeros(B, Q, dtype=dtype, device=dev)
    col4row = torch.full((B, T), -1, dtype=torch.int64, device=dev)
    row4col = torch.full((B, Q), -1, dtype=torch.int64, device=dev)

    for cur in range(T):
        shortest = torch.full((B, Q), float("inf"), dtype=dtype, device=dev)
        path = torch.full((B, Q), -1, dtype=torch.int64, device=dev)
        scanned = torch.zeros(B, Q, dtype=torch.bool, device=dev)
        visited = torch.zeros(B, T, dtype=torch.bool, device=dev)
        sink = torch.full((B,), -1, dtype=torch.int64, device=dev)
        i = torch.full((B,), cur, dtype=torch.int64, device=dev)
        min_val = torch.zeros(B, dtype=dtype, device=dev)
        for _ in range(cur + 1):  # Dijkstra from row `cur`
            active = sink < 0
            visited = visited | (active[:, None] & (ar_t[None, :] == i[:, None]))
            r = min_val[:, None] + costT[ar_b, i] - u[ar_b, i][:, None] - v
            better = active[:, None] & (r < shortest) & ~scanned
            shortest = torch.where(better, r, shortest)
            path = torch.where(better, i[:, None], path)
            masked = torch.where(scanned, inf, shortest)
            j = torch.argmin(masked, dim=1)
            min_val = torch.where(active, masked[ar_b, j], min_val)
            scanned = scanned | (active[:, None] & (torch.arange(Q, device=dev) == j[:, None]))
            owner = row4col[ar_b, j]
            sink = torch.where(active & (owner < 0), j, sink)
            i = torch.where(active & (owner >= 0), owner, i)

        # Dual updates.
        u = u + torch.where(ar_t[None, :] == cur, min_val[:, None], 0.0)
        other = visited & (ar_t[None, :] != cur)
        u = u + torch.where(other, min_val[:, None] - shortest.gather(1, col4row.clamp_min(0)), 0.0)
        v = v - torch.where(scanned, min_val[:, None] - shortest, 0.0)

        # Augment along the alternating path that ends at `sink`.
        j = sink
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        for _ in range(cur + 1):
            keep = ~done
            i = path[ar_b, j]
            row4col = row4col.scatter(1, j[:, None], torch.where(keep, i, row4col[ar_b, j])[:, None])
            next_j = col4row[ar_b, i]
            col4row = col4row.scatter(1, i[:, None], torch.where(keep, j, col4row[ar_b, i])[:, None])
            finished = i == cur
            j = torch.where(keep & ~finished, next_j, j)
            done = done | finished
    return col4row
