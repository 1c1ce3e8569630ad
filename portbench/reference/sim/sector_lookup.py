"""Vectorized BSP point location (renderer/bsp.rs:9-44 equivalent).

Counterpart of doomtpu/sim/sector_lookup.py: every point walks the node
tree at once for tree-height steps, carrying the current node id; a
negative carry encodes the resolved subsector.
"""

from __future__ import annotations

import torch

from portbench.reference.level.tables import NODE_IS_SUBSECTOR
from portbench.reference.render.device import DeviceLevel
from portbench.reference.render.jmath import I32, f32, is_left_of


def subsector_at(level: DeviceLevel, px, py) -> torch.Tensor:
    """[B] subsector index for each point."""
    max_depth = level.sub_path_nodes.shape[1]
    root = level.node_child.shape[0] - 1
    px, py = f32(px), f32(py)
    node = torch.full(px.shape, root, dtype=I32, device=px.device)
    for _ in range(max_depth):
        n = torch.clamp(node, min=0).long()
        sx, sy = level.node_xy[n, 0], level.node_xy[n, 1]
        dx, dy = level.node_dxy[n, 0], level.node_dxy[n, 1]
        left = is_left_of(px, py, sx, sy, sx + dx, sy + dy)
        child = torch.where(
            left, level.node_child[n, 1], level.node_child[n, 0]
        ) & 0xFFFF
        is_leaf = (child & NODE_IS_SUBSECTOR) != 0
        nxt = torch.where(
            is_leaf, -(child & (NODE_IS_SUBSECTOR - 1)) - 1, child
        )
        node = torch.where(node < 0, node, nxt)
    return torch.where(node < 0, -node - 1, torch.zeros_like(node))


def sector_at(level: DeviceLevel, px, py) -> torch.Tensor:
    """[B] sector index (-1 if the subsector has no facing sidedef)."""
    return level.sub_sector[subsector_at(level, px, py).long()]
