"""Map geometry as flat struct-of-arrays tables (layer L1).

The reference builds an Rc pointer graph (map/mod.rs:33-78); a TPU renderer
wants fixed-shape integer/float arrays instead.  Record layouts follow the
WAD spec exactly as the reference reads them:

- THINGS     10 bytes (things.rs:25-44)
- LINEDEFS   14 bytes (linedefs.rs:34-75)
- SIDEDEFS   30 bytes (sidedefs.rs:19-44)
- VERTEXES    4 bytes (vertexes.rs:69-84)
- SEGS       12 bytes (segs.rs:17-42)
- SSECTORS    4 bytes (subsectors.rs:10-33)
- NODES      28 bytes (nodes.rs:45-83), bit 15 of a child = subsector
- SECTORS    26 bytes (sectors.rs:19-44)

Also precomputes what the vectorized renderer needs from the BSP tree:
each subsector's root-to-leaf path (node ids + which side the leaf is on),
so the per-camera front-to-back traversal order reduces to a rank compute
plus argsort (see doomtpu.render.order), and a subsector -> sector map for
O(depth) point-location queries (replacing renderer/bsp.rs:9-44).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from portbench.reference.wad.reader import MapLump, WadFile, fields_i16, fields_name

NODE_IS_SUBSECTOR = 1 << 15


@dataclass
class MapTables:
    name: str

    # THINGS
    thing_pos: np.ndarray      # [T, 2] f32
    thing_angle: np.ndarray    # [T] f32 radians
    thing_type: np.ndarray     # [T] i32
    thing_flags: np.ndarray    # [T] i32

    # geometry
    vertexes: np.ndarray       # [V, 2] f32

    # LINEDEFS
    line_v: np.ndarray         # [L, 2] i32 (start, end vertex)
    line_flags: np.ndarray     # [L] i32
    line_special: np.ndarray   # [L] i32
    line_tag: np.ndarray       # [L] i32
    line_sides: np.ndarray     # [L, 2] i32 (front, back; -1 = none)

    # SIDEDEFS
    side_offset: np.ndarray    # [S, 2] f32 (x, y texture offset)
    side_sector: np.ndarray    # [S] i32
    side_upper: list[str]
    side_lower: list[str]
    side_middle: list[str]

    # SECTORS
    sector_floor_h: np.ndarray   # [SEC] i32
    sector_ceil_h: np.ndarray    # [SEC] i32
    sector_light: np.ndarray     # [SEC] i32 (initial value; mutable sim state)
    sector_special: np.ndarray   # [SEC] i32
    sector_tag: np.ndarray       # [SEC] i32
    sector_floor_flat: list[str]
    sector_ceil_flat: list[str]

    # SEGS
    seg_v: np.ndarray          # [G, 2] i32
    seg_angle: np.ndarray      # [G] i32
    seg_line: np.ndarray       # [G] i32
    seg_dir: np.ndarray        # [G] i32 (0 = same as linedef)
    seg_offset: np.ndarray     # [G] i32

    # SSECTORS
    sub_nseg: np.ndarray       # [SS] i32
    sub_first: np.ndarray      # [SS] i32

    # NODES
    node_xy: np.ndarray        # [N, 2] f32 partition start
    node_dxy: np.ndarray       # [N, 2] f32 partition delta
    node_bbox: np.ndarray      # [N, 2, 4] f32 (right/left, t/b/l/r)
    node_child: np.ndarray     # [N, 2] i32 raw (right, left) with bit 15

    # derived
    root_node: int = -1
    bbox: np.ndarray = field(default=None)          # [4] f32 l,r,t,b (map bounds)
    sub_sector: np.ndarray = field(default=None)    # [SS] i32 sector per subsector
    sub_path_nodes: np.ndarray = field(default=None)  # [SS, D] i32 (pad -1)
    sub_path_left: np.ndarray = field(default=None)   # [SS, D] i8 1=left child
    sub_depth: np.ndarray = field(default=None)       # [SS] i32
    seg_sub: np.ndarray = field(default=None)          # [G] i32 subsector of seg

    @property
    def counts(self) -> dict:
        return {
            "things": len(self.thing_type), "vertexes": len(self.vertexes),
            "linedefs": len(self.line_flags), "sidedefs": len(self.side_sector),
            "sectors": len(self.sector_light), "segs": len(self.seg_line),
            "subsectors": len(self.sub_nseg), "nodes": len(self.node_child),
        }

    # ------------------------------------------------------------------
    @classmethod
    def load(cls, wad: WadFile, map_name: str) -> "MapTables":
        map_name = map_name.upper()

        th = wad.records(map_name, MapLump.THINGS, 10)
        thing_pos = np.stack(
            [fields_i16(th, 0), fields_i16(th, 2)], -1
        ).astype(np.float32)
        # degrees -> radians (things.rs:36)
        thing_angle = np.deg2rad(fields_i16(th, 4).astype(np.float32))

        vx = wad.records(map_name, MapLump.VERTEXES, 4)
        vertexes = np.stack([fields_i16(vx, 0), fields_i16(vx, 2)], -1).astype(
            np.float32
        )

        ld = wad.records(map_name, MapLump.LINEDEFS, 14)
        sd = wad.records(map_name, MapLump.SIDEDEFS, 30)
        sc = wad.records(map_name, MapLump.SECTORS, 26)
        sg = wad.records(map_name, MapLump.SEGS, 12)
        ss = wad.records(map_name, MapLump.SSECTORS, 4)
        nd = wad.records(map_name, MapLump.NODES, 28)

        i32 = lambda a: a.astype(np.int32)

        tables = cls(
            name=map_name,
            thing_pos=thing_pos,
            thing_angle=thing_angle,
            thing_type=i32(fields_i16(th, 6)),
            thing_flags=i32(fields_i16(th, 8)),
            vertexes=vertexes,
            line_v=np.stack([i32(fields_i16(ld, 0)), i32(fields_i16(ld, 2))], -1),
            line_flags=i32(fields_i16(ld, 4)),
            line_special=i32(fields_i16(ld, 6)),
            line_tag=i32(fields_i16(ld, 8)),
            line_sides=np.stack(
                [i32(fields_i16(ld, 10)), i32(fields_i16(ld, 12))], -1
            ),
            side_offset=np.stack(
                [fields_i16(sd, 0), fields_i16(sd, 2)], -1
            ).astype(np.float32),
            side_sector=i32(fields_i16(sd, 28)),
            side_upper=fields_name(sd, 4),
            side_lower=fields_name(sd, 12),
            side_middle=fields_name(sd, 20),
            sector_floor_h=i32(fields_i16(sc, 0)),
            sector_ceil_h=i32(fields_i16(sc, 2)),
            sector_light=i32(fields_i16(sc, 20)),
            sector_special=i32(fields_i16(sc, 22)),
            sector_tag=i32(fields_i16(sc, 24)),
            sector_floor_flat=fields_name(sc, 4),
            sector_ceil_flat=fields_name(sc, 12),
            seg_v=np.stack([i32(fields_i16(sg, 0)), i32(fields_i16(sg, 2))], -1),
            seg_angle=i32(fields_i16(sg, 4)),
            seg_line=i32(fields_i16(sg, 6)),
            seg_dir=i32(fields_i16(sg, 8) != 0),
            seg_offset=i32(fields_i16(sg, 10)),
            sub_nseg=i32(fields_i16(ss, 0)),
            sub_first=i32(fields_i16(ss, 2)),
            node_xy=np.stack([fields_i16(nd, 0), fields_i16(nd, 2)], -1).astype(
                np.float32
            ),
            node_dxy=np.stack([fields_i16(nd, 4), fields_i16(nd, 6)], -1).astype(
                np.float32
            ),
            node_bbox=np.stack(
                [
                    np.stack([fields_i16(nd, 8 + 2 * k) for k in range(4)], -1),
                    np.stack([fields_i16(nd, 16 + 2 * k) for k in range(4)], -1),
                ],
                1,
            ).astype(np.float32),
            node_child=np.stack(
                [i32(fields_i16(nd, 24)), i32(fields_i16(nd, 26))], -1
            ),
        )
        tables._derive()
        return tables

    # ------------------------------------------------------------------
    def _derive(self) -> None:
        # the last node is the root (nodes.rs:42-44, map/mod.rs:57)
        self.root_node = len(self.node_child) - 1

        # whole-map bounding box from linedef vertices (map/mod.rs:59-64)
        used = self.vertexes[self.line_v.ravel()]
        self.bbox = np.array(
            [used[:, 0].min(), used[:, 0].max(), used[:, 1].min(), used[:, 1].max()],
            dtype=np.float32,
        )

        # subsector -> sector: first seg with a facing sidedef (bsp.rs:26-40)
        n_sub = len(self.sub_nseg)
        sub_sector = np.full(n_sub, -1, dtype=np.int32)
        for s in range(n_sub):
            for g in range(
                self.sub_first[s], self.sub_first[s] + self.sub_nseg[s]
            ):
                line = self.seg_line[g]
                side_ix = self.line_sides[line, self.seg_dir[g]]
                if side_ix >= 0:
                    sub_sector[s] = self.side_sector[side_ix]
                    break
        self.sub_sector = sub_sector

        # seg -> subsector
        seg_sub = np.zeros(len(self.seg_line), dtype=np.int32)
        for s in range(n_sub):
            seg_sub[self.sub_first[s] : self.sub_first[s] + self.sub_nseg[s]] = s
        self.seg_sub = seg_sub

        # root-to-leaf path per subsector (for the rank-based traversal order)
        paths: dict[int, tuple[list[int], list[int]]] = {}

        def walk(node: int, node_path: list[int], side_path: list[int]):
            for side in (0, 1):  # 0 = right child, 1 = left child
                child = int(self.node_child[node, side]) & 0xFFFF
                if child & NODE_IS_SUBSECTOR:
                    paths[child & (NODE_IS_SUBSECTOR - 1)] = (
                        node_path + [node],
                        side_path + [side],
                    )
                else:
                    walk(child, node_path + [node], side_path + [side])

        import sys

        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, len(self.node_child) + 100))
        try:
            walk(self.root_node, [], [])
        finally:
            sys.setrecursionlimit(old_limit)

        depth = max(len(p[0]) for p in paths.values())
        self.sub_path_nodes = np.full((n_sub, depth), -1, dtype=np.int32)
        self.sub_path_left = np.zeros((n_sub, depth), dtype=np.int8)
        self.sub_depth = np.zeros(n_sub, dtype=np.int32)
        for s, (np_, sp_) in paths.items():
            d = len(np_)
            self.sub_path_nodes[s, :d] = np_
            self.sub_path_left[s, :d] = sp_
            self.sub_depth[s] = d

    # ------------------------------------------------------------------
    def player_start(self, thing_type: int = 1) -> tuple[np.ndarray, float]:
        """Position + angle of the first thing of the given type
        (things.rs:46-55)."""
        ix = np.nonzero(self.thing_type == thing_type)[0]
        if len(ix) == 0:
            raise ValueError(f"Could not find thing of type {thing_type}")
        i = int(ix[0])
        return self.thing_pos[i].copy(), float(self.thing_angle[i])

    def sector_at(self, x: float, y: float) -> int:
        """Host-side BSP point query (mirrors renderer/bsp.rs:9-44)."""
        node = self.root_node
        while True:
            sx, sy = self.node_xy[node]
            dx, dy = self.node_dxy[node]
            # is_left_of_line: cross(p - s, d) <= 0 (map/vertexes.rs:32-34)
            cross = (x - sx) * dy - (y - sy) * dx
            side = 1 if cross <= 0 else 0
            child = int(self.node_child[node, side]) & 0xFFFF
            if child & NODE_IS_SUBSECTOR:
                return int(self.sub_sector[child & (NODE_IS_SUBSECTOR - 1)])
            node = child
