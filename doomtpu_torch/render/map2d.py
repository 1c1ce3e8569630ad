"""2D overhead map rendering (game.rs:229-309).

Host-side NumPy: linedefs as Bresenham lines (yellow = two-sided, red =
one-sided, DONTDRAW skipped) plus the player arrow, scaled into the
screen with the reference's border/flip transform
(transform_vertex_to_point_for_map, game.rs:229-242).
"""

from __future__ import annotations

import math

import numpy as np

from doomtpu_torch.config import RenderConfig
from doomtpu_torch.level.tables import MapTables

MAP_BORDER = 20
DONTDRAW = 128
TWOSIDED = 4

COLOR_ONE_SIDED = (255, 0, 0)
COLOR_TWO_SIDED = (255, 255, 0)
COLOR_PLAYER = (255, 255, 0)


def _transform(t: MapTables, cfg: RenderConfig, x: float, y: float):
    left, right, top, bottom = t.bbox
    x_size = right - left
    y_size = bottom - top
    sw = cfg.width - MAP_BORDER * 2
    sh = cfg.height - MAP_BORDER * 2
    px = int(MAP_BORDER + (x - left) * sw / x_size)
    py = int(MAP_BORDER + sh - 1.0 - (y - top) * sh / y_size)
    return px, py


def _line(img, x0, y0, x1, y1, color):
    """Bresenham."""
    h, w = img.shape[:2]
    dx, dy = abs(x1 - x0), -abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx + dy
    while True:
        if 0 <= x0 < w and 0 <= y0 < h:
            img[y0, x0] = color
        if x0 == x1 and y0 == y1:
            break
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x0 += sx
        if e2 <= dx:
            err += dx
            y0 += sy


def render_map_2d(
    t: MapTables, cfg: RenderConfig, px: float, py: float, angle: float
) -> np.ndarray:
    img = np.zeros((cfg.height, cfg.width, 3), np.uint8)

    for li in range(len(t.line_flags)):
        flags = int(t.line_flags[li])
        if flags & DONTDRAW:
            continue
        color = COLOR_TWO_SIDED if flags & TWOSIDED else COLOR_ONE_SIDED
        v1 = t.vertexes[t.line_v[li, 0]]
        v2 = t.vertexes[t.line_v[li, 1]]
        x0, y0 = _transform(t, cfg, float(v1[0]), float(v1[1]))
        x1, y1 = _transform(t, cfg, float(v2[0]), float(v2[1]))
        _line(img, x0, y0, x1, y1, color)

    # player arrow (game.rs:286-309)
    length = cfg.width / 16.0
    arrow = cfg.width / 32.0
    ex = px + length * math.cos(angle)
    ey = py + length * math.sin(angle)
    p0 = _transform(t, cfg, px, py)
    p1 = _transform(t, cfg, ex, ey)
    _line(img, *p0, *p1, COLOR_PLAYER)
    for da in (-math.pi - math.pi / 4, -math.pi + math.pi / 4):
        ax = ex + arrow * math.cos(angle + da)
        ay = ey + arrow * math.sin(angle + da)
        pa = _transform(t, cfg, ax, ay)
        _line(img, *pa, *p1, COLOR_PLAYER)
    return img
