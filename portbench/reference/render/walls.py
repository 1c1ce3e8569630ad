"""The occlusion wall scan into the unified span pool.

Counterpart of doomtpu/render/walls.py.  Per camera and screen column,
the scan walks the camera's active segs front to back with the
occlusion state (hor / fo / co) and appends fixed-size span records to
the column's pool; `render/resolve.py` turns the pool into pixels and
the deferred pass reads it as its clip and mid pools
(`render/things.py::pools_from_unified`).  `wall_scan` builds the
seg rows (ops/paint.py) and runs the plain scan (ops/scan.py).

The record format (span word + d1..d6: atlas column or plane light /
sky / flat, by|ty or plane height, off_y|tex_h, light|z-dist, uy1 bits,
seg id) is defined in ops/layout.py and re-exported here under the JAX
module's names.  Its 8-bit y fields clip rows to [-1, 254], as the JAX
package packs them: a screen taller than 255 rows loses walls and
planes below row 254 on this pipeline, there as here.  Slot order is
draw order: the resolve takes a pixel's last covering slot.
"""

from __future__ import annotations

from portbench.reference.config import RenderConfig
from portbench.reference.ops.layout import (  # noqa: F401  (JAX walls.py's names)
    KIND_CEIL, KIND_FLOOR, KIND_MID, KIND_WALL, N_PLANES, SPAN_DC, SPAN_E2B,
    SPAN_E2T, SPAN_NODRAW, pack16, pack_span, unpack_span,
)
from portbench.reference.ops.paint import build_rows
from portbench.reference.ops.scan import scan_reference
from portbench.reference.render.device import DeviceLevel


def wall_scan(level: DeviceLevel, cfg: RenderConfig, frame: dict, order):
    """Run the scan over B cameras.

    Returns (pool, cnt [B, W], overflow [B]); pool is (spans, [d1, d2,
    d3, d4, d5, d6]), each [B, W, K] with K = cfg.span_capacity, as views
    of the kernel's slot-major [B, K, W] store.  Slots at or past a
    column's cnt hold no record: the kernel leaves them unwritten and
    nothing reads them."""
    rows, scnt = build_rows(level, frame, order)
    out = scan_reference(level, cfg, rows, scnt)
    tr = lambda p: p.transpose(1, 2)
    store = out["pool"]
    pool = (tr(store[0]), [tr(store[i]) for i in range(1, 1 + N_PLANES)])
    return pool, out["cnt"], out["overflow"]
