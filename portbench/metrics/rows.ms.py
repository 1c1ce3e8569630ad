"""rows.ms: device ms a batch building the seg rows and the live-seg
lists, ops/paint.py (build_rows, live_drop and, under live reuse,
reuse_drop / kept_set).  The scan path calls build_rows from
render/walls.py, which bound the name with `from ... import`."""

SPANS = {"rows": [
    ("doomtpu_torch.ops.paint", "build_rows"),
    ("doomtpu_torch.ops.paint", "live_drop"),
    ("doomtpu_torch.ops.paint", "reuse_drop"),
    ("doomtpu_torch.ops.paint", "kept_set"),
    ("doomtpu_torch.render.walls", "build_rows"),
]}


def read(trace):
    return trace.span_device_ms("rows")
