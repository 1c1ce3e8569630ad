"""resolve.ms: device ms a batch in the resolve and the shade of the scan
pipeline, render/resolve.py (resolve_frame, shade)."""

SPANS = {"resolve": [("doomtpu_torch.render.resolve", "resolve_frame"),
                     ("doomtpu_torch.render.resolve", "shade")]}


def read(trace):
    return trace.span_device_ms("resolve")
