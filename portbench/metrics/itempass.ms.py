"""itempass.ms: device ms a batch in the item pass, the program's
doom.itempass ranges (doomtpu_torch/trace.py): render/things.py::item_pack
(item selection and the per-item packs) and ops/itempass.py::item_pass
(K3), which run in the deferred pass's place on the item-pass pipeline.
A program without the span reads nothing."""

SPANS = {"doom.itempass": []}


def read(trace):
    return trace.span_device_ms("doom.itempass")
