"""deferred.ms: device ms a batch in the deferred pass,
render/things.py::deferred_pass (item selection, presence, emission,
mid fill and the item composite K2)."""

SPANS = {"deferred": [("doomtpu_torch.render.things", "deferred_pass")]}


def read(trace):
    return trace.span_device_ms("deferred")
