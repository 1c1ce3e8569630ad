"""k2_items.roofline_pct: kernel K2, ops/csrc/items.cu, as a share of its
roofline: the least time of its layer's bytes and operations
(roofline.items_layer, at the pixels the composite wrote in the same
calls, counted by a probe) over its device time, by kernel name, from
the profile."""

from portbench import roofline

SPANS = {}
PROBES = {"items_written_px": [("doomtpu_torch.render.things",
                                "composite_items",
                                roofline.items_written_px)]}


def read(trace):
    ms = trace.kernel_ms("items_kernel")
    written = trace.count("items_written_px")
    if ms is None or not written:
        return None
    s = trace.shape
    least_s, _ = roofline.items_layer(s["batch"], written,
                                      s["level"]).least_s()
    return 100.0 * least_s * 1e3 / ms
