"""k3_itempass.roofline_pct: kernel K3, ops/csrc/itempass.cu, as a share of
its roofline: the least time of its layer's bytes and operations
(roofline.items_layer, the yardstick of K2, which does the same layer's
work: sprites and masked mids over the frame) at the pixels the item
pass wrote in the same calls, counted by the probe below, over its
device time, by kernel name, from the profile."""

import torch

from portbench import roofline

SPANS = {}


def itempass_written_px(fn, level, cfg, items, paint_out):
    """The pixels the item pass (ops/itempass.py::item_pass, as
    render/frame.py binds it) writes: those whose idx, ld or rgb it
    changes.  K3 writes paint_out's planes in place, so they are cloned
    before the call.  A pixel an item rewrites with the very values it
    held goes uncounted, so the count is a lower bound."""
    planes = ("idx", "ld", "rgb")
    before = [paint_out[k].clone() for k in planes]
    out = fn(level, cfg, items, paint_out)
    changed = torch.zeros_like(before[0], dtype=torch.bool)
    for k, x0 in zip(planes, before):
        changed |= x0 != paint_out[k]
    return out, changed.sum()


PROBES = {"itempass_written_px": [("doomtpu_torch.render.frame", "item_pass",
                                   itempass_written_px)]}


def read(trace):
    ms = trace.kernel_ms("itempass_kernel")
    written = trace.count("itempass_written_px")
    if ms is None or not written:
        return None
    s = trace.shape
    least_s, _ = roofline.items_layer(s["batch"], written,
                                      s["level"]).least_s()
    return 100.0 * least_s * 1e3 / ms
