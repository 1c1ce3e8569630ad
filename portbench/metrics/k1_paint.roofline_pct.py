"""k1_paint.roofline_pct: kernel K1, ops/csrc/paint.cu, as a share of its roofline: the
least time of its layer's bytes and operations (roofline.paint_layer) over
its device time, by kernel name, from the profile."""

from portbench import roofline

SPANS = {}


def read(trace):
    ms = trace.kernel_ms("paint_kernel")
    if ms is None:
        return None
    s = trace.shape
    least_s, _ = roofline.paint_layer(s["batch"], s["height"], s["width"],
                                 s["level"]).least_s()
    return 100.0 * least_s * 1e3 / ms
