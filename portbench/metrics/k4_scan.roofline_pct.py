"""k4_scan.roofline_pct: kernel K4, ops/csrc/scan.cu, as a share of its
roofline: the least time of its layer's bytes and operations
(roofline.scan_layer, at the spans the scan emitted in the same calls,
counted by a probe) over its device time, by kernel name, from the
profile."""

from portbench import roofline

SPANS = {}
PROBES = {"scan_spans": [("doomtpu_torch.render.walls", "scan",
                          roofline.scan_spans)]}


def read(trace):
    ms = trace.kernel_ms("scan_kernel")
    spans = trace.count("scan_spans")
    if ms is None or not spans:
        return None
    s = trace.shape
    least_s, _ = roofline.scan_layer(s["batch"], spans, s["level"]).least_s()
    return 100.0 * least_s * 1e3 / ms
