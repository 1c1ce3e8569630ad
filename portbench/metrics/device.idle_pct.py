"""device.idle_pct: the share of a call in which no operation runs on the
device: 1 - (union of the device operations' intervals a call, under the
profiler) / (ms a call without the profiler, in the same process)."""

SPANS = {}


def read(trace):
    return 100.0 * trace.idle_share()
