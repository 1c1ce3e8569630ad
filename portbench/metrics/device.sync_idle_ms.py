"""device.sync_idle_ms: device ms a tick of a rollout or a render call
in which nothing runs on the device because of the host's round trips:
for each of the program's doom.sync ranges (doomtpu_torch/trace.py),
the stretch from the range's start until the first device operation
launched after the range ends starts (up to the end of the last device
operation where no launch follows), less the part of it that some
device operation covers (the copies of the round trip among them).
Stretches that overlap count once."""

from bisect import bisect_right

from portbench.tracing import _union

SPANS = {"doom.sync": []}


def _covered(busy, starts, a, b):
    """ns of [a, b] inside the sorted, disjoint intervals `busy`, whose
    starts are `starts`."""
    ns, i = 0, max(0, bisect_right(starts, a) - 1)
    while i < len(busy) and busy[i][0] < b:
        x, y = busy[i]
        ns += max(0, min(y, b) - max(x, a))
        i += 1
    return ns


def read(trace):
    rng = trace.ranges.get("doom.sync")
    if not rng or not trace.busy:
        return None
    launched = sorted((at, start) for start, _, _, at in trace.device
                      if at is not None)
    ats = [at for at, _ in launched]
    last = trace.busy[-1][1]
    stretches = []
    for a, b in rng:
        i = bisect_right(ats, b)
        end = launched[i][1] if i < len(launched) else last
        if end > a:
            stretches.append((a, end))
    starts = [x for x, _ in trace.busy]
    idle = sum((b - a) - _covered(trace.busy, starts, a, b)
               for a, b in _union(stretches))
    return idle / 1e6 / trace.batches
