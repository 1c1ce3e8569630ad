"""host.syncs_per_batch: host round trips a tick of a rollout or a render
call: the program's doom.sync ranges (doomtpu_torch/trace.py), each a
read of device data by the host, or an upload that waits for the
device, with the host work between.  Each drains the device's queue."""

SPANS = {"doom.sync": []}


def read(trace):
    rng = trace.ranges.get("doom.sync")
    if not rng:
        return None
    return len(rng) / trace.batches
