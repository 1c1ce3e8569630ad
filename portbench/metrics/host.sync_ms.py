"""host.sync_ms: host ms a tick of a rollout or a render call spent in
the program's doom.sync ranges (doomtpu_torch/trace.py): blocked on the
device in its host round trips, and the host work between their
copies."""

SPANS = {"doom.sync": []}


def read(trace):
    return trace.span_host_ms("doom.sync")
