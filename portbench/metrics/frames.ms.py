"""frames.ms: device ms a tick of a rollout copying its frames into the
one tensor the rollout returns: the program's doom.frames ranges
(doomtpu_torch/trace.py), sim/step.py::rollout's torch.stack and
engine.rollout's torch.cat."""

SPANS = {"doom.frames": []}


def read(trace):
    return trace.span_device_ms("doom.frames")
