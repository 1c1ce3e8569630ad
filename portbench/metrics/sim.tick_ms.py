"""sim.tick_ms: device ms a tick in the simulation step, sim/step.py::tick
(movement, sector lookup, light and map-object thinkers)."""

SPANS = {"sim.tick": [("doomtpu_torch.sim.step", "tick")]}


def read(trace):
    return trace.span_device_ms("sim.tick")
