"""Profiler ranges at the engine's layer boundaries.

Run a rollout or a render inside
`torch.profiler.profile(activities=[ProfilerActivity.CPU,
ProfilerActivity.CUDA])` and every `doom.*` range lands in the trace on
the clock of the device's own operations, so each stretch of device
time, and each gap, can be put down to the layer the host was in:

    doom.sim.tick   the simulation step (sim/step.py::tick)
    doom.sim.move   player movement, inside doom.sim.tick
    doom.camera     the camera sort and unsort, the seg frame, the
                    traversal rank and the seg order
    doom.rows       the seg rows and the live-seg lists
    doom.walls      the wall kernels: paint (K1) or wall scan (K4)
    doom.resolve    the scan pipeline's resolve and shade
    doom.deferred   the deferred pass: sprites, masked mids, K2
    doom.itempass   the item pass in the deferred pass's place: the
                    item pack and K3
    doom.frames     a rollout's copy of its frames into one tensor
    doom.sync       a host round trip: a read of device data by the
                    host, or an upload that waits for the device, and
                    the host work between

Outside a profiler a span is one flag check and opens nothing.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import profiler as _profiler

OFF = contextlib.nullcontext()


def span(name: str):
    """A `record_function(name)` range while a profiler records, else
    the shared no-op `OFF`."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return OFF


def spanned(name: str):
    """Decorator: every call of the function runs inside `span(name)`.
    The function keeps its name, module, docstring and signature."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return call
    return wrap
