"""camera.ms: device ms a batch in the camera stage, render/camsort.py and
render/camera.py: the Morton sort of the cameras and the unsort of the
frames, the seg frame, the traversal rank and the seg order.  The
callers bound the sort's names with `from ... import`, so those are
wrapped in the callers' namespaces."""

SPANS = {"camera": [
    ("doomtpu_torch.render.camera", "build_seg_frame"),
    ("doomtpu_torch.render.camera", "traversal_rank"),
    ("doomtpu_torch.render.camera", "seg_order"),
    ("doomtpu_torch.sim.step", "sort_perm"),
    ("doomtpu_torch.sim.step", "sort_state"),
    ("doomtpu_torch.sim.step", "unsort_out"),
    ("doomtpu_torch.engine", "sort_state"),
    ("doomtpu_torch.engine", "unsort_out"),
]}


def read(trace):
    return trace.span_device_ms("camera")
