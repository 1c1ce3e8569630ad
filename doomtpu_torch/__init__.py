"""doomtpu_torch: the PyTorch / CUDA port of doomtpu for one NVIDIA H100.

The JAX package `doomtpu` is the reference; this package mirrors its
module names (render/jmath, render/device, render/camera, ...) and
imports nothing of it: it keeps its own copies of the host layers it
reads (config, wad, level, assets, info).  It renders full frames
(walls, visplanes, sky, sprites, masked mids) through four hand-written
CUDA kernels on the card (ops/csrc: paint, items, itempass, scan) and
through their plain PyTorch versions on the CPU.
"""

from doomtpu_torch.engine import DoomEngine  # noqa: F401
