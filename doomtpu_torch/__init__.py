"""doomtpu_torch: the PyTorch / CUDA port of doomtpu for one NVIDIA H100.

The JAX package `doomtpu` is the reference; this package mirrors its
module names (render/jmath, render/device, render/camera, ...) and
imports only its host-side layers that never touch JAX (config, wad,
level, assets, info).  It renders walls, visplanes and sky through a
hand-written CUDA paint kernel (ops/csrc/paint.cu) on the card and
through that kernel's plain PyTorch version on the CPU.
"""

from doomtpu_torch.engine import DoomEngine  # noqa: F401
