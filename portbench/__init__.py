"""The benchmark of doomtpu_torch on one CUDA card (see run.py)."""
