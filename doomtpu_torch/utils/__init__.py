"""Host-side helpers."""

from doomtpu_torch.utils import fixed  # noqa: F401
