from doomtpu_torch.wad.reader import WadFile, MapLump  # noqa: F401
from doomtpu_torch.wad.builder import WadBuilder  # noqa: F401
