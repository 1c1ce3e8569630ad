from doomtpu_torch.assets.bundle import LevelAssets  # noqa: F401
