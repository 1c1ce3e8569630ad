from doomtpu_torch.level.tables import MapTables  # noqa: F401
