"""Static game data tables (layer L3).

``multigen.py`` parses the original Doom `multigen` data format;
``gen_tables.py`` emits ``_tables.py`` from such a data file (replacing the
reference's offline codegen crate, multigen/src/main.rs).  The generated
module holds the 967-state sprite-animation machine and the 138 map-object
infos as flat arrays, ready to become device-resident constants.
"""

from doomtpu_torch.info.tables import InfoTables, load_default_tables  # noqa: F401
