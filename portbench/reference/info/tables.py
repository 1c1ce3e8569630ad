"""Runtime wrapper over the generated state/map-object tables.

The reference bakes these into Rust arrays (info.rs: SpriteId 138 names,
StateId 967 variants, STATES, MAP_OBJECT_INFOS); here they are NumPy
arrays bound for device residency, so the map-object state machine can run
as pure vectorized indexing (see doomtpu.sim.thinkers).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class InfoTables:
    sprite_names: list[str]
    state_names: list[str]
    state_sprite: np.ndarray       # [NS] i32 index into sprite_names
    state_frame: np.ndarray        # [NS] i32 frame (A=0, B=1, ...)
    state_full_bright: np.ndarray  # [NS] bool
    state_tics: np.ndarray         # [NS] i32 (-1 = frozen)
    state_next: np.ndarray         # [NS] i32 next state id
    state_action: list[str]        # kept as names, never executed (info.rs:1271)

    mobj_names: list[str]
    mobj_doomednum: np.ndarray     # [NM] i32
    mobj_spawn: np.ndarray         # [NM] i32 state id
    mobj_death: np.ndarray         # [NM] i32 state id
    mobj_xdeath: np.ndarray        # [NM] i32 state id
    mobj_radius: np.ndarray        # [NM] i32 (FRACUNIT integer part)
    mobj_height: np.ndarray        # [NM] i32

    @property
    def num_states(self) -> int:
        return len(self.state_names)

    def state_id(self, name: str) -> int:
        return self.state_names.index(name)

    def mobj_index_by_doomednum(self) -> dict[int, int]:
        """doomednum -> info index (map_objects.rs:52-59)."""
        return {int(d): i for i, d in enumerate(self.mobj_doomednum)}


def load_default_tables() -> InfoTables:
    from portbench.reference.info import _tables as t

    i32 = lambda x: np.asarray(x, dtype=np.int32)
    return InfoTables(
        sprite_names=list(t.SPRITE_NAMES),
        state_names=list(t.STATE_NAMES),
        state_sprite=i32(t.STATE_SPRITE),
        state_frame=i32(t.STATE_FRAME),
        state_full_bright=np.asarray(t.STATE_FULL_BRIGHT, dtype=bool),
        state_tics=i32(t.STATE_TICS),
        state_next=i32(t.STATE_NEXT),
        state_action=list(t.STATE_ACTION),
        mobj_names=list(t.MOBJ_NAMES),
        mobj_doomednum=i32(t.MOBJ_DOOMEDNUM),
        mobj_spawn=i32(t.MOBJ_SPAWNSTATE),
        mobj_death=i32(t.MOBJ_DEATHSTATE),
        mobj_xdeath=i32(t.MOBJ_XDEATHSTATE),
        mobj_radius=i32(t.MOBJ_RADIUS),
        mobj_height=i32(t.MOBJ_HEIGHT),
    )
