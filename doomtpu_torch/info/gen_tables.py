"""Codegen: multigen data file -> doomtpu_torch/info/_tables.py.

Replaces the reference's offline codegen crate (multigen/src/main.rs, run
manually with its output committed); we do the same with Python:

    python -m doomtpu_torch.info.gen_tables path/to/multigen.txt

The emitted module contains only flat lists (no code), which
``doomtpu_torch.info.tables`` turns into NumPy arrays.
"""

from __future__ import annotations

import argparse
import sys

from doomtpu_torch.info.multigen import parse_multigen

MOBJ_INT_FIELDS = [
    "doomednum", "reactiontime", "painchance", "speed", "radius", "height",
    "mass", "damage",
]
MOBJ_STATE_FIELDS = [
    "spawnstate", "seestate", "painstate", "meleestate", "missilestate",
    "deathstate", "xdeathstate", "raisestate",
]


def generate(text: str) -> str:
    data = parse_multigen(text)
    state_ix = {s.name: i for i, s in enumerate(data.states)}
    sprite_ix = {n: i for i, n in enumerate(data.sprite_names)}

    def state_ref(name) -> int:
        if isinstance(name, int):
            return name
        return state_ix.get(name, 0)

    lines = []
    w = lines.append
    w('"""Generated by doomtpu.info.gen_tables — do not edit.')
    w("")
    w("Doom state machine / map-object data tables, generated from a")
    w("multigen-format data file (original game data by id Software).")
    w('"""')
    w("")
    w("# fmt: off")
    w(f"SPRITE_NAMES = {data.sprite_names!r}")
    w("")
    w(f"STATE_NAMES = {[s.name for s in data.states]!r}")
    w(f"STATE_SPRITE = {[sprite_ix[s.sprite] for s in data.states]!r}")
    w(f"STATE_FRAME = {[s.frame for s in data.states]!r}")
    w(f"STATE_FULL_BRIGHT = {[int(s.full_bright) for s in data.states]!r}")
    w(f"STATE_TICS = {[s.tics for s in data.states]!r}")
    w(f"STATE_NEXT = {[state_ref(s.next_state) for s in data.states]!r}")
    w(f"STATE_ACTION = {[s.action for s in data.states]!r}")
    w("")
    w(f"MOBJ_NAMES = {[m.name for m in data.mobjs]!r}")
    for f in MOBJ_INT_FIELDS:
        vals = [int(m.fields.get(f, 0)) for m in data.mobjs]
        w(f"MOBJ_{f.upper()} = {vals!r}")
    for f in MOBJ_STATE_FIELDS:
        vals = [state_ref(m.fields.get(f, 0)) for m in data.mobjs]
        w(f"MOBJ_{f.upper()} = {vals!r}")
    flags = [str(m.fields.get("flags", 0)) for m in data.mobjs]
    w(f"MOBJ_FLAGS_EXPR = {flags!r}")
    w("# fmt: on")
    w("")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("source", help="multigen-format data file")
    ap.add_argument(
        "-o", "--output", default="doomtpu_torch/info/_tables.py",
        help="output module path",
    )
    args = ap.parse_args(argv)
    with open(args.source) as f:
        text = f.read()
    code = generate(text)
    with open(args.output, "w") as f:
        f.write(code)
    print(f"wrote {args.output}", file=sys.stderr)


if __name__ == "__main__":
    main()
