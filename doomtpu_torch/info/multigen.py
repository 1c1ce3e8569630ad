"""Parser for the original Doom `multigen` data format.

The format (documented in the file's own header comments) is line based:

- ``;`` starts a comment
- ``S_NAME sprite frameletter[*] tics action nextstate`` defines a state;
  ``*`` after the frame letter marks it full-bright
- ``$ NAME`` opens a map-object info block; subsequent ``field value``
  lines set fields; the special first block ``$ DEFAULT`` provides the
  defaults each later block starts from
- ``N*FRACUNIT`` values are 16.16 fixed point; we keep the integer part
  (the reference does the same, multigen/src/main.rs:127-133)

This is a fresh implementation of the public format, used at build time to
generate doomtpu_torch/info/_tables.py.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


@dataclass
class ParsedState:
    name: str
    sprite: str
    frame: int
    full_bright: bool
    tics: int
    action: str
    next_state: str


@dataclass
class ParsedMobj:
    name: str
    fields: dict = field(default_factory=dict)


@dataclass
class MultigenData:
    states: list[ParsedState]
    mobjs: list[ParsedMobj]
    sprite_names: list[str]  # order of first appearance in state list


_FRACUNIT_RE = re.compile(r"^(-?\d+)\s*\*\s*FRACUNIT$")


def _parse_value(v: str):
    v = v.strip()
    m = _FRACUNIT_RE.match(v)
    if m:
        return int(m.group(1))
    try:
        return int(v)
    except ValueError:
        return v  # symbolic (state name, sfx name, flag expression)


def parse_multigen(text: str) -> MultigenData:
    states: list[ParsedState] = []
    mobjs: list[ParsedMobj] = []
    sprites: list[str] = []
    defaults: dict = {}
    current: ParsedMobj | None = None
    unique_counter = 0

    for raw_line in text.splitlines():
        line = raw_line.split(";", 1)[0].strip()
        if not line:
            continue

        if line.startswith("$"):
            tokens = line[1:].split()
            name = tokens[0]
            if name == "+":
                name = f"MT_UNNAMED{unique_counter}"
                unique_counter += 1
            if current is not None and current.name != "DEFAULT":
                mobjs.append(current)
            if name == "DEFAULT":
                # DEFAULT is itself emitted as entry 0, matching the
                # reference's MAP_OBJECT_INFOS[138] (info.rs:2258-2266)
                current = ParsedMobj("DEFAULT")
                defaults = current.fields
                mobjs.append(current)
            else:
                current = ParsedMobj(name, dict(defaults))
            # `$ NAME field value ...` pairs on the marker line itself
            for k, v in zip(tokens[1::2], tokens[2::2]):
                current.fields[k] = _parse_value(v)
            continue

        parts = line.split()
        if parts[0].startswith("S_") and len(parts) >= 6:
            name, sprite, frame_s, tics_s, action, next_s = parts[:6]
            full_bright = "*" in frame_s
            frame_letter = frame_s.rstrip("*")
            frame = ord(frame_letter[0]) - ord("A")
            if sprite not in sprites:
                sprites.append(sprite)
            states.append(
                ParsedState(
                    name=name, sprite=sprite, frame=frame,
                    # a stray '*' can trail the tics field in the original
                    # data (S_POSS_ATK2); full-bright comes from the frame
                    # field only, matching the reference codegen's output
                    full_bright=full_bright, tics=int(tics_s.rstrip("*")),
                    action=action, next_state=next_s,
                )
            )
            continue

        if current is not None and len(parts) >= 2:
            # property lines may carry several `field value` pairs
            for k, v in zip(parts[0::2], parts[1::2]):
                current.fields[k] = _parse_value(v)

    if current is not None and current.name != "DEFAULT":
        mobjs.append(current)

    return MultigenData(states=states, mobjs=mobjs, sprite_names=sprites)
