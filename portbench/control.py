"""The correctness control: the reference computed in bfloat16, put in
the program's place, must come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--device cuda]

For each seed it makes the cell's inputs at the cell's own size, runs
the reference with every f32 product, division, square root and trig
value rounded to bfloat16 (reference/lowered.py) over the same states
and sampled frames the check compares, and compares that with the f32
reference exactly as a run compares the program (check.py).  It prints
one JSON line a seed: the numbers and whether they pass their limits.
The benchmark's own runs never run it; portbench/tests holds it at a
size a test run can hold.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import check, generate, manifest  # noqa: E402
from portbench.reference import Reference  # noqa: E402
from portbench.reference.lowered import bfloat16  # noqa: E402


def readings(cell: manifest.Cell, seed: int, device: str) -> dict:
    """The check's numbers of the bfloat16 reference in the program's
    place, against the f32 reference, for one seed."""
    wad = generate.wad_bytes(cell.config)
    inputs = generate.generate(cell.traffic, seed,
                               generate.level_tables(cell.config))
    r = cell.config["render"]
    ref = Reference(wad, cell.config["map"], r.get("width", 320),
                    r.get("height", 200), device)
    pairs = check.sample_pairs(inputs)
    expected = check.reference_run(ref, inputs, pairs)
    with bfloat16():
        low = check.reference_run(ref, inputs, pairs)
    produced = check.Produced(states=low.states, frames=low.frames)
    return check.compare(produced, expected,
                         with_rgb=inputs.kind == "render")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = readings(cell, seed, args.device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "numbers": numbers,
                          "correct": check.judge(numbers),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
