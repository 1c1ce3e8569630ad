"""The correctness control at a size a test run holds: the reference in
bfloat16, put in the program's place, comes out not correct, and the
f32 reference in its place comes out correct (portbench/control.py runs
the control at the cells' own sizes on the card)."""

import pytest

from portbench import check, control, generate, manifest
from portbench.reference import Reference

CELLS = [w["name"] for w in manifest.load()["workloads"]]


def small(name: str) -> manifest.Cell:
    c = manifest.cell(name)
    c.config["render"].update(width=64, height=40)
    c.traffic.update(batch=8, ticks=3, chain=3)
    c.traffic["check"]["frames"] = 4
    return c


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_reference_is_not_correct(name):
    numbers = control.readings(small(name), 2**31 + 5, "cpu")
    assert not check.judge(numbers), numbers
    assert numbers["idx_px_differing"] > 0


def test_f32_reference_in_the_programs_place_is_correct():
    c = small("e1m1-paint.rollout-walk")
    inputs = generate.generate(c.traffic, 17, generate.level_tables(c.config))
    ref = Reference(generate.wad_bytes(c.config), "e1m1", 64, 40, "cpu")
    pairs = check.sample_pairs(inputs)
    expected = check.reference_run(ref, inputs, pairs)
    again = check.reference_run(ref, inputs, pairs)
    numbers = check.compare(check.Produced(again.states, again.frames),
                            expected, with_rgb=False)
    assert check.judge(numbers) and not any(numbers.values())
    assert set(numbers) >= {"state_elems_differing", "idx_px_differing"}
