"""The paint kernel writes no pool slot past a column's count (its plain
version zero-fills them).  Nothing downstream may read such a slot.

Here, on the CPU, the paint stage's output gets its mid and clip pool
slots past each column's count filled with poison, and the frame of the
deferred pass (the item pool's mid fill, the item composite's clip),
the frame of the item pass (its clip and mid lookups) and
`render_counters` must not change.  A last case poisons the clip slots
below the count instead, and the frame must change: the check can see a
read.  Demo fixture, the four views of tests/test_paint.py at B=4,
320x200.  Tolerance: exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from doomtpu_torch.config import RenderConfig  # noqa: E402
from doomtpu_torch.engine import DoomEngine  # noqa: E402
from doomtpu_torch.ops import paint as tp  # noqa: E402
from doomtpu_torch.wad import synth  # noqa: E402

VIEWS = [
    (384.0, 256.0, 0.0),
    (900.0, 256.0, 2.5),
    (300.0, 700.0, 4.6),
    (384.0, 256.0, 3.1),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """Engines for the deferred pass and the item pass, a state, and
    what each draws and counts unpoisoned."""
    wad = synth.demo_wad()
    paint = RenderConfig(use_pallas_paint=True)
    engines = {
        "deferred": DoomEngine.from_wad_bytes(wad, "e1m1", config=paint,
                                              device="cpu"),
        "item pass": DoomEngine.from_wad_bytes(
            wad, "e1m1", config=RenderConfig(use_pallas_paint=True,
                                             use_item_pass_kernel=True),
            device="cpu"),
    }
    eng = engines["deferred"]
    st = eng.new_game(
        len(VIEWS), pos=np.asarray([v[:2] for v in VIEWS], np.float32),
        angle=np.asarray([v[2] for v in VIEWS], np.float32),
        generator=torch.Generator().manual_seed(0))
    return engines, st, _draw(engines, st)


def _draw(engines, st) -> dict:
    got = {name: eng.render(st) for name, eng in engines.items()}
    got["counters"] = engines["deferred"].render_counters(st)
    return got


def _poisoned(paint, slots: str, fill):
    """`paint` with its pools' slots past each column's count
    (`slots` = "tail"), or the clip pool's slots below it ("clip
    below"), replaced by fill(plane)."""
    def wrapped(*args):
        out = paint(*args)
        for pool, cnt in (("midpool", "cnt_mid"), ("clippool", "cnt_clip")):
            planes = out[pool]                          # [B, W, K] each
            K = planes[0].shape[2]
            tail = torch.arange(K) >= out[cnt][..., None]
            where = tail if slots == "tail" else ~tail
            if slots == "clip below" and pool == "midpool":
                continue
            # kept as [B, W, K] views of [B, K, W] planes, the kernel's
            out[pool] = tuple(
                torch.where(where, fill(p), p).transpose(1, 2).contiguous()
                .transpose(1, 2) for p in planes)
        return out
    return wrapped


def _random(p):
    g = torch.Generator().manual_seed(7)
    return torch.randint(-2 ** 31, 2 ** 31 - 1, p.shape, generator=g,
                         dtype=torch.int64).to(p.dtype)


POISONS = {"random bits": _random, "all ones": lambda p: torch.full_like(p, -1)}


@pytest.mark.parametrize("poison", sorted(POISONS))
def test_nothing_reads_pool_slots_past_the_count(scene, monkeypatch, poison):
    engines, st, want = scene
    monkeypatch.setattr(tp, "paint",
                        _poisoned(tp.paint, "tail", POISONS[poison]))
    got = _draw(engines, st)
    for name in engines:
        for g, w in zip(got[name], want[name]):
            assert torch.equal(g, w), name
    assert got["counters"] == want["counters"] == {
        k: 0 for k in want["counters"]}


def test_poisoned_clip_records_below_the_count_change_the_frame(
        scene, monkeypatch):
    engines, st, want = scene
    monkeypatch.setattr(tp, "paint", _poisoned(
        tp.paint, "clip below", POISONS["all ones"]))
    got = _draw(engines, st)
    for name in engines:
        assert not torch.equal(got[name][0], want[name][0]), name
