"""The batch split over devices (doomtpu_torch/parallel) on the CPU.

- the shard-local camera permutation (the render/camsort.py::sort_perm
  each shard of shard_batch's split sorts by) equals JAX's
  camsort.sort_state `loc` for S = 1, 2 and 4 at B=32 (eager jnp ops,
  no render jit);
- on [cpu, cpu] (a SplitEngine runs each shard on its device; here both
  are the CPU), render, render_walls, both counter calls, tick and a
  live-reuse rollout of a split state equal the unsplit engine's, the
  counters being the per-shard sums;
- replicate copies every tensor of the level and thinker tables, and a
  SplitEngine copies them only for devices other than the engine's.

Tolerance: exact equality.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_fixtures import spread_poses  # noqa: E402
from doomtpu.render import camsort as jcamsort  # noqa: E402
from doomtpu.sim.state import GameState as JaxState  # noqa: E402
from doomtpu_torch.config import RenderConfig  # noqa: E402
from doomtpu_torch.engine import DoomEngine  # noqa: E402
from doomtpu_torch.parallel import (  # noqa: E402
    SplitEngine, SplitState, make_mesh, replicate, shard_batch,
)
from doomtpu_torch.render.camsort import sort_perm  # noqa: E402
from doomtpu_torch.sim.player import (  # noqa: E402
    KEY_LEFT, KEY_SHIFT, KEY_UP,
)
from doomtpu_torch.wad import synth  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B = 32
# the paint path with per-camera live lists (so a rollout may reuse
# them) at a small screen; pools above the demo's peaks here
CFG = RenderConfig(width=64, height=48, span_capacity=16, mid_capacity=16,
                   clip_capacity=24, item_capacity=16, use_pallas_paint=True,
                   paint_percam_compact=True)


@pytest.fixture(scope="module")
def engine():
    return DoomEngine.from_wad_bytes(synth.demo_wad(), "e1m1", config=CFG,
                                     device="cpu")


@pytest.fixture(scope="module")
def state(engine):
    pos, ang = spread_poses(engine.tables, B, seed=4)
    return engine.new_game(B, pos=pos, angle=ang,
                           generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("S", [1, 2, 4])
def test_shard_local_perm_equals_jax(state, S):
    js = JaxState(**{f.name: jnp.asarray(getattr(state, f.name).numpy())
                     for f in dataclasses.fields(JaxState)})
    _, loc = jcamsort.sort_state(js, B, S)
    # what each shard of a split sorts by: its own cameras' permutation
    split = shard_batch(state, make_mesh(["cpu"] * S))
    assert [s.batch for s in split.shards] == [B // S] * S
    per_shard = [sort_perm(s.pos, s.angle) for s in split.shards]
    assert all(p.dtype == torch.int32 for p in per_shard)
    np.testing.assert_array_equal(torch.stack(per_shard).numpy(),
                                  np.asarray(loc))


def test_split_render_and_counters_equal_unsplit(engine, state):
    split_engine = SplitEngine(engine, ["cpu", "cpu"])
    split = split_engine.shard(state)
    assert isinstance(split, SplitState) and split.batch == B
    assert [s.batch for s in split.shards] == [B // 2, B // 2]
    for name in ("render", "render_walls"):
        got = getattr(split_engine, name)(split)
        for g, w in zip(got, getattr(engine, name)(state)):
            assert torch.equal(g, w), name
    for name in ("render_counters", "render_walls_counters"):
        per = [getattr(engine, name)(s) for s in split.shards]
        got = getattr(split_engine, name)(split)
        assert got == getattr(engine, name)(state)
        assert got == {k: sum(p[k] for p in per) for k in got}
    assert torch.equal(split.gather().pos, state.pos)


def test_split_tick_and_rollout_equal_unsplit(engine, state):
    split_engine = SplitEngine(engine, make_mesh(["cpu", "cpu"]))
    split = split_engine.shard(state)
    ctl = torch.tensor([KEY_UP, KEY_UP | KEY_LEFT, KEY_UP | KEY_SHIFT,
                        KEY_LEFT] * (B // 4), dtype=torch.int32)
    ticked = split_engine.tick(split, ctl)
    assert isinstance(ticked, SplitState)
    want = engine.tick(state, ctl)
    got = ticked.gather()
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), \
            f.name

    T = 4
    seq = ctl[None].expand(T, B)
    gf, gframes, gstale = split_engine.rollout(split, seq,
                                               max_ticks_per_jit=2,
                                               live_reuse=True)
    wf, wframes, wstale = engine.rollout(state, seq, max_ticks_per_jit=2,
                                         live_reuse=True)
    assert gframes.shape == (T, B, CFG.height, CFG.width)
    assert torch.equal(gframes, wframes)
    assert int(gstale) == int(wstale) > 0      # moving cameras go stale
    assert torch.equal(gf.gather().pos, wf.pos)
    _, gsums = split_engine.rollout(split, seq, return_frames=False)
    _, wsums = engine.rollout(state, seq, return_frames=False)
    assert torch.equal(gsums, wsums)


def test_replicate_copies_every_tensor(engine):
    for tables in (engine.level, engine.thinkers):
        copy = replicate(tables, "cpu")
        for f in dataclasses.fields(tables):
            a, b = getattr(tables, f.name), getattr(copy, f.name)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b) and a.dtype == b.dtype, f.name
            else:
                assert b is a, f.name
    # the engine's own device needs no copy; another device gets one
    split_engine = SplitEngine(engine, [torch.device("cpu")] * 2)
    assert list(split_engine.engines.values()) == [engine]
    meta = SplitEngine(engine, ["cpu", "meta"]).engines[torch.device("meta")]
    assert meta.level.seg_v1.is_meta and meta.device == torch.device("meta")
    assert meta.thinkers is not engine.thinkers
    with pytest.raises(ValueError):
        shard_batch(engine.new_game(6), make_mesh(["cpu"] * 4))
