"""Fixtures the port's tests share, CPU and card alike: spread camera
poses, levels and pools altered to reach a kernel's rarer paths, a WAD
with a 256-row masked mid, a moving rollout on two devices, the kernel
launch counts and the census of synchronizing calls.

Not collected (no test_ prefix); imports no JAX, so the card-only tests
(tests/test_torch_cuda.py, run with --noconftest) may use it too.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def spread_poses(t, n, seed=0):
    """n random valid camera poses spread over the map (bench.py's rule):
    (positions [n, 2] f32, angles [n] f32)."""
    rng = np.random.default_rng(seed)
    poses = []
    left, right, top, bottom = [float(v) for v in t.bbox]
    while len(poses) < n:
        x = rng.uniform(left, right)
        y = rng.uniform(top, bottom)
        s = t.sector_at(x, y)
        if s >= 0 and t.sector_floor_h[s] < t.sector_ceil_h[s]:
            poses.append((x, y, rng.uniform(0, 2 * math.pi)))
    return (
        np.asarray([(p[0], p[1]) for p in poses], np.float32),
        np.asarray([p[2] for p in poses], np.float32),
    )


def sky_masked(level):
    """The level with transparent texels in its sky texture (every other
    column of its first 64 rows): the resolve's masked-sky fetch."""
    TW, R = level.tex_pixels.shape[2], level.atlas_rows
    atlas = level.atlas_cm.clone()
    sky = atlas[level.sky_tex * TW * R:(level.sky_tex + 1) * TW * R]
    sky.view(TW, R)[::2, :64] &= ~0x100
    return dataclasses.replace(level, atlas_cm=atlas, sky_is_opaque=False)


def tall_atlas(level, ipool, rows=256):
    """(level, ipool) for K2 at atlas_rows > 128: the level's column
    atlas re-laid `rows` rows a column (each column's rows repeated) and
    the item pool with every slot's picture height doubled, so the fold
    reads atlas rows past 128."""
    cols = level.atlas_cm.view(-1, level.atlas_rows)
    reps = -(-rows // level.atlas_rows)
    cm = cols.repeat(1, reps)[:, :rows].contiguous().view(-1)
    ip = ipool.clone()
    th = (ip[3] << 16) >> 16
    ip[3] = (ip[3] & -65536) | (torch.clamp(th * 2, max=rows) & 0xFFFF)
    return dataclasses.replace(level, atlas_cm=cm, atlas_rows=rows), ip


def tall_mid_wad(synth, builder, rows_128_255=0) -> bytes:
    """Two rooms 320 high, the portal between them hung with TALLMID: a
    64x256 masked texture (grate, step, then the patch `rows_128_255`
    over rows 128-255, then grate) from TEXTURE2, so the level's column
    atlas holds 256 rows; a barrel and a lamp.  Built with the given
    package's synth and builder modules (the port's, or the JAX
    package's in tests/test_torch_faults.py)."""
    rooms = [
        synth.RoomSpec(0, 0, 512, 512, floor_h=0, ceil_h=320, light=200,
                       mid_tex="TALLMID"),
        synth.RoomSpec(512, 0, 1024, 512, floor_h=0, ceil_h=320, light=160,
                       floor_flat="FLOOR2"),
    ]
    things = [synth.ThingSpec(96, 256, 0, 1),
              synth.ThingSpec(700, 200, 180, 2035),
              synth.ThingSpec(400, 320, 90, 2028)]
    b = builder.WadBuilder("IWAD")
    synth.standard_assets(b)
    # PNAMES: 0 PWALL, 1 PSTEP, 2 PGRATE, 4 PWIDE
    b.add("TEXTURE2", builder.encode_texture1([
        {"name": "TALLMID", "width": 64, "height": 256,
         "patches": [(0, 0, 2), (0, 64, 1), (0, 128, rows_128_255),
                     (0, 192, 2)]},
    ]))
    lb = synth.LevelBuilder(rooms, things)
    lb.build_walls()
    lb.build_bsp()
    lumps = lb.lumps()
    b.add("E1M1")
    for name in ("THINGS", "LINEDEFS", "SIDEDEFS", "VERTEXES", "SEGS",
                 "SSECTORS", "NODES", "SECTORS", "REJECT", "BLOCKMAP"):
        b.add(name, lumps[name])
    return b.build()


def kernels() -> dict:
    """The engine's kernel wrappers by name (the seg rows' two: the rows,
    and the per-camera live drop under a cap); each counts its launches
    in `.launches`."""
    from doomtpu_torch.ops import emit, itempass, items, paint, resolve, scan

    return {"paint": paint.paint, "items": items.composite_items,
            "scan": scan.scan, "itempass": itempass.item_pass,
            "resolve": resolve.resolve, "emit": emit.emit,
            "rows": paint.build_rows, "live_drop": paint.live_drop}


def launches(call) -> dict:
    """The kernel launches `call()` makes, by kernel (counts read after a
    synchronize), and its result: (launches, result)."""
    before = {k: fn.launches for k, fn in kernels().items()}
    out = call()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {k: fn.launches - before[k] for k, fn in kernels().items()}, out


# control masks of the moving rollouts (sim/player.py's bits): walk, turn,
# strafe, back up and run, one a camera in turn
MOVES = (1, 1 | 4, 1 | 8, 2, 16 | 4, 1 | 32, 4, 16 | 8 | 32)


def moving_controls(ticks, n):
    """[ticks, n] i32 controls: MOVES, one a camera in turn."""
    return torch.as_tensor(np.resize(np.asarray(MOVES, np.int32),
                                     (ticks, n)))


def moving_rollout(dev, cfg, live_reuse, n=16, ticks=4, seed=3):
    """An n-camera rollout of `ticks` ticks of moving controls on
    e1m1-scale under `cfg`, on `dev` and through the CPU port, with
    the same light draws.  Returns (differing elements per output: the
    final state field by field and the idx frames; live_stale on `dev`;
    the CPU port's; the kernel launches on `dev`)."""
    from doomtpu_torch.engine import DoomEngine
    from doomtpu_torch.wad import synth

    wad = synth.e1m1_scale_wad()
    card = DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg, device=dev)
    cpu = DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg, device="cpu")
    pos, ang = spread_poses(card.tables, n, seed)
    controls = moving_controls(ticks, n)
    draws = torch.randint(0, 1 << 30, (ticks, 2, n, card.level.num_sectors),
                          generator=torch.Generator().manual_seed(seed),
                          dtype=torch.int32)
    runs = []
    for eng in (card, cpu):
        st = eng.new_game(n, pos=pos, angle=ang,
                          generator=torch.Generator().manual_seed(seed))
        counts, r = launches(lambda: eng.rollout(st, controls, draws=draws,
                                                 live_reuse=live_reuse))
        if eng is card:
            card_launches = counts
        runs.append(r)
    (fc, frames_c, *stale_c), (fp, frames_p, *stale_p) = runs
    diffs = {f.name: (getattr(fc, f.name).cpu() != getattr(fp, f.name)).sum()
             .item() for f in dataclasses.fields(fc)}
    diffs["frames"] = (frames_c.cpu() != frames_p).sum().item()
    stale = lambda x: int(x[0]) if x else None
    return diffs, stale(stale_c), stale(stale_p), card_launches


def sync_census(call) -> dict:
    """Every synchronizing CUDA call `call()` makes, found by torch.cuda's
    sync debug mode: {"sites": the port's innermost three frames at each
    warning (the stack's innermost four where no frame is the port's),
    "inside": whether a doom.sync range held each (a `census.sync` mark
    is put in a CPU profile at the warning), "syncs": the doom.sync
    ranges opened, "nested": those inside another, "out": what `call()`
    returned}."""
    import traceback
    import warnings

    from torch.profiler import ProfilerActivity, profile, record_function

    sites = []

    def note(message, category, filename, lineno, file=None, line=None):
        # the mode's own notice on first use ("...does not yet detect
        # all synchronizing operations") is no synchronizing call
        if not str(message).startswith("called a synchronizing"):
            return
        with record_function("census.sync"):
            pass
        stack = traceback.extract_stack()[:-1]
        frames = [f for f in stack if "doomtpu_torch" in f.filename
                  and not f.filename.endswith("trace.py")][-3:] or stack[-4:]
        sites.append(" < ".join(
            f"{f.filename.split('doomtpu_torch/')[-1]}:{f.name}:{f.lineno}"
            for f in frames[::-1]) + f" (warned at {filename}:{lineno})")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        # the profiler's own start and stop synchronize: outside the mode
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ev = [(e.start_ns(), e.end_ns(), e.name())
          for e in prof.profiler.kineto_results.events()
          if e.name() in ("doom.sync", "census.sync")]
    syncs = sorted((a, b) for a, b, n in ev if n == "doom.sync")
    marks = sorted(a for a, _, n in ev if n == "census.sync")
    nested = sum(1 for i, (a, b) in enumerate(syncs)
                 if any(x <= a and b <= y for x, y in syncs[:i]))
    return {"sites": sites, "syncs": len(syncs), "nested": nested,
            "inside": [any(a <= m <= b for a, b in syncs) for m in marks],
            "out": out}
