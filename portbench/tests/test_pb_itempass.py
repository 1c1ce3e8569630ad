"""The item-pass cell's readers (metrics/itempass.ms, k3_itempass.roofline_pct)
on the CPU: the K3 probe counts exactly the pixels the item pass changes,
on the name render/frame.py calls; a CPU profile, which has no K3, reads
no share; a hand-built trace with K3 in it reads the share of
roofline.items_layer; the doom.itempass ranges read as the span's time,
and a pipeline without them reads nothing.

Fixture: e1m1-scale at 64x48, B=4 spread poses (generate.spread_poses),
pools calibrated on the state rendered."""

import dataclasses

import pytest
import torch

from portbench import generate, manifest, roofline, tracing

CFG = {"level": "e1m1_scale_wad", "map": "e1m1"}
B, H, W = 4, 48, 64
READERS = {n: manifest.load_metric(n)
           for n in ("itempass.ms", "k3_itempass.roofline_pct")}


@pytest.fixture(scope="module")
def engine():
    from doomtpu_torch import DoomEngine
    from doomtpu_torch.config import RenderConfig

    config = manifest.read_json(manifest.config_path("e1m1-itempass"))
    render = dict(config["render"], width=W, height=H)
    eng = DoomEngine.from_wad_bytes(generate.wad_bytes(CFG), "e1m1",
                                    config=RenderConfig(**render),
                                    device="cpu")
    pos, ang = generate.spread_poses(eng.tables, B, generate.rng(3, 0))
    st = eng.new_game(B, pos=pos, angle=ang,
                      generator=torch.Generator().manual_seed(3))
    return eng.calibrate([st]), st


def _paint(eng, st):
    """The item pass's inputs: the paint stage's output and the pack."""
    from doomtpu_torch.ops.paint import render_paint
    from doomtpu_torch.render import camera as cam
    from doomtpu_torch.render import things

    lv, cfg = eng.level, eng.config
    px, py = st.pos[:, 0].contiguous(), st.pos[:, 1].contiguous()
    frame = cam.build_seg_frame(lv, cfg, px, py, st.angle, st.floor_height,
                                st.sector_light, st.timestamp)
    order = cam.seg_order(lv, cam.traversal_rank(lv, px, py))
    out = render_paint(lv, cfg, frame, order, st.angle, px, py,
                       st.floor_height)
    pack, _ = things.item_pack(lv, cfg, frame, order, px, py, st.angle,
                               st.floor_height, st.sector_light,
                               st.mobj_state)
    return out, pack


def test_probe_counts_the_pixels_the_item_pass_changes(engine):
    from doomtpu_torch.ops.itempass import item_pass_reference

    eng, st = engine
    out, pack = _paint(eng, st)
    before = [out[k].clone() for k in ("idx", "ld", "rgb")]
    item_pass_reference(eng.level, eng.config, pack, out)
    changed = torch.zeros_like(before[0], dtype=torch.bool)
    for k, x0 in zip(("idx", "ld", "rgb"), before):
        changed |= x0 != out[k]
    want = int(changed.sum())
    assert 0 < want < B * H * W

    probes = READERS["k3_itempass.roofline_pct"].PROBES
    assert [(m, a) for m, a, _ in probes["itempass_written_px"]] == [
        ("doomtpu_torch.render.frame", "item_pass")]
    with tracing.Probes(probes) as pr:
        idx, rgb = eng.render(st)
    assert pr.totals() == {"itempass_written_px": want}
    # the probe hands back the item pass's frame
    out2, pack2 = _paint(eng, st)
    assert torch.equal(idx, item_pass_reference(eng.level, eng.config, pack2,
                                                out2)[0])


def _profiled(eng, st):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.render(st)
    spans = {"doom.itempass": []}
    return tracing.Trace(prof, spans, batches=1, calls=1, plain_ms=1.0,
                         wall_s=1.0, shape={"batch": B, "height": H,
                                            "width": W, "level": None},
                         counts={"itempass_written_px": 1000})


def test_a_cpu_profile_reads_no_kernel_share(engine):
    eng, st = engine
    tr = _profiled(eng, st)
    assert READERS["k3_itempass.roofline_pct"].read(tr) is None
    # two ranges a render (the pack, K3's call), no device operation
    assert len(tr.ranges["doom.itempass"]) == 2
    assert READERS["itempass.ms"].read(tr) == 0


def test_a_pipeline_without_the_item_pass_reads_nothing(engine):
    eng, st = engine
    deferred = dataclasses.replace(
        eng, config=dataclasses.replace(eng.config,
                                        use_item_pass_kernel=False))
    tr = _profiled(deferred, st)
    assert READERS["itempass.ms"].read(tr) is None
    assert READERS["itempass.ms"].SPANS == {"doom.itempass": []}


def test_share_of_a_trace_with_k3():
    lv = roofline.level_bytes(generate.wad_bytes(CFG), "e1m1")
    tr = tracing.Trace.__new__(tracing.Trace)
    tr.batches = 2
    tr.shape = {"batch": 4096, "height": 200, "width": 320, "level": lv}
    tr.counts = {"itempass_written_px": 2 * 3_000_000}
    tr.device = [(0, 2_000_000, "itempass_kernel(Params)", 0),
                 (2_000_000, 4_000_000, "items_kernel(Params)", 0),
                 (5_000_000, 7_000_000, "itempass_kernel(Params)", 0)]
    least_s, bound = roofline.items_layer(4096, 3_000_000, lv).least_s()
    assert bound == "bytes"
    share = READERS["k3_itempass.roofline_pct"].read(tr)
    assert share == pytest.approx(100.0 * least_s * 1e3 / 2.0)
    tr.counts = {}
    assert READERS["k3_itempass.roofline_pct"].read(tr) is None
