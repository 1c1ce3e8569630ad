"""Render configuration and derived projection constants.

The reference hardcodes a 1024x768 screen (game.rs:28-29) and derives the
projection constants from it (renderer/constants.rs:3-17).  Here the screen
size is a runtime parameter; the north-star config is 320x200.
"""

from dataclasses import dataclass, field


# Doom ran on 320x200 pixels displayed on 4:3 monitors (320x240 square
# pixels); the renderer projects on a virtually wider screen and squeezes
# x back (reference renderer/constants.rs:7-14).
ASPECT_RATIO_CORRECTION: float = 200.0 / 240.0

# Eye height above the floor in map units (reference renderer/constants.rs:3).
PLAYER_EYE_HEIGHT: float = 41.0

# Simulation tick rate (reference game.rs:32).
CLOCK_HZ: int = 35

# Sky texture dims + "90 degrees of view = one texture width"
# (reference renderer/visplanes.rs:50-57).
SKY_TEXTURE_WIDTH: int = 256
SKY_TEXTURE_HEIGHT: int = 128

FLAT_SIZE: int = 64  # flats are 64x64 tiles (reference graphics/flats.rs:9)


@dataclass(frozen=True)
class RenderConfig:
    """Screen geometry + span-pool capacities for one compiled renderer.

    All shapes downstream are static functions of this config, as required
    by XLA's trace-once compilation model.
    """

    width: int = 320
    height: int = 200
    # Fixed capacity of the per-column span pool the wall scan emits.
    # Doom-scale maps rarely exceed ~20 overlapping spans per column.
    span_capacity: int = 32
    # Optional cap on deferred items (sprites + masked mids) per frame:
    # 0 = draw all (bit-exact, reference behavior); N > 0 keeps only the
    # nearest N in painter order and counts drops in
    # aux["items_dropped"] (an RL-workload throughput knob — nearness is
    # not visibility, so capping can drop drawable items).
    max_visible_mobjs: int = 0
    # Per-column capacity of the deferred item pool (overlapping
    # sprites/masked-mids per screen column); the farthest overflow and
    # are counted in aux["item_overflow"].
    item_capacity: int = 8
    # Block-local item emission (render/things.deferred_pass): > 0
    # compacts each (camera tile, 128-column block) to its <= NB live
    # items BEFORE the presence/cumsum/one-hot emission, replacing the
    # [B, N, W] / [B, W, N, KI] dense operands (N = max_visible_mobjs
    # worst case, ~288 calibrated) with [.., NB, 128, KI] ones (census:
    # ~7 mean / 20 max live items per tile-block).  Bit-identical to
    # the dense path while aux["item_block_dropped"] == 0 (calibrate()
    # measures the peak; callers assert the counter like live_dropped).
    # 0 disables (dense path).
    item_block_capacity: int = 0
    # Cameras rendered per inner chunk: large batches are processed as a
    # lax.map over chunks so the peak [chunk, H, W] working set stays
    # inside HBM while the output frames accumulate at full batch size.
    render_chunk: int = 256
    # Morton-sort cameras by position before rendering (engine.render;
    # outputs are unsorted back, so frames are bit-identical).  Camera
    # tiles of 8 then see overlapping geometry, which shrinks the paint
    # kernel's per-tile live-seg/live-item lists.
    camera_sort: bool = True
    # Run the occlusion wall scan as a Pallas TPU kernel (VMEM-resident
    # span pool; see doomtpu/ops/pallas_scan.py).  Requires a TPU backend
    # and batch % 8 == 0; the lax.scan path is used otherwise.
    use_pallas_scan: bool = False
    # Draw walls/planes/sky INSIDE the Pallas scan kernel (paint-at-emit,
    # see doomtpu/ops/pallas_paint.py) instead of pool + resolve.  The
    # fastest path; requires level.paint_ok and batch % 4 == 0.
    use_pallas_paint: bool = False
    # Run the deferred item pass as its own Pallas kernel
    # (ops/pallas_itempass.py): per-column billboard math, sprite seg
    # clip, mid-pool match and the painter fold all in VMEM over the
    # paint kernel's pools — every [B, N, W] XLA array disappears.
    # Draws EVERY selected item (no per-column item_capacity cap —
    # exact reference painter semantics); requires level.itempaint_ok
    # and the paint path.  Falls back to the deferred pass otherwise.
    # OFF by default: wins 1.39x at B=256 clustered poses (129.0 ->
    # 92.6 ms/chunk) but LOSES at the bench's B=2048 spread poses
    # (1457.5 vs 1610.0 f/s/chip) — divergent per-camera sprite
    # rotations defeat the tile-uniform picture window fast path, and
    # the per-(tile, block) item visits are fixed-cost bound (PERF.md
    # cont. 5).  (A third variant — items painted inside the paint
    # kernel itself, `use_item_paint` — lost the same benchmarks and
    # was removed in round 3.)
    use_item_pass_kernel: bool = False
    # Per-column capacity of the masked-mid pool the paint kernel emits
    # (overlapping drawable two-sided mids per screen column).
    mid_capacity: int = 8
    # Per-column capacity of the paint kernel's sprite-CLIP pool (wall +
    # mid spans only — plane spans never clip sprites, so this can be
    # much smaller than span_capacity; the deferred pass's per-slot
    # clip reductions scale with it).  Overflow is counted at runtime.
    # The e1m1-scale fixture measures a max of 15 wall+mid spans per
    # column over 64 bench poses — 24 leaves real headroom (an overflow
    # silently weakens sprite clipping on dense columns).
    clip_capacity: int = 24
    # Input-compaction method cutover for the paint kernel: maps with
    # padded seg count <= this use the one-hot MXU compaction (measured
    # ~1.7x faster than a slice-gather at e1m1 sizes, but its one-hot
    # operand is [.., NBW*Gp, Gp+1] f32 — QUADRATIC in map size, ~1.7 GB
    # at 736 segs and ~13 GB at 2048); larger maps use the linear
    # slice-gather (bit-identical either way).
    paint_onehot_max_segs: int = 1024
    # Largest map (in segs) eligible for the paint kernel at all: the
    # compacted per-(tile, block) input packs are sized Gp rows per
    # block (static worst case), ~2 GB per 256-camera chunk at 4096
    # segs.  Bigger maps fall back to the scan-pool pipeline, whose
    # working set is G-independent.
    paint_max_segs: int = 4096
    # Static capacity of the per-(camera tile, column block) compacted
    # live-seg lists.  0 = the full (padded) seg count — always exact.
    # A smaller value shrinks the kernel's seg grid and every compacted
    # input pack proportionally (the bench census: live counts peak at
    # 385 of 736 — 81% of grid steps are dead); any (tile, block)
    # whose live count exceeds it has its FARTHEST segs dropped —
    # wrong pixels — counted per camera in aux["live_dropped"] so
    # benchmarks/tests can assert 0.
    paint_live_capacity: int = 0
    # Compact the paint kernel's live-seg lists PER CAMERA instead of
    # per camera TILE (the union over the tile's 8 cameras).  Each
    # camera's slot g holds its OWN g-th live seg — bit-identical
    # outputs by construction (the kernel's per-seg fields are already
    # per-camera rows) — but the grid length per (tile, block) becomes
    # max_b cnt_b instead of |union|, and paint_live_capacity rides the
    # per-camera peak (~2.6/8 of the union at the bench's spread
    # poses).  Costs an 8x-wider compaction argsort on the XLA side;
    # the pack gathers are per-camera either way.  Env override for
    # A/Bs: DOOMTPU_PAINT_PERCAM.
    paint_percam_compact: bool = False

    @property
    def camera_focus_x(self) -> float:
        return self.width / 2.0

    @property
    def camera_focus_y(self) -> float:
        return self.height / 2.0

    @property
    def game_screen_width(self) -> float:
        return self.width / ASPECT_RATIO_CORRECTION

    @property
    def game_camera_focus_x(self) -> float:
        return self.game_screen_width / 2.0


DEFAULT_CONFIG = RenderConfig()
