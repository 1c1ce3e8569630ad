"""Where the reference's batched renderer (the port's arithmetic, which
the JAX package's renderer shares) departs from the scalar transcription
of the upstream renderer, on the CPU.

    python3 portbench/witness.py --level e1m1_scale_wad --traffic \
        render-spread --batch 12 --ticks 5 --seed 3141592653 [--upstream]

It makes the mix's inputs at the given batch and ticks, ticks the
reference, renders the last state with both renderers at 320x200 and
prints, for every camera that differs, its pose and each differing
pixel with both renderers' values.  The scalar renderer takes a division
by a constant as the JAX package does (a multiply by the f32
reciprocal), or with --upstream as the upstream renderer does.  It is
not part of a run: PERF.md keeps what it found.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import generate, manifest  # noqa: E402
from portbench.reference import Reference  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--level", default="e1m1_scale_wad")
    ap.add_argument("--traffic", default="render-spread")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=3)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--upstream", action="store_true")
    args = ap.parse_args(argv)
    cfg = {"level": args.level, "map": "e1m1"}
    mix = manifest.read_json(manifest.traffic_path(args.traffic))
    mix.update(batch=args.batch, ticks=args.ticks, chain=args.ticks + 1)
    inputs = generate.generate(mix, args.seed, generate.level_tables(cfg))
    ref = Reference(generate.wad_bytes(cfg), "e1m1", 320, 200, "cpu")
    ref.spec.reciprocal_constants = not args.upstream
    st = ref.initial(inputs.pos, inputs.angle,
                     torch.Generator().manual_seed(inputs.light_seed))
    for t in range(args.ticks):
        st = ref.tick(st, torch.as_tensor(inputs.controls[t]),
                      torch.as_tensor(inputs.draws[t]))
    idx, rgb = ref.render(st)
    differing = 0
    for b in range(args.batch):
        sidx, srgb = ref.render_scalar(st, b)
        bad = torch.nonzero((idx[b] != sidx) | (rgb[b] != srgb))
        if not len(bad):
            continue
        differing += 1
        print(f"camera {b}: pos {st.pos[b].tolist()} angle "
              f"{float(st.angle[b])} floor {float(st.floor_height[b])}: "
              f"{len(bad)} pixels")
        for y, x in bad.tolist()[:16]:
            print(f"  (row {y}, col {x}) batched idx {int(idx[b, y, x])} "
                  f"rgb {int(rgb[b, y, x]):06x}, scalar idx "
                  f"{int(sidx[y, x])} rgb {int(srgb[y, x]):06x}")
    print(f"{differing} of {args.batch} frames differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
