"""Run one cell of the benchmark once, on the CUDA card, and print its
result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
metrics (BENCHMARK.json).  Every run also checks the outputs of its
window against the plain reference (check.py) and prints the numbers
compared beside their limits, last on standard error and under "checked"
in the result.  The run fails, and prints no result, where there is no
CUDA card, too few of them, or where JAX or the JAX package is loaded
once the window has closed.  The kernel libraries are built into the
checkout (build/, a fixed path); calibration is not cached.
"""

import os
import time


def _process_start() -> float:
    """time.time() at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "doomtpu"}


def _fixed_caches() -> None:
    # every run calibrates afresh: its seed's states are new to the
    # census, and a cache hit on a repeated seed would make set-up
    # depend on which runs came before
    os.environ["DOOMTPU_CALIB_CACHE"] = "0"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def _card_line() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    _fixed_caches()
    import torch

    from portbench import cell as cell_mod
    from portbench import manifest

    c = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"portbench: {c.name} needs {c.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    cell_mod.log(f"card: {_card_line()}")
    result = cell_mod.run(c, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", STARTED)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"portbench: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 3
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, v in result["checked"].items():
        print(f"checked {name} {v['value']} limit {v['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
