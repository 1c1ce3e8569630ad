"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface (the seven kernel sources
include the shared `csrc/layout.cuh`; the Hopper probes' `probe_visit.cu` and
`probe_ybounds.cu` stand alone); a library of `VARIANTS` is a source
built with extra defines (the paint kernel's cost-probe levels).  At
first use it is compiled by nvcc into
`build/doomtpu_torch/` at the root of the checkout (a directory
.gitignore lists) and loaded with ctypes; the library's file name
carries a hash of the source, the headers and the flags, so an edited
source or header is rebuilt.  A library that reads seg rows reports its
row width, which must equal ops/layout.py's NR; the rows library also
spells the camera-stage fields it reads, which must equal ops/layout.py's
ROW_FIELDS + PIECE_FIELDS.  There is no fallback: a missing nvcc, a card
other than Hopper, a failed build or a row width or field list that
disagrees raises.  The host library `csrc/doomdec.cpp` (the picture
decoder, ops/native.py) is built the same way by `build_host_library`,
with the host C++ compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

from doomtpu_torch.ops.layout import NR, row_fields_spec

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "doomtpu_torch"

# -fmad=false: no multiply is contracted into an FMA (a contracted
# product flips `as i16` truncations at span boundaries); IEEE divide
# and sqrt stay on (no --use_fast_math).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_C = ctypes
_P = _C.c_void_p
_I = _C.c_int
_F = _C.c_float
_L = _C.c_longlong
# argtypes of every exported function, by library
_SIGNATURES = {
    "paint": {
        "doom_paint": (
            [_P, _P, _P, _P, _P, _I, _I,        # rows scnt drop camf cami B G
             _P, _I, _I, _P, _P, _P,            # tex, TH, TW, flats, sky, pal
             _I, _I, _I, _I, _I, _I,            # W, H, KM, KC, pow2, twq
             _F, _F, _F, _F, _F, _F, _F, _F]    # half_w half_h inv_aspect wx_c
            #                                     eye inv_w inv_h inv_255
            + [_I, _I]                          # tc, bands
            + [_P] * 8                          # idx ld rgb mpool cpool
            #                                     cnt_mid cnt_clip ovf
            + [_P],                             # stream
            _I,
        ),
        "doom_cuda_error_string": ([_I], _C.c_char_p),
        "doom_row_words": ([], _I),
        "doom_paint_blocks_per_sm": ([_I, _I, _I], _I),
    },
    "items": {
        "doom_items": (
            [_P] * 8                            # word col byty offth lz uy1
            #                                     vpx vpy
            + [_P, _P, _I, _I, _P]              # icnt, atlas, n, rows, pal
            + [_P] * 7                          # clip span d2 lsx lsy lex
            #                                     ley, clip cnt
            + [_I, _I, _I, _I, _I, _F]          # B W H KI KC inv_255
            + [_I, _I]                          # tc, bands
            + [_P, _P, _P, _P],                 # idx ld rgb stream
            _I,
        ),
        "doom_items_error_string": ([_I], _C.c_char_p),
        "doom_items_blocks_per_sm": ([_I, _I, _I, _I, _I], _I),
    },
    "itempass": {
        "doom_itempass": (
            [_P, _P, _I]                        # item packs i, f; N
            + [_P] * 7                          # clip span d2 lsx lsy lex
            #                                     ley, clip cnt
            + [_P] * 8                          # mid span d1..d6, mid cnt
            + [_P, _I, _I, _I, _I, _I, _I, _P]  # atlas n rows T TW spr0 PW
            #                                     pal
            + [_I, _I, _I, _I, _I, _F]          # B W H KC KM inv_255
            + [_I, _I]                          # tc, bands
            + [_P, _P, _P, _P],                 # idx ld rgb stream
            _I,
        ),
        "doom_itempass_error_string": ([_I], _C.c_char_p),
        "doom_itempass_blocks_per_sm": ([_I, _I, _I, _I, _I], _I),
    },
    "emit": {
        "doom_emit": (
            [_P, _P, _I]                        # item packs i, f; N
            + [_P] * 8                          # mid span d1..d6, mid cnt
            + [_L, _L, _L, _I]                  # mid strides b k w, KM
            + [_I] * 8                          # B W H KI G T spr0 PW
            + [_I, _I]                          # threads, table
            + [_P] * 5,                         # pool icnt overflow peak
            #                                     stream
            _I,
        ),
        "doom_emit_error_string": ([_I], _C.c_char_p),
        "doom_emit_blocks_per_sm": ([_I] * 5, _I),
    },
    "scan": {
        "doom_scan": (
            [_P, _P, _I, _I, _I, _I, _I, _I, _I]  # rows scnt B G W H K TW pow2
            + [_I]                              # tc
            + [_P, _P, _P, _P],                 # pool cnt ovf stream
            _I,
        ),
        "doom_scan_error_string": ([_I], _C.c_char_p),
        "doom_scan_blocks_per_sm": ([_I], _I),
        "doom_row_words": ([], _I),
    },
    "rows": {
        "doom_rows": (
            [_P, _I, _P, _P, _I, _P, _P]       # fields nfields order sky NF
            #                                     tex_h tex_w
            + [_I, _I, _P, _P, _P],             # B G rows scnt stream
            _I,
        ),
        "doom_live_drop": (
            [_P, _P, _P, _I, _I, _I, _I, _I]   # rows scnt order B G nbw gc tb
            + [_P, _P, _P],                     # drop dropped stream
            _I,
        ),
        "doom_rows_smem_bytes": ([_I], _I),
        "doom_rows_blocks_per_sm": ([_I], _I),
        "doom_live_drop_smem_bytes": ([_I, _I], _I),
        "doom_live_drop_blocks_per_sm": ([_I, _I], _I),
        "doom_rows_fields": ([], _C.c_char_p),
        "doom_rows_error_string": ([_I], _C.c_char_p),
        "doom_row_words": ([], _I),
    },
    "resolve": {
        "doom_resolve": (
            [_P] * 9                            # span d1..d5 cnt camf cami
            + [_P, _I, _I, _I, _I, _I, _P]      # atlas n rows TW sky_tex
            #                                     flat_off, pal
            + [_I] * 6                          # B W H K pow2 sky_opaque
            + [_F] * 8                          # focus_x focus_y inv_aspect
            #                                     wx_c eye inv_w inv_h inv_255
            + [_P, _P, _P, _P],                 # idx ld rgb stream
            _I,
        ),
        "doom_resolve_error_string": ([_I], _C.c_char_p),
        "doom_resolve_blocks_per_sm": ([_I], _I),
    },
    "probe_visit": {
        "probe_visit": (
            [_I, _I, _I, _P, _P, _I, _I, _I, _P, _P],  # construct blocks
            #                           threads x t n arg variant out stream
            _I,
        ),
        "probe_exact": ([_I, _P, _P, _P, _I, _I, _P], _I),  # passes w s
        #                                           out copies stored stream
        "probe_visit_names": ([], _C.c_char_p),
        "probe_visit_error_string": ([_I], _C.c_char_p),
    },
    "probe_ybounds": {
        "probe_ybounds": ([_I, _P, _P, _I, _I, _P, _P], _I),  # mode lo hi S
        #                                                 chunks out stream
        "probe_ybounds_full_chunks": ([_I, _P], _I),    # mode, *chunks
        "probe_ybounds_names": ([], _C.c_char_p),
        "probe_ybounds_error_string": ([_I], _C.c_char_p),
    },
}

# the cost probe's libraries (P6, scripts/probe_paint_cost.py's port): a
# kernel source built at a probe level (PAINT_PROBE in csrc/paint.cu;
# the full kernel is the level above the last), by library name ->
# (source, extra nvcc flags)
PROBE_LEVELS = {"paint": 3}
VARIANTS = {f"{src}_probe{n}": (src, (f"-D{src.upper()}_PROBE={n}",))
            for src, levels in PROBE_LEVELS.items()
            for n in range(1, levels + 1)}

_loaded: dict[str, ctypes.CDLL] = {}
# per library: seconds from the start of its build_libraries call until
# its nvcc ended (the builds of one call run side by side), and nvcc's
# output (also kept beside the library, `nvcc_output`)
build_seconds: dict[str, float] = {}
build_log: dict[str, str] = {}


def nvcc_path() -> str | None:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def _check_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA kernels need a CUDA device; none is visible")
    cap = torch.cuda.get_device_capability()
    if cap != (9, 0):
        raise RuntimeError(
            f"the kernels are built for sm_90a (Hopper); this card is "
            f"sm_{cap[0]}{cap[1]}"
        )


def _source(name: str) -> tuple[str, tuple[str, ...]]:
    return VARIANTS.get(name, (name, ()))


def _lib_path(name: str) -> Path:
    src, defines = _source(name)
    h = hashlib.sha256((CSRC / f"{src}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + defines).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_libraries(*names: str) -> None:
    """Build every named library not built yet, one nvcc per source, all
    started together.  Raises if any build fails."""
    todo = [n for n in names if n not in _loaded and not _lib_path(n).exists()]
    if not todo:
        return
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, PATH, "
                           "/usr/local/cuda/bin)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        src, defines = _source(name)
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp),
             str(CSRC / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs[name] = (proc, tmp)
    failed = []
    for name, (proc, tmp) in jobs.items():
        build_log[name] = proc.communicate()[0]
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}:\n{build_log[name]}")
        else:
            _lib_path(name).with_suffix(".log").write_text(build_log[name])
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))


def nvcc_output(name: str) -> str:
    """nvcc's output (ptxas's -v report) of the built library `name`."""
    if name not in build_log:
        build_log[name] = _lib_path(name).with_suffix(".log").read_text()
    return build_log[name]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built from csrc/<name>.cu on
    first use."""
    if name in _loaded:
        return _loaded[name]
    _check_device()
    build_libraries(name)
    lib = ctypes.CDLL(str(_lib_path(name)))
    src = _source(name)[0]
    for fn, (argtypes, restype) in _SIGNATURES[src].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    if "doom_row_words" in _SIGNATURES[src] and lib.doom_row_words() != NR:
        raise RuntimeError(
            f"csrc/{src}.cu reads {lib.doom_row_words()}-word seg rows; "
            f"ops/layout.py builds {NR}-word rows"
        )
    if ("doom_rows_fields" in _SIGNATURES[src]
            and lib.doom_rows_fields().decode() != row_fields_spec()):
        raise RuntimeError(
            f"csrc/{src}.cu reads the fields {lib.doom_rows_fields()!r}; "
            f"ops/layout.py passes {row_fields_spec()!r}"
        )
    _loaded[name] = lib
    return lib


def sass(name: str) -> str:
    """The SASS of the built library `name` (cuobjdump -sass, from the
    toolkit of the nvcc that built it)."""
    nvcc = nvcc_path()
    tool = Path(nvcc).parent / "cuobjdump" if nvcc else None
    if tool is None or not tool.exists():
        raise RuntimeError("cuobjdump not found beside nvcc")
    build_libraries(name)
    out = subprocess.run([str(tool), "-sass", str(_lib_path(name))],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {name}:\n{out.stderr}")
    return out.stdout


# host libraries: csrc/<name>.cpp built with the host C++ compiler (no
# card needed), flags as native/Makefile builds the JAX package's copy
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")


def cxx_path() -> str | None:
    return (os.environ.get("CXX") and shutil.which(os.environ["CXX"])) or \
        shutil.which("g++") or shutil.which("c++")


def host_library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_host_library(name: str) -> Path:
    """Build csrc/<name>.cpp into build/doomtpu_torch/ unless built;
    returns the library's path.  Raises without a C++ compiler or on a
    failed build."""
    path = host_library_path(name)
    if path.exists():
        return path
    cxx = cxx_path()
    if cxx is None:
        raise RuntimeError("no C++ compiler (CXX, g++, c++)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                          str(CSRC / f"{name}.cpp")],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {name}:\n{out.stderr}")
    os.replace(tmp, path)
    return path


def ptxas_resources(log: str) -> dict[str, dict]:
    """Per kernel function in nvcc's `-Xptxas -v` output `log`: its
    registers a thread, spill stores and spill loads (bytes) and static
    shared memory (bytes).  A function ptxas reports without a register
    line (a device function it did not inline) has spills only."""
    out: dict[str, dict] = {}
    entry = props = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            out.setdefault(entry, {})
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
            out.setdefault(props, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props is not None:
            out[props].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            out[entry].update(registers=int(m.group(1)),
                              smem_static=int(smem.group(1)) if smem else 0)
    return out
