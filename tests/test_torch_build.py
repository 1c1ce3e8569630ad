"""The kernel build's resource report, on the CPU: ops/build.py's parse
of nvcc's `-Xptxas -v` output (the card's chip_smoke.py prints it for
every kernel library and fails on a spill), on a report in the form
ptxas 12.8 prints for sm_90a."""

import pytest

pytest.importorskip("torch")

from doomtpu_torch.ops import build  # noqa: E402

ENTRY = "_ZN46_GLOBAL__N__3f0c2b1a_7_scan_cu_5e8d9c2a11scan_kernelENS_6ParamsE"
HELPER = "_ZN46_GLOBAL__N__3f0c2b1a_7_scan_cu_5e8d9c2a8scan_segERKNS_6ParamsE"
REPORT = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Function properties for {HELPER}
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Compiling entry function '{ENTRY}' for 'sm_90a'
ptxas info    : Function properties for {ENTRY}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 6656 bytes smem, \
472 bytes cmem[0]
"""


def test_ptxas_report_gives_registers_spills_and_shared_memory():
    got = build.ptxas_resources(REPORT)
    assert got[ENTRY] == {"spill_stores": 0, "spill_loads": 0,
                          "registers": 40, "smem_static": 6656}
    # a device function ptxas did not inline: its spills count too
    assert got[HELPER] == {"spill_stores": 8, "spill_loads": 12}
    no_smem = REPORT.replace("6656 bytes smem, ", "")
    assert build.ptxas_resources(no_smem)[ENTRY]["smem_static"] == 0


def test_probe_builds_name_a_source_and_a_level():
    """The cost probe's builds (P6, the paint kernel's) name the paint
    kernel's source with a probe level."""
    assert set(build.VARIANTS) == {
        "paint_probe1", "paint_probe2", "paint_probe3"}
    for name, (src, flags) in build.VARIANTS.items():
        assert src in build._SIGNATURES
        assert flags == (f"-D{src.upper()}_PROBE={name[-1]}",)
