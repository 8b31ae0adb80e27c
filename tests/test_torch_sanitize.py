"""How ``sphax_torch.sanitize.check`` reads compute-sanitizer's report,
on stand-in tools that print what the real one prints (the real tool runs
only on a card, ``chip_smoke.py`` phase 41): a refusal before any case
ran is no result and no kernel's fault; an error after a case names that
case; a clean run names none."""
import stat

import pytest

from sphax_torch import sanitize

M = sanitize.MARK
REPORTS = {
    "refused": (9, """========= COMPUTE-SANITIZER
========= Error: Device not supported. Please refer to the "Supported \
Devices" section of the sanitizer documentation
=========
========= Program hit cudaErrorUnknown (error 999) due to "unknown error" \
on CUDA API call to cudaMalloc.
========= ERROR SUMMARY: 3 errors
""", []),
    "clean": (0, f"""========= COMPUTE-SANITIZER
{M} A 3D in place unmasked float32
{M} G N=1 float32
49 cases launched
========= ERROR SUMMARY: 0 errors
""", []),
    "error": (9, f"""========= COMPUTE-SANITIZER
{M} A 3D in place unmasked float32
{M} C 3D compact partly masked float32
========= Invalid __global__ read of size 4 bytes
=========     at forces_compact_kernel+0x1a0
{M} G N=1 float32
========= Error: Race reported between Write access at reduce_slices
========= RACECHECK SUMMARY: 1 hazard displayed (1 error, 0 warnings)
""", ["C 3D compact partly masked float32", "G N=1 float32"]),
}


@pytest.mark.parametrize("kind", sorted(REPORTS))
def test_check_reads_the_report(kind, tmp_path):
    rc, text, errors = REPORTS[kind]
    (tmp_path / "report.txt").write_text(text)
    tool = tmp_path / "compute-sanitizer"
    tool.write_text(f"#!/bin/sh\ncat {tmp_path / 'report.txt'}\nexit {rc}\n")
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    r = sanitize.check("memcheck", str(tool))
    assert r["rc"] == rc and r["errors"] == errors
    assert r["cases"] == text.count(M)
    assert (r["refused"] is not None) == (kind == "refused")
    if kind == "refused":
        assert r["refused"].startswith("Error: Device not supported")
    assert "SUMMARY" in r["summary"]
