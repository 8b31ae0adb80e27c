"""The rest of ``tests/test_torch_pencil_lockstep.py``'s cases (a file of
their own to keep each file's time down): grad-h with the Balsara switch
(tests/dist/test_pencil.py's second configuration) on the 2x2 grid and on
the degenerate 2x1 grid, against ``sphax.dist.pencil`` at 1e-10.
"""
import pytest

from tests.test_torch_pencil_lockstep import check_case


@pytest.mark.parametrize("case", ["2x2-gradh_balsara", "2x1-gradh_balsara"])
def test_pencil_slice_matches_reference(case):
    check_case(case)
