"""The rest of ``tests/test_torch_wrungs.py``'s cases (a file of their own
to keep each file's time down): block timesteps with ``h_predict`` on 2
ranks, and the off-centre blast on 4 ranks: the work before and after a
work rebalance, the migration, and a span of B = 4 in which some rank has
no closer on the first tick, against ``sphax.dist.wrungs`` and
``sphax.dist.wslab`` at 1e-10.
"""
import pytest

from tests.test_torch_wrungs import check_case


@pytest.mark.parametrize("case", ["2-h_predict", "4-offcentre"])
def test_rungs_slice_matches_reference(case):
    check_case(case)
