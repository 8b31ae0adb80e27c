"""The rest of tests/test_torch_pencil_single.py's cases (a file of their
own to keep each file's time down): 3 grad-h steps with the Balsara
switch, and a 4-step chunk with structure reuse, on a 2x2 grid against the
port's single-device window engine at 1e-8 (dts 1e-10).
"""
import numpy as np
import pytest

from tests.test_torch_pencil_single import (CFGS, _compare, _lattice,
                                            _pencils, _real, _single,
                                            check_steps)


@pytest.mark.parametrize("name", ["gradh_balsara"])
def test_pencil_step_matches_single_device(name):
    check_steps(name)


def test_pencil_chunk_reuse_matches_single_device():
    """Two-hop routes and window structures reused for 2 steps, corner
    ghosts included: the per-step-rebuilt single-device run."""
    cfg = CFGS["isothermal"]
    st, dom = _lattice()
    st0, ref, ref_dts = _single(st, cfg, dom, 4)
    recs = _pencils(st0, cfg, dom, (2, 2), [("chunk", 4, 2)])
    assert recs[0]["builds"] == 2
    np.testing.assert_allclose(recs[0]["dts"], ref_dts, rtol=1e-10)
    _compare(_real(recs[0]), ref, dom, ("vel", "u", "h", "rho", "P", "acc"),
             1e-8)
