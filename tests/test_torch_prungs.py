"""Block timesteps over the port's pencils (``sphax_torch.dist.prungs``)
against ``sphax.dist.prungs`` (``use_pallas=False`` on the conftest's fake
devices) on a 2x2 grid, from the same sharded arrays: the Sedov blast at
16^3 (tests/dist/test_prungs.py's set-up: B = 3, one span at
rebuild_every=2), with its h_predict case (test_prungs.py:93) and
Morris-Monaghan alpha(t); every field of the sharded state and the dts at
1e-10, the closings per tick, dt_viol, health and builds equal. The
off-centre blast, where a rank has no closer on a tick, is
tests/test_torch_prungs_offcentre.py.
"""
import dataclasses

import pytest
import torch

import sphax
from tests.test_torch_pencil_lockstep import check_records, run_both
from tests.test_torch_wrungs import _sedov

torch.set_num_threads(1)

SEDOV2 = dataclasses.replace(sphax.configs.SEDOV, newton_iters=2)
CFGS = {
    "sedov": SEDOV2,
    "h_predict": dataclasses.replace(sphax.configs.SEDOV, h_predict=True,
                                     newton_iters=1),
    "mm_visc": dataclasses.replace(SEDOV2, balsara=False, mm_visc=True),
}


def check_rungs(name, centre=(0.5, 0.5, 0.5), ops=(("rungs", 1, 3, 2),)):
    """``ops`` on the 2x2 grid against the JAX package; returns
    ``run_both``'s (port records, JAX records, the ranks' arguments)."""
    cfg = CFGS[name]
    st, dom = _sedov(cfg, centre=centre)
    out = run_both(cfg, st, dom, (2, 2), list(ops), dict(cutoff_scale=1.05))
    check_records(*out[:2], f"{name} at {centre}")
    # the blast spreads the rungs, so the masks bite
    assert all(w["nacts"].min() < st.n for w in out[1] if "nacts" in w)
    return out


@pytest.mark.parametrize("name", ["sedov", "mm_visc"])
def test_pencil_rungs_match_reference(name):
    check_rungs(name)
