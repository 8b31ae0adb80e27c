"""The twin of ``tests/unit/test_sanitizers.py``: the port's derived passes
under a NaN sanitizer.

torch has no ``jax_debug_nans``; ``tests._torch_helpers.NanSanitizer`` (a
``TorchDispatchMode``) raises ``FloatingPointError`` at the first aten op
whose floating output holds a NaN. Pads, ghost images and trash rows flow
through the same ops as real rows, so a guard floor that lets a 0/0
through fails here even when the NaN is masked before any output. On the
JAX sanitizer test's state (8^3 jittered by 0.02, velocities 0.3 N(0,1),
h = 1.3/8, seed 12) and configuration (adaptive h with 4 Newton updates,
grad-h, Balsara, Morris-Monaghan): the window engine's plain derived pass,
and one KDK step of the dense engine.
"""
import numpy as np
import pytest
import torch

from sphax_torch import SPHConfig, make_state
from sphax_torch.core.state import box
from sphax_torch.integrate import leapfrog
from sphax_torch.neighbors import window as win
from sphax_torch.physics import dense, wengine
from tests._torch_helpers import NanSanitizer

torch.set_num_threads(1)
F64 = torch.float64

CFG = SPHConfig(dim=3, adaptive_h=True, newton_iters=4, grad_h=True,
                balsara=True, mm_visc=True)


def _state(n_side=8, seed=12):
    rng = np.random.default_rng(seed)
    pos = (np.mgrid[0:n_side, 0:n_side, 0:n_side].reshape(3, -1).T
           + 0.5) / n_side
    pos = np.mod(pos + 0.02 * rng.standard_normal(pos.shape), 1.0)
    n = len(pos)
    st = make_state(torch.as_tensor(pos),
                    torch.as_tensor(0.3 * rng.standard_normal((n, 3))),
                    torch.full((n,), 1.0 / n, dtype=F64),
                    torch.ones(n, dtype=F64),
                    torch.full((n,), 1.3 / n_side, dtype=F64))
    return st, box(torch.zeros(3, dtype=F64), torch.ones(3, dtype=F64))


def test_window_engine_nan_clean_under_the_sanitizer():
    st, dom = _state()
    spec = win.plan_windows(dom, h_max=float(st.h.max()) * 1.3, n=st.n,
                            dim=3)
    with NanSanitizer():
        out = wengine.update_derived(st, CFG, dom, spec)
    assert bool(torch.isfinite(out.rho).all())


def test_dense_kdk_step_nan_clean_under_the_sanitizer():
    st, dom = _state()
    engine = lambda s: dense.update_derived(s, CFG, dom, block=64)
    with NanSanitizer():
        st2, _ = leapfrog.step(engine(st), CFG, dom, engine)
    assert bool(torch.isfinite(st2.rho).all())


def test_the_sanitizer_fires():
    """An injected 0/0 raises, naming the op."""
    x = torch.zeros(4, dtype=F64)
    with NanSanitizer(), pytest.raises(FloatingPointError, match="div"):
        x / x
