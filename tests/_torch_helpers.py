"""Test helpers of the port's gates (no JAX).

``jittered_lattice`` and ``make_problem`` are copies of
``tests/parity/test_dense_vs_reference.py``'s, with the same numpy draws,
so the port's tests build the JAX tests' inputs bit for bit without
importing them. ``NanSanitizer`` is the port's ``jax_debug_nans``.
"""
import numpy as np
import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode


def jittered_lattice(n_side, dim, seed, jitter=0.2):
    rng = np.random.default_rng(seed)
    ax = (np.arange(n_side) + 0.5) / n_side
    grids = np.meshgrid(*([ax] * dim), indexing="ij")
    pos = np.stack([g.ravel() for g in grids], axis=-1)
    pos += jitter / n_side * rng.standard_normal(pos.shape)
    return np.mod(pos, 1.0)


def make_problem(dim=3, n_side=6, seed=0, vel_scale=0.3):
    """(pos, vel, mass, u, h) as numpy float64 arrays."""
    rng = np.random.default_rng(seed + 1)
    pos = jittered_lattice(n_side, dim, seed)
    n = len(pos)
    vel = vel_scale * rng.standard_normal((n, dim))
    mass = np.full(n, 1.0 / n)
    u = 1.0 + 0.5 * rng.random(n)
    h = np.full(n, 1.3 / n_side)
    return pos, vel, mass, u, h


# allocations whose contents are uninitialised memory, not results
_UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided"}


class NanSanitizer(TorchDispatchMode):
    """Raise ``FloatingPointError`` naming the op as soon as any aten op
    returns a floating tensor that holds a NaN: torch's stand-in for
    ``jax_debug_nans``, which fails at the primitive that made the NaN
    where a check of the outputs sees only what survives to them (a NaN
    made and then masked by ``where`` is caught here)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALISED:
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(f"NaN in the output of {func}")
        return out
