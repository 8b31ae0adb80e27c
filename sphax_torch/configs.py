"""Frozen physics/run configs — a copy of ``sphax.configs``.

A copy and not an import: every ``sphax.*`` import runs ``sphax/__init__``,
which imports JAX, and this package never imports JAX.
``tests/test_torch_contract.py`` holds the copy equal to its original field
by field, defaults and canonical configs included.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SPHConfig:
    """Physics + numerics parameters (hashable; see ``sphax.configs``).

    Cubic-spline kernel, ideal-gas/isothermal EOS, Monaghan artificial
    viscosity, optional Balsara switch, optional grad-h terms, adaptive or
    fixed smoothing length, optional self-gravity.
    """

    dim: int = 3
    gamma: float = 5.0 / 3.0          # adiabatic index (ideal gas)
    isothermal: bool = False          # if True: P = cs_iso^2 * rho
    cs_iso: float = 1.0               # isothermal sound speed

    # Smoothing length: h_i = eta * (m_i / rho_i)^(1/dim); adaptive via Newton
    eta: float = 1.3
    adaptive_h: bool = True
    newton_iters: int = 6             # fixed Newton iterations
    grad_h: bool = False              # apply Omega grad-h correction factors

    # Artificial viscosity (Monaghan): Pi_ij with alpha, beta = 2*alpha
    alpha_visc: float = 1.0
    beta_visc: float = 2.0
    eps_visc: float = 0.01            # softening in mu_ij denominator (eps*h^2)
    balsara: bool = False             # Balsara shear limiter

    # Morris-Monaghan (1997) time-dependent per-particle alpha(t); rides the
    # same per-pair channel as the Balsara factor (pairs.visc_factor).
    mm_visc: bool = False
    mm_alpha_min: float = 0.1
    mm_alpha_max: float = 1.5
    mm_sigma: float = 0.2             # decay rate coefficient (tau = h/(sigma c))

    # Self-gravity (Plummer softening): "p3m" (FFT mesh + screened short
    # range) or direct sum (any other solver name).
    gravity: bool = False
    G: float = 1.0
    grav_eps: float = 0.01
    grav_solver: str = "direct"
    grav_mesh: int = 64               # PM grid points per axis
    grav_rs_cells: float = 2.0        # Ewald split scale in mesh cells

    # Timestep control
    cfl: float = 0.25
    dt_force: float = 0.25            # force criterion safety factor
    dt_max: float = 1e9

    # Energy floor (avoid negative u from AV overshoot in strong shocks)
    u_floor: float = 0.0

    # Neighbor infrastructure
    n_ngb_cap: int = 64               # fixed degree K for neighbor lists

    # Approximate reciprocals for the two per-pair divides of the force
    # kernel (viscous mu denominator, rhobar): ~1e-3 relative error in the
    # artificial viscosity only. Honoured by the fp32 CUDA kernel; the plain
    # torch version always divides exactly.
    fast_math: bool = False

    # Continuity-closure h predictor: h is advanced through the drift by
    # dh/dt = (h / dim) div v (leapfrog.step) and corrected by one lagged
    # Newton update from the same walk's density sums
    # (wengine.stage_density), so kernel A walks once per step.
    h_predict: bool = False

    def __post_init__(self):
        if self.h_predict and not (self.adaptive_h and self.need_divv):
            raise ValueError(
                "cfg.h_predict requires adaptive_h=True (it replaces the "
                "in-walk Newton solve) and need_divv (the continuity "
                "predictor reads state.divv — enable balsara or mm_visc); "
                "without them the predictor silently degrades")

    @property
    def support(self) -> float:
        return 2.0

    @property
    def visc_factor_on(self) -> bool:
        """True when a per-particle viscosity multiplier rides the pair
        term (Balsara limiter and/or Morris-Monaghan alpha)."""
        return self.balsara or self.mm_visc

    @property
    def need_divv(self) -> bool:
        """True when engines must compute the SPH div-v estimator."""
        return self.balsara or self.mm_visc


# ---- canonical problem configs ---------------------------------------------

SOD = SPHConfig(dim=3, gamma=1.4, adaptive_h=False, grad_h=False,
                alpha_visc=1.0, beta_visc=2.0)

SEDOV = SPHConfig(dim=3, gamma=5.0 / 3.0, adaptive_h=True, grad_h=True,
                  alpha_visc=1.0, beta_visc=2.0, balsara=True, u_floor=1e-8,
                  cfl=0.15, dt_force=0.15)

KH = SPHConfig(dim=2, gamma=5.0 / 3.0, adaptive_h=True, grad_h=True,
               alpha_visc=1.0, beta_visc=2.0, balsara=True)

EVRARD = SPHConfig(dim=3, gamma=5.0 / 3.0, adaptive_h=True, grad_h=True,
                   gravity=True, G=1.0, grav_eps=0.02, u_floor=1e-10)

TURB = SPHConfig(dim=3, isothermal=True, cs_iso=1.0, adaptive_h=True,
                 grad_h=False, alpha_visc=1.0, beta_visc=2.0, balsara=True)
