"""sphax_torch — the sphax SPH code in PyTorch, with hand-written CUDA
kernels for Hopper (sm_90a).

A second package beside the JAX reference ``sphax/``, with the same module
layout; it imports torch and numpy and never JAX. The window engine's pair
walks (kernels A and C) run as CUDA kernels on CUDA tensors and as their
plain torch versions on CPU tensors.
"""
__version__ = "0.1.0"

from sphax_torch.configs import SPHConfig, SOD, SEDOV, KH, EVRARD, TURB  # noqa: F401
from sphax_torch.core.state import Domain, ParticleState, make_state, box  # noqa: F401
