"""Initial conditions, made by the benchmark and handed to both sides.

Each kind of ICs is a module of its own, ``ics/<kind>.py``, found by the
``kind`` a configuration's ``ics`` names; its ``build(ic, gen, dtype,
device)`` returns dict(pos, vel, mass, u, h) on ``device``, drawing every
seeded part from ``gen`` (a generator on that device, seeded from
``--seed``). The lattices are the port's own set-ups, so the window plan the
port makes for its own ICs fits them.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def lattice(n: int) -> np.ndarray:
    """Cell-centred cubic lattice of n^3 points in the unit box, [n^3, 3],
    x the slowest axis."""
    ax = (np.arange(n, dtype=np.float64) + 0.5) / n
    g = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.stack([c.ravel() for c in g], axis=-1)


def on_device(host: dict, dtype, device) -> dict:
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in host.items()}


def builder(kind: str, here: Path = HERE):
    """The ``build`` function of ``ics/<kind>.py``."""
    path = here / f"{kind}.py"
    if kind.startswith("_") or not path.is_file():
        raise SystemExit(f"{path} not found: no builder for ICs of kind "
                         f"{kind!r}")
    spec = importlib.util.spec_from_file_location(f"portbench.ics.{kind}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build


def make(ic: dict, seed: int, dtype, device) -> dict:
    """The configuration's ICs on ``device``: dict(pos, vel, mass, u, h),
    the seeded parts drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return builder(ic["kind"])(ic, gen, dtype, device)
