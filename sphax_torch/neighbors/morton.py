"""Morton (Z-order) space-filling-curve keys (torch twin of
``sphax.neighbors.morton``).

The cell list sorts particles by these keys so that same-cell and
nearby-cell particles land contiguously in memory.

The JAX version computes in uint32. Torch's uint32 has no shifts on either
device, so the keys here are int64 holding the same 32 bits: every step
masks to the same constants, and no intermediate value needs more than 32
bits, so each key equals the JAX key exactly. 3D supports 10 bits an axis
(grids to 1024^3), 2D 16 bits an axis.
"""
from __future__ import annotations

import torch


def _i64(x):
    return torch.as_tensor(x).to(torch.int64)


def spread3(x):
    """Spread the 10 low bits of x so there are 2 zero bits between each."""
    x = _i64(x) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def spread2(x):
    """Spread the 16 low bits of x so there is 1 zero bit between each."""
    x = _i64(x) & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def compact3(x):
    """Inverse of spread3."""
    x = _i64(x) & 0x09249249
    x = (x ^ (x >> 2)) & 0x030C30C3
    x = (x ^ (x >> 4)) & 0x0300F00F
    x = (x ^ (x >> 8)) & 0x030000FF
    x = (x ^ (x >> 16)) & 0x3FF
    return x


def compact2(x):
    """Inverse of spread2."""
    x = _i64(x) & 0x55555555
    x = (x ^ (x >> 1)) & 0x33333333
    x = (x ^ (x >> 2)) & 0x0F0F0F0F
    x = (x ^ (x >> 4)) & 0x00FF00FF
    x = (x ^ (x >> 8)) & 0x0000FFFF
    return x


def encode(coords):
    """Interleave integer cell coords [..., D] (D in {1, 2, 3}) into a key
    (int64 holding the JAX version's uint32 bits)."""
    d = coords.shape[-1]
    if d == 1:
        return _i64(coords[..., 0]) & 0xFFFFFFFF
    if d == 2:
        return spread2(coords[..., 0]) | (spread2(coords[..., 1]) << 1)
    if d == 3:
        return (spread3(coords[..., 0])
                | (spread3(coords[..., 1]) << 1)
                | (spread3(coords[..., 2]) << 2))
    raise ValueError(f"dim {d} not supported")


def decode(key, dim: int):
    """Inverse of encode: key -> [..., D] integer coords (int64)."""
    key = _i64(key) & 0xFFFFFFFF
    if dim == 1:
        return key[..., None]
    if dim == 2:
        return torch.stack([compact2(key), compact2(key >> 1)], dim=-1)
    if dim == 3:
        return torch.stack(
            [compact3(key), compact3(key >> 1), compact3(key >> 2)], dim=-1)
    raise ValueError(f"dim {dim} not supported")
