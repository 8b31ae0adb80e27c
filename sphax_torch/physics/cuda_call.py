"""What the wrappers of the hand-written CUDA kernels share
(``window_kernels`` for kernels A and C, ``rowpack`` for the derived
pass's row packing, ``pm`` for the P3M mesh's CIC): the choice between a
kernel and its plain version, a tensor's pointer, the checks of what a
kernel takes, and the launch on the current stream with its count.
"""
from __future__ import annotations

import ctypes

import torch


def plain_here(t) -> bool:
    """True for a CPU tensor, which the plain version takes; False for a
    CUDA tensor, which the kernel takes; raise on any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {t.device}")
    return t.device.type == "cpu"


def ptr(t):
    """``t``'s device pointer; a null pointer for None."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def check_fields(ref, tensors: dict, contiguous: bool = False):
    """Raise unless ``ref`` is float32 or float64 and each entry of
    ``tensors``, a name mapped to (tensor, shape), is on its device, of its
    dtype and of that shape: a tuple is the whole shape, an int the
    leading rows. With ``contiguous`` each must be contiguous too."""
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {ref.dtype}")
    for name, (t, shape) in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, not {ref.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{name} is {t.dtype}, not {ref.dtype}")
        whole = isinstance(shape, tuple)
        if (tuple(t.shape) if whole else t.shape[0]) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, not "
                             f"{shape if whole else f'{shape} rows'}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_index(ref, name: str, t, shape: tuple):
    """Raise unless ``t`` is a contiguous int32 tensor of ``shape`` on
    ``ref``'s device."""
    if (t is None or t.device != ref.device or t.dtype != torch.int32
            or tuple(t.shape) != shape or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous int32 {shape} tensor "
                         f"on {ref.device}")


def launch(counts: dict, fn_name: str, dtype, *args):
    """Launch ``sphax_<fn_name>_<f32|f64>`` on the current stream, raise on
    its launch error, and count it in ``counts[fn_name]``."""
    from sphax_torch import _build

    lib = _build.load()
    suffix = "f32" if dtype == torch.float32 else "f64"
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = getattr(lib, f"sphax_{fn_name}_{suffix}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {fn_name} failed to launch: "
                           f"{_build.error_string(err)}")
    counts[fn_name] += 1
