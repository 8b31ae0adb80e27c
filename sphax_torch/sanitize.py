"""Small launches of every hand kernel, for NVIDIA's ``compute-sanitizer``.

Parity checks compare outputs, and a stray read that lands on finite data
passes them. This module launches kernels A and C (3D, 2D and 1D; in place
and compact; on unmasked, partly masked and fully masked tables; C in its
P3M gravity mode, in place and compact) and kernel G (N = 1, 257 and
65,537: one row, one past the column tile, and one past the split into
slices) once each, on small inputs built on the host and copied to the
card, so that the tool sees the kernels and few of torch's:

    compute-sanitizer --tool memcheck --error-exitcode 9 \\
        python -m sphax_torch.sanitize

``check(tool)`` runs that in a subprocess with ``racecheck``,
``synccheck`` or ``memcheck`` and names the cases after which the tool
reported errors, or the tool's own error where it refuses the device
before any case runs (it does on a machine whose operating-system kernel
it cannot instrument, gVisor's for one: "Device not supported"). The subprocess runs without torch's
caching allocator, so every tensor is an allocation of its own and a read
past its end is one the tool sees. The library must be built before
(``_build.load()``); the subprocess loads it and builds nothing.

Without the tool, ``launch_all(dev, poison=True)`` is the check that
runs anywhere: each case launched again over free memory filled with NaN,
its outputs held finite and bitwise equal to the first launch's. It sees
reads that stray past the packed inputs into free memory and output rows
left unwritten; not reads that land inside another live tensor, nor
races.
"""
from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from sphax_torch import configs, make_state
from sphax_torch.core.state import box
from sphax_torch.ics import kh, lattice, turbulence
from sphax_torch.integrate import rungs
from sphax_torch.neighbors import window as win
from sphax_torch.physics import direct_gravity as dg
from sphax_torch.physics import pm
from sphax_torch.physics import window_kernels as wk

TOOLS = ("memcheck", "racecheck", "synccheck")
MARK = "[sanitize case]"
A_ARGS = ("pos_s", "mass_s", "h0_s")
C_ARGS = ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s", "cs_s", "om_s",
          "bf_s")
# the production window knobs of the 3D paths and of kh (the 1D line too)
KNOBS = {3: dict(cutoff_scale=1.05, ghost_safety=1.4, fast_sub=3, rgroups=2),
         2: dict(cutoff_scale=1.25, fast_sub=3, rgroups=2),
         1: dict(cutoff_scale=1.25, fast_sub=3, rgroups=2)}
CFG = {3: dataclasses.replace(configs.TURB, newton_iters=2),
       2: configs.KH,
       1: configs.SPHConfig(dim=1, gamma=1.4, adaptive_h=True, grad_h=True,
                            balsara=True, newton_iters=2)}
P3M = dataclasses.replace(CFG[3], gravity=True, grav_solver="p3m",
                          grav_mesh=32)
G_CFG = configs.SPHConfig(gravity=True, G=1.4, grav_eps=0.03)
G_SIZES = {torch.float32: (1, 257, 65537), torch.float64: (1, 257)}


def _lattice_state(dim, dtype):
    """A small box of each dimension on the host: the turbulence lattice at
    16^3, the Kelvin-Helmholtz ICs at nx = 64 (6,144 particles), a line of
    2^15 particles."""
    if dim == 3:
        ic = turbulence.build(n_side=16)
    elif dim == 2:
        ic = kh.build(nx=64)
    else:
        n = 1 << 15
        ic = dict(pos=lattice.cubic_lattice((n,), [0.0], [1.0]),
                  vel=np.zeros((n, 1)), mass=np.full(n, 1.0 / n),
                  u=np.ones(n), h=np.full(n, CFG[1].eta / n))
    return make_state(*(torch.as_tensor(ic[k], dtype=dtype)
                        for k in ("pos", "vel", "mass", "u", "h")))


def _to(wd, dev):
    return wd._replace(**{k: v.to(dev) for k, v in wd._asdict().items()
                          if isinstance(v, torch.Tensor)})


def _inputs(dim, dtype, dev, compact, seed=0):
    """(spec, {mask name: WindowData on dev}, sorted fields on dev): the
    structure and seeded kernel inputs, owner-consistent on ghost rows; the
    tables unmasked, masked to the rows within 0.25 of the box centre, and
    masked to none."""
    st = _lattice_state(dim, dtype)
    dom = box(torch.zeros(dim, dtype=dtype), torch.ones(dim, dtype=dtype))
    plan = win.plan_compact if compact else win.plan_measured
    spec = plan(st.pos, dom, h_max=float(st.h.max()) * (
        1.05 if dim == 3 else 1.3), dim=dim, **KNOBS[dim])
    wd = win.build(st.pos, dom, spec)
    g = torch.Generator().manual_seed(seed)

    def rnd(lo, hi):
        return lo + (hi - lo) * torch.rand(st.n, generator=g, dtype=dtype)
    rho = rnd(0.8, 1.2)
    cols = dict(vel_s=(0.4 * torch.randn(st.vel.shape, generator=g,
                                         dtype=dtype), 0.0),
                mass_s=(st.mass, 0.0), h0_s=(st.h, 1.0),
                h_s=(st.h * rnd(0.95, 1.05), 1.0), rho_s=(rho, 1.0),
                P_s=(rho * rnd(0.9, 1.1), 1.0), cs_s=(rnd(0.8, 1.2), 1.0),
                om_s=(rnd(0.9, 1.1), 1.0), bf_s=(rnd(0.0, 1.0), 0.0))
    f = {k: win.gather_sorted(v, wd, fill) for k, (v, fill) in cols.items()}
    f["pos_s"] = wd.pos_s
    ball = (wd.pos_s - 0.5).norm(dim=-1) < 0.25
    tables = {"unmasked": wd,
              "partly masked": rungs.mask_structure(wd, spec, ball),
              "fully masked": rungs.mask_structure(
                  wd, spec, torch.zeros_like(ball))}
    return (spec, {k: _to(v, dev) for k, v in tables.items()},
            {k: v.to(dev) for k, v in f.items()})


def cases(dev):
    """[(name, launch key, a function that launches the kernel once and
    returns its outputs, the output rows the kernel's contract defines:
    the real sorted rows of a window kernel, every row of G (None))]."""
    out = []
    for dim in (3, 2, 1):
        for dtype in (torch.float32, torch.float64):
            for compact in (False, True):
                if dtype == torch.float64 and dim != 3:
                    continue
                spec, tables, f = _inputs(dim, dtype, dev, compact)
                walk = "compact" if compact else "in place"
                for mask, wd in tables.items():
                    if dtype == torch.float64 and mask != "unmasked":
                        continue
                    tag = f"{dim}D {walk} {mask} {str(dtype)[6:]}"
                    out.append((f"A {tag}", wk._kernel_name(
                        "solve_h_density" + "_compact" * compact, dim),
                        lambda w=wd, s=spec, f=f, d=dim: wk.solve_h_density(
                            w, s, *(f[k] for k in A_ARGS), CFG[d],
                            vel_s=f["vel_s"]), wd.is_real))
                    out.append((f"C {tag}", wk._kernel_name(
                        "forces" + "_compact" * compact, dim),
                        lambda w=wd, s=spec, f=f, d=dim: wk.forces(
                            w, s, *(f[k] for k in C_ARGS), CFG[d]),
                        wd.is_real))
                if dim == 3 and dtype == torch.float32:
                    dom = box(torch.zeros(3), torch.ones(3))
                    grav = (pm.rs_traced(P3M, dom, dtype,
                                         cutoff=spec.cutoff).to(dev),
                            P3M.grav_eps)
                    for mask in ("unmasked", "partly masked"):
                        out.append((
                            f"C GRAV 3D {walk} {mask} float32",
                            "forces_grav" + "_compact" * compact,
                            lambda w=tables[mask], s=spec, f=f, g=grav:
                            wk.forces(w, s, *(f[k] for k in C_ARGS), P3M,
                                      grav=g), tables[mask].is_real))
    for dtype, sizes in G_SIZES.items():
        for n in sizes:
            g = torch.Generator().manual_seed(3)
            pos = torch.rand((n, 3), generator=g, dtype=dtype).to(dev)
            mass = ((torch.rand(n, generator=g, dtype=dtype) + 0.5)
                    / n).to(dev)
            out.append((f"G N={n} {str(dtype)[6:]}", "gravity",
                        lambda p=pos, m=mass: dg.gravity(p, m, G_CFG),
                        None))
    return out


def poison_free_memory(dev, large=1 << 28, small=64):
    """Fill the caching allocator's free memory with NaN: release the
    cached blocks, then allocate a NaN block of ``large`` bytes and
    ``small`` of 1 MiB (the largest the small-block pool serves) and free
    them. The next allocations, a wrapper's packed inputs and its outputs,
    are carved from NaN, and what lies past their ends stays NaN."""
    torch.cuda.empty_cache()
    nan = float("nan")
    blocks = [torch.full((large // 4,), nan, device=dev)]
    blocks += [torch.full(((1 << 20) // 4,), nan, device=dev)
               for _ in range(small)]
    torch.cuda.synchronize()
    del blocks


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def launch_all(dev, poison=False, log=None):
    """Launch every case once, each followed by a synchronise and preceded
    by ``log(name)`` where given; hold each to one launch of its key and
    the cases to every key of ``wk.LAUNCHES``.
    With ``poison``, launch each again over NaN-filled free memory
    (``poison_free_memory``) and hold its outputs on the contract's rows
    finite and bitwise equal to the first launch's (the kernels have no
    atomics, so one input gives one output): a read past the end of the
    packed inputs, or an output row left unwritten, turns up as a NaN or a
    difference. Returns the names."""
    names = []
    for name, key, fn, rows in cases(dev):
        n0 = wk.LAUNCHES[key]
        if log is not None:
            log(name)
        first = [o.clone() for o in _outputs(fn())]
        torch.cuda.synchronize()
        assert wk.LAUNCHES[key] == n0 + 1, (name, key)
        if poison:
            poison_free_memory(dev)
            again = _outputs(fn())
            torch.cuda.synchronize()
            for k, (a, b) in enumerate(zip(first, again)):
                a, b = (a, b) if rows is None else (a[rows], b[rows])
                assert bool(torch.isfinite(a).all()), (name, k, "non-finite")
                assert torch.equal(a, b), (
                    f"{name} output {k}: a launch over NaN-filled free "
                    f"memory differs on {int((a != b).sum())} values")
        names.append((name, key))
    missing = set(wk.LAUNCHES) - {k for _, k in names}
    assert not missing, f"no case launches {sorted(missing)}"
    return [n for n, _ in names]


def sanitizer_path():
    """(path of compute-sanitizer beside the toolkit's nvcc, or None; the
    places looked in)."""
    from torch.utils.cpp_extension import CUDA_HOME

    from sphax_torch import _build

    where = [os.path.join(CUDA_HOME, "bin") if CUDA_HOME else
             "$CUDA_HOME/bin ($CUDA_HOME unset)", "PATH"]
    return _build.cuda_tool("compute-sanitizer"), where


def check(tool, sanitizer, timeout=400):
    """Run this module under ``compute-sanitizer --tool tool`` in a
    subprocess. Returns {"tool", "rc", "seconds", "cases": the cases it
    reached, "errors": the cases after which the tool reported an error,
    "refused": the tool's own error before any case ran (it refuses a
    device it cannot instrument, and CUDA then fails under it) or None,
    "summary": its last summary line, "output": the tail of what it
    printed}."""
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    cmd = [sanitizer, "--tool", tool, "--error-exitcode", "9",
           "--print-limit", "50", sys.executable, "-m", "sphax_torch.sanitize"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, env=env,
                          timeout=timeout,
                          cwd=Path(__file__).resolve().parent.parent)
    text = proc.stdout
    errors, case, refused, reached = [], None, None, 0
    for line in text.splitlines():
        if line.startswith(MARK):
            case, reached = line[len(MARK):].strip(), reached + 1
        elif case is None:
            if refused is None and line.startswith("========= Error:"):
                refused = line.strip("= ")
        elif (re.match(r"=+ +(Invalid|Race|Barrier|Error|Uninitialized|"
                       r"Program hit)", line) and case not in errors):
            errors.append(case)
    summary = [ln for ln in text.splitlines() if "SUMMARY" in ln]
    return {"tool": tool, "rc": proc.returncode,
            "seconds": time.perf_counter() - t0, "cases": reached,
            "errors": errors, "refused": refused,
            "summary": summary[-1].strip("= ") if summary else "",
            "output": text[-4000:]}


def version(sanitizer) -> str:
    out = subprocess.run([sanitizer, "--version"], capture_output=True,
                         text=True).stdout
    return next((ln.strip() for ln in out.splitlines()
                 if ln.startswith("Version")), out.strip())


if __name__ == "__main__":
    from sphax_torch import _build

    if not _build.library_path().exists():
        raise SystemExit("build the kernels first (_build.load())")
    _build.load()
    dev = torch.device("cuda")
    names = launch_all(dev, log=lambda n: print(f"{MARK} {n}", flush=True))
    print(f"{len(names)} cases launched", flush=True)
