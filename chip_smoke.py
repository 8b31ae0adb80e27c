"""Smoke run of the PyTorch/CUDA port on one card: builds the CUDA kernels
from ``sphax_torch/csrc``, holds each against its plain torch version, and
drives the port's paths at N = 1e6: the bench configuration, the driven CLI
configuration, the same with P3M self-gravity, an open box with direct
gravity, and ``python -m sphax_torch kh n=1024`` (N = 1,572,864, 2D) with
the rest of the problem suite through the same CLI; then the bench
configuration with the compact walks of kernels A and C, with drift-gated
rebuilds, and with both, and the CLI's turb with ``adaptive=8``; then block
timesteps, ``python -m sphax_torch sedov n=100 rungs=4`` (kernels A and C on
masked tables) beside global dt, the Sedov shock-radius gate, and a 1D line
of 2^20 particles through the dim=1 kernels; then what the warp cull of
kernels A and C keeps at each path's shapes, the kernels against plain on
inputs no lattice gives them, and the derived pass on the card against the
NumPy reference; then the slab decomposition (``sphax_torch.dist``): ranks
sharing the card over gloo in lockstep with the single-device engine, and
``python -m sphax_torch turb n=100 shards=2`` (N = 1e6) with kernels A and
C on each rank's masked shard structure; then the h predictor against full
Newton, and block timesteps on the slab ranks (``dist.wrungs``): in
lockstep with the single-device rung integrator, and ``python -m
sphax_torch sedov n=100 shards=2 rungs=4`` with kernels A and C on each
rank's shard structure masked again to its closers; then the 2D pencil
decomposition (``dist.pencil``, ``dist.prungs``): a 2x2 grid of ranks in
lockstep with the single-device engine, ``turb n=100 shards=2x2`` with and
without P3M and ``sedov n=100 shards=2x2 rungs=4``, with kernels A and C
(and C's gravity mode) on each rank's pencil shard structure, and the
multi-rank dry run; then the twin of ``__graft_entry__.entry()``, the JAX
package's slow gates, and compute-sanitizer over the hand kernels; then
the cell-list engine at N = 1e6 and ``sod n=64`` on it, the equal-extent
slabs over it on 2 ranks, and the sorted-order P3M mesh.

    python3 chip_smoke.py

Phases, in order; any failed check raises and exits non-zero:
  1. device    a CUDA card is required; TF32 off; the card's name and
               power limit
  2. build     nvcc builds the kernels; build seconds and registers
  3. kernel A  CUDA vs plain on the same inputs (n_side=48, production
               window knobs, is_real rows), cold Newton and h_predict
               modes, fp32 (rtol 3e-5, atol 3e-5 max) and fp64 (1e-10)
  4. kernel C  the same, then fp32 fast_math against the exact plain
               version at 2e-3
  5. derived   update_derived through the kernels vs through the plain
               versions, on the card (n_side=48, fp32, 3e-5)
  6. main path the bench configuration at N = 1e6: plan, cold derived
               pass, warm-up run and 3 timed runs of 16 steps; bench.py's
               checks; one launch of each kernel per step
  7. driven    the CLI ``turb`` configuration (newton_iters=2, OU driving
               with noise from a seeded generator) at N = 1e6, 4 steps
  8. times     each kernel and its plain version at the N = 1e6 shapes,
               timed with CUDA events
  9. kernel C  gravity mode (fused P3M short range, split scalars from
     + grav    pm.rs_traced at grav_mesh=128) vs plain, n_side=48,
               fp32 (3e-5) and fp64 (1e-10)
 10. kernel G  CUDA vs plain at N = 1, 255, 257, 5000, 65537 and 64^3
               (across the column tile and the split into slices), fp32
               (1e-4) and fp64 (1e-10); a second launch bitwise equal; the
               runtime's registers and blocks a SM against the plan's
 11. P3M path  the driven configuration with gravity=1 grav_solver=p3m
               grav_mesh=128 at N = 1e6, 4 steps: kernel C in its gravity
               mode every step, and the momentum of one derived pass
 12. direct    the turbulence lattice in an open box with direct gravity at
     path      N = 1e6, one update_derived: kernel G once; its output pulls
               toward the centre and matches the plain sum on sampled rows
 13. times     kernel C with and without gravity at the path-11 shapes,
               kernel G at N = 4096, 65536 and 64^3 (fp32 and fp64) and 1e6
               (fp32) beside its bound and plan, and with its plain version
               at 64^3, and pm.mesh_accel at N = 1e6, M = 128
 14. 2D        kernels A (cold Newton, configs.KH) and C (exact and
     kernels   fast_math) in their dim=2 instantiation vs plain at the kh
               geometry (kh.build(nx=64), is_real rows): fp32 3e-5, fp64
               1e-10, fast_math 2e-3
 15. kh CLI    sphax_torch.__main__.main(["kh", "n=1024", "max_steps=16",
               "chunk=16", ...]) in-process: 16 steps, metrics.jsonl and
               checkpoint.npz, finite records, overflow 0, h_capped 0,
               |dp| < 1e-5 sum m|v|, 17 launches of each 2D kernel and
               none of the 3D ones; then a resume from the checkpoint for
               one more chunk, held to the direct continuation; the warm
               step time
 16. KH gate   tests/problems/test_kh.py through problems.kh(n=32, fp64) on
               the window engine and run.simulate_until: growth rate in
               [0.24, 0.40] of linear theory, amps[-1] > 2 amps[i0],
               |dp| < 1e-10
 17. problems  the CLI on sod (n=32: the dense fallback, no window kernel),
               sedov n=32 visc=mm (3D window engine, Morris-Monaghan) and
               evrard n=4096 (dense with direct gravity), 4 steps each
 18. times     kernels A (cold, 6 Newton updates) and C in 2D at the
               path-15 shapes, with their plain versions
 19. compact   the compact walks (spec.cwidth > 0, plan_compact) at the
     walks     phase 3/14 geometries: A cold and h_predict, C exact,
               fast_math and gravity (grav_mesh=128) in 3D, A and C in 2D,
               against the compact plain versions (fp32 3e-5, fp64 1e-10,
               fast_math 2e-3) and against the in-place kernels on the same
               inputs (fp32 3e-5, fp64 1e-10)
 20. compact   bench.run at N = 1e6 with compact=True, adaptive=8 and both:
     and       bench.py's checks and exact launch counts (compact keys only
     adaptive  when compact); particle-steps/s, cwidth, c_n's mean, p99 and
               max, the builds; then the CLI's turb n=100 adaptive=8 for 16
               steps: finite, overflow 0, builds in its record
 21. times     the compact walks beside the in-place ones, in turns on the
               same inputs: A (h_predict, cold) and C (fast_math) at the
               bench shapes, C with gravity at the phase-13 shapes, A and C
               in 2D at the phase-18 shapes; their plain versions; the pairs
               inside the support recounted on the compact lists (the same,
               so the same bounds); and one adaptive=8 step with and without
               the drift gate's host read
 22. masked    kernels A and C on ``rungs.mask_structure``d tables of the
     parity    Sedov N = 1e6 structure (``problems.sedov(n=100)``, with a
               seeded 0.4 N(0,1) velocity on its resting lattice), a ball
               around the blast centre holding 10 % of the particles
               closing: against plain on the real rows of active groups,
               fp32 3e-5 and fp64 1e-10 (d rho/d h, whose terms cancel on
               the unperturbed lattice, against the size of its terms,
               dim rho / h); on masked groups h == h0 and the other outputs
               exactly zero; active groups and tiles of all;
               ms per launch at this share, unmasked, and with every group
               masked (the floor of a launch)
 23. B = 1     simulate_rungs(n_rungs=1, rebuild_every=1) against
               wengine.simulate(rebuild_every=1) from the Sedov N = 1e6
               state, fp32, 2 steps: dts at 1e-6, the state at rtol 5e-5,
               atol 1e-6
 24. rung path ``sedov n=100 rungs=4 max_steps=16`` through the CLI (2 spans
               of 8 ticks), and again with ``adaptive=8``: overflow 0,
               finite, h_capped 0, dt_viol under 5 % of the closings,
               active_frac < 0.5, the energy drift; then the same 16 ticks
               through simulate_rungs, its adaptive=8 loop and global dt
               (wengine.simulate), in turns: ms per tick of each, the
               active fraction per tick, the builds, and kernel A's and C's
               time per tick against the active groups; the device time
               of a tick by kind of kernel (profiler) and the idle share
 25. Sedov     tests/problems/test_sedov.py on the port's window engine,
     gate      ``problems.sedov(n=14, fp64)`` (the test's own size) to
               t = 0.06 at global dt and with rungs=3: shock radius within
               25 % of R(t), energy within 2e-2 (4e-2 with rungs, as
               tests/unit/test_rungs.py asks, and some tick closing fewer
               than N particles)
 26. dim=1     a periodic line of N = 2^20 particles (a lattice jittered by
               0.2 spacings, seeded velocity noise) through
               wengine.update_derived and wengine.simulate (4 steps), in
               place and compact: the ``_1d`` kernels A and C
               once per pass and step; against plain, fp32 3e-5 and fp64
               1e-10; ms per launch and bounds
 27. cull      per real row at the bench, P3M, kh, Sedov and 1D shapes, in
               place and compact: the candidate rows, the survivors of the
               warp's cull (``window_kernels.cull_stats``, the kernels' rule
               as plain torch) and the pairs inside the support; at the
               turb256, sedov128 and kh1024 shapes kernel A's and kernel
               C's two walks (``window_kernels.walk_stats`` at each
               kernel's rule and batch): the steps a warp and the lane
               fill of the walk in which every lane visits every survivor
               and of the pair walk. Then
               kernels A (cold, 2 Newton updates) and C against plain, fp32
               3e-5 and fp64 1e-10, in place and compact, on a clustered
               state (half of 65,536 particles drawn toward 4 centres, h
               from the local density, about 10x apart, so that a warp's
               buffer fills many times in a walk), on an open box of 45^3
               particles whose last warp mixes real and pad rows
 28. reference ``wengine.update_derived`` through the kernels, in place and
               compact, 3D (13^3) and 2D (44^2), 10 Newton updates with
               grad-h and Balsara, against ``sphax_torch.reference_cpu`` on
               the host: fp64 at 1e-8; fp32 h, rho, P, Omega at 1e-5 and
               acc, du/dt at 3e-5 of the largest value
 29. profile   the device time of a step by kind of kernel (profiler) and
               the idle share against the unprofiled wall, 16 steps each:
               the bench configuration in place and compact, and kh n=1024
 30. slab      4 ranks on the card (gloo, spawned with
     lockstep  ``dist.comm.launch``), fp64, from the turbulence lattice at
               32^3 with a seeded 0.3 N(0,1) velocity: 3 ``wslab.step``s,
               a 4-step chunk at rebuild_every=2, a rebalance and a
               migration (pad_factor 2 and migrate_frac 1: the rebalance
               moves a cut by a whole cell of the coarse slab grid),
               against ``wengine.simulate`` on one device
               (rebuild every step): every field at 1e-8, the dts at 1e-10,
               with configs.TURB and tests/dist/test_wslab.py's mm_visc
               configuration; with TURB, first kernels A and C on rank 0's
               shard structure (its real rows active, slab ghosts imaged
               but inactive, padding in the trash band) against plain:
               fp32 3e-5, fp64 1e-10 on its own real rows, finite on every
               row
 31. slab CLI  ``turb n=100 shards=2 chunk=8 max_steps=16`` (N = 1e6, fp32)
               through the CLI: records finite, the checkpoint finite with
               |sum m v| <= 1e-5 sum m|v|, migration converged, the set-up's
               one derived pass in this process and one launch of A and of
               C a step on each rank (from the records); ms per
               step, host-staged bytes per step, migration and rebalance ms
               per chunk and builds, beside the same 16 steps at shards=1
               (its builds from ``window.BUILDS``, its staged bytes from
               ``dist.comm.STAGED``, both read around the run) (two ranks
               sharing one card: not a scaling measure); a
               resume of the shards=2 checkpoint to step 24; then A and C
               on rank 0's shard of that checkpoint's state against plain
               (fp32 3e-5), timed, with their bounds
 32. h_predict tpu_tests/test_tpu_hpredict.py's two gates through
               wengine.simulate and the kernels, fp32: Sod (nx_left=16,
               n_trans=16, 64 steps) L1(rho) of full Newton < 0.06 and of
               the predictor <= 1.15x it + 1e-4, residual < 5e-3; the
               turbulence lattice at 16^3 with a seeded 0.3 N(0,1)
               velocity and the production window knobs, 30 steps of the
               predictor against full Newton (6 updates): h drift < 3e-3,
               rho < 1e-2, dts rtol 2e-3, residual < 5e-3
 33. rung      2 ranks on the card (gloo), fp64, Sedov at 16^3
     lockstep  (configs.SEDOV, newton_iters=2), B = 3, one span at
               rebuild_every=2: the blast centred, and at (0.15, 0.5, 0.5)
               after a work rebalance (the ranks' work before and after)
               and the migration, against ``rungs.simulate_rungs`` on one
               device with the kernels: every field at 1e-8, dts at 1e-12,
               closings per tick and dt_viol equal, health 0; first
               kernels A and C on rank 0's shard structure masked to the
               closers of a span's first tick, and to none (a tick whose
               closers are all rank 1's), against plain on the shard's
               rows jittered by 0.2 of a spacing with a 0.4 N(0,1)
               velocity, fp32 3e-5 and fp64 1e-10; with none, h0 and zeros
               from both on every row
 34. rung      ``sedov n=100 shards=2 rungs=4 chunk=8 max_steps=16``
     slab CLI  (N = 1e6, fp32, two spans of 8 ticks) through the CLI:
               records finite, |sum m v| <= 1e-5 sum m|v|, dt_viol under
               5 % of the closings, active_frac < 0.5, migration converged,
               health 0; ms per tick by chunk beside phase 24's shards=1,
               active_frac, dt_viol, builds, host-staged bytes per tick,
               migration and rebalance ms, the work imbalance before and
               after each rebalance, and the launches of A and C (the
               seeding passes included) against the schedule's count (two
               ranks sharing one card: not a scaling measure); then A and
               C on rank 0's rung-masked shard of that run's checkpoint
               (the closers of a span's first tick) against plain (fp32
               3e-5), timed, with their bounds
 35. pencil    4 ranks on the card as a 2x2 grid (gloo), fp64, from the
     lockstep  phase-30 lattice (32^3, a seeded 0.3 N(0,1) velocity): a
               4-step ``pencil.chunk`` at rebuild_every=2, a rebalance of
               both axes and the migration (pad_factor 2, migrate_frac 1),
               against ``wengine.simulate`` on one device (rebuild every
               step): every field at 1e-8 after the chunk and after the
               migration, dts at 1e-10, with configs.TURB and the mm_visc
               configuration; with TURB, first kernels A and C on rank 0's
               pencil shard structure (its real rows active, x and y
               ghosts imaged but inactive, padding in the trash band) on
               rows jittered by 0.2 of a spacing with a 0.4 N(0,1)
               velocity, against plain: fp32 3e-5, fp64 1e-10
 36. pencil    ``turb n=100 gravity=1 grav_solver=p3m grav_mesh=128
     P3M       shards=2x2 chunk=4 max_steps=4`` (N = 1e6, fp32) through
               the CLI: kernel C in its gravity mode every step on every
               rank (the records' launches); then on rank 0's pencil of
               that run's checkpoint C's gravity mode against plain, fp32
               (3e-5, timed, with its bound) and fp64 (1e-10), and the
               momentum of one derived pass over the ranks,
               |sum m a| < 2e-3 sum |m a|
 37. pencil    ``turb n=100 shards=2x2 chunk=8 max_steps=16`` (N = 1e6,
     CLI       fp32) through the CLI and a resume to step 24: records
               finite, health 0, |sum m v| <= 1e-5 sum m|v|, one launch of
               A and of C a step on each rank; ms per step by chunk beside
               phase 31's shards=2 and shards=1, host-staged bytes per
               step (in all and by grid axis) beside the plan's prediction
               (``staged_per_step``, printed before the run), migration
               passes and ms, builds, the ranks' count imbalance before and
               after each rebalance (four ranks sharing one card: not a
               scaling measure); then A and C on rank 0's pencil of the
               step-16 checkpoint against plain (fp32 3e-5), timed, with
               their bounds
 38. pencil    4 ranks as a 2x2 grid, fp64, Sedov at 16^3 (configs.SEDOV,
     rungs     newton_iters=2), B = 3, one span at rebuild_every=2, the
               blast centred and at (0.15, 0.3, 0.5), against
               ``rungs.simulate_rungs`` on one device: every field at 1e-8,
               dts at 1e-12, closings per tick and dt_viol equal, health
               0; first A and C on rank 0's pencil structure masked to a
               span's first tick's closers and to none, jittered, against
               plain (fp32 3e-5, fp64 1e-10). Then ``sedov n=100 shards=2x2
               rungs=4 chunk=8 max_steps=16`` (N = 1e6, fp32) through the
               CLI: finite, |sum m v| <= 1e-5 sum m|v|, dt_viol under 5 %
               of the closings, the launches of A and C against the
               schedule's count; ms per tick, staged bytes, active_frac,
               count imbalance; A and C on rank 0's rung-masked pencil of
               its checkpoint against plain (fp32 3e-5), timed, with their
               bounds. Last ``sphax_torch.entry.dryrun_multichip(4)`` on
               the card (the slab chunk, rebalance and migration, a B = 2
               span, a 2x2 pencil chunk, all in one launch of 4 ranks)
               Starting 4 ranks costs tens of seconds on the card, so
               besides the CLI runs one launch runs the four locksteps of
               phases 35 and 38 and one the kernel checks on the three
               checkpoints of phases 36-38 (printed at the end of 38)
 39. entry     ``sphax_torch.entry.entry()``, the twin of
               ``__graft_entry__.entry()``, on the card (fp32, the
               turbulence lattice at 16^3, configs.TURB with 6 Newton
               updates, exact C): one call, then 8 more, all finite;
               window overflow 0; one launch of A and of C a call; one step
               through the kernels against the same step through the plain
               versions (fp32 3e-5); a warm call's wall and enqueue (host
               clock) beside its device time by kind (profiler); A and C
               alone at the call's shapes (events), plain, bounds
 40. slow      the JAX package's slow gates with no other twin, fp64 on
     gates     the card: tests/unit/test_h_predict.py's B = 3 rungs with
               h_predict against full Newton (sedov n_side=10, 2 spans:
               active fraction < 0.9, h < 3e-3, rho < 1e-2, overflow 0);
               tests/problems/test_sedov.py's Morris-Monaghan variant
               (problems.sedov(n=16, visc="mm") on the window engine to
               t = 0.02: max alpha > 3 alpha_min, its 20th percentile
               < 2 alpha_min, energy within 5 %); and
               tests/problems/test_evrard.py's energy gate (n = 1024, the
               dense engine, to t = 0.5: drift < 5e-3, kinetic energy
               > 1e-3, the median radius shrinks), a minute a CPU thread
 41. sanitize  ``sphax_torch.sanitize``'s small launches of every hand
               kernel (A and C in 3D, 2D and 1D, in place and compact,
               unmasked, partly and fully masked, C's gravity mode, G at
               N = 1, 257 and 65,537) in this process, each launched again
               over NaN-filled free memory: finite and bitwise equal on the
               rows the contract defines; then each of compute-sanitizer's
               memcheck, racecheck and synccheck over them in a
               subprocess: a reported error fails the script naming the
               cases after which it came. Where the tool is absent, or
               refuses the device before any case runs, the phase says so
 42. clist     ``clist.update_derived`` (the cell-list engine, plain
               torch) at N = 1e6 on the bench lattice (configs.TURB, fp32,
               h_max 1.3 max h, the card's blocks) against
               ``wengine.update_derived`` through kernels A and C on the
               same state: every field within 3e-5 (rtol, and atol of the
               largest value); overflow and h saturation 0; the warm pass
               (events), the block, peak memory. Then ``sod n=64
               max_steps=16`` through the CLI: the banner says
               ``engine=clist``, finite records; its warm step beside 8
               steps of the dense engine (run.simulate, at most a minute)
 43. eq slab   ``dist.slab`` on 2 ranks sharing the card (gloo), one launch:
               fp64 (24^3, newton_iters=2) 2 steps against the
               single-device cell list at 1e-10 (fields and dts); the
               N = 1e6 lattice in fp32 for 1 step: no particle lost,
               density finite, health 0, the step's wall
 44. sorted    ``pm.mesh_accel_sorted`` against ``pm.mesh_accel`` at
     mesh      N = 1e6, M = 128 on the P3M lattice's sorted rows, fp32 3e-5
               and fp64 1e-10, fallback rows and dropped == 0, both times
               (events); the CLI's ``turb n=100 gravity=1 grav_solver=p3m
               grav_mesh=128`` (the scatter mesh, kernel C's gravity mode)
               for 4 steps with ``mesh_fb`` in its record
 45. rowpack   the derived pass's three row-packing kernels
               (``physics/rowpack.py``) at turb256's shapes (``problems.turb
               n=256 accel_rms=0.2``, fp32): each bitwise equal to its plain
               version; ms a launch, bound (bytes over 3.35 TB/s), plain
               ms; a derived pass bitwise equal to the plain versions' and
               to the frozen pass of tests/_rowpack_frozen.py, one launch
               of each kernel
 46. cic       the P3M mesh's CIC kernels (``csrc/cic.cu``) at
               cloud256.p3m's shapes (``ics.cloud`` at n = 256, N =
               16,777,216, M = 384, fp32): the interpolation of the solved
               grids (3, and 1 as ``mesh_potential`` takes) bitwise equal to
               ``pm._interp_plain``, the deposit within 1e-6 of the largest
               cell of ``pm._deposit_plain`` and the total mass within 1e-6;
               one launch a call; ms a launch, bound (bytes over 3.35 TB/s),
               plain ms
 47. limiter   the timestep limiter's kernels (``csrc/rung_limit.cu``) on
               ``sedov n=256 limiter=4``'s structure after one span of
               ``rung_chunk`` on 8 rungs, fp32: the tick's pass (the
               neighbours' lowest rungs, the wake targets, the lowered
               closers) and the sync point's pass ``torch.equal`` to their
               plain versions at ticks with few closers and with all; one
               ``rung_limit_tick`` launch a tick and ``sync_passes``
               launches of ``rung_limit_sync`` a span on the limiter's
               path; ms a launch, bound, plain ms
Each path runs with every launch count set to 0 just before it, and its
counts are read just after: those of kernels A, C and G
(``window_kernels.LAUNCHES``), of the three row-packing kernels
(``rowpack.LAUNCHES``), of the two CIC kernels (``pm.LAUNCHES``) and of
the timestep limiter's two kernels (``rung_limit.LAUNCHES``, 0 on every
path but phase 47's). A
P3M derived pass launches ``cic_deposit`` and ``cic_interp`` once each, a
launch of C's gravity mode, and a P3M CLI record's potential once more.
Every derived pass packs through the row-packing kernels:
``rowpack_gather_a`` launches once a launch of A, a shard's pass and the
block timesteps' seeding pass included, and on one device
``rowpack_gather_c`` and ``rowpack_scatter_out`` once a launch of C (a
shard's pass packs C's window itself); the slab and pencil CLIs' ranks
are processes of their own whose counts start at 0, and each chunk's record
carries their sums (``SlabRun.chunk_record``), which phases 31, 34 and
36-38 add up. Each kernel's bound is the larger of its bytes over 3.35
TB/s and its operations on the pairs these inputs need (inside the
support, or the cutoff for the gravity mode) over 67 TFLOP/s fp32 (34
fp64). The line before the last holds the
kernels' record: every row of kernels A and C also carries the candidates,
the survivors and the pairs inside the support per real row. The
survivors are what the cull's rule keeps on this run's inputs, counted by
its plain torch statement (``window_kernels.cull_stats``); the kernels do
not report what they staged.
The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import sys
import time
import types

import torch

# the peak rates and operations a pair behind every bound
from sphax_torch.bounds import FLOPS, bound, gravity_bound


def log(*a):
    print(*a, flush=True)


def main():
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")

    import numpy as np

    from sphax_torch import _build, bench, configs, make_state, problems
    from sphax_torch import run as run_mod
    from sphax_torch.__main__ import main as cli
    from sphax_torch.__main__ import rung_chunk
    from sphax_torch import reference_cpu
    from sphax_torch.ab_kernels import (cloud, last_launch, line_inputs,
                                        sedov_inputs, sorted_fields,
                                        with_cwidth)
    from sphax_torch.core.state import box
    from sphax_torch.diag import sedov as sedov_diag
    from sphax_torch.ics import kh as kh_ics
    from sphax_torch.ics import lattice, turbulence
    from sphax_torch.integrate import rungs
    from sphax_torch.io import checkpoint
    from sphax_torch.neighbors import window as win
    from sphax_torch.physics import direct_gravity as dg
    from sphax_torch.physics import driving, pm, rowpack, wengine
    from sphax_torch.physics import rung_limit as rl
    from sphax_torch.physics import window_kernels as wk

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench.card()
    name = torch.cuda.get_device_name(0)
    log(f"[1 device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.device_count()} card(s)")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    log(f"[2 build] {time.perf_counter() - t0:.1f} s to build and load "
        f"{_build.library_path().name} "
        f"(nvcc {_build.BUILD_INFO['seconds']} s)")
    for line in _build.BUILD_INFO["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("   ", line.strip())

    knobs = dict(cutoff_scale=1.05, ghost_safety=1.4, fast_sub=3, rgroups=2)
    # problems._window_engine's knobs (with h_margin 1.3)
    KH_KNOBS = dict(cutoff_scale=1.25, fast_sub=3, rgroups=2)
    TOL = {torch.float32: 3e-5, torch.float64: 1e-10}

    def compare(got, want, real, tol, what):
        """Assert |got - want| <= tol |want| + tol max|want| on ``real``
        rows; return the largest absolute error."""
        got, want = got[real].double(), want[real].double()
        assert bool(torch.isfinite(got).all()), f"{what}: non-finite"
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        bad = (got - want).abs() > tol * want.abs() + tol * scale
        assert not bool(bad.any()), (
            f"{what}: {int(bad.sum())} rows outside rtol=atol/max={tol}; "
            f"max abs err {err:.3g} (scale {scale:.3g})")
        errs[what] = err / scale if scale else 0.0
        return err

    errs = {}

    def worst(prefix):
        return max(v for k, v in errs.items() if k.startswith(prefix))

    def sorted_inputs(n_side, dtype, seed=1, dim=3, compact=False):
        """Sorted kernel inputs at a path's geometry (owner-consistent on
        ghost rows): positions of the turbulence ICs with the main path's
        window knobs (3D), or of the Kelvin-Helmholtz ICs at nx = 4 n_side
        with the kh problem's knobs (2D); a seeded 0.4 N(0,1) velocity, and
        plausible seeded per-particle fields for kernel C. ``compact`` plans
        with plan_compact."""
        if dim == 3:
            cfg = dataclasses.replace(configs.TURB, newton_iters=1)
            ic = turbulence.build(n_side=n_side)
            margin, kn = 1.05, knobs
        else:
            cfg = configs.KH
            ic = kh_ics.build(nx=4 * n_side)
            margin, kn = 1.3, KH_KNOBS
        st = make_state(*(torch.as_tensor(ic[k], dtype=dtype, device=dev)
                          for k in ("pos", "vel", "mass", "u", "h")))
        dom = box(torch.zeros(dim, dtype=dtype, device=dev),
                  torch.ones(dim, dtype=dtype, device=dev))
        plan = win.plan_compact if compact else win.plan_measured
        spec = plan(st.pos, dom, h_max=float(st.h.max()) * margin, dim=dim,
                    **kn)
        wd = win.build(st.pos, dom, spec)
        return cfg, spec, wd, seeded_fields(st, wd, seed)

    def seeded_fields(st, wd, seed):
        """Sorted kernel inputs for the positions, masses and h of ``st``:
        a seeded 0.4 N(0,1) velocity and plausible seeded per-particle
        fields for kernel C, owner-consistent on ghost rows."""
        dtype = st.pos.dtype
        g = torch.Generator(device=dev).manual_seed(seed)

        def rnd(lo, hi, shape=(st.n,)):
            return lo + (hi - lo) * torch.rand(shape, generator=g,
                                               dtype=dtype, device=dev)
        vel = 0.4 * torch.randn(st.vel.shape, generator=g, dtype=dtype,
                                device=dev)
        rho = rnd(0.8, 1.2)
        cols = {"vel_s": (vel, 0.0), "mass_s": (st.mass, 0.0),
                "h0_s": (st.h, 1.0), "h_s": (st.h * rnd(0.95, 1.05), 1.0),
                "rho_s": (rho, 1.0), "P_s": (rho * rnd(0.9, 1.1), 1.0),
                "cs_s": (rnd(0.8, 1.2), 1.0), "om_s": (rnd(0.9, 1.1), 1.0),
                "bf_s": (rnd(0.0, 1.0), 0.0)}
        f = {k: win.gather_sorted(v, wd, fill) for k, (v, fill)
             in cols.items()}
        f["pos_s"] = wd.pos_s
        return f

    A_MODES = {
        "cold": dataclasses.replace(configs.TURB, newton_iters=1),
        "h_predict": dataclasses.replace(configs.TURB, newton_iters=1,
                                         h_predict=True),
    }
    A_ARGS = ("pos_s", "mass_s", "h0_s")
    C_ARGS = ("pos_s", "vel_s", "mass_s", "h_s", "rho_s", "P_s", "cs_s",
              "om_s", "bf_s")

    # ---- 3. kernel A parity ---------------------------------------------
    for dtype in (torch.float32, torch.float64):
        _, spec, wd, f = sorted_inputs(48, dtype)
        for mode, cfg in A_MODES.items():
            args = [f[k] for k in A_ARGS]
            got = wk.solve_h_density(wd, spec, *args, cfg, vel_s=f["vel_s"])
            want = wk.solve_h_density_plain(wd, spec, *args, cfg,
                                             vel_s=f["vel_s"])
            torch.cuda.synchronize()
            e = max(compare(a, b, wd.is_real, TOL[dtype],
                            f"A {mode} {dtype} out{k}")
                    for k, (a, b) in enumerate(zip(got, want)))
            log(f"[3 kernel A] {mode:9s} {str(dtype):13s} n={spec.n_sorted} "
                f"wseg={spec.wseg}: max abs err {e:.3g}, max err/scale "
                f"{worst(f'A {mode} {dtype}'):.3g} (tol {TOL[dtype]})")

    # ---- 4. kernel C parity ---------------------------------------------
    for dtype in (torch.float32, torch.float64):
        cfg, spec, wd, f = sorted_inputs(48, dtype)
        args = [f[k] for k in C_ARGS]
        got = wk.forces(wd, spec, *args, cfg)
        want = wk.forces_plain(wd, spec, *args, cfg)
        torch.cuda.synchronize()
        e = max(compare(got[0], want[0], wd.is_real, TOL[dtype],
                        f"C {dtype} acc"),
                compare(got[1], want[1], wd.is_real, TOL[dtype],
                        f"C {dtype} du"))
        log(f"[4 kernel C] exact     {str(dtype):13s}: max abs err {e:.3g}, "
            f"max err/scale {worst(f'C {dtype}'):.3g} (tol {TOL[dtype]})")
        if dtype == torch.float32:
            fast = dataclasses.replace(cfg, fast_math=True)
            got = wk.forces(wd, spec, *args, fast)
            torch.cuda.synchronize()
            e = max(compare(got[0], want[0], wd.is_real, 2e-3,
                            "C fast_math acc"),
                    compare(got[1], want[1], wd.is_real, 2e-3,
                            "C fast_math du"))
            log(f"[4 kernel C] fast_math float32 vs exact plain: max abs "
                f"err {e:.3g}, max err/scale {worst('C fast_math'):.3g} "
                f"(tol 2e-3)")

    # ---- 5. derived pass: kernels vs plain versions, on the card ---------
    @contextlib.contextmanager
    def plain_kernels():
        saved = wk.solve_h_density, wk.forces
        wk.solve_h_density, wk.forces = wk.solve_h_density_plain, \
            wk.forces_plain
        with plain_rowpack():
            try:
                yield
            finally:
                wk.solve_h_density, wk.forces = saved

    cfg = dataclasses.replace(configs.TURB, newton_iters=1)
    st, dom, spec = bench.setup(48, cfg, dev, vel_scale=0.4, **knobs)
    got = wengine.update_derived(st, cfg, dom, spec)
    with plain_kernels():
        want = wengine.update_derived(st, cfg, dom, spec)
    torch.cuda.synchronize()
    every = torch.ones(st.n, dtype=torch.bool, device=dev)
    e = max(compare(getattr(got, k), getattr(want, k), every, 3e-5,
                    f"derived {k}")
            for k in ("h", "rho", "P", "omega", "divv", "acc", "du_dt"))
    log(f"[5 derived] update_derived kernels vs plain, n={st.n}: max abs "
        f"err {e:.3g}, max err/scale {worst('derived'):.3g} (tol 3e-5)")

    paths = {}

    def zero_counts():
        """Set the launch counts of kernels A, C and G, of the three
        row-packing kernels, of the two CIC kernels and of the timestep
        limiter's two kernels to 0."""
        for c_ in (wk.LAUNCHES, rowpack.LAUNCHES, pm.LAUNCHES, rl.LAUNCHES):
            for k in c_:
                c_[k] = 0

    def counts():
        return (dict(wk.LAUNCHES) | dict(rowpack.LAUNCHES)
                | dict(pm.LAUNCHES) | dict(rl.LAUNCHES))

    def with_cic(want):
        """``want`` with the CIC kernels' launches, where it does not give
        them: one of each a launch of C's gravity mode (the P3M mesh of the
        same derived pass)."""
        n_g = sum(v for k, v in want.items() if k.startswith("forces_grav"))
        if n_g == 0 or "cic_deposit" in want:
            return want
        return want | {"cic_deposit": n_g, "cic_interp": n_g}

    # one derived pass of the window engine: each row-packing kernel once
    one_pass = {k: 1 for k in rowpack.LAUNCHES}

    def _key(base, compact, dim):
        """The launch key of a walk (window_kernels._walk's)."""
        return wk._kernel_name(f"{base}_compact" if compact else base, dim)

    def shard_packing(want):
        """A shard rank's launches: its passes pack A's window through
        ``rowpack_gather_a``, once a launch of A; C's window they pack
        themselves; their P3M mesh launches the CIC kernels."""
        return with_cic(want) | {"rowpack_gather_a": want["solve_h_density"]}

    def drive(name, run, want):
        """Run one path with every launch count set to 0 just before it;
        read the counts just after and hold them to ``want`` (kernels
        absent from it must not launch), or to ``want(out)`` where the
        count depends on the run. On one device every derived pass packs
        through the row-packing kernels: ``rowpack_gather_a`` must launch
        once a launch of A (the rung path's seeding pass of A included),
        ``rowpack_gather_c`` and ``rowpack_scatter_out`` once a launch of
        C; and the CIC kernels as ``with_cic`` has them."""
        zero_counts()
        out = run()
        torch.cuda.synchronize()
        paths[name] = counts()
        if callable(want):
            want = want(out)
        want = with_cic(want)
        n_a, n_c = (sum(v for k, v in want.items() if k.startswith(base))
                    for base in ("solve_h_density", "forces"))
        want = want | {"rowpack_gather_a": n_a, "rowpack_gather_c": n_c,
                       "rowpack_scatter_out": n_c}
        assert paths[name] == {k: want.get(k, 0) for k in paths[name]}, (
            name, paths[name])
        return out

    # ---- 6. main path ----------------------------------------------------
    t0 = time.perf_counter()
    per = 1 + 4 * 16      # cold derived pass + warm-up and 3 timed runs
    res, st_main, dom_main, spec_main = drive(
        "bench", lambda: bench.run(n_side=100, steps=16, reps=3, device=dev),
        {"solve_h_density": per, "forces": per})
    res.update(particle_steps_per_s=res["value"], launches=paths["bench"],
               card=card, setup_and_runs_s=time.perf_counter() - t0)
    log("[6 main path]", json.dumps(res))

    # ---- 7. driven phase (CLI turb configuration) ------------------------
    cfg_d = dataclasses.replace(configs.TURB, newton_iters=2)
    st, dom, spec = bench.setup(100, cfg_d, dev, vel_scale=0.0,
                                h_margin=1.3, cutoff_scale=1.25, fast_sub=3,
                                rgroups=2)
    modes = tuple(map(tuple, driving.make_modes(1, 2).astype(int)))
    dspec = driving.DriveSpec(modes=modes, tau=0.5, accel_rms=3.0)
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    st, dr, dts, ovf = drive("driven", lambda: wengine.simulate(
        st, cfg_d, dom, spec, 4, rebuild_every=2,
        drive=driving.init(len(modes), dtype=torch.float32, device=dev),
        drive_spec=dspec, noise=driving.gaussian_noise(gen)),
        {"solve_h_density": 4, "forces": 4})
    wall = time.perf_counter() - t0
    assert int(ovf) == 0, f"overflow {int(ovf)} in the driven phase"
    for f_ in ("pos", "vel", "h", "rho", "acc", "du_dt"):
        assert bool(torch.isfinite(getattr(st, f_)).all()), f_
    assert bool((dts > 0).all()) and bool(torch.isfinite(dr.amp_re).all())
    vrms = float(st.vel.pow(2).sum(-1).mean().sqrt())
    log(f"[7 driven] N={st.n} wseg={spec.wseg} 4 steps in {wall:.3f} s, "
        f"overflow 0, v_rms {vrms:.4g}, h_residual "
        f"{bench.h_residual(st, cfg_d):.3g}")

    # ---- 8. kernel times at the N = 1e6 shapes ---------------------------
    cfg = dataclasses.replace(configs.TURB, newton_iters=1, fast_math=True,
                              h_predict=True)
    wd = win.build(st_main.pos, dom_main, spec_main)
    c = torch.cat([st_main.pos, st_main.vel, st_main.mass[:, None],
                   st_main.h[:, None], st_main.rho[:, None],
                   st_main.P[:, None], st_main.cs[:, None],
                   st_main.omega[:, None]], dim=-1)
    g = win.gather_sorted_cols(c, wd, [0.0] * 6 + [0.0] + [1.0] * 5)
    f = dict(pos_s=wd.pos_s, vel_s=g[:, 3:6], mass_s=g[:, 6], h0_s=g[:, 7],
             h_s=g[:, 7], rho_s=g[:, 8], P_s=g[:, 9], cs_s=g[:, 10],
             om_s=g[:, 11], bf_s=torch.ones_like(g[:, 11]))
    f = {k: v.contiguous() for k, v in f.items()}
    real = wd.is_real

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            out = fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps, out

    times = {}
    for label, kcfg in (("A cold", A_MODES["cold"]),
                        ("A h_predict", cfg)):
        args = [f[k] for k in A_ARGS]
        ms, got = cuda_ms(lambda: wk.solve_h_density(
            wd, spec_main, *args, kcfg, vel_s=f["vel_s"]), 10)
        pms, want = cuda_ms(lambda: wk.solve_h_density_plain(
            wd, spec_main, *args, kcfg, vel_s=f["vel_s"]), 2)
        e = max(compare(a, b, real, 3e-5, f"{label} at N=1e6")
                for a, b in zip(got, want))
        times[label] = (ms, pms, e)
        log(f"[8 times] {label:12s} kernel {ms:.3f} ms  plain {pms:.1f} ms "
            f" max abs err {e:.3g}")
    args = [f[k] for k in C_ARGS]
    ms, got = cuda_ms(lambda: wk.forces(wd, spec_main, *args, cfg), 10)
    pms, want = cuda_ms(lambda: wk.forces_plain(wd, spec_main, *args, cfg), 2)
    e = max(compare(got[0], want[0], real, 2e-3, "C fast_math at N=1e6"),
            compare(got[1], want[1], real, 2e-3, "C fast_math du at N=1e6"))
    times["C"] = (ms, pms, e)
    log(f"[8 times] {'C fast_math':12s} kernel {ms:.3f} ms  plain {pms:.1f} "
        f"ms  max abs err {e:.3g}")
    walked, computed = candidate_rows(wd, spec_main)
    log(f"[8 times] candidate rows per real row at N=1e6: walked {walked:.1f}"
        f", computed {computed:.1f}")
    pa, pc, _ = pair_counts(wd, spec_main, f["pos_s"], f["mass_s"], f["h_s"])
    bounds = {
        "A": kernel_bound("A", spec_main, f["pos_s"], pa, iters=0,
                          bals=True),
        "A cold": kernel_bound("A", spec_main, f["pos_s"], pa,
                               iters=A_MODES["cold"].newton_iters,
                               bals=True),
        "C": kernel_bound("C", spec_main, f["pos_s"], pc, bf=True)}
    log(f"[8 times] pairs inside the support per real row: A "
        f"{pa / int(real.sum()):.1f}, C {pc / int(real.sum()):.1f}; bounds "
        + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]})" for k, v in bounds.items()))

    # ---- 9. kernel C gravity mode parity --------------------------------
    def p3m_cfg(cfg):
        return dataclasses.replace(cfg, gravity=True, grav_solver="p3m",
                                   grav_mesh=128)

    for dtype in (torch.float32, torch.float64):
        cfg, spec, wd, f = sorted_inputs(48, dtype)
        cfg = p3m_cfg(cfg)
        dom = box(torch.zeros(3, dtype=dtype, device=dev),
                  torch.ones(3, dtype=dtype, device=dev))
        grav = (pm.rs_traced(cfg, dom, dtype, cutoff=spec.cutoff),
                cfg.grav_eps)
        args = [f[k] for k in C_ARGS]
        got = wk.forces(wd, spec, *args, cfg, grav=grav)
        want = wk.forces_plain(wd, spec, *args, cfg, grav=grav)
        torch.cuda.synchronize()
        e = max(compare(got[0], want[0], wd.is_real, TOL[dtype],
                        f"Cg {dtype} acc"),
                compare(got[1], want[1], wd.is_real, TOL[dtype],
                        f"Cg {dtype} du"))
        log(f"[9 kernel C+grav] {str(dtype):13s} rs {float(grav[0]):.4g} "
            f"cutoff {spec.cutoff:.4g}: max abs err {e:.3g}, max err/scale "
            f"{worst(f'Cg {dtype}'):.3g} (tol {TOL[dtype]})")

    # ---- 10. kernel G parity ---------------------------------------------
    G_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
    cfg_gt = configs.SPHConfig(gravity=True, G=1.4, grav_eps=0.03)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    g_launch = {}
    for n in (1, 255, 257, 5000, 65537, 64 ** 3):
        for dtype in (torch.float32, torch.float64):
            pos, mass = cloud(dev, n, dtype)
            got = dg.gravity(pos, mass, cfg_gt)
            again = dg.gravity(pos, mass, cfg_gt)
            want = dg.gravity_plain(pos, mass, cfg_gt)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (
                f"G {n} {dtype}: two launches differ")
            every = torch.ones(n, dtype=torch.bool, device=dev)
            e = compare(got, want, every, G_TOL[dtype], f"G {n} {dtype}")
            plan = dg.gravity_plan(n, sm_count)
            g_launch[str(dtype)] = last_launch(_build.load(),
                                              "sphax_gravity_last_launch")
            log(f"[10 kernel G] N={n:7d} {str(dtype):13s} plan (rows a "
                f"thread, threads, slices, columns a slice) {plan}: max abs "
                f"err {e:.3g}, max err/scale {worst(f'G {n} {dtype}'):.3g} "
                f"(tol {G_TOL[dtype]}); a second launch bitwise equal")
    for k, v in g_launch.items():
        # gravity_plan counts on the blocks a SM its __launch_bounds__ keep
        assert v["blocks_per_sm"] >= dg.BLOCKS_PER_SM, (k, v)
        log(f"[10 kernel G] {k} at N = 64^3, the runtime: {v}")
    del pos, mass, got, again, want

    # ---- 11. P3M path: the driven configuration with self-gravity --------
    cfg_g = p3m_cfg(cfg_d)
    st, dom, spec = bench.setup(100, cfg_g, dev, vel_scale=0.0,
                                h_margin=1.3, cutoff_scale=1.25, fast_sub=3,
                                rgroups=2)
    spec_g, dom_g = spec, dom
    rs_g = pm.rs_traced(cfg_g, dom, torch.float32, cutoff=spec.cutoff)
    rs_cells = float(rs_g) * cfg_g.grav_mesh / float(dom.extent.min())

    def p3m_run(st, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return wengine.simulate(
            st, cfg_g, dom, spec, 4, rebuild_every=2,
            drive=driving.init(len(modes), dtype=torch.float32, device=dev),
            drive_spec=dspec, noise=driving.gaussian_noise(gen))

    t0 = time.perf_counter()
    st_g, dr, dts, ovf = drive("p3m", lambda: p3m_run(st, 1),
                               {"solve_h_density": 4, "forces_grav": 4})
    wall_g = time.perf_counter() - t0
    assert int(ovf) == 0, f"overflow {int(ovf)} in the P3M path"
    for f_ in ("pos", "vel", "h", "rho", "acc", "du_dt"):
        assert bool(torch.isfinite(getattr(st_g, f_)).all()), f_
    assert bool((dts > 0).all()) and bool(torch.isfinite(dr.amp_re).all())
    t0 = time.perf_counter()
    p3m_run(st_g, 2)                      # warm: the step time
    torch.cuda.synchronize()
    step_g = (time.perf_counter() - t0) / 4
    # total momentum of one derived pass, before the driving term: the
    # symmetrized SPH pairs cancel to roundoff, so this holds the mesh and
    # the fused short range to test_pm.py's gate
    wd_g = win.build(st_g.pos, dom, spec)
    out = wengine.derived_with(st_g, wd_g, cfg_g, dom, spec)
    ma = (st_g.mass[:, None] * out.acc).double()
    mom = (ma.sum(0).abs() / ma.abs().sum(0)).max().item()
    assert mom < 2e-3, f"momentum {mom} in the P3M derived pass"
    log(f"[11 P3M path] N={st_g.n} wseg={spec.wseg} rs={float(rs_g):.5g} = "
        f"{rs_cells:.3f} mesh cells (cutoff {spec.cutoff:.5g}); 4 steps in "
        f"{wall_g:.3f} s cold, {step_g * 1e3:.1f} ms/step warm; overflow 0,"
        f" h_residual {bench.h_residual(st_g, cfg_g):.3g}, |sum m a| / "
        f"sum |m a| = {mom:.3g} (< 2e-3)")

    # ---- 12. direct path: open box, kernel G -----------------------------
    cfg_dir = dataclasses.replace(configs.TURB, gravity=True,
                                  grav_solver="direct", grav_eps=0.01)
    ic = turbulence.build(n_side=100)
    st_o = make_state(*(torch.as_tensor(ic[k], dtype=torch.float32,
                                        device=dev)
                        for k in ("pos", "vel", "mass", "u", "h")))
    dom_o = box(torch.zeros(3, device=dev), torch.ones(3, device=dev),
                periodic=False)
    spec_o = win.plan_measured(st_o.pos, dom_o,
                               h_max=float(st_o.h.max()) * 1.05, dim=3,
                               **knobs)
    t0 = time.perf_counter()
    out = drive("direct", lambda: wengine.update_derived(
        st_o, cfg_dir, dom_o, spec_o),
        {"solve_h_density": 1, "forces": 1, "gravity": 1})
    wall_o = time.perf_counter() - t0
    for f_ in ("h", "rho", "acc", "du_dt"):
        assert bool(torch.isfinite(getattr(out, f_)).all()), f_
    a_g = dg.gravity(st_o.pos, st_o.mass, cfg_dir)
    d = st_o.pos - 0.5
    radial = float(((d * a_g).sum(-1) / d.norm(dim=-1).clamp_min(1e-12))
                   .mean())
    assert radial < 0.0, f"kernel G's mean radial acceleration {radial}"
    rows = torch.randperm(st_o.n, device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(4))[:8192]
    want = dg.gravity_plain(st_o.pos, st_o.mass, cfg_dir, rows=rows)
    g_e = compare(a_g[rows], want, torch.ones_like(rows, dtype=torch.bool),
                  1e-4, "G at N=1e6")
    log(f"[12 direct path] N={st_o.n} open box, one update_derived in "
        f"{wall_o:.3f} s; kernel G's mean radial acceleration {radial:.4g} "
        f"(< 0); vs plain on 8192 sampled rows: max abs err {g_e:.3g}, max "
        f"err/scale {errs['G at N=1e6']:.3g} (tol 1e-4)")

    # ---- 13. gravity times -----------------------------------------------
    c = torch.cat([st_g.pos, st_g.vel, st_g.mass[:, None], st_g.h[:, None],
                   st_g.rho[:, None], st_g.P[:, None], st_g.cs[:, None],
                   st_g.omega[:, None]], dim=-1)
    g = win.gather_sorted_cols(c, wd_g, [0.0] * 6 + [0.0] + [1.0] * 5)
    fg = dict(pos_s=wd_g.pos_s, vel_s=g[:, 3:6], mass_s=g[:, 6],
              h_s=g[:, 7], rho_s=g[:, 8], P_s=g[:, 9], cs_s=g[:, 10],
              om_s=g[:, 11], bf_s=torch.ones_like(g[:, 11]))
    args = [fg[k].contiguous() for k in C_ARGS]
    grav = (rs_g, cfg_g.grav_eps)
    cg = {}
    for label, gr in (("with", grav), ("without", None)):
        ms, got = cuda_ms(lambda: wk.forces(wd_g, spec, *args, cfg_g,
                                            grav=gr), 10)
        pms, want = cuda_ms(lambda: wk.forces_plain(wd_g, spec, *args,
                                                    cfg_g, grav=gr), 1)
        e = max(compare(a, b, wd_g.is_real, 3e-5, f"C {label} grav at N=1e6")
                for a, b in zip(got, want))
        cg[label] = (ms, pms, e)
        log(f"[13 times] C {label:7s} gravity, P3M path shapes: kernel "
            f"{ms:.3f} ms  plain {pms:.1f} ms  max abs err {e:.3g}")
    del got, want
    walked_g, _ = candidate_rows(wd_g, spec)
    _, pc_g, pg_g = pair_counts(wd_g, spec, fg["pos_s"], fg["mass_s"],
                                fg["h_s"], cutoff=spec.cutoff)
    bounds["C grav"] = kernel_bound("C", spec, fg["pos_s"], pc_g, bf=True,
                                    grav_pairs=pg_g)
    log(f"[13 times] candidate rows per real row, P3M path: walked "
        f"{walked_g:.1f}; pairs inside the cutoff {pg_g / st_g.n:.1f}; "
        f"bound of C with gravity {bounds['C grav'][0]:.4f} ms "
        f"({bounds['C grav'][1]})")
    g_ms_1e6, _ = cuda_ms(lambda: dg.gravity(st_o.pos, st_o.mass, cfg_dir), 2)
    g_by_n = {}
    for n_g, dtype in ((4096, torch.float32), (65536, torch.float32),
                       (64 ** 3, torch.float32), (10 ** 6, torch.float32),
                       (4096, torch.float64), (65536, torch.float64),
                       (64 ** 3, torch.float64)):
        if n_g == 10 ** 6:      # the direct path's lattice, timed above
            ms, pos = g_ms_1e6, st_o.pos
        else:
            pos, mass = cloud(dev, n_g, dtype)
            ms, _ = cuda_ms(lambda: dg.gravity(pos, mass, cfg_gt),
                            2 if n_g == 64 ** 3 and dtype == torch.float64
                            else 5)
        size = pos.element_size()
        b_ms, b_by = gravity_bound(n_g, dtype)
        rows_g, _, slices_g, _ = dg.gravity_plan(n_g, sm_count)
        g_by_n[f"{'fp32' if size == 4 else 'fp64'} N={n_g}"] = {
            "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
            "rows_per_thread": rows_g, "slices": slices_g}
        log(f"[13 times] G {str(dtype):13s} N={n_g:7d}: kernel {ms:.3f} ms, "
            f"bound {b_ms:.3f} ms ({b_by}), {b_ms / ms:.2f} of it; "
            f"{rows_g} rows a thread, {slices_g} slices")
    pos, mass = cloud(dev, 64 ** 3, torch.float32)
    g_ms, got = cuda_ms(lambda: dg.gravity(pos, mass, cfg_gt), 5)
    g_pms, want = cuda_ms(lambda: dg.gravity_plain(pos, mass, cfg_gt), 1)
    compare(got, want, torch.ones(pos.shape[0], dtype=torch.bool,
                                  device=dev), 1e-4, "G timed 64^3")
    n_g = pos.shape[0]
    bounds["G"] = gravity_bound(n_g, torch.float32)
    log(f"[13 times] G fp32: N=1e6 kernel {g_ms_1e6:.2f} ms; N=64^3 kernel "
        f"{g_ms:.3f} ms  plain {g_pms:.1f} ms  bound {bounds['G'][0]:.3f} ms "
        f"({bounds['G'][1]})")
    mesh_ms, _ = cuda_ms(lambda: pm.mesh_accel(st_g.pos, st_g.mass, cfg_g,
                                               dom, rs=rs_g), 10)
    # back-to-back calls time the host's launches of ~100 small torch
    # kernels; the profiler gives the device time those kernels take
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        pm.mesh_accel(st_g.pos, st_g.mass, cfg_g, dom, rs=rs_g)
        torch.cuda.synchronize()
    mesh_dev_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    log(f"[13 times] pm.mesh_accel N=1e6 M=128: {mesh_ms:.3f} ms a call "
        f"back to back ({100 * mesh_ms / (step_g * 1e3):.1f} % of a warm "
        f"P3M step), device time {mesh_dev_ms:.3f} ms (profiler)")

    # ---- 14. 2D kernels: the dim=2 instantiations vs plain ---------------
    for dtype in (torch.float32, torch.float64):
        cfg, spec, wd, f = sorted_inputs(16, dtype, dim=2)
        args = [f[k] for k in A_ARGS]
        got = wk.solve_h_density(wd, spec, *args, cfg, vel_s=f["vel_s"])
        want = wk.solve_h_density_plain(wd, spec, *args, cfg,
                                         vel_s=f["vel_s"])
        torch.cuda.synchronize()
        e = max(compare(a, b, wd.is_real, TOL[dtype], f"A2 {dtype} out{k}")
                for k, (a, b) in enumerate(zip(got, want)))
        log(f"[14 2D kernel A] cold      {str(dtype):13s} n={spec.n_sorted} "
            f"wseg={spec.wseg} group={spec.group}: max abs err {e:.3g}, max "
            f"err/scale {worst(f'A2 {dtype}'):.3g} (tol {TOL[dtype]})")
        args = [f[k] for k in C_ARGS]
        want = wk.forces_plain(wd, spec, *args, cfg)
        for fast in ((False, True) if dtype == torch.float32 else (False,)):
            got = wk.forces(wd, spec, *args,
                            dataclasses.replace(cfg, fast_math=fast))
            torch.cuda.synchronize()
            tol, tag = (2e-3, "fast_math") if fast else (TOL[dtype], "exact")
            e = max(compare(got[0], want[0], wd.is_real, tol,
                            f"C2 {tag} {dtype} acc"),
                    compare(got[1], want[1], wd.is_real, tol,
                            f"C2 {tag} {dtype} du"))
            log(f"[14 2D kernel C] {tag:9s} {str(dtype):13s}: max abs err "
                f"{e:.3g}, max err/scale {worst(f'C2 {tag} {dtype}'):.3g} "
                f"(tol {tol})")

    KINDS = (("kernel A", ("solve_h_density",)), ("kernel C", ("forces_",)),
             ("sorts", ("RadixSort", "radix_sort", "Onesweep")),
             ("gathers and scatters", ("index", "gather", "scatter")),
             ("packing and copies", ("CatArray", "Memcpy", "copy")),
             ("reductions", ("reduce",)),
             ("elementwise", ("elementwise",)))

    def device_ms_by_kind(run, n):
        """One profiled call of ``run`` (``n`` steps): the device time of
        its CUDA kernels per step, summed by kind of kernel."""
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        out = {k: 0.0 for k, _ in KINDS}
        out["other"] = 0.0
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            kind = next((k for k, pats in KINDS
                         if any(p_ in e.name for p_ in pats)), "other")
            out[kind] += e.time_range.elapsed_us() / 1e3 / n
        assert out["kernel A"] > 0 and out["kernel C"] > 0, out
        return out

    def fresh(path):
        """An empty output directory under the checkout's build/."""
        shutil.rmtree(path, ignore_errors=True)
        return path

    def records(out):
        with open(os.path.join(out, "metrics.jsonl")) as fh:
            return [json.loads(line) for line in fh]

    def p_sum(st):
        """(total momentum, sum m |v|), summed in fp64."""
        mv = st.mass.double()[:, None] * st.vel.double()
        return mv.sum(0), float(mv.norm(dim=-1).sum())

    # ---- 15. the CLI main path: python -m sphax_torch kh n=1024 ------------
    kh_out = fresh(os.path.join("build", "smoke", "kh"))
    kh_args = ["kh", "n=1024", "chunk=16"]
    ic = kh_ics.build(nx=1024)
    st0 = make_state(*(torch.as_tensor(ic[k], dtype=torch.float32,
                                       device=dev)
                       for k in ("pos", "vel", "mass", "u", "h")))
    p0, mv0 = p_sum(st0)
    del st0
    t0 = time.perf_counter()
    st_kh, t_kh, step_kh = drive(
        "kh", lambda: cli(kh_args + ["max_steps=16", f"out={kh_out}"]),
        {"solve_h_density_2d": 17, "forces_2d": 17})
    wall_kh = time.perf_counter() - t0
    recs = records(kh_out)
    ck = os.path.join(kh_out, "checkpoint.npz")
    assert step_kh == 16 and os.path.exists(ck), step_kh
    assert [r["step"] for r in recs] == [16, 16], recs
    assert all(r["finite"] for r in recs) and recs[0]["h_capped"] == 0, recs
    for f_ in ("pos", "vel", "h", "rho", "acc", "du_dt"):
        assert bool(torch.isfinite(getattr(st_kh, f_)).all()), f_
    dp = float((p_sum(st_kh)[0] - p0).abs().max()) / mv0
    assert dp < 1e-5, f"kh momentum drift {dp}"
    prob_kh = problems.kh(n=1024)
    assert prob_kh.engine_name == "window" and prob_kh.wspec.n_seg == 3
    # resume from the checkpoint for one more chunk
    st_ck, t_ck, step_ck, _, _ = checkpoint.load(ck, device=dev)
    assert (t_ck, step_ck) == (t_kh, 16)
    assert all(torch.equal(getattr(st_ck, k), getattr(st_kh, k))
               for k in st_kh._fields)
    kh_out_r = fresh(os.path.join("build", "smoke", "kh_resume"))
    st_r, t_r, step_r = drive(
        "kh resume", lambda: cli(kh_args + ["max_steps=32", f"out={kh_out_r}",
                                            f"resume={ck}"]),
        {"solve_h_density_2d": 17, "forces_2d": 17})
    assert step_r == 32 and records(kh_out_r)[0]["step"] == 32
    # the direct continuation of the saved state, timed warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cont, _, dts_c, ovf_c = wengine.simulate(st_ck, prob_kh.cfg,
                                             prob_kh.domain, prob_kh.wspec,
                                             16)
    torch.cuda.synchronize()
    kh_step = (time.perf_counter() - t0) / 16
    assert int(ovf_c) == 0
    assert math.isclose(t_r, t_ck + float(dts_c.sum()), rel_tol=1e-9)
    every = torch.ones(st_r.n, dtype=torch.bool, device=dev)
    e_r = max(compare(getattr(st_r, k), getattr(cont, k), every, 1e-6,
                      f"kh resume {k}") for k in ("pos", "vel", "u", "h"))
    kh_pss = st_kh.n / kh_step
    log(f"[15 kh CLI] {card} | N={st_kh.n} wseg={prob_kh.wspec.wseg} "
        f"group={prob_kh.wspec.group}: 16 steps in {wall_kh:.2f} s with set-"
        f"up (CLI record {recs[0]['particle_steps_per_sec']:.4g} "
        f"particle-steps/s); warm {kh_step * 1e3:.2f} ms/step = "
        f"{kh_pss:.4g} particle-steps/s; |dp|/sum m|v| {dp:.3g} (< 1e-5); "
        f"h_capped 0; resumed at t={t_ck:.5g} step 16, ran to step "
        f"{step_r}; vs the direct continuation max abs err {e_r:.3g}")

    # ---- 16. the KH growth gate through the 2D kernels (fp64) --------------
    def kh_gate():
        prob = problems.kh(n=32, dtype=torch.float64)
        mass = prob.state.mass.cpu().numpy()

        def amp(s):
            return kh_ics.mode_amplitude(s.pos.cpu().numpy(),
                                         s.vel.cpu().numpy(), mass)
        amps, times_ = [amp(prob.state)], [0.0]

        def cb(s, t, n):
            amps.append(amp(s))
            times_.append(t)
        st, _, _, n = run_mod.simulate_until(
            prob.state, prob.cfg, prob.domain, prob.engine, t_end=0.8,
            chunk=32, max_steps=3000, callback=cb)
        return prob, st, np.asarray(amps), np.asarray(times_), n

    t0 = time.perf_counter()
    prob16, st16, amps, times16, n16 = drive(
        "kh gate", kh_gate, lambda out: {"solve_h_density_2d": 1 + out[4],
                                         "forces_2d": 1 + out[4]})
    wall16 = time.perf_counter() - t0
    assert prob16.engine_name == "window"
    assert bool(torch.isfinite(st16.rho).all())
    gamma_th = 2 * math.pi * 2 * math.sqrt(2.0) / 3.0
    i0 = int(np.argmin(amps))
    assert i0 < len(amps) - 3, "no post-transient growth window"
    rate = float(np.polyfit(times16[i0:], np.log(amps[i0:]), 1)[0])
    assert 0.24 * gamma_th < rate < 0.40 * gamma_th, (rate, gamma_th)
    assert amps[-1] > 2.0 * amps[i0]
    dp16 = float((p_sum(st16)[0] - p_sum(prob16.state)[0]).abs().max())
    assert dp16 < 1e-10, dp16
    capped16 = int(wengine.capped_count(st16, prob16.wspec))
    log(f"[16 KH gate] N={st16.n} fp64 window engine, {n16} steps in "
        f"{wall16:.2f} s: rate {rate:.4f} = {rate / gamma_th:.3f} of linear "
        f"theory (gate [0.24, 0.40]), amplitude x{amps[-1] / amps[i0]:.2f} "
        f"from step {i0 * 32}, |dp| {dp16:.3g} (< 1e-10), h_capped "
        f"{capped16}")

    # ---- 17. the other problems through the CLI ----------------------------
    for label, args, want in (
            ("sod", ["sod"], {}),
            ("sedov mm", ["sedov", "n=32", "visc=mm"],
             {"solve_h_density": 5, "forces": 5}),
            ("evrard", ["evrard", "n=4096"], {})):
        out = fresh(os.path.join("build", "smoke", args[0]))
        t0 = time.perf_counter()
        st_p, _, step_p = drive(label, lambda: cli(
            args + ["max_steps=4", f"out={out}"]), want)
        wall_p = time.perf_counter() - t0
        recs = records(out)
        assert step_p == 4 and all(r["finite"] for r in recs), recs
        for f_ in ("pos", "vel", "h", "rho", "acc"):
            assert bool(torch.isfinite(getattr(st_p, f_)).all()), (label, f_)
        note = ""
        if label == "sedov mm":
            a_max = float(st_p.alpha.max())
            assert a_max > configs.SEDOV.mm_alpha_min, a_max
            note = f", MM alpha up to {a_max:.3f}"
        if label == "evrard":
            note = f", e_grav {recs[-1]['e_grav']:.5f}"
        log(f"[17 problems] {label:8s} N={st_p.n}: 4 steps in {wall_p:.2f} s "
            f"with set-up, launches {paths[label]}, E "
            f"{recs[-1]['e_total']:.6f}" + note)

    # ---- 18. 2D kernel times at the path-15 shapes -------------------------
    spec2 = prob_kh.wspec
    wd2 = win.build(st_kh.pos, prob_kh.domain, spec2)
    c = torch.cat([st_kh.pos, st_kh.vel, st_kh.mass[:, None],
                   st_kh.h[:, None], st_kh.rho[:, None], st_kh.P[:, None],
                   st_kh.cs[:, None], st_kh.omega[:, None]], dim=-1)
    g = win.gather_sorted_cols(c, wd2, [0.0] * 4 + [0.0] + [1.0] * 5)
    f2 = dict(pos_s=wd2.pos_s, vel_s=g[:, 2:4], mass_s=g[:, 4],
              h0_s=g[:, 5], h_s=g[:, 5], rho_s=g[:, 6], P_s=g[:, 7],
              cs_s=g[:, 8], om_s=g[:, 9], bf_s=torch.ones_like(g[:, 9]))
    f2 = {k: v.contiguous() for k, v in f2.items()}
    real2 = wd2.is_real
    cfg2 = prob_kh.cfg
    args = [f2[k] for k in A_ARGS]
    a2_ms, got = cuda_ms(lambda: wk.solve_h_density(
        wd2, spec2, *args, cfg2, vel_s=f2["vel_s"]), 5)
    a2_pms, want = cuda_ms(lambda: wk.solve_h_density_plain(
        wd2, spec2, *args, cfg2, vel_s=f2["vel_s"]), 1)
    a2_e = max(compare(a, b, real2, 3e-5, "A2 at kh N")
               for a, b in zip(got, want))
    args = [f2[k] for k in C_ARGS]
    c2_ms, got = cuda_ms(lambda: wk.forces(wd2, spec2, *args, cfg2), 10)
    c2_pms, want = cuda_ms(lambda: wk.forces_plain(wd2, spec2, *args, cfg2),
                           1)
    c2_e = max(compare(a, b, real2, 3e-5, "C2 at kh N")
               for a, b in zip(got, want))
    del got, want
    walked2, computed2 = candidate_rows(wd2, spec2)
    pa2, pc2, _ = pair_counts(wd2, spec2, f2["pos_s"], f2["mass_s"],
                              f2["h_s"])
    bounds["A2"] = kernel_bound("A", spec2, f2["pos_s"], pa2,
                                iters=cfg2.newton_iters, bals=True)
    bounds["C2"] = kernel_bound("C", spec2, f2["pos_s"], pc2, bf=True)
    n_real2 = int(real2.sum())
    log(f"[18 times] 2D at N={st_kh.n}: A cold ({cfg2.newton_iters} Newton "
        f"updates) kernel {a2_ms:.3f} ms  plain {a2_pms:.1f} ms  bound "
        f"{bounds['A2'][0]:.4f} ms ({bounds['A2'][1]})  max abs err "
        f"{a2_e:.3g}; C exact kernel {c2_ms:.3f} ms  plain {c2_pms:.1f} ms  "
        f"bound {bounds['C2'][0]:.4f} ms ({bounds['C2'][1]})  max abs err "
        f"{c2_e:.3g}; candidate rows per real row walked {walked2:.1f}, "
        f"computed {computed2:.1f}; pairs inside the support per real row "
        f"A {pa2 / n_real2:.1f}, C {pc2 / n_real2:.1f}")

    # ---- 19. compact walks vs plain, and vs the in-place walk ------------
    def compact_parity(tag, dim, dtype, cfg, which, grav=None, n_side=48):
        """One kernel's compact walk on phase 3/14's inputs with a compact
        plan: against the compact plain version at ``which``'s tolerance,
        and against the in-place kernel on the same inputs (the same pairs)
        at the dtype's. Returns the largest absolute error."""
        _, spec, wd, f = sorted_inputs(n_side, dtype, dim=dim, compact=True)
        assert int(wd.overflow) == 0 and spec.cwidth > 0
        inplace = dataclasses.replace(spec, cwidth=0)
        gr = None
        if grav:
            dom_ = box(torch.zeros(3, dtype=dtype, device=dev),
                       torch.ones(3, dtype=dtype, device=dev))
            gr = (pm.rs_traced(cfg, dom_, dtype, cutoff=spec.cutoff),
                  cfg.grav_eps)
        if which == "A":
            args = [f[k] for k in A_ARGS]
            run = lambda fn, s_: fn(wd, s_, *args, cfg, vel_s=f["vel_s"])
            fns = (wk.solve_h_density, wk.solve_h_density_plain)
        else:
            args = [f[k] for k in C_ARGS]
            run = lambda fn, s_: fn(wd, s_, *args, cfg, grav=gr)
            fns = (wk.forces, wk.forces_plain)
        got, want = run(fns[0], spec), run(fns[1], spec)
        ref = run(fns[0], inplace)
        torch.cuda.synchronize()
        tol = 2e-3 if cfg.fast_math and dtype == torch.float32 else TOL[dtype]
        key = f"compact {tag} {dtype}"
        e = max(compare(a, b, wd.is_real, tol, f"{key} out{k}")
                for k, (a, b) in enumerate(zip(got, want)))
        e_in = max(compare(a, b, wd.is_real, TOL[dtype],
                           f"{key} vs in place out{k}")
                   for k, (a, b) in enumerate(zip(got, ref)))
        log(f"[19 compact] {tag:14s} {str(dtype):13s} cwidth={spec.cwidth}: "
            f"vs plain max abs err {e:.3g}, max err/scale "
            f"{worst(f'{key} out'):.3g} (tol {tol}); vs the in-place kernel "
            f"{e_in:.3g}, {worst(f'{key} vs'):.3g} (tol {TOL[dtype]})")
        return e

    for dtype in (torch.float32, torch.float64):
        for mode, cfg in A_MODES.items():
            compact_parity(f"A {mode}", 3, dtype, cfg, "A")
        cfg = dataclasses.replace(configs.TURB, newton_iters=1)
        compact_parity("C exact", 3, dtype, cfg, "C")
        if dtype == torch.float32:
            compact_parity("C fast_math", 3, dtype,
                           dataclasses.replace(cfg, fast_math=True), "C")
        compact_parity("C grav", 3, dtype, p3m_cfg(cfg), "C", grav=True)
        compact_parity("A2 cold", 2, dtype, configs.KH, "A", n_side=16)
        compact_parity("C2 exact", 2, dtype, configs.KH, "C", n_side=16)
        if dtype == torch.float32:
            compact_parity("C2 fast_math", 2, dtype,
                           dataclasses.replace(configs.KH, fast_math=True),
                           "C", n_side=16)

    # ---- 20. the compact and adaptive bench paths, and adaptive=8 CLI ----
    def c_stats(wd):
        """Compacted candidates per group with real rows (mean, p99, max)
        and per real row (mean)."""
        n = wd.c_n[wd.c_n > 0].double()
        per_row = wd.c_n.repeat_interleave(
            wd.is_real.numel() // wd.c_n.numel())[wd.is_real].double()
        return (float(n.mean()), float(torch.quantile(n, 0.99)),
                int(n.max()), float(per_row.mean()))

    bench_modes = {}
    for label, kw in (("bench compact", dict(compact=True)),
                      ("bench adaptive=8", dict(adaptive=8)),
                      ("bench compact adaptive=8",
                       dict(compact=True, adaptive=8))):
        tag = "_compact" if kw.get("compact") else ""
        t0 = time.perf_counter()
        res_m, st_m, dom_m, spec_m = drive(label, lambda: bench.run(
            n_side=100, steps=16, reps=3, device=dev, **kw),
            {f"solve_h_density{tag}": per, f"forces{tag}": per})
        res_m.update(launches=paths[label],
                     setup_and_runs_s=time.perf_counter() - t0)
        if spec_m.cwidth:
            wd_m = win.build(st_m.pos, dom_m, spec_m)
            assert int(wd_m.overflow) == 0
            res_m["c_n_mean_p99_max_per_row"] = c_stats(wd_m)
        bench_modes[label] = res_m
        log(f"[20 {label}]", json.dumps(res_m))

    cli_out = fresh(os.path.join("build", "smoke", "turb_adaptive"))
    t0 = time.perf_counter()
    st_a, _, step_a = drive("turb adaptive=8 CLI", lambda: cli(
        ["turb", "n=100", "adaptive=8", "max_steps=16", f"out={cli_out}"]),
        {"solve_h_density": 17, "forces": 17})
    wall_a = time.perf_counter() - t0
    recs = records(cli_out)
    assert step_a == 16 and [r["step"] for r in recs] == [16, 16], recs
    assert all(r["finite"] for r in recs) and recs[0]["h_capped"] == 0, recs
    assert 2 <= recs[0]["rebuilds"] <= 16, recs[0]
    for f_ in ("pos", "vel", "h", "rho", "acc", "du_dt"):
        assert bool(torch.isfinite(getattr(st_a, f_)).all()), f_
    log(f"[20 turb adaptive=8 CLI] N={st_a.n}: 16 steps in {wall_a:.2f} s "
        f"with set-up, overflow 0, {recs[0]['rebuilds']} builds, CLI record "
        f"{recs[0]['particle_steps_per_sec']:.4g} particle-steps/s, mach "
        f"{recs[0]['mach_rms']:.4g}")

    # ---- 21. compact times at the N = 1e6 shapes, beside in-place -------
    def turns(fa, fb, reps=10, rounds=2):
        """Median ms of two launch functions timed in turns a, b, b, a."""
        ta, tb = [], []
        for _ in range(rounds):
            ta.append(cuda_ms(fa, reps)[0])
            tb.append(cuda_ms(fb, reps)[0])
            tb.append(cuda_ms(fb, reps)[0])
            ta.append(cuda_ms(fa, reps)[0])
        return float(np.median(ta)), float(np.median(tb))

    # the bench configuration's shapes (phase 8)
    cfg_b = dataclasses.replace(configs.TURB, newton_iters=1, fast_math=True,
                                h_predict=True)
    wd_b = win.build(st_main.pos, dom_main, spec_main)
    fb = sorted_fields(st_main, wd_b)
    spec_c = with_cwidth(spec_main, st_main.pos, dom_main)
    wd_c = win.build(st_main.pos, dom_main, spec_c)
    assert torch.equal(wd_c.g, wd_b.g) and int(wd_c.overflow) == 0
    real_b = wd_b.is_real
    ctimes = {}
    for label, kcfg in (("A h_predict", cfg_b), ("A cold", A_MODES["cold"])):
        args = [fb[k] for k in A_ARGS]

        def launch(w, s_):
            return lambda: wk.solve_h_density(w, s_, *args, kcfg,
                                              vel_s=fb["vel_s"])
        ims, cms = turns(launch(wd_b, spec_main), launch(wd_c, spec_c))
        got = launch(wd_c, spec_c)()
        pms, want = cuda_ms(lambda: wk.solve_h_density_plain(
            wd_c, spec_c, *args, kcfg, vel_s=fb["vel_s"]), 2)
        e = max(compare(a, b, real_b, 3e-5, f"{label} compact at N=1e6")
                for a, b in zip(got, want))
        ctimes[label] = (cms, pms, e, ims)
    args = [fb[k] for k in C_ARGS]

    def launch_c(w, s_, c_=cfg_b, fields=args, gr=None):
        return lambda: wk.forces(w, s_, *fields, c_, grav=gr)
    ims, cms = turns(launch_c(wd_b, spec_main), launch_c(wd_c, spec_c))
    got = launch_c(wd_c, spec_c)()
    pms, want = cuda_ms(lambda: wk.forces_plain(wd_c, spec_c, *args, cfg_b),
                        2)
    e = max(compare(a, b, real_b, 2e-3, f"C fast_math compact at N=1e6 {k}")
            for k, (a, b) in enumerate(zip(got, want)))
    ctimes["C"] = (cms, pms, e, ims)
    pa_c, pc_c, _ = pair_counts(wd_c, spec_c, fb["pos_s"], fb["mass_s"],
                                fb["h_s"])
    assert (pa_c, pc_c) == (pa, pc), ((pa_c, pc_c), (pa, pc))
    cst = c_stats(wd_c)
    # the P3M path's shapes (phase 13), kernel C with gravity
    grav_g = (rs_g, cfg_g.grav_eps)
    spec_gc = with_cwidth(spec_g, st_g.pos, dom_g)
    wd_gc = win.build(st_g.pos, dom_g, spec_gc)
    assert torch.equal(wd_gc.g, wd_g.g) and int(wd_gc.overflow) == 0
    gargs = [fg[k].contiguous() for k in C_ARGS]
    ims, cms = turns(launch_c(wd_g, spec_g, cfg_g, gargs, grav_g),
                     launch_c(wd_gc, spec_gc, cfg_g, gargs, grav_g))
    got = launch_c(wd_gc, spec_gc, cfg_g, gargs, grav_g)()
    pms, want = cuda_ms(lambda: wk.forces_plain(wd_gc, spec_gc, *gargs,
                                                cfg_g, grav=grav_g), 1)
    e = max(compare(a, b, wd_gc.is_real, 3e-5, f"C grav compact at N=1e6 {k}")
            for k, (a, b) in enumerate(zip(got, want)))
    ctimes["C grav"] = (cms, pms, e, ims)
    cst_g = c_stats(wd_gc)
    # 2D, the kh path's shapes (phase 18)
    spec2c = with_cwidth(spec2, st_kh.pos, prob_kh.domain)
    wd2c = win.build(st_kh.pos, prob_kh.domain, spec2c)
    assert torch.equal(wd2c.g, wd2.g) and int(wd2c.overflow) == 0
    args = [f2[k] for k in A_ARGS]
    ims, cms = turns(lambda: wk.solve_h_density(wd2, spec2, *args, cfg2,
                                                vel_s=f2["vel_s"]),
                     lambda: wk.solve_h_density(wd2c, spec2c, *args, cfg2,
                                                vel_s=f2["vel_s"]), reps=5)
    got = wk.solve_h_density(wd2c, spec2c, *args, cfg2, vel_s=f2["vel_s"])
    pms, want = cuda_ms(lambda: wk.solve_h_density_plain(
        wd2c, spec2c, *args, cfg2, vel_s=f2["vel_s"]), 1)
    e = max(compare(a, b, real2, 3e-5, f"A2 compact at kh N {k}")
            for k, (a, b) in enumerate(zip(got, want)))
    ctimes["A2"] = (cms, pms, e, ims)
    args = [f2[k] for k in C_ARGS]
    ims, cms = turns(lambda: wk.forces(wd2, spec2, *args, cfg2),
                     lambda: wk.forces(wd2c, spec2c, *args, cfg2))
    got = wk.forces(wd2c, spec2c, *args, cfg2)
    pms, want = cuda_ms(lambda: wk.forces_plain(wd2c, spec2c, *args, cfg2), 1)
    e = max(compare(a, b, real2, 3e-5, f"C2 compact at kh N {k}")
            for k, (a, b) in enumerate(zip(got, want)))
    ctimes["C2"] = (cms, pms, e, ims)
    cst2 = c_stats(wd2c)
    del got, want
    for label, (cms, pms, e, ims) in ctimes.items():
        log(f"[21 times] {label:11s} compact {cms:.3f} ms  in place "
            f"{ims:.3f} ms ({ims / cms:.2f}x)  plain {pms:.1f} ms  max abs "
            f"err {e:.3g}")
    log(f"[21 times] compacted candidates per group (mean, p99, max) and per"
        f" real row: bench {cst}, P3M {cst_g}, kh {cst2}; in-place walked "
        f"per real row: bench {walked:.1f}, P3M {walked_g:.1f}, kh "
        f"{walked2:.1f}; pairs inside the support per real row unchanged "
        f"(A {pa}, C {pc} in all)")

    # one adaptive step with and without the gate's host read: the same
    # 16-step run (bench configuration, adaptive=8) with the gate read, and
    # replaying the decisions it took without reading (nor computing) it
    gate = wengine.drift_gate
    decisions = []

    def reading(*a):
        decisions.append(gate(*a))
        return decisions[-1]

    def adaptive_run(st0):
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        out = wengine.simulate(st0, cfg_b, dom_main, spec_main, 16,
                               adaptive_rebuild=8)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0_) / 16 * 1e3, out[4]

    st_w = wengine.simulate(st_main, cfg_b, dom_main, spec_main, 16)[0]
    with_read, without, builds = [], [], None
    try:
        for r in range(4):
            if r % 2 == 0:
                decisions.clear()
                wengine.drift_gate = reading
                ms, builds = adaptive_run(st_w)
                with_read.append(ms)
            else:
                replay = iter(list(decisions))
                wengine.drift_gate = lambda *a: next(replay)
                without.append(adaptive_run(st_w)[0])
    finally:
        wengine.drift_gate = gate
    gate_ms = (float(np.median(with_read)), float(np.median(without)))
    log(f"[21 times] adaptive=8 step, bench configuration: "
        f"{gate_ms[0]:.3f} ms with the gate's host read, {gate_ms[1]:.3f} "
        f"ms replaying its {len(decisions)} decisions without it "
        f"({gate_ms[0] - gate_ms[1]:.3f} ms a step); {builds} builds in 16 "
        f"steps")

    # ---- 22. kernels A and C on masked tables (the rung path's) ----------
    def energy(st):
        return float((0.5 * st.mass.double()
                      * st.vel.double().pow(2).sum(-1)).sum()
                     + (st.mass.double() * st.u.double()).sum())

    # on the resting lattice the terms of d rho/d h cancel to nearly
    # nothing, so the kernels are held on positions jittered by a seeded
    # 0.2 of a spacing (as in phase 26), with a seeded 0.4 N(0,1) velocity
    # for the Balsara sums and the viscosity (ab_kernels.sedov_inputs); the
    # rung runs below start from the lattice itself. Closing: the ball
    # around the blast centre that holds 10 % of the box's volume
    prob_s, st_j, wd_s, fs, close_s, masks_s = sedov_inputs(dev)
    assert prob_s.engine_name == "window" and prob_s.state.n == 100 ** 3
    st_s, cfg_s, dom_s, spec_s = (prob_s.state, prob_s.cfg, prob_s.domain,
                                  prob_s.wspec)
    e0_s = energy(st_s)
    n_had = int(wk._group_active(win.build(st_s.pos, dom_s, spec_s),
                                 spec_s).sum())
    assert int(wd_s.overflow) == 0
    act_rows = win.gather_sorted(close_s.to(st_s.pos.dtype), wd_s) > 0.5
    wm_s = masks_s["tenth"]
    none_s = rungs.mask_structure(wd_s, spec_s,
                                  torch.zeros_like(act_rows))
    act_g = act_rows.reshape(spec_s.n_groups, spec_s.group).any(1)
    act_t = act_g.reshape(spec_s.n_tiles, spec_s.rgroups).any(1)
    act_r = act_g.repeat_interleave(spec_s.group)
    had = wk._group_active(wd_s, spec_s)
    assert torch.equal(wk._group_active(wm_s, spec_s), act_g & had)
    assert not bool(wk._group_active(none_s, spec_s).any())
    rows_m = act_r & wd_s.is_real
    mask_e = {}
    for dtype in (torch.float32, torch.float64):
        fd = {k: v.to(dtype) for k, v in fs.items()}
        a_args = [fd[k] for k in A_ARGS]
        got = wk.solve_h_density(wm_s, spec_s, *a_args, cfg_s,
                                 vel_s=fd["vel_s"])
        want = wk.solve_h_density_plain(wm_s, spec_s, *a_args, cfg_s,
                                        vel_s=fd["vel_s"])
        torch.cuda.synchronize()
        e_a = max(compare(a, b, rows_m, TOL[dtype],
                          f"masked A {dtype} out{k}")
                  for k, (a, b) in enumerate(zip(got, want)))
        assert torch.equal(got[0][~act_r], fd["h0_s"][~act_r])
        assert not any(bool(o[~act_r].any()) for o in got[1:])
        c_args = [fd[k] for k in C_ARGS]
        got = wk.forces(wm_s, spec_s, *c_args, cfg_s)
        want = wk.forces_plain(wm_s, spec_s, *c_args, cfg_s)
        torch.cuda.synchronize()
        e_c = max(compare(a, b, rows_m, TOL[dtype],
                          f"masked C {dtype} out{k}")
                  for k, (a, b) in enumerate(zip(got, want)))
        assert not bool(got[0][~act_r].any() | got[1][~act_r].any())
        mask_e[dtype] = (e_a, e_c)
        log(f"[22 masked parity] {str(dtype):13s} N={st_s.n} "
            f"wseg={spec_s.wseg}: A max abs err {e_a:.3g}, max err/scale "
            f"{worst(f'masked A {dtype}'):.3g}; C {e_c:.3g}, "
            f"{worst(f'masked C {dtype}'):.3g} (tol {TOL[dtype]}); masked "
            f"groups: h == h0, every other output 0")
    del fd, got, want
    a_args = [fs[k] for k in A_ARGS]
    c_args = [fs[k] for k in C_ARGS]
    mtimes = {}
    for label, w in (("all", wd_s), ("masked", wm_s), ("none", none_s),
                     ("4 groups", masks_s["4 groups"])):
        a_t = cuda_ms(lambda: wk.solve_h_density(
            w, spec_s, *a_args, cfg_s, vel_s=fs["vel_s"]), 5)[0]
        c_t = cuda_ms(lambda: wk.forces(w, spec_s, *c_args, cfg_s), 5)[0]
        mtimes[label] = (a_t, c_t)
    mp_a = cuda_ms(lambda: wk.solve_h_density_plain(
        wm_s, spec_s, *a_args, cfg_s, vel_s=fs["vel_s"]), 1)[0]
    mp_c = cuda_ms(lambda: wk.forces_plain(wm_s, spec_s, *c_args, cfg_s),
                   1)[0]
    pa_m, pc_m, _ = pair_counts(wm_s, spec_s, fs["pos_s"], fs["mass_s"],
                                fs["h_s"])
    pa_s, pc_s, _ = pair_counts(wd_s, spec_s, fs["pos_s"], fs["mass_s"],
                                fs["h_s"])
    bounds["A masked"] = kernel_bound("A", spec_s, fs["pos_s"], pa_m,
                                      iters=cfg_s.newton_iters, bals=True,
                                      masked=wm_s)
    bounds["C masked"] = kernel_bound("C", spec_s, fs["pos_s"], pc_m,
                                      bf=True, masked=wm_s)
    bounds["A sedov"] = kernel_bound("A", spec_s, fs["pos_s"], pa_s,
                                     iters=cfg_s.newton_iters, bals=True)
    bounds["C sedov"] = kernel_bound("C", spec_s, fs["pos_s"], pc_s, bf=True)
    walked_s, _ = candidate_rows(wd_s, spec_s)
    share = (int((act_g & had).sum()) / int(had.sum()),
             int(act_t.sum()) / spec_s.n_tiles)
    log(f"[22 masked parity] closing {int(close_s.sum())} of {st_s.n} "
        f"particles; active groups {int((act_g & had).sum())} of "
        f"{int(had.sum())} with candidates ({spec_s.n_groups} in all), "
        f"tiles {int(act_t.sum())} of {spec_s.n_tiles}; sorted rows that "
        f"an active group reads {rows_needed(wm_s, spec_s)} of "
        f"{spec_s.n_sorted}; candidate rows per "
        f"real row {walked_s:.1f}; A cold ({cfg_s.newton_iters} Newton "
        f"updates) all / masked / none: "
        + " / ".join(f"{mtimes[k][0]:.3f}" for k in ("all", "masked", "none"))
        + f" ms, 4 groups {mtimes['4 groups'][0]:.3f} ms (plain masked "
        f"{mp_a:.1f} ms, bound "
        f"{bounds['A masked'][0]:.4f} ms masked, {bounds['A sedov'][0]:.4f} "
        f"all); C exact: "
        + " / ".join(f"{mtimes[k][1]:.3f}" for k in ("all", "masked", "none"))
        + f" ms, 4 groups {mtimes['4 groups'][1]:.3f} ms (plain masked "
        f"{mp_c:.1f} ms, bound "
        f"{bounds['C masked'][0]:.4f} ms masked, {bounds['C sedov'][0]:.4f} "
        f"all)")

    # ---- 23. B = 1 equals the global-dt loop, on the card ----------------
    st_g1, _, dts_g1, ovf_g1 = wengine.simulate(st_s, cfg_s, dom_s, spec_s,
                                                2, rebuild_every=1)
    st_r1, dts_r1, nact1, ovf_r1, viol1, builds1 = drive(
        "rungs B=1", lambda: rungs.simulate_rungs(
            st_s, cfg_s, dom_s, spec_s, nspans=2, n_rungs=1,
            rebuild_every=1),
        {"solve_h_density": 3, "forces": 2})
    assert int(ovf_g1) == 0 and int(ovf_r1) == 0 and int(viol1) == 0
    assert builds1 == 2 and bool((nact1 == st_s.n).all())
    torch.testing.assert_close(dts_r1, dts_g1, rtol=1e-6, atol=0.0)
    b1_err = {}
    for k in ("pos", "vel", "u", "rho", "h"):
        a, b = getattr(st_r1, k), getattr(st_g1, k)
        torch.testing.assert_close(a, b, rtol=5e-5, atol=1e-6, msg=k)
        b1_err[k] = float((a - b).abs().max())
    log(f"[23 B=1] simulate_rungs(n_rungs=1) vs wengine.simulate, N="
        f"{st_s.n}, 2 steps: dts equal at 1e-6, max abs differences "
        f"{b1_err} (rtol 5e-5, atol 1e-6)")

    # ---- 24. the rung path at full width, through the CLI ----------------
    rung_recs = {}
    masks = {}          # per CLI run and tick: groups active, before masking
    real_mask = rungs.mask_structure

    def counted_mask(wd, spec, act_s):
        out = real_mask(wd, spec, act_s)
        masks[label].append((wk._group_active(out, spec).sum(),
                             wk._group_active(wd, spec).sum()))
        return out

    for label, extra_args in (("rungs=4 CLI", []),
                              ("rungs=4 adaptive=8 CLI", ["adaptive=8"])):
        out = fresh(os.path.join("build", "smoke", label.replace(" ", "_")))
        masks[label] = []
        t0 = time.perf_counter()
        # the set-up's derived pass, the seeding pass of kernel A, then A
        # and C once per tick
        rungs.mask_structure = counted_mask
        try:
            st_c, t_c, step_c = drive(label, lambda: cli(
                ["sedov", "n=100", "rungs=4", "max_steps=16", "chunk=16",
                 f"out={out}"] + extra_args),
                {"solve_h_density": 18, "forces": 17})
        finally:
            rungs.mask_structure = real_mask
        wall_c = time.perf_counter() - t0
        masks[label] = [(int(a), int(b)) for a, b in masks[label]]
        assert len(masks[label]) == 16, masks[label]
        recs = records(out)
        assert step_c == 16 and [r["step"] for r in recs] == [16, 16], recs
        r0 = recs[0]
        assert all(r["finite"] for r in recs) and r0["h_capped"] == 0, recs
        for f_ in ("pos", "vel", "h", "rho", "u", "acc", "du_dt"):
            assert bool(torch.isfinite(getattr(st_c, f_)).all()), f_
        closings = r0["active_frac"] * st_c.n * 16
        assert r0["dt_viol"] < 0.05 * closings, r0
        assert r0["active_frac"] < 0.5, r0
        if extra_args:
            assert 1 <= r0["rebuilds"] < 8, r0
        drift = abs(energy(st_c) - e0_s) / e0_s
        rung_recs[label] = dict(r0, energy_drift=drift, t=t_c)
        log(f"[24 {label}] N={st_c.n}: 16 ticks to t={t_c:.4g} in "
            f"{wall_c:.2f} s with set-up; overflow 0, h_capped 0, "
            f"active_frac {r0['active_frac']:.4f}, dt_viol {r0['dt_viol']} "
            f"of {closings:.0f} closings, rebuilds {r0.get('rebuilds')}, "
            f"energy drift {drift:.3g}, CLI record "
            f"{r0['particle_steps_per_sec']:.4g} particle-ticks/s")

    # the same 16 ticks three ways, in turns; the host clock around a run
    # that ends in a synchronise; builds counted by window.BUILDS, which
    # the graphed build of the global-dt loop counts too
    built = []

    def clocked(fn):
        n0 = win.BUILDS["n"]
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        built.append(win.BUILDS["n"] - n0)
        return (time.perf_counter() - t0_) / 16 * 1e3, out

    ways = {
        "rungs": lambda: rungs.simulate_rungs(st_s, cfg_s, dom_s, spec_s,
                                              nspans=2, n_rungs=4),
        "rungs adaptive=8": lambda: rungs.simulate_rungs(
            st_s, cfg_s, dom_s, spec_s, nspans=2, n_rungs=4,
            adaptive_rebuild=8),
        "global dt": lambda: wengine.simulate(st_s, cfg_s, dom_s, spec_s,
                                              16),
    }
    # the global-dt loop captures its graphed build at its first run:
    # once, untimed
    ways["global dt"]()
    tick_ms = {k: [] for k in ways}
    outs, builds = {}, {}       # builds: window builds in the run
    for k in ("rungs", "rungs adaptive=8", "global dt", "global dt",
              "rungs adaptive=8", "rungs"):
        ms, outs[k] = clocked(ways[k])
        tick_ms[k].append(ms)
        builds[k] = built[-1]
    _, dts_r, nact_r, ovf_r, viol_r, builds_r = outs["rungs"]
    _, dts_a, nact_a, ovf_a, viol_a, builds_a = outs["rungs adaptive=8"]
    st_gd, _, dts_gd, ovf_gd = outs["global dt"]
    assert int(ovf_r) == int(ovf_a) == int(ovf_gd) == 0
    # a rung run builds once more than it reports, for the pass that seeds
    # the viscosity factor
    assert (builds["rungs"], builds["rungs adaptive=8"]) == (
        builds_r + 1, builds_a + 1), builds
    assert builds["global dt"] == 8, builds     # one every 2 steps
    assert torch.equal(nact_a, nact_r), (nact_a, nact_r)
    fracs = (nact_r.double() / st_s.n).tolist()
    rung_ms = {k: float(np.median(v)) for k, v in tick_ms.items()}
    log(f"[24 ticks] {card} | sedov N={st_s.n}, B=4, 16 ticks, ms per tick "
        f"(two runs each, in turns): "
        + "; ".join(f"{k} {v[0]:.2f}, {v[1]:.2f}" for k, v in
                    tick_ms.items())
        + f"; builds: rungs {builds_r}, adaptive {builds_a}, global dt "
        f"{builds['global dt']}; "
        f"simulated time: rungs {float(dts_r.sum()):.5g}, global dt "
        f"{float(dts_gd.sum()):.5g}; dt_viol {int(viol_r)}; active fraction "
        f"per tick " + " ".join(f"{x:.4f}" for x in fracs)
        + f" (mean {sum(fracs) / 16:.4f}); global-dt energy drift "
        f"{abs(energy(st_gd) - e0_s) / e0_s:.3g}")

    # one more rung run with CUDA events around every launch of A and C,
    # and the groups each launch found active
    launches = []
    real_a, real_c = wk.solve_h_density, wk.forces

    def timed(fn, name):
        def inner(wd, spec, *a, **k):
            e0_, e1_ = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            e0_.record()
            out = fn(wd, spec, *a, **k)
            e1_.record()
            launches.append((name, wk._group_active(wd, spec).sum(), e0_,
                             e1_))
            return out
        return inner

    wk.solve_h_density, wk.forces = timed(real_a, "A"), timed(real_c, "C")
    try:
        ways["rungs"]()
        torch.cuda.synchronize()
    finally:
        wk.solve_h_density, wk.forces = real_a, real_c
    per_tick = {"A": [], "C": []}
    for which, groups, e0_, e1_ in launches[1:]:    # [0]: the seeding pass
        per_tick[which].append((int(groups), e0_.elapsed_time(e1_)))
    assert len(per_tick["A"]) == len(per_tick["C"]) == 16
    kern_ms = {k: sum(ms for _, ms in v) / 16 for k, v in per_tick.items()}
    grp_share = sum(g for g, _ in per_tick["A"]) / (16 * n_had)
    log(f"[24 kernels] per tick, active groups of {n_had} with candidates "
        f"and ms: A " + " ".join(f"{g}:{ms:.3f}" for g, ms in per_tick["A"])
        + "; C " + " ".join(f"{g}:{ms:.3f}" for g, ms in per_tick["C"])
        + f"; mean per tick A {kern_ms['A']:.3f} ms, C {kern_ms['C']:.3f} "
        f"ms at a mean active-group share of {grp_share:.4f}")

    # where a rung run's device time goes: the profiler's kernel times by
    # kind; the idle share is taken against the unprofiled wall above
    dev_ms = device_ms_by_kind(ways["rungs"], 16)
    busy = sum(dev_ms.values())
    log(f"[24 profile] device ms per tick by kind (16 ticks, profiler): "
        + ", ".join(f"{k} {v:.3f}" for k, v in dev_ms.items())
        + f"; busy {busy:.2f} of {rung_ms['rungs']:.2f} ms a tick unprofiled "
        f"(idle share {1 - busy / rung_ms['rungs']:.3f})")

    # ---- 25. the Sedov shock-radius gate on the window engine (fp64) -----
    def sedov_gate(n_rungs):
        prob = problems.sedov(n=14, dtype=torch.float64)
        assert prob.engine_name == "window"
        st, t, n = prob.state, 0.0, 0
        e0 = energy(st)
        if n_rungs == 1:
            st, _, t, n = run_mod.simulate_until(
                st, prob.cfg, prob.domain, prob.engine, t_end=0.06,
                chunk=32, max_steps=3000)
        fracs = [1.0]
        while n_rungs > 1 and t < 0.06 and n < 6000:
            st, dts, ovf, _, frac, _ = rung_chunk(prob, st, n_rungs, 32)
            assert int(ovf) == 0
            t, n = t + float(dts.sum()), n + len(dts)
            fracs.append(frac)
        assert bool(torch.isfinite(st.rho).all())
        ic = dict(E=1.0, rho0=1.0)
        r_meas = sedov_diag.measured_shock_radius(
            st.pos.cpu().numpy(), st.rho.cpu().numpy(),
            np.array([0.5, 0.5, 0.5]), ic["rho0"])
        r_th = sedov_diag.shock_radius(t, ic["E"], ic["rho0"],
                                       prob.cfg.gamma)
        return (prob, n, t, r_meas, r_th, abs(energy(st) - e0) / e0,
                min(fracs))

    gate_s = {}
    for n_rungs, e_tol in ((1, 2e-2), (3, 4e-2)):
        t0 = time.perf_counter()
        prob25, n25, t25, r_meas, r_th, de, frac25 = drive(
            "sedov gate " + (f"rungs={n_rungs}" if n_rungs > 1
                             else "global dt"),
            lambda: sedov_gate(n_rungs),
            lambda out: ({"solve_h_density": 1 + out[1],
                          "forces": 1 + out[1]} if n_rungs == 1 else
                         {"solve_h_density": 1 + out[1] + out[1] // 32,
                          "forces": 1 + out[1]}))
        wall25 = time.perf_counter() - t0
        assert abs(r_meas - r_th) / r_th < 0.25, (r_meas, r_th, t25)
        assert de < e_tol, de
        # tests/unit/test_rungs.py:66's nact.min() < n: no tick closes more
        # than N particles, so a chunk's mean active fraction below 1 means
        # some tick of it closed fewer
        assert n_rungs == 1 or frac25 < 1.0, frac25
        gate_s[n_rungs] = dict(steps=n25, t=t25, r_meas=r_meas, r_th=r_th,
                               energy_drift=de, wall_s=wall25,
                               min_chunk_active_frac=frac25)
        log(f"[25 Sedov gate] rungs={n_rungs} N={prob25.state.n} fp64 "
            f"window engine: {n25} ticks to t={t25:.4f} in {wall25:.2f} s; "
            f"shock radius {r_meas:.4f} vs R(t) {r_th:.4f} "
            f"({abs(r_meas - r_th) / r_th:.3f} < 0.25); energy drift "
            f"{de:.3g} (< {e_tol})" + (
                f"; least active fraction of a chunk {frac25:.4f} (< 1: "
                "some tick closed fewer than N)" if n_rungs > 1 else ""))

    # ---- 26. dim=1: a periodic line of 2^20 particles --------------------
    st1, cfg1, dom1, spec1 = line_inputs(dev)
    n1 = st1.n
    spec1c = with_cwidth(spec1, st1.pos, dom1)
    assert spec1.n_seg == 1
    line = {}
    for tag, sp in (("", spec1), ("_compact", spec1c)):
        keys = {f"solve_h_density{tag}_1d": 1, f"forces{tag}_1d": 1}
        st1d = drive(f"1d derived{tag}", lambda: wengine.update_derived(
            st1, cfg1, dom1, sp), keys)
        t0 = time.perf_counter()
        st1s, _, dts1, ovf1 = drive(
            f"1d simulate{tag}", lambda: wengine.simulate(
                st1d, cfg1, dom1, sp, 4), {k: 4 for k in keys})
        wall1 = (time.perf_counter() - t0) / 4
        assert int(ovf1) == 0 and bool((dts1 > 0).all())
        for f_ in ("pos", "vel", "h", "rho", "u", "acc", "du_dt"):
            assert bool(torch.isfinite(getattr(st1s, f_)).all()), f_
        assert int(wengine.capped_count(st1s, sp)) == 0
        line[tag] = (st1d, wall1 * 1e3)
    wd1 = win.build(st1.pos, dom1, spec1)
    wd1c = win.build(st1.pos, dom1, spec1c)
    assert torch.equal(wd1c.g, wd1.g) and int(wd1c.overflow) == 0
    f1 = sorted_fields(line[""][0], wd1)
    times1 = {}
    for tag, w, sp in (("", wd1, spec1), ("_compact", wd1c, spec1c)):
        for dtype in (torch.float32, torch.float64):
            fd = {k: v.to(dtype) for k, v in f1.items()}
            a_args = [fd[k] for k in A_ARGS]
            c_args = [fd[k] for k in C_ARGS]
            reps = 10 if dtype == torch.float32 else 1
            a_ms1, got = cuda_ms(lambda: wk.solve_h_density(
                w, sp, *a_args, cfg1, vel_s=fd["vel_s"]), reps)
            a_pms1, want = cuda_ms(lambda: wk.solve_h_density_plain(
                w, sp, *a_args, cfg1, vel_s=fd["vel_s"]), 1)
            e_a = max(compare(a, b, w.is_real, TOL[dtype],
                              f"A1{tag} {dtype} out{k}")
                      for k, (a, b) in enumerate(zip(got, want)))
            assert not bool(got[4][w.is_real].any())
            c_ms1, got = cuda_ms(lambda: wk.forces(w, sp, *c_args, cfg1),
                                 reps)
            c_pms1, want = cuda_ms(lambda: wk.forces_plain(
                w, sp, *c_args, cfg1), 1)
            e_c = max(compare(a, b, w.is_real, TOL[dtype],
                              f"C1{tag} {dtype} out{k}")
                      for k, (a, b) in enumerate(zip(got, want)))
            log(f"[26 dim=1] {'compact ' if tag else 'in place'} "
                f"{str(dtype):13s}: A cold kernel {a_ms1:.3f} ms plain "
                f"{a_pms1:.1f} ms max abs err {e_a:.3g}, max err/scale "
                f"{worst(f'A1{tag} {dtype}'):.3g}; C exact kernel "
                f"{c_ms1:.3f} ms plain {c_pms1:.1f} ms max abs err "
                f"{e_c:.3g}, {worst(f'C1{tag} {dtype}'):.3g} (tol "
                f"{TOL[dtype]})")
            if dtype == torch.float32:
                times1[tag] = dict(A=(a_ms1, a_pms1, e_a),
                                   C=(c_ms1, c_pms1, e_c))
    del fd, got, want
    walked1, computed1 = candidate_rows(wd1, spec1)
    pa1, pc1, _ = pair_counts(wd1, spec1, f1["pos_s"], f1["mass_s"],
                              f1["h_s"])
    bounds["A1"] = kernel_bound("A", spec1, f1["pos_s"], pa1,
                                iters=cfg1.newton_iters, bals=True)
    bounds["C1"] = kernel_bound("C", spec1, f1["pos_s"], pc1, bf=True)
    cst1 = c_stats(wd1c)
    log(f"[26 dim=1] {card} | N={n1} wseg={spec1.wseg} group={spec1.group} "
        f"cwidth={spec1c.cwidth}: {line[''][1]:.2f} ms a step in place, "
        f"{line['_compact'][1]:.2f} ms compact (4 steps each); candidate "
        f"rows per real row walked {walked1:.1f}, compacted {cst1[3]:.1f}; pairs inside the "
        f"support per real row A {pa1 / n1:.2f}, C {pc1 / n1:.2f}; bounds A "
        f"{bounds['A1'][0]:.4f} ms ({bounds['A1'][1]}), C "
        f"{bounds['C1'][0]:.4f} ms ({bounds['C1'][1]})")

    # ---- 27. the cull: survivors per row, and parity off the lattice -----
    def survivors(wd, spec, f, h_key="h_s", rcut=None):
        """(candidate rows, survivors) per real row of kernel A's and of
        kernel C's cull (``rcut``: C's gravity mode)."""
        a = wk.cull_stats(wd, spec, f["pos_s"], f["mass_s"], f[h_key])
        c = wk.cull_stats(wd, spec, f["pos_s"], f["mass_s"], f["h_s"],
                          pair_h=True, rcut=rcut)
        return {"candidates": a[0], "A": a[1], "C": c[1]}

    n_b, n_s = int(real_b.sum()), int(wd_s.is_real.sum())
    surv = {
        "bench": survivors(wd_b, spec_main, fb, "h0_s"),
        "bench compact": survivors(wd_c, spec_c, fb, "h0_s"),
        "P3M grav": survivors(wd_g, spec_g, fg, rcut=spec_g.cutoff),
        "P3M grav compact": survivors(wd_gc, spec_gc, fg,
                                      rcut=spec_gc.cutoff),
        "kh": survivors(wd2, spec2, f2, "h0_s"),
        "kh compact": survivors(wd2c, spec2c, f2, "h0_s"),
        "sedov": survivors(wd_s, spec_s, fs, "h0_s"),
        "1d": survivors(wd1, spec1, f1, "h0_s"),
        "1d compact": survivors(wd1c, spec1c, f1, "h0_s"),
    }
    inside = {"bench": (pa / n_b, pc / n_b), "bench compact": (pa / n_b,
                                                               pc / n_b),
              "P3M grav": (None, pg_g / st_g.n),
              "P3M grav compact": (None, pg_g / st_g.n),
              "kh": (pa2 / n_real2, pc2 / n_real2),
              "kh compact": (pa2 / n_real2, pc2 / n_real2),
              "sedov": (pa_s / n_s, pc_s / n_s),
              "1d": (pa1 / n1, pc1 / n1), "1d compact": (pa1 / n1, pc1 / n1)}
    for k, v in surv.items():
        v["inside_A"], v["inside_C"] = inside[k]
        log(f"[27 cull] {k:17s} per real row: {v['candidates']:.1f} "
            f"candidates, the warp's cull keeps {v['A']:.1f} (A) and "
            f"{v['C']:.1f} (C); pairs inside the support "
            + (f"{v['inside_A']:.1f} (A), " if v["inside_A"] else "")
            + f"{v['inside_C']:.1f} (C"
            + (", inside the cutoff)" if "grav" in k else ")"))
        assert v["A"] <= v["candidates"] and v["C"] <= v["candidates"]
        assert v["C"] >= v["inside_C"] * 0.999, v
    walks = walk_fill(dev)

    def parity(tag, wd, spec, f, cfg, rows, dtype, grav=None):
        """Kernels A and C against plain on ``rows``; the largest absolute
        errors."""
        fd = {k: v.to(dtype) for k, v in f.items()}
        a_args = [fd[k] for k in A_ARGS]
        got = wk.solve_h_density(wd, spec, *a_args, cfg, vel_s=fd["vel_s"])
        want = wk.solve_h_density_plain(wd, spec, *a_args, cfg,
                                        vel_s=fd["vel_s"])
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(o).all()) for o in got), tag
        e_a = max(compare(a, b, rows, TOL[dtype], f"{tag} A {dtype} out{k}")
                  for k, (a, b) in enumerate(zip(got, want)))
        c_args = [fd[k] for k in C_ARGS]
        got = wk.forces(wd, spec, *c_args, cfg, grav=grav)
        want = wk.forces_plain(wd, spec, *c_args, cfg, grav=grav)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(o).all()) for o in got), tag
        e_c = max(compare(a, b, rows, TOL[dtype], f"{tag} C {dtype} out{k}")
                  for k, (a, b) in enumerate(zip(got, want)))
        log(f"[27 {tag}] {str(dtype):13s}: A max abs err {e_a:.3g}, max "
            f"err/scale {worst(f'{tag} A {dtype}'):.3g}; C {e_c:.3g}, "
            f"{worst(f'{tag} C {dtype}'):.3g} (tol {TOL[dtype]})")
        return e_a, e_c

    # a clustered state: half the particles on a jittered lattice, half
    # drawn toward 4 centres (sigma 0.02), h from the local density (a 64^3
    # histogram) so that it varies about 10x, also inside one warp at a
    # cluster's edge; a cluster's cells hold thousands of rows, so a warp's
    # buffer fills and is walked many times within one walk
    gen_c = torch.Generator(device=dev).manual_seed(11)
    n_lat = 32
    lat = torch.as_tensor(lattice.cubic_lattice((n_lat,) * 3, [0.0] * 3,
                                                [1.0] * 3),
                          dtype=torch.float32, device=dev)
    lat = (lat + (0.3 / n_lat) * (2.0 * torch.rand(
        lat.shape, generator=gen_c, device=dev) - 1.0)) % 1.0
    centres = torch.tensor([[0.3, 0.3, 0.35], [0.7, 0.35, 0.6],
                            [0.4, 0.7, 0.65], [0.65, 0.68, 0.3]], device=dev)
    blob = (centres[torch.randint(4, (lat.shape[0],), generator=gen_c,
                                  device=dev)]
            + 0.02 * torch.randn(lat.shape, generator=gen_c, device=dev))
    pos_c = torch.cat([lat, blob.clamp(0.05, 0.95)])
    n_c = pos_c.shape[0]
    bins = (pos_c * 64).long().clamp(0, 63)
    flat = (bins[:, 0] * 64 + bins[:, 1]) * 64 + bins[:, 2]
    count = torch.bincount(flat, minlength=64 ** 3)[flat].float()
    h_lat = 1.3 / n_lat
    h_c = (1.3 * (count * 64 ** 3) ** (-1.0 / 3.0)).clamp(h_lat / 12, h_lat)
    st_c = make_state(pos_c, torch.zeros_like(pos_c),
                      torch.full((n_c,), 1.0 / n_c, device=dev),
                      torch.ones(n_c, device=dev), h_c)
    dom_c = box(torch.zeros(3, device=dev), torch.ones(3, device=dev))
    cfg_c = dataclasses.replace(configs.TURB, newton_iters=2)
    off_lattice = {}
    for compact in (False, True):
        plan = win.plan_compact if compact else win.plan_measured
        spec_k = plan(st_c.pos, dom_c, h_max=h_lat * 1.05, dim=3, **knobs)
        wd_k = win.build(st_c.pos, dom_c, spec_k)
        assert int(wd_k.overflow) == 0
        f_k = seeded_fields(st_c, wd_k, seed=12)
        hs = f_k["h_s"][wd_k.is_real].reshape(-1)
        warp_h = f_k["h0_s"].reshape(-1, 32)
        warp_m = f_k["mass_s"].reshape(-1, 32) > 0
        ratio = (torch.where(warp_m, warp_h, 0.0).amax(1)
                 / torch.where(warp_m, warp_h, 9.0).amin(1))
        st_k = survivors(wd_k, spec_k, f_k, "h0_s")
        tag = "clustered compact" if compact else "clustered"
        log(f"[27 {tag}] N={n_c} wseg={spec_k.wseg} cwidth={spec_k.cwidth}:"
            f" h from {float(hs.min()):.4g} to {float(hs.max()):.4g}, up "
            f"to {float(ratio[warp_m.any(1)].max()):.1f}x inside one warp; "
            f"{st_k['candidates']:.0f} candidates and {st_k['A']:.0f} (A), "
            f"{st_k['C']:.0f} (C) survivors per real row (a warp stages "
            f"{wk.pair_cap(torch.float32)} at a time in A's 3D pair walk "
            f"and 96 in C in fp32, half that in fp64)")
        assert st_k["A"] > 256, st_k     # several flushes a walk
        assert float(ratio[warp_m.any(1)].max()) > 3.0
        for dtype in (torch.float32, torch.float64):
            off_lattice[(tag, dtype)] = parity(tag, wd_k, spec_k, f_k, cfg_c,
                                               wd_k.is_real, dtype)
    del lat, blob, pos_c, bins, flat, count, f_k, wd_k

    # the boundary between rows with and without mass: an open box, so the
    # sort ends on real rows, and N = 45^3 is no multiple of 32, so the
    # last warp with real rows also holds pad rows (position 0, h = 1)
    ic = turbulence.build(n_side=45)
    st_e = make_state(*(torch.as_tensor(ic[k], dtype=torch.float32,
                                        device=dev)
                        for k in ("pos", "vel", "mass", "u", "h")))
    dom_e = box(torch.zeros(3, device=dev), torch.ones(3, device=dev),
                periodic=False)
    for compact in (False, True):
        plan = win.plan_compact if compact else win.plan_measured
        spec_e = plan(st_e.pos, dom_e, h_max=float(st_e.h.max()) * 1.05,
                      dim=3, **knobs)
        wd_e = win.build(st_e.pos, dom_e, spec_e)
        f_e = seeded_fields(st_e, wd_e, seed=13)
        warp_m = (f_e["mass_s"] > 0).reshape(-1, 32)
        mixed = warp_m.any(1) & ~warp_m.all(1)
        assert int(mixed.sum()) == 1 and int(wd_e.overflow) == 0
        edge = mixed.repeat_interleave(32) & wd_e.is_real
        assert bool(edge.any())
        tag = "edge warp compact" if compact else "edge warp"
        for dtype in (torch.float32, torch.float64):
            off_lattice[(tag, dtype)] = parity(tag, wd_e, spec_e, f_e, cfg_c,
                                               wd_e.is_real, dtype)
            # and on the mixed warp's own real rows alone
            parity(tag + " rows", wd_e, spec_e, f_e, cfg_c, edge, dtype)

    # ---- 28. the derived pass on the card against reference_cpu ----------
    # fp64 at 1e-8: both sides converge h in 10 Newton updates, and what is
    # left is summation order. fp32: h, rho, P and Omega are sums of 20 to
    # 70 positive terms and a converged Newton root, each rounded at 6e-8,
    # held at 1e-5; acc and du/dt are sums of signed pair terms several
    # times larger than the result, held at 3e-5 of the largest value.
    REF_TOL = {torch.float64: (1e-8, 1e-8), torch.float32: (1e-5, 3e-5)}
    ref_err = {}
    for dim_, n_side_ in ((3, 13), (2, 44)):
        rng = np.random.default_rng(3)
        ax = (np.arange(n_side_) + 0.5) / n_side_
        pos_r = np.stack([g_.ravel() for g_ in np.meshgrid(
            *([ax] * dim_), indexing="ij")], axis=-1)
        pos_r = np.mod(pos_r + 0.2 / n_side_
                       * rng.standard_normal(pos_r.shape), 1.0)
        n_r = len(pos_r)
        vel_r = 0.3 * rng.standard_normal((n_r, dim_))
        mass_r = np.full(n_r, 1.0 / n_r)
        u_r = 1.0 + 0.5 * rng.random(n_r)
        h_r = np.full(n_r, 1.3 / n_side_)
        cfg_r = configs.SPHConfig(dim=dim_, adaptive_h=True, grad_h=True,
                                  balsara=True, newton_iters=10)
        t0 = time.perf_counter()
        der = reference_cpu.update_derived(pos_r, vel_r, mass_r, u_r, h_r,
                                           cfg_r, box=np.ones(dim_))
        ref_s = time.perf_counter() - t0
        for dtype in (torch.float64, torch.float32):
            st_r = make_state(*(torch.as_tensor(a, dtype=dtype, device=dev)
                                for a in (pos_r, vel_r, mass_r, u_r, h_r)))
            dom_r = box(torch.zeros(dim_, dtype=dtype, device=dev),
                        torch.ones(dim_, dtype=dtype, device=dev))
            for compact in (False, True):
                plan = win.plan_compact if compact else win.plan_measured
                spec_r = plan(st_r.pos, dom_r, h_max=float(h_r.max()) * 1.25,
                              dim=dim_, **KH_KNOBS)
                tag = f"{dim_}D{' compact' if compact else ''}"
                keys = {_key("solve_h_density", compact, dim_): 1,
                        _key("forces", compact, dim_): 1}
                out = drive(f"reference {tag} {dtype}",
                            lambda: wengine.update_derived(
                                st_r, cfg_r, dom_r, spec_r), keys)
                assert int(wengine.capped_count(out, spec_r)) == 0
                every = torch.ones(n_r, dtype=torch.bool, device=dev)
                tol_s, tol_v = REF_TOL[dtype]
                errs_r = {}
                for k in ("h", "rho", "P", "omega", "acc", "du_dt"):
                    want = torch.as_tensor(der[k], dtype=torch.float64,
                                           device=dev)
                    name_ = f"reference {tag} {dtype} {k}"
                    if k in ("acc", "du_dt"):
                        compare(getattr(out, k), want, every, tol_v, name_)
                    else:
                        torch.testing.assert_close(
                            getattr(out, k).double(), want, rtol=tol_s,
                            atol=0.0, msg=name_)
                        errs[name_] = float(((getattr(out, k).double()
                                              - want).abs() / want.abs())
                                            .max())
                    errs_r[k] = errs[name_]
                ref_err[f"{tag} {dtype}"] = errs_r
                log(f"[28 reference_cpu] {tag:10s} {str(dtype):13s} N={n_r}"
                    f" (reference {ref_s:.1f} s on the host): largest "
                    f"relative error "
                    + ", ".join(f"{k} {v:.2g}" for k, v in errs_r.items())
                    + f" (h, rho, P, omega at {tol_s}; acc, du_dt at "
                    f"{tol_v} of the largest value)")


    # ---- 29. where a step's device time goes ----------------------------
    def step_profile(tag, run):
        run()                                   # warm
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0_) / 16 * 1e3
        ms = device_ms_by_kind(run, 16)
        busy_ = sum(ms.values())
        log(f"[29 profile] {tag}: device ms per step by kind (16 steps, "
            "profiler): " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
            + f"; busy {busy_:.2f} of {wall_ms:.2f} ms a step unprofiled "
            f"(idle share {1 - busy_ / wall_ms:.3f})")
        return dict(ms, busy=busy_, wall_ms=wall_ms)

    where = {
        "bench": step_profile("bench in place", lambda: wengine.simulate(
            st_main, cfg_b, dom_main, spec_main, 16)),
        "bench compact": step_profile(
            "bench compact", lambda: wengine.simulate(
                st_main, cfg_b, dom_main, spec_c, 16)),
        "kh": step_profile("kh n=1024", lambda: wengine.simulate(
            st_ck, prob_kh.cfg, prob_kh.domain, prob_kh.wspec, 16)),
    }

    # ---- 30. the slab decomposition in lockstep (fp64, 4 ranks) ----------
    from sphax_torch import convert
    from sphax_torch.dist import comm as dist_comm
    from sphax_torch.dist import wslab

    torch.cuda.empty_cache()
    SLAB_CFGS = _slab_cfgs()
    ic = turbulence.build(n_side=32)
    lock_ops = [("step",)] * 3 + [("chunk", 4, 2, 0), ("rebalance",),
                                  ("migrate",)]
    slab_lock = {}
    for tag, cfg_l in SLAB_CFGS.items():
        st = make_state(*(torch.as_tensor(ic[k], dtype=torch.float64,
                                          device=dev)
                          for k in ("pos", "vel", "mass", "u", "h")))
        gen = torch.Generator(device=dev).manual_seed(30)
        st = st._replace(vel=0.3 * torch.randn(st.vel.shape, generator=gen,
                                               dtype=torch.float64,
                                               device=dev))
        dom = box(torch.zeros(3, dtype=torch.float64, device=dev),
                  torch.ones(3, dtype=torch.float64, device=dev))
        spec1 = win.plan_measured(st.pos, dom,
                                  h_max=float(st.h.max()) * 1.1, dim=3,
                                  fast_sub=3, rgroups=2)
        st0 = wengine.update_derived(st, cfg_l, dom, spec1)
        ref3, _, dts3, o3 = wengine.simulate(st0, cfg_l, dom, spec1, 3,
                                             rebuild_every=1)
        ref7, _, dts7, o7 = wengine.simulate(ref3, cfg_l, dom, spec1, 4,
                                             rebuild_every=1)
        assert int(o3) == 0 and int(o7) == 0
        # a rebalance moves a cut by whole cells of the coarse slab grid
        # (about 3,600 particles): shards and send buffers that hold it
        spec = wslab.plan(dom, st0.n, float(st0.h.max()) * 1.1, 4,
                          fast_sub=3, rgroups=2, pad_factor=2.0,
                          migrate_frac=1.0)
        cuts = wslab.equal_cuts(spec.ncell_ax, 4)
        sh = [convert.state_to_numpy(wslab.distribute(st0, dom, spec, cuts,
                                                      r)) for r in range(4)]
        rows = {k: np.concatenate([x[k] for x in sh]) for k in sh[0]}
        t0 = time.perf_counter()
        recs, kerr = dist_comm.launch(
            slab_lockstep_rank, 4, dev, "gloo", timeout=300, deadline=900,
            args=(rows, (np.zeros(3), np.ones(3), True), cfg_l, spec, cuts,
                  lock_ops, tag == "turb"))
        wall = time.perf_counter() - t0
        errs_l = {}
        for rec, ref, dts_ref, n_dts in ((recs[2], ref3, dts3, 3),
                                         (recs[-1], ref7, dts7, 4)):
            assert all(not np.any(r.get("health", 0)) for r in recs)
            got_dts = (np.array([r["dts"][0] for r in recs[:3]])
                       if n_dts == 3 else recs[3]["dts"])
            want = dts_ref.cpu().numpy()
            errs_l[f"dts{n_dts}"] = float(np.max(np.abs(got_dts - want)
                                                 / want))
            assert errs_l[f"dts{n_dts}"] <= 1e-10, errs_l
            errs_l.update(slab_compare(rec, ref, 1e-8, n_dts))
        slab_lock[tag] = dict(errs_l, wall_s=wall, n=st0.n,
                              migrate_passes=recs[-1]["passes"],
                              cuts=recs[-1]["cuts"].tolist(),
                              kernels_on_rank0=kerr)
        log(f"[30 slab lockstep] {tag}: N={st0.n} 4 ranks on one card "
            f"(gloo), 3 steps + a 4-step chunk (rebuild_every=2) + rebalance "
            f"+ migration ({recs[-1]['passes']} passes) in {wall:.1f} s: "
            "max err/scale vs single device " + ", ".join(
                f"{k} {v:.3g}" for k, v in errs_l.items())
            + " (tol 1e-8, dts 1e-10)"
            + ("; kernels on rank 0's shard vs plain: " + ", ".join(
                f"{k} {v:.3g}" for k, v in kerr.items()) if kerr else ""))

    # ---- 31. the slice at full size: turb n=100 shards=2 -----------------
    torch.cuda.empty_cache()
    slab_args = ["turb", "n=100", "chunk=8", "max_steps=16"]
    d2 = fresh(os.path.join("build", "smoke", "slab2"))
    zero_counts()
    builds0 = win.BUILDS["n"]
    t0 = time.perf_counter()
    _, t2, step2 = cli(slab_args + ["shards=2", "checkpoint_every=1",
                                    f"out={d2}"])
    wall2 = time.perf_counter() - t0
    torch.cuda.synchronize()
    # this process builds the problem (one single-device derived pass) and
    # splits it; the ranks' counts come with their records
    setup2 = counts()
    setup2_builds = win.BUILDS["n"] - builds0
    assert {k: v for k, v in setup2.items() if v} == {
        "solve_h_density": 1, "forces": 1} | one_pass, setup2
    recs2 = records(d2)
    assert step2 == 16 and all(r["finite"] for r in recs2)
    chunks2 = [r["chunk"] for r in recs2 if "chunk" in r]
    slab_launches = {}
    for c_ in chunks2:
        for k, v in c_["launches"].items():
            slab_launches[k] = slab_launches.get(k, 0) + v
    # one launch of A and one of C a step on each rank
    assert slab_launches == shard_packing(
        {"solve_h_density": 32, "forces": 32}), slab_launches
    paths["slab shards=2"] = {k: slab_launches.get(k, 0) + setup2[k]
                              for k in setup2}
    st2, _, _, _, x2 = checkpoint.load(os.path.join(d2, "checkpoint.npz"),
                                       device="cpu")
    assert x2["shards"] == "2" and st2.n == 100 ** 3
    assert checkpoint.verify_integrity(st2) is None
    p2, mv2 = p_sum(st2)
    assert float(p2.norm()) <= 1e-5 * mv2, (float(p2.norm()), mv2)
    d1 = fresh(os.path.join("build", "smoke", "slab1"))
    builds0, staged0 = win.BUILDS["n"], dist_comm.STAGED["bytes"]
    t0 = time.perf_counter()
    drive("slab shards=1", lambda: cli(slab_args + [f"out={d1}"]),
          {"solve_h_density": 17, "forces": 17})
    wall1 = time.perf_counter() - t0
    builds1 = win.BUILDS["n"] - builds0
    staged1 = dist_comm.STAGED["bytes"] - staged0
    recs1 = records(d1)
    n_slab = 100 ** 3
    slab = {
        "n": n_slab, "card": card, "steps": 16,
        "note": "2 ranks sharing one card over gloo: not a scaling measure",
        "shards2": {
            "wall_s": wall2,
            "ms_per_step_by_chunk": [c_["chunk_ms"] / 8 for c_ in chunks2],
            "ms_per_step_records": [n_slab / r["particle_steps_per_sec"]
                                    * 1e3 for r in recs2[:2]],
            "staged_bytes_per_step": [c_["staged_bytes"] / 8
                                      for c_ in chunks2],
            "migrate_ms": [c_["migrate_ms"] for c_ in chunks2],
            "migrate_passes": [c_["migrate_passes"] for c_ in chunks2],
            "rebalance_ms": [c_["rebalance_ms"] for c_ in chunks2],
            "builds": [c_["builds"] for c_ in chunks2],
            "setup_builds": setup2_builds, "setup_launches": {
                k: v for k, v in setup2.items() if v},
            "momentum_over_sum_m_abs_v": float(p2.norm()) / mv2},
        "shards1": {
            "wall_s": wall1,
            "ms_per_step_records": [n_slab / r["particle_steps_per_sec"]
                                    * 1e3 for r in recs1[:2]],
            "staged_bytes_per_step": staged1 / 16,
            "builds_with_setup": builds1}}
    log(f"[31 slab CLI] turb n=100 (N=1e6, fp32) 16 steps, 2 ranks sharing "
        f"the card over gloo (not a scaling measure): ms/step by chunk "
        f"{[round(v, 2) for v in slab['shards2']['ms_per_step_by_chunk']]}, "
        f"between records "
        f"{[round(v, 2) for v in slab['shards2']['ms_per_step_records']]}; "
        f"host-staged B/step {slab['shards2']['staged_bytes_per_step']}; "
        f"migration ms {[round(v, 1) for v in slab['shards2']['migrate_ms']]}"
        f" ({slab['shards2']['migrate_passes']} passes), rebalance ms "
        f"{[round(v, 2) for v in slab['shards2']['rebalance_ms']]}, builds "
        f"{slab['shards2']['builds']} a rank (set-up: {setup2_builds} "
        f"build and {slab['shards2']['setup_launches']} in this process); "
        f"|sum m v| / sum m|v| "
        f"{float(p2.norm()) / mv2:.3g}; launches {slab_launches}; "
        f"shards=1 ms/step between records "
        f"{[round(v, 2) for v in slab['shards1']['ms_per_step_records']]}, "
        f"host-staged B/step {staged1 / 16}, builds {builds1} with the "
        f"set-up's; walls {wall2:.1f} s and {wall1:.1f} s")
    d3 = fresh(os.path.join("build", "smoke", "slab_resume"))
    _, t3, step3 = cli(["turb", "n=100", "chunk=8", "max_steps=24",
                        "shards=2", f"out={d3}",
                        f"resume={d2}/checkpoint.npz"])
    recs3 = records(d3)
    assert step3 == 24 and t3 > t2 and all(r["finite"] for r in recs3)
    st3 = checkpoint.load(os.path.join(d3, "checkpoint.npz"),
                          device="cpu")[0]
    assert checkpoint.verify_integrity(st3) is None
    slab["resume"] = {"from_step": step2, "to_step": step3, "t": t3}
    log(f"[31 slab CLI] resumed the shards=2 checkpoint at step {step2} "
        f"(t={t2:.4f}) and ran to step {step3} (t={t3:.4f}), finite")
    # the CLI's set-up of a resume from that checkpoint: the state split
    # here, each rank handed its rows
    from sphax_torch.dist import runner as dist_runner

    st_ck2 = checkpoint.load(os.path.join(d2, "checkpoint.npz"),
                             device=dev)[0]
    spec_k, cuts_k, rows_k = dist_runner.split(st_ck2, box(
        torch.zeros(3, device=dev), torch.ones(3, device=dev)), 2)
    shard_k = dist_comm.launch(
        slab_shapes_rank, 2, dev, "gloo", timeout=300, deadline=900,
        args=(spec_k, cuts_k, st_ck2.n), rank_args=rows_k)
    del st_ck2, rows_k
    slab["kernels_on_a_shard"] = shard_k
    log("[31 slab kernels] A and C on rank 0's shard of turb n=100 "
        "shards=2 (fp32, the step-16 checkpoint): " + json.dumps(shard_k))

    # ---- 32. the h predictor against full Newton, through the kernels ----
    from sphax_torch.diag import riemann
    from sphax_torch.ics import sod as sod_ics

    hp = {}
    f32 = torch.float32

    def f32_state(ic, vel=None):
        st = make_state(*(torch.as_tensor(ic[k], dtype=f32, device=dev)
                          for k in ("pos", "vel", "mass", "u", "h")))
        return st if vel is None else st._replace(vel=vel)

    def residual(st, cfg):
        """max |rho - m (eta / h)^3| / rho, the bench's h-consistency."""
        return float(((st.rho - st.mass * (cfg.eta / st.h) ** 3).abs()
                      / st.rho).max())

    # Sod (tpu_tests/test_tpu_hpredict.py:35): L1 of rho against the exact
    # Riemann solution after 64 steps, full Newton (6 updates) and the
    # predictor (1 walk and the lagged correction)
    sod_base = configs.SPHConfig(dim=3, gamma=1.4, adaptive_h=True,
                                 balsara=True, newton_iters=6)
    sod_pred = dataclasses.replace(sod_base, h_predict=True, newton_iters=1)
    ic = sod_ics.build(nx_left=16, n_trans=16)
    st_sod = f32_state(ic)
    dom_sod = box(torch.zeros(3, dtype=f32, device=dev),
                  torch.as_tensor(ic["box"], dtype=f32, device=dev))
    spec_sod = win.plan_measured(st_sod.pos, dom_sod,
                                 h_max=float(st_sod.h.max()) * 1.25, dim=3,
                                 cutoff_scale=1.1)
    for tag, cfg_h in (("newton", sod_base), ("h_predict", sod_pred)):
        st, _, dts, ovf = drive(f"sod {tag}", lambda: wengine.simulate(
            wengine.update_derived(st_sod, cfg_h, dom_sod, spec_sod), cfg_h,
            dom_sod, spec_sod, 64, rebuild_every=2),
            {"solve_h_density": 65, "forces": 65})
        assert int(ovf) == 0
        t_sod = float(dts.sum())
        x = st.pos[:, 0].double().cpu().numpy()
        rho = st.rho.double().cpu().numpy()
        assert np.isfinite(rho).all()
        sel = (x > 0.2) & (x < 0.85)
        exact = riemann.sod_solution(x[sel], t_sod)[0]
        hp[f"sod_l1_{tag}"] = float(np.mean(np.abs(rho[sel] - exact)))
        hp[f"sod_residual_{tag}"] = residual(st, cfg_h)
    hp["sod_t"], hp["sod_n"] = t_sod, st_sod.n
    assert hp["sod_l1_newton"] < 0.06, hp
    assert hp["sod_l1_h_predict"] < 1.15 * hp["sod_l1_newton"] + 1e-4, hp
    assert hp["sod_residual_h_predict"] < 5e-3, hp

    # the 30-step lockstep (tpu_tests/test_tpu_hpredict.py:74): the
    # turbulence lattice at 16^3 with a seeded 0.3 N(0,1) velocity, the
    # production window knobs, full Newton (6 updates) against the predictor
    t_base = dataclasses.replace(configs.TURB, newton_iters=6)
    t_pred = dataclasses.replace(t_base, h_predict=True, newton_iters=1)
    ic = turbulence.build(n_side=16)
    gen = torch.Generator(device=dev).manual_seed(32)
    st_t = f32_state(ic, 0.3 * torch.randn((16 ** 3, 3), generator=gen,
                                           dtype=f32, device=dev))
    dom_t = box(torch.zeros(3, dtype=f32, device=dev),
                torch.ones(3, dtype=f32, device=dev))
    spec_t = win.plan_measured(st_t.pos, dom_t,
                               h_max=float(st_t.h.max()) * 1.3, dim=3,
                               cutoff_scale=1.05, fast_sub=3, rgroups=2)
    st_t = wengine.update_derived(st_t, t_base, dom_t, spec_t)
    outs_t = {}
    for tag, cfg_h in (("newton", t_base), ("h_predict", t_pred)):
        outs_t[tag] = drive(f"turb lockstep {tag}", lambda: wengine.simulate(
            st_t, cfg_h, dom_t, spec_t, 30, rebuild_every=2),
            {"solve_h_density": 30, "forces": 30})
        assert int(outs_t[tag][3]) == 0
    (st_n, _, dts_n, _), (st_p, _, dts_p, _) = outs_t["newton"], \
        outs_t["h_predict"]
    hp["turb_h_drift"] = float(((st_p.h - st_n.h).abs() / st_n.h).max())
    hp["turb_rho_drift"] = float(((st_p.rho - st_n.rho).abs()
                                  / st_n.rho).max())
    hp["turb_dts_rel"] = float(((dts_p - dts_n).abs() / dts_n).max())
    hp["turb_residual"] = residual(st_p, t_pred)
    assert hp["turb_h_drift"] < 3e-3 and hp["turb_rho_drift"] < 1e-2, hp
    torch.testing.assert_close(dts_p, dts_n, rtol=2e-3, atol=0.0)
    assert hp["turb_residual"] < 5e-3, hp
    log(f"[32 h_predict] fp32, through kernels A and C: Sod (N="
        f"{st_sod.n}, 64 steps to t={t_sod:.4f}) L1(rho) full Newton "
        f"{hp['sod_l1_newton']:.5f} (< 0.06), predictor "
        f"{hp['sod_l1_h_predict']:.5f} (< 1.15x + 1e-4), residual "
        f"{hp['sod_residual_h_predict']:.3g} (< 5e-3); turbulence 16^3, "
        f"30 steps: h drift {hp['turb_h_drift']:.3g} (< 3e-3), rho drift "
        f"{hp['turb_rho_drift']:.3g} (< 1e-2), dts {hp['turb_dts_rel']:.3g} "
        f"(rtol 2e-3), residual {hp['turb_residual']:.3g} (< 5e-3)")
    del outs_t, st_n, st_p, st_t, st_sod

    # ---- 33. block timesteps on the slab ranks in lockstep (fp64) --------
    from sphax_torch.ics import sedov as sedov_ics

    torch.cuda.empty_cache()
    f64 = torch.float64
    cfg_r = dataclasses.replace(configs.SEDOV, newton_iters=2)
    rung_lock = {}
    for tag, centre, ops in (
            ("centred", (0.5, 0.5, 0.5), [("rungs", 1, 3, 2, 0)]),
            # tests/dist/test_rungs_dist.py:130's blast, the span after a
            # work rebalance and the migration
            ("off-centre", (0.15, 0.5, 0.5),
             [("work", 3), ("rebalance", 3), ("migrate",), ("work", 3),
              ("refine",), ("rungs", 1, 3, 2, 0)])):
        ic = sedov_ics.build(n_side=16, E=1.0, centre=centre)
        st = make_state(*(torch.as_tensor(ic[k], dtype=f64, device=dev)
                          for k in ("pos", "vel", "mass", "u", "h")))
        dom = box(torch.zeros(3, dtype=f64, device=dev),
                  torch.ones(3, dtype=f64, device=dev))
        knobs_r = dict(cutoff_scale=1.05, fast_sub=3, rgroups=2)
        spec1 = win.plan_measured(st.pos, dom, h_max=float(st.h.max()) * 1.1,
                                  dim=3, **knobs_r)
        st0 = wengine.update_derived(st, cfg_r, dom, spec1)
        # the seeding pass of A, then A and C once a tick
        ref, dts_ref, nact_ref, ovf, viol_ref, _ = drive(
            f"rungs lockstep {tag}", lambda: rungs.simulate_rungs(
                st0, cfg_r, dom, spec1, nspans=1, n_rungs=3,
                rebuild_every=2), {"solve_h_density": 5, "forces": 4})
        assert int(ovf) == 0 and int(nact_ref.min()) < st0.n
        # shards and send buffers that hold a cut moved by whole cells
        spec = wslab.plan(dom, st0.n, float(st0.h.max()) * 1.1, 2,
                          pad_factor=2.0, migrate_frac=1.0, **knobs_r)
        cuts = wslab.equal_cuts(spec.ncell_ax, 2)
        sh = [convert.state_to_numpy(wslab.distribute(st0, dom, spec, cuts,
                                                      r)) for r in range(2)]
        rows = {k: np.concatenate([x[k] for x in sh]) for k in sh[0]}
        t0 = time.perf_counter()
        recs, kchk = dist_comm.launch(
            rung_lockstep_rank, 2, dev, "gloo", timeout=300, deadline=900,
            args=(rows, (np.zeros(3), np.ones(3), True), cfg_r, spec, cuts,
                  ops, 16))
        wall = time.perf_counter() - t0
        rec = recs[-1]
        assert not np.any(rec["health"]), rec["health"]
        dts_err = float(np.max(np.abs(rec["dts"] - dts_ref.cpu().numpy())
                               / dts_ref.cpu().numpy()))
        assert dts_err <= 1e-12, dts_err
        assert np.array_equal(rec["nacts"], nact_ref.cpu().numpy()), (
            rec["nacts"], nact_ref)
        assert rec["dt_viol"] == int(viol_ref)
        errs_r = slab_compare(rec, ref, 1e-8, "span")
        rung_lock[tag] = dict(
            errs_r, dts=dts_err, nacts=rec["nacts"].tolist(),
            dt_viol=rec["dt_viol"], wall_s=wall, n=st0.n,
            cuts=rec["cuts"].tolist(), kernels_on_rank0=kchk,
            work=[r["work"].tolist() for r in recs if "work" in r])
        log(f"[33 rung lockstep] {tag}: N={st0.n} 2 ranks on one card "
            f"(gloo), B=3, one span of 4 ticks"
            + (" after a work rebalance (rank work "
               + " -> ".join(str([round(w, 2) for w in v])
                             for v in rung_lock[tag]["work"])
               + f", cuts {rec['cuts'].tolist()})" if len(ops) > 1 else "")
            + f" in {wall:.1f} s: closings per tick {rec['nacts'].tolist()}"
            f" and dt_viol {rec['dt_viol']} equal one device's, dts within "
            f"{dts_err:.3g} (1e-12), max err/scale " + ", ".join(
                f"{k} {v:.3g}" for k, v in errs_r.items())
            + " (1e-8); A and C on rank 0's rung-masked shard (jittered) vs "
            "plain: "
            + "; ".join(f"{dt_} closers {kr['closers']}, active groups "
                        f"{kr['active_group_share']:.3f}, A "
                        f"{kr['A']['max_err_over_scale']:.3g} C "
                        f"{kr['C']['max_err_over_scale']:.3g}"
                        for dt_, kr in kchk.items()))
        del ref, st0, st
    # the off-centre blast's first closers are in rank 0's slab: its
    # kernels ran on a partly masked structure there, and on a fully
    # masked one where it had none
    ks = rung_lock["off-centre"]["kernels_on_rank0"]
    assert all((kr["closers"] > 0) == k.endswith("tick 0")
               for k, kr in ks.items()), {k: kr["closers"]
                                          for k, kr in ks.items()}

    # ---- 34. the slice at full size: sedov n=100 shards=2 rungs=4 --------
    torch.cuda.empty_cache()
    dr = fresh(os.path.join("build", "smoke", "rung2"))
    zero_counts()
    t0 = time.perf_counter()
    _, t_r2, step_r2 = cli(["sedov", "n=100", "shards=2", "rungs=4",
                            "chunk=8", "max_steps=16", "checkpoint_every=1",
                            f"out={dr}"])
    wall_r2 = time.perf_counter() - t0
    torch.cuda.synchronize()
    setup_r2 = {k: v for k, v in counts().items() if v}
    assert setup_r2 == {"solve_h_density": 1, "forces": 1} | one_pass, \
        setup_r2
    recs_r2 = records(dr)
    assert step_r2 == 16 and all(r["finite"] for r in recs_r2)
    chunks_r2 = [r["chunk"] for r in recs_r2 if "chunk" in r]
    assert len(chunks_r2) == 2
    rung_launches = {}
    for c_ in chunks_r2:
        for k, v in c_["launches"].items():
            rung_launches[k] = rung_launches.get(k, 0) + v
    # each chunk a rank: A's seeding pass, then A and C once a tick
    want_r2 = shard_packing({"solve_h_density": 2 * 2 * (1 + 8),
                             "forces": 2 * 2 * 8})
    assert rung_launches == want_r2, rung_launches
    paths["rung shards=2"] = {k: rung_launches.get(k, 0)
                              + setup_r2.get(k, 0) for k in counts()}
    for r in recs_r2[:2]:
        closings = r["active_frac"] * 100 ** 3 * 8
        assert r["dt_viol"] < 0.05 * closings, r
        assert r["active_frac"] < 0.5, r
    st_r2, _, _, _, x_r2 = checkpoint.load(os.path.join(dr, "checkpoint.npz"),
                                           device="cpu")
    assert x_r2["shards"] == "2" and st_r2.n == 100 ** 3
    assert checkpoint.verify_integrity(st_r2) is None
    p_r2, mv_r2 = p_sum(st_r2)
    assert float(p_r2.norm()) <= 1e-5 * mv_r2, (float(p_r2.norm()), mv_r2)
    one = rung_recs["rungs=4 CLI"]
    rung2 = {
        "n": 100 ** 3, "card": card, "ticks": 16, "wall_s": wall_r2,
        "note": "2 ranks sharing one card over gloo: not a scaling measure",
        "ms_per_tick_by_chunk": [c_["chunk_ms"] / 8 for c_ in chunks_r2],
        "ms_per_tick_records": [100 ** 3 / r["particle_steps_per_sec"]
                                * 1e3 for r in recs_r2[:2]],
        "active_frac": [r["active_frac"] for r in recs_r2[:2]],
        "dt_viol": [r["dt_viol"] for r in recs_r2[:2]],
        "builds": [c_["builds"] for c_ in chunks_r2],
        "staged_bytes_per_tick": [c_["staged_bytes"] / 8
                                  for c_ in chunks_r2],
        "migrate_ms": [c_["migrate_ms"] for c_ in chunks_r2],
        "migrate_passes": [c_["migrate_passes"] for c_ in chunks_r2],
        "rebalance_ms": [c_["rebalance_ms"] for c_ in chunks_r2],
        "imbalance_before_after": [(c_["imbalance_before"],
                                    c_["imbalance_after"])
                                   for c_ in chunks_r2],
        "launches": rung_launches, "launches_predicted": want_r2,
        "setup_launches": setup_r2,
        "momentum_over_sum_m_abs_v": float(p_r2.norm()) / mv_r2,
        "shards1_ms_per_tick_cli": 100 ** 3 / one["particle_steps_per_sec"]
        * 1e3,
        "shards1_ms_per_tick_simulate_rungs": rung_ms["rungs"]}
    log(f"[34 rung slab CLI] sedov n=100 (N=1e6, fp32) rungs=4, 16 ticks, "
        f"2 ranks sharing the card over gloo (not a scaling measure): ms/"
        f"tick by chunk "
        f"{[round(v, 2) for v in rung2['ms_per_tick_by_chunk']]}, between "
        f"records {[round(v, 2) for v in rung2['ms_per_tick_records']]} "
        f"(shards=1, phase 24: CLI "
        f"{rung2['shards1_ms_per_tick_cli']:.2f}, simulate_rungs "
        f"{rung_ms['rungs']:.2f}); active_frac {rung2['active_frac']}, "
        f"dt_viol {rung2['dt_viol']}, builds {rung2['builds']} a rank; "
        f"host-staged B/tick {rung2['staged_bytes_per_tick']}; migration "
        f"ms {[round(v, 1) for v in rung2['migrate_ms']]} "
        f"({rung2['migrate_passes']} passes), rebalance ms "
        f"{[round(v, 2) for v in rung2['rebalance_ms']]}, work imbalance "
        f"before -> after {rung2['imbalance_before_after']}; launches "
        f"{rung_launches} (predicted {want_r2}; set-up {setup_r2} in this "
        f"process); |sum m v| / sum m|v| {float(p_r2.norm()) / mv_r2:.3g}; "
        f"wall {wall_r2:.1f} s")
    # A and C on rank 0's rung-masked shard of that run's checkpoint: the
    # closers of the first tick of a span starting there
    st_ck = checkpoint.load(os.path.join(dr, "checkpoint.npz"),
                            device=dev)[0]
    spec_k, cuts_k, rows_k = dist_runner.split(st_ck, box(
        torch.zeros(3, device=dev), torch.ones(3, device=dev)), 2)
    rung_k = dist_comm.launch(
        rung_shapes_rank, 2, dev, "gloo", timeout=300, deadline=900,
        args=(spec_k, cuts_k, st_ck.n), rank_args=rows_k)
    del st_ck, rows_k
    rung2["kernels_on_a_shard"] = rung_k
    log("[34 rung slab kernels] A and C on rank 0's rung-masked shard of "
        "sedov n=100 shards=2 rungs=4 (fp32, the tick-16 checkpoint, the "
        "first tick's closers): " + json.dumps(rung_k))

    # ---- 35. the pencil decomposition in lockstep (fp64, 2x2) ------------
    # one launch of 4 ranks runs phase 35's and phase 38's locksteps (a
    # launch costs tens of seconds of start-up on the card)
    from sphax_torch.dist import pencil
    from sphax_torch.dist.runner import split_pencil

    torch.cuda.empty_cache()
    unit = (np.zeros(3), np.ones(3), True)
    dom64 = box(torch.zeros(3, dtype=f64, device=dev),
                torch.ones(3, dtype=f64, device=dev))

    def pencil_job(st0, cfg_j, ops, n_side, n_rungs, check, **plan_kw):
        """``pencil_lockstep_rank``'s job from a derived fp64 state: the
        2x2 plan with the production window knobs, equal cuts, every
        rank's rows."""
        spec = pencil.plan(dom64, st0.n, float(st0.h.max()) * 1.1, 2, 2,
                           fast_sub=3, rgroups=2, **plan_kw)
        cuts = (pencil.equal_cuts(spec.ncell0, 2),
                pencil.equal_cuts(spec.ncell1, 2))
        sh = [convert.state_to_numpy(pencil.distribute(st0, dom64, spec,
                                                       *cuts, r))
              for r in range(4)]
        rows = {k: np.concatenate([x[k] for x in sh]) for k in sh[0]}
        return (rows, unit, cfg_j, spec, cuts, ops, n_side, n_rungs, check)

    jobs, refs = [], {}
    ic = turbulence.build(n_side=32)
    for tag, cfg_l in SLAB_CFGS.items():
        st = make_state(*(torch.as_tensor(ic[k], dtype=f64, device=dev)
                          for k in ("pos", "vel", "mass", "u", "h")))
        gen = torch.Generator(device=dev).manual_seed(35)
        st = st._replace(vel=0.3 * torch.randn(st.vel.shape, generator=gen,
                                               dtype=f64, device=dev))
        spec1 = win.plan_measured(st.pos, dom64,
                                  h_max=float(st.h.max()) * 1.1, dim=3,
                                  fast_sub=3, rgroups=2)
        st0 = wengine.update_derived(st, cfg_l, dom64, spec1)
        ref, _, dts_ref, o_ = wengine.simulate(st0, cfg_l, dom64, spec1, 4,
                                               rebuild_every=1)
        assert int(o_) == 0
        refs[tag] = (ref, dts_ref.cpu().numpy())
        # a rebalance moves a cut by whole cells of the coarse grid:
        # pencils and send buffers that hold it
        jobs.append(pencil_job(st0, cfg_l, [("chunk", 4, 2), ("rebalance",),
                                            ("migrate",)], 32, 0,
                               tag == "turb", pad_factor=2.0,
                               migrate_frac=1.0))
    # phase 38's: the Sedov blast at 16^3, B = 3, one span, centred and
    # off centre (where rank 0 holds the first tick's closers: the kernel
    # checks run there)
    for tag, centre in (("centred", (0.5, 0.5, 0.5)),
                        ("off-centre", (0.15, 0.3, 0.5))):
        ic = sedov_ics.build(n_side=16, E=1.0, centre=centre)
        st = make_state(*(torch.as_tensor(ic[k], dtype=f64, device=dev)
                          for k in ("pos", "vel", "mass", "u", "h")))
        knobs_r = dict(cutoff_scale=1.05, fast_sub=3, rgroups=2)
        spec1 = win.plan_measured(st.pos, dom64,
                                  h_max=float(st.h.max()) * 1.1, dim=3,
                                  **knobs_r)
        st0 = wengine.update_derived(st, cfg_r, dom64, spec1)
        ref = rungs.simulate_rungs(st0, cfg_r, dom64, spec1, nspans=1,
                                   n_rungs=3, rebuild_every=2)
        assert int(ref[3]) == 0 and int(ref[2].min()) < st0.n
        refs[tag] = ref
        jobs.append(pencil_job(st0, cfg_r, [("rungs", 1, 3, 2)], 16, 3,
                               tag == "off-centre", cutoff_scale=1.05))
    t0 = time.perf_counter()
    outs = dist_comm.launch(pencil_lockstep_rank, 4, dev, "gloo",
                            timeout=300, deadline=900, args=(jobs,))
    lock_wall = time.perf_counter() - t0
    pencil_lock = {}
    for (tag, cfg_l), (recs, kchk) in zip(SLAB_CFGS.items(), outs):
        ref, dts_ref = refs[tag]
        rec = recs[0]
        assert not np.any(rec["health"]) and rec["builds"] == 2, rec
        errs_p = {"dts4": float(np.max(np.abs(rec["dts"] - dts_ref)
                                       / dts_ref))}
        assert errs_p["dts4"] <= 1e-10, errs_p
        # the chunk, and the same state after the rebalance and migration
        errs_p.update(slab_compare(rec, ref, 1e-8, "chunk"))
        errs_p.update(slab_compare(recs[-1], ref, 1e-8, "migrated"))
        pencil_lock[tag] = dict(errs_p, n=32 ** 3,
                                migrate_passes=recs[-1]["passes"],
                                cuts=[c_.tolist() for c_ in recs[-1]["cuts"]],
                                kernels_on_rank0=kchk)
        log(f"[35 pencil lockstep] {tag}: N={32 ** 3} 2x2 ranks on one card "
            f"(gloo), a 4-step chunk (rebuild_every=2) + rebalance (cuts "
            f"{pencil_lock[tag]['cuts']}) + migration "
            f"({recs[-1]['passes']} passes): max err/scale vs single device "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs_p.items())
            + " (tol 1e-8, dts 1e-10)"
            + ("; A and C on rank 0's pencil shard (jittered) vs plain: "
               + ", ".join(f"{d} A {kr['A']['max_err_over_scale']:.3g} C "
                           f"{kr['C']['max_err_over_scale']:.3g}"
                           for d, kr in kchk.items()) if kchk else ""))
    log(f"[35 pencil lockstep] the four locksteps of phases 35 and 38 in "
        f"one launch of 4 ranks: {lock_wall:.1f} s")
    del jobs

    def pencil_cli(tag, args, setup_want, rank_want, out):
        """One pencil CLI run with the counts at 0 just before it: the
        set-up's launches in this process (one single-device derived pass)
        held to ``setup_want`` and one pass of the row packing, the
        ranks' (the records' sums) to ``rank_want`` and A's row packing
        (``shard_packing``); (t, step, records,
        chunk records, rank launches, wall, |sum m v| / sum m|v|)."""
        zero_counts()
        t0 = time.perf_counter()
        _, t_, step_ = cli(args + ["checkpoint_every=1", f"out={out}"])
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        setup = {k: v for k, v in counts().items() if v}
        assert setup == with_cic(setup_want) | one_pass, (tag, setup)
        recs = records(out)
        assert all(r["finite"] for r in recs), tag
        chunks = [r["chunk"] for r in recs if "chunk" in r]
        ranks = {}
        for c_ in chunks:
            for k, v in c_["launches"].items():
                ranks[k] = ranks.get(k, 0) + v
        assert ranks == shard_packing(rank_want), (tag, ranks)
        paths[tag] = {k: ranks.get(k, 0) + setup.get(k, 0)
                      for k in counts()}
        st_, _, _, _, x_ = checkpoint.load(os.path.join(out,
                                                        "checkpoint.npz"),
                                           device="cpu")
        assert x_["shards"] == "2x2" and st_.n == 100 ** 3, x_
        assert checkpoint.verify_integrity(st_) is None
        p_, mv_ = p_sum(st_)
        return t_, step_, recs, chunks, ranks, wall, float(p_.norm()) / mv_

    shape_jobs = []

    def pencil_shapes(out, cfg_k, n_rungs=0, fp64=False):
        """Queue A and C on rank 0's pencil of the checkpoint in ``out``
        (the CLI's split of a resume) for ``pencil_shapes_rank``."""
        st_ck = checkpoint.load(os.path.join(out, "checkpoint.npz"),
                                device=dev)[0]
        spec_k, cuts_k, rows_k = split_pencil(st_ck, box(
            torch.zeros(3, device=dev), torch.ones(3, device=dev)), 2, 2)
        shape_jobs.append(((spec_k, cuts_k, st_ck.n, cfg_k, n_rungs, fp64),
                           rows_k))

    # ---- 36. P3M on pencils: turb n=100 gravity=1 shards=2x2 ---------------
    torch.cuda.empty_cache()
    g_kv = ["gravity=1", "grav_solver=p3m", "grav_mesh=128"]
    dg36 = fresh(os.path.join("build", "smoke", "pencil_p3m"))
    t36, s36, recs36, ch36, l36, wall36, pm36 = pencil_cli(
        "pencil p3m", ["turb", "n=100", "shards=2x2", "chunk=4",
                       "max_steps=4"] + g_kv,
        {"solve_h_density": 1, "forces_grav": 1},
        {"solve_h_density": 16, "forces_grav": 16}, dg36)
    assert s36 == 4
    pencil_shapes(dg36, problems._cfg_kw(
        dataclasses.replace(configs.TURB, newton_iters=2),
        dict(gravity=1, grav_solver="p3m", grav_mesh=128)), fp64=True)
    pencil_p3m = {
        "n": 100 ** 3, "card": card, "steps": 4, "wall_s": wall36,
        "note": "4 ranks sharing one card over gloo: not a scaling measure",
        "ms_per_step": [c_["chunk_ms"] / 4 for c_ in ch36],
        "staged_bytes_per_step": [c_["staged_bytes"] / 4 for c_ in ch36],
        "launches": l36, "momentum_over_sum_m_abs_v": pm36}
    log(f"[36 pencil P3M] turb n=100 gravity=1 grav_solver=p3m "
        f"grav_mesh=128 shards=2x2 (N=1e6, fp32), 4 steps, 4 ranks sharing "
        f"the card (not a scaling measure): ms/step "
        f"{[round(v, 2) for v in pencil_p3m['ms_per_step']]}, host-staged "
        f"B/step {pencil_p3m['staged_bytes_per_step']}, launches {l36}, "
        f"|sum m v| / sum m|v| {pm36:.3g}; wall {wall36:.1f} s")

    # ---- 37. the slice at full size: turb n=100 shards=2x2 ---------------
    torch.cuda.empty_cache()
    d37 = fresh(os.path.join("build", "smoke", "pencil"))
    # the staged bytes a step, predicted from the plan before the run
    st_p = problems.turb(n=100, device=dev).state
    spec_p = split_pencil(st_p, box(torch.zeros(3, device=dev),
                                    torch.ones(3, device=dev)), 2, 2)[0]
    staged_pred = staged_per_step(spec_p, 3, 4, 8, 2, 4)
    log(f"[37 pencil CLI] predicted from the plan (n_local "
        f"{spec_p.n_local}, ghost caps {spec_p.ghost_cap0} and "
        f"{spec_p.ghost_cap1}, n_comb {spec_p.n_comb}): "
        f"{staged_pred / 1e6:.2f} MB staged a step")
    del st_p
    t37, s37, recs37, ch37, l37, wall37, pm37 = pencil_cli(
        "pencil shards=2x2", ["turb", "n=100", "shards=2x2", "chunk=8",
                              "max_steps=16"],
        {"solve_h_density": 1, "forces": 1},
        {"solve_h_density": 64, "forces": 64}, d37)
    assert s37 == 16 and pm37 <= 1e-5, pm37
    pencil_launches = l37
    d37r = fresh(os.path.join("build", "smoke", "pencil_resume"))
    _, t37r, s37r = cli(["turb", "n=100", "chunk=8", "max_steps=24",
                         "shards=2x2", f"out={d37r}",
                         f"resume={d37}/checkpoint.npz"])
    assert s37r == 24 and t37r > t37
    assert all(r["finite"] for r in records(d37r))
    assert checkpoint.verify_integrity(checkpoint.load(
        os.path.join(d37r, "checkpoint.npz"), device="cpu")[0]) is None
    pencil_shapes(d37, dataclasses.replace(configs.TURB, newton_iters=2))
    pen = {
        "n": 100 ** 3, "card": card, "steps": 16, "wall_s": wall37,
        "note": "4 ranks sharing one card over gloo: not a scaling measure",
        "ms_per_step_by_chunk": [c_["chunk_ms"] / 8 for c_ in ch37],
        "ms_per_step_records": [100 ** 3 / r["particle_steps_per_sec"] * 1e3
                                for r in recs37[:2]],
        "staged_bytes_per_step": [c_["staged_bytes"] / 8 for c_ in ch37],
        "staged_bytes_per_step_by_axis": [
            {a: v / 8 for a, v in c_["staged_bytes_by_axis"].items()}
            for c_ in ch37],
        "staged_bytes_per_step_predicted": staged_pred,
        "migrate_ms": [c_["migrate_ms"] for c_ in ch37],
        "migrate_passes": [c_["migrate_passes"] for c_ in ch37],
        "rebalance_ms": [c_["rebalance_ms"] for c_ in ch37],
        "builds": [c_["builds"] for c_ in ch37],
        "count_imbalance_before_after": [
            (c_["imbalance_before"], c_["imbalance_after"]) for c_ in ch37],
        "momentum_over_sum_m_abs_v": pm37,
        "resume": {"from_step": s37, "to_step": s37r, "t": t37r},
        "shards2_ms_per_step_by_chunk": slab["shards2"][
            "ms_per_step_by_chunk"],
        "shards1_ms_per_step_records": slab["shards1"][
            "ms_per_step_records"]}
    log(f"[37 pencil CLI] turb n=100 shards=2x2 (N=1e6, fp32) 16 steps, 4 "
        f"ranks sharing the card over gloo (not a scaling measure): ms/step "
        f"by chunk {[round(v, 2) for v in pen['ms_per_step_by_chunk']]} "
        f"(phase 31: shards=2 "
        f"{[round(v, 2) for v in pen['shards2_ms_per_step_by_chunk']]}, "
        f"shards=1 "
        f"{[round(v, 2) for v in pen['shards1_ms_per_step_records']]}); "
        f"host-staged B/step {pen['staged_bytes_per_step']} (predicted "
        f"{staged_pred:.4g}; by axis {pen['staged_bytes_per_step_by_axis']})"
        f"; migration ms {[round(v, 1) for v in pen['migrate_ms']]} "
        f"({pen['migrate_passes']} passes), rebalance ms "
        f"{[round(v, 2) for v in pen['rebalance_ms']]}, builds "
        f"{pen['builds']} a rank, count imbalance before -> after "
        f"{pen['count_imbalance_before_after']}; launches {l37}; |sum m v| "
        f"/ sum m|v| {pm37:.3g}; resumed to step {s37r} (t={t37r:.4f}); "
        f"wall {wall37:.1f} s")

    # ---- 38. block timesteps on pencils: lockstep, then sedov n=100 ------
    prung_lock = {}
    for tag, (recs, kchk) in zip(("centred", "off-centre"), outs[2:]):
        ref, dts_ref, nact_ref, _, viol_ref, _ = refs[tag]
        rec = recs[-1]
        assert not np.any(rec["health"]), rec["health"]
        dts_err = float(np.max(np.abs(rec["dts"] - dts_ref.cpu().numpy())
                               / dts_ref.cpu().numpy()))
        assert dts_err <= 1e-12, dts_err
        assert np.array_equal(rec["nacts"], nact_ref.cpu().numpy()), (
            rec["nacts"], nact_ref)
        assert rec["dt_viol"] == int(viol_ref)
        errs_r = slab_compare(rec, ref, 1e-8, "span")
        prung_lock[tag] = dict(errs_r, dts=dts_err,
                               nacts=rec["nacts"].tolist(),
                               dt_viol=rec["dt_viol"], n=16 ** 3,
                               kernels_on_rank0=kchk)
        log(f"[38 pencil rung lockstep] {tag}: N={16 ** 3} 2x2 ranks on one "
            f"card (gloo), B=3, one span of 4 ticks (phase 35's launch): "
            f"closings per tick {rec['nacts'].tolist()} and dt_viol "
            f"{rec['dt_viol']} equal one device's, dts within {dts_err:.3g}"
            " (1e-12), max err/scale " + ", ".join(
                f"{k} {v:.3g}" for k, v in errs_r.items())
            + " (1e-8)"
            + ("; A and C on rank 0's rung-masked pencil (jittered) vs "
               "plain: "
               + "; ".join(f"{dt_} closers {kr['closers']}, active groups "
                           f"{kr['active_group_share']:.3f}, A "
                           f"{kr['A']['max_err_over_scale']:.3g} C "
                           f"{kr['C']['max_err_over_scale']:.3g}"
                           for dt_, kr in kchk.items()) if kchk else ""))
    # rank 0 held the off-centre blast's first closers, then none
    ks = prung_lock["off-centre"]["kernels_on_rank0"]
    assert all((kr["closers"] > 0) == k.endswith("tick 0")
               for k, kr in ks.items()), {k: kr["closers"]
                                          for k, kr in ks.items()}
    del refs, outs
    torch.cuda.empty_cache()
    dr38 = fresh(os.path.join("build", "smoke", "pencil_rung"))
    t38, s38, recs38, ch38, l38, wall38, pm38 = pencil_cli(
        "pencil rung shards=2x2", ["sedov", "n=100", "shards=2x2", "rungs=4",
                                   "chunk=8", "max_steps=16"],
        {"solve_h_density": 1, "forces": 1},
        # each chunk a rank: A's seeding pass, then A and C once a tick
        {"solve_h_density": 4 * 2 * (1 + 8), "forces": 4 * 2 * 8}, dr38)
    assert s38 == 16 and pm38 <= 1e-5, pm38
    prung_launches = l38
    for r in recs38[:2]:
        closings = r["active_frac"] * 100 ** 3 * 8
        assert r["dt_viol"] < 0.05 * closings, r
    pencil_shapes(dr38, configs.SEDOV, n_rungs=4)
    prung = {
        "n": 100 ** 3, "card": card, "ticks": 16, "wall_s": wall38,
        "note": "4 ranks sharing one card over gloo: not a scaling measure",
        "ms_per_tick_by_chunk": [c_["chunk_ms"] / 8 for c_ in ch38],
        "active_frac": [r["active_frac"] for r in recs38[:2]],
        "dt_viol": [r["dt_viol"] for r in recs38[:2]],
        "builds": [c_["builds"] for c_ in ch38],
        "staged_bytes_per_tick": [c_["staged_bytes"] / 8 for c_ in ch38],
        "migrate_ms": [c_["migrate_ms"] for c_ in ch38],
        "migrate_passes": [c_["migrate_passes"] for c_ in ch38],
        "count_imbalance_before_after": [
            (c_["imbalance_before"], c_["imbalance_after"]) for c_ in ch38],
        "launches": l38, "momentum_over_sum_m_abs_v": pm38,
        "shards2_ms_per_tick_by_chunk": rung2["ms_per_tick_by_chunk"],
        "shards1_ms_per_tick_simulate_rungs": rung_ms["rungs"]}
    log(f"[38 pencil rung CLI] sedov n=100 shards=2x2 rungs=4 (N=1e6, "
        f"fp32), 16 ticks, 4 ranks sharing the card over gloo (not a "
        f"scaling measure): ms/tick by chunk "
        f"{[round(v, 2) for v in prung['ms_per_tick_by_chunk']]} (phase 34 "
        f"shards=2 {[round(v, 2) for v in rung2['ms_per_tick_by_chunk']]},"
        f" phase 24 shards=1 {rung_ms['rungs']:.2f}); active_frac "
        f"{prung['active_frac']}, dt_viol {prung['dt_viol']}, builds "
        f"{prung['builds']}; host-staged B/tick "
        f"{prung['staged_bytes_per_tick']}; migration ms "
        f"{[round(v, 1) for v in prung['migrate_ms']]} "
        f"({prung['migrate_passes']} passes); count imbalance "
        f"{prung['count_imbalance_before_after']}; launches {l38}; wall "
        f"{wall38:.1f} s")
    # A and C on rank 0's pencil of each run's checkpoint, in one launch:
    # phase 36's (C in its gravity mode, fp32 timed and fp64), 37's, 38's
    # (masked to a span's first tick's closers)
    t0 = time.perf_counter()
    grav_k, pen_k, prung_k = dist_comm.launch(
        pencil_shapes_rank, 4, dev, "gloo", timeout=300, deadline=900,
        args=([j for j, _ in shape_jobs],),
        rank_args=[[rows[r] for _, rows in shape_jobs] for r in range(4)])
    del shape_jobs
    assert grav_k["momentum_over_sum_abs"] < 2e-3, grav_k
    pencil_p3m["kernels_on_a_shard"] = grav_k
    pen["kernels_on_a_shard"] = pen_k
    prung["kernels_on_a_shard"] = prung_k
    log(f"[36 pencil kernels] C's gravity mode (and A) on rank 0's pencil "
        f"of the P3M run's checkpoint vs plain, fp32 timed and fp64: "
        + json.dumps(grav_k))
    log("[37 pencil kernels] A and C on rank 0's pencil of turb n=100 "
        "shards=2x2 (fp32, the step-16 checkpoint): " + json.dumps(pen_k))
    log("[38 pencil rung kernels] A and C on rank 0's rung-masked pencil of "
        "sedov n=100 shards=2x2 rungs=4 (fp32, the tick-16 checkpoint, the "
        "first tick's closers): " + json.dumps(prung_k))
    log(f"[38 pencil kernels] the three checkpoints' checks in one launch "
        f"of 4 ranks: {time.perf_counter() - t0:.1f} s")
    from sphax_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    dry = dryrun_multichip(4, dev)
    dry["wall_s"] = time.perf_counter() - t0
    log(f"[38 dryrun] sphax_torch.entry.dryrun_multichip(4) on the card: "
        f"{json.dumps(dry)}")

    # ---- 39. entry(): the twin of __graft_entry__.entry() on the card ----
    helpers = types.SimpleNamespace(
        drive=drive, compare=compare, worst=worst, cuda_ms=cuda_ms,
        device_ms_by_kind=device_ms_by_kind, plain_kernels=plain_kernels)
    entry_rec, entry_rows = entry_phase(dev, helpers)

    # ---- 40. the JAX package's slow gates, fp64, on the card -------------
    t0 = time.perf_counter()
    gates = slow_gates_phase(dev, helpers)
    gates["seconds"] = time.perf_counter() - t0
    log(f"[40 slow gates] {gates['seconds']:.1f} s")

    # ---- 41. compute-sanitizer over the hand kernels ---------------------
    san = sanitize_phase(dev)
    log(f"[41 sanitize] {san['seconds']:.1f} s")

    # ---- 42. the cell-list engine: N = 1e6, and sod n=64 through the CLI -
    helpers.fresh, helpers.records = fresh, records
    t_new = time.perf_counter()
    clist_rec = clist_phase(dev, helpers)
    log(f"[42 clist] {clist_rec['seconds']:.1f} s")

    # ---- 43. the equal-extent slabs on 2 ranks ---------------------------
    eq_rec = eq_slab_phase(dev, helpers)
    log(f"[43 eq slab] {eq_rec['seconds']:.1f} s")

    # ---- 44. the sorted-order P3M mesh -----------------------------------
    sm_rec = sorted_mesh_phase(dev, helpers)
    new_s = time.perf_counter() - t_new
    log(f"[44 sorted mesh] {sm_rec['seconds']:.1f} s; phases 42-44 "
        f"{new_s:.1f} s")

    # ---- 45. the derived pass's row gathers and packing at turb256 -------
    rp_rec = rowpack_phase(dev, helpers)

    # ---- 46. the P3M mesh's CIC kernels at cloud256 ----------------------
    cic_rec = cic_phase(dev, helpers)

    # ---- 47. the timestep limiter's kernels on sedov n=256 ---------------
    lim_rec = limiter_phase(dev, helpers)

    def total(kernel):
        return sum(p_[kernel] for p_ in paths.values())

    # each row-packing, CIC and limiter kernel's launches over every path,
    # as A's and C's
    for row in rp_rec["kernels"] + cic_rec["kernels"] + lim_rec["kernels"]:
        row["launches"] = total(row["name"])

    src = "sphax_torch/csrc/window_kernels.cu"
    a_ms, a_pms, a_e = times["A h_predict"]
    c_ms, c_pms, c_e = times["C"]

    # the launches at N = 1e6 on the rung path's tables: the two CLI runs
    # of phase 24, A's seeding pass and the set-up's passes apart (one mask
    # per tick, one launch of A and of C on it)
    ticks_m = [m for v in masks.values() for m in v]
    masked_keys = {
        "launches": len(ticks_m),
        "launches_partial_mask": sum(a < b for a, b in ticks_m),
        "launches_mean_active_group_share":
            sum(a / b for a, b in ticks_m) / len(ticks_m)}

    def cull_keys(shapes, which):
        """What the cull's rule keeps at a row's shapes, by the plain
        ``cull_stats`` on this run's inputs. Every row takes the
        cull-and-walk body."""
        v = surv[shapes]
        return {"survivors_per_row": v[which],
                "survivors_from": "window_kernels.cull_stats (plain torch)",
                "candidates_per_row": v["candidates"],
                "pairs_inside_per_row": v[f"inside_{which}"]}

    def bound_keys(key):
        # no single PyTorch call computes these kernels' functions
        return {"bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                "library_ms": None}

    kernels = {"kernels": [
        {"name": "solve_h_density", "route": "cuda", "source": src,
         "replaces": "sphax/physics/pallas_kernels.py:315",
         "launches": total("solve_h_density"), "max_abs_err": a_e,
         "ms": a_ms, "plain_ms": a_pms, **bound_keys("A"),
         **cull_keys("bench", "A"),
         "ms_cold": times["A cold"][0], "plain_ms_cold": times["A cold"][1],
         "bound_ms_cold": bounds["A cold"][0],
         "dim2": {"replaces": "sphax/physics/pallas_kernels.py:480",
                  "launches": total("solve_h_density_2d"),
                  "max_abs_err": a2_e, "ms": a2_ms, "plain_ms": a2_pms,
                  **bound_keys("A2"), **cull_keys("kh", "A"),
                  "n": st_kh.n}},
        {"name": "forces", "route": "cuda", "source": src,
         "replaces": "sphax/physics/pallas_kernels.py:563",
         "launches": total("forces") + total("forces_grav"),
         "launches_grav": total("forces_grav"), "max_abs_err": c_e,
         "ms": c_ms, "plain_ms": c_pms, **bound_keys("C"),
         **cull_keys("bench", "C"),
         "grav": {"replaces": "sphax/physics/pallas_kernels.py:747",
                  "ms": cg["with"][0], "plain_ms": cg["with"][1],
                  "max_abs_err": cg["with"][2], **bound_keys("C grav"),
                  **cull_keys("P3M grav", "C"),
                  "ms_without_grav": cg["without"][0],
                  "plain_ms_without_grav": cg["without"][1]},
         "dim2": {"replaces": "sphax/physics/pallas_kernels.py:583",
                  "launches": total("forces_2d"), "max_abs_err": c2_e,
                  "ms": c2_ms, "plain_ms": c2_pms, **bound_keys("C2"),
                  **cull_keys("kh", "C"), "n": st_kh.n}},
        {"name": "solve_h_density_compact", "route": "cuda", "source": src,
         "replaces": "sphax/physics/pallas_kernels.py:195",
         "launches": total("solve_h_density_compact"),
         "max_abs_err": ctimes["A h_predict"][2],
         "ms": ctimes["A h_predict"][0], "plain_ms": ctimes["A h_predict"][1],
         **bound_keys("A"), **cull_keys("bench compact", "A"),
         "in_place_ms": ctimes["A h_predict"][3],
         "ms_cold": ctimes["A cold"][0],
         "plain_ms_cold": ctimes["A cold"][1],
         "in_place_ms_cold": ctimes["A cold"][3],
         "bound_ms_cold": bounds["A cold"][0],
         "c_n_mean_p99_max_per_row": cst,
         "dim2": {"launches": total("solve_h_density_compact_2d"),
                  "max_abs_err": ctimes["A2"][2], "ms": ctimes["A2"][0],
                  "plain_ms": ctimes["A2"][1],
                  "in_place_ms": ctimes["A2"][3], **bound_keys("A2"),
                  **cull_keys("kh compact", "A"),
                  "c_n_mean_p99_max_per_row": cst2}},
        {"name": "forces_compact", "route": "cuda", "source": src,
         "replaces": "sphax/physics/pallas_kernels.py:619",
         "launches": total("forces_compact") + total("forces_grav_compact"),
         "launches_grav": total("forces_grav_compact"),
         "max_abs_err": ctimes["C"][2], "ms": ctimes["C"][0],
         "plain_ms": ctimes["C"][1], **bound_keys("C"),
         **cull_keys("bench compact", "C"),
         "in_place_ms": ctimes["C"][3],
         "grav": {"ms": ctimes["C grav"][0], "plain_ms": ctimes["C grav"][1],
                  "max_abs_err": ctimes["C grav"][2],
                  "in_place_ms": ctimes["C grav"][3],
                  **bound_keys("C grav"),
                  **cull_keys("P3M grav compact", "C"),
                  "c_n_mean_p99_max_per_row": cst_g},
         "dim2": {"launches": total("forces_compact_2d"),
                  "max_abs_err": ctimes["C2"][2], "ms": ctimes["C2"][0],
                  "plain_ms": ctimes["C2"][1],
                  "in_place_ms": ctimes["C2"][3], **bound_keys("C2"),
                  **cull_keys("kh compact", "C")}},
        # kernels A and C on the rung path's masked tables: the Sedov
        # N = 1e6 structure with 10 % of the particles closing (phase 22,
        # where ms and the bound are taken at active_group_share); launches
        # are the ticks of the CLI's rung runs at that size (phase 24)
        {"name": "solve_h_density on masked tables", "route": "cuda",
         "source": src, "replaces": "sphax/physics/pallas_kernels.py:373",
         **masked_keys,
         "max_abs_err": mask_e[torch.float32][0],
         "ms": mtimes["masked"][0], "plain_ms": mp_a,
         **bound_keys("A masked"), **cull_keys("sedov", "A"),
         "active_group_share": share[0],
         "active_tile_share": share[1], "ms_unmasked": mtimes["all"][0],
         "bound_ms_unmasked": bounds["A sedov"][0],
         "ms_all_masked": mtimes["none"][0],
         "ms_4_groups": mtimes["4 groups"][0]},
        {"name": "forces on masked tables", "route": "cuda", "source": src,
         "replaces": "sphax/physics/pallas_kernels.py:640",
         **masked_keys,
         "max_abs_err": mask_e[torch.float32][1],
         "ms": mtimes["masked"][1], "plain_ms": mp_c,
         **bound_keys("C masked"), **cull_keys("sedov", "C"),
         "active_group_share": share[0],
         "active_tile_share": share[1], "ms_unmasked": mtimes["all"][1],
         "bound_ms_unmasked": bounds["C sedov"][0],
         "ms_all_masked": mtimes["none"][1],
         "ms_4_groups": mtimes["4 groups"][1]},
        *[{"name": f"{base}{tag}_1d", "route": "cuda", "source": src,
           "replaces": "sphax/physics/pallas_kernels.py:"
                       + ("529" if which == "A" else "583"),
           "launches": total(f"{base}{tag}_1d"),
           "max_abs_err": times1[tag][which][2],
           "ms": times1[tag][which][0], "plain_ms": times1[tag][which][1],
           **bound_keys(f"{which}1"),
           **cull_keys("1d compact" if tag else "1d", which), "n": n1}
          for tag in ("", "_compact")
          for which, base in (("A", "solve_h_density"), ("C", "forces"))],
        # kernels A and C on a slab shard's masked structure: launches are
        # the ranks' (the CLI's turb n=100 shards=2, 16 steps, phase 31),
        # ms, plain_ms and the bound on rank 0's shard of that run
        *[{"name": f"{base} on a slab shard's masked structure",
           "route": "cuda", "source": src,
           "replaces": "sphax/physics/pallas_kernels.py:"
                       + ("315" if which == "A" else "563"),
           "launches": slab_launches[base],
           "max_abs_err": shard_k[which]["max_abs_err"],
           "ms": shard_k[which]["ms"], "plain_ms": shard_k[which]["plain_ms"],
           "bound_ms": shard_k[which]["bound_ms"],
           "bound_by": shard_k[which]["bound_by"], "library_ms": None,
           "shards": 2, "n": n_slab,
           "own_rows": shard_k["own_rows"],
           "active_group_share": shard_k["active_group_share"],
           "pairs_inside_per_own_row": shard_k[which]["pairs_per_row"]}
          for which, base in (("A", "solve_h_density"), ("C", "forces"))],
        # kernels A and C on a slab shard's structure masked again to the
        # closers of a rung tick: launches are the ranks' (the CLI's sedov
        # n=100 shards=2 rungs=4, 16 ticks, the seeding passes of A
        # included, phase 34), ms, plain_ms and the bound on rank 0's shard
        # of that run at the first tick of a span; the quiet rank's fully
        # masked launch and the fp64 check are phase 33's
        *[{"name": f"{base} on a slab shard's rung-masked structure",
           "route": "cuda", "source": src,
           "replaces": "sphax/physics/pallas_kernels.py:"
                       + ("373" if which == "A" else "640"),
           "launches": rung_launches[base],
           "max_abs_err": rung_k[which]["max_abs_err"],
           "ms": rung_k[which]["ms"], "plain_ms": rung_k[which]["plain_ms"],
           "bound_ms": rung_k[which]["bound_ms"],
           "bound_by": rung_k[which]["bound_by"], "library_ms": None,
           "shards": 2, "n": 100 ** 3, "n_rungs": 4,
           "own_rows": rung_k["own_rows"], "closers": rung_k["closers"],
           "active_group_share": rung_k["active_group_share"],
           "pairs_inside_per_own_row": rung_k[which]["pairs_per_row"],
           "lockstep_max_err_over_scale": {
               f"{tag} {dt_}": kr[which]["max_err_over_scale"]
               for tag, v in rung_lock.items()
               for dt_, kr in v["kernels_on_rank0"].items()}}
          for which, base in (("A", "solve_h_density"), ("C", "forces"))],
        # kernels A and C on a pencil shard's masked structure: launches
        # are the ranks' (the CLI's turb n=100 shards=2x2, 16 steps, phase
        # 37), ms, plain_ms and the bound on rank 0's pencil of that run;
        # the fp64 checks on jittered rows are phase 35's
        *[{"name": f"{base} on a pencil shard's masked structure",
           "route": "cuda", "source": src,
           "replaces": "sphax/physics/pallas_kernels.py:"
                       + ("315" if which == "A" else "563"),
           "launches": pencil_launches[base],
           "max_abs_err": pen_k[which]["max_abs_err"],
           "ms": pen_k[which]["ms"], "plain_ms": pen_k[which]["plain_ms"],
           "bound_ms": pen_k[which]["bound_ms"],
           "bound_by": pen_k[which]["bound_by"], "library_ms": None,
           "shards": "2x2", "n": 100 ** 3,
           "own_rows": pen_k["own_rows"], "n_sorted": pen_k["n_sorted"],
           "active_group_share": pen_k["active_group_share"],
           "pairs_inside_per_own_row": pen_k[which]["pairs_per_row"],
           "lockstep_max_err_over_scale": {
               d: kr[which]["max_err_over_scale"]
               for d, kr in pencil_lock["turb"]["kernels_on_rank0"].items()}}
          for which, base in (("A", "solve_h_density"), ("C", "forces"))],
        # kernel C's gravity mode (the fused P3M short range) on a pencil
        # shard: launches are the ranks' (phase 36's turb n=100 P3M at
        # shards=2x2, 4 steps), ms, plain_ms and the bound on rank 0's
        # pencil of that run, fp32 and fp64 against plain
        {"name": "forces (gravity mode) on a pencil shard", "route": "cuda",
         "source": src, "replaces": "sphax/physics/pallas_kernels.py:747",
         "launches": l36["forces_grav"],
         "max_abs_err": grav_k["C"]["max_abs_err"],
         "ms": grav_k["C"]["ms"], "plain_ms": grav_k["C"]["plain_ms"],
         "bound_ms": grav_k["C"]["bound_ms"],
         "bound_by": grav_k["C"]["bound_by"], "library_ms": None,
         "shards": "2x2", "n": 100 ** 3, "own_rows": grav_k["own_rows"],
         "pairs_inside_per_own_row": grav_k["C"]["pairs_per_row"],
         "pairs_in_cutoff_per_own_row": grav_k["C"]["grav_pairs_per_row"],
         "fp64_max_err_over_scale": grav_k["fp64"]["C"],
         "momentum_over_sum_abs": grav_k["momentum_over_sum_abs"]},
        # kernels A and C on a pencil shard's rung-masked structure:
        # launches are the ranks' (sedov n=100 shards=2x2 rungs=4, 16
        # ticks, the seeding passes of A included, phase 38), ms, plain_ms
        # and the bound on rank 0's pencil of that run at a span's first
        # tick; the quiet launch and the fp64 check are phase 38's lockstep
        *[{"name": f"{base} on a pencil shard's rung-masked structure",
           "route": "cuda", "source": src,
           "replaces": "sphax/physics/pallas_kernels.py:"
                       + ("373" if which == "A" else "640"),
           "launches": prung_launches[base],
           "max_abs_err": prung_k[which]["max_abs_err"],
           "ms": prung_k[which]["ms"], "plain_ms": prung_k[which]["plain_ms"],
           "bound_ms": prung_k[which]["bound_ms"],
           "bound_by": prung_k[which]["bound_by"], "library_ms": None,
           "shards": "2x2", "n": 100 ** 3, "n_rungs": 4,
           "own_rows": prung_k["own_rows"], "closers": prung_k["closers"],
           "active_group_share": prung_k["active_group_share"],
           "pairs_inside_per_own_row": prung_k[which]["pairs_per_row"],
           "lockstep_max_err_over_scale": {
               f"{tag} {dt_}": kr[which]["max_err_over_scale"]
               for tag, v in prung_lock.items()
               for dt_, kr in v["kernels_on_rank0"].items()}}
          for which, base in (("A", "solve_h_density"), ("C", "forces"))],
        {"name": "gravity", "route": "cuda",
         "source": "sphax_torch/csrc/gravity_kernel.cu",
         "replaces": "sphax/physics/pallas_kernels.py:808",
         "launches": total("gravity"), "max_abs_err": g_e,
         "ms": g_ms, "plain_ms": g_pms, **bound_keys("G"), "n": 64 ** 3,
         "ms_n1e6": g_ms_1e6,
         "ms_by_n": {k: v["ms"] for k, v in g_by_n.items()},
         "bound_ms_by_n": {k: v["bound_ms"] for k, v in g_by_n.items()},
         "rows_per_thread": {k: v["rows_per_thread"]
                             for k, v in g_by_n.items()},
         "slices": {k: v["slices"] for k, v in g_by_n.items()},
         "runtime_at_64_cubed": g_launch},
        *entry_rows, *cic_rec["kernels"], *lim_rec["kernels"],
    ], "launches_by_path": paths, "mesh_accel_ms": mesh_ms,
        "mesh_accel_device_ms": mesh_dev_ms,
        "p3m_step_ms": step_g * 1e3, "rs_mesh_cells": rs_cells,
        "candidate_rows_walked_p3m": walked_g,
        "candidate_rows_walked": walked,
        "candidate_rows_computed": computed,
        "kh": {"n": st_kh.n, "ms_per_step": kh_step * 1e3,
               "particle_steps_per_s": kh_pss,
               "candidate_rows_walked": walked2,
               "candidate_rows_computed": computed2,
               "gate_rate_over_theory": rate / gamma_th,
               "gate_steps": n16},
        "bench_modes": {k: {"particle_steps_per_s": v["value"],
                            "cwidth": v["cwidth"], "rebuilds": v["rebuilds"]}
                        for k, v in bench_modes.items()},
        "adaptive_step_ms_with_without_gate_read": gate_ms,
        "rungs": {"n": st_s.n, "n_rungs": 4, "ticks": 16,
                  "ms_per_tick": rung_ms, "ms_per_tick_runs": tick_ms,
                  "builds": {"rungs": builds_r, "adaptive": builds_a,
                             "global dt": builds["global dt"]},
                  "active_frac_per_tick": fracs,
                  "kernel_ms_per_tick": kern_ms,
                  "kernel_ticks": per_tick,
                  "device_ms_per_tick_by_kind": dev_ms,
                  "active_group_share": grp_share,
                  "candidate_rows_walked": walked_s,
                  "cli": rung_recs, "b1_max_abs_diff": b1_err,
                  "sedov_gate": gate_s},
        "dim1": {"n": n1, "step_ms": line[""][1],
                 "step_ms_compact": line["_compact"][1],
                 "candidate_rows_walked": walked1,
                 "candidate_rows_computed": computed1,
                 "c_n_mean_p99_max_per_row": cst1},
        "cull": surv, "walks": walks,
        "off_lattice_max_abs_err": {f"{k} {d}": v
                                    for (k, d), v in off_lattice.items()},
        "reference_cpu_max_rel_err": ref_err,
        "device_ms_per_step_by_kind": where,
        "slab": dict(slab, lockstep_fp64_4_ranks=slab_lock),
        "rung_slab": dict(rung2, lockstep_fp64_2_ranks=rung_lock),
        "pencil": dict(pen, lockstep_fp64_2x2=pencil_lock, p3m=pencil_p3m),
        "pencil_rungs": dict(prung, lockstep_fp64_2x2=prung_lock),
        "dryrun_multichip": dry,
        "h_predict": hp,
        "entry": entry_rec, "slow_gates": gates, "sanitize": san,
        "clist": clist_rec, "eq_slab": eq_rec, "sorted_mesh": sm_rec,
        "phases_42_44_s": new_s, "rowpack": rp_rec, "cic": cic_rec,
        "limiter": lim_rec, "script_wall_s": time.perf_counter() - t_script,
        "build_s": _build.BUILD_INFO["seconds"],
        "card": card}
    log(f"[done] phases 1-47 in {kernels['script_wall_s']:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def entry_phase(dev, h):
    """Phase 39: ``sphax_torch.entry.entry()`` on the card (fp32, n_side 16)
    through kernels A and C, held to the same step through their plain
    versions; the warm call's enqueue, wall and device time. ``h`` holds
    main()'s helpers (drive, compare, cuda_ms, device_ms_by_kind,
    plain_kernels). Returns (record, kernel rows for A and C)."""
    from sphax_torch.ab_kernels import sorted_fields
    from sphax_torch.entry import entry
    from sphax_torch.neighbors import window as win
    from sphax_torch.physics import wengine
    from sphax_torch.physics import window_kernels as wk

    t0 = time.perf_counter()
    fn, (st0,) = entry()
    cfg, dom, spec = fn.cfg, fn.domain, fn.spec
    assert st0.pos.device.type == dev.type, st0.pos.device
    assert st0.pos.dtype == torch.float32 and st0.n == 16 ** 3
    calls = [h.drive("entry first call", lambda: fn(st0),
                     {"solve_h_density": 1, "forces": 1})]

    def eight():
        for _ in range(8):
            calls.append(fn(calls[-1]))
        return calls[-1]
    st9 = h.drive("entry 8 calls", eight, {"solve_h_density": 8,
                                           "forces": 8})
    fields = ("pos", "vel", "u", "h", "rho", "P", "cs", "omega", "divv",
              "acc", "du_dt")
    for k, s in enumerate(calls):
        for f in fields:
            assert bool(torch.isfinite(getattr(s, f)).all()), (k, f)
    ovf = int(wengine.overflow_count(st9, dom, spec))
    assert ovf == 0, f"window overflow {ovf} after 9 entry() calls"

    # one step through the kernels against the same step through plain
    with h.plain_kernels():
        want = fn(st0)
    torch.cuda.synchronize()
    every = torch.ones(st0.n, dtype=torch.bool, device=dev)
    step_err = max(h.compare(getattr(calls[0], f), getattr(want, f), every,
                             3e-5, f"entry step {f}") for f in fields)

    # a warm call: the host's enqueue, the wall, the device time by kind
    s = calls[-1]
    for _ in range(3):
        s = fn(s)
    torch.cuda.synchronize()
    enq, wall = [], []
    for _ in range(20):
        t1 = time.perf_counter()
        s = fn(s)
        enq.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t1)
    enq_ms = sorted(enq)[10] * 1e3
    wall_ms = sorted(wall)[10] * 1e3

    def ten():
        s_ = s
        for _ in range(10):
            s_ = fn(s_)
    by_kind = h.device_ms_by_kind(ten, 10)
    busy = sum(by_kind.values())

    # A and C alone at the call's shapes: CUDA events, plain, bounds
    wd = win.build(s.pos, dom, spec)
    f = sorted_fields(s, wd)
    a_args = [f[k] for k in ("pos_s", "mass_s", "h0_s")]
    c_args = [f[k] for k in ("pos_s", "vel_s", "mass_s", "h_s", "rho_s",
                             "P_s", "cs_s", "om_s", "bf_s")]
    ms_a, got_a = h.cuda_ms(lambda: wk.solve_h_density(
        wd, spec, *a_args, cfg, vel_s=f["vel_s"]), 20)
    pms_a, want_a = h.cuda_ms(lambda: wk.solve_h_density_plain(
        wd, spec, *a_args, cfg, vel_s=f["vel_s"]), 2)
    err_a = max(h.compare(a, b, wd.is_real, 3e-5, f"entry A out{k}")
                for k, (a, b) in enumerate(zip(got_a, want_a)))
    ms_c, got_c = h.cuda_ms(lambda: wk.forces(wd, spec, *c_args, cfg), 20)
    pms_c, want_c = h.cuda_ms(lambda: wk.forces_plain(wd, spec, *c_args,
                                                      cfg), 2)
    err_c = max(h.compare(got_c[0], want_c[0], wd.is_real, 3e-5,
                          "entry C acc"),
                h.compare(got_c[1], want_c[1], wd.is_real, 3e-5,
                          "entry C du"))
    pa, pc, _ = pair_counts(wd, spec, f["pos_s"], f["mass_s"], f["h_s"])
    b_a = kernel_bound("A", spec, f["pos_s"], pa,
                       iters=wk._newton_iters(cfg), bals=True)
    b_c = kernel_bound("C", spec, f["pos_s"], pc, bf=True)
    n_real = int(wd.is_real.sum())
    rec = dict(n=st0.n, n_sorted=spec.n_sorted, wseg=spec.wseg,
               newton_iters=cfg.newton_iters, overflow=ovf,
               step_vs_plain_max_err_over_scale=h.worst("entry step"),
               step_vs_plain_max_abs_err=step_err,
               call_enqueue_ms=enq_ms, call_wall_ms=wall_ms,
               device_ms_per_call_by_kind=by_kind, device_busy_ms=busy,
               seconds=time.perf_counter() - t0)
    log(f"[39 entry] entry() on the card: N={st0.n} fp32, n_sorted "
        f"{spec.n_sorted}, {cfg.newton_iters} Newton updates; 9 calls "
        f"finite, overflow 0, one launch of A and of C a call; a step "
        f"through the kernels vs plain: max abs err {step_err:.3g}, max "
        f"err/scale {rec['step_vs_plain_max_err_over_scale']:.3g} (tol "
        f"3e-5); a warm call {wall_ms:.3f} ms wall, {enq_ms:.3f} ms to "
        f"enqueue, device busy {busy:.3f} ms (A "
        f"{by_kind['kernel A']:.3f}, C {by_kind['kernel C']:.3f}, profiler)"
        f"; A alone {ms_a:.4f} ms (plain {pms_a:.2f}, bound {b_a[0]:.4f} "
        f"{b_a[1]}), C alone {ms_c:.4f} ms (plain {pms_c:.2f}, bound "
        f"{b_c[0]:.4f} {b_c[1]}) (events); pairs inside the support per "
        f"real row A {pa / n_real:.1f}, C {pc / n_real:.1f}; "
        f"{rec['seconds']:.1f} s")
    src = "sphax_torch/csrc/window_kernels.cu"
    rows = [
        {"name": "solve_h_density at entry()'s shapes", "route": "cuda",
         "source": src, "replaces": "sphax/physics/pallas_kernels.py:315",
         "launches": 9, "max_abs_err": err_a, "ms": ms_a, "plain_ms": pms_a,
         "bound_ms": b_a[0], "bound_by": b_a[1], "library_ms": None,
         "n": st0.n, "newton_iters": cfg.newton_iters,
         "pairs_inside_per_row": pa / n_real},
        {"name": "forces at entry()'s shapes", "route": "cuda",
         "source": src, "replaces": "sphax/physics/pallas_kernels.py:563",
         "launches": 9, "max_abs_err": err_c, "ms": ms_c, "plain_ms": pms_c,
         "bound_ms": b_c[0], "bound_by": b_c[1], "library_ms": None,
         "n": st0.n, "pairs_inside_per_row": pc / n_real}]
    return rec, rows


def slow_gates_phase(dev, h):
    """Phase 40: the JAX package's ``slow`` gates with no twin, and the
    Evrard energy gate, at their own sizes in fp64 on the card (through
    kernels A and C where the engine is the window engine). Returns the
    measured values."""
    from sphax_torch import configs, make_state, problems
    from sphax_torch.core.state import box
    from sphax_torch.diag import conservation
    from sphax_torch.ics import sedov as sedov_ics
    from sphax_torch.integrate import rungs
    from sphax_torch.neighbors import window as win
    from sphax_torch.physics import wengine
    from sphax_torch.run import simulate_until

    f64 = dict(dtype=torch.float64, device=dev)
    out = {}

    # tests/unit/test_h_predict.py:175: per-closer predicted h with B = 3
    # rungs tracks the full-Newton rung run
    t0 = time.perf_counter()
    base = dataclasses.replace(configs.SEDOV, newton_iters=6)
    pred = dataclasses.replace(base, h_predict=True, newton_iters=1)
    ic = sedov_ics.build(n_side=10, E=1.0)
    st = make_state(*(torch.as_tensor(ic[k], **f64)
                      for k in ("pos", "vel", "mass", "u", "h")))
    dom = box(torch.zeros(3, **f64), torch.as_tensor(ic["box"], **f64))
    spec = win.plan_measured(st.pos, dom, h_max=float(st.h.max()) * 1.3,
                             dim=3, cutoff_scale=1.25)
    st = wengine.update_derived(st, base, dom, spec)
    runs = {}
    for tag, cfg in (("newton", base), ("h_predict", pred)):
        # the seeding pass of kernel A, then A and C once a tick (8 ticks)
        runs[tag] = h.drive(f"h_predict rungs {tag}",
                            lambda: rungs.simulate_rungs(
                                st, cfg, dom, spec, nspans=2, n_rungs=3,
                                rebuild_every=2),
                            {"solve_h_density": 9, "forces": 8})
    (st_n, _, nact_n, ovf_n, _, _), (st_p, _, _, ovf_p, _, _) = \
        runs["newton"], runs["h_predict"]
    assert int(ovf_n) == 0 and int(ovf_p) == 0
    frac = float(nact_n.sum()) / (st.n * len(nact_n))
    dh = float(((st_p.h - st_n.h).abs() / st_n.h).max())
    drho = float(((st_p.rho - st_n.rho).abs() / st_n.rho).max())
    assert frac < 0.9, f"the blast spread no rungs: active fraction {frac}"
    assert dh < 3e-3, f"h drift vs full-Newton rungs: {dh}"
    assert drho < 1e-2, f"rho drift vs full-Newton rungs: {drho}"
    out["h_predict_rungs"] = dict(n=st.n, active_frac=frac, h_drift=dh,
                                  rho_drift=drho,
                                  seconds=time.perf_counter() - t0)
    log(f"[40 slow gates] h_predict B=3 (sedov n_side=10, fp64, 2 spans): "
        f"active fraction {frac:.4f} (< 0.9), max rel dh {dh:.3g} "
        f"(< 3e-3), drho {drho:.3g} (< 1e-2), overflow 0; "
        f"{out['h_predict_rungs']['seconds']:.1f} s")

    # tests/problems/test_sedov.py:45: the Morris-Monaghan alpha(t) switch
    # switches on at the front and stays near its floor outside
    t0 = time.perf_counter()

    def mm_run():
        prob = problems.sedov(n=16, visc="mm", dtype=torch.float64,
                              device=dev)
        assert prob.cfg.mm_visc and not prob.cfg.balsara
        assert prob.engine_name == "window", prob.engine_name
        assert float(prob.state.alpha.max()) <= prob.cfg.mm_alpha_min * 1.001
        e0 = float(conservation.total_energy(prob.state, prob.cfg))
        st_, _, t_, n_ = simulate_until(prob.state, prob.cfg, prob.domain,
                                        prob.engine, t_end=0.02, chunk=16,
                                        max_steps=1500)
        return prob, st_, t_, n_, e0
    prob, st_m, t_m, n_m, e0 = h.drive(
        "sedov mm gate", mm_run,
        lambda o: {"solve_h_density": 1 + o[3], "forces": 1 + o[3]})
    a_min = prob.cfg.mm_alpha_min
    assert bool(torch.isfinite(st_m.rho).all())
    a_max = float(st_m.alpha.max())
    a_p20 = float(torch.quantile(st_m.alpha, 0.2))
    de = abs(float(conservation.total_energy(st_m, prob.cfg)) - e0) / abs(e0)
    assert a_max > 3.0 * a_min, a_max
    assert a_p20 < 2.0 * a_min, a_p20
    assert de < 0.05, de
    out["sedov_mm"] = dict(n=st_m.n, steps=n_m, t=t_m, alpha_max=a_max,
                           alpha_p20=a_p20, alpha_min=a_min,
                           energy_drift=de,
                           seconds=time.perf_counter() - t0)
    log(f"[40 slow gates] Sedov Morris-Monaghan (n=16, fp64, window "
        f"engine): {n_m} steps to t={t_m:.4f}; max alpha {a_max:.4g} "
        f"(> {3 * a_min:.3g}), 20th percentile {a_p20:.4g} "
        f"(< {2 * a_min:.3g}), energy drift {de:.3g} (< 0.05); "
        f"{out['sedov_mm']['seconds']:.1f} s")

    # tests/problems/test_evrard.py:12 (a minute a CPU thread, so here):
    # the collapse through the dense engine conserves energy
    t0 = time.perf_counter()

    def evrard_run():
        prob = problems.evrard(n=1024, dtype=torch.float64, device=dev)
        r0 = prob.state.pos.norm(dim=-1).median()
        e0 = float(conservation.total_energy(prob.state, prob.cfg))
        st_, _, t_, n_ = simulate_until(prob.state, prob.cfg, prob.domain,
                                        prob.engine, t_end=0.5, chunk=32,
                                        max_steps=4000)
        return prob, st_, t_, n_, e0, float(r0)
    # the dense engine: no hand kernel
    prob, st_e, t_e, n_e, e0, r0 = h.drive("evrard gate", evrard_run, {})
    assert e0 < 0  # a bound cloud
    assert bool(torch.isfinite(st_e.rho).all())
    ek = float(conservation.kinetic_energy(st_e))
    drift = abs(float(conservation.total_energy(st_e, prob.cfg)) - e0) / abs(
        e0)
    r1 = float(st_e.pos.norm(dim=-1).median())
    assert ek > 1e-3, ek
    assert drift < 5e-3, f"energy drift {drift}"
    assert r1 < r0, (r1, r0)
    out["evrard"] = dict(n=st_e.n, steps=n_e, t=t_e, e_kin=ek,
                         energy_drift=drift, median_r=[r0, r1],
                         seconds=time.perf_counter() - t0)
    log(f"[40 slow gates] Evrard (n=1024, fp64, dense engine): {n_e} steps "
        f"to t={t_e:.4f}; energy drift {drift:.3g} (< 5e-3), kinetic "
        f"energy {ek:.4g} (> 1e-3), median radius {r0:.4f} -> {r1:.4f}; "
        f"{out['evrard']['seconds']:.1f} s")
    return out


def sanitize_phase(dev):
    """Phase 41: every hand kernel's small launches (``sphax_torch.sanitize``)
    in this process, each again over NaN-filled free memory; then under
    compute-sanitizer's memcheck, racecheck and synccheck, each in a
    subprocess. Fails where a poisoned launch differs or the tool reports
    an error after a case; says so where the tool is absent or refuses the
    device. Returns the record."""
    from sphax_torch import sanitize

    t0 = time.perf_counter()
    names = sanitize.launch_all(dev, poison=True)
    rec = {"cases": len(names), "poisoned_free_memory": "bitwise equal"}
    log(f"[41 sanitize] {len(names)} cases, each launch over NaN-filled "
        f"free memory finite and bitwise equal to the first: "
        f"{time.perf_counter() - t0:.1f} s")
    path, where = sanitize.sanitizer_path()
    if path is None:
        rec.update(present=False, looked_in=where,
                   seconds=time.perf_counter() - t0)
        log(f"[41 sanitize] {len(names)} cases launched; compute-sanitizer "
            f"is not on this machine (looked in {', '.join(where)}): no "
            f"tool ran")
        return rec
    rec.update(present=True, path=path, version=sanitize.version(path),
               tools={})
    for tool in sanitize.TOOLS:
        r = sanitize.check(tool, path)
        rec["tools"][tool] = {k: r[k] for k in ("rc", "seconds", "cases",
                                                 "errors", "refused",
                                                 "summary")}
        log(f"[41 sanitize] {rec['version']} --tool {tool}: exit {r['rc']},"
            f" {r['cases']} of {len(names)} cases reached, "
            f"{r['seconds']:.1f} s; " + (
                f"the tool refused before any case ran: {r['refused']} "
                f"({r['summary']}): no result" if r["refused"] else
                r["summary"]))
        if r["errors"] or (not r["refused"] and r["rc"] != 0):
            log(r["output"])
            raise AssertionError(
                f"compute-sanitizer --tool {tool} reported errors after "
                f"the cases {r['errors'] or '(none reached)'}")
    rec.update(ran=[t for t, v in rec["tools"].items() if not v["refused"]],
               seconds=time.perf_counter() - t0)
    return rec


def clist_phase(dev, h):
    """Phase 42: the cell-list engine at N = 1e6 against the window engine
    through kernels A and C on the same state (fp32), its warm pass, block
    and peak memory; then ``sod n=64`` through the CLI on the cell list,
    beside the dense engine's steps. Returns the record."""
    from sphax_torch import bench, configs, problems
    from sphax_torch import run as run_mod
    from sphax_torch.__main__ import main as cli
    from sphax_torch.neighbors.cell_list import choose_grid
    from sphax_torch.physics import clist, wengine

    t_phase = time.perf_counter()
    cfg = configs.TURB
    st, dom, spec = bench.setup(100, cfg, dev, vel_scale=0.3, h_margin=1.3,
                                cutoff_scale=1.25, fast_sub=3, rgroups=2)
    grid = choose_grid(dom, float(st.h.max()) * 1.3, st.n)
    block = clist.default_cell_block(grid, 3, dev)
    want = h.drive("clist: window pass", lambda: wengine.update_derived(
        st, cfg, dom, spec), {"solve_h_density": 1, "forces": 1})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    got = h.drive("clist", lambda: clist.update_derived(
        st, cfg, dom, grid, cell_block=block), {})
    cold = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    every = torch.ones(st.n, dtype=torch.bool, device=dev)
    e = max(h.compare(getattr(got, k), getattr(want, k), every, 3e-5,
                      f"clist {k}")
            for k in ("h", "rho", "P", "omega", "divv", "acc", "du_dt"))
    ovf = int(clist.overflow_count(st, dom, grid))
    hsat = int(clist.h_saturation_count(got, dom, grid))
    assert ovf == 0 and hsat == 0, (ovf, hsat)
    ms, _ = h.cuda_ms(lambda: clist.update_derived(st, cfg, dom, grid,
                                                   cell_block=block), 1)
    ms_w, _ = h.cuda_ms(lambda: wengine.update_derived(st, cfg, dom, spec),
                        3)
    used = int((clist.cl_mod.build(st.pos, dom, grid).table < st.n)
               .sum(1).max())
    pairs = grid.ncells * used * len(grid.offsets()) * used
    rec = {"n": st.n, "grid": list(grid.res), "capacity": grid.capacity,
           "fullest_cell": used, "candidate_pairs_per_pass": pairs,
           "cell_block": block, "blocks_per_pass": -(-grid.ncells // block),
           "pass_ms": ms, "cold_pass_s": cold, "peak_gib": peak,
           "window_pass_ms": ms_w, "max_err_over_scale": h.worst("clist"),
           "overflow": ovf, "h_saturated": hsat}
    log(f"[42 clist] N={st.n} grid {grid.res} capacity {grid.capacity}, "
        f"fullest cell {used}, {pairs:.3g} candidate pairs a pass; blocks of"
        f" {block} cells: a warm pass {ms:.1f} ms (cold {cold:.2f} s), peak "
        f"{peak:.2f} GiB above the inputs; the window engine's pass through "
        f"A and C {ms_w:.2f} ms; fields within {rec['max_err_over_scale']:.3g}"
        f" of it (max abs err {e:.3g}, tol 3e-5); overflow 0, h saturation 0")
    del got, want, st

    out = h.fresh(os.path.join("build", "smoke", "sod64"))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        st_s, _, step_s = h.drive("sod n=64 clist", lambda: cli(
            ["sod", "n=64", "max_steps=16", "chunk=8", f"out={out}"]), {})
    wall_s = time.perf_counter() - t0
    text = buf.getvalue()
    print(text, end="", flush=True)
    recs = h.records(out)
    assert "engine=clist" in text and step_s == 16, text
    assert all(r["finite"] for r in recs), recs
    for f_ in ("pos", "vel", "h", "rho", "acc"):
        assert bool(torch.isfinite(getattr(st_s, f_)).all()), f_
    # the warm chunk's rate (steps 9-16) of the CLI's own clock
    clist_step = st_s.n / recs[1]["particle_steps_per_sec"] * 1e3
    prob = problems.sod(n=64, device=dev)
    assert prob.engine_name == "clist", prob.engine_name
    eng_d = problems._dense_engine(prob.cfg, prob.domain)
    st_d, steps_d = prob.state, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # 8 steps (16 take about 40 s there): the rate, not the run, is compared
    while steps_d < 8 and time.perf_counter() - t0 < 60.0:
        st_d, _, _ = run_mod.simulate(st_d, prob.cfg, prob.domain, eng_d, 2)
        torch.cuda.synchronize()
        steps_d += 2
    dense_step = (time.perf_counter() - t0) / steps_d * 1e3
    assert bool(torch.isfinite(st_d.rho).all())
    rec.update(sod={"n": st_s.n, "grid": list(prob.grid.res),
                    "cli_16_steps_s": wall_s, "clist_ms_per_step": clist_step,
                    "dense_ms_per_step": dense_step, "dense_steps": steps_d},
               seconds=time.perf_counter() - t_phase)
    log(f"[42 clist] sod n=64 (N={st_s.n}, grid {prob.grid.res}) through "
        f"the CLI: engine=clist, 16 steps in {wall_s:.2f} s with set-up, "
        f"{clist_step:.1f} ms a warm step (the CLI's record); the dense "
        f"engine {dense_step:.1f} ms a step over {steps_d} steps "
        f"(run.simulate)")
    return rec


def eq_slab_rank(c, jobs):
    """Phase 43's ranks: ``tests/_slab_helpers.eq_slab_lockstep`` on each
    job in turn (one launch of the ranks for both). Rank 0 returns the
    records."""
    from tests._slab_helpers import eq_slab_lockstep

    out = [eq_slab_lockstep(c, *job) for job in jobs]
    return out if c.rank == 0 else None


def eq_slab_phase(dev, h):
    """Phase 43: the equal-extent slabs (``dist.slab``) on 2 ranks sharing
    the card over gloo: fp64 in lockstep with the single-device cell list
    for 2 steps (1e-10), then the N = 1e6 lattice in fp32 for 1 step.
    Returns the record."""
    import numpy as np

    from sphax_torch import bench, configs, convert
    from sphax_torch.dist import comm, slab
    from sphax_torch.integrate import leapfrog
    from sphax_torch.neighbors.cell_list import choose_grid
    from sphax_torch.physics import clist

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.TURB, newton_iters=2)
    jobs, refs = [], {}
    for tag, n_side, dtype, nsteps in (("fp64", 24, torch.float64, 2),
                                       ("fp32 N=1e6", 100, torch.float32, 1)):
        st, dom, _ = bench.setup(n_side, cfg, dev, dtype=dtype,
                                 vel_scale=0.3, h_margin=1.3,
                                 cutoff_scale=1.25, fast_sub=3, rgroups=2)
        spec = slab.plan(dom, st.n, float(st.h.max()) * 1.1, 2)
        shards = [convert.state_to_numpy(slab.distribute(st, dom, spec, r))
                  for r in range(2)]
        rows = {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}
        jobs.append((rows, (dom.lo.cpu().numpy(), dom.hi.cpu().numpy(),
                            dom.periodic), cfg, spec, [("step",)] * nsteps,
                     dtype))
        refs[tag] = (st, dom, spec)
    # the single-device cell list's 2 steps, fp64
    st, dom, _ = refs["fp64"]
    grid = choose_grid(dom, float(st.h.max()) * 1.3, st.n)

    def engine(s):
        return clist.update_derived(s, cfg, dom, grid)
    ref, dts = st, []
    for _ in range(2):
        ref, dt = leapfrog.step(ref, cfg, dom, engine, wrap=False)
        dts.append(float(dt))
    t0 = time.perf_counter()
    # the two ranks share the card with this process
    torch.cuda.empty_cache()
    out = comm.launch(eq_slab_rank, 2, dev, "gloo", timeout=600,
                      deadline=900, args=(jobs,))
    wall = time.perf_counter() - t0
    rec = {"launch_s": wall}
    for (tag, (st_t, _, spec)), recs in zip(refs.items(), out):
        health = [r["health"].tolist() for r in recs]
        assert not any(np.any(r["health"]) for r in recs), (tag, health)
        got = recs[-1]["real"]
        assert got["pos"].shape[0] == st_t.n, (tag, got["pos"].shape)
        assert np.isfinite(got["rho"]).all(), tag
        rec[tag] = {"n": st_t.n, "grid": list(spec.grid.res),
                    "n_local": spec.n_local, "ghost_cap": spec.ghost_cap,
                    "step_s": [r["seconds"] for r in recs],
                    "dts": np.concatenate([r["dts"] for r in recs]).tolist()}
    got = out[0][-1]["real"]
    gd = np.concatenate([r["dts"] for r in out[0]])
    err_dt = float(np.abs(gd - dts).max() / max(dts))
    assert err_dt <= 1e-10, err_dt

    def order(p):
        p = np.mod(p, 1.0)
        return np.lexsort((p[:, 2], p[:, 1], p[:, 0]))
    oi, oj = order(got["pos"]), order(ref.pos.cpu().numpy())
    errs = {}
    for k in ("pos", "vel", "u", "h", "rho", "P", "acc", "du_dt"):
        b = getattr(ref, k).cpu().numpy()[oj]
        a = got[k][oi]
        scale = np.abs(b).max()
        errs[k] = float(np.abs(a - b).max() / scale)
        assert np.all(np.abs(a - b) <= 1e-10 * np.abs(b) + 1e-10 * scale), (
            k, errs[k])
    rec["fp64"].update(max_err_over_scale=errs, dt_rel_err=err_dt)
    rec["seconds"] = time.perf_counter() - t_phase
    big = rec["fp32 N=1e6"]
    log(f"[43 eq slab] 2 ranks on the card (gloo), one launch {wall:.1f} s: "
        f"fp64 N={rec['fp64']['n']} 2 steps against the single-device cell "
        f"list, worst field {max(errs.values()):.3g} of its scale, dts "
        f"{err_dt:.3g} (tol 1e-10), health 0; fp32 N={big['n']} (grid "
        f"{big['grid']}, n_local {big['n_local']}, ghost_cap "
        f"{big['ghost_cap']}): 1 step of {big['step_s'][0]:.2f} s (rank 0's "
        f"wall, both ranks sharing the card), no particle lost, density "
        f"finite, health 0")
    return rec


def sorted_mesh_phase(dev, h):
    """Phase 44: the sorted-order P3M mesh at N = 1e6, M = 128 against the
    scatter mesh on the bench lattice's sorted rows (fp32 3e-5, fp64
    1e-10), its fallback counts and both times; the CLI's P3M run with
    ``mesh_fb`` in its records. Returns the record."""
    from sphax_torch import bench, configs, convert
    from sphax_torch.__main__ import main as cli
    from sphax_torch.neighbors import window as win
    from sphax_torch.physics import pm, pm_sorted

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.TURB, newton_iters=2, gravity=True,
                              grav_solver="p3m", grav_mesh=128)
    st, dom, spec = bench.setup(100, cfg, dev, vel_scale=0.3, h_margin=1.3,
                                cutoff_scale=1.25, fast_sub=3, rgroups=2)
    plan = pm_sorted.plan_mesh(spec, 128)
    rec = {"n": st.n, "mesh": 128, "plan": dataclasses.asdict(plan)}
    tol = {torch.float32: 3e-5, torch.float64: 1e-10}
    for dtype in (torch.float32, torch.float64):
        tag = "fp32" if dtype == torch.float32 else "fp64"
        d = convert.domain_from_numpy(dom.lo.cpu().numpy(),
                                      dom.hi.cpu().numpy(), dom.periodic,
                                      dev, dtype)
        pos, mass = st.pos.to(dtype), st.mass.to(dtype)
        wd = win.build(pos, d, spec)
        mass_s = win.gather_sorted(mass, wd)
        rs = pm.rs_traced(cfg, d, dtype, cutoff=spec.cutoff)
        ms_s, (acc_s, drop) = h.cuda_ms(lambda: pm.mesh_accel_sorted(
            wd.pos_s, mass_s, wd.is_real, cfg, d, plan, rs=rs), 5)
        ms_m, acc = h.cuda_ms(lambda: pm.mesh_accel(pos, mass, cfg, d,
                                                    rs=rs), 5)
        every = torch.ones(st.n, dtype=torch.bool, device=dev)
        e = h.compare(acc_s[wd.inv], acc, every, tol[dtype],
                      f"sorted mesh {tag}")
        n_fb, n_drop = pm_sorted.fallback_stats(
            wd.pos_s, wd.is_real & (mass_s > 0), d, 128, True, plan)
        assert int(drop) == 0 and int(n_drop) == 0, (int(drop), int(n_drop))
        rec[tag] = {"sorted_ms": ms_s, "scatter_ms": ms_m,
                    "max_abs_err": e,
                    "max_err_over_scale": h.worst(f"sorted mesh {tag}"),
                    "fallback_rows": int(n_fb), "dropped": int(n_drop)}
        log(f"[44 sorted mesh] {tag} N={st.n} M=128, {plan}: "
            f"mesh_accel_sorted {ms_s:.2f} ms, mesh_accel (scatter) "
            f"{ms_m:.2f} ms a call (events, back to back); within "
            f"{rec[tag]['max_err_over_scale']:.3g} of the scatter mesh (tol "
            f"{tol[dtype]}); {int(n_fb)} fallback rows, dropped 0")
        del acc_s, acc, wd, mass_s

    out = h.fresh(os.path.join("build", "smoke", "p3m_mesh_fb"))
    t0 = time.perf_counter()
    h.drive("p3m CLI mesh_fb", lambda: cli(
        ["turb", "n=100", "gravity=1", "grav_solver=p3m", "grav_mesh=128",
         "max_steps=4", "chunk=4", f"out={out}"]),
        # 5 derived passes, and the P3M potential of the start's energy
        # and of the record
        {"solve_h_density": 5, "forces_grav": 5, "cic_deposit": 7,
         "cic_interp": 7})
    wall = time.perf_counter() - t0
    recs = h.records(out)
    assert all(r["finite"] for r in recs), recs
    assert "mesh_fb" in recs[0] and recs[0]["step"] == 4, recs[0]
    rec["cli"] = {"mesh_fb": recs[0]["mesh_fb"], "seconds": wall}
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[44 sorted mesh] the CLI's turb n=100 P3M (the scatter mesh), 4 "
        f"steps in {wall:.2f} s: mesh_fb {recs[0]['mesh_fb']} in its record")
    return rec


# the slab lockstep's configurations (phase 30): the main path's, and
# tests/dist/test_wslab.py's Morris-Monaghan alpha(t)
def _slab_cfgs():
    from sphax_torch import configs
    return {"turb": configs.TURB,
            "mm_visc": configs.SPHConfig(dim=3, adaptive_h=True,
                                         mm_visc=True, newton_iters=8)}


def span_closers(c, st, cfg, n_rungs, tick):
    """This rank's closers at ``tick`` of a span of block timesteps that
    starts from ``st``: the rungs as ``wrungs.chunk_rungs`` assigns them at
    the span's start (dt_min a MIN all-reduce: every rank must call it)."""
    from sphax_torch.integrate.rungs import _rung_of
    from sphax_torch.integrate.timestep import particle_dt

    real = st.mass > 0
    dt = torch.where(real, particle_dt(st, cfg), cfg.dt_max)
    rung = _rung_of(dt, c.all_reduce_min(dt.amin()), n_rungs)
    period = torch.bitwise_left_shift(torch.ones_like(rung), rung) - 1
    return real & (torch.bitwise_and(period, tick + 1) == 0)


def shard_kernel_check(c, st, cuts, dom, cfg, spec, tol, reps=0, n_rungs=0,
                       tick=0, quiet=False):
    """Every rank: one derived pass of its shard (a slab's, or with a
    PencilSpec and ``cuts`` = (cuts0, cuts1) a pencil's) that records
    kernel A's and C's arguments (``tests/_slab_helpers.kernel_calls``;
    under P3M, C in its gravity mode); with
    ``n_rungs``, the rung pass on the structure masked to the closers of
    ``tick`` of a span starting from ``st`` (``span_closers``), or with
    ``quiet`` to none on rank 0, as on a tick whose closers all lie in the
    other slabs. Rank 0 then
    holds each kernel against its plain version on its own real rows at
    ``tol`` (rtol, and atol ``tol`` of the largest value), finite on every
    row; where it has no closer, both give h0 and zeros on every row. With
    ``reps`` > 0 it times both and counts the pairs and the bound.
    Returns rank 0's record (None on the others)."""
    from sphax_torch.physics import window_kernels as wk
    from tests._slab_helpers import kernel_calls

    close_m = span_closers(c, st, cfg, n_rungs, tick) if n_rungs else None
    if quiet and c.rank == 0:
        close_m = torch.zeros_like(close_m)
    calls, own = kernel_calls(c, st, cuts, dom, cfg, spec, close_m)
    if c.rank != 0:
        return None
    out = {}
    quiet = close_m is not None and not bool(close_m.any())
    wspec = spec.wspec
    for which, fn, plain in (("A", wk.solve_h_density,
                              wk.solve_h_density_plain),
                             ("C", wk.forces, wk.forces_plain)):
        a, k = calls[which]
        got, want = fn(*a, **k), plain(*a, **k)
        if quiet:
            # every group masked: h0 and zeros from both
            for x, y in zip(got[1:] if which == "A" else got,
                            want[1:] if which == "A" else want):
                assert not bool(x.any() | y.any()), which
            if which == "A":
                assert torch.equal(got[0], a[4]) and torch.equal(want[0],
                                                                 a[4])
        err = rel = 0.0
        for x, y in zip(got, want):
            assert bool(torch.isfinite(x).all()), f"{which}: non-finite"
            x, y = x[own].double(), y[own].double()
            scale = float(y.abs().max())
            bad = (x - y).abs() > tol * y.abs() + tol * scale
            assert not bool(bad.any()), (which, int(bad.sum()))
            err = max(err, float((x - y).abs().max()))
            if scale:
                rel = max(rel, float((x - y).abs().max()) / scale)
        rec = {"max_abs_err": err, "max_err_over_scale": rel}
        if reps:
            a_ = torch.cuda.Event(enable_timing=True)
            b_ = torch.cuda.Event(enable_timing=True)
            for tag, f_, n_ in (("ms", fn, reps), ("plain_ms", plain, 1)):
                f_(*a, **k)
                torch.cuda.synchronize()
                a_.record()
                for _ in range(n_):
                    f_(*a, **k)
                b_.record()
                torch.cuda.synchronize()
                rec[tag] = a_.elapsed_time(b_) / n_
            wd = a[0]
            pos_s = a[2]
            mass_s = a[3] if which == "A" else a[4]
            h_s = a[4] if which == "A" else a[5]
            grav = which == "C" and k.get("grav") is not None
            pairs = pair_counts(wd._replace(is_real=own), wspec, pos_s,
                                mass_s, h_s,
                                cutoff=wspec.cutoff if grav else None)
            n_pairs = pairs[0] if which == "A" else pairs[1]
            rec["pairs_per_row"] = n_pairs / max(int(own.sum()), 1)
            if grav:
                rec["grav_pairs_per_row"] = pairs[2] / max(int(own.sum()), 1)
            rec["bound_ms"], rec["bound_by"] = kernel_bound(
                which, wspec, pos_s, n_pairs,
                iters=wk._newton_iters(cfg), bals=bool(cfg.need_divv),
                bf=bool(cfg.visc_factor_on), masked=wd,
                grav_pairs=pairs[2] if grav else 0)
        out[which] = rec
    wd = calls["A"][0][0]
    out["own_rows"] = int(own.sum())
    out["n_sorted"] = wspec.n_sorted
    out["active_group_share"] = float(
        wk._group_active(wd, wspec).double().mean())
    if close_m is not None:
        out["closers"] = int(close_m.sum())
    return out


def rung_lockstep_rank(c, rows, domain, cfg, spec, cuts, ops, n_side):
    """Phase 33 on one rank: ``jittered_checks`` of kernels A and C on rank
    0's shard structure masked to the closers of a span's first tick, and
    to none; then ``tests/_slab_helpers.lockstep``'s ops in fp64 from the
    rows as given. Rank 0 returns (records, its kernel records)."""
    from tests._slab_helpers import lockstep

    kchk = jittered_checks(c, rows, domain, cfg, spec, cuts, n_side, 3,
                           seed=33)
    recs = lockstep(c, rows, domain, cfg, spec, cuts, ops, None, True)
    return (recs, kchk) if c.rank == 0 else None


def rung_shapes_rank(c, spec, cuts, n_real, rows):
    """Phase 34's kernel shapes: the CLI's ``sedov`` set-up of a resume on
    this rank with rungs=4 (its rows of the split checkpoint state,
    ``SlabRun``), then ``shard_kernel_check`` with times and bounds on the
    structure masked to the first tick's closers."""
    from sphax_torch import configs, convert
    from sphax_torch.dist.runner import SlabRun

    cfg = configs.SEDOV                                   # problems.sedov
    dom = convert.domain_from_numpy([0.0] * 3, [1.0] * 3, True,
                                    device=c.device, dtype=torch.float32)
    run = SlabRun(c, convert.state_from_numpy(rows, c.device, torch.float32),
                  spec, cuts, n_real, cfg, dom, n_rungs=4)
    return shard_kernel_check(c, run.state, run.cuts, dom, cfg, run.spec,
                              3e-5, reps=10, n_rungs=4)


def slab_lockstep_rank(c, rows, domain, cfg, spec, cuts, ops, check):
    """Phase 30 on one rank: with ``check``, kernels A and C on rank 0's
    shard structure against plain (fp32 3e-5, fp64 1e-10); then
    ``tests/_slab_helpers.lockstep``'s ops in fp64. Rank 0 returns
    (records, kernel errors)."""
    from sphax_torch import convert
    from sphax_torch.dist import wslab
    from tests._slab_helpers import lockstep

    kerr = {}
    if check:
        for dtype, tol in ((torch.float32, 3e-5), (torch.float64, 1e-10)):
            st = convert.shard_from_numpy(rows, spec, c.rank, c.device,
                                          dtype)
            dom = convert.domain_from_numpy(*domain, device=c.device,
                                            dtype=dtype)
            sp = wslab.refine_wseg(spec, wslab.max_run(c, st, cuts, dom,
                                                       spec)[0])
            rec = shard_kernel_check(c, st, cuts, dom, cfg, sp, tol)
            if rec is not None:
                for k in ("A", "C"):
                    kerr[f"{k} {str(dtype)[6:]}"] = rec[k][
                        "max_err_over_scale"]
    recs = lockstep(c, rows, domain, cfg, spec, cuts, ops,
                           None, True)
    return (recs, kerr) if c.rank == 0 else None


def slab_shapes_rank(c, spec, cuts, n_real, rows):
    """Phase 31's kernel shapes: the CLI's ``turb`` set-up of a resume on
    this rank (its rows of the split checkpoint state, ``SlabRun``), then
    ``shard_kernel_check`` with times and bounds."""
    import dataclasses

    from sphax_torch import configs, convert
    from sphax_torch.dist.runner import SlabRun

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.TURB, newton_iters=2)  # problems.turb
    dom = convert.domain_from_numpy([0.0] * 3, [1.0] * 3, True,
                                    device=c.device, dtype=torch.float32)
    run = SlabRun(c, convert.state_from_numpy(rows, c.device, torch.float32),
                  spec, cuts, n_real, cfg, dom)
    return shard_kernel_check(c, run.state, run.cuts, dom, cfg, run.spec,
                              3e-5, reps=10)


def jittered_checks(c, rows, domain, cfg, spec, cuts, n_side, n_rungs=0,
                    seed=35):
    """Kernels A and C on rank 0's shard structure (a slab's, or with a
    PencilSpec a pencil's) against plain, fp32 3e-5 and fp64 1e-10, on the
    shard's real rows jittered by a seeded 0.2 of a spacing with a seeded
    0.4 N(0,1) velocity (on the resting lattice d rho/d h cancels and the
    Balsara sums vanish, as in phase 22); with ``n_rungs``, on the
    structure masked to the closers of a span's first tick and to none.
    Every rank calls it; rank 0's records come back."""
    from sphax_torch import convert
    from sphax_torch.dist import pencil, wslab

    pen = isinstance(spec, pencil.PencilSpec)
    if pen:
        c.grid(spec.ns0, spec.ns1)
    out = {}
    for dtype, tol in ((torch.float32, 3e-5), (torch.float64, 1e-10)):
        st = convert.shard_from_numpy(rows, spec, c.rank, c.device, dtype)
        gen = torch.Generator(device=c.device).manual_seed(seed + c.rank)
        real = (st.mass > 0)[:, None]
        jit = (0.2 / n_side) * (2.0 * torch.rand(
            st.pos.shape, generator=gen, dtype=dtype, device=c.device) - 1.0)
        vel = 0.4 * torch.randn(st.vel.shape, generator=gen, dtype=dtype,
                                device=c.device)
        st = st._replace(pos=torch.where(real, st.pos + jit, st.pos),
                         vel=torch.where(real, vel, st.vel))
        dom = convert.domain_from_numpy(*domain, device=c.device,
                                        dtype=dtype)
        mr = (pencil.max_run(c, st, *cuts, dom, spec) if pen
              else wslab.max_run(c, st, cuts, dom, spec))[0]
        sp = wslab.refine_wseg(spec, mr)
        for quiet in ((False, True) if n_rungs else (False,)):
            rec = shard_kernel_check(c, st, cuts, dom, cfg, sp, tol,
                                     n_rungs=n_rungs, quiet=quiet)
            if rec is not None:
                out[f"{str(dtype)[6:]}"
                    + (f" {'none' if quiet else 'tick 0'}" if n_rungs
                       else "")] = rec
    return out


def pencil_lockstep_rank(c, jobs):
    """Phases 35 and 38 on one rank, for each job (rows, domain, cfg, spec,
    cuts, ops, n_side, n_rungs, check): with ``check``,
    ``jittered_checks``; then ``tests/_slab_helpers.pencil_lockstep``'s
    ops in fp64 from the rows as given. Rank 0 returns [(records, its
    kernel records)] a job."""
    from tests._slab_helpers import pencil_lockstep

    out = []
    for rows, domain, cfg, spec, cuts, ops, n_side, n_rungs, check in jobs:
        kchk = (jittered_checks(c, rows, domain, cfg, spec, cuts, n_side,
                                n_rungs) if check else {})
        out.append((pencil_lockstep(c, rows, domain, cfg, spec, cuts, ops,
                                    None, True), kchk))
    return out if c.rank == 0 else None


def pencil_shapes_rank(c, jobs, rows_list):
    """Phases 36-38's kernel shapes, for each job (spec, cuts, n_real, cfg,
    n_rungs, fp64) and this rank's rows of it: the CLI's set-up of a resume
    on this rank (its rows of the split checkpoint state, ``PencilRun``),
    then ``shard_kernel_check`` in fp32 with times and bounds (and with
    ``fp64`` again in fp64, at 1e-10); with rungs on the structure masked
    to a span's first tick's closers. Under gravity also the total
    momentum of one derived pass, over the ranks. Rank 0 returns its
    records, a job each."""
    from sphax_torch import convert
    from sphax_torch.dist import pencil
    from sphax_torch.dist.runner import PencilRun

    torch.backends.cuda.matmul.allow_tf32 = False
    recs = []
    for (spec, cuts, n_real, cfg, n_rungs, fp64), rows in zip(jobs,
                                                              rows_list):
        out = {}
        for dtype, tol, reps in ((torch.float32, 3e-5, 10),
                                 (torch.float64, 1e-10, 0))[:1 + bool(fp64)]:
            dom = convert.domain_from_numpy([0.0] * 3, [1.0] * 3, True,
                                            device=c.device, dtype=dtype)
            run = PencilRun(c, convert.state_from_numpy(rows, c.device,
                                                        dtype),
                            spec, cuts, n_real, cfg, dom, n_rungs=n_rungs)
            rec = shard_kernel_check(c, run.state, run.cuts, dom, cfg,
                                     run.spec, tol, reps=reps,
                                     n_rungs=n_rungs)
            if dtype == torch.float32:
                out = rec
                if cfg.gravity:
                    st = run.state._replace(pos=pencil._wrap_other(
                        run.state.pos, dom))
                    wd, *built, _ = pencil._exchange_and_build(
                        c, st, *run.cuts, dom, run.spec)
                    s2 = pencil._local_derived(c, st, wd, *built, cfg, dom,
                                               run.spec)
                    ma = (s2.mass[:, None] * s2.acc).double()
                    tot = c.all_reduce_sum(torch.cat([ma.sum(0),
                                                      ma.abs().sum(0)]))
                    if rec is not None:
                        rec["momentum_over_sum_abs"] = float(
                            (tot[:3].abs() / tot[3:]).max())
            elif rec is not None:
                out["fp64"] = {w: rec[w]["max_err_over_scale"] for w in "AC"}
            del run
        recs.append(out)
    return recs if c.rank == 0 else None


def staged_per_step(spec, dim, itemsize, steps, rebuild_every, ranks):
    """The bytes a pencil chunk stages through the host on a card under
    gloo, predicted from the plan: every message copied out and in. A
    step ships kinematics (2 dim + 1 columns) over both hops and the
    phase-2 hydro (6 columns) back; a build ships the x kinematics twice
    more (to place the combined rows that the y faces select from, then
    for the structure) and the y kinematics once more; the dt's MIN is
    one value a step and the health's SUM two int64 a chunk."""
    x, y = 2 * spec.ghost_cap0, 2 * spec.ghost_cap1
    kin = (2 * dim + 1) * itemsize
    step = (x + y) * (kin + 6 * itemsize) + itemsize
    build = (2 * x + y) * kin
    per_rank = steps * step + steps // rebuild_every * build + 16
    return 2 * ranks * per_rank / steps


def slab_compare(rec, ref, tol, tag):
    """Max err/scale of a lockstep record's real rows against a
    single-device state, positions wrapped into the unit box; asserts
    ``tol`` (rtol, and atol ``tol`` of the largest value)."""
    import numpy as np

    real = rec["rows"]["mass"] > 0
    got = {k: v[real] for k, v in rec["rows"].items()}
    pa = np.mod(got["pos"], 1.0)
    pb = np.mod(ref.pos.cpu().numpy(), 1.0)
    oi = np.lexsort((pa[:, 2], pa[:, 1], pa[:, 0]))
    oj = np.lexsort((pb[:, 2], pb[:, 1], pb[:, 0]))
    errs = {}
    for k, a, b in [("pos", pa[oi], pb[oj])] + [
            (k, got[k][oi], getattr(ref, k).cpu().numpy()[oj])
            for k in ("vel", "u", "h", "rho", "P", "acc", "alpha", "divv")]:
        scale = float(np.abs(b).max()) or 1.0
        bad = np.abs(a - b) > tol * np.abs(b) + tol * scale
        assert not bad.any(), (tag, k, int(bad.sum()))
        errs[f"{k}@{tag}"] = float(np.abs(a - b).max()) / scale
    return {k: v for k, v in errs.items() if k.split("@")[0] in
            ("pos", "h", "rho", "acc")}


def pair_counts(wd, spec, pos_s, mass_s, h_s, cutoff=None):
    """Over real rows, each row's candidates counted once: the pairs inside
    2 h_i (whose terms kernel A computes), inside 2 max(h_i, h_j) (kernel
    C), and with 0 < r <= cutoff (kernel C's gravity mode)."""
    from sphax_torch.physics.wengine import _tile_pass

    def kfn(own, winf):
        (pos_i, m_i, h_i), (pos_j, m_j, h_j) = own, winf
        r2 = torch.zeros(pos_i.shape[:2] + pos_j.shape[1:2],
                         dtype=pos_i.dtype, device=pos_i.device)
        for d in range(pos_i.shape[-1]):
            dd = pos_i[:, :, None, d] - pos_j[:, None, :, d]
            r2 += dd * dd
        live = (m_i > 0)[..., None] & (m_j > 0)[:, None, :]
        hi = 2.0 * h_i[..., None]
        hc = torch.maximum(hi, 2.0 * h_j[:, None, :])
        grav = ((r2 > 0) & (r2 <= cutoff ** 2) if cutoff
                else torch.zeros_like(live))
        return tuple((live & m).sum(-1) for m in (r2 < hi * hi,
                                                   r2 < hc * hc, grav))

    outs = _tile_pass(kfn, wd, spec, (pos_s, mass_s, h_s),
                      (pos_s, mass_s, h_s), mass_axis=1)
    return tuple(int(o[wd.is_real].sum()) for o in outs)


def kernel_bound(kind, spec, pos_s, pairs, iters=0, bals=False, bf=False,
                 grav_pairs=0, masked=None):
    """The bound of one launch of kernel A or C: its SoA window, h0 and
    tables read once and its outputs written once; the operations of the
    ``pairs`` it needs (``pair_counts``), Newton walks included. With
    ``masked``, a mask_structure'd WindowData, the SoA rows are read only
    where an active group needs them (its own rows and its windows); the
    outputs, and kernel A's h0 that masked rows hand back as h, cover
    every row."""
    dim, ns, size = spec.dim, spec.n_sorted, pos_s.element_size()
    tables = 2 * spec.n_groups * spec.n_seg * 4
    ns_in = ns if masked is None else rows_needed(masked, spec)
    if kind == "A":
        rows_in, rows_all = dim + 1 + (dim if bals else 0), 1 + (
            5 if bals else 3)
        per = iters * FLOPS["A_walk"][dim] + (
            FLOPS["A_final_bals"][dim] if bals else FLOPS["A_walk"][dim])
        flops = pairs * per
    else:
        rows_in, rows_all = 2 * dim + 8 + (1 if bf else 0), dim + 1
        flops = pairs * (FLOPS["C"][dim] - (0 if bf else 3))
        flops += grav_pairs * FLOPS["C_grav"] + max(
            grav_pairs - pairs, 0) * FLOPS["C_grav_outside"]
    return bound((rows_in * ns_in + rows_all * ns) * size + tables, flops,
                 pos_s.dtype)


def rows_needed(wd, spec):
    """Sorted rows that some active group of an in-place structure reads:
    the union of the active groups' own rows and of their segment ranges
    [w_lo, w_lo + 128 w_nact)."""
    assert spec.cwidth == 0
    lo = wd.w_lo.long()
    hi = lo + 128 * wd.w_nact.long()
    own = torch.arange(spec.n_groups, device=lo.device) * spec.group
    own_n = spec.group * (wd.w_nact.sum(1) > 0).long()
    lo = torch.cat([lo.reshape(-1), own])
    hi = torch.cat([hi.reshape(-1), own + own_n])
    # +1 where a range opens, -1 where it closes; a row is needed where the
    # running sum is positive
    edge = torch.zeros(spec.n_sorted + 1, dtype=torch.long, device=lo.device)
    edge.index_add_(0, lo, torch.ones_like(lo))
    edge.index_add_(0, hi, -torch.ones_like(hi))
    return int((edge.cumsum(0)[:-1] > 0).sum())


def candidate_rows(wd, spec):
    """Mean candidate rows per real sorted row that the kernels walk (the
    segment ranges [w_lo, w_lo + 128 w_nact), duplicates included) and that
    they compute pair math for (each row of the ranges' union once)."""
    lo = wd.w_lo.long()
    hi = lo + 128 * wd.w_nact.long()
    walked = (hi - lo).sum(1)
    # a range overlaps the earlier ranges' union only below their running
    # maximum end (the ranges rise with the segment offset)
    prev_hi = torch.cummax(hi, 1).values[:, :-1]
    overlap = (torch.minimum(prev_hi, hi[:, 1:]) - lo[:, 1:]).clamp_min(0)
    computed = walked - overlap.sum(1)
    real = wd.is_real
    return tuple(float(x.repeat_interleave(spec.group)[real].double().mean())
                 for x in (walked, computed))


@contextlib.contextmanager
def plain_rowpack():
    """The derived pass's row gathers and packing through their plain torch
    versions (the composition they replaced), on any device."""
    from sphax_torch.physics import rowpack

    names = ("gather_a", "gather_c", "scatter_out")
    saved = [getattr(rowpack, k) for k in names]
    for k in names:
        setattr(rowpack, k, getattr(rowpack, f"{k}_plain"))
    try:
        yield
    finally:
        for k, fn in zip(names, saved):
            setattr(rowpack, k, fn)


def rowpack_bytes(dim, n, Ns, size, alpha=False, bf=True):
    """Bytes a launch of each row-packing kernel moves, each input read
    once and each output written once: gather_a reads g, shift_s and (for
    the N rows that are particles) pos, vel, m, u, h (, alpha), and writes
    A's window and h0, u (, alpha); gather_c reads A's window and src,
    and six sorted fields (five without bf) at the N + 1 rows that src
    names (the N owner rows and the one row every pad row mirrors), and
    writes C's window; scatter_out reads inv and, at the N owner rows, 7
    scalars and acc, and writes them."""
    from sphax_torch.physics import rowpack

    fa = 2 * dim + 3 + int(alpha)
    return {
        "rowpack_gather_a": Ns * (4 + dim * size) + n * fa * size
        + Ns * (2 * dim + 3 + int(alpha)) * size,
        "rowpack_gather_c": Ns * ((2 * dim + 1) * size + 4)
        + (n + 1) * (5 + int(bf)) * size
        + Ns * rowpack.c_rows(dim, bf) * size,
        "rowpack_scatter_out": n * (4 + 2 * (7 + dim) * size),
    }


def walk_fill(dev, every=8):
    """Phase 27's kernel A and C walks at the benchmark cells' shapes
    (turb256, sedov128 and kh1024, each problem's set-up state): per real
    row the candidates, survivors and pairs inside the support, and the
    steps a warp and the lane fill of the walk in which every lane visits
    every survivor and of the pair walk (``window_kernels.walk_stats``:
    the plain rule on every ``every``-th row-group with candidates, at the
    fp32 batch of A's Newton walk and of its final walk with the Balsara
    sums, and at C's rule and batch). Returns its record."""
    from sphax_torch import problems
    from sphax_torch.neighbors import window as win
    from sphax_torch.physics import window_kernels as wk

    makers = {"turb256": lambda: problems.turb(n=256, accel_rms=0.2,
                                               device=dev),
              "sedov128": lambda: problems.sedov(n=128, device=dev),
              "kh1024": lambda: problems.kh(n=1024, smooth=1, device=dev)}
    rec = {}
    for cell, make in makers.items():
        t0 = time.perf_counter()
        prob = make()
        st = prob.state
        wd = win.build(st.pos, prob.domain, prob.wspec)
        mass_s = win.gather_sorted(st.mass, wd)
        h_s = win.gather_sorted(st.h, wd, 1.0)
        r = {walk: wk.walk_stats(wd, prob.wspec, wd.pos_s, mass_s, h_s,
                                 wk.pair_cap(torch.float32, rest), every)
             for walk, rest in (("newton", False), ("final", True))}
        r["forces"] = wk.walk_stats(wd, prob.wspec, wd.pos_s, mass_s, h_s,
                                    wk.force_cap(torch.float32), every,
                                    pair_h=True, step=wk.FORCE_STEP)
        n, f = r["newton"], r["final"]
        log(f"[27 walks] {cell} (every {every}th row-group, "
            f"{time.perf_counter() - t0:.1f} s): per real row "
            f"{n['candidates']:.1f} candidates, {n['survivors']:.1f} "
            f"survivors, {n['pairs']:.2f} pairs inside 2 h; every lane "
            f"over every survivor: {n['steps_warp']:.1f} steps a warp, "
            f"fill {n['fill_warp']:.3f}; the pair walk: "
            f"{n['steps_pairs']:.1f} steps, fill {n['fill_pairs']:.3f} "
            f"(batch {wk.pair_cap(torch.float32)}), {f['steps_pairs']:.1f}"
            f" steps, fill {f['fill_pairs']:.3f} (batch "
            f"{wk.pair_cap(torch.float32, True)}, the final walk)")
        assert 0 < n["fill_warp"] <= n["fill_pairs"] <= 1.0, n
        c = r["forces"]
        log(f"[27 walks] {cell} kernel C: per real row {c['survivors']:.1f} "
            f"survivors, {c['pairs']:.2f} pairs inside 2 max(h_i, h_j); "
            f"every lane over every survivor: {c['steps_warp']:.1f} steps a "
            f"warp, fill {c['fill_warp']:.3f}; the pair walk: "
            f"{c['steps_pairs']:.1f} steps, fill {c['fill_pairs']:.3f} "
            f"(batch {wk.force_cap(torch.float32)})")
        assert 0 < c["fill_warp"] <= c["fill_pairs"] <= 1.0, c
        rec[cell] = r
        del prob, st, wd, mass_s, h_s
    return rec


def rowpack_phase(dev, h, n_side=256):
    """Phase 45: the three row-packing kernels at turb256's shapes
    (``problems.turb(n=256, accel_rms=0.2)``, the benchmark's turbulence
    configuration, fp32): each launch bit for bit equal to its plain
    version; a derived pass (a path of ``h.drive``: one launch of A, C and
    each row-packing kernel) equal bit for bit to the same pass through
    the plain versions (the composition they replaced) and to the frozen
    copy of that composition in tests/_rowpack_frozen.py; ms a launch
    (CUDA events), its bound (bytes over 3.35 TB/s) and the plain
    version's ms. Returns its record."""
    from sphax_torch import problems
    from sphax_torch.neighbors import window as win
    from sphax_torch.physics import rowpack, wengine
    from sphax_torch.physics import window_kernels as wk
    from sphax_torch.physics.eos import eos
    from tests._rowpack_frozen import frozen_derived

    t_phase = time.perf_counter()
    prob = problems.turb(n=n_side, accel_rms=0.2, device=dev)
    st, cfg, dom, spec = prob.state, prob.cfg, prob.domain, prob.wspec
    wd = win.build(st.pos, dom, spec)
    dim, n, Ns = st.dim, st.n, spec.n_sorted
    size = st.pos.element_size()

    def same(a, b, what):
        assert a.shape == b.shape and torch.equal(a, b), (
            f"{what}: {int((a != b).sum())} entries differ")

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            out = fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps, out

    # the inputs gather_c and scatter_out see in a derived pass
    a_args = (wd, st.pos, st.vel, st.mass, st.u, st.h,
              st.alpha if cfg.mm_visc else None)
    win_a, h0_s, u_s, _ = rowpack.gather_a(*a_args)
    h_s, rho_s, om_s, bf_s, divv_s = wengine.stage_density(
        wd, spec, cfg, win_a[:dim].T, win_a[dim + 1:].T, win_a[dim], u_s,
        h0_s, win=win_a)
    P_s, cs_s = eos(rho_s, u_s, cfg)
    c_args = (win_a, wd, cfg, h_s, rho_s, om_s, bf_s, P_s, cs_s)
    win_c, mirrored = rowpack.gather_c(*c_args)
    acc_s, du_s = wengine.stage_forces(wd, spec, cfg, win_a[:dim].T,
                                       win_a[dim + 1:].T, win_a[dim],
                                       *mirrored, win=win_c)
    s_args = (wd, h_s, rho_s, P_s, cs_s, om_s, du_s, divv_s, acc_s)
    runs = {"rowpack_gather_a": (lambda: rowpack.gather_a(*a_args),
                                 lambda: rowpack.gather_a_plain(*a_args)),
            "rowpack_gather_c": (lambda: rowpack.gather_c(*c_args),
                                 lambda: rowpack.gather_c_plain(*c_args)),
            "rowpack_scatter_out": (
                lambda: rowpack.scatter_out(*s_args),
                lambda: rowpack.scatter_out_plain(*s_args))}
    nbytes = rowpack_bytes(dim, n, Ns, size, alpha=cfg.mm_visc,
                           bf=cfg.visc_factor_on)
    rows = []
    for name, (kern, plain) in runs.items():
        k_ms, got = ms(kern, 20)
        p_ms, want = ms(plain, 5)
        got = got[:1] if name == "rowpack_gather_c" else got
        want = want[:1] if name == "rowpack_gather_c" else want
        for k, (a, b) in enumerate(zip(got, want)):
            if b is not None:
                same(a, b, f"{name} output {k}")
        b_ms, by = bound(nbytes[name], 0, st.pos.dtype)
        rows.append({"name": name, "ms": k_ms, "bound_ms": b_ms, "by": by,
                     "bytes": nbytes[name], "plain_ms": p_ms,
                     "bitwise_equal": True})
        log(f"[45 rowpack] {name:20s} {k_ms:.3f} ms  bound {b_ms:.3f} ms "
            f"({by}, {nbytes[name] / 1e9:.2f} GB)  plain {p_ms:.3f} ms  "
            f"bitwise equal")
    del win_a, h0_s, u_s, h_s, rho_s, om_s, bf_s, divv_s, P_s, cs_s, c_args
    del a_args
    del win_c, mirrored, acc_s, du_s, s_args

    # the whole derived pass: the kernels, the plain versions, the frozen
    # composition
    compact = "_compact" if spec.cwidth > 0 else ""
    got = h.drive("rowpack derived pass", lambda: wengine.derived_with(
        st, wd, cfg, dom, spec), {
            wk._kernel_name(f"solve_h_density{compact}", dim): 1,
            wk._kernel_name(f"forces{compact}", dim): 1})
    fields = ("h", "rho", "P", "cs", "omega", "acc", "du_dt", "divv")
    with plain_rowpack():
        want = wengine.derived_with(st, wd, cfg, dom, spec)
    for f in fields:
        same(getattr(got, f), getattr(want, f), f"derived {f} (plain)")
    del want
    frozen = frozen_derived(st, wd, cfg, dom, spec)
    for f in fields:
        same(getattr(got, f), getattr(frozen, f), f"derived {f} (frozen)")
    del frozen
    d_ms, _ = ms(lambda: wengine.derived_with(st, wd, cfg, dom, spec), 5)
    with plain_rowpack():
        dp_ms, _ = ms(lambda: wengine.derived_with(st, wd, cfg, dom, spec),
                      5)
    log(f"[45 rowpack] derived_with at n={n} (Ns={Ns}): bitwise equal to "
        f"the plain versions' and the frozen pass, one launch of each "
        f"row-packing kernel; {d_ms:.2f} ms a pass, {dp_ms:.2f} ms through "
        f"the plain versions")
    return {"n": n, "n_sorted": Ns, "kernels": rows, "derived_ms": d_ms,
            "derived_plain_ms": dp_ms,
            "seconds": time.perf_counter() - t_phase}


def cic_phase(dev, h, n_side=256, M=384):
    """Phase 46: the P3M mesh's CIC kernels at cloud256.p3m's shapes
    (``ab_kernels.cic_inputs``: N = n_side^3, M^3 mesh, fp32). The deposit
    through ``cic_deposit`` against ``pm._deposit_plain``: every cell within
    1e-6 of the largest, the total mass within 1e-6; the solved
    acceleration grids interpolated through ``cic_interp`` (3 grids, and
    the first alone) bitwise equal to ``pm._interp_plain``; one launch of
    each kernel a call (a path of ``h.drive``); ms a launch (CUDA events),
    the bound (``bounds.cic_bound``) and the plain version's ms. Returns
    its record, with a row of the kernels' record for each kernel."""
    from sphax_torch.ab_kernels import cic_inputs
    from sphax_torch.bounds import cic_bound
    from sphax_torch.physics import pm

    t_phase = time.perf_counter()
    pos, mass, lo, cell, cfg, dom = cic_inputs(dev, n_side, M)
    n, dtype = pos.shape[0], pos.dtype
    src = "sphax_torch/csrc/cic.cu"

    def deposit():
        return pm._deposit(pos, mass, lo, cell, M, True)

    grid = h.drive("cic deposit", deposit, {"cic_deposit": 1})
    want = pm._deposit_plain(pos, mass, lo, cell, M, True)
    scale = float(want.abs().max())
    e_dep = float((grid - want).abs().max()) / scale
    total, m_sum = float(grid.double().sum()), float(mass.double().sum())
    e_mass = abs(total - m_sum) / m_sum
    assert e_dep <= 1e-6 and e_mass <= 1e-6, (e_dep, e_mass)
    grids = pm._solve_grids(grid, dom, float(cfg.G),
                            pm.rs_traced(cfg, dom, dtype), M, True)
    del grid, want
    for g in (3, 1):
        got = h.drive(f"cic interp {g}", lambda: pm._interp(
            grids[:g], pos, lo, cell, M, True), {"cic_interp": 1})
        want = pm._interp_plain(grids[:g], pos, lo, cell, M, True)
        assert got.shape == want.shape and torch.equal(got, want), (
            f"cic_interp of {g} grids: {int((got != want).sum())} entries "
            f"differ")
    del got, want
    cases = {
        "cic_deposit": (deposit, lambda: pm._deposit_plain(
            pos, mass, lo, cell, M, True), cic_bound(n, M, 0, dtype),
            e_dep),
        "cic_interp": (lambda: pm._interp(grids, pos, lo, cell, M, True),
                       lambda: pm._interp_plain(grids, pos, lo, cell, M,
                                                True),
                       cic_bound(n, M, 3, dtype), 0.0)}
    rows = []
    for name, (kern, plain, (b_ms, by), err) in cases.items():
        k_ms, _ = h.cuda_ms(kern, 20)
        p_ms, _ = h.cuda_ms(plain, 3)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": None, "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                     "max_err_over_scale": err, "n": n, "M": M,
                     "grids": 3 if name == "cic_interp" else 0})
        log(f"[46 cic] {name:12s} {k_ms:.3f} ms  bound {b_ms:.3f} ms ({by})"
            f"  plain {p_ms:.3f} ms")
    log(f"[46 cic] N={n} M={M} fp32: deposit within {e_dep:.3g} of the "
        f"largest cell (tol 1e-6), total mass within {e_mass:.3g}; the "
        f"interpolation of 3 and of 1 grid bitwise equal to the plain "
        f"version; one launch a call")
    return {"n": n, "M": M, "kernels": rows, "deposit_max_err_over_scale":
            e_dep, "deposit_mass_err": e_mass,
            "seconds": time.perf_counter() - t_phase}


def limiter_phase(dev, h, n_side=256, n_rungs=8):
    """Phase 47: the timestep limiter's kernels (``csrc/rung_limit.cu``)
    at the shapes of the cell ``sedov256.sm09r8``. ``sedov n=256
    limiter=4`` runs one span of ``rung_chunk`` on 8 rungs
    with the drift gate (a path of ``h.drive``: one ``rung_limit_tick``
    launch a tick, ``rung_limit.sync_passes`` launches of
    ``rung_limit_sync`` at its sync point, one A and one C a tick and A's
    seeding pass). On the state it ends with, the sync point's passes and
    the tick's pass (seeded wanted rungs, ticks 3, 63 and 127: few closers,
    a quarter, every row) are ``torch.equal`` to their plain versions; ms a
    launch (CUDA events), the bound of the closers' inputs read once, one
    rung written and 12 operations a neighbour pair (``bounds.bound``), and
    the plain version's ms. Returns its record, with a row of the kernels'
    record for each kernel."""
    from sphax_torch import problems
    from sphax_torch.__main__ import rung_chunk
    from sphax_torch.bounds import bound
    from sphax_torch.integrate import rungs
    from sphax_torch.neighbors import window as win
    from sphax_torch.physics import rung_limit as rl

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    prob = problems.sedov(n=n_side, limiter=4, device=dev)
    assert prob.engine_name == "window" and prob.rung_limiter == 4
    span = 1 << (n_rungs - 1)
    a = rungs.limiter_exponent(prob.rung_limiter)
    passes = rl.sync_passes(n_rungs, a)
    ticks0 = rungs.WOKEN["ticks"]
    st, dts, ovf, viol, frac, builds = h.drive(
        "limiter sedov rungs=8", lambda: rung_chunk(
            prob, prob.state, n_rungs, span, 8),
        {"solve_h_density": span + 1, "forces": span,
         "rung_limit_tick": span, "rung_limit_sync": passes})
    assert int(ovf) == 0 and bool(torch.isfinite(st.u).all())
    assert rungs.WOKEN["ticks"] - ticks0 == span
    spec, dom = prob.wspec, prob.domain
    pos = dom.wrap(st.pos)
    wd = win.build(pos, dom, spec)
    dt_des = rungs.particle_dt(st, prob.cfg)
    start = rungs._rung_of(dt_des, dt_des.amin(), n_rungs)
    rung, plain = start, start
    for _ in range(passes):
        rung = rl.sync(wd, spec, pos, st.h, st.mass, rung, a, n_rungs)
        plain = rl.sync_plain(wd, spec, pos, st.h, st.mass, plain, a,
                              n_rungs)
        assert torch.equal(rung, plain), int((rung != plain).sum())
    lowered_sync = int((rung < start).sum())
    gen = torch.Generator(device=dev).manual_seed(47)
    r_des = torch.randint(0, n_rungs, rung.shape, generator=gen,
                          device=dev, dtype=torch.int32)
    ticks = {}
    for k in (3, span // 2 - 1, span - 1):
        args = (wd, spec, pos, st.h, st.mass, rung, r_des, k, a,
                rungs._alignment(k + 1, n_rungs), n_rungs)
        got, want = rl.tick(*args), rl.tick_plain(*args)
        for name, x, y in zip(("m", "target", "limited"), got, want):
            assert torch.equal(x, y), (k, name, int((x != y).sum()))
        g, x, h_s, m_s, r_s, real = rl._sorted(wd, pos, st.h, st.mass,
                                              rung)
        closes = real & (torch.bitwise_and((1 << r_s.long()) - 1, k + 1)
                         == 0)
        pairs = sum(i.numel() for i, _ in rl.neighbour_pairs(
            wd, spec, closes, x, h_s, m_s, g))
        ticks[k] = dict(closers=int(closes.sum()), pairs=int(pairs),
                        limited=int(got[2]),
                        woken=int((got[1] < rung).sum()))
    size = pos.element_size()
    rows, src = [], "sphax_torch/csrc/rung_limit.cu"
    few = ticks[3]
    cases = {
        "rung_limit_tick": (
            lambda: rl.tick(wd, spec, pos, st.h, st.mass, rung, r_des, 3, a,
                            rungs._alignment(4, n_rungs), n_rungs),
            lambda: rl.tick_plain(wd, spec, pos, st.h, st.mass, rung, r_des,
                                  3, a, rungs._alignment(4, n_rungs),
                                  n_rungs),
            bound(few["closers"] * (5 * size + 3 * 4), 12 * few["pairs"],
                  pos.dtype), few["closers"]),
        "rung_limit_sync": (
            lambda: rl.sync(wd, spec, pos, st.h, st.mass, rung, a, n_rungs),
            lambda: rl.sync_plain(wd, spec, pos, st.h, st.mass, rung, a,
                                  n_rungs),
            bound(st.n * (5 * size + 2 * 4),
                  12 * ticks[span - 1]["pairs"], pos.dtype), st.n)}
    for name, (kern, slow, (b_ms, by), walking) in cases.items():
        k_ms, _ = h.cuda_ms(kern, 20)
        p_ms, _ = h.cuda_ms(slow, 2)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": None, "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                     "max_abs_err": 0, "n": st.n, "walking_rows": walking})
        log(f"[47 limiter] {name:16s} {k_ms:.3f} ms  bound {b_ms:.3g} ms "
            f"({by}, {walking} walking rows)  plain {p_ms:.3f} ms")
    log(f"[47 limiter] sedov n={n_side} limiter=4, {span} ticks on "
        f"{n_rungs} rungs: dt_viol {int(viol)}, active {frac:.4f}, builds "
        f"{builds}; sync ({passes} passes, {lowered_sync} rungs lowered) "
        f"and the tick's pass ({ticks}) equal to plain; one tick launch a "
        f"tick")
    return {"n": st.n, "n_rungs": n_rungs, "span_dt_viol": int(viol),
            "span_active_frac": frac, "sync_passes": passes,
            "sync_lowered": lowered_sync, "ticks": ticks, "kernels": rows,
            "seconds": time.perf_counter() - t_phase}


if __name__ == "__main__":
    main()
    sys.exit(0)
