"""Set-up and the measured window: the CLI's single-device loop.

The window drives ``sphax_torch`` as ``python -m sphax_torch`` does: the
problem from ``problems.REGISTRY``, then chunks of
``wengine.simulate`` (the driven box reseeds its noise at each chunk's
first step, as the CLI does) or of ``__main__.rung_chunk``, each followed by
a device synchronise, the chunk's simulated time read back and its overflow
checked. It runs episodes: each restores the state set-up left (a device
copy, with the driving state and the step index) and runs a fixed number of
chunks, so a faster program repeats the same work. The window ends at the
first chunk boundary at or after ``--seconds``.

``Recorder`` keeps what the check needs of the window's last chunk: it
wraps the integrator's step (global dt: the input and output state of the
chunk's last step) or the rung loop's per-tick functions (block timesteps:
one tick of the chunk's last span, copied to host memory as it runs). It
calls the program's functions unchanged.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench import ics as ICS
from portbench import spec


def seeds(seed: int, n: int = 3):
    """Independent 31-bit seeds drawn from the run's ``--seed``: the
    velocity field or jitter, the driving noise, the sample of rows."""
    return [int(s) >> 1 for s in
            np.random.SeedSequence(int(seed)).generate_state(n)]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Recorder:
    """Keeps references to (global dt) or host copies of (rung ticks) what
    one step or tick of the chunk being run reads and writes. ``arm`` before
    a chunk to record it; ``clear`` drops what is held."""

    def __init__(self, rungs: int, kstar: int, host: bool):
        self.rungs, self.kstar, self.host = rungs, kstar, host
        self.span = 1 << (rungs - 1)
        self.rec, self.armed, self.calls, self.target = None, False, 0, 0

    def arm(self, on: bool, steps: int = 0):
        self.armed, self.calls, self.target = on, 0, steps
        self.rec = None

    def clear(self):
        self.rec = None

    def _keep(self, t):
        if not self.host:
            return t
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        out.copy_(t, non_blocking=True)
        return out

    @contextlib.contextmanager
    def installed(self):
        from sphax_torch.integrate import leapfrog, rungs

        saved = {(leapfrog, "step"): leapfrog.step,
                 (rungs, "open_drift"): rungs.open_drift,
                 (rungs, "_derived_rungs"): rungs._derived_rungs,
                 (rungs, "particle_dt"): rungs.particle_dt,
                 (rungs, "close_rungs"): rungs.close_rungs}
        orig = {name: fn for (_, name), fn in saved.items()}

        def step(state, cfg, domain, derived_fn, dt=None, wrap=True):
            out = orig["step"](state, cfg, domain, derived_fn, dt=dt,
                               wrap=wrap)
            self.calls += 1
            if self.armed and self.calls == self.target:
                self.rec = dict(s_in=state, s_out=out[0], dt=out[1])
            return out

        def open_drift(st, rung, dt_min, k, cfg):
            tick = self.calls
            self.calls += 1
            last = self.armed and tick >= self.target - self.span
            if last and k == 0:
                self.rec = dict(span={f: self._keep(getattr(st, f))
                                      for f in ("h", "cs", "acc")})
            if last and k == self.kstar:
                self.rec.update(k=k, dt_min=self._keep(dt_min), pre={
                    f: self._keep(getattr(st, f))
                    for f in ("pos", "vel", "mass", "u", "h", "rho",
                              "omega", "divv", "acc", "du_dt")})
                self.rec["pre"]["rung"] = self._keep(rung)
                self.rec["tick"] = tick
            return orig["open_drift"](st, rung, dt_min, k, cfg)

        def at_kstar():
            return (self.armed and self.rec is not None
                    and self.rec.get("tick") == self.calls - 1)

        def derived_rungs(state, bf_prev, wd, cfg, domain, spec, close_m):
            out = orig["_derived_rungs"](state, bf_prev, wd, cfg, domain,
                                         spec, close_m)
            if at_kstar():
                self.rec["pre"]["bf"] = self._keep(bf_prev)
                self.rec["post"] = {f: self._keep(getattr(out[0], f))
                                    for f in ("h", "rho", "divv", "acc",
                                              "du_dt")}
            return out

        def particle_dt(st, cfg):
            if at_kstar() and "post" in self.rec:
                self.rec["post"].update(
                    {f: self._keep(getattr(st, f))
                     for f in ("pos", "vel", "u")})
            return orig["particle_dt"](st, cfg)

        def close_rungs(rung, dt_des, dt_min, close_m, k, n_rungs):
            out = orig["close_rungs"](rung, dt_des, dt_min, close_m, k,
                                      n_rungs)
            if at_kstar() and "post" in self.rec:
                self.rec["post"]["rung"] = self._keep(out[0])
            return out

        new = {"step": step, "open_drift": open_drift,
               "_derived_rungs": derived_rungs, "particle_dt": particle_dt,
               "close_rungs": close_rungs}
        try:
            for (mod, name) in saved:
                setattr(mod, name, new[name])
            yield self
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)


class Sim:
    """The problem set up from the configuration, the restore point, and
    one chunk of the CLI's loop."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 override: dict | None = None):
        from sphax_torch.problems import REGISTRY

        over = dict(override or {})
        self.config, self.traffic, self.device = config, traffic, device
        self.reference = spec.reference(config)
        self.dtype = getattr(torch, config["dtype"])
        self.seed_ic, self.seed_noise, self.seed_rows = seeds(seed)
        self.chunk = int(over.pop("chunk", traffic["chunk"]))
        self.episode = int(over.pop("episode_chunks",
                                    traffic["episode_chunks"]))
        self.adaptive = int(traffic["adaptive"])
        self.rungs = int(traffic["rungs"])
        args = dict(config["problem_args"])
        ic = dict(config["ics"])
        if "n" in over:
            args["n"] = ic["n_side"] = int(over.pop("n"))
        if over:
            raise ValueError(f"unknown overrides {sorted(over)}")
        # ``seed_args`` names the problem's arguments that take one of the
        # run's seeds: {"seed": "noise"} hands the driving noise its seed
        drawn = {"ics": self.seed_ic, "noise": self.seed_noise}
        for arg, which in config.get("seed_args", {}).items():
            args[arg] = drawn[which]
        prob = REGISTRY[config["problem"]](device=device, dtype=self.dtype,
                                           **args)
        self.ic = ic
        self._check_config(prob)
        made = ICS.make(ic, self.seed_ic, self.dtype, device)
        st = prob.state._replace(**made)
        s0 = prob.engine(st)
        # the restore point takes the place of the problem's own start
        # state, as the CLI holds ``prob.state`` through its run
        self.prob = prob._replace(state=s0)
        self.n = s0.n
        self.driven = prob.drive_spec is not None
        self.recorder = Recorder(self.rungs, int(traffic.get("kstar", 3)),
                                 host=self.rungs > 1)

    def _check_config(self, prob):
        """The program has to run what the configuration states."""
        want = self.config["sph"]
        got = {k: getattr(prob.cfg, k) for k in want}
        bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if bad:
            raise SystemExit(f"the program's config departs from the "
                             f"configuration: {bad} (got, stated)")
        if prob.drive_spec is not None:
            d = self.config["drive"]
            ds = prob.drive_spec
            modes = self.reference.drive_modes(d["kmin"], d["kmax"],
                                               "cpu").tolist()
            if ([list(m) for m in ds.modes] != modes
                    or ds.tau != d["tau"] or ds.accel_rms != d["accel_rms"]):
                raise SystemExit(f"the program's driving departs from the "
                                 f"configuration's {d}")
        if prob.wspec is None:
            raise SystemExit("the configuration states the window engine; "
                             f"the program took {prob.engine_name}")
        cut = 2.0 * self.hcap()
        if not np.isclose(prob.wspec.cutoff, cut, rtol=1e-5):
            raise SystemExit(f"window cutoff {prob.wspec.cutoff} departs "
                             f"from the configuration's {cut}")

    def hcap(self) -> float:
        """The structural h cap the configuration states: half the window
        cutoff, 2 cutoff_scale h_margin max(h_IC)."""
        w = self.config["window"]
        h0 = float(self.ic["eta"]) / int(self.ic["n_side"])
        return w["cutoff_scale"] * w["h_margin"] * h0

    def restore(self):
        """(state, drive, step) of the restore point, on fresh storage."""
        p = self.prob
        st = p.state._replace(**{f: getattr(p.state, f).clone()
                                 for f in p.state._fields})
        drive = (None if p.drive is None else
                 p.drive._replace(amp_re=p.drive.amp_re.clone(),
                                  amp_im=p.drive.amp_im.clone()))
        return st, drive, 0

    def run_chunk(self, st, drive, step, nsteps):
        """One chunk as the CLI runs it. Returns (state, drive, dts,
        builds, active fraction or None)."""
        from sphax_torch import __main__ as cli
        from sphax_torch.physics import wengine

        p = self.prob
        if self.rungs > 1:
            st, dts, ovf, viol, frac, builds = cli.rung_chunk(
                p, st, self.rungs, nsteps, self.adaptive)
        else:
            if self.driven:
                p.noise.reseed(p.seed, step)
            out = wengine.simulate(st, p.cfg, p.domain, p.wspec, nsteps,
                                   drive=drive, drive_spec=p.drive_spec,
                                   noise=p.noise,
                                   adaptive_rebuild=self.adaptive)
            st, drive, dts, ovf = out[:4]
            builds = out[4] if self.adaptive else nsteps // 2
            frac = None
        sync(self.device)
        if int(ovf):
            raise RuntimeError(f"window structure overflow ({int(ovf)})")
        return st, drive, dts, builds, frac

    def warm_up(self):
        """One short chunk from the restore point through the same calls
        (and the recorder), discarded."""
        steps = int(self.traffic["warmup_steps"])
        t0 = time.perf_counter()
        st, drive, step = self.restore()
        with self.recorder.installed():
            self.recorder.arm(True, steps)
            self.run_chunk(st, drive, step, steps)
            self.recorder.arm(False)
        sync(self.device)
        self.est_chunk = (time.perf_counter() - t0) * self.chunk / steps

    def window(self, seconds: float, episodes: int | None = None):
        """Run whole chunks of episodes until ``seconds`` have passed (or,
        with ``episodes``, that many whole episodes). Returns the counters
        of the window."""
        from torch.profiler import record_function

        rec = self.recorder
        c = dict(steps=0, chunks=0, sim_time=0.0, builds=0, active=0.0,
                 episodes=0)
        last_chunk = 0.0
        with rec.installed():
            t0 = time.perf_counter()
            done = False
            while not done:
                rec.clear()
                with record_function("portbench.restore"):
                    st, drive, step = self.restore()
                for k in range(self.episode):
                    t1 = time.perf_counter()
                    if episodes is None:
                        # record the chunk that is likely the last: the
                        # global-dt recorder holds what is alive anyway
                        final = (self.rungs == 1 or t1 - t0 + 1.25
                                 * (last_chunk or self.est_chunk) >= seconds)
                    else:
                        final = (c["episodes"] + 1 == episodes
                                 and k + 1 == self.episode)
                    rec.arm(final, self.chunk)
                    drive_in = drive
                    with record_function("portbench.chunk"):
                        st, drive, dts, builds, frac = self.run_chunk(
                            st, drive, step, self.chunk)
                    with record_function("portbench.readback"):
                        tsum = float(dts.double().sum())
                    nd = len(dts)
                    c["steps"] += nd
                    c["chunks"] += 1
                    c["sim_time"] += tsum
                    c["builds"] += int(builds)
                    if frac is not None:
                        c["active"] += frac * nd
                    last_chunk = time.perf_counter() - t1
                    end = time.perf_counter() - t0
                    # the last chunk is one that was recorded: a chunk
                    # that overran the window unrecorded is followed by one
                    # more
                    if episodes is None and end >= seconds and rec.armed:
                        done = True
                    if (episodes is not None and k + 1 == self.episode
                            and c["episodes"] + 1 == episodes):
                        done = True
                    if done:
                        c.update(wall=end, dts=dts, drive_in=drive_in,
                                 drive_out=drive, step_in=step,
                                 state=st, record=rec.rec)
                        break
                    step += nd
                c["episodes"] += 1
        return c
