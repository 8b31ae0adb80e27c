"""The comparison that decides ``correct``.

Readings, each the largest normalised gap over a sample of rows drawn from
the seed (the workload file sets the sample and each reading's limit):

- ``start_err``: the set-up's derived pass on the benchmark's ICs against
  the reference's on the same ICs (h, rho, div v, acc, du/dt);
- ``step_err`` (global steps): the last step the window ran against the
  reference's step from the program's input state of that step (pos, vel,
  u, h, rho, div v, acc with the driving term, du/dt, dt, and the driving
  amplitudes the reference carries through the chunk);
- ``tick_err`` and ``rung_miss`` (block timesteps): tick ``kstar`` of the
  last span the window ran, from the program's state before it: every
  sampled row's drift and kicks and its fields (fresh on closers, stale on
  the others), and the span's dt_min; and how many sampled closers took
  another rung than the reference's (a row whose log2(dt / dt_min) lies
  within 1e-4 of a rung boundary, which fp32 may round either way, is not
  counted).

Each field's gap is scaled by what bounds its rounding: h, rho, u per row;
acc, du/dt, div v by the row's sum of absolute pair terms; positions by
the row's h; velocities and driving amplitudes by their largest value in
the sample; dt relative. The control computes the reference in its lower
precision and stands where the program's values stand.
"""
from __future__ import annotations

import math

import torch

_FIELDS = ("h", "rho", "divv", "acc", "du_dt")


def _gap(a, b, scale):
    a, b = a.double(), b.double()
    d = torch.abs(a - b)
    if d.dim() > 1:
        d = torch.sqrt(torch.sum(d * d, dim=-1))
    s = torch.as_tensor(scale, dtype=torch.float64, device=d.device)
    e = torch.where(d > 0, d / torch.clamp_min(s, 1e-300), 0.0)
    e = torch.where(torch.isnan(d), float("inf"), e)
    return float(e.max()) if e.numel() else 0.0


def _mag(v):
    v = v.double()
    return torch.sqrt(torch.sum(v * v, dim=-1)) if v.dim() > 1 else v.abs()


def _pos_gap(a, b, h, box):
    d = a.double() - b.double()
    d = d - box * torch.round(d / box)
    return _gap(d, torch.zeros_like(d), h)


def _vmax(v):
    return _mag(v).max() if len(v) else 1.0


def derived_gaps(got: dict, ref: dict, tag: str = "") -> dict:
    rho = ref["rho"]
    return {
        "h" + tag: _gap(got["h"], ref["h"], ref["h"]),
        "rho" + tag: _gap(got["rho"], rho, rho),
        "divv" + tag: _gap(got["divv"], ref["divv"], ref["div_abs"]),
        "acc" + tag: _gap(got["acc"], ref["acc"], ref["acc_abs"]),
        "du_dt" + tag: _gap(got["du_dt"], ref["du_dt"], ref["du_abs"]),
    }


def worst(gaps: dict) -> float:
    """The reading: the largest gap (infinite where one is not a number)."""
    if any(math.isnan(v) for v in gaps.values()):
        return float("inf")
    return max(gaps.values(), default=0.0)


def sample(n: int, seed: int, spec: dict, ranks: dict, device):
    """Rows to judge: ``spec["random"]`` uniform rows from ``seed`` plus,
    for each key of ``ranks`` also in ``spec``, that many rows of the
    largest score (``ranks[key]``: a [n] tensor)."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    rows = [torch.randperm(n, generator=gen)[:min(int(spec["random"]), n)]
            .to(device)]
    for key, score in ranks.items():
        m = min(int(spec.get(key, 0)), n)
        if m:
            rows.append(torch.topk(score.to(device), m).indices)
    return torch.unique(torch.cat(rows))


# ---- the set-up's derived pass ----------------------------------------------


def start_values(s0, rows) -> dict:
    return {k: getattr(s0, k)[rows] for k in _FIELDS}


# ---- a global KDK step ------------------------------------------------------


def step_values(rec: dict, rows, drive_out=None) -> dict:
    out = rec["s_out"]
    got = {k: getattr(out, k)[rows] for k in _FIELDS + ("pos", "vel", "u")}
    got["dt"] = rec["dt"].reshape(1)
    if drive_out is not None:
        got["amp_re"], got["amp_im"] = drive_out
    return got


def step_ref(R, ar, rec: dict, rows, sph, hcap, box, drive=None) -> dict:
    """The reference ``R``'s step from the recorded input state; ``drive`` =
    (amp_re, amp_im at the step's start of the chunk, modes, spec, dts,
    noise) carries the driving amplitudes through the chunk's steps."""
    s_in = rec["s_in"]
    st = {k: getattr(s_in, k) for k in ("pos", "vel", "mass", "u", "h",
                                         "cs", "acc", "du_dt")}
    amps = None
    if drive is not None:
        re, im, modes, spec, dts, noise = drive
        re, im = re.to(ar.dtype), im.to(ar.dtype)
        for dt, (xr, xi) in zip(dts, noise):
            re, im = R.ou_update(re, im, modes.to(ar.dtype), float(dt), spec,
                                 xr.to(ar.dtype), xi.to(ar.dtype))
        amps = (re, im, modes, spec)
    ref = R.kdk_step(ar, st, rows, sph, hcap, box, drive=amps)
    ref["dt"] = ref["dt"].reshape(1)
    if amps is not None:
        ref["amp_re"], ref["amp_im"] = amps[0], amps[1]
    return ref


def step_gaps(got: dict, ref: dict, box) -> dict:
    g = derived_gaps(got, ref)
    g["pos"] = _pos_gap(got["pos"], ref["pos"], ref["h"], box)
    g["vel"] = _gap(got["vel"], ref["vel"], _vmax(ref["vel"]))
    g["u"] = _gap(got["u"], ref["u"], ref["u"])
    g["dt"] = _gap(got["dt"], ref["dt"], ref["dt"])
    if "amp_re" in ref:
        scale = torch.maximum(ref["amp_re"].abs().max(),
                              ref["amp_im"].abs().max())
        g["drive"] = max(_gap(got["amp_re"], ref["amp_re"], scale),
                         _gap(got["amp_im"], ref["amp_im"], scale))
    return g


# ---- a rung tick ------------------------------------------------------------


def tick_values(rec: dict, rows) -> dict:
    post = rec["post"]
    got = {k: post[k].to(rows.device)[rows]
           for k in _FIELDS + ("pos", "vel", "u", "rung")}
    got["dt_min"] = rec["dt_min"].reshape(1).to(rows.device)
    return got


def tick_ref(R, ar, rec: dict, rows, n_rungs: int, sph, hcap, box) -> dict:
    dev = rows.device
    pre = {k: v.to(dev) for k, v in rec["pre"].items()}
    ref = R.rung_tick(ar, pre, rows, rec["k"], rec["dt_min"].to(dev),
                      n_rungs, sph, hcap, box)
    span = {k: v.to(dev).to(ar.dtype) for k, v in rec["span"].items()}
    ref["dt_min"] = R.particle_dt(span["h"], span["cs"], span["acc"],
                                  sph).min().reshape(1)
    return ref


def tick_gaps(got: dict, ref: dict, box, judge_rungs: dict):
    """(gaps, rung misses); ``judge_rungs`` is the float64 reference, whose
    log2(dt / dt_min) says which closers' rungs are certain."""
    c = judge_rungs["close"]
    g = {"pos": _pos_gap(got["pos"], ref["pos"], ref["h"], box),
         "vel": _gap(got["vel"], ref["vel"], _vmax(ref["vel"])),
         "u": _gap(got["u"], ref["u"], ref["u"]),
         "dt_min": _gap(got["dt_min"], ref["dt_min"], ref["dt_min"])}
    pick = {k: v for k, v in ref.items()
            if torch.is_tensor(v) and v.dim() and len(v) == len(c)}
    g.update(derived_gaps({k: got[k][c] for k in _FIELDS},
                          {k: v[c] for k, v in pick.items()}, ".close"))
    keep = ~c
    for k in ("h", "rho", "divv", "acc", "du_dt"):
        g[k + ".stale"] = _gap(got[k][keep], ref[k][keep],
                               _mag(ref[k][keep]))
    lr = judge_rungs["log2_ratio"][c].double()
    sure = torch.abs(lr - torch.round(lr)) > 1e-4
    miss = int(((got["rung"][c].long() != ref["rung"][c].long())
                & sure).sum())
    return g, miss
