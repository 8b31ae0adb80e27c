"""Run one cell of the benchmark once and print one JSON line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control 1]

Set-up (imports, the kernels' build on a checkout's first run, the
problem, the benchmark's ICs, one short warm-up chunk) counts as
``setup_s``; the window then runs whole chunks of episodes for
``--seconds`` (``--trace 1``: the traffic's ``trace_episodes`` under
``torch.profiler``, and the per-layer metrics instead of the end-to-end
ones). After the window the peak memory is read, the program's state is
freed, and the reference judges the set-up's derived pass and the last
step or tick the window ran (``check.py``); each reading is printed beside
its limit, on standard error and last in the JSON line. ``--control 1``
puts the control, the reference computed in the control's precision, in
the program's place: its readings are compared and decide ``correct``, and
the program's own readings are reported apart under ``program``
(calibration only; the benchmark's own runs do not use it).

Exits 2 without a result where no CUDA device (or too few) is visible, and
3 where a JAX module was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sphax")


def loaded_forbidden():
    """Top-level names in ``sys.modules`` that this process must not hold,
    compared whole (``sphax_torch`` is not ``sphax``)."""
    tops = {m.partition(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


@dataclasses.dataclass
class Run:
    """What the metric readers see of one run."""

    n: int
    counters: dict
    setup_s: float
    peak_bytes: int
    config: dict
    traffic: dict
    trace: object = None
    final: tuple = None          # (pos, h) of the window's last state
    _pairs: tuple = None

    def pairs(self):
        """(pairs inside 2 h_i with self, inside 2 max(h_i, h_j) without)
        of the final state, counted once."""
        if self._pairs is None:
            from portbench import yardstick

            self._pairs = yardstick.pair_counts(*self.final)
        return self._pairs


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def judge(sim, c, cell, control: bool):
    """(compared, the program's readings where the control is compared,
    per-field gaps for the log)."""
    import torch

    from portbench import check as K
    from portbench import ics as ICS

    chk, cfg, R = cell.check, cell.config, cell.reference
    sph, box, hcap, dev = cfg["sph"], float(cfg["box"]), sim.hcap(), \
        sim.device
    ariths = [("program", None)] + ([("control", R.Arith(True))]
                                    if control else [])
    f64 = R.Arith()
    readings = {name: {} for name, _ in ariths}
    log = {}

    # the set-up's derived pass
    s0 = sim.prob.state
    n = s0.n
    rows = K.sample(n, sim.seed_rows, chk["sample"],
                    {"top_acc": torch.linalg.norm(s0.acc, dim=-1),
                     "top_u": s0.u}, dev)
    ics = ICS.make(sim.ic, sim.seed_ic, sim.dtype, dev)
    ref = R.derived_start(f64, ics, rows, sph, hcap, box)
    for name, ar in ariths:
        got = (K.start_values(s0, rows) if ar is None
               else R.derived_start(ar, ics, rows, sph, hcap, box))
        g = K.derived_gaps(got, ref)
        log[f"{name}.start"] = g
        readings[name]["start_err"] = K.worst(g)
    del ics, ref

    rec = c["record"]
    if sim.rungs > 1:
        pre = rec["pre"]
        rung = pre["rung"].to(dev).long()
        close = ((rec["k"] + 1) & ((1 << rung) - 1)) == 0
        gen = torch.Generator(device="cpu").manual_seed(sim.seed_rows + 1)
        cl = torch.nonzero(close).reshape(-1)
        pick = cl[torch.randperm(len(cl), generator=gen)[
            :int(chk["sample"]["closers"])].to(dev)]
        rows = torch.unique(torch.cat([pick, K.sample(
            n, sim.seed_rows + 2, chk["sample"], {}, dev)]))
        ref = K.tick_ref(R, f64, rec, rows, sim.rungs, sph, hcap, box)
        for name, ar in ariths:
            got = (K.tick_values(rec, rows) if ar is None else
                   K.tick_ref(R, ar, rec, rows, sim.rungs, sph, hcap, box))
            g, miss = K.tick_gaps(got, ref, box, ref)
            log[f"{name}.tick"] = dict(g, closers=int(ref["close"].sum()))
            readings[name]["tick_err"] = K.worst(g)
            readings[name]["rung_miss"] = miss
    else:
        out = rec["s_out"]
        rows = K.sample(n, sim.seed_rows + 1, chk["sample"],
                        {"top_acc": torch.linalg.norm(out.acc, dim=-1),
                         "top_u": out.u}, dev)
        drive, drive_out = None, None
        if sim.driven:
            d = cfg["drive"]
            modes = R.drive_modes(d["kmin"], d["kmax"], dev)
            gen = torch.Generator(device=dev).manual_seed(
                (sim.seed_noise << 32) | int(c["step_in"]))
            shape = c["drive_in"].amp_re.shape
            dts = [float(x) for x in c["dts"]]
            noise = [tuple(torch.randn(shape, generator=gen,
                                       dtype=sim.dtype, device=dev)
                           for _ in range(2)) for _ in dts]
            drive = (c["drive_in"].amp_re, c["drive_in"].amp_im, modes, d,
                     dts, noise)
            drive_out = (c["drive_out"].amp_re, c["drive_out"].amp_im)
        ref = K.step_ref(R, f64, rec, rows, sph, hcap, box, drive)
        for name, ar in ariths:
            got = (K.step_values(rec, rows, drive_out) if ar is None else
                   K.step_ref(R, ar, rec, rows, sph, hcap, box, drive))
            g = K.step_gaps(got, ref, box)
            log[f"{name}.step"] = g
            readings[name]["step_err"] = K.worst(g)
    # with the control, its readings stand where the program's stand and
    # decide ``correct`` by the same test; the program's are kept apart
    limits = chk["limits"]
    judged = readings["control" if control else "program"]
    compared = {k: {"value": v, "limit": limits[k]}
                for k, v in judged.items()}
    return compared, (readings["program"] if control else None), log


def execute(cell, seed: int, seconds: float, trace: int, device,
            t0: float = T0, override: dict | None = None,
            control: bool = False):
    """Set up, warm up, measure, judge. Returns (result dict, lines for
    standard error)."""
    import torch

    from portbench import harness, spec
    from portbench import trace as TR

    cuda = device.type == "cuda"
    if cuda:
        # the driving force's matmul runs in full fp32, as the CLI sets it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    sim = harness.Sim(cell.config, cell.traffic, seed, device, override)
    sim.warm_up()
    setup_s = time.perf_counter() - t0

    tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with profile(activities=acts, acc_events=True) as prof:
            c = sim.window(math.inf,
                           episodes=int(cell.traffic["trace_episodes"]))
        tr = TR.from_profiler(prof, c["wall"])
        del prof
    else:
        c = sim.window(seconds)
    harness.sync(device)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    # free the program's state before the reference runs; the check keeps
    # the restore point and what the recorder holds
    final = (c["state"].pos, c["state"].h)
    c["state"] = None
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    compared, program, log = judge(sim, c, cell, control)
    t_check = time.perf_counter() - t_check
    run = Run(n=sim.n, counters={k: c[k] for k in (
        "steps", "chunks", "sim_time", "builds", "active", "episodes",
        "wall")}, setup_s=setup_s, peak_bytes=peak, config=cell.config,
        traffic=cell.traffic, trace=tr, final=final)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                  for v in compared.values())
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda
                else "cpu", "count": 1, "memory_peak_bytes": peak}
    res = {"correct": correct, "attempted": c["steps"], "failed": 0,
           "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        res["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
    res["card"] = card() if cuda else "cpu"
    res["window"] = {k: run.counters[k] for k in ("steps", "chunks",
                                                   "episodes", "wall")}
    res["check_s"] = t_check
    if program is not None:
        res["control"] = True
        res["program"] = program
    res["compared"] = compared
    lines = [f"gaps {k}: " + json.dumps(v) for k, v in log.items()]
    lines += [f"{k} {v['value']!r} limit {v['limit']!r}"
              for k, v in compared.items()]
    return res, lines


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device is visible; the benchmark runs on "
              "the card only", file=sys.stderr)
        return 2
    from portbench import spec

    cell = spec.cell(args.workload)
    if torch.cuda.device_count() < int(cell.entry["chips"]):
        print(f"portbench: {args.workload} needs {cell.entry['chips']} "
              f"cards, {torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    res, lines = execute(cell, args.seed, args.seconds, args.trace,
                         torch.device("cuda", 0), control=bool(args.control))
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: this process loaded {bad}; the port and the "
              "benchmark must not import JAX or the JAX package",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
