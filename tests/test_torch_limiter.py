"""Saitoh & Makino's timestep limiter and the wake-up of sleeping neighbours
on the rung path (``rungs.simulate_rungs(limiter=A)``, the pair passes of
``physics.rung_limit``), on the CPU through the plain versions.

With the limiter off the loop is bit for bit the loop before it
(``tests/_rungs_frozen.py``). With A = 4 every tick of two whole spans of
a Sedov blast on 6 rungs matches the benchmark's plain reference
(``portbench/reference_sm09.py``) through the check that decides the cell
``sedov256.sm09r8``'s ``correct``: the closers' fields and rungs, every
row's rung (the woken rows' among them), the woken rows' velocity and u,
and the sync point's rungs. The pass's plain version gives the reference's
neighbour mins; the trajectory keeps the limiter's promises (closers
within a of their neighbours' lowest rung, woken rows closing on their new
rung's boundary, each row's kicks summing to KDK over the steps it took);
planted faults read ``correct`` false; the CLI refuses the limiter where
it does not run it; the cell's readers read the program's counters.

Sizes: one span of 32 ticks at n = 12 a side (1,728 particles; the
reference's fp64 pass of a tick's closers and their neighbourhood takes
about 0.7 s), each run shared by the tests that read it; the extra-depth
cases (two spans at n = 16, the limiter off at n = 24) carry ``slow``.
"""
import dataclasses
import functools
import signal
import threading

import pytest
import torch

from portbench import check as K
from portbench import harness
from portbench import reference_sm09 as R
from portbench import spec as bench_spec
from sphax_torch import __main__ as cli
from sphax_torch import configs, problems
from sphax_torch.ics import sedov as sedov_ics
from sphax_torch.integrate import rungs
from sphax_torch.physics import rung_limit as RL
from tests._rungs_frozen import simulate_rungs_before

torch.set_num_threads(1)

CONFIG = bench_spec.load("configs", "sedov-sm09-256")
LIMITS = bench_spec.load("workloads", "sedov256.sm09r8")["limits"]
SPH = CONFIG["sph"]
F64, F32 = torch.float64, torch.float32
B = 6
N = 12              # a side, for one span of 32 ticks
SLOW = pytest.mark.slow
FIELDS = ("pos", "vel", "mass", "u", "h", "rho", "omega", "divv", "acc",
          "du_dt", "cs")


def limited(seconds: int):
    """A test's time limit: it fails with TimeoutError past ``seconds``
    (SIGALRM, where it runs on the main thread)."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            if threading.current_thread() is not threading.main_thread():
                return fn(*args, **kw)

            def over(signum, frame):
                raise TimeoutError(f"{fn.__name__} ran past {seconds} s")
            old = signal.signal(signal.SIGALRM, over)
            signal.alarm(seconds)
            try:
                return fn(*args, **kw)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)
        return run
    return deco


@functools.lru_cache(maxsize=None)
def _problem(n: int, dtype):
    """The CLI's sedov problem (``configs.SEDOV``, h_margin 1.5) on the
    window engine's plain versions, where the CPU would take the cell
    list."""
    ic = sedov_ics.build(n_side=n)
    dom = problems._box(ic, 3, dtype, "cpu")
    st = problems._state(ic, dtype, "cpu")
    eng, spec = problems._window_engine(st, configs.SEDOV, dom,
                                        h_margin=1.5)
    return problems.Problem("sedov", eng(st), configs.SEDOV, dom, eng,
                            t_end=0.06, wspec=spec, engine_name="window")


def _hcap(p):
    return 0.5 * p.wspec.cutoff


class Ticks:
    """Each tick of a ``simulate_rungs`` run: the state as ``open_drift``
    receives it (with the rungs, dt_min and the carried viscosity factor)
    and as the tick's last ``particle_dt`` sees it, with the closers' rungs
    from ``close_rungs``."""

    def __init__(self, monkeypatch):
        self.recs = []
        orig = {k: getattr(rungs, k) for k in (
            "open_drift", "_derived_rungs", "particle_dt", "close_rungs")}

        def open_drift(st, rung, dt_min, k, cfg):
            pre = {f: getattr(st, f).clone() for f in FIELDS}
            pre["rung"] = rung.clone()
            self.recs.append(dict(k=k, dt_min=dt_min.clone(), pre=pre))
            return orig["open_drift"](st, rung, dt_min, k, cfg)

        def derived_rungs(st, bf_prev, *args):
            self.recs[-1]["pre"]["bf"] = bf_prev.clone()
            return orig["_derived_rungs"](st, bf_prev, *args)

        def particle_dt(st, cfg):
            if self.recs:
                self.recs[-1]["post"] = {f: getattr(st, f).clone()
                                         for f in FIELDS}
            return orig["particle_dt"](st, cfg)

        def close_rungs(rung, dt_des, dt_min, close_m, k, n_rungs):
            out = orig["close_rungs"](rung, dt_des, dt_min, close_m, k,
                                      n_rungs)
            self.recs[-1]["closers_rung"] = out[0].clone()
            return out

        for name, fn in dict(open_drift=open_drift, particle_dt=particle_dt,
                             _derived_rungs=derived_rungs,
                             close_rungs=close_rungs).items():
            monkeypatch.setattr(rungs, name, fn)

    def after(self, t: int):
        """Every row's rung after tick t (the next tick's, within a
        span), or None at a span's end."""
        if t + 1 < len(self.recs) and self.recs[t + 1]["k"] > 0:
            return self.recs[t + 1]["pre"]["rung"]
        return None


@functools.lru_cache(maxsize=None)
def _run(n, dtype, nspans):
    """(problem, ticks, outputs, closers the limiter lowered) of
    ``nspans`` spans with the limiter (A = 4, the drift gate at 8), each
    tick recorded; made once and shared, read only."""
    p = _problem(n, dtype)
    low0 = rungs.LIMITED["sums"]
    low0 = 0 if low0 is None else int(low0[0])
    with pytest.MonkeyPatch.context() as m:
        ticks = Ticks(m)
        out = rungs.simulate_rungs(p.state, p.cfg, p.domain, p.wspec, nspans,
                                   n_rungs=B, adaptive_rebuild=8, limiter=4)
    assert int(out[3]) == 0
    return p, ticks, out, int(rungs.LIMITED["sums"][0]) - low0


def _closes(rung, k):
    return (torch.bitwise_and((1 << rung.long()) - 1, k + 1) == 0)


def _sample(rec, hcap, every: int = 37):
    """The rows a tick is judged on: its closers (every ninth at a span's
    end, where all close), the rows within 2 hcap of a closer that sleep on
    a rung a wake-up can shorten (above 2), and every ``every``-th row."""
    pre, k = rec["pre"], rec["k"]
    close = _closes(pre["rung"], k)
    n = close.numel()
    cl = torch.nonzero(close).reshape(-1)
    if len(cl) == n:
        return torch.arange(0, n, 9)
    x = torch.remainder(pre["pos"].double(), 1.0)
    near = R.Grid(x, 2.0 * hcap).pairs(cl)[1]
    near = near[(pre["rung"][near] > 2) & ~close[near]]
    return torch.unique(torch.cat([cl, near, torch.arange(0, n, every)]))


def _judge(rec, rows, hcap, ar=None):
    """(gaps, rung misses, reference) of one tick on ``rows`` through the
    cell's check: ``check.tick_gaps`` of the program against
    ``reference_sm09.rung_tick`` in float64."""
    ar = ar or R.Arith()
    ref = R.rung_tick(ar, rec["pre"], rows, rec["k"], rec["dt_min"], B, SPH,
                      hcap, 1.0)
    got = {f: rec["post"][f][rows] for f in ("pos", "vel", "u", "h", "rho",
                                             "divv", "acc", "du_dt")}
    got["rung"] = rec["closers_rung"][rows]
    got["dt_min"] = ref["dt_min"] = rec["dt_min"].reshape(1)
    g, miss = K.tick_gaps(got, ref, 1.0, ref)
    return g, miss, ref


# ---- the limiter off --------------------------------------------------------


@limited(240)
@pytest.mark.parametrize("n", [N, pytest.param(24, marks=SLOW)])
@pytest.mark.parametrize("n_rungs,nspans", [(3, 2), (5, 1)])
@pytest.mark.parametrize("adaptive", [0, 8])
def test_limiter_off_is_the_loop_before_it(n_rungs, nspans, adaptive, n):
    """limiter=0: every output of the loop, the state and the counters,
    equals the loop before the limiter bit for bit (n = 12, and 24 in the
    slow cases; fixed cadence and drift-gated)."""
    p = _problem(n, F32)
    kw = dict(nspans=nspans, n_rungs=n_rungs, adaptive_rebuild=adaptive)
    got = rungs.simulate_rungs(p.state, p.cfg, p.domain, p.wspec, **kw)
    want = simulate_rungs_before(p.state, p.cfg, p.domain, p.wspec, **kw)
    for f in got[0]._fields:
        a, b = getattr(got[0], f), getattr(want[0], f)
        assert torch.equal(a, b), f
    for a, b in zip(got[1:5], want[1:5]):
        assert torch.equal(a, b)
    assert got[5] == want[5]
    assert int(got[2].min()) < p.state.n


# ---- the pair passes --------------------------------------------------------


@limited(120)
def test_pass_plain_equals_the_references_mins():
    """On a drifted Sedov state with seeded rungs: the tick pass's
    neighbour mins equal the reference's (brute force by the minimum
    image, fp64) on every closer, and its wake targets the rule's; the
    sync passes reach ``reference_sm09.sync_limit``'s fixed point in
    ``sync_passes`` passes and no fewer suffice in general."""
    p = _problem(N, F64)
    st = p.state
    gen = torch.Generator().manual_seed(7)
    st = st._replace(pos=p.domain.wrap(st.pos + 0.05 * st.h[:, None] * (
        torch.rand(st.pos.shape, generator=gen, dtype=F64) - 0.5)))
    wd = rungs.win.build(st.pos, p.domain, p.wspec)
    n = st.n
    rung = torch.randint(0, B, (n,), generator=gen, dtype=torch.int32)
    r_des = torch.randint(0, B, (n,), generator=gen, dtype=torch.int32)
    k, a = 7, 2
    m, target, limited = RL.tick(wd, p.wspec, st.pos, st.h, st.mass, rung,
                                 r_des, k, a, rungs._alignment(k + 1, B), B)
    close = _closes(rung, k)
    assert 0 < int(close.sum()) < n
    x = torch.remainder(st.pos, 1.0)
    grid = R.Grid(x, 2.0 * float(st.h.max()) * 1.001)
    every = torch.arange(n)
    i, j, r, edge = R.neighbour_pairs(grid, st.h, every)
    near = r < edge
    i, j = i[near], j[near]
    want_m = R._lowest(i, rung.long()[j], n, B)
    assert torch.equal(m[close].long(), want_m[close])
    assert bool((m[~close] == B - 1).all())
    # the closers' new rungs, and the wake targets they give
    ri, rd = rung.long(), r_des.long()
    rn = R._aligned(torch.minimum(rd, want_m + a), ri, k, B)
    ru = R._aligned(rd, ri, k, B)
    assert int(limited) == int(((rn < ru) & close).sum()) > 0
    pv = torch.where(close, rn + a, B)[i]
    k0 = k - (k % (1 << ri[j]))
    need = torch.ceil(torch.log2((k + 2 - k0).double())).long()
    v = torch.maximum(pv, need)
    hit = close[i] & ~close[j] & (ri[j] > pv) & (v < ri[j])
    want_t = ri.clone().scatter_reduce(0, j[hit], v[hit], reduce="amin")
    assert torch.equal(target.long(), want_t)
    assert bool((target < rung).any())
    # the sync point
    passes = RL.sync_passes(B, a)
    got = rung
    for _ in range(passes):
        got = RL.sync(wd, p.wspec, st.pos, st.h, st.mass, got, a, B)
    want = R.sync_limit(R.Arith(), st.pos, st.h, rung, B, 1.0)
    assert torch.equal(got, want)
    assert not torch.equal(want, rung)
    assert RL.sync_passes(8, 2) == 3 and RL.sync_passes(3, 2) == 0
    assert RL.sync_passes(5, 2) == 1 and RL.sync_passes(8, 3) == 2


@limited(30)
def test_need_rung_is_the_bit_length():
    """The least rung whose step from a sleeping row's opening ends after
    tick k: ceil(log2(k + 2 - k0))."""
    rung = torch.arange(6, dtype=torch.int32).repeat_interleave(32)
    ks = torch.arange(32).repeat(6)
    for k in range(32):
        got = RL.need_rung(rung, k, 6)
        k0 = k - (k % (1 << rung.long()))
        want = torch.ceil(torch.log2((k + 2 - k0).double())).long()
        assert torch.equal(got.long(), want), k
    assert ks.numel() == rung.numel()


# ---- whole spans against the reference --------------------------------------


@limited(900)
@pytest.mark.parametrize("n,nspans", [(N, 1), pytest.param(16, 2,
                                                           marks=SLOW)])
@pytest.mark.parametrize("dtype", [F64, F32])
def test_limited_spans_match_the_reference(dtype, n, nspans):
    """Whole spans of 32 ticks (B = 6, the drift gate at 8; one at n = 12,
    two at n = 16 in the slow cases): every tick through the cell's check
    against ``reference_sm09`` (fp64: 1e-9 and no rung missed; fp32: the
    cell's limits), on the closers, the rows near them and every 37th row;
    every row's rung after the tick (the woken rows' too) as the reference
    has it, the others' unchanged; and the sync point's rungs as
    ``reference_sm09.sync_limit`` makes them from the unlimited ones. The
    limiter lowers closers' rungs and wakes rows in these spans."""
    p, ticks, out, lowered = _run(n, dtype, nspans)
    hcap = _hcap(p)
    tol = 1e-9 if dtype == F64 else LIMITS["tick_err"]
    woken = 0
    for t, rec in enumerate(ticks.recs):
        pre, k = rec["pre"], rec["k"]
        if k == 0:
            dt = R.particle_dt(pre["h"].double(), pre["cs"].double(),
                               pre["acc"].double(), SPH)
            start = R.rung_of(dt, rec["dt_min"].double(), B)
            want = R.sync_limit(R.Arith(), pre["pos"], pre["h"], start, B,
                                1.0)
            sure = _sure(dt, rec["dt_min"])
            assert torch.equal(pre["rung"][sure], want[sure]), t
            assert sure.float().mean() > 0.99
        rows = _sample(rec, hcap)
        g, miss, ref = _judge(rec, rows, hcap)
        assert K.worst(g) <= tol and miss == 0, (t, k, g, miss)
        after = ticks.after(t)
        if after is None:
            continue
        close = _closes(pre["rung"], k)
        sure = torch.abs(ref["log2_ratio"] - torch.round(
            ref["log2_ratio"])) > 1e-4
        keep = sure | ~ref["close"]
        assert torch.equal(after[rows][keep], ref["rung"][keep].to(
            torch.int32)), (t, k)
        off = torch.ones_like(close)
        off[rows] = False
        assert torch.equal(after[off], pre["rung"][off])
        woken += int(((after < pre["rung"]) & ~close).sum())
    assert woken > 0 and lowered > 0


def _sure(dt, dt_min):
    lr = torch.log2(torch.clamp_min(dt / dt_min.double(), 1.0))
    return torch.abs(lr - torch.round(lr)) > 1e-4


@limited(120)
def test_limited_trajectory_keeps_the_limiters_promises():
    """fp64, n = 12, B = 6, a span: after every tick no closer's rung
    exceeds its neighbours' lowest current rung by more than 2; every woken
    row closes next on its new rung's first boundary; and over each span
    every row's velocity changes by the sum of 1/2 tau (a_open + a_close)
    over the steps it took, tau the step it took (the wake-up's correction
    makes a woken row's opening half-kick that of its shorter step)."""
    p, ticks, out, _ = _run(N, F64, 1)
    recs = ticks.recs
    n = p.state.n
    span = 1 << (B - 1)
    woken_seen = 0
    for s0 in range(0, len(recs), span):
        spn = recs[s0:s0 + span]
        v0 = spn[0]["pre"]["vel"]
        opened = torch.zeros(n, dtype=torch.long)
        a_open = spn[0]["pre"]["acc"].clone()
        kick = torch.zeros_like(v0)
        due = torch.full((n,), -1, dtype=torch.long)
        for t, rec in enumerate(spn):
            pre, post, k = rec["pre"], rec["post"], rec["k"]
            close = _closes(pre["rung"], k)
            assert bool((due[~close] != k).all()), k
            assert bool((due[close] <= k).all()), k
            new = rec["closers_rung"]
            x = torch.remainder(post["pos"], 1.0)
            grid = R.Grid(x, 2.0 * float(post["h"].max()) * 1.001)
            cl = torch.nonzero(close).reshape(-1)
            i, j, r, edge = R.neighbour_pairs(grid, post["h"], cl)
            near = r < edge
            low = R._lowest(i[near], pre["rung"].long()[j[near]], len(cl),
                            B)
            assert bool((new[cl].long() <= low + 2).all()), k
            tau = (k + 1 - opened[cl]).double() * rec["dt_min"]
            kick[cl] += 0.5 * tau[:, None] * (a_open[cl] + post["acc"][cl])
            a_open[cl] = post["acc"][cl]
            opened[cl] = k + 1
            if t + 1 < len(spn):
                after = spn[t + 1]["pre"]["rung"]
                woke = torch.nonzero((after < pre["rung"]) & ~close)
                woke = woke.reshape(-1)
                woken_seen += len(woke)
                r_new = after[woke].long()
                k0 = k - (k % (1 << pre["rung"][woke].long()))
                due[woke] = k0 + (1 << r_new) - 1
                assert bool((due[woke] > k).all())
        vmax = float(v0.norm(dim=-1).max()) + float(
            spn[-1]["post"]["vel"].norm(dim=-1).max())
        gap = (spn[-1]["post"]["vel"] - v0 - kick).abs().max()
        assert float(gap) <= 1e-10 * vmax, float(gap) / vmax
    assert woken_seen > 0


# ---- planted faults ---------------------------------------------------------


def _fault_limiter_skipped(monkeypatch):
    tick = RL.tick

    def no_cap(wd, spec, pos, h, mass, rung, r_des, k, a, align, n_rungs):
        m, target, low = tick(wd, spec, pos, h, mass, rung, r_des, k, a,
                              align, n_rungs)
        return torch.full_like(m, n_rungs - 1), target, low * 0
    monkeypatch.setattr(RL, "tick", no_cap)
    monkeypatch.setattr(RL, "sync_passes", lambda n_rungs, a: 0)


def _fault_wake_skipped(monkeypatch):
    tick = RL.tick

    def no_wake(wd, spec, pos, h, mass, rung, r_des, k, a, align, n_rungs):
        m, _, low = tick(wd, spec, pos, h, mass, rung, r_des, k, a, align,
                         n_rungs)
        return m, rung.clone(), low
    monkeypatch.setattr(RL, "tick", no_wake)


def _fault_kick_skipped(monkeypatch):
    wake = rungs.wake

    def no_kick(st, rung, target, dt_min, cfg):
        return st, wake(st, rung, target, dt_min, cfg)[1]
    monkeypatch.setattr(rungs, "wake", no_kick)


FAULTS = {"limiter skipped": (_fault_limiter_skipped, 4),
          "wake-up skipped": (_fault_wake_skipped, 4),
          "kick correction skipped": (_fault_kick_skipped, 4),
          "A = 8": (None, 8)}


def _woke(ticks, t: int) -> bool:
    """Whether tick t of a run woke a row."""
    after = ticks.after(t)
    return after is not None and bool(
        (after < ticks.recs[t]["pre"]["rung"]).any())


@limited(180)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_read_incorrect(monkeypatch, fault):
    """fp32, n = 12, B = 6: a program with the fault reads ``correct``
    false by the cell's limits (tick_err or rung_miss) on some tick of its
    first span, judged on the closers, the rows near them and every 37th
    row, where the sound program reads true on every tick
    (``test_limited_spans_match_the_reference``). The ticks at which the
    sound program woke rows are judged first."""
    plant, limiter = FAULTS[fault]
    p = _problem(N, F32)
    sound = _run(N, F32, 1)[1]
    with monkeypatch.context() as m:
        if plant is not None:
            plant(m)
        ticks = Ticks(m)
        out = rungs.simulate_rungs(p.state, p.cfg, p.domain, p.wspec, 1,
                                   n_rungs=B, adaptive_rebuild=8,
                                   limiter=limiter)
    assert int(out[3]) == 0
    hcap = _hcap(p)
    for t in sorted(range(len(ticks.recs)), key=lambda t: not _woke(sound, t)):
        rec = ticks.recs[t]
        g, miss, _ = _judge(rec, _sample(rec, hcap), hcap)
        if not (K.worst(g) <= LIMITS["tick_err"]
                and miss <= LIMITS["rung_miss"]):
            return
    pytest.fail(f"{fault}: every tick read correct")


# ---- the benchmark's recorder, the CLI and the readers ----------------------


@limited(120)
def test_the_benchmarks_recorder_sees_the_woken_rows():
    """``portbench.harness.Recorder`` around a limited span keeps, at its
    tick, the state the tick ends with (the woken rows' corrected velocity
    and u) and the closers' limited rungs: the state of a tick with woken
    rows, recorded by the recorder, equals ``Ticks``'."""
    p, ticks, _, _ = _run(N, F64, 1)
    woke = [t for t in range(len(ticks.recs)) if _woke(ticks, t)]
    assert woke
    t = woke[0]
    rec = harness.Recorder(B, ticks.recs[t]["k"], host=True)
    with rec.installed():
        rec.arm(True, 1 << (B - 1))
        rungs.simulate_rungs(p.state, p.cfg, p.domain, p.wspec, 1,
                             n_rungs=B, adaptive_rebuild=8, limiter=4)
    want = ticks.recs[t]
    for f in ("pos", "vel", "u"):
        assert torch.equal(rec.rec["post"][f], want["post"][f]), f
    assert torch.equal(rec.rec["post"]["rung"], want["closers_rung"])
    assert torch.equal(rec.rec["pre"]["rung"], want["pre"]["rung"])


@limited(120)
def test_rung_chunk_runs_the_problems_limiter():
    """``__main__.rung_chunk`` hands the problem's ``rung_limiter`` to the
    loop, so the benchmark's harness runs the limiter with no edit."""
    p = _problem(N, F32)._replace(rung_limiter=4)
    want = _run(N, F32, 1)[2]
    w0 = rungs.WOKEN["ticks"]
    st, dts, ovf, viol, frac, builds = cli.rung_chunk(p, p.state, B, 32, 8)
    assert rungs.WOKEN["ticks"] == w0 + 32
    assert torch.equal(st.vel, want[0].vel) and torch.equal(dts, want[1])
    assert int(ovf) == 0 and viol == 0 and 0.0 < frac < 1.0


@limited(60)
def test_sedov_takes_a_limiter_that_is_a_power_of_two():
    p = problems.sedov(n=6, limiter=4, device="cpu", dtype=F64)
    assert p.rung_limiter == 4
    assert problems.sedov(n=6, device="cpu", dtype=F64).rung_limiter == 0
    for bad in (3, 1, -4):
        with pytest.raises(SystemExit, match="power of two"):
            problems.sedov(n=6, limiter=bad, device="cpu", dtype=F64)
    assert rungs.limiter_exponent(0) is None
    assert rungs.limiter_exponent(8) == 3


@limited(60)
def test_cli_refuses_a_limiter_without_rungs(tmp_path):
    with pytest.raises(SystemExit, match="rungs=B > 1"):
        cli.main(["sedov", "n=6", "limiter=4", "device=cpu",
                  f"out={tmp_path}"])


@limited(60)
@pytest.mark.parametrize("shards,loop", [("2", "dist/wrungs.py"),
                                         ("2x2", "dist/prungs.py")])
def test_cli_refuses_the_limiter_on_shards(shards, loop, tmp_path):
    """The slab and the pencil ranks' rung loops keep no limiter: the CLI
    says so before it splits the box."""
    with pytest.raises(SystemExit, match=loop.replace(".", r"\.")):
        cli.main(["sedov", "n=12", "rungs=2", "limiter=4", "device=cpu",
                  f"shards={shards}", f"out={tmp_path}"])


@dataclasses.dataclass
class _Run:
    n: int
    counters: dict
    config: dict
    trace: object = None


@limited(60)
def test_the_cells_readers_read_the_programs_counters(monkeypatch):
    """``limited_frac.sm09`` and ``woken_per_tick.sm09`` read the program's
    counters, and nothing where the program keeps none (the parent);
    ``limiter_ms_per_tick.sm09`` and ``limiter_roofline.sm09`` read nothing
    without a trace."""
    run = _Run(n=4096, counters=dict(steps=32, active=0.5), config=CONFIG)
    monkeypatch.setattr(rungs, "LIMITED", {"sums": torch.tensor([3, 12])})
    monkeypatch.setattr(rungs, "WOKEN", {"sums": torch.tensor([8]),
                                         "ticks": 4})
    assert bench_spec.reader("limited_frac.sm09")(run) == 25.0
    assert bench_spec.reader("woken_per_tick.sm09")(run) == 2.0
    for name in ("limiter_ms_per_tick.sm09", "limiter_roofline.sm09",
                 "idle_share.sm09", "host_ms_per_tick.sm09"):
        assert bench_spec.reader(name)(run) is None, name
    monkeypatch.delattr(rungs, "LIMITED")
    monkeypatch.delattr(rungs, "WOKEN")
    assert bench_spec.reader("limited_frac.sm09")(run) is None
    assert bench_spec.reader("woken_per_tick.sm09")(run) is None
    assert CONFIG["problem_args"]["limiter"] == R.A == 1 << R._A
    assert CONFIG["reference"] == "reference_sm09"
