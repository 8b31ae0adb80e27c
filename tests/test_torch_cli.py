"""``python -m sphax_torch`` and the port's checkpoints, on the CPU.

The CLI writes the JAX CLI's metrics keys and a checkpoint, resumes from
it, clamps the last chunk to max_steps, parses bool overrides strictly,
writes its plots with plot=1, refuses the options it has not ported (and
plot=1 where matplotlib does not import), and raises without a card unless
asked for the CPU. Checkpoints move between the two packages field for
field.
"""
import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphax
from sphax.diag import conservation as jcons
from sphax.io import checkpoint as jckpt
from sphax.physics import driving as jdrv
from sphax_torch import configs as tconf
from sphax_torch import make_state, problems
from sphax_torch.__main__ import main
from sphax_torch.io import checkpoint
from sphax_torch.physics import driving

torch.set_num_threads(1)

SOD = ["sod", "n=8", "device=cpu"]


def _records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _jax_state(st):
    return sphax.ParticleState(**{k: jnp.asarray(getattr(st, k).numpy())
                                  for k in st._fields})


def test_cli_metrics_checkpoint_and_resume(tmp_path, capsys):
    out, out2 = str(tmp_path / "a"), str(tmp_path / "b")
    st, t, step = main(SOD + ["max_steps=4", "chunk=2", f"out={out}"])
    assert step == 4
    recs = _records(out)
    # one record per chunk and the final one, with the JAX CLI's keys:
    # conservation.summary's, then step and particle_steps_per_sec
    assert [r["step"] for r in recs] == [2, 4, 4]
    cfg = problems.sod(n=8, dtype=torch.float32, device="cpu").cfg
    want = list(jcons.summary(_jax_state(st), sphax.SPHConfig(
        **dataclasses.asdict(cfg)), t)) + ["step", "particle_steps_per_sec"]
    assert all(list(r) == want for r in recs)
    assert all(r["finite"] for r in recs)
    assert "engine=dense" in capsys.readouterr().out
    ck = os.path.join(out, "checkpoint.npz")
    st_c, t_c, step_c, drive, _ = checkpoint.load(ck, device="cpu")
    assert (t_c, step_c, drive) == (t, 4, None)
    for k in st._fields:
        assert torch.equal(getattr(st_c, k), getattr(st, k)), k

    # resume: the run starts at the saved step and time, and 2 more steps
    # from the saved state equal 2 more steps of the first run
    st2, t2, step2 = main(SOD + ["max_steps=6", "chunk=2", f"out={out2}",
                                 f"resume={ck}"])
    assert "resumed from" in capsys.readouterr().out
    assert step2 == 6 and t2 > t
    assert _records(out2)[0]["step"] == 6
    st3, t3, step3 = main(SOD + ["max_steps=6", "chunk=2",
                                 f"out={tmp_path / 'c'}"])
    assert step3 == 6 and t3 == pytest.approx(t2, rel=1e-12)
    for k in ("pos", "vel", "u", "h", "rho"):
        torch.testing.assert_close(getattr(st2, k), getattr(st3, k),
                                   rtol=1e-6, atol=1e-7)


def test_max_steps_clamps_the_last_chunk(tmp_path):
    """max_steps=3 chunk=16 runs 4 steps (3 rounded up to whole rebuild
    periods of 2), not 16; profile=1 traces the first chunk."""
    _, _, step = main(SOD + ["max_steps=3", "chunk=16", "profile=1",
                             f"out={tmp_path}"])
    assert step == 4
    assert [r["step"] for r in _records(str(tmp_path))] == [4, 4]
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("value,want", [("false", False), (0, False),
                                        ("no", False), ("False", False),
                                        ("true", True), (1, True),
                                        ("yes", True)])
def test_bool_overrides_parse(value, want):
    assert problems._cfg_kw(tconf.KH, {"h_predict": value}).h_predict is want


@pytest.mark.parametrize("kv", [{"h_predict": "maybe"},
                                {"h_predict": 2},
                                {"no_such_knob": 1}])
def test_bad_overrides_raise(kv):
    with pytest.raises(SystemExit):
        problems._cfg_kw(tconf.KH, kv)


@pytest.mark.parametrize("opt", ["shards=2x2", "plot=1", "rebuild_every=4",
                                 "plot=1 shards=2"])
def test_unported_options_raise(opt, tmp_path, monkeypatch):
    # shards=N runs the slab decomposition and shards=AxB the pencil one,
    # with rungs=B too (tests/test_torch_dist_cli.py,
    # tests/test_torch_pencil_cli.py), but not on a box too thin for that
    # many shards, as this Sod tube; plot=1 runs where matplotlib imports
    # (test_cli_plot_writes_pngs) and is refused before the run where it
    # does not, as on the card's machine
    if opt == "plot=1":
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="not ported|rebuilds|matplotlib|"
                                         "single-device|thinner"):
        main(SOD + opt.split() + [f"out={tmp_path}"])
    assert not os.path.exists(tmp_path / "metrics.jsonl")


@pytest.mark.parametrize("name,png", [("sod", "profile.png"),
                                      ("kh", "slice.png")])
def test_cli_plot_writes_pngs(name, png, tmp_path):
    """plot=1 writes the JAX CLI's plots at the end of the run: the Sod
    profile (or a slice of kh) and the metrics history."""
    main([name, "n=8", "device=cpu", "max_steps=2", "plot=1",
          f"out={tmp_path}"])
    for f in (png, "history.png"):
        assert os.path.getsize(tmp_path / f) > 1000, f


def test_plots_render(tmp_path):
    """The plots render to PNG without a display (the port of
    tests/unit/test_io.py::test_plots_render), from the port's state."""
    from sphax_torch.diag import plots

    rng = np.random.default_rng(0)
    st = make_state(*(torch.as_tensor(a) for a in (
        rng.random((64, 3)), rng.normal(size=(64, 3)), np.full(64, 1 / 64),
        np.ones(64), np.full(64, 0.1))))
    st = st._replace(rho=torch.ones(64, dtype=torch.float64),
                     P=torch.ones(64, dtype=torch.float64),
                     cs=torch.ones(64, dtype=torch.float64))
    p1 = plots.sod_profile(st, 0.1, str(tmp_path / "sod.png"))
    p2 = plots.sedov_profile(st, 0.05, str(tmp_path / "sedov.png"))
    p3 = plots.slice_2d(st, str(tmp_path / "slice.png"))
    for p in (p1, p2, p3):
        assert os.path.getsize(p) > 1000


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device runs there")
    with pytest.raises(SystemExit, match="device=cpu"):
        main(["sod", "n=8", f"out={tmp_path}"])
    with pytest.raises(SystemExit, match="unknown problem"):
        main(["nope", "device=cpu"])


def _driven_state(seed=4):
    # any state will do: the fields are only moved
    st = problems.sod(n=8, dtype=torch.float64, device="cpu").state
    rng = np.random.default_rng(seed)
    dr = driving.DriveState(amp_re=torch.as_tensor(rng.normal(size=(9, 3))),
                            amp_im=torch.as_tensor(rng.normal(size=(9, 3))))
    return st, dr


def test_port_checkpoint_loads_in_sphax(tmp_path):
    st, dr = _driven_state()
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, st, 0.125, 7, drive=dr, extra={"run": "x"},
                    seed=3)
    # the write is atomic: no temporary file is left behind
    assert os.listdir(tmp_path) == ["ck.npz"]
    jst, t, step, jdr, extra = jckpt.load(path)
    assert (t, step, extra) == (0.125, 7, {"run": "x"})
    for k in st._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jst, k)),
                                      getattr(st, k).numpy(), k)
    np.testing.assert_array_equal(np.asarray(jdr.amp_re), dr.amp_re.numpy())
    np.testing.assert_array_equal(np.asarray(jdr.amp_im), dr.amp_im.numpy())
    # drive/key is (seed, step) as uint32[2]: a key the JAX driving takes
    np.testing.assert_array_equal(np.asarray(jdr.key), [3, 7])
    assert np.asarray(jdr.key).dtype == np.uint32
    jdrv.update(jdr, jnp.asarray(jdrv.make_modes(1, 2)[:9]), 0.01, 0.5, 3.0)
    with np.load(path) as z:
        assert json.loads(bytes(z["meta"]).decode())["schema"] == 2


def test_sphax_checkpoint_loads_in_port(tmp_path):
    st, dr = _driven_state(5)
    jst = _jax_state(st)
    jdr = jdrv.DriveState(jnp.asarray(dr.amp_re.numpy()),
                          jnp.asarray(dr.amp_im.numpy()),
                          jnp.asarray([11, 12], jnp.uint32))
    path = str(tmp_path / "ck.npz")
    jckpt.save(path, jst, 0.5, 9, jdr)
    tst, t, step, tdr, extra = checkpoint.load(path, device="cpu")
    assert (t, step, extra) == (0.5, 9, {})
    for k in st._fields:
        assert torch.equal(getattr(tst, k), getattr(st, k)), k
    assert torch.equal(tdr.amp_re, dr.amp_re)
    assert torch.equal(tdr.amp_im, dr.amp_im)
    # a dtype asked for on load converts every field
    assert checkpoint.load(path, device="cpu",
                           dtype=torch.float32)[0].rho.dtype == torch.float32


def test_checkpoint_schema_and_integrity(tmp_path):
    st, _ = _driven_state()
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, st, 0.0, 0)
    with np.load(path) as z:
        payload = dict(z)
    # an older file without divv and alpha migrates forward
    del payload["state/divv"], payload["state/alpha"]
    old = str(tmp_path / "old.npz")
    np.savez(old, **payload)
    st_old = checkpoint.load(old, device="cpu")[0]
    assert torch.equal(st_old.alpha, torch.ones_like(st.rho))
    assert torch.equal(st_old.divv, torch.zeros_like(st.rho))
    # a newer schema is refused
    meta = json.loads(bytes(payload["meta"]).decode())
    meta["schema"] = 3
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    new = str(tmp_path / "new.npz")
    np.savez(new, **payload)
    with pytest.raises(ValueError, match="newer"):
        checkpoint.load(new, device="cpu")
    assert checkpoint.verify_integrity(st) is None
    bad = st._replace(rho=st.rho.clone().index_fill_(0, torch.tensor([3]),
                                                      float("nan")))
    assert checkpoint.verify_integrity(bad) == "non-finite values in rho"
    assert checkpoint.verify_integrity(st._replace(h=-st.h)) == \
        "non-positive smoothing length"


def test_noise_reseed_repeats_the_stream():
    """A driven CLI run reseeds its noise from (seed, step) at every chunk,
    so a run resumed at a step draws what the uninterrupted run drew."""
    noise = driving.gaussian_noise(torch.Generator().manual_seed(1))
    noise.reseed(1, 16)
    a = noise((9, 3), torch.float64, "cpu")
    noise((9, 3), torch.float64, "cpu")
    noise.reseed(1, 16)
    b = noise((9, 3), torch.float64, "cpu")
    noise.reseed(1, 18)
    c = noise((9, 3), torch.float64, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def _driven_sod(device=None, dtype=torch.float32, seed=1, **kw):
    """sod with OU driving on the dense engine: a driven problem that runs
    in a second on the CPU (turb's window engine takes far longer)."""
    p = problems.sod(n=8, dtype=dtype, device=device, **kw)
    modes = tuple(map(tuple, driving.make_modes(1, 2).astype(int)))
    return p._replace(
        drive=driving.init(len(modes), dtype=dtype, device=device),
        drive_spec=driving.DriveSpec(modes=modes, tau=0.5, accel_rms=3.0),
        noise=driving.gaussian_noise(torch.Generator(device=device)),
        seed=seed)


def test_driven_cli_resume_is_exact(tmp_path, monkeypatch):
    """A driven run through the CLI: 2 + 2 steps through a checkpoint
    equal 4 steps, because the noise restarts from (seed, step) at every
    chunk; the checkpoint's drive/key holds (seed, step)."""
    monkeypatch.setitem(problems.REGISTRY, "driven", _driven_sod)
    base = ["driven", "chunk=2", "device=cpu", "seed=5"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    main(base + ["max_steps=2", f"out={a}"])
    st_r, _, step_r = main(base + ["max_steps=4", f"out={b}",
                                   f"resume={a}/checkpoint.npz"])
    st_f, _, step_f = main(base + ["max_steps=4", f"out={tmp_path / 'f'}"])
    assert step_r == step_f == 4
    for k in ("pos", "vel", "u", "h", "rho"):
        assert torch.equal(getattr(st_r, k), getattr(st_f, k)), k
    with np.load(f"{b}/checkpoint.npz") as z:
        np.testing.assert_array_equal(z["drive/key"], [5, 4])
        assert bool(np.any(z["drive/amp_re"] != 0.0))
