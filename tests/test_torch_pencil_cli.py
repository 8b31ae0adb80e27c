"""``python -m sphax_torch <problem> shards=AxB`` on the CPU (the port of
tests/dist/test_cli_multichip.py's pencil case): the pencil CLI on a 2x2
grid of gloo ranks tracks the single-device CLI run of ``turb`` at that
test's tolerances, resumes from its own ``shards=2x2`` checkpoint and
still tracks it, and runs block timesteps (``shards=2x2 rungs=2``). The
refusals (``adaptive=K`` with pencils, a malformed AxB) are
tests/test_torch_dist_cli.py's.
"""
import numpy as np

from sphax_torch.__main__ import main
from sphax_torch.io import checkpoint
from tests.test_torch_dist_cli import (ARGS, _check_against_single, _metrics,
                                       single_ref)  # noqa: F401

PENCIL = ["shards=2x2"]


def test_cli_turb_pencil_matches_single_device(single_ref, tmp_path,
                                               capfd):
    out = str(tmp_path / "p")
    st, t, step = main(ARGS + PENCIL + [f"out={out}", "rebuild_every=2"])
    assert st is None and step == 4
    _check_against_single(single_ref, out, "2x2")
    text = capfd.readouterr().out
    assert "[2x2 shards] count imbalance" in text
    c = _metrics(out)[0]["chunk"]
    assert c["builds"] == 1 and c["migrate_passes"] >= 1
    # the ranks' tensors live on the CPU here: nothing is staged
    assert c["staged_bytes_by_axis"] == {"sx": 0, "sy": 0}
    assert c["imbalance_before"] >= 1.0


def test_cli_pencil_resume(single_ref, tmp_path, capfd):
    """2 steps on the 2x2 grid, then a resume from that checkpoint (split
    anew into pencils) for 2 more: the same trajectory as the
    uninterrupted single-device run, and a checkpoint that says 2x2."""
    o = str(tmp_path / "r")
    main(ARGS[:3] + ["max_steps=2", "chunk=2", f"out={o}"] + PENCIL)
    st, t, step, _, x = checkpoint.load(f"{o}/checkpoint.npz", device="cpu")
    assert step == 2 and t > 0 and x["shards"] == "2x2"
    o2 = str(tmp_path / "r2")
    _, t2, step2 = main(ARGS + PENCIL + [f"out={o2}",
                                         f"resume={o}/checkpoint.npz"])
    assert "resumed from" in capfd.readouterr().out
    assert step2 == 4
    m1 = {r["step"]: r for r in _metrics(single_ref)}
    rec = _metrics(o2)[-1]
    np.testing.assert_allclose(rec["e_total"], m1[4]["e_total"], rtol=1e-5)
    s1, t1, _, d1, _ = checkpoint.load(f"{single_ref}/checkpoint.npz",
                                       device="cpu")
    s2, t2c, k2, d2, x2 = checkpoint.load(f"{o2}/checkpoint.npz",
                                          device="cpu")
    assert k2 == 4 and abs(t2c - t1) < 1e-6 and x2["shards"] == "2x2"
    np.testing.assert_allclose(d2.amp_re.numpy(), d1.amp_re.numpy(),
                               rtol=1e-6, atol=1e-12)
    assert s2.n == s1.n and np.isfinite(s2.rho.numpy()).all()


def test_cli_pencil_rungs_sedov(tmp_path, capfd):
    """shards=2x2 rungs=2: block timesteps on the pencils through the CLI,
    finite records with active_frac and dt_viol, the rung masks engaged."""
    out = str(tmp_path / "rg")
    _, t, step = main(["sedov", "n=12", "device=cpu", "rungs=2", "chunk=2",
                       "max_steps=4", f"out={out}"] + PENCIL)
    assert step == 4 and t > 0
    recs = _metrics(out)
    assert all(r["finite"] for r in recs)
    assert all(0 < r["active_frac"] < 1 and r["dt_viol"] == 0
               for r in recs[:2]), recs
    assert recs[0]["chunk"]["active_frac"] == recs[0]["active_frac"]
    st, _, k, d, x = checkpoint.load(f"{out}/checkpoint.npz", device="cpu")
    assert d is None and x["shards"] == "2x2" and st.n == 12 ** 3 and k == 4
    assert "active_frac=" in capfd.readouterr().out
