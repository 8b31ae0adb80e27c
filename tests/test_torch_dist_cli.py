"""``python -m sphax_torch <problem> shards=N`` on the CPU (the port of
tests/dist/test_cli_multichip.py): the distributed CLI runs distribute ->
chunk (structure reuse, replicated driving) -> rebalance and migration ->
all-reduced metrics -> gathered checkpoint, and tracks the single-device
CLI run of the same problem at that test's tolerances, at 2 and at 4
ranks; a run resumes from its own checkpoint (re-distributing it, with
drift-gated rebuilds) and still tracks it; block timesteps run on the
ranks and resume; and what the distributed loop does not run, or a
malformed ``shards``, is refused (``shards=AxB`` itself runs:
tests/test_torch_pencil_cli.py).
"""
import json
import os

import numpy as np
import pytest
import torch

from sphax_torch.__main__ import main
from sphax_torch.io import checkpoint

torch.set_num_threads(1)

ARGS = ["turb", "n=16", "device=cpu", "max_steps=4", "chunk=2",
        "metrics_every=1", "checkpoint_every=1"]


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def single_ref(tmp_path_factory):
    """One single-device CLI run shared by every case."""
    out = str(tmp_path_factory.mktemp("cli_single"))
    main(ARGS + [f"out={out}"])
    return out


def _check_against_single(o1, o2, shards):
    m1, m2 = _metrics(o1), _metrics(o2)
    assert len(m1) == len(m2)
    # the same dt sequence -> the same (t, step) trajectory; conserved and
    # all-reduced scalars agree to accumulation-order tolerance
    for r1, r2 in zip(m1, m2):
        assert r2["finite"]
        assert r1["step"] == r2["step"]
        np.testing.assert_allclose(r2["t"], r1["t"], rtol=1e-6)
        for k in ("e_kin", "e_int", "e_total", "mach_rms", "max_rho",
                  "mean_h"):
            np.testing.assert_allclose(r2[k], r1[k], rtol=1e-5, atol=1e-8,
                                       err_msg=k)

    # checkpoints: the same particles (the distributed one gather-ordered)
    s1, t1, k1, d1, _ = checkpoint.load(f"{o1}/checkpoint.npz", device="cpu")
    s2, t2, k2, d2, x2 = checkpoint.load(f"{o2}/checkpoint.npz",
                                         device="cpu")
    assert k1 == k2 and abs(t1 - t2) < 1e-6 * max(t1, 1.0)
    assert str(x2.get("shards")) == str(shards)
    assert s1.n == s2.n
    # the replicated drive stream matches the single-device one
    np.testing.assert_allclose(d2.amp_re.numpy(), d1.amp_re.numpy(),
                               rtol=1e-6, atol=1e-12)

    def order(s):
        # canonical (wrapped) coordinates: the two paths wrap at different
        # cadences
        p = np.mod(s.pos.double().numpy(), 1.0)
        return np.lexsort((p[:, 2], p[:, 1], p[:, 0]))

    a, b = order(s2), order(s1)
    np.testing.assert_allclose(s2.rho.numpy()[a], s1.rho.numpy()[b],
                               rtol=1e-5)


@pytest.mark.parametrize("shards", [2, 4])
def test_cli_turb_shards_matches_single_device(single_ref, tmp_path, shards,
                                               capfd):
    out = str(tmp_path / "dist")
    st, t, step = main(ARGS + [f"out={out}", f"shards={shards}",
                               "rebuild_every=2", "snapshot_every=2"])
    assert st is None and step == 4
    _check_against_single(single_ref, out, shards)
    assert os.path.exists(os.path.join(out, "snap_0000004.npz"))
    assert f"[{shards} shards]" in capfd.readouterr().out


def test_cli_dist_resume(single_ref, tmp_path, capfd):
    """2 steps on 2 ranks, then a resume from that checkpoint for 2 more
    with drift-gated rebuilds (the same physics): the resumed run equals
    the uninterrupted single-device run at the same tolerances, its records
    carry the builds, and its checkpoint says 2 shards."""
    o = str(tmp_path / "r")
    main(ARGS[:3] + ["max_steps=2", "chunk=2", "shards=2", f"out={o}"])
    st, t, step, _, _ = checkpoint.load(f"{o}/checkpoint.npz", device="cpu")
    assert step == 2 and t > 0
    o2 = str(tmp_path / "r2")
    main(ARGS + [f"out={o2}", "shards=2", "adaptive=2",
                 f"resume={o}/checkpoint.npz"])
    assert "resumed from" in capfd.readouterr().out
    recs = _metrics(o2)
    assert [r["step"] for r in recs] == [4, 4]
    assert 1 <= recs[0]["rebuilds"] <= 2
    m1 = {r["step"]: r for r in _metrics(single_ref)}
    np.testing.assert_allclose(recs[-1]["e_total"], m1[4]["e_total"],
                               rtol=1e-5)
    s1, t1, _, d1, _ = checkpoint.load(f"{single_ref}/checkpoint.npz",
                                       device="cpu")
    s2, t2, k2, d2, x2 = checkpoint.load(f"{o2}/checkpoint.npz", device="cpu")
    assert k2 == 4 and abs(t2 - t1) < 1e-6 and x2["shards"] == "2"
    np.testing.assert_allclose(d2.amp_re.numpy(), d1.amp_re.numpy(),
                               rtol=1e-6, atol=1e-12)
    assert np.isfinite(s2.rho.numpy()).all()


RUNGS = ["sedov", "n=8", "device=cpu", "shards=2", "rungs=2", "chunk=4",
         "metrics_every=1", "checkpoint_every=1"]


def test_cli_dist_rungs_sedov(tmp_path, capfd):
    """shards=N rungs=B (the port of tests/dist/test_cli_multichip.py's
    test_cli_dist_rungs_sedov): block timesteps on 2 ranks through the
    CLI, finite records carrying active_frac and dt_viol and the work
    imbalance in their chunk, the rung machinery engaged (fewer closings
    than particles), a checkpoint without driving state; then a resume
    from it, which re-distributes and keeps going."""
    out = str(tmp_path / "rg")
    _, t, step = main(RUNGS + ["max_steps=8", f"out={out}"])
    assert step == 8 and t > 0
    m = _metrics(out)
    assert [r["step"] for r in m] == [4, 8, 8]
    assert all(r["finite"] for r in m)
    recs = m[:2]
    assert all(0 < r["active_frac"] < 1 and r["dt_viol"] == 0
               for r in recs), recs
    for r in recs:
        c = r["chunk"]
        assert c["active_frac"] == r["active_frac"]
        assert c["imbalance_before"] >= 1 and c["imbalance_after"] >= 1
        # the plain versions launch no kernel (chip_smoke.py counts the
        # card's launches)
        assert c["launches"] == {}
    st, t1, k, d, x = checkpoint.load(f"{out}/checkpoint.npz", device="cpu")
    assert d is None and x["shards"] == "2"
    assert st.n == 512 and k == 8 and t1 == pytest.approx(t)
    assert "active_frac=" in capfd.readouterr().out

    o2 = str(tmp_path / "rg2")
    _, t2, step2 = main(RUNGS + ["max_steps=12", "adaptive=2", f"out={o2}",
                                 f"resume={out}/checkpoint.npz"])
    assert "resumed from" in capfd.readouterr().out
    assert step2 == 12 and t2 > t
    r = _metrics(o2)[0]
    assert r["finite"] and r["step"] == 12 and 1 <= r["rebuilds"] <= 4
    assert 0 < r["active_frac"] < 1 and r["dt_viol"] == 0
    st2 = checkpoint.load(f"{o2}/checkpoint.npz", device="cpu")[0]
    assert checkpoint.verify_integrity(st2) is None


@pytest.mark.parametrize("extra,msg", [
    (["shards=2x2", "adaptive=4"], "pencil"),
    (["shards=2", "rungs=2", "gravity=1"], "self-gravity"),
    (["shards=2", "profile=1"], "profile"), (["shards=0"], "shards=0"),
    (["rebuild_every=3"], "rebuild_every"), (["shards=0x2"], "shards=0x2"),
    (["shards=2xb"], "shards=2xb"), (["shards=2x2x2"], "shards=2x2x2"),
    (["shards=2x2", "plot=1"], "plot")])
def test_cli_refuses_unported(extra, msg, tmp_path):
    with pytest.raises(SystemExit, match=msg):
        main(["sedov", "n=8", "device=cpu", f"out={tmp_path}"] + extra)
