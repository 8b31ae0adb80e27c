"""``sphax_torch.entry.dryrun_multichip``, the twin of
``__graft_entry__.dryrun_multichip``, on 4 gloo ranks over CPU tensors at
the JAX dry run's sizes (the turbulence lattice at ceil(3.8 * 4)^3 = 16^3,
the pencil's own 12^3): the slab chunk, the rebalance and migration to
convergence, the B = 2 rung span and the 2x2 pencil chunk, each with its
own checks inside."""
import torch

from sphax_torch.entry import dryrun_multichip

torch.set_num_threads(1)


def test_dryrun_multichip_four_ranks(capfd):
    rec = dryrun_multichip(4, "cpu", timeout=120)
    assert rec["n"] == 16 ** 3 and rec["pencil"]["n"] == 12 ** 3
    s = rec["slab"]
    assert s["steps"] == 2 and s["dt_last"] > 0 and s["rung_ticks"] == 2
    assert 1 <= s["migrate_passes"] <= 4 and s["rung_closings"] > 0
    assert rec["pencil"]["steps"] == 2
    assert "dryrun_multichip OK: 4 ranks" in capfd.readouterr().out
