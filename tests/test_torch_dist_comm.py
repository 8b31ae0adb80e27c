"""``sphax_torch.dist.comm``: the ring, the reductions and the gather on 1,
2 and 4 gloo ranks over CPU tensors (the two messages of one exchange keep
their direction when both neighbours are the same peer), the rings along
the two axes of a rank grid (a ring of one along an axis hands a rank its
own messages), and a rank that raises or hangs makes ``launch`` raise
within its timeout. The rank
programs below are module-level so that the spawned ranks import them;
this module imports no JAX."""
import time

import numpy as np
import pytest
import torch

from sphax_torch.dist import comm

torch.set_num_threads(1)


def _collectives(c):
    """Each rank sends (rank, 0) to the left and (rank, 1) to the right,
    passes a block right, reduces, gathers rank+1 rows of its rank, and
    waits at the barrier."""
    r = c.rank
    to_l = torch.tensor([[r, 0.0]] * 3, dtype=torch.float64)
    to_r = torch.tensor([[r, 1.0]] * 3, dtype=torch.float64)
    fr, fl = c.ring(to_l, to_r)
    none, right_only = c.ring(None, torch.full((2,), float(r)))
    gathered = c.gather_rows(torch.full((r + 1, 2), float(r)))
    c.barrier()
    return dict(
        rank=r, left=c.left, right=c.right, from_right=fr.tolist(),
        from_left=fl.tolist(), none=none, right_only=right_only.tolist(),
        sum=c.all_reduce_sum(torch.tensor([r + 1.0, 1.0])).tolist(),
        min=float(c.all_reduce_min(torch.tensor(r + 5.0))),
        max=int(c.all_reduce_max(torch.tensor(r + 5, dtype=torch.int64))),
        gather=None if gathered is None else gathered.tolist())


def _grid_rings(c, ns0, ns1):
    """On an ns0 x ns1 grid, each rank sends (rank, axis, 0) left and
    (rank, axis, 1) right along each axis; every rank's (coords, what
    arrived from the right and from the left on each axis) on rank 0."""
    c.grid(ns0, ns1)
    out = list(c.coords)
    for axis in (0, 1):
        fr, fl = c.ring(torch.tensor([c.rank, axis, 0.0]),
                        torch.tensor([c.rank, axis, 1.0]), axis=axis)
        out += fr.tolist() + fl.tolist()
    return c.gather_rows(torch.tensor([out], dtype=torch.float64))


def _own_rows(c, shared, own):
    """Returns what this rank was handed: the shared argument and its own."""
    return c.all_reduce_sum(torch.tensor([float(own["rank"])])).item(), \
        shared, own


def _raise_on_last(c):
    if c.rank == c.world - 1:
        raise ValueError("rank fails on purpose")
    c.all_reduce_sum(torch.ones(1))


def _hang_on_last(c):
    if c.rank == c.world - 1:
        time.sleep(600)
    c.all_reduce_sum(torch.ones(1))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_collectives(world):
    got = comm.launch(_collectives, world, "cpu", "gloo", timeout=30,
                      deadline=120)
    left, right = (world - 1) % world, 1 % world
    assert (got["rank"], got["left"], got["right"]) == (0, left, right)
    # rank 0 receives what its right neighbour sent left and what its left
    # neighbour sent right: with 2 ranks both are rank 1, and the tags keep
    # the two apart
    assert got["from_right"] == [[float(right), 0.0]] * 3
    assert got["from_left"] == [[float(left), 1.0]] * 3
    assert got["none"] is None
    assert got["right_only"] == [float(left)] * 2
    assert got["sum"] == [world * (world + 1) / 2, float(world)]
    assert (got["min"], got["max"]) == (5.0, 4 + world)
    assert got["gather"] == [[float(r)] * 2 for r in range(world)
                             for _ in range(r + 1)]


@pytest.mark.parametrize("grid", [(2, 2), (1, 2), (2, 1), (2, 3)])
def test_grid_rings(grid):
    """rank = i0 * ns1 + i1; along axis 0 the neighbours are i0 -+ 1 and
    along axis 1 i1 -+ 1, cyclic; with two along an axis both messages come
    from the one peer, each in its own direction; with one, a rank's own
    messages come back."""
    ns0, ns1 = grid
    got = comm.launch(_grid_rings, ns0 * ns1, "cpu", "gloo", timeout=30,
                      deadline=120, args=grid)
    for r, row in enumerate(got):
        i0, i1 = divmod(r, ns1)
        assert row[:2].tolist() == [i0, i1]
        for axis, n, i in ((0, ns0, i0), (1, ns1, i1)):
            def rank_at(j):
                return ((j % n) * ns1 + i1) if axis == 0 else \
                    (i0 * ns1 + j % n)
            fr, fl = row[2 + 6 * axis:5 + 6 * axis], row[5 + 6 * axis:
                                                         8 + 6 * axis]
            assert fr.tolist() == [rank_at(i + 1), axis, 0.0], (r, axis)
            assert fl.tolist() == [rank_at(i - 1), axis, 1.0], (r, axis)
    with pytest.raises(Exception, match="grid"):
        comm.Comm(0, 4, "cpu", "gloo").grid(3, 2)


def test_rank_args():
    """``rank_args``: each rank gets its own object after the shared
    arguments (rank 0's comes back); a list of the wrong length raises."""
    mine = [{"rank": r, "rows": np.arange(r + 3)} for r in range(3)]
    total, shared, own = comm.launch(_own_rows, 3, "cpu", "gloo", timeout=30,
                                     deadline=120, args=("x",),
                                     rank_args=mine)
    assert (total, shared, own["rank"]) == (3.0, "x", 0)
    assert own["rows"].tolist() == [0, 1, 2]
    with pytest.raises(ValueError, match="rank_args"):
        comm.launch(_own_rows, 2, "cpu", "gloo", rank_args=mine)


def test_failed_rank_raises():
    """The rank that raised is the one reported, not its peer, whose
    all-reduce fails when the group goes down."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank fails on purpose"):
        comm.launch(_raise_on_last, 2, "cpu", "gloo", timeout=20,
                    deadline=120)
    assert time.monotonic() - t0 < 60


def test_hung_rank_times_out():
    """A rank that never joins the collective: its peer's all-reduce gives
    up at the group's 3 s timeout, and launch raises and stops the hung
    rank well before the hang would end."""
    t0 = time.monotonic()
    with pytest.raises(Exception):
        comm.launch(_hang_on_last, 2, "cpu", "gloo", timeout=3, deadline=60)
    assert time.monotonic() - t0 < 45


def test_launch_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="backend"):
        comm.launch(_collectives, 2, "cpu", "mpi")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            comm.launch(_collectives, 2, "cuda", "gloo")
