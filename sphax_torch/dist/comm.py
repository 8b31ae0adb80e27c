"""Ranks and their collectives (the port's counterpart of the JAX package's
``Mesh`` and ``make_mesh``, and of ``lax.ppermute``, ``psum``, ``pmin`` and
``pmax`` over the mesh axis).

``launch(fn, world, device, backend)`` spawns ``world`` processes with
``torch.multiprocessing``; each joins one process group, builds a ``Comm``
and runs ``fn(comm, *args)``. Rank 0's return value comes back to the
caller. The rendezvous is a ``FileStore`` in a fresh temporary directory,
so concurrent launches never share a port or a store. Every collective of
the group has a finite timeout, and a rank that fails or exits makes the
launch raise with the traceback of the rank that failed first (its peers
then fail in their collectives): a hung rank fails its peers within the
timeout instead of hanging the run.

On one card all ranks share ``cuda:0`` and use gloo (NCCL puts no two
ranks on one device). gloo moves host memory, so on a CUDA device a gloo
``Comm`` copies every message and every reduced tensor to a pinned host
buffer and back, here and nowhere else; ``STAGED`` counts the bytes of
those copies (both directions). With NCCL (one card per rank) tensors stay
on their device; that configuration has not been run.

``Comm.grid(ns0, ns1)`` lays the ranks out as the pencil decomposition's
two-axis grid (the JAX package's ``Mesh(devs.reshape(ns0, ns1), ("sx",
"sy"))``: rank = i0 * ns1 + i1), and ``ring(..., axis=0 or 1)`` runs the
ring along one axis of it; all-reduces over both axes are the world's.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

# host-staged traffic of this process: bytes copied between the card and
# pinned host buffers ("bytes", everything), and the part of them that the
# rings along the grid's two axes moved ("sx", "sy")
STAGED = {"bytes": 0, "sx": 0, "sy": 0}

# message tags of the ring: a message sent to the left neighbour, and one
# sent to the right. With two ranks both neighbours are the same peer, and
# the tags keep the two messages of one exchange from swapping. The rings
# along the grid's axes have tags of their own.
_TO_LEFT, _TO_RIGHT = 1, 2
_AXIS_TAGS = {0: (3, 4), 1: (5, 6)}
_AXIS_NAMES = ("sx", "sy")


class Comm:
    """One rank's view of the group: its rank, the world size, the device
    its tensors live on, and the collectives of the slab decomposition."""

    def __init__(self, rank: int, world: int, device, backend: str):
        self.rank, self.world = int(rank), int(world)
        self.device = torch.device(device)
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.shape = None

    @property
    def left(self) -> int:
        return (self.rank - 1) % self.world

    @property
    def right(self) -> int:
        return (self.rank + 1) % self.world

    def grid(self, ns0: int, ns1: int) -> "Comm":
        """Lay the ranks out as an ``ns0 x ns1`` grid, row-major (rank =
        i0 * ns1 + i1); returns self."""
        if ns0 < 1 or ns1 < 1 or ns0 * ns1 != self.world:
            raise ValueError(f"a {ns0}x{ns1} grid of {self.world} ranks")
        self.shape = (int(ns0), int(ns1))
        return self

    @property
    def coords(self):
        """(i0, i1): this rank's place in the grid."""
        return divmod(self.rank, self.shape[1])

    def _axis_peers(self, axis: int):
        """(left, right) neighbours along one grid axis, cyclic."""
        i = list(self.coords)
        n = self.shape[axis]
        out = []
        for step in (-1, 1):
            j = list(i)
            j[axis] = (i[axis] + step) % n
            out.append(j[0] * self.shape[1] + j[1])
        return tuple(out)

    # -- host staging (gloo on a card) --------------------------------------

    def _out(self, t, key=None):
        """The buffer a collective sends or reduces in place: a pinned host
        copy of a CUDA tensor under gloo, else a contiguous copy. ``key``
        names the grid axis whose ring moves it."""
        if not self.staged:
            return t.contiguous().clone()
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        self._count(buf, key)
        return buf

    def _empty(self, shape, dtype):
        return torch.empty(shape, dtype=dtype, pin_memory=self.staged,
                           device="cpu" if self.staged else self.device)

    def _in(self, buf, key=None):
        """A received or reduced buffer, back on this rank's device."""
        if not self.staged:
            return buf
        self._count(buf, key)
        return buf.to(self.device, non_blocking=True)

    @staticmethod
    def _count(buf, key):
        nbytes = buf.numel() * buf.element_size()
        STAGED["bytes"] += nbytes
        if key is not None:
            STAGED[key] += nbytes

    # -- collectives ----------------------------------------------------------

    def ring(self, to_left=None, to_right=None, axis=None):
        """Send ``to_left`` to the left neighbour (rank - 1, cyclic) and
        ``to_right`` to the right one; return (from_right, from_left), the
        messages the right neighbour sent left and the left one sent right.
        A message is None where nothing goes that way (the answer from the
        other side is None then). Every rank must pass the same shapes.

        ``axis`` (0 or 1, after ``grid``): the ring along that axis of the
        grid, i0 +- 1 or i1 +- 1, cyclic. A ring of one returns the rank's
        own messages, as ``ppermute`` over an axis of one does."""
        if axis is None:
            n, (left, right), tags, key = (self.world, (self.left,
                                                        self.right),
                                           (_TO_LEFT, _TO_RIGHT), None)
        else:
            n, (left, right), tags, key = (self.shape[axis],
                                           self._axis_peers(axis),
                                           _AXIS_TAGS[axis],
                                           _AXIS_NAMES[axis])
        if n == 1:
            return to_left, to_right       # a ring of one: mine come back
        ops, recv = [], [None, None]
        for k, (msg, dst, tag) in enumerate(((to_left, left, tags[0]),
                                             (to_right, right, tags[1]))):
            if msg is None:
                continue
            ops.append(dist.P2POp(dist.isend, self._out(msg, key), dst,
                                  tag=tag))
            recv[k] = self._empty(msg.shape, msg.dtype)
            src = right if k == 0 else left
            ops.append(dist.P2POp(dist.irecv, recv[k], src, tag=tag))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return tuple(None if r is None else self._in(r, key) for r in recv)

    def _reduce(self, t, op):
        if self.world == 1:
            return t
        buf = self._out(t)
        dist.all_reduce(buf, op=op)
        return self._in(buf)

    def all_reduce_sum(self, t):
        return self._reduce(t, dist.ReduceOp.SUM)

    def all_reduce_min(self, t):
        return self._reduce(t, dist.ReduceOp.MIN)

    def all_reduce_max(self, t):
        return self._reduce(t, dist.ReduceOp.MAX)

    def barrier(self):
        """Wait until every rank gets here."""
        if self.world > 1:
            dist.barrier()

    def gather_rows(self, t):
        """Every rank's rows of ``t`` ([n_rank, ...], n_rank may differ)
        concatenated in rank order on rank 0 (on its device); None on the
        other ranks."""
        if self.world == 1:
            return t
        counts = torch.zeros(self.world, dtype=torch.int64,
                             device=self.device)
        counts[self.rank] = t.shape[0]
        counts = self.all_reduce_sum(counts).cpu()
        pad = t.new_zeros((int(counts.max()),) + tuple(t.shape[1:]))
        pad[:t.shape[0]] = t
        buf = self._out(pad)
        bufs = ([self._empty(buf.shape, buf.dtype) for _ in range(self.world)]
                if self.rank == 0 else None)
        dist.gather(buf, bufs, dst=0)
        if self.rank != 0:
            return None
        return torch.cat([self._in(b[:int(c)]) for b, c in zip(bufs, counts)])


def _rank_main(rank, fn, world, device, backend, timeout, tmp, args):
    try:
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)
        own = os.path.join(tmp, f"rank{rank}.in.pkl")
        if os.path.exists(own):
            with open(own, "rb") as f:
                args = tuple(args) + (pickle.load(f),)
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        out = fn(Comm(rank, world, device, backend), *args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if rank == 0:
            path = os.path.join(tmp, "rank0.pkl")
            with open(path + ".tmp", "wb") as f:
                pickle.dump(out, f)
            os.replace(path + ".tmp", path)
    except BaseException:
        # when it failed, beside what, before the group goes down: a rank
        # whose peer died fails in its next collective, after the peer
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    dist.destroy_process_group()


def _first_failure(tmp, world):
    """(time, rank, traceback) of the rank that failed first, or None."""
    fails = []
    for r in range(world):
        try:
            with open(os.path.join(tmp, f"rank{r}.err")) as f:
                when, _, tb = f.read().partition("\n")
            fails.append((float(when), r, tb))
        except (OSError, ValueError):
            continue
    return min(fails) if fails else None


def launch(fn, world: int, device, backend: str, timeout: float = 300.0,
           deadline: float = None, args=(), rank_args=None):
    """Run ``fn(comm, *args)`` on ``world`` spawned ranks; return rank 0's
    value (it must pickle, and should hold no CUDA tensor).

    ``fn`` must be importable by name (a module-level function). ``device``
    is every rank's device (``cuda`` means ``cuda:0``: the ranks share one
    card); ``backend`` is ``gloo`` or ``nccl``. ``timeout`` (seconds)
    bounds every collective; ``deadline`` (seconds, optional) bounds the
    whole run. ``rank_args`` (optional, one picklable object a rank): rank
    r is called as ``fn(comm, *args, rank_args[r])`` and loads only its
    own. A rank that raises, exits or outlives the deadline makes this
    raise, after the other ranks are stopped, with the traceback of the
    rank that failed first."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: expected 'gloo' or 'nccl'")
    if rank_args is not None and len(rank_args) != world:
        raise ValueError(f"rank_args holds {len(rank_args)} entries for "
                         f"{world} ranks")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                               "to run the ranks on the CPU")
        if device.index is None:
            device = torch.device("cuda", 0)
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="sphax_torch_ranks_")
    try:
        for r, a in enumerate(rank_args or ()):
            with open(os.path.join(tmp, f"rank{r}.in.pkl"), "wb") as f:
                pickle.dump(a, f, protocol=pickle.HIGHEST_PROTOCOL)
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, str(device), backend, float(timeout),
                              tmp, tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        end = None if deadline is None else time.monotonic() + deadline
        try:
            while not ctx.join(timeout=1.0):
                if end is not None and time.monotonic() > end:
                    raise TimeoutError(f"{world} ranks outlived their "
                                       f"deadline of {deadline} s")
        except BaseException as e:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
            first = _first_failure(tmp, world)
            if first is None or isinstance(e, KeyboardInterrupt):
                raise
            raise RuntimeError(f"rank {first[1]} of {world} failed first:\n"
                               f"{first[2]}") from e
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
