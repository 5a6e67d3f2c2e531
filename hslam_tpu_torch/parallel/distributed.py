"""Process groups and collectives (port of hslam_tpu/parallel/distributed.py).

  * `initialize()` wraps torch.distributed.init_process_group. It reads
    torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) or
    takes the rendezvous as arguments (`host:port`, `tcp://...` or
    `file://...`). The backend is the caller's: NCCL puts one rank on each
    card; Gloo also reduces CUDA tensors (through the host), and is the only
    way to put two ranks on one card.
  * `Mesh`: one named axis over the ranks of a process group.
    `global_mesh(axis)` makes one over the world; `Mesh.split(axis)` gives
    the same ranks a group of their own, so that two threads (the mapping
    thread's BA and the loop-closure worker's pose graph) never issue
    collectives on one group in an order that may differ between ranks.
  * `psum` and `all_gather` are the JAX package's `lax.psum` and tiled
    `lax.all_gather`. `all_gather` is a zero-padded all_reduce: each rank
    writes its block into zeros of the full size and the sum is exact
    (x + 0 = x; a -0.0 comes back as +0.0). Gloo has no all_gather for CUDA
    tensors, only all_reduce and broadcast.
  * `Channel`: records from a mesh's rank 0 to its other ranks, on a Gloo
    group of its own: how the threaded SLAMSystem entries make each
    timing-dependent decision once (rank 0) and replay it everywhere else.
  * `run_ranks(fn, n)` spawns n processes, brings a group up in each over a
    file rendezvous and calls fn(mesh, *args) on every rank.

Left out, as TPU-only: the MEGASCALE_* and TPU_WORKER_HOSTNAMES detection.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue as _queue
import tempfile
import time
import traceback
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """Bring the default process group up. A no-op if one exists, or in a
    single process with nothing configured. `backend=None` takes torch's
    default (NCCL for CUDA tensors, Gloo for CPU ones)."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return                       # single process: nothing to initialize
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs the rendezvous address, the number of "
                         "processes and this process's rank (or torchrun's env)")
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


class Mesh:
    """One named axis over the ranks of `group` (None: the world). Counts
    the collectives issued on it and their bytes."""

    def __init__(self, axis_names: Sequence[str] = ("points",), group=None):
        self.axis_names = tuple(axis_names)
        self.group = group if group is not None else dist.group.WORLD
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.n_collectives = 0
        self.n_bytes = 0

    def split(self, axis: str) -> "Mesh":
        """The same ranks on a new group of their own (a collective call:
        every rank of the world makes it, in the same order)."""
        return Mesh((axis,), dist.new_group(dist.get_process_group_ranks(self.group)))

    def block(self, n: int) -> slice:
        """This rank's contiguous block of n items."""
        if n % self.size:
            raise ValueError(f"{n} items do not split into {self.size} equal blocks")
        m = n // self.size
        return slice(self.rank * m, (self.rank + 1) * m)

    def _reduce(self, buf: torch.Tensor) -> torch.Tensor:
        """all_reduce SUM of `buf` in place, counted."""
        dist.all_reduce(buf, group=self.group)
        self.n_collectives += 1
        self.n_bytes += buf.numel() * buf.element_size()
        return buf

    def __repr__(self):
        return f"Mesh(axis_names={self.axis_names}, size={self.size}, rank={self.rank})"


def global_mesh(axis: str = "points", n_devices: int | None = None) -> Mesh | None:
    """One axis over the first `n_devices` ranks of the world (all of them
    by default), on a group of its own. Every rank must call it; ranks
    outside the mesh get None."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    group = dist.new_group(list(range(n)))
    return Mesh((axis,), group) if dist.get_rank() < n else None


def _pack(xs):
    """Flatten tensors of one dtype into one buffer; bool as uint8."""
    return torch.cat([(x.to(torch.uint8) if x.dtype == torch.bool else x).reshape(-1)
                      for x in xs])


def _by_dtype(xs):
    groups: dict = {}
    for i, x in enumerate(xs):
        dt = torch.uint8 if x.dtype == torch.bool else x.dtype
        groups.setdefault(dt, []).append(i)
    return groups.values()


def psum(x, mesh: Mesh | None):
    """Sum over the mesh (`lax.psum`). `x` is a tensor or a sequence of
    tensors; one all_reduce per dtype. Integer and bool tensors are counts
    and reduce in int64. Without a mesh, `x` itself."""
    if mesh is None:
        return x
    xs = [x] if isinstance(x, torch.Tensor) else list(x)
    xs = [t.to(torch.int64) if not t.is_floating_point() else t for t in xs]
    out = [None] * len(xs)
    for idx in _by_dtype(xs):
        buf = mesh._reduce(_pack([xs[i] for i in idx]))
        off = 0
        for i in idx:
            n = xs[i].numel()
            out[i] = buf[off:off + n].view(xs[i].shape)
            off += n
    return out[0] if isinstance(x, torch.Tensor) else out


def all_gather(x, mesh: Mesh | None):
    """Every rank's block concatenated along dim 0 (a tiled `lax.all_gather`),
    by a zero-padded all_reduce. `x` is a tensor or a sequence of tensors,
    each holding this rank's block of its array (the same shape on every
    rank); one all_reduce per dtype. Integers stay integers, bools come back
    as bools. Without a mesh, `x` itself."""
    if mesh is None:
        return x
    xs = [x] if isinstance(x, torch.Tensor) else list(x)
    n, r = mesh.size, mesh.rank
    out = [None] * len(xs)
    for idx in _by_dtype(xs):
        local = _pack([xs[i] for i in idx])
        L = local.numel()
        buf = local.new_zeros(n * L)
        buf[r * L:(r + 1) * L] = local
        blocks = mesh._reduce(buf).view(n, L)
        off = 0
        for i in idx:
            t = xs[i]
            k = t.numel()
            full = blocks[:, off:off + k].reshape((n * t.shape[0],) + tuple(t.shape[1:]))
            out[i] = full.bool() if t.dtype == torch.bool else full
            off += k
    return out[0] if isinstance(x, torch.Tensor) else out


# ------------------------------------------------------------- control
class Channel:
    """One-way control records from rank 0 of `mesh` to its other ranks.

    A record is a fixed layout of named fields (`fields`: (name, shape)
    pairs) packed into one float64 host tensor, one broadcast each: ints up
    to 2**53, bools and float32 values are exact in float64. `send` (rank 0)
    and `recv` (the others) must be called the same number of times in the
    same order on every rank. `send_tensors` / `recv_tensors` carry a list
    of tensors of any shapes and dtypes (through the host, bit for bit).

    Each channel has a Gloo group of its own, even in an NCCL world: a
    record never touches the card or waits on a CUDA sync, and two threads
    never issue collectives on one group. Making one is a collective call:
    every rank of the world makes its channels in the same order. Counts
    its broadcasts and the host seconds spent in them. Without a mesh there
    is no transport (a subclass brings one: the tests' scripted channels)."""

    def __init__(self, fields: Sequence[tuple], mesh: Mesh | None = None):
        self.fields = tuple((name, tuple(shape)) for name, shape in fields)
        self._slices, off = {}, 0
        for name, shape in self.fields:
            n = int(np.prod(shape, dtype=np.int64))
            self._slices[name] = slice(off, off + n)
            off += n
        self.numel = off
        self.n_broadcasts = 0
        self.seconds = 0.0
        self.group, self.src, self.leader = None, 0, True
        if mesh is not None:
            ranks = dist.get_process_group_ranks(mesh.group)
            self.group = dist.new_group(ranks, backend="gloo")
            self.src, self.leader = ranks[0], mesh.rank == 0

    def pack(self, **values) -> torch.Tensor:
        """The record as one float64 tensor; every field must be given."""
        if set(values) != set(self._slices):
            raise KeyError(f"record fields {sorted(values)} != {sorted(self._slices)}")
        buf = torch.empty(self.numel, dtype=torch.float64)
        for name, shape in self.fields:
            v = np.asarray(values[name], np.float64)
            if v.shape != shape:
                raise ValueError(f"record field {name}: shape {v.shape}, want {shape}")
            buf[self._slices[name]] = torch.from_numpy(v.reshape(-1))
        return buf

    def unpack(self, buf: torch.Tensor) -> dict:
        """Field name -> float (shape ()) or float64 array."""
        a = buf.numpy()
        return {name: (float(a[self._slices[name]][0]) if shape == ()
                       else a[self._slices[name]].reshape(shape).copy())
                for name, shape in self.fields}

    def send(self, **values) -> None:
        self._bcast(self.pack(**values))

    def recv(self) -> dict:
        buf = torch.empty(self.numel, dtype=torch.float64)
        self._bcast(buf)
        return self.unpack(buf)

    def send_tensors(self, tensors) -> None:
        self._bcast_objects([[t.detach().cpu() for t in tensors]])

    def recv_tensors(self, device) -> list:
        box = [None]
        self._bcast_objects(box)
        return [t.to(device) for t in box[0]]

    def _bcast(self, buf: torch.Tensor) -> None:
        t0 = time.perf_counter()
        dist.broadcast(buf, self.src, group=self.group)
        self._count(t0)

    def _bcast_objects(self, box: list) -> None:
        t0 = time.perf_counter()
        dist.broadcast_object_list(box, self.src, group=self.group)
        self._count(t0)

    def _count(self, t0: float) -> None:
        self.n_broadcasts += 1
        self.seconds += time.perf_counter() - t0


# --------------------------------------------------------------- launcher
def _rank_entry(rank, n, init_file, backend, fn, args, results):
    try:
        initialize(f"file://{init_file}", n, rank, backend)
        try:
            results.put((rank, True, fn(global_mesh("points"), *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:               # reported to the parent, then exit 1
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_ranks(fn, n: int, args: tuple = (), backend: str = "gloo",
              timeout: float = 600.0) -> list:
    """Run fn(mesh, *args) on n spawned ranks (a group over a file
    rendezvous in a temporary directory) and return the n results in rank
    order. `fn` must be importable by name and its arguments and result
    picklable. A rank that raises, exits non-zero or is still running after
    `timeout` seconds makes this raise; every rank is stopped first."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_entry, daemon=True,
                             args=(r, n, init_file, backend, fn, args, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        got, errors = {}, []
        try:
            deadline = time.monotonic() + timeout
            while len(got) < n and not errors:
                try:
                    rank, ok, val = results.get(timeout=1.0)
                except _queue.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                    if dead or all(p.exitcode is not None for p in procs):
                        # exited before it could report (an import error)
                        errors.append(f"ranks {dead or 'all'} exited without a result")
                    elif time.monotonic() > deadline:
                        raise TimeoutError(f"run_ranks: {n - len(got)} of {n} ranks gave "
                                           f"no result within {timeout:.0f} s") from None
                    continue
                if ok:
                    got[rank] = val
                else:               # the others may wait on it forever: stop them
                    errors.append(f"rank {rank}:\n{val}")
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0) if not errors else 5.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10.0)
        bad = [f"rank {r} exit code {p.exitcode}" for r, p in enumerate(procs)
               if p.exitcode != 0]
        if errors or bad:
            raise RuntimeError("run_ranks failed: " + "; ".join(bad) + "\n" + "\n".join(errors))
    return [got[r] for r in range(n)]
