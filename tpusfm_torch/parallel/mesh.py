"""Process-group mesh runtime (port of ``tpusfm/parallel/mesh.py``).

The reference's mesh is single-controller: one JAX process drives N
devices through ``shard_map``, with ``psum`` and ``ppermute`` as its
collectives.  The port takes PyTorch's idiom, one process per device
(SPMD): every rank runs the whole host program on identical inputs, only
the sharded parts split their work by rank, and they rejoin through
``all_reduce`` (for ``psum``), ``all_gather`` (for ``out_specs=P(axis)``)
and ``batch_isend_irecv`` (for ``ppermute``).

A ``Mesh`` is a ``torch.distributed`` process group with its axis name
(``"shard"``), ``shape = {axis: world size}``, this rank and this rank's
device.  ``make_mesh`` registers it under its axis name, so that
``BAConfig.axis_name`` stays a plain string (both packages write the same
``config.json``) and the BA resolves the group from it.

The backend is chosen explicitly: NCCL for CUDA devices and gloo for the
CPU by default, and a caller may ask for gloo on a card (two ranks sharing
one card, which NCCL refuses).  gloo moves CUDA tensors through host
memory for every collective; the compute stays on the card.  Every group
has a finite timeout, so ranks that fall out of step fail instead of
hanging.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

AXIS = "shard"
TIMEOUT_S = 600.0
# Ranks waiting while rank 0 alone works (feature detection, the mesh stage,
# writing a stage's files) wait up to this long: such work grows with the
# collection, unlike one collective's step.
WAIT_S = 24 * 3600.0

_NO_GROUP = ("no torch.distributed process group is initialised: start one process per "
             "device with `torchrun --nproc-per-node N ...`, or call "
             "tpusfm_torch.parallel.mesh.initialize_distributed(coordinator, N, rank) in "
             "each of the N processes, before asking for a mesh")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh: the process group, its axis name, the
    group's size, this process's rank in it, the rank's device and the
    group's backend."""
    group: object
    axis: str
    size: int
    rank: int
    device: torch.device
    backend: str

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}


_MESHES: dict[str, Mesh] = {}


def _timeout(seconds: float = TIMEOUT_S) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _init_method(coordinator: str | None) -> str:
    """A URL for init_process_group: 'host:port' becomes tcp://host:port;
    file:// and tcp:// URLs pass through; None reads torchrun's
    MASTER_ADDR and MASTER_PORT (env://)."""
    if coordinator is None:
        return "env://"
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, *, backend: str | None = None,
                           device="cuda") -> bool:
    """Join this process to a group of `num_processes` ranks as rank
    `process_id` (``init_process_group``).  Arguments left None come from
    torchrun's environment (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT).
    Does nothing for at most one process, or when a group already exists
    (idempotent, as the reference's for service restarts).  `backend`
    defaults to NCCL for a CUDA `device` and gloo for the CPU.  Returns
    whether it initialised a group."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 or dist.is_initialized():
        return False
    if process_id is None:
        process_id = int(os.environ["RANK"])
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend or default_backend(device),
                            init_method=_init_method(coordinator), world_size=int(num_processes),
                            rank=int(process_id), timeout=_timeout())
    return True


def rank_device(device) -> torch.device:
    """`device` for this rank: a card named without an index ("cuda")
    becomes card LOCAL_RANK (torchrun's; the rank on one host otherwise);
    anything else stays as it is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
        return torch.device("cuda", local % max(torch.cuda.device_count(), 1))
    return device


def make_mesh(n_devices: int | None = None, axis: str = AXIS, *, backend: str | None = None,
              device=None) -> Mesh:
    """The 1-D mesh over the initialised group's `n_devices` ranks (default:
    all; another count raises).  `backend` None takes the group's own;
    another backend makes a new group over the same ranks.  `device` is
    this rank's device (default: its local card; with no CUDA device that
    raises, and the CPU is used only when asked for).  The mesh is
    registered under `axis`."""
    if not dist.is_initialized():
        raise RuntimeError(_NO_GROUP)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh spans every rank of the group: asked for {n} of {world}")
    group_backend = str(dist.get_backend())
    if backend is None or backend == group_backend:
        group, backend = dist.group.WORLD, group_backend
    else:
        group = dist.new_group(list(range(world)), timeout=_timeout(), backend=backend)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not available; "
                           f"pass device='cpu' to run on the CPU")
    dev = rank_device(dev)
    mesh = Mesh(group=group, axis=axis, size=world, rank=dist.get_rank(), device=dev,
                backend=backend)
    _MESHES[axis] = mesh
    return mesh


def register(mesh: Mesh, axis: str | None = None) -> None:
    """Make `mesh` the one that `axis` (default: its own axis) names."""
    _MESHES[axis or mesh.axis] = mesh


def mesh_for(axis: str) -> Mesh:
    """The mesh registered under `axis`."""
    if axis not in _MESHES:
        raise RuntimeError(f"no mesh is registered under axis {axis!r}; "
                           f"make one with parallel.mesh.make_mesh(axis={axis!r})")
    return _MESHES[axis]


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Pad `axis` up to a multiple of `multiple`.  Returns (padded, valid
    (m,) bool)."""
    n = arr.shape[axis]
    m = ((n + multiple - 1) // multiple) * multiple
    if m == n:
        return arr, np.ones(n, bool)
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, m - n)
    return np.pad(arr, pad_width, constant_values=fill), np.arange(m) < n


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _staged(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x the group's backend can take: gloo moves CUDA
    tensors through host memory."""
    if mesh.backend == "gloo" and x.device.type != "cpu":
        return x.detach().to("cpu", copy=True).contiguous()
    return x.detach().clone().contiguous()


def psum_many(tensors, axis: str) -> list[torch.Tensor]:
    """The sums over the ranks of `axis` of `tensors`, each in its own
    dtype, in one all_reduce per dtype: each rank gets the same bits."""
    mesh = mesh_for(axis)
    tensors = list(tensors)
    out = [None] * len(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        buf = _staged(mesh, flat)
        dist.all_reduce(buf, group=mesh.group)
        buf, o = buf.to(flat.device), 0
        for i in idx:
            out[i] = buf[o: o + tensors[i].numel()].reshape(tensors[i].shape)
            o += tensors[i].numel()
    return out


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``jax.lax.psum`` over the ranks of `axis`."""
    return psum_many([x], axis)[0]


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's x (equal shapes) concatenated along dim 0, in rank
    order, on x's device."""
    buf = _staged(mesh, x)
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat(parts).to(x.device)


def ring_shift(mesh: Mesh, tensors) -> list[torch.Tensor]:
    """``ppermute`` one step round the ring: send each tensor to rank + 1
    and receive rank - 1's, by one batch_isend_irecv."""
    if mesh.size == 1:
        return list(tensors)
    tensors = list(tensors)
    nxt, prv = (mesh.rank + 1) % mesh.size, (mesh.rank - 1) % mesh.size
    sends = [_staged(mesh, t) for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    ops = [dist.P2POp(dist.isend, s, nxt, group=mesh.group) for s in sends]
    ops += [dist.P2POp(dist.irecv, r, prv, group=mesh.group) for r in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(recvs, tensors)]


def check_same(mesh: Mesh, what: str, **values: int) -> None:
    """Raise unless every rank passed the same integers: one all_reduce of
    their minimum and one of their maximum.  Sharded calls run it at entry,
    so ranks that fall out of step fail at once instead of deadlocking in
    a later collective."""
    names = sorted(values)
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    v = torch.tensor([int(values[k]) for k in names], dtype=torch.int64, device=dev)
    lo, hi = v.clone(), v.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group)
    bad = {k: (int(a), int(b)) for k, a, b in zip(names, lo.tolist(), hi.tolist()) if a != b}
    if bad:
        raise RuntimeError(f"{what}: the ranks disagree on {bad} (min, max); every rank must "
                           "run the same program on the same inputs")


def broadcast_ints(mesh: Mesh, values, group=None) -> list[int]:
    """Rank 0's integers `values` on every rank, by one broadcast on the
    mesh's group or on `group`, a gloo group over the same ranks (the other
    ranks pass as many placeholders)."""
    nccl = group is None and mesh.backend == "nccl"
    v = torch.tensor([int(x) for x in values], dtype=torch.int64,
                     device=mesh.device if nccl else "cpu")
    dist.broadcast(v, src=0, group=mesh.group if group is None else group)
    return v.tolist()


def broadcast_flags(mesh: Mesh, flags) -> list[bool]:
    """Rank 0's `flags` on every rank, by one broadcast: ranks that decide
    from what rank 0 saw take the same branches."""
    return [bool(f) for f in broadcast_ints(mesh, (bool(f) for f in flags))]


def waiting_group(mesh: Mesh):
    """A gloo group over the mesh's ranks whose barrier waits up to WAIT_S,
    for ranks that wait on work rank 0 does alone.  Every rank of the mesh
    makes it together."""
    return dist.new_group(list(range(mesh.size)), timeout=_timeout(WAIT_S), backend="gloo")


# ---------------------------------------------------------------------------
# Running ranks on one host
# ---------------------------------------------------------------------------

def _rank_main(rank, world, init_method, backend, threads, fn, args, out):
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                                timeout=_timeout())
        try:
            # Pickled by value here: the queue would share tensors through
            # file descriptors that die with this process.
            out.put((rank, True, pickle.dumps(fn(rank, *args))))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, *, backend: str, init_method: str, args=(),
              threads: int | None = None, timeout_s: float | None = None) -> list:
    """Run fn(rank, *args) in `world` spawned processes joined into one
    group (`backend`, `init_method`: a file:// or tcp://localhost URL), and
    return their results in rank order.  fn must be importable by name (a
    module-level function).  A rank that raises or dies fails the call
    with its traceback, and so do ranks that have not all reported within
    `timeout_s` (None: no limit); every process is stopped before this
    returns."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, init_method, backend, threads, fn, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    end = None if timeout_s is None else time.time() + timeout_s
    try:
        while len(results) + len(errors) < world:
            try:
                rank, ok, val = out.get(timeout=5.0)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"a rank exited with code {dead[0]} and no result")
                    break
                if end is not None and time.time() > end:
                    waiting = sorted(set(range(world)) - set(results))
                    errors.append(f"ranks {waiting} reported nothing within {timeout_s:g} s")
                    break
                continue
            if ok:
                results[rank] = pickle.loads(val)
            else:
                errors.append(f"rank {rank}:\n{val}")
                break
        if errors:
            raise RuntimeError("run_ranks failed: " + "\n".join(errors))
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [results[r] for r in range(world)]
