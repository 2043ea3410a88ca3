"""The device mesh on ``torch.distributed``: the port of
``autosmoothquant_tpu/shard/mesh.py``.

JAX drives every device from one process and lets its partitioner insert
the collectives. Here each rank is a process of its own: :func:`make_mesh`
lays the ranks out on JAX's axes (``stage`` outermost, ``model`` innermost)
and opens one process group a line of each axis, and the models call the
collectives themselves through :class:`Axis` (``models/common.py``).

Axes:
  data   -- batch rows (the engines split a batch over it)
  expert -- Mixtral's experts (expert parallelism)
  model  -- tensor parallelism (column- and row-parallel projections)
  stage  -- pipeline stages: a rank holds L/S contiguous layers and the
            hidden state walks the stage line by point-to-point sends
            (``shard/pipeline.py``; the engines' sequential placement in
            ``models/common.py:stage_input`` / ``stage_output``)

:func:`launch` starts one process a rank (``torch.multiprocessing``, spawn)
for the CLI, the tests and ``chip_smoke.py``. Two ranks may share one device
only under the gloo backend (NCCL refuses two ranks on one GPU): that is an
explicit choice of the caller, never a fallback.

The stage link (:meth:`Axis.send`, :meth:`Axis.recv`) sends device tensors
under NCCL. gloo's point-to-point ops take host memory only, so under gloo
a CUDA tensor is copied to the host before its send and from the host after
its receive: chosen by the backend, before any send, and never after a
failure.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# collectives run through Axis, by kind (the card's parallel phase reads
# them a decode step; reset by setting the entries to 0)
COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "send": 0, "recv": 0,
                               "broadcast": 0}


def mesh_axes(n: int, data: int = 1, model: Optional[int] = None,
              expert: Optional[int] = None, stage: Optional[int] = None
              ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axis names, sizes) of JAX ``make_mesh`` over n devices: ``model=None``
    takes what data, expert and stage leave; "stage" leads where given,
    "expert" sits between "data" and "model" where given. Sizes that do not
    multiply to n raise ValueError (JAX asserts)."""
    e, st = expert or 1, stage or 1
    if model is None:
        if n % (data * e * st):
            raise ValueError(f"{n} devices not divisible by data*expert*stage")
        model = n // (data * e * st)
    if data * model * e * st != n:
        raise ValueError(f"mesh stage={st} data={data} expert={e} model={model} != {n} devices")
    names, sizes = [], []
    if stage:
        names.append("stage")
        sizes.append(st)
    names.append("data")
    sizes.append(data)
    if expert:
        names.append("expert")
        sizes.append(e)
    names.append("model")
    sizes.append(model)
    return tuple(names), tuple(sizes)


def rank_grid(sizes: Sequence[int]) -> np.ndarray:
    """Rank r at its coordinates: JAX reshapes its device list to the mesh's
    shape, so device r of the list is rank r here."""
    return np.arange(int(np.prod(sizes))).reshape(tuple(sizes))


def axis_lines(sizes: Sequence[int], axis: int) -> List[List[int]]:
    """The ranks that differ only along ``axis``, one list a line, in a fixed
    order (every rank opens every line's group in this order)."""
    grid = np.moveaxis(rank_grid(sizes), axis, -1)
    return [list(map(int, line)) for line in grid.reshape(-1, sizes[axis])]


def gathers_natively(backend: Optional[str], device: torch.device) -> bool:
    """Whether ``torch.distributed`` lists all_gather for the backend on the
    device: NCCL on CUDA and gloo on the CPU do; gloo on CUDA lists only
    broadcast and all_reduce, so :meth:`Axis.all_gather` there sums a
    zero-filled buffer instead (zeros add exactly)."""
    if backend == "nccl":
        return device.type == "cuda"
    return device.type == "cpu"


@dataclasses.dataclass
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's coordinate
    and the process group of its line (None where the size is 1, and every
    collective is then the identity)."""

    name: str
    size: int = 1
    index: int = 0
    group: Any = None
    backend: Optional[str] = None
    # the global ranks of this rank's line, by coordinate (point-to-point
    # ops and broadcasts name their peers by global rank)
    ranks: Tuple[int, ...] = ()
    # sends posted and not yet waited for: (work, the tensor sent)
    _pending: List[Any] = dataclasses.field(default_factory=list, repr=False)

    def _via_host(self, device) -> bool:
        """Whether a point-to-point op on ``device`` goes through host memory
        (a CUDA tensor under gloo)."""
        return self.backend != "nccl" and torch.device(device).type != "cpu"

    def send(self, t: torch.Tensor, to: int) -> None:
        """Post ``t`` to coordinate ``to`` of the line (returns at once; the
        tensor stays referenced until :meth:`wait_sends`)."""
        buf = t.detach().contiguous()
        if self._via_host(buf.device):
            buf = buf.cpu()
        self._pending.append((dist.isend(buf, self.ranks[to], group=self.group), buf))
        COLLECTIVES["send"] += 1

    def wait_sends(self) -> None:
        """Wait until every posted send has left."""
        for work, _ in self._pending:
            work.wait()
        self._pending.clear()

    def recv(self, shape, dtype, device, src: int) -> torch.Tensor:
        """A tensor of ``shape`` and ``dtype`` from coordinate ``src`` of the
        line, on ``device`` (blocks until it has come)."""
        dev = torch.device(device)
        host = self._via_host(dev)
        buf = torch.empty(shape, dtype=dtype, device="cpu" if host else dev)
        dist.recv(buf, self.ranks[src], group=self.group)
        COLLECTIVES["recv"] += 1
        return buf.to(dev) if host else buf

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` of coordinate ``src`` on every rank of the line, in place;
        returns t."""
        if self.size > 1:
            dist.broadcast(t, self.ranks[src], group=self.group)
            COLLECTIVES["broadcast"] += 1
        return t

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (or maxed) over the axis, in place; returns t."""
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                            group=self.group)
            COLLECTIVES["all_reduce"] += 1
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' ``t`` (one shape on every rank) side by side along
        ``dim`` in coordinate order."""
        if self.size == 1:
            return t
        dim = dim % t.ndim
        if gathers_natively(self.backend, t.device):
            parts = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(parts, t.contiguous(), group=self.group)
            COLLECTIVES["all_gather"] += 1
            return torch.cat(parts, dim=dim)
        shape = list(t.shape)
        w = shape[dim]
        shape[dim] = w * self.size
        full = t.new_zeros(shape)
        full.narrow(dim, self.index * w, w).copy_(t)
        dist.all_reduce(full, group=self.group)
        COLLECTIVES["all_reduce"] += 1
        return full


@dataclasses.dataclass
class Mesh:
    """This rank's place in the mesh: the axis names and sizes (JAX's order),
    its rank and coordinates, its device, and an :class:`Axis` (with its
    process group) for each axis. A mesh of one rank has no groups and every
    collective is the identity. ``rows_split``: the forward's rows are this
    rank's share of a batch split over "data" (the static engine's), so a
    route chosen on the number of rows (int4's W4A8 / W4A16) counts all of
    the batch's. ``host_group``: a gloo group of every rank for host-side
    marshalling (``serve/multihost.py``) where the backend is not gloo
    (None: the world group serves)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    backend: Optional[str]
    axes: Dict[str, Axis]
    rows_split: bool = False
    host_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    @property
    def coords(self) -> Dict[str, int]:
        return {a: int(c) for a, c in zip(self.axis_names,
                                          np.unravel_index(self.rank, self.axis_sizes))}

    def axis(self, name: str) -> Axis:
        """The named axis, or a size-1 one where the mesh has no such axis."""
        return self.axes.get(name) or Axis(name)


def axis_of(mesh: Optional[Mesh], name: str) -> Axis:
    """``mesh.axis(name)``, and a size-1 axis for no mesh."""
    return mesh.axis(name) if mesh is not None else Axis(name)


def sharded(mesh: Optional[Mesh]) -> bool:
    """Whether the mesh splits params or rows at all (any axis above 1)."""
    return mesh is not None and mesh.size > 1


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: str = "gloo",
                     timeout: Optional[float] = None) -> None:
    """The process group of ``num_processes`` ranks (JAX ``init_distributed``
    on ``torch.distributed.init_process_group``); ``coordinator`` is
    "host:port" or a ``tcp://`` address; ``timeout`` the group's in seconds
    (None: torch's default for the backend). Nothing for one process."""
    if not num_processes or num_processes <= 1:
        return
    addr = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=addr, world_size=num_processes,
                            rank=process_id, **kw)


def make_mesh(data: int = 1, model: Optional[int] = None, expert: Optional[int] = None,
              stage: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """This rank's :class:`Mesh` over the ranks of the initialized process
    group (one rank where there is none), JAX ``make_mesh``'s axes and sizes.
    ``devices`` lists each rank's device (default: ``cuda:<rank>``); every
    rank must call this, with the same arguments, in the same order, since
    it opens the axes' process groups."""
    live = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if live else 1
    rank = dist.get_rank() if live else 0
    names, sizes = mesh_axes(n, data, model, expert, stage)
    if devices is None:
        devices = [f"cuda:{r}" for r in range(n)]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    device = torch.device(devices[rank])
    backend = dist.get_backend() if live else None
    if backend == "nccl" and len({str(d) for d in devices}) < n:
        raise ValueError("NCCL takes one GPU a rank; ranks sharing a device need gloo")
    coords = np.unravel_index(rank, sizes)
    axes = {}
    for i, (name, size) in enumerate(zip(names, sizes)):
        group, ranks = None, (rank,)
        if size > 1:
            for line in axis_lines(sizes, i):
                g = dist.new_group(line)
                if rank in line:
                    group, ranks = g, tuple(line)
        axes[name] = Axis(name, size, int(coords[i]), group, backend, ranks)
    host = dist.new_group(backend="gloo") if live and backend != "gloo" else None
    return Mesh(names, sizes, rank, device, backend, axes, host_group=host)


def layout_mesh(data: int = 1, model: Optional[int] = None, expert: Optional[int] = None,
                rank: int = 0, n: Optional[int] = None, device="cpu",
                stage: Optional[int] = None) -> Mesh:
    """Rank ``rank``'s :class:`Mesh` of n ranks without process groups: its
    axes, sizes and coordinates only, for what is a pure function of them
    (specs, a rank's shard of the params; its collectives would fail)."""
    n = n or data * (model or 1) * (expert or 1) * (stage or 1)
    names, sizes = mesh_axes(n, data, model, expert, stage)
    coords = np.unravel_index(rank, sizes)
    axes = {a: Axis(a, s, int(c)) for a, s, c in zip(names, sizes, coords)}
    return Mesh(names, sizes, rank, torch.device(device), None, axes)


# ---------------------------------------------------------------------------
# one process a rank
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def to_host(obj):
    """obj with every tensor as a numpy array (a rank's result crosses a
    process boundary by pickle)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _rank_main(fn, rank, world, port, backend, threads, args, queue):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_distributed(f"127.0.0.1:{port}", world, rank, backend)
        queue.put((rank, True, to_host(fn(*args))))
    except BaseException:  # the parent raises it, with the rank's traceback
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world_size: int, *args, backend: str = "gloo",
           threads: Optional[int] = None, timeout: float = 900.0) -> List[Any]:
    """Run ``fn(*args)`` in ``world_size`` new processes (spawned), each a
    rank of one process group of ``backend`` on localhost, and return their
    results in rank order (tensors as numpy arrays). ``fn`` must be
    importable (a module-level function) and builds its mesh itself
    (:func:`make_mesh` with the devices it wants). A rank that raises makes
    this raise with the rank's traceback; ranks still running after
    ``timeout`` seconds are killed and this raises TimeoutError. Every
    process started here has ended when this returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, port, backend, threads, args, queue),
                         daemon=True) for r in range(world_size)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    failure = None
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world_size and failure is None:
            if not queue.empty():
                rank, ok, value = queue.get()
                if ok:
                    results[rank] = value
                else:
                    failure = f"rank {rank} of {world_size} failed:\n{value}"
                continue
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size - len(results)} of {world_size} ranks "
                                   f"still running after {timeout:.0f} s")
            if any(p.exitcode not in (None, 0) for p in procs) and queue.empty():
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                time.sleep(0.5)
                if queue.empty():
                    failure = f"ranks {dead} exited with {[procs[r].exitcode for r in dead]}"
                continue
            time.sleep(0.01)
    finally:
        for p in procs:
            p.join(timeout=5 if failure is None else 0.5)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [results[r] for r in range(world_size)]

