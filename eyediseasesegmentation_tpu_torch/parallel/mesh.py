"""Process-group mesh and collectives: the port's one communication layer.

Counterpart of ``eyediseasesegmentation_tpu/parallel/mesh.py``. The JAX
package runs one controller over a device mesh and lets XLA insert the
collectives from sharding annotations. The port keeps PyTorch's idiom: one
process per GPU (``torchrun``, or :func:`spawn`), a ``torch.distributed``
process group, and explicit devices. A :class:`Mesh` names this process's
place in a grid of ranks with JAX's axis names (``data``, room for
``model``); the per-rank code then calls the collectives of this module.

Every collective is built on ``all_reduce`` and ``broadcast``: gloo takes no
other collective for CUDA tensors, so gloo (the CPU tests, two ranks on one
card) and NCCL run one code path. :func:`psum`, :func:`all_gather` and
:func:`neighbour_rows` are differentiable: the backward of a SUM
``all_reduce`` is a SUM ``all_reduce`` of the gradient. A loss that every
rank computes, replicated, through them gives each rank n × its share of the
gradient, so :func:`mean_grads` (the mean over the ranks) is the gradient
of the whole batch.

:func:`data_parallel` marks a forward as data-parallel for the modules that
reduce over the batch (BatchNorm's train statistics, DropBlock's and
dropout's draws, ``models/modules/layers.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import tempfile
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def world_size() -> int:
    """The number of processes of the job: the process group's size once it
    is up, else ``torchrun``'s ``WORLD_SIZE`` (1 without it)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def world_rank() -> int:
    """This process's rank in the job (0 without a process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def is_main_process() -> bool:
    """Rank 0: the one process that prints results and writes files."""
    return world_rank() == 0


def local_device_count() -> int:
    """The number of ranks of the job, one device each (JAX's
    ``jax.device_count()``: every device of the job, not of this host)."""
    return world_size()


@dataclasses.dataclass
class Mesh:
    """A grid of ranks. ``shape`` maps each axis name to its size (the JAX
    mesh's ``shape``); ranks are laid out row-major over the axes, as JAX
    reshapes its device list. ``groups`` holds, per axis, the process group
    of the ranks that differ from this one on that axis only (None where
    the axis has size 1 or is the whole world, which uses the default
    group)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    device: torch.device
    backend: Optional[str] = None
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def devices(self) -> np.ndarray:
        """The ranks of the grid, shaped like it (JAX's ``mesh.devices``)."""
        return np.arange(self.size).reshape(self.sizes)

    def axis_size(self, axis: str = DATA_AXIS) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str = DATA_AXIS) -> int:
        """This rank's index along ``axis`` (JAX's ``lax.axis_index``)."""
        if axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]

    @property
    def rank(self) -> int:
        return int(np.ravel_multi_index(self.coords, self.sizes))

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _resolve_device(device) -> torch.device:
    if device is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(shape: Optional[Dict[str, int]] = None, device=None,
              backend: Optional[str] = None) -> Mesh:
    """The mesh of this job. Default: every rank on the ``data`` axis.

    ``shape`` e.g. ``{"data": 4, "model": 2}``; a size of -1 takes the
    ranks that remain, as in JAX. The sizes must cover the job's ranks
    exactly (a rank outside the mesh would have nothing to do). The process
    group is the one already up, else one started from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``); without either the job is one rank and needs no group.

    ``device``: this rank's device, by default ``cuda:LOCAL_RANK`` (NCCL);
    ``"cpu"`` selects gloo. An explicit ``backend`` that cannot start
    raises: nothing falls back to another device or backend."""
    device = _resolve_device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"backend nccl needs a CUDA device, not {device}")
    if dist.is_available() and dist.is_initialized():
        backend = dist.get_backend()
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        backend = backend or _default_backend(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method="env://")
    n_ranks, rank = world_size(), world_rank()
    if not shape:
        shape = {DATA_AXIS: n_ranks}
    axes, sizes = list(shape), [int(s) for s in shape.values()]
    if sizes.count(-1) > 1:
        raise ValueError(f"mesh shape {shape}: at most one -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n_ranks // max(known, 1)
    if int(np.prod(sizes)) != n_ranks:
        raise ValueError(
            f"mesh shape {dict(zip(axes, sizes))} covers "
            f"{int(np.prod(sizes))} ranks, but the job has {n_ranks}")
    coords = tuple(int(c) for c in np.unravel_index(rank, sizes))
    groups: Dict[str, Any] = {}
    grid = np.arange(n_ranks).reshape(sizes)
    for i, axis in enumerate(axes):
        if sizes[i] == 1 or sizes[i] == n_ranks:
            groups[axis] = None
            continue
        # every rank creates every group of the axis, in one order
        lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    return Mesh(tuple(axes), tuple(sizes), coords, device,
                backend if n_ranks > 1 else None, groups)


def data_mesh(mesh_shape: Optional[Dict[str, int]], batch_size: int,
              device=None) -> Mesh:
    """The trainers' mesh, by JAX's rule: ``mesh_shape``, else ``{"data":
    gcd(batch_size, ranks)}``. Raises ``ValueError`` naming both numbers
    where that data axis is not the whole job or does not divide the
    batch."""
    n_ranks = world_size()
    if not mesh_shape:
        data = math.gcd(int(batch_size), n_ranks)
        if data != n_ranks:
            raise ValueError(
                f"batch_size {batch_size} on {n_ranks} ranks: JAX's rule "
                f"gives a data axis of gcd = {data}, which would leave "
                f"ranks idle; use a batch_size that {n_ranks} divides")
        mesh_shape = {DATA_AXIS: data}
    mesh = make_mesh(mesh_shape, device)
    data = mesh.axis_size(DATA_AXIS)
    if int(batch_size) % data:
        raise ValueError(f"mesh_shape data {data} does not divide "
                         f"batch_size {batch_size}")
    return mesh


# ---------------------------------------------------------------------------
# data-parallel context for the modules that reduce over the batch
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Mesh] = None


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """Run the enclosed forward (and its backward, where ``remat``
    recomputes it) as one rank's share of a batch split over ``mesh``'s
    data axis: BatchNorm's train statistics are those of the whole batch,
    DropBlock and dropout draw the whole batch's masks and keep this rank's
    rows. A module-level switch, not a thread-local one: the backward may
    run in another thread."""
    global _ACTIVE
    outer = _ACTIVE
    _ACTIVE = mesh if mesh is not None and mesh.axis_size() > 1 else None
    try:
        yield
    finally:
        _ACTIVE = outer


def active_data_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing :func:`data_parallel`, if its data axis
    has more than one rank."""
    return _ACTIVE


def batch_rows(mesh: Mesh, n: int, axis: str = DATA_AXIS) -> slice:
    """This rank's contiguous rows of a leading axis of ``n``: rank r of k
    holds ``[r·n/k, (r+1)·n/k)``, JAX's ``P("data")`` layout."""
    k, r = mesh.axis_size(axis), mesh.axis_index(axis)
    if n % k:
        raise ValueError(f"a batch of {n} does not split over {k} ranks")
    return slice(r * n // k, (r + 1) * n // k)


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """The part of a batch of ``n`` this rank holds (:func:`batch_rows`)."""
    return batch_rows(mesh, n)


def replicated_sharding(mesh: Mesh) -> slice:
    """The part of a replicated array this rank holds: all of it."""
    return slice(None)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of every leaf of a host batch (numpy arrays or
    tensors, in dicts, lists or tuples)."""
    return _tree_map(lambda x: x[batch_rows(mesh, x.shape[0])], batch)


def pad_to_batch_multiple(batch, multiple: int):
    """Pad the leading axis of every leaf with zeros up to a multiple of
    ``multiple``. Returns (padded batch, real rows)."""
    leaves = []
    _tree_map(leaves.append, batch)
    n = leaves[0].shape[0]
    pad = (-n) % multiple

    def _pad(x):
        if pad == 0:
            return x
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    return _tree_map(_pad, batch), n


# ---------------------------------------------------------------------------
# collectives (all_reduce and broadcast only)
# ---------------------------------------------------------------------------

def _group(mesh: Mesh, axis: Optional[str]):
    return None if axis is None else mesh.groups.get(axis)


def _contiguous_copy(x: torch.Tensor) -> torch.Tensor:
    return torch.clone(x, memory_format=torch.contiguous_format)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = _contiguous_copy(x)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = _contiguous_copy(grad)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, mesh: Mesh,
         axis: Optional[str] = DATA_AXIS) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (None: every rank of the
    mesh), on every one of them; differentiable."""
    if (mesh.axis_size(axis) if axis else mesh.size) == 1:
        return x
    return _AllReduceSum.apply(x, _group(mesh, axis))


def pmax(x: torch.Tensor, mesh: Mesh,
         axis: Optional[str] = DATA_AXIS) -> torch.Tensor:
    """Elementwise maximum of ``x`` over the ranks of ``axis``."""
    if (mesh.axis_size(axis) if axis else mesh.size) == 1:
        return x
    y = _contiguous_copy(x)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=_group(mesh, axis))
    return y


def _slot(x: torch.Tensor, n: int, r: int, dim: int) -> torch.Tensor:
    """``x`` at block ``r`` of ``n`` equal blocks along ``dim``, zeros in the
    others (differentiable)."""
    def zeros(count):
        shape = list(x.shape)
        shape[dim] = count * x.shape[dim]
        return [x.new_zeros(shape)] if count else []

    return torch.cat(zeros(r) + [x] + zeros(n - r - 1), dim)


def all_gather(x: torch.Tensor, mesh: Mesh, dim: int = 0,
               axis: str = DATA_AXIS) -> torch.Tensor:
    """The blocks of every rank of ``axis`` concatenated along ``dim`` in
    rank order, on every rank: one SUM ``all_reduce`` of a zeroed buffer
    with this rank's slot filled. Differentiable; needs equal blocks."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    return psum(_slot(x, n, mesh.axis_index(axis), dim), mesh, axis)


def neighbour_rows(x: torch.Tensor, halo: int, mesh: Mesh, dim: int = 2,
                   axis: str = DATA_AXIS
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the previous rank's last ``halo`` rows, the next rank's first
    ``halo`` rows) along ``dim``, zeros where there is no such rank (the
    global edges): each rank fills its two edge slots of one buffer, one
    SUM ``all_reduce``. Differentiable."""
    n, r = mesh.axis_size(axis), mesh.axis_index(axis)
    first = x.narrow(dim, 0, halo)
    last = x.narrow(dim, x.shape[dim] - halo, halo)
    if n == 1:
        return torch.zeros_like(first), torch.zeros_like(last)
    edges = _slot(torch.stack([first, last])[None], n, r, 0)
    edges = psum(edges, mesh, axis)
    top = edges[r - 1, 1] if r > 0 else torch.zeros_like(first)
    bottom = edges[r + 1, 0] if r < n - 1 else torch.zeros_like(last)
    return top, bottom


def _flat_apply(tensors: Sequence[torch.Tensor], op: Callable,
                mesh: Mesh) -> None:
    """``op`` on one flat buffer per (dtype, device) holding ``tensors``,
    the result copied back in place. NCCL takes device tensors only: a CPU
    buffer (an optimizer's step count) goes through the mesh's device."""
    by_kind: Dict[Tuple, list] = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for ts in by_kind.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        if mesh.backend == "nccl" and flat.device != mesh.device:
            work = flat.to(mesh.device)
            op(work)
            flat.copy_(work)
        else:
            op(flat)
        off = 0
        for t in ts:
            t.detach().copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def broadcast_(tensors: Sequence[torch.Tensor], mesh: Mesh,
               src: int = 0) -> None:
    """Rank ``src``'s values of ``tensors`` on every rank, in place."""
    if mesh.size > 1 and tensors:
        _flat_apply(list(tensors), lambda f: dist.broadcast(f, src), mesh)


def replicate(obj, mesh: Mesh, src: int = 0):
    """Rank ``src``'s parameters and buffers of a module (or the values of
    a sequence of tensors) on every rank; returns ``obj``."""
    if isinstance(obj, torch.nn.Module):
        tensors = list(obj.parameters()) + list(obj.buffers())
    else:
        tensors = list(obj)
    broadcast_(tensors, mesh, src)
    return obj


def mean_grads(params, mesh: Mesh, axis: str = DATA_AXIS) -> None:
    """Replace every gradient by its mean over the ranks of ``axis`` (one
    flat SUM ``all_reduce`` per dtype). The ranks hold gradients of the
    same parameters: their graphs are one graph."""
    n = mesh.axis_size(axis)
    grads = [p.grad for p in params if p.grad is not None]
    if n == 1 or not grads:
        return
    group = _group(mesh, axis)

    def op(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(n)

    _flat_apply(grads, op, mesh)


# ---------------------------------------------------------------------------
# launching ranks from one process (tests, chip_smoke.py)
# ---------------------------------------------------------------------------

def _rank_entry(rank, fn, world, device, backend, store_path, args):
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend or _default_backend(device), store=store,
                            rank=rank, world_size=world)
    try:
        fn(make_mesh(device=device), *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, device, *args,
          backend: Optional[str] = None) -> None:
    """Run ``fn(mesh, *args)`` in ``world`` new processes, one rank each,
    on ``device`` (``"cpu"``: gloo; a CUDA device: NCCL unless ``backend``
    says otherwise), and wait for them. ``spawn``, not ``fork``: CUDA
    cannot be initialised again in a forked child. The group meets through
    a ``FileStore`` in a temporary directory, so jobs side by side need no
    port. ``fn`` must be importable by name; a rank's exception is raised
    here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            _rank_entry,
            args=(fn, world, str(device), backend,
                  os.path.join(tmp, "store"), args),
            nprocs=world, join=True, start_method="spawn")
