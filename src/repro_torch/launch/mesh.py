"""Device meshes over ``torch.distributed`` ranks, and a launcher of rank
processes.

Counterpart of ``repro.launch.mesh``.  The reference's mesh is a grid of
devices that one program drives; here every mesh position is a rank
process, and a ``Mesh`` is the grid of ranks with the process groups the
distributed layer (``repro_torch.dist``) needs: a
``torch.distributed.device_mesh.DeviceMesh`` gives one group an axis, and
every set of two or more axes gets a group made with ``new_group`` when the
mesh is built (all ranks create every group, in one order, as
``new_group`` requires).  A mesh needs an initialised default process
group whose world size is the mesh's size; it uses whatever backend the
caller initialised.

``spawn`` starts the rank processes of one machine: W processes by the
spawn start method, each initialising the default group from a file
(``init_method="file://..."``, so concurrent runs never share a port).  On a
machine with one card every rank uses ``cuda:0`` (NCCL refuses two ranks on
one device, so such runs use gloo).
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
from pathlib import Path
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist


class Mesh:
    """A grid of ranks with named axes (rank = row-major position) and the
    process group of every non-empty set of axes.

    ``shape`` maps axis name -> size, as the reference's ``mesh.shape``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device_type: str):
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs an initialised default process "
                               "group (torch.distributed.init_process_group)")
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} does not match axes {axis_names}")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} holds "
                             f"{math.prod(shape)} ranks; the world has {world}")
        from torch.distributed.device_mesh import init_device_mesh

        self.device_type = device_type
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.device_mesh = init_device_mesh(device_type, shape,
                                            mesh_dim_names=axis_names)
        rank = dist.get_rank()
        self.coords = dict(zip(axis_names, _unravel(rank, shape)))
        self._blocks = {}
        self._groups = {(a,): self.device_mesh.get_group(a)
                        for a in axis_names}
        # every set of two or more axes: the groups of ranks that share the
        # other axes' coordinates, created on every rank in one order
        for n in range(2, len(axis_names) + 1):
            for axes in itertools.combinations(axis_names, n):
                if n == len(axis_names):
                    self._groups[axes] = dist.group.WORLD
                    continue
                rest = [a for a in axis_names if a not in axes]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    ranks = [_ravel({**dict(zip(rest, fixed)),
                                     **dict(zip(axes, sub))}, self)
                             for sub in itertools.product(
                                 *(range(self.shape[a]) for a in axes))]
                    g = dist.new_group(sorted(ranks))
                    if rank in ranks:
                        self._groups[axes] = g

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def block_group(self, axis: str, size: int):
        """The group of the ranks that share this rank's coordinates on the
        other axes and whose ``axis`` coordinate lies in its block of
        ``size`` consecutive ones (the ranks that hold one replicated kv
        head of an uneven head split).  The first call for an (axis, size)
        creates every such group on every rank, so all ranks make it in
        one order, as ``new_group`` requires."""
        key = (axis, size)
        if key not in self._blocks:
            n = self.shape[axis]
            if n % size:
                raise ValueError(f"{n} {axis} ranks do not tile blocks of "
                                 f"{size}")
            rank, mine = dist.get_rank(), None
            rest = [a for a in self.axis_names if a != axis]
            for fixed in itertools.product(
                    *(range(self.shape[a]) for a in rest)):
                for b in range(n // size):
                    ranks = [_ravel({**dict(zip(rest, fixed)),
                                     axis: b * size + k}, self)
                             for k in range(size)]
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        mine = g
            self._blocks[key] = mine
        return self._blocks[key]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[axis]

    def group(self, axes: str | Sequence[str]):
        """The process group of this rank over ``axes`` (a name or names;
        taken in mesh order)."""
        if isinstance(axes, str):
            axes = (axes,)
        key = tuple(a for a in self.axis_names if a in set(axes))
        if len(key) != len(set(axes)):
            raise KeyError(f"axes {tuple(axes)} not all in {self.axis_names}")
        if not key:
            raise ValueError("the group of no axes")
        if not dist.is_initialized():
            raise RuntimeError("the mesh's process group is gone "
                               "(destroy_process_group was called)")
        return self._groups[key]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type})"


def _unravel(rank: int, shape: tuple[int, ...]) -> tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _ravel(coords: dict, mesh: Mesh) -> int:
    r = 0
    for a in mesh.axis_names:
        r = r * mesh.shape[a] + coords[a]
    return r


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    """16x16 single pod (256 ranks) or 2x16x16 two-pod (512 ranks), the
    reference's shapes and axis names; raises unless the world matches."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device_type=device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, *,
                    device_type: str = "cuda") -> Mesh:
    """A small ("data", "model") mesh over the ranks of a test or a one-card
    run."""
    return Mesh((n_data, n_model), ("data", "model"), device_type=device_type)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def all_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               init_file: str, device: str, timeout_s: float,
               args: tuple) -> None:
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, *args)
        torch.save(out, _result_path(init_file, rank))
    finally:
        dist.destroy_process_group()


def _result_path(init_file: str, rank: int) -> str:
    return f"{init_file}.rank{rank}.pt"


def spawn(fn: Callable, world: int, *, backend: str, init_file: str | Path,
          device: str, args: tuple = (), timeout_s: float = 600.0
          ) -> list[Any]:
    """Run ``fn(rank, *args)`` in ``world`` rank processes (spawn start
    method) with the default process group initialised over ``backend``
    from the file ``init_file`` (which must not exist yet; its directory
    also takes the ranks' results).  Each rank uses one thread for torch
    and, with ``device="cuda"``, the card ``rank % device_count``.

    Returns the ranks' return values in rank order (saved with
    ``torch.save``, so what ``fn`` returns must pickle).  A rank that raises
    fails the run: ``torch.multiprocessing`` stops the others and raises
    here.  ``fn`` must be importable by name (a module-level function)."""
    import torch.multiprocessing as mp

    init_file = str(init_file)
    if os.path.exists(init_file):
        raise FileExistsError(f"{init_file} exists; a file store starts "
                              "from no file")
    mp.start_processes(_rank_main,
                       args=(fn, world, backend, init_file, device,
                             timeout_s, tuple(args)),
                       nprocs=world, join=True, start_method="spawn")
    out = []
    for r in range(world):
        path = _result_path(init_file, r)
        out.append(torch.load(path, weights_only=False))  # our ranks' files
        os.unlink(path)
    return out
