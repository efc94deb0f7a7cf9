"""Meshes for the launchers -- counterpart of `repro.launch.mesh`.

A JAX mesh is single-controller: one process sees every device.  The
port runs one process per rank (`repro_torch.core.mesh`), so a
multi-axis mesh here is a `GridMesh`: the axis names and sizes, this
rank's coordinates, and one process subgroup per *line* of the grid (the
ranks that differ only along a set of axes), over which
`repro_torch.sharding.layout` gathers a tensor sharded along those axes
and the split step reduces over its data axes.  Ranks lie on the grid in
row-major order of the axes.  The line groups carry the grid's
collective ``timeout``: a rank that waits longer in one raises instead
of waiting on, and `sharding.layout.agree`, over the whole process
group, which no line uses, then has every rank remake its lines
(`GridMesh.remake_lines`).

`make_production_mesh` is shape only: the port starts no 256 or 512
ranks, and the dry run (`launch.dryrun`) reads nothing but the shape.
"""
from __future__ import annotations

import datetime
import itertools
import math
from typing import Dict, Optional, Tuple

import torch.distributed as dist

from repro_torch.core import mesh as core_mesh

__all__ = ["GridMesh", "make_production_mesh", "make_rows_mesh",
           "make_grid", "make_mesh_like", "parse_mesh"]


class GridMesh:
    """A named grid of ranks.  ``shape`` maps axis -> size (JAX's
    ``Mesh.shape``), ``coords`` this rank's coordinate per axis, ``device``
    where its blocks live, ``world`` the `core.mesh.Mesh` of the whole
    process group (None: one rank, or a mesh with no process behind it --
    shape only, even where ``rank`` gives it coordinates), ``timeout``
    the seconds a collective over a line may wait (None: the process
    group's)."""

    def __init__(self, axis_names: Tuple[str, ...], sizes: Tuple[int, ...],
                 *, rank: Optional[int] = None, device=None,
                 timeout: Optional[float] = None):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        self.size = math.prod(sizes)
        self.rank = rank
        self.device = device
        self.timeout = timeout
        self.world: Optional[core_mesh.Mesh] = None
        self.coords = None if rank is None else self.coords_of(rank)
        # frozenset of axes -> (core_mesh.Mesh of this rank's line, the
        # line's global ranks in group order)
        self._lines: Dict[frozenset, tuple] = {}

    def __repr__(self) -> str:
        dims = "x".join(str(s) for s in self.shape.values())
        return (f"GridMesh({dims}, {self.axis_names}, rank={self.rank}, "
                f"device={self.device})")

    def coords_of(self, rank: int) -> Dict[str, int]:
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def line_ranks(self, axes, coords: Dict[str, int]):
        """The global ranks that share ``coords`` off ``axes``, row-major
        over ``axes`` (in the mesh's axis order)."""
        axes = [a for a in self.axis_names if a in axes]
        out = []
        for combo in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(coords)
            c.update(zip(axes, combo))
            out.append(self.rank_of(c))
        return out

    def line(self, axes) -> tuple:
        """(a `core.mesh.Mesh` over this rank's line along ``axes``, its
        global ranks in group order)."""
        return self._lines[frozenset(axes)]

    def _make_lines(self) -> None:
        """Every rank creates every subgroup, in the same order: for each
        set of axes of more than one rank, one group per line (the whole
        grid's too: the process group itself is `agree`'s alone)."""
        names = self.axis_names
        timeout = None if self.timeout is None else datetime.timedelta(
            seconds=self.timeout)
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                if math.prod(self.shape[a] for a in axes) == 1:
                    continue
                key = frozenset(axes)
                rest = [a for a in names if a not in key]
                for combo in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    base = dict(zip(rest, combo), **{a: 0 for a in axes})
                    ranks = self.line_ranks(axes, base)
                    group = dist.new_group(ranks, timeout=timeout)
                    if self.rank in ranks:
                        self._lines[key] = (self._sub(group, ranks), ranks)

    def remake_lines(self) -> None:
        """Every rank drops its line groups and creates them anew, in the
        same order.  After a rank failed between two collectives of a
        line, and the others' wait in the next one timed out, the line's
        ranks have issued different numbers of collectives over it, and
        the old group would pair the wrong ones."""
        for line, _ in self._lines.values():
            dist.destroy_process_group(line.group)
        self._lines = {}
        self._make_lines()

    def _sub(self, group, ranks) -> core_mesh.Mesh:
        return core_mesh.Mesh(group=group, size=len(ranks),
                              rank=ranks.index(self.rank),
                              device=self.device)


def make_production_mesh(*, multi_pod: bool = False) -> GridMesh:
    """16x16 chips per pod ("data", "model"); 2 pods add a leading "pod".
    Shape only."""
    if multi_pod:
        return GridMesh(("pod", "data", "model"), (2, 16, 16))
    return GridMesh(("data", "model"), (16, 16))


def make_rows_mesh(n: int | None = None, axis_name: str = "rows",
                   device=None) -> core_mesh.Mesh:
    """The 1-D mesh of the logdet core over the process group (the
    paper's P processors); ``n``, when given, must be its size."""
    mesh = core_mesh.make_mesh(device=device)
    if n is not None and n != mesh.size:
        raise ValueError(f"a {n}-rank mesh over a group of {mesh.size}")
    return core_mesh.Mesh(group=mesh.group, size=mesh.size, rank=mesh.rank,
                          device=mesh.device, axis_name=axis_name)


def make_grid(axes, dims, device=None, timeout=None) -> GridMesh:
    """A `GridMesh` of ``axes`` x ``dims`` over the process group (a
    one-rank grid needs none); ``timeout`` as in `GridMesh`."""
    n = math.prod(dims)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a {'x'.join(map(str, dims))} mesh needs a process group "
                f"of {n} ranks (core.mesh.run_ranks, or launch.train "
                "--mesh, which starts them)")
        return GridMesh(axes, dims, rank=0,
                        device=core_mesh.rank_device(0, device))
    world = core_mesh.make_mesh(device=device)
    if world.size != n:
        raise ValueError(f"a {'x'.join(map(str, dims))} mesh over a group "
                         f"of {world.size} ranks")
    grid = GridMesh(axes, dims, rank=world.rank, device=world.device,
                    timeout=timeout)
    grid.world = world
    grid._make_lines()
    return grid


def parse_mesh(spec: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """'2x2' / '2x16x16' / '8' -> (axis names, sizes): ("rows",), ("data",
    "model") or ("pod", "data", "model") by the number of dims."""
    dims = tuple(int(x) for x in spec.lower().split("x"))
    axes = {1: ("rows",), 2: ("data", "model"),
            3: ("pod", "data", "model")}.get(len(dims))
    if axes is None:
        raise ValueError(spec)
    return axes, dims


def make_mesh_like(spec: str, device=None, *, grid: bool = False,
                   timeout=None):
    """'2x2' / '2x16x16' / '8' -> a mesh over the process group (for CLI
    flags): a 1-D spec is the rows mesh (with ``grid``, a ("rows",)
    `GridMesh`, on which the sharding rules split nothing), two or three
    dims a `GridMesh` on ("data", "model") / ("pod", "data", "model").  A
    one-rank grid needs no process group.  ``device`` as in
    `core.mesh.rank_device`, ``timeout`` as in `GridMesh`."""
    axes, dims = parse_mesh(spec)
    if axes == ("rows",) and not grid:
        return make_rows_mesh(dims[0], device=device)
    return make_grid(axes, dims, device, timeout)
