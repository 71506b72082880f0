"""Meshes of ranks over a torch.distributed process group.

The counterpart of `repro.launch.mesh.make_mesh`. A JAX mesh is an array
of devices with named axes; here each rank of an initialized process
group is one cell of the mesh, laid out row-major over the axes as
`jax.make_mesh` lays out its devices, and every axis gets the process
group of the ranks that differ only along it. The sharded RankSVM oracle
(`core.distributed`) splits rows over 'pod' x 'data' (the row group) and
columns over 'model'.

The caller initializes the process group and picks its backend: 'nccl'
for one rank per card, 'gloo' on the CPU or for several ranks that share
one card. Nothing here switches backend. With no process group, the
default is the degenerate 1 x 1 mesh on the caller's device
(`default_mesh`), on which every collective is the identity: the
counterpart of the reference's `_default_mesh`, all local devices on
'data', which is one on one card.

The collectives the oracle needs are methods of the mesh, each in a
fixed rank order, so that every rank of a group computes the same value
bit for bit (`sum` adds the gathered parts one after another instead of
leaving the order to a reduction algorithm). They take the tensors where
they are: gloo accepts tensors on the card for `all_gather` and
`all_to_all_single` (float32, float64, int8 and int32 checked on the
H100), so several ranks can share one card without staging through the
host.

`make_production_mesh`, the dry-run's 256- and 512-chip meshes, is not
ported (ROADMAP.md Queue 1 item 13(c)).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.platform import resolve_device

AXES = ('pod', 'data', 'model')
ROW_AXES = ('pod', 'data')
ROWS = 'rows'            # the combined row group, pod x data


class Mesh:
    """This rank's place in a mesh of ranks.

    Attributes:
      axis_names: the axes, a subsequence of ('pod', 'data', 'model').
      shape: axis name -> size.
      coords: axis name -> this rank's index along it.
      groups: axis name (and 'rows', the pod x data row group) -> the
        `ProcessGroup` of the ranks that differ only along it, or None on
        a mesh with no process group.
      device: this rank's torch device.
      backend: the process group's backend, or None.
    """

    def __init__(self, shape: dict, coords: dict, groups: dict, device,
                 backend=None):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.coords = dict(coords)
        self.groups = dict(groups)
        self.device = torch.device(device)
        self.backend = backend

    def size(self, axis: str) -> int:
        """Ranks along `axis`; 'rows' is pod x data. An axis the mesh
        lacks has size 1."""
        if axis == ROWS:
            return int(np.prod([self.shape.get(a, 1) for a in ROW_AXES]))
        return int(self.shape.get(axis, 1))

    def index(self, axis: str) -> int:
        """This rank's index along `axis` ('rows': its row block)."""
        if axis == ROWS:
            return int(np.ravel_multi_index(
                tuple(self.coords.get(a, 0) for a in ROW_AXES),
                tuple(self.shape.get(a, 1) for a in ROW_AXES)))
        return int(self.coords.get(axis, 0))

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0):
        """Every rank's `t` along `axis`, concatenated on `dim` in rank
        order. The identity without a process group."""
        group = self.groups.get(axis)
        if group is None:
            return t
        return torch.cat(self._gather(t, group), dim=dim)

    def gather_stack(self, t: torch.Tensor, axis: str):
        """Every rank's `t` along `axis`, stacked on a new leading axis in
        rank order."""
        group = self.groups.get(axis)
        if group is None:
            return t[None]
        return torch.stack(self._gather(t, group))

    def sum(self, t: torch.Tensor, axis: str):
        """The sum of every rank's `t` along `axis`, the parts added one
        after another in rank order: the same bits on every rank."""
        parts = self.gather_stack(t, axis)
        out = parts[0].clone()
        for part in parts[1:]:
            out += part
        return out

    def all_to_all(self, t: torch.Tensor, axis: str):
        """`dist.all_to_all_single` along `axis`: chunk k of `t`'s leading
        axis goes to rank k, and chunk k of the result came from rank k."""
        group = self.groups.get(axis)
        if group is None:
            return t
        src = t.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        return out

    def _gather(self, t, group):
        src = t.contiguous()
        parts = [torch.empty_like(src)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        return parts

    def __repr__(self):
        return (f'Mesh({self.shape}, coords={self.coords}, '
                f'device={self.device}, backend={self.backend})')


def _validate_axes(shape, axes):
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f'mesh shape {shape} and axes {axes} differ in '
                         'length')
    if any(a not in AXES for a in axes) or len(set(axes)) != len(axes):
        raise ValueError(f'mesh axes must be distinct names from {AXES}; '
                         f'got {axes}')
    if any(s < 1 for s in shape):
        raise ValueError(f'mesh sizes must be positive; got {shape}')
    return shape, axes


def make_mesh(shape, axes, device=None) -> Mesh:
    """The mesh `shape` over `axes` (e.g. (2, 2) over ('data', 'model'))
    of the initialized process group, whose world size must be the
    product of `shape`; rank r sits at `np.unravel_index(r, shape)`.
    Every rank must call it, in the same order as its other group
    creations: it creates one process group per axis line and per row
    line (`dist.new_group` is collective). Without a process group only
    a mesh of one rank can be made, with no groups.

    `device` is this rank's device, default 'cuda' (`resolve_device`)."""
    shape, axes = _validate_axes(shape, axes)
    dev = resolve_device(device)
    total = int(np.prod(shape))
    sizes = dict(zip(axes, shape))
    if not dist.is_initialized():
        if total != 1:
            raise ValueError(
                f'a mesh of {total} ranks needs an initialized process '
                'group (torch.distributed.init_process_group) of that '
                'world size')
        return Mesh(sizes, {a: 0 for a in axes}, {}, dev)
    world = dist.get_world_size()
    if total != world:
        raise ValueError(f'mesh shape {shape} holds {total} ranks but the '
                         f'process group has {world}')
    rank = dist.get_rank()
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(rank,
                                                                shape))))
    grid = np.arange(world).reshape(shape)
    groups = {}
    lines = [(a, (axes.index(a),)) for a in axes]
    row_dims = tuple(i for i, a in enumerate(axes) if a in ROW_AXES)
    lines.append((ROWS, row_dims))
    for name, dims in lines:
        rest = [i for i in range(len(axes)) if i not in dims]
        for fixed in itertools.product(*(range(shape[i]) for i in rest)):
            index = [slice(None)] * len(axes)
            for i, v in zip(rest, fixed):
                index[i] = v
            ranks = sorted(int(r) for r in grid[tuple(index)].ravel())
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = group
    return Mesh(sizes, coords, groups, dev, backend=dist.get_backend())


def default_mesh(device=None) -> Mesh:
    """Every rank of the process group on 'data' and 'model' of size 1,
    or the degenerate 1 x 1 mesh when there is no process group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((world, 1), ('data', 'model'), device)
