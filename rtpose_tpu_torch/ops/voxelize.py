"""Fixed-shape point-cloud voxelization in plain torch, on any device.

Counterpart of ``rtpose_tpu/ops/voxelize.py`` (reference numba hash-grid
voxelizer ``det3d/ops/point_cloud/point_cloud_ops.py:7-55``: reverse (z, y,
x) coordinate indexing, ``max_points`` per voxel, ``max_voxels`` cap; and the
dynamic scatter-mean encoder ``models/readers/dynamic_voxel_encoder.py``).

The JAX package's deviation is kept: the reference assigns voxel slots and
drops overflow in point-arrival order; here points are sorted by voxel id
(stable), so voxel slots come out in flat-id order and overflow drops the
later points within the sorted order.  The mean-pool reader and the dense
scatter downstream are order-invariant, so the dense grid is the
reference's whenever no voxel overflows ``max_points``.

Every shape is fixed by the spec and the padded point count: invalid and
padding points carry the sentinel id ``nx * ny * nz`` and sort to the tail,
group ranks come from a running max (``torch.cummax``, JAX's
``associative_scan(jnp.maximum)``), and dropped points are written to a pad
row that is sliced off.  No boolean indexing and no ``nonzero``: nothing
here has a data-dependent shape.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class VoxelizerSpec:
    pc_range: Tuple[float, float, float, float, float, float]  # xyz_min, xyz_max
    voxel_size: Tuple[float, float, float]                     # (sx, sy, sz)
    max_points: int = 35
    max_voxels: int = 20000

    @property
    def grid_size_xyz(self) -> Tuple[int, int, int]:
        return tuple(int(round((self.pc_range[3 + i] - self.pc_range[i]) / self.voxel_size[i]))
                     for i in range(3))

    @property
    def grid_size_zyx(self) -> Tuple[int, int, int]:
        return self.grid_size_xyz[::-1]


def _voxel_ids(points: torch.Tensor, num_points: int, spec: VoxelizerSpec):
    """Integer voxel coordinates (N, 3) xyz, validity (N,) and the z-major
    flat id (N,) int64, the sentinel ``nx * ny * nz`` where invalid.  The
    offsets and sizes are float32 tensors (a division by a Python scalar on
    the card multiplies by its reciprocal, one ulp away from JAX)."""
    N = points.shape[0]
    nx, ny, nz = spec.grid_size_xyz
    dev = points.device
    pmin = torch.tensor(spec.pc_range[:3], dtype=torch.float32, device=dev)
    vsz = torch.tensor(spec.voxel_size, dtype=torch.float32, device=dev)
    cxyz = torch.floor((points[:, :3] - pmin) / vsz).to(torch.int32)
    grid = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)
    valid = torch.arange(N, device=dev) < num_points
    valid = valid & ((cxyz >= 0) & (cxyz < grid)).all(dim=1)
    c = cxyz.long()
    flat = (c[:, 2] * ny + c[:, 1]) * nx + c[:, 0]
    flat = torch.where(valid, flat, torch.full_like(flat, nx * ny * nz))
    return cxyz, valid, flat


def voxelize(points: torch.Tensor, num_points: int, spec: VoxelizerSpec) -> dict:
    """Voxelize one padded point cloud.

    Args:
      points: (N, F) float32, columns 0..2 = xyz (padding rows arbitrary).
      num_points: number of valid rows.
      spec: static config.

    Returns a dict (``rtpose_tpu/ops/voxelize.py::voxelize``'s):
      voxels: (max_voxels, max_points, F) padded per-voxel points;
      coors: (max_voxels, 3) int32 (z, y, x), 0 for empty slots;
      num_points_per_voxel: (max_voxels,) int32;
      num_voxels: () int32;
      point_voxel_idx: (N,) int32 voxel slot of each point (-1 dropped).
    """
    N, F = points.shape
    V, P = spec.max_voxels, spec.max_points
    dev = points.device
    cxyz, _, flat = _voxel_ids(points, num_points, spec)
    nx, ny, nz = spec.grid_size_xyz
    big = nx * ny * nz

    order = torch.argsort(flat, stable=True)
    sflat = flat[order]
    svalid = sflat < big
    head = torch.ones_like(svalid)
    head[1:] = sflat[1:] != sflat[:-1]
    head = head & svalid
    gidx = torch.cumsum(head.long(), 0) - 1                   # group of each sorted point
    gidx = torch.where(svalid, gidx, torch.full_like(gidx, V))
    pos = torch.arange(N, device=dev)
    group_start = torch.cummax(torch.where(head, pos, torch.zeros_like(pos)), 0).values
    rank = pos - group_start

    keep = svalid & (gidx < V) & (rank < P)
    g_safe = torch.where(keep, gidx, torch.full_like(gidx, V))   # the pad row
    r_safe = torch.where(keep, rank, torch.zeros_like(rank))

    voxels = torch.zeros((V + 1, P, F), dtype=points.dtype, device=dev)
    voxels[g_safe, r_safe] = torch.where(keep[:, None], points[order],
                                         torch.zeros((), dtype=points.dtype, device=dev))
    npts = torch.zeros((V + 1,), dtype=torch.int32, device=dev)
    npts.index_add_(0, g_safe, keep.to(torch.int32))
    # every point of a kept group carries the group's coordinates
    coors = torch.zeros((V + 1, 3), dtype=torch.int32, device=dev)
    coors[g_safe] = torch.where(keep[:, None], cxyz[order].flip(1),
                                torch.zeros((), dtype=torch.int32, device=dev))
    num_voxels = torch.clamp(head.sum(), max=V).to(torch.int32)
    pv = torch.full((N,), -1, dtype=torch.int32, device=dev)
    pv[order] = torch.where(keep, gidx, torch.full_like(gidx, -1)).to(torch.int32)
    return dict(voxels=voxels[:V], coors=coors[:V], num_points_per_voxel=npts[:V],
                num_voxels=num_voxels, point_voxel_idx=pv)


def dynamic_scatter_mean(points: torch.Tensor, num_points: int,
                         spec: VoxelizerSpec) -> torch.Tensor:
    """Dynamic voxelization: the mean of the point features per voxel, on the
    dense (Z, Y, X, F) grid (DynamicVoxelEncoder parity, no voxel list)."""
    N, F = points.shape
    nx, ny, nz = spec.grid_size_xyz
    _, valid, flat = _voxel_ids(points, num_points, spec)
    w = valid.to(points.dtype)
    sums = torch.zeros((nz * ny * nx + 1, F), dtype=points.dtype, device=points.device)
    sums.index_add_(0, flat, points * w[:, None])
    cnts = torch.zeros((nz * ny * nx + 1,), dtype=points.dtype, device=points.device)
    cnts.index_add_(0, flat, w)
    mean = sums[:-1] / torch.clamp(cnts[:-1, None], min=1.0)
    return mean.reshape(nz, ny, nx, F)


def scatter_to_dense(voxel_features: torch.Tensor, coors: torch.Tensor,
                     num_voxels: torch.Tensor, grid_zyx: Tuple[int, int, int]) -> torch.Tensor:
    """Scatter (B, V, C) voxel features at (B, V, 3) zyx coordinates onto a
    dense (B, Z, Y, X, C) grid (the dense 'middle encoder'), for a batch at
    once: one ``index_add_`` on a flat (B * Z * Y * X + 1, C) buffer.  Slots
    at or past a sample's ``num_voxels`` carry weight 0 and land on the last
    row, which is dropped.  The valid slots of a sample hold distinct
    coordinates, so no two of them add into one row and the float result
    does not depend on the order of the adds."""
    B, V, C = voxel_features.shape
    nz, ny, nx = grid_zyx
    dev = voxel_features.device
    valid = torch.arange(V, device=dev)[None, :] < num_voxels.reshape(B, 1)
    c = coors.long()
    flat = (c[..., 0] * ny + c[..., 1]) * nx + c[..., 2]
    flat = flat + torch.arange(B, device=dev)[:, None] * (nz * ny * nx)
    flat = torch.where(valid, flat, torch.full_like(flat, B * nz * ny * nx))
    src = voxel_features * valid[..., None].to(voxel_features.dtype)
    grid = torch.zeros((B * nz * ny * nx + 1, C), dtype=voxel_features.dtype, device=dev)
    grid.index_add_(0, flat.reshape(-1), src.reshape(B * V, C))
    return grid[:-1].reshape(B, nz, ny, nx, C)
