"""Grid/sequence generators (reference: russell_lab/src/base/generators.rs:39,111
and linspace in vector/num_vector.rs).

Counterpart of ``russell_tpu.core.generators``, on the device rule
(``core/_place.py``): the grids are made on ``device=``, the card by
default.
"""

from __future__ import annotations

import numpy as np
import torch

from russell_tpu_torch.core._place import place

__all__ = ["linspace", "generate2d", "generate3d"]


def linspace(start: float, stop: float, count: int, dtype=None,
             device=None):
    """Evenly spaced values including both endpoints; count may be 0 or 1.

    The values are ``jnp.linspace``'s formula, ``start (1 - t) + stop t``
    with ``t = i / (count - 1)`` for i < count - 1 and ``stop`` last, each
    operation rounded once (``torch.linspace`` steps from both ends
    instead). Count 0 gives an empty f64 vector, count 1 ``[start]``."""
    dev = place(device=device)
    if count == 0:
        return torch.zeros((0,), dtype=dtype or torch.float64, device=dev)
    if count == 1:
        return torch.as_tensor(np.asarray([start]), dtype=dtype, device=dev)
    s = torch.tensor(float(start), dtype=torch.float64, device=dev)
    e = torch.tensor(float(stop), dtype=torch.float64, device=dev)
    i = torch.arange(count - 1, dtype=torch.float64, device=dev)
    # tensor over tensor: one rounding (the card divides a tensor by a
    # Python number through its reciprocal)
    t = i / torch.full_like(i, count - 1)
    out = torch.cat([s * (1.0 - t) + e * t, e.reshape(1)])
    return out if dtype is None else out.to(dtype)


def generate2d(xmin, xmax, ymin, ymax, nx: int, ny: int, device=None):
    """2D meshgrid matrices (X, Y) of shape (ny, nx) with x varying along
    columns — matches russell's generate2d (base/generators.rs:39)."""
    x = linspace(xmin, xmax, nx, device=device)
    y = linspace(ymin, ymax, ny, device=device)
    X, Y = torch.meshgrid(x, y, indexing="xy")
    return X, Y


def generate3d(xmin, xmax, ymin, ymax, zmin, zmax, nx: int, ny: int, nz: int,
               device=None):
    """3D meshgrid (X, Y, Z), each of shape (nz, ny, nx)."""
    x = linspace(xmin, xmax, nx, device=device)
    y = linspace(ymin, ymax, ny, device=device)
    z = linspace(zmin, zmax, nz, device=device)
    X, Y, Z = torch.meshgrid(x, y, z, indexing="xy")
    # meshgrid xy gives (ny, nx, nz); move z to the front
    return (torch.movedim(X, 2, 0), torch.movedim(Y, 2, 0),
            torch.movedim(Z, 2, 0))
