"""Wrapper of H1, the delete-complement map of the R-TBS downsample.

On a CUDA tensor it launches the hand-written kernels of ``csrc/swap_delete.cu``,
which read the trip count on the device, so a tick never syncs to learn it;
the plain loop in :mod:`.ref` runs only for CPU tensors. Two routes, chosen
from the host integers L and D alone (:func:`route`):

  * ``forest`` builds the map in parallel from the steps' last-writer
    forest (three launches: scratch set, last writers, map), whatever the
    trip count; rows with k > L run the loop itself inside the map launch;
  * ``rows`` gives each row one thread that runs the loop in shared memory,
    32 rows a warp: the keyed bank's many short rows.

Both write the whole map, identity included. The least time is the map's
bytes: 8 L + 8 trips (the bits read) a row. ``swap_delete.launches``
counts calls on the card, ``swap_delete.forest_launches`` those on the
forest route.
"""
from __future__ import annotations

import torch

from .. import _common
from . import kernel, ref

# the rows route's reach: 32 rows' maps and victims in a warp's shared
# memory, and few enough dependent steps for one lane
ROWS_MAX_L, ROWS_MAX_D = 256, 64


def route(L: int, D: int) -> str:
    """``rows`` for short rows with few steps (a thread each, the loop in
    shared memory), else ``forest``."""
    return "rows" if L <= ROWS_MAX_L and D <= ROWS_MAX_D else "forest"


def swap_delete(L: int, trips: torch.Tensor, k: torch.Tensor,
                bits: torch.Tensor, D: int) -> torch.Tensor:
    """The identity map [..., L] after ``trips`` [...] swap-with-last
    deletions from the prefix [0, k) driven by ``bits`` [..., >= D] (int64
    words in [0, 2^32)), step i taking word min(i, D - 1). Returns int64."""
    if trips.device.type == "cpu":
        return ref.swap_delete_ref(L, trips, k, bits, D)
    _common.check_cuda("swap_delete", trips, k, bits)
    if D > 0 and bits.shape[-1] < D:
        raise ValueError(f"swap_delete: bits hold {bits.shape[-1]} words a row, "
                         f"fewer than D = {D}")
    batch = trips.shape
    T = trips.numel()
    out = torch.empty((T, L), dtype=torch.int64, device=trips.device)
    args = (out, trips.to(torch.int64).reshape(T).contiguous(),
            k.to(torch.int64).reshape(T).contiguous(),
            bits.to(torch.int64).reshape(T, -1).contiguous(), D)
    if route(L, D) == "rows":
        kernel.rows(*args)
    else:
        kernel.forest(*args)
        swap_delete.forest_launches += 1
    swap_delete.launches += 1
    return out.reshape(batch + (L,))


swap_delete.launches = 0
swap_delete.forest_launches = 0
