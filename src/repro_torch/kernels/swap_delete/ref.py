"""Plain PyTorch versions of H1's delete-complement map: the loop itself
(:func:`swap_delete_ref`, the CPU route) and the last-writer forest the
card's kernels build (:func:`swap_delete_forest_ref`, for checking them at
sizes where the loop takes seconds)."""
from __future__ import annotations

import torch


def _steps(trips: torch.Tensor, k: torch.Tensor, D: int) -> torch.Tensor:
    """Each row's effective step count: iterations with m = k - i <= 0 are
    no-ops, so clamp(min(trips, k), 0); none where D <= 0."""
    n = torch.minimum(trips, k).clamp(min=0)
    return n if D > 0 else torch.zeros_like(n)


def swap_delete_ref(L: int, trips: torch.Tensor, k: torch.Tensor,
                    bits: torch.Tensor, D: int) -> torch.Tensor:
    """Start from the identity map [..., L] and run ``trips`` [...] deletions:
    iteration i sets src[v] = src[clamp(m - 1, 0, L - 1)] with m = k - i and
    v = bits[..., min(i, D - 1)] mod max(m, 1), dropped where v >= L. A loop
    of masked iterations (each a no-op where a row has no step i left), in
    the JAX order."""
    batch = trips.shape
    src = torch.arange(L, dtype=torch.int64, device=trips.device).expand(
        batch + (L,)).clone()
    n = _steps(trips, k, D)
    for i in range(int(n.max()) if n.numel() else 0):
        active = i < n
        m = k - i
        v = bits[..., min(i, D - 1)] % torch.clamp(m, min=1)
        # v >= L only where m - 1 >= L, whose read clamps to L - 1 too: the
        # clamped write puts src[L - 1] back in place, as a dropped one leaves it
        v = v.clamp(0, L - 1)
        val = torch.gather(src, -1, (m - 1).clamp(0, L - 1).unsqueeze(-1))
        old = torch.gather(src, -1, v.unsqueeze(-1))
        src.scatter_(-1, v.unsqueeze(-1),
                     torch.where(active.unsqueeze(-1), val, old))
    return src


def swap_delete_forest_ref(L: int, trips: torch.Tensor, k: torch.Tensor,
                           bits: torch.Tensor, D: int) -> torch.Tensor:
    """:func:`swap_delete_ref`'s map built as the card's forest route builds
    it. Where k <= L, slot f_i = k - 1 - i is never written after step i, so
    step i moves the value of the last earlier step that wrote into f_i (a
    step with v_i == f_i writes its slot into itself: no writer), or f_i
    where none did. Last writers by one scatter-max of step indices, each
    step's root by pointer jumping, then s[q] = f of the root of q's last
    writer, or q. Rows with k > L, or more steps than D, take the loop."""
    batch = trips.shape
    T = trips.numel()
    dev = trips.device
    tr, kk = trips.reshape(T).to(torch.int64), k.reshape(T).to(torch.int64)
    b = bits.reshape(T, -1).to(torch.int64) if D > 0 else None
    n = _steps(tr, kk, D)
    slot = torch.arange(L, dtype=torch.int64, device=dev)
    out = slot.expand(T, L).clone()
    loop = (n > 0) & ((kk > L) | (n > D))
    if bool(loop.any()):
        out[loop] = swap_delete_ref(L, tr[loop], kk[loop], b[loop], D)
    rows = ((n > 0) & ~loop).nonzero().squeeze(-1)
    width = int(n[rows].max()) if rows.numel() else 0
    if width == 0:
        return out.reshape(batch + (L,))
    n_r, k_r = n[rows, None], kk[rows, None]
    i = torch.arange(width, dtype=torch.int64, device=dev)
    active = i < n_r                                        # [R, width]
    m = k_r - i
    f = (m - 1).clamp(0, L - 1)
    v = b[rows][:, i.clamp(max=D - 1)] % m.clamp(min=1)
    writes = active & (v != f)
    # phase A: each slot's last writer; column L takes the steps that write nothing
    last = torch.full((rows.numel(), L + 1), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(1, torch.where(writes, v, L), i.expand_as(v), "amax")
    last[:, L] = -1
    # phase B: parent = the last writer of f_i; roots point at themselves
    par = torch.gather(last, 1, torch.where(active, f, L))
    ptr = torch.where(par >= 0, par, i)
    while True:
        nxt = torch.gather(ptr, 1, ptr)
        if torch.equal(nxt, ptr):
            break
        ptr = nxt
    val = k_r - 1 - ptr                                     # f of each step's root
    # phase C: the map
    w = last[:, :L]
    out[rows] = torch.where(w >= 0, torch.gather(val, 1, w.clamp(min=0)), slot)
    return out.reshape(batch + (L,))
