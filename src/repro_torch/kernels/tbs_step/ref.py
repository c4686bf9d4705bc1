"""Plain PyTorch versions of the fused TBS-step payload passes (B1, B3)."""
from __future__ import annotations

import torch


def apply_ref(items: torch.Tensor, batch: torch.Tensor,
              src: torch.Tensor) -> torch.Tensor:
    """items [T, cap, D]; batch [T, bcap, D]; src [T, rows] with values in
    [0, cap + bcap) -> out [T, rows, D] with out[t, i] = items[t, src[t, i]]
    when src[t, i] < cap, else batch[t, src[t, i] - cap]. Out-of-range
    entries are clamped, as JAX clamps its gathers. Any dtype."""
    cap, bcap, D = items.shape[1], batch.shape[1], items.shape[2]
    src = src.to(torch.int64)
    shape = src.shape + (D,)
    gi = torch.gather(items, 1, src.clamp(0, cap - 1).unsqueeze(-1).expand(shape))
    gb = torch.gather(batch, 1, (src - cap).clamp(0, bcap - 1).unsqueeze(-1)
                      .expand(shape))
    return torch.where((src >= cap).unsqueeze(-1), gb, gi)


def apply_banked_ref(items: torch.Tensor, batch: torch.Tensor,
                     src: torch.Tensor) -> torch.Tensor:
    """The JAX oracle of the banked pass, ``vmap`` of the one-reservoir
    gather over T stacked reservoirs: items [T, cap, D], batch [T, bcap, D],
    src [T, cap] -> [T, cap, D]. :func:`apply_ref` is already batched."""
    return apply_ref(items, batch, src)


def subbatches_ref(payload: torch.Tensor, order: torch.Tensor,
                   starts: torch.Tensor, bcap: int) -> torch.Tensor:
    """Each routed row's sub-batch: payload [b, D] -> [b, bcap, D] with
    row t, slot j = payload[order[clip(starts[t] + j, 0, b - 1)]]."""
    b = order.shape[0]
    j = torch.arange(bcap, dtype=torch.int64, device=order.device)
    idx = (starts.to(torch.int64).unsqueeze(-1) + j).clamp(0, b - 1)
    return payload[order.to(torch.int64)][idx]


def banked_write_mask(src: torch.Tensor, cap: int) -> torch.Tensor:
    """The slots a tick map must write, [..., cap] bool for ``src``
    [..., cap]: a slot whose source is a batch row (``src >= cap``), or
    another slot of the reservoir once ``src`` is clamped into [0, cap).
    A slot whose clamped source is itself (``src[i] == i``, or
    ``src[0] < 0``) keeps its row. B3 writes these slots of the touched
    keys and nothing else; the bound in ``chip_smoke.py`` counts them."""
    s = src.to(torch.int64)
    i = torch.arange(s.shape[-1], device=s.device)
    return (s >= cap) | (s.clamp(0, cap - 1) != i)


def banked_ref(bank: torch.Tensor, payload: torch.Tensor, src: torch.Tensor,
               order: torch.Tensor, starts: torch.Tensor,
               touched: torch.Tensor, ntouched: torch.Tensor,
               bcap: int) -> None:
    """The composition B3 fuses, in place on ``bank`` [K, cap, D]: the
    routed sub-batches of ``payload`` [b, D], a gather of the clipped
    ``touched`` rows, :func:`apply_banked_ref`, and a scatter of the rows
    t < ``ntouched`` back over their keys (the sentinel rows drop). Reads
    ``ntouched`` on the host: a reference, not the card's path."""
    K = bank.shape[0]
    touched = touched.to(torch.int64)
    sub = subbatches_ref(payload, order, starts, bcap)
    items_t = bank[touched.clamp(max=K - 1)]
    out = apply_banked_ref(items_t, sub, src)
    nt = int(ntouched)
    bank[touched[:nt]] = out[:nt]
