"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside a plain
PyTorch version of the same function.

  * tbs_step          -- B1, the R-TBS tick's two-source payload pass
                         (replaces the Pallas ``tbs_step`` kernel), and
                         B3, the keyed bank's payload pass, fused with the
                         gather, sub-batching and scatter around it and in
                         place (replaces ``apply_banked``).
  * reservoir_compact -- B2, stable compaction of a realized sample
                         (replaces the Pallas ``reservoir_compact`` kernel).
  * swap_delete       -- H1, the delete-complement map of the downsample,
                         whose trip count lives on the device: a parallel
                         last-writer forest for long rows, one thread a
                         row for the bank's short ones.
  * variates          -- H2, the binomial draws of T-TBS and B-TBS, and H3,
                         the hypergeometric draw of B-RS: one thread a row
                         runs the draw's loop to its end, so no trip count
                         reaches the host.
  * flash_attention   -- B4, online-softmax GQA attention with causal and
                         sliding-window masks (replaces the Pallas
                         ``flash_attention_bhsd``): the LM prefill. bf16
                         runs on the tensor cores (wgmma fed by TMA), f32
                         on the CUDA cores.
  * ssd_scan          -- B5, the Mamba2 SSD chunked scan with its state
                         carried across chunks (replaces the Pallas
                         ``ssd_scan_bhsp``): the Mamba2 prefill. bf16 runs
                         on the tensor cores (wgmma fed by TMA), f32 on
                         the CUDA cores.

Each ``ops`` wrapper launches its kernel for CUDA tensors (or raises) and
runs the plain version for CPU tensors only. B4 and B5 launch through
registered ops (``torch.ops.repro_torch.flash_attention`` / ``.ssd_scan``)
that also give their outputs' shapes on the meta device and a FLOP formula,
so the dry run (``repro_torch.launch.dryrun``) counts them as the card runs
them. The kernels are compiled from
``csrc/*.cu`` at first use (:mod:`._build`); ``csrc/hopper.cuh`` holds the
Hopper building blocks (mbarriers, TMA, wgmma) the tensor-core kernels share.
"""
from __future__ import annotations

from .flash_attention import ops as _fa
from .reservoir_compact import ops as _rc
from .ssd_scan import ops as _ss
from .swap_delete import ops as _sd
from .tbs_step import ops as _ts
from .variates import ops as _va

WRAPPERS = {
    "tbs_step_apply": _ts.tbs_step_apply,
    "tbs_step_apply_banked": _ts.tbs_step_apply_banked,
    "reservoir_compact": _rc.reservoir_compact,
    "swap_delete": _sd.swap_delete,
    "binomial": _va.binomial,
    "hypergeometric": _va.hypergeometric,
    "flash_attention": _fa.flash_attention,
    "ssd_scan": _ss.ssd_scan,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    _fa.flash_attention.tensor_core_launches = 0
    _ss.ssd_scan.tensor_core_launches = 0
    _ss.ssd_scan.recompute_launches = 0
    _sd.swap_delete.forest_launches = 0


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
