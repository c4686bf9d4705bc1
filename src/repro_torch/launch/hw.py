"""Target-hardware constants for the roofline: one NVIDIA H100 SXM card,
every number from NVIDIA's H100 data sheet (dense rates, no sparsity, at
the full 700 W power limit) unless labelled an assumption. The JAX
package's ``launch/hw.py`` holds a TPU v5e's; the names are the same, so
:mod:`repro_torch.launch.dryrun` reads as JAX's does.

A card set below 700 W runs slower under load: whatever is measured beside
these numbers names the card's power limit.
"""

PEAK_FLOPS_BF16 = 989e12     # per card, bf16 / fp16 on the tensor cores (spec sheet)
PEAK_FLOPS_F32 = 67e12       # per card, f32 on the CUDA cores, no TF32 (spec sheet)
HBM_BW = 3.35e12             # bytes/s per card, HBM3 (spec sheet)
# NVLink 4, per card to the other cards of its host, both directions
# together (450 GB/s each way; spec sheet): the twin of the TPU's ICI link
ICI_BW = 900e9
# one 400 Gb/s NIC a card across hosts: an ASSUMPTION (a common H100 node
# layout, not a spec-sheet figure), the twin of JAX's DCN assumption
DCN_BW = 50e9
HBM_PER_CHIP = 80e9          # bytes per card: 80 GB (spec sheet)

# device-memory bandwidth (bytes/s) by the name nvidia-smi reports, first
# match wins: (name fragment, bytes/s, label), each from its spec sheet
HBM_BW_BY_CARD = (("H200", 4.8e12, "H200 SXM spec sheet, 4.8 TB/s"),
                  ("H100 NVL", 3.9e12, "H100 NVL spec sheet, 3.9 TB/s"),
                  ("H100 PCIe", 2.0e12, "H100 PCIe spec sheet, 2.0 TB/s"),
                  ("H100", HBM_BW, "H100 SXM spec sheet, 3.35 TB/s"))


def hbm_bw_for(name: str) -> tuple[float, str]:
    """(bytes/s, label) of the card ``name`` (as nvidia-smi reports it);
    an unknown card gets the H100 SXM's, labelled so."""
    for key, bw, label in HBM_BW_BY_CARD:
        if key in name:
            return bw, label
    return HBM_BW, "H100 SXM spec sheet, 3.35 TB/s (card not in table)"
