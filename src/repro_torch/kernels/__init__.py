"""Kernels of the port: the plain PyTorch versions (:mod:`.ref`, with the
reduction ops of :mod:`.reduce_ops` and the int8 block quantization of
:mod:`.quant_ops`) and the checked, counted wrappers of the hand-written
CUDA kernels: the round steps (:mod:`.block_pack`, as in
``repro.kernels.block_pack``), forward flash attention
(:mod:`.flash_attention`) and the Mamba2 SSD scan (:mod:`.ssd_scan`), each
of the last two with its plain version beside it, and the exchange's row
rotation (:mod:`.row_roll`, ``torch.roll`` on the CPU; its launches are
counted by path in ``row_roll.LAUNCHES``, not in :func:`launches`).
Nothing here builds or loads a kernel at import; :mod:`._build` compiles
``csrc/*.cu`` at the first launch."""

from . import block_pack, flash_attention, quant_ops, reduce_ops, ref, row_roll, ssd_scan

__all__ = ["block_pack", "flash_attention", "quant_ops", "reduce_ops", "ref",
           "row_roll", "ssd_scan", "launches"]


def launches() -> dict:
    """The CUDA kernels launched since their counts were last reset (each
    wrapper module's ``reset_launches``), by name: those that ran."""
    return {k: v for mod in (block_pack, flash_attention, ssd_scan)
            for k, v in mod.LAUNCHES.items() if v}
