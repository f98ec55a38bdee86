"""Round-step kernels of the port: the plain PyTorch versions
(:mod:`.ref`, with the reduction ops of :mod:`.reduce_ops` and the
int8 block quantization of :mod:`.quant_ops`) and the
checked, counted wrappers of the hand-written CUDA
kernels (:mod:`.block_pack`, as in ``repro.kernels.block_pack``).
Nothing here builds or loads a kernel at import; :mod:`._build`
compiles ``csrc/*.cu`` at the first launch."""

from . import block_pack, quant_ops, reduce_ops, ref

__all__ = ["block_pack", "quant_ops", "reduce_ops", "ref"]
