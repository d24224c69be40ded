"""The TACO operators and the route between their two forms.

Every operator is a kernel wrapper that dispatches by the device of its
tensor: a CPU tensor takes the plain PyTorch version (``ref``), a CUDA
tensor launches the hand-written kernel or raises.  The block forms
(``compress_blocks``, ``decompress_blocks``, ``decompress_reduce``) work on
(M, B) blocks and separate metadata; the fused wire forms
(``compress_wire``, ``decompress_wire``, ``decompress_reduce_wire``) read
and write the packed uint8 wire row.

:func:`wire_kernel_impl` picks the form a codec takes for a slot, with the
JAX package's rule (``repro/kernels/ops.py``): the wire forms up to
``WIRE_FUSED_MAX_SLOT_ELEMS`` elements per slot, the block forms composed
with ``pack_wire`` / ``unpack_wire`` above it.
"""
from __future__ import annotations

from repro_torch.kernels.ash_compress import (  # noqa: F401
    compress_blocks, compress_wire, supported)
from repro_torch.kernels.ash_decompress import (  # noqa: F401
    decompress_blocks, decompress_reduce, decompress_reduce_wire,
    decompress_wire)

# The JAX package's slot budget for its fused wire kernels (a TPU VMEM
# limit there), kept at the same value so that both packages take the same
# route at the same shape and the tests can hold route against route.  It
# is no limit of the card: the CUDA wire kernels take any slot.  Decode
# hops (n = batch x d_model) stay below it; a training hop, which flattens
# a whole (B, S, d) activation into one slot, lies above it.
WIRE_FUSED_MAX_SLOT_ELEMS = 512 * 1024


def wire_kernel_impl(cfg, n: int | None = None):
    """``"wire"`` when the fused wire kernels cover ``cfg`` at slot size
    ``n`` (the kernels' config coverage and the slot budget), else None:
    the codec then composes the block forms with the wire packing."""
    if not supported(cfg):
        return None
    if n is not None and n > WIRE_FUSED_MAX_SLOT_ELEMS:
        return None
    return "wire"
