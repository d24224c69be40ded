"""The TACO operators: the route by configuration, and the route between
their two forms.

Each of the six operators dispatches by configuration first, as the JAX
package's ``_impl_for`` (``repro/kernels/ops.py``) does: a CUDA tensor
under a configuration that has no kernel (:func:`supported` is false:
another transform, or tensor scales) runs the operator's plain PyTorch
version (``ref``) on the card, and each such call adds one to
:data:`plain_routes`.  Every other call goes to the kernel wrapper, which
runs the plain version for a CPU tensor and launches the hand-written
kernel for a CUDA tensor, or raises (a block size the kernels are not
built for, for one).  This is a route, not a fallback: nothing is caught,
and a wrapper that fails to build or launch raises.

The block forms (``compress_blocks``, ``decompress_blocks``,
``decompress_reduce``) work on (M, B) blocks and separate metadata; the
fused wire forms (``compress_wire``, ``decompress_wire``,
``decompress_reduce_wire``) read and write the packed uint8 wire row.
:func:`wire_kernel_impl` picks the form a codec takes for a slot, with the
JAX package's rule: the wire forms up to ``WIRE_FUSED_MAX_SLOT_ELEMS``
elements per slot, the block forms composed with ``pack_wire`` /
``unpack_wire`` above it.
"""
from __future__ import annotations

from repro_torch.kernels import ash_compress, ash_decompress, ref
from repro_torch.kernels.ash_compress import supported

#: operator -> the module of its kernel wrapper (same name); its plain
#: version is ``ref.<operator>_ref``
_WRAPPERS = {"compress_blocks": ash_compress,
             "decompress_blocks": ash_decompress,
             "decompress_reduce": ash_decompress,
             "compress_wire": ash_compress,
             "decompress_wire": ash_decompress,
             "decompress_reduce_wire": ash_decompress}

#: calls on a CUDA tensor that took the plain version because their
#: configuration has no kernel, by operator (0 on the main path)
plain_routes = dict.fromkeys(_WRAPPERS, 0)

# The JAX package's slot budget for its fused wire kernels (a TPU VMEM
# limit there), kept at the same value so that both packages take the same
# route at the same shape and the tests can hold route against route.  It
# is no limit of the card: the CUDA wire kernels take any slot.  Decode
# hops (n = batch x d_model) stay below it; a training hop, which flattens
# a whole (B, S, d) activation into one slot, lies above it.
WIRE_FUSED_MAX_SLOT_ELEMS = 512 * 1024


def _operator(name: str, doc: str):
    """The operator ``name(t, *args, cfg)``: the plain version for a CUDA
    tensor whose ``cfg`` has no kernel, else the kernel wrapper."""
    module = _WRAPPERS[name]

    def op(t, *args):
        if t.device.type == "cuda" and not supported(args[-1]):
            plain_routes[name] += 1
            return getattr(ref, f"{name}_ref")(t, *args)
        return getattr(module, name)(t, *args)
    op.__name__ = op.__qualname__ = name
    op.__doc__ = doc
    return op


compress_blocks = _operator(
    "compress_blocks", "(M, B) -> (q storage dtype, alpha (M,), s (M, G)).")
decompress_blocks = _operator(
    "decompress_blocks",
    "(q, s, alpha | None, cfg) -> blocks (M, B) in the compute dtype.")
decompress_reduce = _operator(
    "decompress_reduce",
    "Stacked peers q (P, M, B) -> peer sum (M, B) in the compute dtype.")
compress_wire = _operator(
    "compress_wire", "(slots, n) -> packed (slots, total_bytes) uint8 rows.")
decompress_wire = _operator(
    "decompress_wire",
    "(wire (slots, total_bytes) uint8, n, cfg) -> (slots, n) compute dtype.")
decompress_reduce_wire = _operator(
    "decompress_reduce_wire",
    "(wire (P, total_bytes) uint8, n, cfg) -> peer sum (n/B, B).")


def wire_kernel_impl(cfg, n: int | None = None):
    """``"wire"`` when the fused wire kernels cover ``cfg`` at slot size
    ``n`` (the kernels' config coverage and the slot budget), else None:
    the codec then composes the block forms with the wire packing."""
    if not supported(cfg):
        return None
    if n is not None and n > WIRE_FUSED_MAX_SLOT_ELEMS:
        return None
    return "wire"
