"""Compressed collectives — the paper's §4.4.2 communication layer.

Compression follows COCCL's two-shot decomposition, as the JAX package:

  ReduceScatter = one compressed all-to-all + ONE fused local reduction
  AllGather     = one compressed all-gather + fused decompress
  AllReduce     = ReduceScatter ∘ AllGather  (two compressions per round)

``_transport`` pads to the codec granule, encodes straight into ONE
packed uint8 wire buffer (``encode_wire``), moves it, and decodes straight
from the moved buffer (``decode_wire``, or ``decode_sum_wire`` when the
hop reduces).  Each hop therefore runs one compress operator on the sender
and one decompress (all-gather) or decompress-reduce (reduce-scatter)
operator on the receiver: the fused wire kernels for a slot inside the
codec's wire budget (decode hops), the block kernels for a larger one
(training hops).

The move goes through ``torch.distributed`` on the hop's process group
(the TP group, or a group of the fsdp axes) — NCCL on the cards, gloo on
the CPU — with one implementation for both backends:

  all-gather      : ``(1, total)`` uint8 rows -> ``all_gather_into_tensor``
                    -> ``(P, total)``, peer j's row at index j
  reduce-scatter  : ``(P, total)`` rows, row j for peer j ->
                    ``all_to_all_single`` -> ``(P, total)``, peer j's
                    contribution at index j
  permute         : ``(1, total)`` -> ``batch_isend_irecv`` to the rank's
                    destination and from its source (``ppermute_c``, the
                    pipeline boundary; ``chunks=`` is ignored, as in the
                    JAX package: one send has nothing to ring over)

A codec with ``chunks > 1`` takes the chunked ring instead (the JAX
package's ``_ag_one_ring`` / ``_rs_one_ring``): each chunk is encoded,
forwarded neighbour to neighbour with ``batch_isend_irecv`` and decoded,
the three stages pipelined over chunks by ``core/overlap.py``.  The
ring's arrivals are put back in peer-index order (:func:`_peer_order`)
before the decode, so the ring is bit-identical to the monolithic hop.

The group is a ``torch.distributed`` process group, or ``None`` (or the
int 1) for a group of one: this process alone, where the move is the
identity on the wire — as JAX's size-1 ``all_to_all`` / ``all_gather``
is — and encode and decode still run.  The identity codec takes the plain
collectives of the same meaning (``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce``).

A tuple of groups, outermost first, is the JAX package's tuple of mesh
axes (the fsdp axes ``("pod", "data")``): an all-gather walks it innermost
first and a reduce-scatter outermost first, one hop per group, so that
rank ``pod * data_size + data`` holds the shard of that index.  The codec
runs at every stage, a stage of one rank included, as in the JAX package:
under ``grad_rs=sdp4bit`` a weight gradient is quantized once per stage.

Every collective takes a forward and a backward codec and is a
``torch.autograd.Function`` whose backward routes the cotangent through
the conjugate collective on the same group with the codec pair swapped,
as the JAX package's ``custom_vjp`` (quantization is straight-through:
the quantizer is not differentiated):

  Megatron-SP : ``all_gather_c`` fwd / ``psum_scatter_c`` bwd, and back
  AllReduce   : ``allreduce_g`` (fwd AR, bwd id) / ``copy_f`` (fwd id,
                bwd AR)
  Pipeline    : ``ppermute_c`` fwd / ``ppermute_c`` over the inverted
                pairs bwd

Every rank must issue the same collectives in the same order.  The model
guarantees it: all ranks run the same layers on same-shaped shards, and
``torch.utils.checkpoint`` recomputes the same hops on every rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import overlap
from repro_torch.core.codecs import IdentityCodec

Identity = IdentityCodec()


def _groups(group) -> tuple:
    """A group, or a tuple of groups (outermost first), as a tuple."""
    return group if isinstance(group, tuple) else (group,)


def group_size(group) -> int:
    """Ranks in ``group``: 1 for ``None`` / the int 1 (this process
    alone), else the process group's size."""
    if group is None or group == 1:
        return 1
    if isinstance(group, int):
        raise ValueError(
            f"a group of {group} given as a bare size: pass the "
            "torch.distributed process group (parallel.init_tp_group)")
    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank in ``group`` (0 for a group of one)."""
    if group is None or group == 1:
        return 0
    group_size(group)                      # rejects a bare size > 1
    return dist.get_rank(group)


def moves(group) -> bool:
    """True when the hop goes through ``torch.distributed`` (a process
    group, even of one rank); False for this process alone."""
    group_size(group)                      # rejects a bare size > 1
    return not (group is None or group == 1)


def _pad_to(x: torch.Tensor, mult: int):
    n = x.shape[-1]
    rem = (-n) % mult
    if rem:
        x = torch.nn.functional.pad(x, (0, rem))
    return x, n


# --------------------------------------------------------------------------
# the moves of one packed wire buffer
# --------------------------------------------------------------------------

def _gather_rows(row: torch.Tensor, group) -> torch.Tensor:
    """(1, total) -> (P, total), row j from peer j (the wire's uint8 rows,
    or any flattened tensor)."""
    if not moves(group):
        return row
    out = row.new_empty((group_size(group), row.shape[-1]))
    dist.all_gather_into_tensor(out, row.contiguous(), group=group)
    return out


def _exchange_rows(rows: torch.Tensor, group) -> torch.Tensor:
    """(P, total) uint8, row j for peer j -> (P, total), row j from peer j
    (the two-shot reduce-scatter's all-to-all)."""
    if not moves(group):
        return rows
    out = torch.empty_like(rows)
    dist.all_to_all_single(out, rows.contiguous(), group=group)
    return out


def _transport(x2d, codec, move, *, reduce=False, dtype):
    """Pad the trailing dim of ``x2d`` to the codec granule, encode into the
    packed wire buffer, ``move`` it (one collective), decode (fused peer
    sum when ``reduce``), and crop the padding."""
    padded, n = _pad_to(x2d, codec.granule)
    pn = padded.shape[-1]
    wire = move(codec.encode_wire(padded))
    if reduce:
        return codec.decode_sum_wire(wire, pn, dtype)[:n]
    return codec.decode_wire(wire, pn, dtype)[..., :n]


# --------------------------------------------------------------------------
# the chunked ring
# --------------------------------------------------------------------------

def ring_chunks(codec) -> int:
    """Number of ring chunks the codec requests (1 = monolithic; the
    identity codec, which has no wire buffer to slice, always 1)."""
    return int(getattr(codec, "chunks", 1) or 1)


def _peer_order(arrivals, idx: int, p: int) -> torch.Tensor:
    """Stack arrival-ordered buffers into peer-index order.

    THE ring bit-parity invariant.  After k neighbour-forwarding hops a
    rank holds the buffer of peer ``(idx - k) mod P``, so arrivals come in
    a rank-DEPENDENT order; the monolithic collectives deliver peer-index
    order on every rank.  Decoding — and especially ``decode_sum``'s
    sequential float accumulation, whose rounding depends on operand
    order — must therefore consume ``stack[j] == peer j's buffer``
    everywhere (peer j's buffer sits at arrival ``(idx - j) mod P``).
    Skipping it would give per-rank 1-ulp sum differences, not just
    permuted outputs."""
    return torch.stack([arrivals[(idx - j) % p] for j in range(p)])


def _chunk_slices(x2d, codec):
    """Pad the trailing dim to ``chunks * granule`` and return the chunk
    views plus the original trailing size and the chunk size.  The padding
    is compressed and shipped like real data, and every chunk has the same
    size, so all ring streams share one wire layout."""
    chunks = ring_chunks(codec)
    padded, n0 = _pad_to(x2d, chunks * codec.granule)
    csz = padded.shape[-1] // chunks
    return ([padded[:, c * csz:(c + 1) * csz].contiguous()
             for c in range(chunks)], n0, csz)


def _exchange(sends, recvs, group) -> list:
    """Post ``(peer, tensor)`` sends and receives as one batch; returns the
    async work handles (nothing to do for an empty batch)."""
    ops = [dist.P2POp(op, t, dist.get_global_rank(group, peer), group)
           for op, pairs in ((dist.isend, sends), (dist.irecv, recvs))
           for peer, t in pairs]
    return dist.batch_isend_irecv(ops) if ops else []


def _ag_one_ring(x, group, dim, codec):
    """Chunked ring all-gather: each chunk's local wire buffer is forwarded
    neighbour to neighbour for P-1 steps, and each chunk's decode consumes
    the peer-ordered arrival stack (:func:`_peer_order`), so the result is
    bit-identical to the monolithic hop.  A step's send is the buffer the
    step before received, so each step but the last is waited on before
    the next is posted; the last stays in flight until its decode."""
    p, idx = group_size(group), group_rank(group)
    segs, n0, csz = _chunk_slices(x.reshape(1, -1), codec)
    nxt, prv = (idx + 1) % p, (idx - 1) % p

    def transfer(buf):
        arrivals, works = [buf], []
        for _ in range(p - 1):
            for w in works:
                w.wait()
            got = torch.empty_like(buf)
            works = _exchange([(nxt, arrivals[-1])], [(prv, got)], group)
            arrivals.append(got)
        return arrivals, works

    def decode(moved):
        stack = _peer_order(moved[0], idx, p)[:, 0]          # (P, bytes)
        return codec.decode_wire(stack, csz, x.dtype)

    outs = overlap.run_ring(segs, encode=codec.encode_wire,
                            transfer=transfer, decode=decode,
                            schedule=overlap.ring_schedule(codec))
    dec = (torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0])[:, :n0]
    dec = dec.reshape(p, *x.shape)
    out = torch.movedim(dec, 0, dim)
    shape = list(x.shape)
    shape[dim] *= p
    return out.reshape(shape)


def _rs_one_ring(x, group, dim, codec):
    """Chunked ring reduce-scatter (two-shot preserving): every rank sends
    its once-compressed contribution for the peer k hops ahead straight to
    it, for k = 1..P-1, in one batch — no partial-sum requantization — and
    the fused ``decode_sum`` runs per chunk on the peer-ordered stack
    (:func:`_peer_order`), bit-identical to the monolithic all-to-all."""
    p, idx = group_size(group), group_rank(group)
    rowsrc = torch.movedim(x, dim, 0)
    d = rowsrc.shape[0]
    if d % p:
        raise ValueError(
            f"compressed reduce-scatter: scatter dim {dim} has size {d}, "
            f"not divisible by the group size {p}")
    rows = rowsrc.reshape(p, -1)                   # row j -> destined peer j
    segs, n0, csz = _chunk_slices(rows, codec)

    def transfer(wire):
        # arrival k: the contribution of peer (idx - k) for this rank
        arrivals = [wire[idx]] + [torch.empty_like(wire[0])
                                  for _ in range(p - 1)]
        works = _exchange(
            [((idx + k) % p, wire[(idx + k) % p]) for k in range(1, p)],
            [((idx - k) % p, arrivals[k]) for k in range(1, p)], group)
        return arrivals, works

    def decode(moved):
        stack = _peer_order(moved[0], idx, p)               # (P, bytes)
        return codec.decode_sum_wire(stack, csz, x.dtype).reshape(-1)[:csz]

    outs = overlap.run_ring(segs, encode=codec.encode_wire,
                            transfer=transfer, decode=decode,
                            schedule=overlap.ring_schedule(codec))
    summed = (torch.cat(outs) if len(outs) > 1 else outs[0])[:n0]
    out = summed.reshape(d // p, *rowsrc.shape[1:])
    return torch.movedim(out, 0, dim) if dim != 0 else out


# --------------------------------------------------------------------------
# one-axis hops
# --------------------------------------------------------------------------

def _ag_plain(x, group, dim):
    """Uncompressed tiled all-gather along ``dim``."""
    p = group_size(group)
    if not moves(group):
        return x
    out = _gather_rows(x.reshape(1, -1), group).reshape(p, *x.shape)
    shape = list(x.shape)
    shape[dim] *= p
    return torch.movedim(out, 0, dim).reshape(shape)


def _rs_plain(x, group, dim):
    """Uncompressed tiled reduce-scatter along ``dim``."""
    p = group_size(group)
    if not moves(group):
        return x
    moved = torch.movedim(x, dim, 0).contiguous()
    if moved.shape[0] % p:
        raise ValueError(
            f"reduce-scatter: scatter dim {dim} has size {moved.shape[0]}, "
            f"not divisible by the group size {p}")
    out = moved.new_empty((moved.shape[0] // p, *moved.shape[1:]))
    dist.reduce_scatter_tensor(out, moved, group=group)
    return torch.movedim(out, 0, dim) if dim != 0 else out


def _ag_one(x, group, dim, codec):
    """One-axis compressed all-gather concatenating along ``dim``: identity
    codecs take the plain all-gather, chunked wire codecs the ring,
    everything else the monolithic packed transport — all bit-identical
    for a given codec."""
    if isinstance(codec, IdentityCodec):
        return _ag_plain(x, group, dim)
    if ring_chunks(codec) > 1:
        return _ag_one_ring(x, group, dim, codec)
    p = group_size(group)
    dec = _transport(x.reshape(1, -1), codec,
                     lambda w: _gather_rows(w, group), dtype=x.dtype)
    dec = dec.reshape(p, *x.shape)                            # (P, ...)
    out = torch.movedim(dec, 0, dim)
    shape = list(x.shape)
    shape[dim] *= p
    return out.reshape(shape)


def _rs_one(x, group, dim, codec):
    """One-axis compressed reduce-scatter along ``dim`` (same three-way
    dispatch as :func:`_ag_one`): ONE compressed all-to-all, ONE fused
    local reduction."""
    if isinstance(codec, IdentityCodec):
        return _rs_plain(x, group, dim)
    if ring_chunks(codec) > 1:
        return _rs_one_ring(x, group, dim, codec)
    p = group_size(group)
    moved = torch.movedim(x, dim, 0)
    d = moved.shape[0]
    if d % p:
        raise ValueError(
            f"compressed reduce-scatter: scatter dim {dim} has size {d}, "
            f"not divisible by the group size {p}")
    chunks = moved.reshape(p, -1)                       # chunk i -> peer i
    summed = _transport(chunks, codec, lambda w: _exchange_rows(w, group),
                        reduce=True, dtype=x.dtype)
    out = summed.reshape(d // p, *moved.shape[1:])
    return torch.movedim(out, 0, dim) if dim != 0 else out


def _pairs(group, perm):
    """(source, destination) of this rank under ``perm``, a tuple of
    ``(src, dst)`` group-rank pairs as ``lax.ppermute`` takes them (each
    rank a source at most once and a destination at most once); ``None``
    where no pair names this rank."""
    p, me = group_size(group), group_rank(group)
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or \
            any(not 0 <= r < p for r in srcs + dsts):
        raise ValueError(f"permutation {perm!r} is not one over a group "
                         f"of {p}")
    src = next((s for s, d in perm if d == me), None)
    dst = next((d for s, d in perm if s == me), None)
    return src, dst


def _permute(buf, group, src, dst, shape, dtype, device):
    """Send ``buf`` to ``dst`` and receive a ``shape`` / ``dtype`` tensor on
    ``device`` from ``src`` (group ranks; ``None``: no send, no receive),
    as one batch; returns what arrived, or ``None``.  A pair of this rank
    with itself is a copy, with no ``torch.distributed`` call."""
    me = group_rank(group)
    got = None
    if src is not None:
        got = buf.clone() if src == me else \
            torch.empty(shape, dtype=dtype, device=device)
    sends = [(dst, buf)] if dst not in (None, me) else []
    recvs = [(src, got)] if src not in (None, me) else []
    if sends or recvs:
        for w in _exchange(sends, recvs, group):
            w.wait()
    return got


def _pp_impl(x, group, perm, codec):
    """Point-to-point permute over ``group`` (the JAX package's
    ``_pp_impl``): the identity codec moves the tensor; any other codec
    encodes it into ONE packed uint8 wire buffer, sends it and decodes
    what arrives.  A rank that no pair sends to gets zeros, as
    ``lax.ppermute`` gives; a rank that sends nothing encodes nothing."""
    src, dst = _pairs(group, perm)
    if isinstance(codec, IdentityCodec):
        send, shape, dtype = x.contiguous(), x.shape, x.dtype
    else:
        flat, n = _pad_to(x.reshape(1, -1), codec.granule)
        pn = flat.shape[-1]
        shape = (1, codec.wire_layout(pn).total_bytes)
        send = None if dst is None else codec.encode_wire(flat)
        dtype = torch.uint8
    got = _permute(send, group, src, dst, shape, dtype, x.device)
    if got is None:
        return torch.zeros_like(x)
    if isinstance(codec, IdentityCodec):
        return got
    return codec.decode_wire(got, pn, x.dtype)[..., :n].reshape(x.shape)


def _ag_impl(x, group, dim, codec):
    """Hierarchical all-gather over a group or a tuple of groups, innermost
    first (the JAX package's major-to-minor concatenation order)."""
    for g in reversed(_groups(group)):
        x = _ag_one(x, g, dim, codec)
    return x


def _rs_impl(x, group, dim, codec):
    """Hierarchical reduce-scatter, outermost first (the conjugate of
    :func:`_ag_impl`'s order)."""
    for g in _groups(group):
        x = _rs_one(x, g, dim, codec)
    return x


def _ar_impl(x, group, codec):
    """Compressed two-shot AllReduce = ReduceScatter ∘ AllGather over the
    flattened tensor; identity codecs take the plain ``all_reduce`` (one
    per group of a tuple)."""
    groups = _groups(group)
    if isinstance(codec, IdentityCodec):
        if not any(moves(g) for g in groups):
            return x
        out = x.detach().clone(memory_format=torch.contiguous_format)
        for g in groups:
            if moves(g):
                dist.all_reduce(out, group=g)
        return out
    p = 1
    for g in groups:
        p *= group_size(g)
    flat, n = _pad_to(x.reshape(1, -1), p * codec.granule)
    rs = _rs_impl(flat[0], group, 0, codec)
    ag = _ag_impl(rs, group, 0, codec)
    return ag[:n].reshape(x.shape)


class _Collective(torch.autograd.Function):
    """One compressed collective with a straight-through backward:
    ``impl(x, *static)`` is the forward communication, ``bwd(ct, *static)``
    the conjugate collective on the cotangent (the JAX package's
    ``_compressed_collective``)."""

    @staticmethod
    def forward(ctx, x, impl, bwd, static):
        ctx.bwd, ctx.static = bwd, static
        return impl(x, *static)

    @staticmethod
    def backward(ctx, ct):
        return ctx.bwd(ct, *ctx.static), None, None, None


def _apply(x, impl, bwd, static):
    """``impl(x, *static)``, recorded for autograd when a gradient flows
    through ``x`` (the decode path runs without an autograd node)."""
    for g in _groups(static[0]):           # a bare size > 1 raises here
        group_size(g)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Collective.apply(x, impl, bwd, static)
    return impl(x, *static)


def all_gather_c(x, group, dim, fwd_codec, bwd_codec):
    """Compressed all-gather concatenating along ``dim`` (tiled layout);
    backward is the compressed reduce-scatter with the codec pair
    swapped."""
    return _apply(
        x, lambda a, g, d, fc, bc: _ag_impl(a, g, d, fc),
        lambda ct, g, d, fc, bc: psum_scatter_c(ct, g, d, bc, fc),
        (group, dim, fwd_codec, bwd_codec))


def psum_scatter_c(x, group, dim, fwd_codec, bwd_codec):
    """Compressed reduce-scatter along ``dim`` (two-shot: every
    contribution compressed once, peers summed in index order); backward is
    the compressed all-gather with the codec pair swapped."""
    return _apply(
        x, lambda a, g, d, fc, bc: _rs_impl(a, g, d, fc),
        lambda ct, g, d, fc, bc: all_gather_c(ct, g, d, bc, fc),
        (group, dim, fwd_codec, bwd_codec))


def allreduce_g(x, group, fwd_codec, bwd_codec):
    """Megatron "g": forward compressed two-shot AllReduce (row-parallel
    outputs and the decode path); backward identity."""
    return _apply(
        x, lambda a, g, fc, bc: _ar_impl(a, g, fc),
        lambda ct, g, fc, bc: ct, (group, fwd_codec, bwd_codec))


def copy_f(x, group, fwd_codec, bwd_codec):
    """Megatron "f": forward identity (column-parallel inputs); backward
    compressed AllReduce with the BACKWARD codec."""
    return _apply(
        x, lambda a, g, fc, bc: a,
        lambda ct, g, fc, bc: _ar_impl(ct, g, bc),
        (group, fwd_codec, bwd_codec))


def ppermute_c(x, group, perm, fwd_codec, bwd_codec):
    """Compressed point-to-point send over ``group`` (the pipeline
    boundary; the TahQuant site).  ``perm`` is a tuple of ``(src, dst)``
    group-rank pairs, as ``lax.ppermute`` takes; the backward sends the
    cotangent over the inverted pairs through the backward codec."""
    return _apply(
        x, lambda a, g, pm, fc, bc: _pp_impl(a, g, pm, fc),
        lambda ct, g, pm, fc, bc: ppermute_c(
            ct, g, tuple((d, s) for s, d in pm), bc, fc),
        (group, tuple(perm), fwd_codec, bwd_codec))


def psum_exact(x, group):
    """Sum over the group, or over each group of a tuple (plain
    ``all_reduce``s), whose backward passes the (replicated) cotangent
    through unchanged — for scalars every consumer of which is replicated
    (losses, softmax statistics)."""
    return allreduce_g(x, group, Identity, Identity)


def pmax(x, group):
    """Elementwise max over the group, no gradient (the softmax's
    stability shift)."""
    if not moves(group):
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_gather_stack(x, group) -> torch.Tensor:
    """(…) -> (P, …): every peer's ``x``, stacked in peer order, no
    gradient (small per-shard statistics)."""
    if not moves(group):
        return x[None]
    return _gather_rows(x.reshape(1, -1), group).reshape(-1, *x.shape)
