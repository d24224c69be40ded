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
  all-to-all      : ``(P, total)`` rows, row j for peer j ->
                    ``all_to_all_single`` -> ``(P, total)``, peer j's
                    block at index j (``all_to_all_c``, the Ulysses
                    redistribute; ``chunks=`` ignored as for the permute)

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
  All-to-all  : ``all_to_all_c`` fwd / ``all_to_all_c`` with the split
                and concat dims swapped bwd

Every rank must issue the same collectives in the same order.  The model
guarantees it: all ranks run the same layers on same-shaped shards, and
``torch.utils.checkpoint`` recomputes the same hops on every rank.

Bounded-but-ragged slots (the JAX package's negotiated slots): a stack
such as ``taco+zle`` publishes a variable layout, whose slot width is a
worst-case bound with a uint32 length header recording the achieved
bytes.  A codec with ``slot="auto"`` carries a controller-set
``moved_frac`` (per-chunk fractions of the bound): each hop truncates its
wire to the negotiated width before its one ``torch.distributed`` call
and zero-repads after — bit-exact whenever every slot's achieved bytes
fit, because a variable layout zeroes everything past them.  Such hops
probe their achieved bytes, and ``escalate=`` codecs probe their
relative quantization error (one row decoded back, on chunk 0 of a ring
hop).  A probe leaves a 0-d tensor on the device; :func:`drain_probes`
reads every pending probe with one copy to the host per device, between
steps (the JAX package's ``jax.effects_barrier``), and hands the values
to the :class:`SlotController` and ``policy.ErrorEscalationController``
that were live at the probe.  A codec without ``slot=auto`` or
``escalate=`` adds no probe op and no host sync.  ``multibuffer_wire()``
moves each encoded component with a call of its own and routes chunked
codecs through the monolithic hop, as the JAX package's toggle does.
The byte accounting splits three ways: ``wire_slot_bytes`` (the bound),
``moved_slot_bytes`` (the negotiated width) and ``achieved_slot_bytes``
(the payload).
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import math
import weakref

import torch
import torch.distributed as dist

from repro_torch.core import overlap
from repro_torch.core.codecs import (IdentityCodec, achieved_wire_bytes_i64,
                                     unpack_wire)

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


# --------------------------------------------------------------------------
# single-buffer wire packing
# --------------------------------------------------------------------------

_WIRE_PACKING: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_wire_packing", default=True)


@contextlib.contextmanager
def multibuffer_wire():
    """Within the block, each encoded component moves with a
    ``torch.distributed`` call of its own (as its bytes), and chunked
    codecs take the monolithic hop (the ring slices the packed buffer).
    A :mod:`contextvars` value: nested uses restore the enclosing state,
    and concurrent contexts each see their own."""
    token = _WIRE_PACKING.set(False)
    try:
        yield
    finally:
        _WIRE_PACKING.reset(token)


def _wire_layout(codec, n):
    wl = getattr(codec, "wire_layout", None)
    return None if wl is None else wl(n)


def _move_components(enc, move) -> tuple:
    """One ``move`` per encoded component, each as its uint8 bytes."""
    out = []
    for a in enc:
        got = move(a.contiguous().view(torch.uint8))
        out.append(got.view(a.dtype))
    return tuple(out)


# --------------------------------------------------------------------------
# negotiated slots: widths, truncation, probes
# --------------------------------------------------------------------------

#: Live SlotControllers and ErrorEscalationControllers (weak: a dropped
#: controller needs no unregister).  With none live, probes are inert.
_CONTROLLERS: "weakref.WeakSet" = weakref.WeakSet()
_ERR_CONTROLLERS: "weakref.WeakSet" = weakref.WeakSet()

#: Probe values still on the device: ``(controllers, head, value, cast)``;
#: :func:`drain_probes` appends ``head + (cast(value),)`` to each
#: controller's ``_obs``.
_PENDING: list = []


def _slot_key(codec):
    """The codec with any negotiated ``moved_frac`` stripped: the identity
    a controller keeps its statistics under (and the static-bound variant
    a resync runs)."""
    if getattr(codec, "moved_frac", None) is not None:
        return dataclasses.replace(codec, moved_frac=None)
    return codec


def negotiated_wire_bytes(codec, n: int, *, chunk: int | None = None):
    """The bytes one hop of an ``n``-element slot moves under the codec's
    negotiated ``moved_frac``, or None when the full bound moves (static
    layouts, codecs not negotiated).  ``chunk`` picks a ring chunk's
    fraction; ``None`` (a monolithic hop) takes the widest.  Clamped to
    the layout's always-achieved floor (every component before the data
    region) and to the bound."""
    layout = _wire_layout(codec, n)
    if layout is None or not layout.variable:
        return None
    frac = getattr(codec, "moved_frac", None)
    if frac is None:
        return None
    f = max(frac) if chunk is None else frac[min(chunk, len(frac) - 1)]
    floor = layout.components[-1].offset
    return max(floor, min(layout.total_bytes,
                          math.ceil(layout.total_bytes * f)))


def _truncate(wire, moved_b):
    """The first ``moved_b`` bytes of every wire row, contiguous (what a
    negotiated hop moves); the wire itself when the full bound moves."""
    if moved_b is None or moved_b >= wire.shape[-1]:
        return wire
    return wire[..., :moved_b].contiguous()


def _zero_repad(wire, total_bytes: int):
    """Widen a truncated wire back to the slot bound with zero bytes: the
    exact inverse of the truncation when the achieved bytes fit."""
    pad = total_bytes - wire.shape[-1]
    if pad <= 0:
        return wire
    return torch.nn.functional.pad(wire, (0, pad))


def _enqueue(controllers, head, value, cast) -> None:
    ctls = list(controllers)
    if ctls:
        _PENDING.append((ctls, head, value.detach(), cast))


def _spans_ranks() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def _agree(vals: torch.Tensor) -> torch.Tensor:
    """Every observation as the MAX over the ranks of the job, so that
    every rank's controllers take the same decisions (negotiated widths
    must match on both ends of a hop, and a replay must happen on every
    rank or on none).  Every rank runs the same hops in the same order,
    so the pending lists line up; a rank whose list is longer or shorter
    raises."""
    n = torch.tensor([vals.numel(), -vals.numel()], dtype=torch.int64,
                     device=vals.device)
    dist.all_reduce(n, op=dist.ReduceOp.MAX)
    if int(n[0]) != -int(n[1]):
        raise RuntimeError(f"probe lists differ across ranks: "
                           f"{-int(n[1])} .. {int(n[0])} observations")
    dist.all_reduce(vals, op=dist.ReduceOp.MAX)
    return vals


def drain_probes() -> None:
    """Read every pending probe value to the host (one copy per device)
    and append the observations to the controllers that were live at the
    probe.  Controllers call it at the top of ``finish_step``.  Across
    processes (``torch.distributed`` with more than one rank) every rank
    must call it at the same point: the values are first reduced to
    their MAX over the ranks (:func:`_agree`), the one place where the
    port differs from the JAX package, whose single controller sees the
    probes of every device."""
    items = list(_PENDING)
    _PENDING.clear()
    if _spans_ranks():
        dev = items[0][2].device if items else (
            torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))
        vals = torch.stack([v.reshape(()).to(torch.float64)
                            for _, _, v, _ in items]) if items else \
            torch.zeros(0, dtype=torch.float64, device=dev)
        host = _agree(vals).cpu().tolist()
    else:
        if not items:
            return
        by_dev: dict = {}
        for i, (_, _, v, _) in enumerate(items):
            by_dev.setdefault(v.device, []).append(i)
        host = [None] * len(items)
        for idx in by_dev.values():
            vals = torch.stack([items[i][2].reshape(()).to(torch.float64)
                                for i in idx]).cpu().tolist()
            for i, v in zip(idx, vals):
                host[i] = v
    for (ctls, head, _, cast), v in zip(items, host):
        for ctl in ctls:
            ctl._obs.append(head + (cast(v),))


def _probed(codec, layout) -> bool:
    """Whether a hop of ``codec`` probes anything."""
    return (layout.variable and getattr(codec, "slot", "static") == "auto") \
        or getattr(codec, "escalate", None) is not None


def _slot_probe(codec, layout, wire, moved_bytes: int, chunk: int) -> None:
    """One achieved-bytes observation of a hop's encoded wire (the max
    over its rows), when the codec opted into slot renegotiation."""
    if not layout.variable or getattr(codec, "slot", "static") != "auto":
        return
    mx = achieved_wire_bytes_i64(wire, layout).max()
    _enqueue(_CONTROLLERS, (_slot_key(codec), int(chunk),
                            int(layout.total_bytes), int(moved_bytes)),
             mx, int)


def _err_probe(codec, x2d, wire, n: int) -> None:
    """One sampled relative-quantization-error observation, when the codec
    carries an ``escalate=`` policy: the first wire row decoded back on
    the device, ``||dec - x|| / ||x||``."""
    if getattr(codec, "escalate", None) is None:
        return
    ref = x2d[:1].float()
    dec = codec.decode_wire(wire[:1], n, torch.float32)
    err = torch.sqrt(torch.sum((dec - ref) ** 2)) \
        / (torch.sqrt(torch.sum(ref * ref)) + 1e-12)
    _enqueue(_ERR_CONTROLLERS, (_slot_key(codec),), err, float)


def _transport(x2d, codec, move, *, reduce=False, dtype):
    """Pad the trailing dim of ``x2d`` to the codec granule, encode into the
    packed wire buffer, ``move`` it (one collective), decode (fused peer
    sum when ``reduce``), and crop the padding.  A negotiated codec moves
    only ``negotiated_wire_bytes`` and zero-repads what arrives; under
    :func:`multibuffer_wire` each component moves on its own."""
    padded, n = _pad_to(x2d, codec.granule)
    pn = padded.shape[-1]
    layout = _wire_layout(codec, pn) if _WIRE_PACKING.get() else None
    if layout is None:
        enc = _move_components(codec.encode(padded), move)
        if reduce:
            return codec.decode_sum(enc, pn, dtype)[:n]
        return codec.decode(enc, pn, dtype)[..., :n]
    wire = codec.encode_wire(padded)
    moved_b = negotiated_wire_bytes(codec, pn, chunk=None)
    _slot_probe(codec, layout, wire,
                layout.total_bytes if moved_b is None else moved_b, 0)
    _err_probe(codec, padded, wire, pn)
    wire = _zero_repad(move(_truncate(wire, moved_b)), layout.total_bytes)
    if reduce:
        return codec.decode_sum_wire(wire, pn, dtype)[:n]
    return codec.decode_wire(wire, pn, dtype)[..., :n]


def _ring_stages(codec, csz: int, nchunks: int, stack, decode_one):
    """Per-chunk encode and decode stages of a ring: chunk ``c`` encodes,
    probes (the error probe on chunk 0 only) and truncates to its
    negotiated width; its decode stacks the arrivals in peer order
    (``stack``), zero-repads them and ``decode_one``s them."""
    layout = _wire_layout(codec, csz)
    total = layout.total_bytes
    moved = [negotiated_wire_bytes(codec, csz, chunk=c)
             for c in range(nchunks)]

    def enc_for(c):
        def enc(seg):
            wire = codec.encode_wire(seg)
            m = moved[c]
            _slot_probe(codec, layout, wire, total if m is None else m, c)
            if c == 0:                  # sampled: one error probe a hop
                _err_probe(codec, seg, wire, csz)
            return _truncate(wire, m)
        return enc

    def decode(arrivals):
        return decode_one(_zero_repad(stack(arrivals), total))

    return [enc_for(c) for c in range(nchunks)], decode


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
    the next is posted; the last stays in flight until its decode.  A
    negotiated codec moves each chunk at its own width (the JAX package's
    ragged-aware ring)."""
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

    encode, decode = _ring_stages(
        codec, csz, len(segs),
        lambda moved: _peer_order(moved[0], idx, p)[:, 0],    # (P, bytes)
        lambda stack: codec.decode_wire(stack, csz, x.dtype))

    outs = overlap.run_ring(segs, encode=encode, transfer=transfer,
                            decode=decode,
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

    encode, decode = _ring_stages(
        codec, csz, len(segs),
        lambda moved: _peer_order(moved[0], idx, p),          # (P, bytes)
        lambda stack: codec.decode_sum_wire(stack, csz,
                                            x.dtype).reshape(-1)[:csz])

    outs = overlap.run_ring(segs, encode=encode, transfer=transfer,
                            decode=decode,
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
    if _WIRE_PACKING.get() and ring_chunks(codec) > 1:
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
    if _WIRE_PACKING.get() and ring_chunks(codec) > 1:
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
    encodes it into ONE packed uint8 wire buffer (probed and truncated as
    in :func:`_transport`), sends it and decodes what arrives.  A rank
    that no pair sends to gets zeros, as ``lax.ppermute`` gives; a rank
    that sends nothing encodes nothing, unless the codec probes.  Under
    :func:`multibuffer_wire` each component is sent on its own."""
    src, dst = _pairs(group, perm)
    if isinstance(codec, IdentityCodec):
        got = _permute(x.contiguous(), group, src, dst, x.shape, x.dtype,
                       x.device)
        return torch.zeros_like(x) if got is None else got
    flat, n = _pad_to(x.reshape(1, -1), codec.granule)
    pn = flat.shape[-1]
    layout = codec.wire_layout(pn)
    if not _WIRE_PACKING.get():
        sends = [None] * len(layout.components) if dst is None else \
            [a.contiguous().view(torch.uint8) for a in codec.encode(flat)]
        got = [_permute(b, group, src, dst, (1, c.nbytes), torch.uint8,
                        x.device) for b, c in zip(sends, layout.components)]
        if src is None:
            return torch.zeros_like(x)
        enc = unpack_wire(torch.cat(got, dim=-1), layout)
        return codec.decode(enc, pn, x.dtype)[..., :n].reshape(x.shape)
    moved_b = negotiated_wire_bytes(codec, pn, chunk=None)
    width = layout.total_bytes if moved_b is None else moved_b
    send = None
    if dst is not None or _probed(codec, layout):
        # a rank that sends nothing still probes, so that every rank of
        # the job makes the same observations (drain_probes)
        wire = codec.encode_wire(flat)
        _slot_probe(codec, layout, wire, width, 0)
        _err_probe(codec, flat, wire, pn)
        send = None if dst is None else _truncate(wire, moved_b)
    got = _permute(send, group, src, dst, (1, width), torch.uint8, x.device)
    if got is None:
        return torch.zeros_like(x)
    wire = _zero_repad(got, layout.total_bytes)
    return codec.decode_wire(wire, pn, x.dtype)[..., :n].reshape(x.shape)


def _a2a_impl(x, group, split_dim, concat_dim, codec):
    """All-to-all over ``group`` (the JAX package's ``_a2a_impl``): ``x``
    is cut along ``split_dim`` into P blocks, block j goes to peer j, and
    the blocks received are joined peer-major along ``concat_dim`` — the
    tiled ``lax.all_to_all`` layout, for ``split_dim == concat_dim`` (the
    MoE dispatch) and for the transposed Ulysses hop alike.  The identity
    codec moves the tensor's bytes; any other codec encodes the P blocks
    into ONE packed (P, slot) wire buffer through :func:`_transport`
    (probed, truncated and, under :func:`multibuffer_wire`, moved a
    component at a time as on the other hops) and decodes what arrives.
    ``chunks=`` is ignored: an all-to-all has nothing to ring over."""
    p = group_size(group)
    moved = torch.movedim(x, split_dim, 0)
    d = moved.shape[0]
    if d % p:
        raise ValueError(
            f"compressed all-to-all: split dim {split_dim} has size {d}, "
            f"not divisible by the group size {p}")
    rows = moved.reshape(p, -1)                     # row j -> peer j
    if isinstance(codec, IdentityCodec):
        raw = rows.contiguous().view(torch.uint8)
        dec = _exchange_rows(raw, group).view(x.dtype)
    else:
        dec = _transport(rows, codec, lambda w: _exchange_rows(w, group),
                         dtype=x.dtype)
    # stack[j]: peer j's block, split dim already cut to d/p and in front;
    # undo the movedim inside each block, then put the peer axis just
    # before concat_dim and merge it in, peer-major
    stack = dec.reshape(p, d // p, *moved.shape[1:])
    blocks = torch.movedim(stack, 1, split_dim + 1)
    out = torch.movedim(blocks, 0, concat_dim)
    shape = list(x.shape)
    shape[split_dim] = d // p
    shape[concat_dim] *= p
    return out.reshape(shape)


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


def all_to_all_c(x, group, split_dim, concat_dim, fwd_codec, bwd_codec):
    """Compressed all-to-all over ``group`` (the MoE dispatch; the Ulysses
    heads<->sequence redistribute): ONE ``all_to_all_single`` moving the
    packed wire buffer, the output in the tiled layout (``split_dim``
    shrinks P-fold, ``concat_dim`` grows P-fold); the split dim must
    divide by the group size (``ValueError`` otherwise).  The backward
    swaps the dims and the codecs — for the transposed hop exactly the
    inverse redistribute."""
    return _apply(
        x, lambda a, g, sd, cd, fc, bc: _a2a_impl(a, g, sd, cd, fc),
        lambda ct, g, sd, cd, fc, bc: all_to_all_c(ct, g, cd, sd, bc, fc),
        (group, split_dim, concat_dim, fwd_codec, bwd_codec))


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


# --------------------------------------------------------------------------
# communication-volume accounting
# --------------------------------------------------------------------------

def _chunk_geometry(codec, n: int, chunks):
    """(chunks, chunk size) of an ``n``-element slot as the transport pads
    it: to ``chunks * granule`` (``chunks`` defaults to the codec's)."""
    chunks = ring_chunks(codec) if chunks is None else max(1, int(chunks))
    mult = chunks * codec.granule
    padded = ((int(n) + mult - 1) // mult) * mult
    return chunks, padded // chunks


def wire_slot_bytes(codec, n: int, *, chunks: int | None = None):
    """Exact packed bytes one ``n``-element slot puts on the wire: the
    slot padded to ``chunks * granule``, ``chunks`` wire slices of
    ``wire_layout(padded / chunks)`` each (``chunks=1`` for hops that
    never ring).  For a variable layout this is the slot bound.  None for
    the identity codec."""
    chunks, csz = _chunk_geometry(codec, n, chunks)
    layout = _wire_layout(codec, csz)
    if layout is None:
        return None
    return chunks * layout.total_bytes


def moved_slot_bytes(codec, n: int, *, chunks: int | None = None):
    """Exact bytes the transport MOVES for one ``n``-element slot under
    the codec's negotiated ``moved_frac``: the per-chunk
    :func:`negotiated_wire_bytes` summed over the chunks.  Equals
    :func:`wire_slot_bytes` for static layouts and codecs not
    negotiated; None for the identity codec."""
    chunks, csz = _chunk_geometry(codec, n, chunks)
    layout = _wire_layout(codec, csz)
    if layout is None:
        return None
    if chunks == 1:
        m = negotiated_wire_bytes(codec, csz, chunk=None)
        return layout.total_bytes if m is None else m
    total = 0
    for c in range(chunks):
        m = negotiated_wire_bytes(codec, csz, chunk=c)
        total += layout.total_bytes if m is None else m
    return total


def achieved_slot_bytes(codec, x2d, *, chunks: int | None = None):
    """Achieved (data-dependent) wire bytes per slot row of ``x2d``, a
    ``(slots,)`` int64 tensor (None for the identity codec): each chunk
    slice encoded as the transport encodes it, the length headers summed
    over the chunks (the full slot width on a static layout)."""
    chunks = ring_chunks(codec) if chunks is None else max(1, int(chunks))
    padded, _ = _pad_to(x2d, chunks * codec.granule)
    csz = padded.shape[-1] // chunks
    layout = _wire_layout(codec, csz)
    if layout is None:
        return None
    total = None
    for c in range(chunks):
        wire = codec.encode_wire(padded[:, c * csz:(c + 1) * csz])
        ach = achieved_wire_bytes_i64(wire, layout)
        total = ach if total is None else total + ach
    return total


def _achieved_total(codec, sample, chunks=None):
    ach = achieved_slot_bytes(codec, sample, chunks=chunks)
    return None if ach is None else float(ach.sum())


def gather_wire_bytes(local_shape, dtype, p, codec, *, sample=None) -> float:
    """Bytes one all-gather puts on the wire per rank: the local slot's
    packed buffer sent to the other p-1 peers.  With ``sample`` (a tensor
    of ``local_shape``) the achieved bytes of that data instead of the
    bound."""
    n = int(math.prod(local_shape))
    if sample is not None:
        ach = _achieved_total(codec, sample.reshape(1, -1))
        if ach is not None:
            return ach * (p - 1)
    slot = wire_slot_bytes(codec, n)
    if slot is None:
        slot = n * torch.empty((), dtype=dtype).element_size()
    return float(slot) * (p - 1)


def scatter_wire_bytes(local_shape, dtype, p, codec, *, sample=None) -> float:
    """Bytes one reduce-scatter puts on the wire per rank: p-1 of the p
    destination slots (each ``n/p`` elements, padded and packed).  With
    ``sample`` the achieved bytes, split into the p slots as the
    transport does and scaled by (p-1)/p."""
    n = int(math.prod(local_shape))
    if sample is not None and n % p == 0:
        ach = _achieved_total(codec, sample.reshape(p, -1))
        if ach is not None:
            return ach * (p - 1) / p
    slot = wire_slot_bytes(codec, n // p)
    if slot is None:
        slot = (n // p) * torch.empty((), dtype=dtype).element_size()
    return float(slot) * (p - 1)


def a2a_wire_bytes(local_shape, dtype, p, codec, *, sample=None) -> float:
    """Bytes one all-to-all puts on the wire per rank: p-1 of the p split
    slots (each ``n/p`` elements, padded to the granule and packed; the
    hop never rings).  With ``sample`` the achieved bytes, scaled by
    (p-1)/p as for :func:`scatter_wire_bytes`."""
    n = int(math.prod(local_shape))
    if sample is not None and n % p == 0:
        ach = _achieved_total(codec, sample.reshape(p, -1), chunks=1)
        if ach is not None:
            return ach * (p - 1) / p
    slot = wire_slot_bytes(codec, n // p, chunks=1)
    if slot is None:
        slot = (n // p) * torch.empty((), dtype=dtype).element_size()
    return float(slot) * (p - 1)


# --------------------------------------------------------------------------
# SlotController: slot renegotiation between steps
# --------------------------------------------------------------------------

class SlotController:
    """Host-side renegotiation of ``slot="auto"`` wire codecs, per codec
    identity (:func:`_slot_key`)::

        STATIC ──(watermark known)──> NEGOTIATED(frac)
           ^                              │
           └──(overflow: achieved > moved, one-step resync)──┘

    * STATIC (bootstrap, or the step after an overflow): hops move the
      full bound, always bit-exact, and their probes record the achieved
      bytes.
    * NEGOTIATED: hops move ``ceil(frac * bound)``, ``frac`` the decaying
      achieved/slot high-watermark times ``1 + headroom``, rounded up to
      the :data:`QUANTUM` grid (few distinct widths, few plan variants).
    * A probe with ``achieved > moved`` is an OVERFLOW: the step's decode
      may have dropped nonzero tail bytes, so :meth:`finish_step` returns
      True and the caller discards the step and replays it; ``apply``
      then hands back the static bound, which cannot overflow.

    Probes leave their values on the device; ``finish_step`` reads them
    with one copy (:func:`drain_probes`)."""

    #: An overflow demands a bit-exact replay (``policy.StepController``).
    may_replay = True
    #: Negotiated fractions snap UP to this grid.
    QUANTUM = 1.0 / 32.0
    #: High-watermark decay per observation: ``max(obs, d*wm + (1-d)*obs)``.
    DECAY = 0.875

    def __init__(self, reporter=None):
        self.reporter = reporter
        self._obs: collections.deque = collections.deque()
        self._hwm: dict = {}     # (key, chunk) -> achieved/slot frac hwm
        self._frac: dict = {}    # key -> negotiated per-chunk frac tuple
        self._resync: set = set()   # keys pinned to STATIC next step
        self._paths: dict = {}   # key -> set of plan path names (events)
        self.renegotiations = 0
        self.resyncs = 0
        self.overflows = 0
        _CONTROLLERS.add(self)

    # ---- negotiation ------------------------------------------------------
    def negotiate(self, codec):
        """The variant of ``codec`` the next step runs: negotiated once a
        watermark exists, the static-bound key while bootstrapping or
        resyncing, a codec not under ``slot=auto`` unchanged."""
        if getattr(codec, "slot", None) != "auto":
            return codec
        key = _slot_key(codec)
        frac = self._frac.get(key)
        if key in self._resync or frac is None:
            return key
        if getattr(codec, "moved_frac", None) == frac:
            return codec
        return dataclasses.replace(key, moved_frac=frac)

    def apply(self, plan):
        """:meth:`negotiate` over every codec path of a ``CommPlan``; the
        plan itself when no path is under ``slot=auto``."""
        changes = {}
        for f in dataclasses.fields(plan):
            codec = getattr(plan, f.name)
            if getattr(codec, "slot", None) != "auto":
                continue
            self._paths.setdefault(_slot_key(codec), set()).add(f.name)
            neg = self.negotiate(codec)
            if neg is not codec:
                changes[f.name] = neg
        return dataclasses.replace(plan, **changes) if changes else plan

    # ---- observation ------------------------------------------------------
    def observe_sample(self, codec, x2d, *, chunks: int | None = None):
        """Record the observations the probes would make for ``x2d``
        without a collective (a warm start): one per-chunk achieved-bytes
        max at the static width.  The rows of ``x2d`` are wire rows and
        its trailing dim is chunk-sliced as the transport slices a flat
        hop, so flatten a one-stream hop to ``(1, -1)``."""
        key = _slot_key(codec)
        if getattr(key, "slot", None) != "auto":
            raise ValueError("observe_sample needs a slot='auto' codec")
        nchunks = ring_chunks(key) if chunks is None else max(1, int(chunks))
        padded, _ = _pad_to(x2d, nchunks * key.granule)
        csz = padded.shape[-1] // nchunks
        layout = _wire_layout(key, csz)
        for c in range(nchunks):
            wire = key.encode_wire(padded[:, c * csz:(c + 1) * csz])
            ach = int(achieved_wire_bytes_i64(wire, layout).max())
            self._obs.append((key, c, int(layout.total_bytes),
                              int(layout.total_bytes), ach))

    # ---- the between-steps tick --------------------------------------------
    def finish_step(self) -> bool:
        """Drain this step's probes, update the watermarks and renegotiate.
        True on an OVERFLOW: the caller must discard the step and replay
        it (``apply`` now returns the static bound for the overflowed
        keys)."""
        drain_probes()
        overflowed: dict = {}
        seen_static: set = set()
        while self._obs:
            key, chunk, slot_b, moved_b, ach = self._obs.popleft()
            f = ach / slot_b
            k = (key, chunk)
            cur = self._hwm.get(k)
            self._hwm[k] = f if cur is None else max(
                f, self.DECAY * cur + (1.0 - self.DECAY) * f)
            if ach > moved_b:
                overflowed[key] = max(overflowed.get(key, 0), ach - moved_b)
            elif moved_b >= slot_b:
                seen_static.add(key)
        if overflowed:
            self.overflows += len(overflowed)
            self.resyncs += len(overflowed)
            self._resync |= set(overflowed)
            for key, by in sorted(overflowed.items(), key=repr):
                self._event("slot/resync", key, overflow_bytes=by)
            return True
        # a clean static observation closes a resync window
        self._resync -= seen_static
        self._renegotiate()
        return False

    def _renegotiate(self) -> None:
        per_key: dict = {}
        for (key, chunk), wm in self._hwm.items():
            per_key.setdefault(key, {})[chunk] = wm
        for key, obs in per_key.items():
            if key in self._resync:
                continue
            headroom = float(getattr(key, "headroom", 0.5))
            # chunks never probed (only monolithic hops ran) borrow the
            # widest observed fraction
            fallback = max(obs.values())
            fracs = tuple(
                self._quantize(obs.get(c, fallback) * (1.0 + headroom))
                for c in range(ring_chunks(key)))
            if fracs != self._frac.get(key):
                self._frac[key] = fracs
                self.renegotiations += 1
                self._event("slot/renegotiate", key,
                            frac_max=max(fracs), frac_min=min(fracs))

    def _quantize(self, f: float) -> float:
        q = math.ceil(f / self.QUANTUM) * self.QUANTUM
        return min(max(q, self.QUANTUM), 1.0)

    # ---- telemetry --------------------------------------------------------
    def _event(self, kind, key, **fields) -> None:
        if self.reporter is not None:
            paths = ",".join(sorted(self._paths.get(key, ()))) or "?"
            self.reporter.event(kind, paths=paths, **fields)

    def metrics(self) -> dict:
        """Cumulative protocol counters (``comm/*`` keys)."""
        return {"comm/slot_renegotiations": float(self.renegotiations),
                "comm/slot_resyncs": float(self.resyncs),
                "comm/slot_overflows": float(self.overflows)}
