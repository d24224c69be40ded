"""Software-pipelined stage scheduler for the chunked ring transport — the
JAX package's ``repro/core/overlap.py`` for ``torch.distributed``.

The chunked ring collectives (``core/collectives.py`` ``_ag_one_ring`` /
``_rs_one_ring``) split one compressed all-gather / reduce-scatter into
``chunks`` independent streams, each a three-stage chain::

    encode[c]    raw chunk c      -> packed uint8 wire buffer
    transfer[c]  wire buffer      -> pending arrivals (async work handles)
    decode[c]    arrivals, waited -> decoded / peer-summed output chunk

Chunk streams carry no data dependencies on each other, so the stages of
different chunks may run at the same time (TACO §4.4, "efficient overlap
with communication").  :func:`run_ring` keeps the JAX package's tick
order under ``schedule="pipelined"``::

    tick t:   encode[t]  |  transfer[t-1]  |  decode[t-2]

with a prologue (ticks 0..1) and an epilogue (the last two ticks).  The
JAX package fences each tick with one ``optimization_barrier``; eager
PyTorch has no compiler to reorder ops, so the order is the order of
emission.  A transfer returns its arrivals with the async work handles of
its sends and receives still pending, and the decode stage waits on them
just before it reads them (``wait`` makes the current CUDA stream wait for
the NCCL stream; on gloo it blocks the host).  Inside a tick the transfer
is emitted FIRST: NCCL orders a collective after the work already queued
on the current stream, so a transfer emitted after its tick's encode
would wait for it, while one emitted before overlaps both the encode of
chunk t and the decode of chunk t-2.

``schedule="serial"`` keeps the hoisted ordering — all encodes, then all
transfers (each waited on at once), then all decodes — as the baseline the
pipelined schedule is compared against.  Both schedules run the same stage
functions on the same operands, so their results are bit-identical to
each other and to the monolithic single-collective hop.
"""
from __future__ import annotations

__all__ = [
    "PIPELINED", "SERIAL", "SCHEDULES", "validate_schedule",
    "ring_schedule", "run_ring",
]

PIPELINED = "pipelined"
SERIAL = "serial"
#: Valid values of the ``schedule=`` spec token / codec field.
SCHEDULES = (PIPELINED, SERIAL)


def validate_schedule(value: str) -> str:
    """Return ``value`` if it names a known ring schedule, else raise
    ``ValueError`` (the registry wraps it as ``CommSpecError``)."""
    if value not in SCHEDULES:
        raise ValueError(
            f"unknown ring schedule {value!r}; valid: {'/'.join(SCHEDULES)}")
    return value


def ring_schedule(codec) -> str:
    """The validated ring schedule a codec requests (``schedule`` field;
    codecs without one — e.g. ``IdentityCodec`` — default to pipelined,
    which is moot since they never route through the ring)."""
    return validate_schedule(getattr(codec, "schedule", PIPELINED))


def _per_chunk(stage, n: int) -> list:
    """A stage as one callable per chunk: a single callable is shared by
    every chunk; a sequence gives chunk ``c`` its own at index ``c`` (the
    negotiated ring's per-chunk wire widths).  The schedules consume
    chunks FIFO per stage, so chunk ``c``'s buffer always meets chunk
    ``c``'s callable."""
    if callable(stage):
        return [stage] * n
    fns = list(stage)
    if len(fns) != n:
        raise ValueError(
            f"per-chunk stage needs exactly {n} callables, got {len(fns)}")
    return fns


def _serial(segs, encode, transfer, decode):
    """Hoisted stage ordering: all encodes, then all transfers (each waited
    on before the next is issued), then all decodes."""
    wires = [encode[c](seg) for c, seg in enumerate(segs)]
    moved = [_settled(transfer[c](wire)) for c, wire in enumerate(wires)]
    return [decode[c](m) for c, m in enumerate(moved)]


def _settled(moved):
    """A transfer's ``(arrivals, works)`` with every work waited on."""
    arrivals, works = moved
    for w in works:
        w.wait()
    return arrivals, ()


def _pipelined(segs, encode, transfer, decode):
    """Double-buffered 3-stage software pipeline over ticks; see the
    module docstring for the schedule diagram and the emission order
    inside a tick.  Each stage queue holds at most one buffer in flight
    and outputs are appended in chunk order (FIFO)."""
    pending = list(segs)            # raw chunks awaiting encode
    enc: list = []                  # encoded wires awaiting transfer
    tx: list = []                   # transfers in flight, awaiting decode
    outs: list = []                 # decoded chunks, in chunk order
    e_i = t_i = d_i = 0             # next chunk index per stage (FIFO)
    for _ in range(len(segs) + 2):  # prologue + steady state + epilogue
        # pop every stage's input BEFORE pushing results: a buffer
        # produced in tick t enters its next stage no earlier than t+1
        e_in = pending.pop(0) if pending else None
        t_in = enc.pop(0) if enc else None
        d_in = tx.pop(0) if tx else None
        if t_in is not None:
            tx.append(transfer[t_i](t_in))
            t_i += 1
        if e_in is not None:
            enc.append(encode[e_i](e_in))
            e_i += 1
        if d_in is not None:
            outs.append(decode[d_i](_settled(d_in)))
            d_i += 1
    return outs


def run_ring(segs, *, encode, transfer, decode, schedule=PIPELINED):
    """Run the 3-stage ring chain over chunk ``segs`` under ``schedule``.

    ``encode(seg)`` -> wire buffer; ``transfer(wire)`` -> ``(arrivals,
    works)``: the buffers that will hold what the peers sent, and the
    async work handles that fill them; ``decode((arrivals, ()))`` -> the
    output chunk, called only after every work of its transfer was waited
    on.  Each stage is one callable shared by every chunk or a sequence
    of one callable per chunk (:func:`_per_chunk`).  Returns the decoded
    chunks in input order.  The stage functions must be per-chunk
    independent (no chunk's stage may read another chunk's buffers) —
    the schedules reorder emission under exactly that contract, which is
    what keeps ``pipelined`` and ``serial`` bit-identical."""
    validate_schedule(schedule)
    if not segs:
        return []
    encode = _per_chunk(encode, len(segs))
    transfer = _per_chunk(transfer, len(segs))
    decode = _per_chunk(decode, len(segs))
    if schedule == SERIAL or len(segs) == 1:
        # one chunk has nothing to pipeline with
        return _serial(segs, encode, transfer, decode)
    return _pipelined(segs, encode, transfer, decode)
