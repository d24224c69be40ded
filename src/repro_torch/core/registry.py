"""Codec registry + the declarative compression-plan spec grammar.

The port parses the JAX package's grammar and emits the same normalized
strings (``from_spec`` / ``to_spec``) for the codecs it has ported::

    spec   := alias | item ("," item)*
    item   := path "=" codec | knob "=" int
    path   := "tp" | "tp_fwd" | "tp_bwd" | "grad_rs" | "weight_ag" | "pp"
            | "sp"
    knob   := "skip_first" | "skip_last" | "warmup"
    codec  := base ("+" stage)* (":" arg)*

Codecs: ``none``, ``taco``, ``sdp4bit``, ``tahquant`` and ``int8``.
``taco`` takes e4m3|e5m2|int8, b<N>, g<N>, dual|folded,
ash|hadamard|notransform, blockscale|tensorscale, auto, cd<dtype>, tau<f>,
eps<f>, seps<f>, disabled, chunks=<N> and schedule=pipelined|serial.
``sdp4bit`` takes b<N>, norot, chunks=<N> and schedule=pipelined|serial.
``tahquant`` and ``int8`` take g<N>, chunks=<N> and
schedule=pipelined|serial.  Every one of these four takes
``escalate=<fallback>@<thr>`` and ``hold=<N>`` (error-driven escalation,
``core/policy.py``; ``hold=`` without ``escalate=`` is rejected).
Aliases: ``baseline``, ``identity``, ``taco``, ``taco_folded``, ``taco3d``.

A ``+stage`` suffix on the codec head stacks a lossless wire stage over
the base codec (``tp=taco+zle:folded:chunks=4``).  Colon args are routed
by prefix: a stage claims its ``key=`` prefixes (``zle``: ``g=``,
``slot=``, ``headroom=``), everything else goes to the base codec — so
``taco+zle:escalate=bf16@0.08:slot=auto`` parses ``escalate=`` into taco
and ``slot=auto`` into zle.  A stage needs a codec with a wire layout
(``none+zle`` is rejected).  Escalation fallbacks: ``bf16`` (the identity
codec), ``int8`` and ``tahquant`` (:func:`register_fallback`).

The implementation tokens ``jnp``, ``pallas`` and ``pallas_interpret``
name TPU implementations and are rejected: the port chooses the CUDA
kernel or the plain version by the tensor's device.

The registry is open, as the JAX package's: :func:`register_codec` adds
a codec head (its class, ``parse`` and ``unparse``), :func:`register_alias`
a whole-spec alias, :func:`register_stage` a lossless stage and
:func:`register_fallback` an escalation fallback.  The built-in codecs and
aliases are registered through the same calls.  A registered codec needs
no other wiring: the transport, the rings, the policy layer and the
telemetry call the codec's own methods (the :class:`Codec` protocol), so
one registration makes it usable on every path, from both launchers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, runtime_checkable

from repro_torch.core.codecs import (DEFAULT_HOLD, PIPELINED, SCHEDULES,
                                     IdentityCodec, Int8Codec, Sdp4BitCodec,
                                     TahQuantCodec, TacoCodec)
from repro_torch.core.lossless import ZleCodec
from repro_torch.core.parallel import PATHS, CommPlan
from repro_torch.core.taco import TacoConfig

__all__ = [
    "Codec", "CodecEntry", "CommSpecError", "register_codec", "get_codec",
    "list_codecs", "register_stage", "list_stages",
    "codec_from_spec", "codec_to_spec", "from_spec", "to_spec",
    "register_alias", "list_aliases",
    "register_fallback", "list_fallbacks", "fallback_codec",
]

_TPU_IMPLS = ("jnp", "pallas", "pallas_interpret")


class CommSpecError(ValueError):
    """Malformed or unknown compression spec."""


@runtime_checkable
class Codec(Protocol):
    """The wire-codec protocol every registered codec implements.

    ``encode`` maps a 2-D ``(slots, n)`` tensor (``n`` a multiple of
    ``granule``) to a tuple of wire tensors; ``decode`` inverts it, and
    ``decode_sum`` sums a stacked peer axis (the reduce-scatter's
    receiver).  ``wire_layout(n)`` publishes the per-slot byte layout of
    ``encode``'s output (a ``codecs.WireLayout``), so the transport moves
    every component as one packed uint8 buffer; None for a codec that
    moves the raw tensor (then ``chunks=`` is refused).

    ``encode_wire`` / ``decode_wire`` / ``decode_sum_wire`` are the
    wire-native paths the transport calls: they write and read the packed
    buffer and must equal ``pack_wire(encode(x), wire_layout(n))`` (and
    the decodes of ``unpack_wire``) bit for bit — inherit
    ``codecs.WireFastPath`` for those compositions, or route to kernels,
    as ``TacoCodec`` does."""

    @property
    def granule(self) -> int: ...

    def wire_layout(self, n): ...

    def encode(self, x): ...

    def decode(self, enc, n, dtype): ...

    def decode_sum(self, enc, n, dtype): ...

    def encode_wire(self, x): ...

    def decode_wire(self, wire, n, dtype): ...

    def decode_sum_wire(self, wire, n, dtype): ...

    def bytes_per_element(self, in_dtype=None) -> float: ...


# --------------------------------------------------------------------------
# registry core
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CodecEntry:
    name: str
    cls: type
    parse: Callable        # (args: tuple[str, ...]) -> codec instance
    unparse: Callable      # (codec) -> tuple[str, ...] of normalized args


_CODECS: dict[str, CodecEntry] = {}
_CODEC_NAME_BY_CLS: dict[type, str] = {}
_ALIASES: dict[str, str] = {}


def register_codec(name: str, cls: type, parse: Callable,
                   unparse: Callable) -> None:
    """Register a wire codec under ``name``.  ``parse(args)`` builds an
    instance from the colon-separated spec args; ``unparse(codec)`` emits
    its normalized (non-default, fixed-order) args, so that
    ``parse(unparse(c)) == c`` for every instance of ``cls``."""
    if name in _CODECS:
        raise ValueError(f"codec {name!r} already registered")
    _CODECS[name] = CodecEntry(name, cls, parse, unparse)
    _CODEC_NAME_BY_CLS.setdefault(cls, name)


def get_codec(name: str) -> CodecEntry:
    """The :class:`CodecEntry` registered as ``name`` (``CommSpecError``
    naming the registered set when there is none)."""
    try:
        return _CODECS[name]
    except KeyError:
        raise CommSpecError(
            f"unknown codec {name!r}; registered: {sorted(_CODECS)}") from None


def list_codecs() -> list[str]:
    """Sorted names of every registered codec (the codec heads of the
    grammar)."""
    return sorted(_CODECS)


def register_alias(name: str, spec: str) -> None:
    """Register a whole-spec alias (e.g. ``taco3d``)."""
    _ALIASES[name] = spec


def list_aliases() -> dict[str, str]:
    """Copy of the alias table (alias -> the spec it expands to)."""
    return dict(_ALIASES)


# --------------------------------------------------------------------------
# codecs
# --------------------------------------------------------------------------

_TACO_FMT = ("e4m3", "e5m2", "int8")
_TACO_TRANSFORM = {"ash": "ash", "hadamard": "hadamard",
                   "notransform": "none"}
_TACO_SCALE = {"blockscale": "block", "tensorscale": "tensor"}
_TACO_META = ("dual", "folded")


def _pos_int(tok, prefix):
    n = int(tok[len(prefix):])
    if n <= 0:
        raise CommSpecError(f"arg {tok!r}: size must be >= 1")
    return n


def _chunks_val(tok):
    try:
        n = int(tok[len("chunks="):])
    except ValueError:
        raise CommSpecError(
            f"arg {tok!r}: chunks needs an integer >= 1") from None
    if n < 1:
        raise CommSpecError(f"arg {tok!r}: chunks must be >= 1, got {n}")
    return n


def _schedule_val(tok):
    val = tok[len("schedule="):]
    if val not in SCHEDULES:
        raise CommSpecError(
            f"arg {tok!r}: schedule must be one of {'/'.join(SCHEDULES)}")
    return val


def _escalate_val(tok):
    """``escalate=<fallback>@<thr>`` -> ``(fallback_name, threshold)``."""
    val = tok[len("escalate="):]
    name, sep, thr = val.partition("@")
    if not sep or not name or not thr:
        raise CommSpecError(
            f"arg {tok!r}: escalate needs <fallback>@<threshold> "
            "(e.g. escalate=bf16@0.08)")
    if name not in _FALLBACKS:
        raise CommSpecError(
            f"arg {tok!r}: unknown escalation fallback {name!r}; "
            f"registered: {sorted(_FALLBACKS)}")
    try:
        t = float(thr)
    except ValueError:
        raise CommSpecError(
            f"arg {tok!r}: escalation threshold must be a float") from None
    if not t > 0.0:
        raise CommSpecError(
            f"arg {tok!r}: escalation threshold must be > 0, got {t}")
    return (name, t)


def _hold_val(tok):
    """``hold=<N>`` -> N (>= 1)."""
    try:
        n = int(tok[len("hold="):])
    except ValueError:
        raise CommSpecError(
            f"arg {tok!r}: hold needs an integer >= 1") from None
    if n < 1:
        raise CommSpecError(f"arg {tok!r}: hold must be >= 1, got {n}")
    return n


def _check_hold_has_escalate(kw, name):
    """``hold=`` without ``escalate=`` would be silently inert."""
    if "hold" in kw and "escalate" not in kw:
        raise CommSpecError(
            f"codec {name!r}: 'hold=' requires an 'escalate=' token")


def _escalation_args(codec) -> list:
    """Normalised escalate / hold args, the tail of every lossy codec's
    unparse."""
    out = []
    if codec.escalate is not None:
        name, thr = codec.escalate
        out.append(f"escalate={name}@{thr!r}")
        if codec.hold != DEFAULT_HOLD:
            out.append(f"hold={codec.hold}")
    return out


def _parse_identity(args):
    if args:
        raise CommSpecError(f"codec 'none' takes no args, got {args}")
    return IdentityCodec()


def _parse_taco(args):
    kw, codec_kw = {}, {}

    def put(key, val, tok, into=None):
        d = kw if into is None else into
        if key in d:
            raise CommSpecError(f"duplicate taco arg {tok!r}")
        d[key] = val

    for tok in args:
        if tok.startswith("chunks="):
            put("chunks", _chunks_val(tok), tok, into=codec_kw)
        elif tok.startswith("schedule="):
            put("schedule", _schedule_val(tok), tok, into=codec_kw)
        elif tok.startswith("escalate="):
            put("escalate", _escalate_val(tok), tok, into=codec_kw)
        elif tok.startswith("hold="):
            put("hold", _hold_val(tok), tok, into=codec_kw)
        elif tok in _TACO_FMT:
            put("fmt", tok, tok)
        elif tok in _TACO_META:
            put("metadata", tok, tok)
        elif tok in _TACO_TRANSFORM:
            put("transform", _TACO_TRANSFORM[tok], tok)
        elif tok in _TACO_SCALE:
            put("scale_granularity", _TACO_SCALE[tok], tok)
        elif tok == "auto":
            put("impl", tok, tok)
        elif tok in _TPU_IMPLS:
            raise CommSpecError(
                f"taco arg {tok!r} names a TPU implementation; the PyTorch "
                "package picks the CUDA kernel or the plain version by the "
                "tensor's device (use 'auto' or nothing)")
        elif tok.startswith("b") and tok[1:].isdigit():
            put("block_size", _pos_int(tok, "b"), tok)
        elif tok.startswith("g") and tok[1:].isdigit():
            put("quant_group_size", _pos_int(tok, "g"), tok)
        elif tok.startswith("cd"):
            put("compute_dtype", tok[2:], tok)
        elif tok.startswith("tau"):
            put("tau", float(tok[3:]), tok)
        elif tok.startswith("seps"):
            put("scale_eps", float(tok[4:]), tok)
        elif tok.startswith("eps"):
            put("eps", float(tok[3:]), tok)
        elif tok == "disabled":
            put("enabled", False, tok)
        else:
            raise CommSpecError(f"unknown taco arg {tok!r}")
    _check_hold_has_escalate(codec_kw, "taco")
    return TacoCodec(TacoConfig(**kw), **codec_kw)


def _unparse_taco(codec):
    cfg, ref = codec.cfg, TacoConfig()
    out = []
    if not cfg.enabled:
        out.append("disabled")
    if cfg.fmt != ref.fmt:
        out.append(cfg.fmt)
    if cfg.block_size != ref.block_size:
        out.append(f"b{cfg.block_size}")
    if cfg.quant_group_size != ref.quant_group_size:
        out.append(f"g{cfg.quant_group_size}")
    if cfg.metadata != ref.metadata:
        out.append(cfg.metadata)
    if cfg.transform != ref.transform:
        out.append({v: k for k, v in _TACO_TRANSFORM.items()}[cfg.transform])
    if cfg.scale_granularity != ref.scale_granularity:
        out.append({v: k for k, v in _TACO_SCALE.items()}
                   [cfg.scale_granularity])
    if cfg.compute_dtype != ref.compute_dtype:
        out.append(f"cd{cfg.compute_dtype}")
    if cfg.tau != ref.tau:
        out.append(f"tau{cfg.tau!r}")
    if cfg.eps != ref.eps:
        out.append(f"eps{cfg.eps!r}")
    if cfg.scale_eps != ref.scale_eps:
        out.append(f"seps{cfg.scale_eps!r}")
    if codec.chunks != 1:
        out.append(f"chunks={codec.chunks}")
    if codec.schedule != PIPELINED:
        out.append(f"schedule={codec.schedule}")
    out += _escalation_args(codec)
    return tuple(out)


def _parse_sdp4bit(args):
    kw = {}
    for tok in args:
        if tok.startswith("chunks="):
            kw["chunks"] = _chunks_val(tok)
        elif tok.startswith("schedule="):
            kw["schedule"] = _schedule_val(tok)
        elif tok.startswith("escalate="):
            kw["escalate"] = _escalate_val(tok)
        elif tok.startswith("hold="):
            kw["hold"] = _hold_val(tok)
        elif tok.startswith("b") and tok[1:].isdigit():
            kw["block"] = _pos_int(tok, "b")
        elif tok == "norot":
            kw["rotate"] = False
        else:
            raise CommSpecError(f"unknown sdp4bit arg {tok!r}")
    _check_hold_has_escalate(kw, "sdp4bit")
    return Sdp4BitCodec(**kw)


def _unparse_sdp4bit(codec):
    out = []
    if codec.block != Sdp4BitCodec().block:
        out.append(f"b{codec.block}")
    if not codec.rotate:
        out.append("norot")
    if codec.chunks != 1:
        out.append(f"chunks={codec.chunks}")
    if codec.schedule != PIPELINED:
        out.append(f"schedule={codec.schedule}")
    out += _escalation_args(codec)
    return tuple(out)


def _group_codec(cls, name):
    """(parse, unparse) of a per-group int8 codec: g<N>, chunks=<N>,
    schedule=, escalate=, hold=."""
    def parse(args):
        kw = {}
        for tok in args:
            if tok.startswith("chunks="):
                kw["chunks"] = _chunks_val(tok)
            elif tok.startswith("schedule="):
                kw["schedule"] = _schedule_val(tok)
            elif tok.startswith("escalate="):
                kw["escalate"] = _escalate_val(tok)
            elif tok.startswith("hold="):
                kw["hold"] = _hold_val(tok)
            elif tok.startswith("g") and tok[1:].isdigit():
                kw["group"] = _pos_int(tok, "g")
            else:
                raise CommSpecError(f"unknown {name} arg {tok!r}")
        _check_hold_has_escalate(kw, name)
        return cls(**kw)

    def unparse(codec):
        out = []
        if codec.group != cls().group:
            out.append(f"g{codec.group}")
        if codec.chunks != 1:
            out.append(f"chunks={codec.chunks}")
        if codec.schedule != PIPELINED:
            out.append(f"schedule={codec.schedule}")
        out += _escalation_args(codec)
        return tuple(out)

    return parse, unparse


register_codec("none", IdentityCodec, _parse_identity, lambda c: ())
register_codec("taco", TacoCodec, _parse_taco, _unparse_taco)
register_codec("sdp4bit", Sdp4BitCodec, _parse_sdp4bit, _unparse_sdp4bit)
register_codec("tahquant", TahQuantCodec,
               *_group_codec(TahQuantCodec, "tahquant"))
register_codec("int8", Int8Codec, *_group_codec(Int8Codec, "int8"))

register_alias("identity", "baseline")
register_alias("baseline", "")                  # identity everywhere
register_alias("taco", "tp=taco")
register_alias("taco_folded", "tp=taco:folded")
register_alias("taco3d", "tp=taco,grad_rs=sdp4bit,pp=tahquant")


# --------------------------------------------------------------------------
# lossless stages
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageEntry:
    name: str
    cls: type
    wrap: Callable          # (inner codec, *stage args) -> stacked codec
    unparse: Callable | None = None   # (codec) -> normalised stage args
    args: tuple = ()        # "key=" prefixes of the args the stage claims


_STAGES: dict[str, StageEntry] = {}
_STAGE_NAME_BY_CLS: dict[type, str] = {}


def register_stage(name: str, cls: type, wrap: Callable, *,
                   unparse: Callable | None = None,
                   args: tuple = ()) -> None:
    """Register a lossless wire stage usable as a ``+name`` head suffix:
    ``wrap(inner, *stage_args)`` stacks it over a codec with a wire
    layout, ``args`` are the ``key=`` prefixes it claims out of the codec
    spec, ``unparse(codec)`` its normalised non-default args."""
    if name in _STAGES:
        raise ValueError(f"stage {name!r} already registered")
    if name in _CODECS:
        raise ValueError(f"stage {name!r} collides with a codec name")
    _STAGES[name] = StageEntry(name, cls, wrap, unparse, tuple(args))
    _STAGE_NAME_BY_CLS.setdefault(cls, name)


def list_stages() -> list[str]:
    """Sorted names of every registered lossless stage."""
    return sorted(_STAGES)


def _stage_entry(name: str, spec: str) -> StageEntry:
    try:
        return _STAGES[name]
    except KeyError:
        raise CommSpecError(
            f"unknown stage {name!r} in {spec!r}; "
            f"registered stages: {sorted(_STAGES)}") from None


def _apply_stage(entry: StageEntry, codec, stage_args: tuple, spec: str):
    wl = getattr(codec, "wire_layout", None)
    if wl is None or wl(codec.granule) is None:
        raise CommSpecError(
            f"stage {entry.name!r} in {spec!r} requires a codec with a "
            "wire layout to stack over (lossless stages transform the "
            "packed wire buffer)")
    try:
        return entry.wrap(codec, *stage_args)
    except CommSpecError:
        raise
    except Exception as e:  # noqa: BLE001 — surface as a spec error
        raise CommSpecError(
            f"bad args for stage {entry.name!r}: {spec!r} ({e})") from e


def _wrap_zle(inner, *args):
    kw = {}
    for tok in args:
        if tok.startswith("g="):
            key, val = "group", _pos_int(tok, "g=")
        elif tok.startswith("slot="):
            key, val = "slot", tok[len("slot="):]
        elif tok.startswith("headroom="):
            key, val = "headroom", float(tok[len("headroom="):])
        else:  # unreachable while routing matches the claimed prefixes
            raise CommSpecError(f"unknown zle arg {tok!r}")
        if key in kw:
            raise CommSpecError(f"duplicate zle arg {tok!r}")
        kw[key] = val
    return ZleCodec(inner, **kw)


def _unparse_zle(codec):
    ref = ZleCodec(codec.inner)
    out = []
    if codec.group != ref.group:
        out.append(f"g={codec.group}")
    if codec.slot != ref.slot:
        out.append(f"slot={codec.slot}")
    if codec.headroom != ref.headroom:
        out.append(f"headroom={codec.headroom!r}")
    # moved_frac is controller-negotiated state, never spec text
    return tuple(out)


register_stage("zle", ZleCodec, _wrap_zle, unparse=_unparse_zle,
               args=("g=", "slot=", "headroom="))


# --------------------------------------------------------------------------
# escalation fallbacks
# --------------------------------------------------------------------------

_FALLBACKS: dict[str, str] = {}


def register_fallback(name: str, spec: str) -> None:
    """Register an escalation fallback: ``escalate=<name>@<thr>`` swaps
    the escalated path to ``codec_from_spec(spec)``.  The fallback must
    parse and carry no ``escalate=`` of its own (it emits no probes, so a
    chained escalation could never fire)."""
    codec = codec_from_spec(spec)
    if getattr(codec, "escalate", None) is not None:
        raise CommSpecError(
            f"fallback {name!r} -> {spec!r} carries its own 'escalate=' "
            "token; escalation fallbacks must be terminal")
    _FALLBACKS[name] = spec


def list_fallbacks() -> dict[str, str]:
    """Copy of the escalation-fallback table (name -> codec spec)."""
    return dict(_FALLBACKS)


def fallback_codec(name: str):
    """The codec registered as escalation fallback ``name``."""
    try:
        return codec_from_spec(_FALLBACKS[name])
    except KeyError:
        raise CommSpecError(
            f"unknown escalation fallback {name!r}; "
            f"registered: {sorted(_FALLBACKS)}") from None


# --------------------------------------------------------------------------
# codec specs
# --------------------------------------------------------------------------

def codec_from_spec(spec: str):
    """``"taco:e4m3:folded"`` / ``"taco+zle:folded:slot=auto"`` -> codec.
    The head splits on ``+`` into the base codec and its stages; an arg a
    stage claims goes to that stage, the rest to the base codec; the
    stages wrap the base codec left to right."""
    parts = spec.strip().split(":")
    head, args = parts[0], tuple(parts[1:])
    name, *stages = head.split("+")
    entry = get_codec(name)
    sentries = [_stage_entry(s, spec) for s in stages]
    base_args, stage_args = [], {s: [] for s in stages}
    for tok in args:
        owner = next((se.name for se in sentries
                      if any(tok.startswith(p) for p in se.args)), None)
        (stage_args[owner] if owner else base_args).append(tok)
    try:
        codec = entry.parse(tuple(base_args))
    except CommSpecError:
        raise
    except Exception as e:  # noqa: BLE001 — surface as a spec error
        raise CommSpecError(f"bad args for codec {name!r}: {spec!r} ({e})") \
            from e
    wl = getattr(codec, "wire_layout", None)
    if getattr(codec, "chunks", 1) > 1 and \
            (wl is None or wl(codec.granule) is None):
        raise CommSpecError(
            f"codec {name!r} has no wire layout; 'chunks=' requires one "
            "(the ring slices the packed wire buffer)")
    for se in sentries:
        codec = _apply_stage(se, codec, tuple(stage_args[se.name]), spec)
    return codec


def codec_to_spec(codec) -> str:
    """Codec instance -> normalised spec string.  A stacked stage adds
    ``+stage`` to the inner codec's head and its args after the inner
    codec's; a negotiated ``moved_frac`` is not written."""
    stage = _STAGE_NAME_BY_CLS.get(type(codec))
    if stage is not None:
        inner = codec_to_spec(codec.inner)
        head, sep, rest = inner.partition(":")
        entry = _STAGES[stage]
        extra = tuple(entry.unparse(codec)) if entry.unparse else ()
        out = f"{head}+{stage}{sep}{rest}"
        return ":".join((out,) + extra) if extra else out
    name = _CODEC_NAME_BY_CLS.get(type(codec))
    if name is None:
        raise CommSpecError(f"codec class {type(codec).__name__} is not "
                            "registered")
    return ":".join((name,) + tuple(_CODECS[name].unparse(codec)))


# the precision ladder an escalated path climbs ("bf16": the identity
# baseline), registered after the codecs they parse through
register_fallback("bf16", "none")
register_fallback("int8", "int8")
register_fallback("tahquant", "tahquant")


_KNOBS = {"skip_first": "skip_first", "skip_last": "skip_last",
          "warmup": "warmup_steps"}


def from_spec(spec: str) -> CommPlan:
    """Parse a spec string (or alias) into a frozen :class:`CommPlan`."""
    if not isinstance(spec, str):
        raise CommSpecError(f"spec must be a string, got {type(spec)}")
    s = spec.strip()
    seen = set()
    while s in _ALIASES:
        if s in seen:
            raise CommSpecError(f"alias cycle at {s!r}")
        seen.add(s)
        s = _ALIASES[s]
    kwargs: dict = {}
    for item in filter(None, (p.strip() for p in s.split(","))):
        if "=" not in item:
            raise CommSpecError(
                f"bad spec item {item!r} (expected path=codec or knob=int)")
        key, _, val = item.partition("=")
        key, val = key.strip(), val.strip()
        if key == "tp":
            codec = codec_from_spec(val)
            for k in ("tp_fwd", "tp_bwd"):
                if k in kwargs:
                    raise CommSpecError(f"'tp=' conflicts with '{k}='")
                kwargs[k] = codec
        elif key in PATHS:
            if key in kwargs:
                raise CommSpecError(f"duplicate path {key!r}")
            kwargs[key] = codec_from_spec(val)
        elif key in _KNOBS:
            field = _KNOBS[key]
            if field in kwargs:
                raise CommSpecError(f"duplicate knob {key!r}")
            try:
                n = int(val)
            except ValueError:
                raise CommSpecError(
                    f"knob {key!r} needs an integer, got {val!r}") from None
            if n < 0:
                raise CommSpecError(f"knob {key!r} must be >= 0, got {n}")
            kwargs[field] = n
        else:
            raise CommSpecError(
                f"unknown spec key {key!r}; paths: {sorted(PATHS)}, "
                f"knobs: {sorted(_KNOBS)}")
    return CommPlan(**kwargs)


def to_spec(plan: CommPlan) -> str:
    """Normalized spec string; ``from_spec(to_spec(p)) == p``."""
    parts = []
    identity = IdentityCodec()
    if plan.tp_fwd == plan.tp_bwd:
        if plan.tp_fwd != identity:
            parts.append(f"tp={codec_to_spec(plan.tp_fwd)}")
    else:
        parts.append(f"tp_fwd={codec_to_spec(plan.tp_fwd)}")
        parts.append(f"tp_bwd={codec_to_spec(plan.tp_bwd)}")
    for path in ("grad_rs", "weight_ag", "pp", "sp"):
        codec = getattr(plan, path)
        if codec != identity:
            parts.append(f"{path}={codec_to_spec(codec)}")
    for knob, field in _KNOBS.items():
        v = getattr(plan, field)
        if v:
            parts.append(f"{knob}={v}")
    return ",".join(parts) if parts else "baseline"

