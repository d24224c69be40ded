"""Codec registry + the declarative compression-plan spec grammar.

The port parses the JAX package's grammar and emits the same normalized
strings (``from_spec`` / ``to_spec``) for the codecs it has ported::

    spec   := alias | item ("," item)*
    item   := path "=" codec | knob "=" int
    path   := "tp" | "tp_fwd" | "tp_bwd" | "grad_rs" | "weight_ag" | "pp"
            | "sp"
    knob   := "skip_first" | "skip_last" | "warmup"
    codec  := name (":" arg)*

Ported codecs: ``none``, ``taco``, ``sdp4bit``, ``tahquant`` and
``int8``.  ``taco`` takes e4m3|e5m2|int8, b<N>, g<N>, dual|folded,
ash|hadamard|notransform, blockscale|tensorscale, auto, cd<dtype>, tau<f>,
eps<f>, seps<f>, disabled, chunks=<N> and schedule=pipelined|serial.
``sdp4bit`` takes b<N>, norot, chunks=<N> and schedule=pipelined|serial.
``tahquant`` and ``int8`` take g<N>, chunks=<N> and
schedule=pipelined|serial.  Aliases: ``baseline``, ``identity``, ``taco``,
``taco_folded``, ``taco3d``.

What the port does not have yet is rejected with a :class:`CommSpecError`
that says so: ``+stage`` lossless stacks and the ``escalate=`` /
``hold=`` policy tokens.  The implementation tokens ``jnp``, ``pallas``
and ``pallas_interpret`` name TPU implementations and are rejected: the
port chooses the CUDA kernel or the plain version by the tensor's device.
"""
from __future__ import annotations

from repro_torch.core.codecs import (PIPELINED, SCHEDULES, IdentityCodec,
                                     Int8Codec, Sdp4BitCodec,
                                     TahQuantCodec, TacoCodec)
from repro_torch.core.parallel import PATHS, CommPlan
from repro_torch.core.taco import TacoConfig

__all__ = ["CommSpecError", "codec_from_spec", "codec_to_spec", "from_spec",
           "to_spec", "list_codecs"]

_TPU_IMPLS = ("jnp", "pallas", "pallas_interpret")


class CommSpecError(ValueError):
    """Malformed, unknown or not yet ported compression spec."""


def _not_ported(what: str) -> CommSpecError:
    return CommSpecError(f"{what} is not ported yet to the PyTorch package")


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
        elif tok.startswith(("escalate=", "hold=")):
            raise _not_ported(f"the error-escalation policy ({tok!r})")
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
    return tuple(out)


def _parse_sdp4bit(args):
    kw = {}
    for tok in args:
        if tok.startswith("chunks="):
            kw["chunks"] = _chunks_val(tok)
        elif tok.startswith("schedule="):
            kw["schedule"] = _schedule_val(tok)
        elif tok.startswith(("escalate=", "hold=")):
            raise _not_ported(f"the error-escalation policy ({tok!r})")
        elif tok.startswith("b") and tok[1:].isdigit():
            kw["block"] = _pos_int(tok, "b")
        elif tok == "norot":
            kw["rotate"] = False
        else:
            raise CommSpecError(f"unknown sdp4bit arg {tok!r}")
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
    return tuple(out)


def _group_codec(cls, name):
    """(parse, unparse) of a per-group int8 codec: g<N>, chunks=<N>,
    schedule=."""
    def parse(args):
        kw = {}
        for tok in args:
            if tok.startswith("chunks="):
                kw["chunks"] = _chunks_val(tok)
            elif tok.startswith("schedule="):
                kw["schedule"] = _schedule_val(tok)
            elif tok.startswith(("escalate=", "hold=")):
                raise _not_ported(f"the error-escalation policy ({tok!r})")
            elif tok.startswith("g") and tok[1:].isdigit():
                kw["group"] = _pos_int(tok, "g")
            else:
                raise CommSpecError(f"unknown {name} arg {tok!r}")
        return cls(**kw)

    def unparse(codec):
        out = []
        if codec.group != cls().group:
            out.append(f"g{codec.group}")
        if codec.chunks != 1:
            out.append(f"chunks={codec.chunks}")
        if codec.schedule != PIPELINED:
            out.append(f"schedule={codec.schedule}")
        return tuple(out)

    return cls, parse, unparse


_CODECS = {"none": (IdentityCodec, _parse_identity, lambda c: ()),
           "taco": (TacoCodec, _parse_taco, _unparse_taco),
           "sdp4bit": (Sdp4BitCodec, _parse_sdp4bit, _unparse_sdp4bit),
           "tahquant": _group_codec(TahQuantCodec, "tahquant"),
           "int8": _group_codec(Int8Codec, "int8")}
_ALIASES = {"identity": "baseline", "baseline": "", "taco": "tp=taco",
            "taco_folded": "tp=taco:folded",
            "taco3d": "tp=taco,grad_rs=sdp4bit,pp=tahquant"}


def list_codecs() -> list[str]:
    return sorted(_CODECS)


def codec_from_spec(spec: str):
    """``"taco:e4m3:folded"`` -> codec instance."""
    parts = spec.strip().split(":")
    head, args = parts[0], tuple(parts[1:])
    name, *stages = head.split("+")
    if stages:
        raise _not_ported(f"the lossless stage stack {head!r}")
    if name not in _CODECS:
        raise CommSpecError(
            f"unknown codec {name!r}; registered: {list_codecs()}")
    try:
        return _CODECS[name][1](args)
    except CommSpecError:
        raise
    except ValueError as e:
        raise CommSpecError(f"bad args for codec {name!r}: {spec!r} ({e})") \
            from e


def codec_to_spec(codec) -> str:
    """Codec instance -> normalized spec string."""
    for name, (cls, _, unparse) in _CODECS.items():
        if type(codec) is cls:
            return ":".join((name,) + tuple(unparse(codec)))
    raise CommSpecError(f"codec class {type(codec).__name__} is not "
                        "registered")


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

