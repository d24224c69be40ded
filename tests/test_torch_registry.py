"""The port's spec grammar: the ``none``, ``taco``, ``sdp4bit``,
``tahquant`` and ``int8`` codecs, the ``+zle`` lossless stage, the
``escalate=`` / ``hold=`` policy tokens and the aliases round-trip to the
same normalized strings as the JAX registry; the TPU implementation
tokens are rejected with a clear error.  The extension API
(``register_codec``, ``get_codec``, ``register_alias``, ``list_aliases``):
a codec registered in both packages round-trips to the same string and
runs every path as the codec it delegates to."""
import dataclasses

import pytest
import torch

from repro.core import registry as jreg
from repro_torch.core import collectives as cc
from repro_torch.core import registry as reg
from repro_torch.core.parallel import CommPlan, ParallelCtx
from test_torch_dist import one_thread  # noqa: F401  (autouse)

#: specs the port refused before its lossless tier and policy layer
LOSSLESS_AND_POLICY = [
    "grad_rs=sdp4bit:escalate=bf16@0.08",
    "grad_rs=sdp4bit:escalate=int8@0.1:hold=5",
    "pp=tahquant:escalate=bf16@0.1", "weight_ag=int8:escalate=int8@0.05:hold=3",
    "pp=tahquant+zle", "tp=taco+zle", "tp=taco+zle:slot=auto",
    "tp=taco:escalate=bf16@0.08", "tp=taco:escalate=int8@0.1:hold=5"]

SUPPORTED = [
    "baseline", "identity", "taco", "taco_folded", "", "tp=none",
    "tp=taco", "tp=taco:e4m3:b256:folded", "tp=taco:e5m2:g64",
    "tp=taco:int8:dual:ash:blockscale", "tp=taco:hadamard:tensorscale",
    "tp=taco:notransform", "tp=taco:auto", "tp=taco:cdbfloat16",
    "tp=taco:tau2.0:eps1e-10:seps1e-20", "tp=taco:disabled",
    "tp=taco:chunks=4", "tp=taco:folded:chunks=2:schedule=serial",
    "tp_fwd=taco,tp_bwd=taco:folded", "tp_fwd=taco:int8",
    "tp=taco,skip_first=2,skip_last=1,warmup=100",
    "tp=taco,sp=taco:folded", "pp=taco,weight_ag=none",
    " tp = taco:folded , warmup=3 ",
    "tp=taco,grad_rs=sdp4bit", "grad_rs=sdp4bit:b64", "grad_rs=sdp4bit:norot",
    "tp=taco:folded:chunks=4,grad_rs=sdp4bit:chunks=4:schedule=serial",
    "weight_ag=sdp4bit:b256:norot,grad_rs=sdp4bit", "tp=sdp4bit",
    "tp=taco,grad_rs=sdp4bit,skip_first=2,warmup=100",
    "pp=tahquant", "pp=tahquant:g32", "weight_ag=int8",
    "weight_ag=int8:g64:chunks=2", "pp=tahquant,weight_ag=int8", "taco3d",
    "pp=int8:chunks=3:schedule=serial", "grad_rs=tahquant:g128",
    "tp=taco:folded:chunks=4,grad_rs=sdp4bit,pp=tahquant,weight_ag=int8",
    "tp=taco+zle:folded:chunks=4", "tp=taco+zle:escalate=bf16@0.08:slot=auto",
    "tp=taco+zle:slot=auto:escalate=bf16@0.08", "tp=taco+zle:g=32",
    "tp=taco+zle:g64", "tp=taco+zle:slot=auto:headroom=0.25:chunks=4",
    "tp=taco+zle:slot=static", "weight_ag=int8+zle:slot=auto",
    "grad_rs=sdp4bit+zle:g=8,pp=tahquant:g128:escalate=bf16@0.1",
] + LOSSLESS_AND_POLICY


@pytest.mark.parametrize("spec", SUPPORTED)
def test_round_trip_matches_jax(spec):
    plan = reg.from_spec(spec)
    out = reg.to_spec(plan)
    assert out == jreg.to_spec(jreg.from_spec(spec))
    assert reg.from_spec(out) == plan
    assert reg.to_spec(reg.from_spec(out)) == out


@pytest.mark.parametrize("spec", LOSSLESS_AND_POLICY)
def test_not_ported_yet_is_rejected(spec):
    """Named for what it held before the lossless tier and the policy
    layer were ported (these nine specs were refused): each now parses to
    the JAX package's normalized string, and one all-gather hop of its
    compressed path runs and equals the hop of its inner codec."""
    plan = reg.from_spec(spec)
    assert reg.to_spec(plan) == jreg.to_spec(jreg.from_spec(spec))
    path = next(p for p in ("tp_fwd", "grad_rs", "weight_ag", "pp")
                if getattr(plan, p) != cc.Identity)
    codec = getattr(plan, path)
    inner = getattr(codec, "inner", codec)
    x = torch.linspace(-1.0, 1.0, 4 * codec.granule).reshape(4, -1)
    assert torch.equal(cc.all_gather_c(x, None, 0, codec, codec),
                       cc.all_gather_c(x, None, 0, inner, inner))


@pytest.mark.parametrize("tok", ["jnp", "pallas", "pallas_interpret"])
def test_tpu_impl_tokens_rejected(tok):
    with pytest.raises(reg.CommSpecError, match="TPU implementation"):
        reg.from_spec(f"tp=taco:{tok}")


@pytest.mark.parametrize("spec", [
    "tp=foo", "tp=taco:b0", "tp=taco:bogus", "tp=taco:e4m3:e5m2",
    "tp=taco,tp_fwd=none", "nonsense", "tp=none:chunks=2",
    "warmup=-1", "skip_first=x", "tp=taco:tensorscale:g64",
    "tp=taco:schedule=fast", "tp=taco:chunks=0", "tp=taco:cdint7",
    "pp=tahquant:g0", "pp=tahquant:b64", "weight_ag=int8:norot",
    "pp=tahquant:chunks=0", "tp=none+zle", "tp=taco+zle:g=0",
    "tp=taco:slot=auto", "tp=taco:hold=5", "tp=taco:escalate=sdp4bit",
    "tp=taco:escalate=nosuch@0.1", "tp=taco+foo",
])
def test_malformed_specs_rejected(spec):
    with pytest.raises(reg.CommSpecError):
        reg.from_spec(spec)


def test_plan_spans_and_views():
    plan = reg.from_spec("tp=taco,skip_first=1,skip_last=1")
    spans = plan.layer_spans(0, 4, 4)
    assert [(n, p.tp_identity) for n, p in spans] == \
        [(1, True), (2, False), (1, True)]
    ctx = ParallelCtx(plan=plan)
    views = ctx.layer_views(0, 4, 4)
    assert [n for n, _ in views] == [1, 2, 1]
    assert views[1][1].plan is plan
    assert reg.from_spec("tp=taco,warmup=2").warmup_steps == 2
    assert CommPlan().tp_identity
    assert reg.from_spec("taco").wire_bytes_per_element()["tp_fwd"] == \
        jreg.from_spec("taco").wire_bytes_per_element()["tp_fwd"]


# --------------------------------------------------------------------------
# the extension API: register_codec, get_codec, register_alias
# --------------------------------------------------------------------------

def test_extension_tables_equal_the_references():
    """Codecs, aliases, stages and fallbacks: the JAX package's tables."""
    assert reg.list_codecs() == jreg.list_codecs()
    assert reg.list_aliases() == jreg.list_aliases()
    assert reg.list_stages() == jreg.list_stages()
    assert reg.list_fallbacks() == jreg.list_fallbacks()
    for name in reg.list_codecs():
        entry = reg.get_codec(name)
        assert isinstance(entry, reg.CodecEntry) and entry.name == name
        assert entry.cls.__name__ == jreg.get_codec(name).cls.__name__
        codec = reg.codec_from_spec(name)
        assert isinstance(codec, reg.Codec), name
        assert type(codec) is entry.cls
        assert codec.granule >= 1 and codec.bytes_per_element() > 0
    with pytest.raises(reg.CommSpecError, match="registered"):
        reg.get_codec("nosuch")
    with pytest.raises(ValueError, match="already registered"):
        e = reg.get_codec("taco")
        reg.register_codec("taco", e.cls, e.parse, e.unparse)


def _toy(codec_cls, taco_cls):
    """A codec that delegates every method to an inner taco codec: what a
    user registers through ``register_codec``."""
    @dataclasses.dataclass(frozen=True)
    class Toy:
        inner: taco_cls = taco_cls()

        @property
        def granule(self):
            return self.inner.granule

        @property
        def chunks(self):
            return self.inner.chunks

        def wire_layout(self, n):
            return self.inner.wire_layout(n)

        def encode(self, x):
            return self.inner.encode(x)

        def decode(self, enc, n, dtype):
            return self.inner.decode(enc, n, dtype)

        def decode_sum(self, enc, n, dtype):
            return self.inner.decode_sum(enc, n, dtype)

        def encode_wire(self, x):
            return self.inner.encode_wire(x)

        def decode_wire(self, wire, n, dtype):
            return self.inner.decode_wire(wire, n, dtype)

        def decode_sum_wire(self, wire, n, dtype):
            return self.inner.decode_sum_wire(wire, n, dtype)

        def bytes_per_element(self, in_dtype=None):
            return self.inner.bytes_per_element()
    Toy.__name__ = codec_cls
    return Toy


@pytest.fixture
def toy():
    """``toy`` (a codec delegating to taco) and the alias ``toy3d``
    registered in both packages, and taken out again: the registry is
    module state that other test files of this worker see."""
    from repro.core.codecs import TacoCodec as JTaco
    from repro_torch.core.codecs import TacoCodec as TTaco
    made = {}
    for r, taco_cls in ((reg, TTaco), (jreg, JTaco)):
        cls = _toy("ToyCodec", taco_cls)
        taco = r.get_codec("taco")
        r.register_codec(
            "toy", cls, lambda args, cls=cls, taco=taco: cls(taco.parse(args)),
            lambda c, taco=taco: taco.unparse(c.inner))
        r.register_alias("toy3d", "tp=toy,grad_rs=sdp4bit,pp=tahquant")
        made[r] = cls
    yield made[reg]
    for r, cls in made.items():
        r._CODECS.pop("toy", None)
        r._CODEC_NAME_BY_CLS.pop(cls, None)
        r._ALIASES.pop("toy3d", None)


TOY_SPECS = ["tp=toy", "tp=toy:folded:chunks=4", "tp=toy:int8:b128",
             "tp_fwd=toy:e5m2,tp_bwd=taco", "toy3d",
             "tp=toy,grad_rs=toy:folded,skip_first=1"]


@pytest.mark.parametrize("spec", TOY_SPECS)
def test_registered_codec_round_trips_as_in_the_reference(toy, spec):
    """One ``register_codec`` / ``register_alias`` and the codec parses
    and round-trips to the JAX package's string, with no other edit."""
    plan = reg.from_spec(spec)
    out = reg.to_spec(plan)
    assert out == jreg.to_spec(jreg.from_spec(spec))
    assert reg.from_spec(out) == plan
    assert "toy" in reg.list_codecs() and "toy3d" in reg.list_aliases()
    assert isinstance(plan.tp_fwd, reg.Codec)


@pytest.mark.parametrize("spec", ["toy", "toy:folded", "toy:folded:chunks=4",
                                  "toy:int8:b64"])
def test_registered_codec_runs_a_tp_hop_as_its_inner_codec(toy, spec):
    """``all_gather_c`` / ``psum_scatter_c`` / ``allreduce_g`` (the
    training and the decode hops) under the registered codec equal the
    hops under the taco codec it delegates to, bit for bit."""
    codec = reg.codec_from_spec(spec)
    inner = reg.codec_from_spec(spec.replace("toy", "taco"))
    assert isinstance(codec, toy) and codec.inner == inner
    x = torch.linspace(-1.0, 1.0, 8 * 256).reshape(8, -1).to(torch.bfloat16)
    assert torch.equal(cc.all_gather_c(x, None, 0, codec, codec),
                       cc.all_gather_c(x, None, 0, inner, inner))
    assert torch.equal(cc.psum_scatter_c(x, None, 0, codec, codec),
                       cc.psum_scatter_c(x, None, 0, inner, inner))
    assert torch.equal(cc.allreduce_g(x, None, codec, codec),
                       cc.allreduce_g(x, None, inner, inner))


def test_registered_codec_reaches_every_path(toy):
    """A smoke training step under ``tp=toy,grad_rs=toy`` equals the step
    under ``tp=taco,grad_rs=taco`` bit for bit (loss and every grad: the
    TP hops and the weight gathers' reduce-scatters), and greedy decode
    under ``tp=toy`` gives taco's logits: the transport, the trainer and
    the serve path call the codec's own methods."""
    from repro_torch.configs import get_config, make_plan, smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import OptConfig, leaves
    from repro_torch.serve import serve_step as ss
    from repro_torch.train.train_step import build_train_step
    cfg = smoke_config(get_config("qwen2-0.5b"))
    model = Model(cfg, make_plan(cfg, 1, 1), device="cpu")
    batch = SyntheticLM.place(SyntheticLM(DataConfig(cfg.vocab_size, 32, 2),
                                          cfg).batch(0), model.device)
    out = {}
    for spec in ("tp=toy,grad_rs=toy", "tp=taco,grad_rs=taco"):
        params = model.init(0)
        ctx = ParallelCtx(plan=reg.from_spec(spec))
        step = build_train_step(model, ctx, OptConfig())
        grads, loss = step.grads(params, batch)
        cache = ss.init_cache(model, 2, 16)
        tok = torch.tensor([[3], [5]])
        with torch.no_grad():
            logits = ss.decode_forward(params, tok, cache, 0,
                                       model, ParallelCtx(
                                           plan=reg.from_spec(spec)),
                                       return_logits=True)
        out[spec] = [loss] + leaves(grads) + [logits[1]]
    for got, want in zip(*out.values(), strict=True):
        assert torch.equal(got, want)
