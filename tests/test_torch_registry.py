"""The port's spec grammar: the ``none``, ``taco``, ``sdp4bit``,
``tahquant`` and ``int8`` codecs, the ``+zle`` lossless stage, the
``escalate=`` / ``hold=`` policy tokens and the aliases round-trip to the
same normalized strings as the JAX registry; the TPU implementation
tokens are rejected with a clear error."""
import pytest
import torch

from repro.core import registry as jreg
from repro_torch.core import collectives as cc
from repro_torch.core import registry as reg
from repro_torch.core.parallel import CommPlan, ParallelCtx

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
