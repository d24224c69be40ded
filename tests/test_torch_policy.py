"""The port's policy layer (``repro_torch.core.policy``, the negotiated
slots of ``repro_torch.core.collectives``, the ``escalate=`` / ``hold=``
grammar) held against the JAX package's on the CPU, with seeded numpy
inputs, and the trainer and serve engine running on it.

  * Grammar: every escalation spec of the reference's tests normalises to
    the JAX package's string; every spec it rejects, the port rejects.
  * Negotiated slots: ``negotiated_wire_bytes``, ``moved_slot_bytes``,
    ``achieved_slot_bytes`` and the per-hop byte counters equal the
    reference's; a negotiated hop equals the static hop bit for bit
    (monolithic, ring pipelined and serial; in one process and in gloo
    groups of 2 and 4 processes, where every rank negotiates the same
    widths); an overflow costs exactly one resync and lands bit-exact.
  * Controllers: the same observation stream fed to both packages'
    ``SlotController`` and ``ErrorEscalationController`` gives the same
    fractions, states, counters and events.
  * Engine and consumers: the ``PolicyEngine`` replay loop; the
    controller stack a plan asks for; the trainer escalates within at
    most 3 plan variants; a trainer step replayed after an overflow
    equals a step that never overflowed bit for bit, with the failed
    attempt leaving params and optimizer state untouched; the serve
    engine escalates, and a replayed decode tick's tokens are unchanged.
  * Telemetry: the ``comm/*`` keys equal the reference's for the same
    plan.
  * Probes: a codec without ``slot=auto`` or ``escalate=`` leaves nothing
    to read; one with them leaves one value per probe on the device.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tp_like
from repro.core import collectives as jcc
from repro.core import policy as jpolicy
from repro.core import registry as jreg
from repro.core import telemetry as jtel
from repro_torch.core import collectives as cc
from repro_torch.core import policy
from repro_torch.core import registry as treg
from repro_torch.core import telemetry as ttel
from test_torch_dist import run_group
from test_torch_dist import one_thread  # noqa: F401  (autouse)

ID = treg.codec_from_spec("none")
TRANSPORTS = ["", ":chunks=4", ":chunks=4:schedule=serial"]


def _jax_spec(spec):
    """The JAX package's spec of a port spec: every taco codec through its
    oracle (``jnp``)."""
    items = []
    for item in spec.split(","):
        key, eq, val = item.partition("=")
        if eq and val.startswith("taco") and key in (
                "tp", "tp_fwd", "tp_bwd", "grad_rs", "weight_ag", "pp", "sp"):
            head, sep, rest = val.partition(":")
            val = f"{head}:jnp{sep}{rest}"
        items.append(f"{key}{eq}{val}")
    return ",".join(items)


def sparse_flat(rng, rows=8, cols=1024, dense_rows=2):
    """bf16 (1, rows*cols) whose trailing rows are zero: the padded-batch
    workload renegotiation targets (the JAX package's test input)."""
    x = rng.normal(0, 0.02, (rows, cols)).astype(np.float32)
    x[dense_rows:] = 0.0
    return x.reshape(1, -1)


def dense_flat(rng, rows=8, cols=1024):
    return rng.normal(0, 0.02, (rows, cols)).astype(np.float32).reshape(1, -1)


def bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def negotiated(codec, sample):
    ctl = cc.SlotController()
    ctl.observe_sample(codec, sample)
    assert ctl.finish_step() is False
    neg = ctl.negotiate(codec)
    assert neg.moved_frac is not None
    return neg, ctl


# --------------------------------------------------------------------------
# grammar
# --------------------------------------------------------------------------

ESCALATION_SPECS = [
    "taco:escalate=bf16@0.08", "taco:folded:escalate=int8@0.05:hold=7",
    "int8:g256:escalate=bf16@0.02:hold=4", "tahquant:g128:escalate=bf16@0.1",
    "sdp4bit:escalate=tahquant@0.25:hold=2",
    "taco+zle:escalate=bf16@0.08:slot=auto",
    "taco+zle:slot=auto:escalate=bf16@0.08",
    "taco:folded:escalate=bf16@0.08:hold=20",
    "taco+zle:folded:chunks=4:slot=auto:escalate=bf16@0.005:hold=2",
]


@pytest.mark.parametrize("spec", ESCALATION_SPECS)
def test_escalate_spec_round_trips_to_jax_string(spec):
    codec = treg.codec_from_spec(spec)
    assert codec.escalate is not None
    assert treg.codec_from_spec(treg.codec_to_spec(codec)) == codec
    want = jreg.codec_to_spec(jreg.codec_from_spec(_jax_spec(spec)))
    assert treg.codec_to_spec(codec) == want.replace(":jnp", "")


#: every codec spec the reference's lossless, slot and policy tests
#: (tests/test_lossless.py, tests/test_slots.py, tests/test_policy.py)
#: parse, less the TPU ``impl`` token
REFERENCE_SPECS = [
    "taco+zle", "taco+zle:folded", "sdp4bit+zle", "tahquant+zle",
    "int8+zle:g64", "taco+zle:g=4", "taco+zle:g=32", "taco+zle:g=64",
    "taco+zle:g64", "taco+zle:slot=auto", "taco+zle:slot=static",
    "taco+zle:slot=auto:headroom=0.25:chunks=4",
    "taco+zle:slot=auto:chunks=4", "taco+zle:slot=auto:headroom=0.0",
    "taco+zle:slot=auto:headroom=1.0",
    "taco+zle:slot=auto:chunks=4:schedule=serial",
    "taco+zle:slot=auto:escalate=tahquant@0.05",
    "taco+zle:escalate=int8@0.1:slot=auto", "int8:g256:escalate=bf16@0.02",
    "int8:g256:escalate=bf16@0.05:hold=3", "taco:chunks=4:escalate=bf16@0.05",
    "taco:escalate=bf16@1e-6:hold=3", "taco:escalate=bf16@0.05",
] + ESCALATION_SPECS
REFERENCE_BAD = [
    "taco+zle:g=0", "taco+zle:g=16:g=32", "taco:g=16", "none+zle",
    "taco+zle:slot=dynamic", "taco+zle:headroom=-0.5",
    "taco+zle:slot=auto:slot=static", "taco:slot=auto",
]


@pytest.mark.parametrize("spec", REFERENCE_SPECS)
def test_reference_spec_round_trips_to_jax_string(spec):
    for plan_spec in (f"tp={spec}", f"tp={spec},warmup=3",
                      f"grad_rs=sdp4bit,tp_fwd={spec}"):
        port = treg.to_spec(treg.from_spec(plan_spec))
        want = jreg.to_spec(jreg.from_spec(_jax_spec(plan_spec)))
        assert port == want.replace(":jnp", ""), plan_spec
        assert treg.to_spec(treg.from_spec(port)) == port


@pytest.mark.parametrize("spec", REFERENCE_BAD)
def test_reference_bad_spec_rejected(spec):
    with pytest.raises(jreg.CommSpecError):
        jreg.from_spec(_jax_spec(f"tp={spec}"))
    with pytest.raises(treg.CommSpecError):
        treg.from_spec(f"tp={spec}")


@pytest.mark.parametrize("spec", [
    "taco:hold=5", "taco:escalate=nosuch@0.1", "taco:escalate=bf16@0",
    "taco:escalate=bf16", "taco:escalate=bf16@abc",
    "taco:escalate=bf16@0.1:hold=0", "int8:g256:hold=3",
    "sdp4bit:hold=2", "tahquant:escalate=bf16@-1", "taco:escalate=sdp4bit",
])
def test_bad_escalation_specs_rejected_as_jax_does(spec):
    with pytest.raises(jreg.CommSpecError):
        jreg.codec_from_spec(_jax_spec(spec))
    with pytest.raises(treg.CommSpecError):
        treg.codec_from_spec(spec)


@pytest.mark.parametrize("spec", [
    "taco+zle:slot=dynamic", "taco+zle:headroom=-0.5",
    "taco+zle:slot=auto:slot=static", "taco:slot=auto", "none+zle",
])
def test_bad_slot_specs_rejected_as_jax_does(spec):
    with pytest.raises(jreg.CommSpecError):
        jreg.codec_from_spec(_jax_spec(spec))
    with pytest.raises(treg.CommSpecError):
        treg.codec_from_spec(spec)


def test_slot_spec_defaults_and_routing():
    c = treg.codec_from_spec("taco+zle:slot=auto")
    assert c.slot == "auto" and c.moved_frac is None
    d = treg.codec_from_spec("taco+zle:slot=auto:headroom=0.25:chunks=4")
    assert d.headroom == 0.25 and d.chunks == 4
    assert treg.codec_to_spec(treg.codec_from_spec("taco+zle:slot=static")) \
        == "taco+zle"
    e = treg.codec_from_spec("taco+zle:escalate=int8@0.1:slot=auto")
    assert e.inner.escalate == ("int8", 0.1) == e.escalate


def test_moved_frac_is_controller_owned():
    base = treg.codec_from_spec("taco+zle:slot=auto")
    with pytest.raises(ValueError):
        dataclasses.replace(base, slot="static", moved_frac=(0.5,))
    with pytest.raises(ValueError):
        dataclasses.replace(base, moved_frac=(0.0,))
    neg = dataclasses.replace(base, moved_frac=(0.5,))
    assert treg.codec_to_spec(neg) == "taco+zle:slot=auto"
    assert treg.codec_from_spec(treg.codec_to_spec(neg)).moved_frac is None


def test_fallback_registry_matches_jax():
    assert treg.list_fallbacks() == jreg.list_fallbacks()
    assert treg.fallback_codec("bf16") == ID
    assert treg.fallback_codec("int8") == treg.codec_from_spec("int8")
    with pytest.raises(treg.CommSpecError):
        treg.fallback_codec("nosuch")
    with pytest.raises(treg.CommSpecError):
        treg.register_fallback("chained", "int8:escalate=bf16@0.1")
    assert "chained" not in treg.list_fallbacks()


PLAN_SPECS = [
    "tp=taco+zle:slot=auto,grad_rs=sdp4bit",
    "tp=taco:escalate=bf16@0.08,grad_rs=int8",
    "tp=taco+zle:folded:chunks=4:slot=auto:escalate=bf16@0.005:hold=2",
    "tp=taco+zle,pp=tahquant+zle:g=4,weight_ag=int8:escalate=bf16@0.1",
    "tp=taco+zle:slot=auto,warmup=5", "taco3d", "baseline",
]


@pytest.mark.parametrize("spec", PLAN_SPECS)
def test_plan_accessors_and_comm_metrics_match_jax(spec):
    tp, jp = treg.from_spec(spec), jreg.from_spec(_jax_spec(spec))
    assert treg.to_spec(tp) == jreg.to_spec(jp).replace(":jnp", "")
    for name in ("slot_modes", "escalation_modes", "wire_variable",
                 "has_auto_slots", "has_escalation"):
        assert getattr(tp, name)() == getattr(jp, name)(), name
    assert ttel.comm_metrics(tp, spec=spec, warmup_active=False) == \
        jtel.comm_metrics(jp, spec=spec, warmup_active=False)


def test_negotiated_comm_metrics_match_jax(rng):
    spec = "tp=taco+zle:slot=auto"
    tp, jp = treg.from_spec(spec), jreg.from_spec(_jax_spec(spec))
    sample = sparse_flat(rng)
    tctl, jctl = cc.SlotController(), jcc.SlotController()
    tctl.observe_sample(tp.tp_fwd, bf16(sample))
    jctl.observe_sample(jp.tp_fwd, jnp.asarray(sample, jnp.bfloat16))
    assert tctl.finish_step() is False and jctl.finish_step() is False
    tm, jm = ttel.comm_metrics(tctl.apply(tp)), jtel.comm_metrics(jctl.apply(jp))
    assert tm == jm
    assert tm["comm/tp_fwd_negotiated_bytes"] < tm["comm/tp_fwd_bytes_per_elem"]
    assert "comm/grad_rs_slot_auto" not in tm


# --------------------------------------------------------------------------
# negotiated-bound math and byte accounting
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["taco+zle:slot=auto",
                                  "taco+zle:folded:slot=auto:chunks=4",
                                  "sdp4bit+zle:slot=auto:g=4",
                                  "int8+zle:slot=auto:chunks=2",
                                  "tahquant+zle:slot=auto:headroom=0.25"])
@pytest.mark.parametrize("frac", [None, (1.0 / 32,), (0.5,), (1.0,),
                                  (1.0, 0.25, 0.25, 0.5)])
def test_negotiated_bytes_match_jax(spec, frac, rng):
    t, j = treg.codec_from_spec(spec), jreg.codec_from_spec(_jax_spec(spec))
    if frac is not None:
        t = dataclasses.replace(t, moved_frac=frac)
        j = dataclasses.replace(j, moved_frac=frac)
    for n in (t.granule, 4 * t.granule, 8192):
        for chunk in (None, 0, 1, 3):
            assert cc.negotiated_wire_bytes(t, n, chunk=chunk) == \
                jcc.negotiated_wire_bytes(j, n, chunk=chunk)
    for n in (4 * t.granule, 3 * t.granule + 17, 8192):
        for chunks in (None, 1, 4):
            assert cc.moved_slot_bytes(t, n, chunks=chunks) == \
                jcc.moved_slot_bytes(j, n, chunks=chunks)
            assert cc.wire_slot_bytes(t, n, chunks=chunks) == \
                jcc.wire_slot_bytes(j, n, chunks=chunks)
    x = tp_like(rng, (4, 2048))
    x[1:] = 0.0
    for chunks in (None, 1, 2):
        got = cc.achieved_slot_bytes(t, torch.from_numpy(x), chunks=chunks)
        want = jcc.achieved_slot_bytes(j, jnp.asarray(x), chunks=chunks)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))
    for p in (2, 4):
        assert cc.gather_wire_bytes((4, 2048), torch.float32, p, t,
                                    sample=torch.from_numpy(x)) == \
            jcc.gather_wire_bytes((4, 2048), jnp.float32, p, j,
                                  sample=jnp.asarray(x))
        assert cc.scatter_wire_bytes((4, 2048), torch.float32, p, t,
                                     sample=torch.from_numpy(x)) == \
            jcc.scatter_wire_bytes((4, 2048), jnp.float32, p, j,
                                   sample=jnp.asarray(x))
        assert cc.gather_wire_bytes((4, 2048), torch.float32, p, t) == \
            jcc.gather_wire_bytes((4, 2048), jnp.float32, p, j)
        assert cc.scatter_wire_bytes((4, 2048), torch.float32, p, ID) == \
            jcc.scatter_wire_bytes((4, 2048), jnp.float32, p,
                                   jreg.codec_from_spec("none"))


def test_negotiated_bound_is_clamped_to_floor_and_bound():
    base = treg.codec_from_spec("taco+zle:slot=auto")
    n = 4 * base.granule
    layout = base.wire_layout(n)
    assert cc.negotiated_wire_bytes(base, n) is None
    floor = layout.components[-1].offset
    tiny = dataclasses.replace(base, moved_frac=(1.0 / 32,))
    assert cc.negotiated_wire_bytes(tiny, n) >= floor
    full = dataclasses.replace(base, moved_frac=(1.0,))
    assert cc.negotiated_wire_bytes(full, n) == layout.total_bytes
    assert cc.moved_slot_bytes(full, n) == cc.wire_slot_bytes(base, n)
    assert cc.negotiated_wire_bytes(treg.codec_from_spec("taco"), n) is None


# --------------------------------------------------------------------------
# the truncated transport: bit-parity, overflow, probes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("transport", TRANSPORTS)
def test_negotiated_hop_equals_static_bitwise(transport, rng):
    spec = f"taco+zle:slot=auto{transport}"
    codec = treg.codec_from_spec(spec)
    static = treg.codec_from_spec(spec.replace(":slot=auto", ""))
    flat = bf16(sparse_flat(rng))
    neg, ctl = negotiated(codec, flat)
    n = flat.shape[-1]
    assert cc.moved_slot_bytes(neg, n) < cc.wire_slot_bytes(codec, n)
    for fn in (cc.all_gather_c, cc.psum_scatter_c):
        assert torch.equal(fn(flat, None, 0, neg, ID),
                           fn(flat, None, 0, static, ID))
        # the backward (the conjugate hop) under the negotiated codec too
        xs = [flat.clone().requires_grad_(True) for _ in range(2)]
        fn(xs[0], None, 1, ID, neg).backward(flat)
        fn(xs[1], None, 1, ID, static).backward(flat)
        assert torch.equal(xs[0].grad, xs[1].grad)
    assert ctl.finish_step() is False
    assert ctl.overflows == 0


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("dense_rows", [3, 8])
def test_overflow_resyncs_once_bit_exact(transport, dense_rows, rng):
    """The sequence of the JAX package's overflow property: a spike
    overflows the negotiated hop, exactly one static resync replays it
    bit-exactly, and the raised watermark renegotiates a wider bound that
    decodes the spike bit-exactly."""
    spec = f"taco+zle:slot=auto{transport}"
    codec = treg.codec_from_spec(spec)
    static = treg.codec_from_spec(spec.replace(":slot=auto", ""))
    rep = ttel.Reporter()
    ctl = cc.SlotController(reporter=rep)
    ctl.observe_sample(codec, bf16(sparse_flat(rng, dense_rows=1)))
    assert ctl.finish_step() is False
    neg = ctl.negotiate(codec)
    assert max(neg.moved_frac) < 1.0
    spike = bf16(dense_flat(rng) if dense_rows == 8
                 else sparse_flat(rng, dense_rows=dense_rows))

    def hop(c):
        return cc.all_gather_c(spike, None, 0, c, ID)
    ref = hop(static)
    attempts = 0
    out = hop(ctl.negotiate(codec))
    while ctl.finish_step():
        attempts += 1
        assert attempts <= 1, "resync failed to converge"
        out = hop(ctl.negotiate(codec))
    assert torch.equal(out, ref)
    assert attempts == 1 and ctl.resyncs == 1
    assert len(rep.of_kind("slot/resync")) == 1
    wide = ctl.negotiate(codec)
    assert max(wide.moved_frac) > max(neg.moved_frac)
    out2 = hop(wide)
    assert ctl.finish_step() is False
    assert torch.equal(out2, ref)


def test_multibuffer_equals_packed_and_jax(rng):
    """``multibuffer_wire`` (one move per component, the ring through the
    monolithic hop) equals the port's packed hop bit for bit, and the JAX
    package's packed hop within the decode tolerance."""
    x = tp_like(rng, (2, 4096))
    for spec in ("taco", "taco+zle:chunks=4", "sdp4bit+zle", "tahquant"):
        c = treg.codec_from_spec(spec)
        for fn in (cc.all_gather_c, cc.psum_scatter_c):
            packed = fn(torch.from_numpy(x), None, 1, c, c)
            with cc.multibuffer_wire():
                multi = fn(torch.from_numpy(x), None, 1, c, c)
            assert torch.equal(packed, multi), spec
        j = jreg.codec_from_spec(_jax_spec(spec))
        lay = j.wire_layout(x.shape[-1] // c.chunks)
        assert lay is not None
        want = j.decode_wire(j.encode_wire(jnp.asarray(x[:, :1024])), 1024,
                             jnp.float32)
        got = c.decode_wire(c.encode_wire(torch.from_numpy(x[:, :1024])),
                            1024, torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
    pp = treg.codec_from_spec("tahquant+zle:slot=auto")
    xx = torch.from_numpy(x)
    with cc.multibuffer_wire():
        multi = cc.ppermute_c(xx, None, ((0, 0),), pp, pp)
    assert torch.equal(multi, cc.ppermute_c(xx, None, ((0, 0),), pp, pp))


def test_probes_only_with_tokens(rng):
    """No probe op without ``slot=auto`` / ``escalate=``: nothing is left
    to read.  With them, one device value per probe (the error probe on
    chunk 0 of a ring hop only), read by ``drain_probes``."""
    ctl, esc = cc.SlotController(), policy.ErrorEscalationController()
    x = torch.from_numpy(tp_like(rng, (1, 4096)))
    cc.drain_probes()
    for spec in ("taco", "taco+zle", "taco+zle:chunks=4", "sdp4bit"):
        c = treg.codec_from_spec(spec)
        cc.all_gather_c(x, None, 1, c, c)
        assert not cc._PENDING, spec
    cases = {"taco:escalate=bf16@0.1": (0, 1),
             "taco+zle:slot=auto": (1, 0),
             "taco+zle:slot=auto:chunks=4:escalate=bf16@0.1": (4, 1)}
    for spec, (slots, errs) in cases.items():
        c = treg.codec_from_spec(spec)
        cc.all_gather_c(x, None, 1, c, c)
        assert len(cc._PENDING) == slots + errs, spec
        assert all(v.dim() == 0 for _, _, v, _ in cc._PENDING)
        cc.drain_probes()
        assert not cc._PENDING
        got_s, got_e = len(ctl._obs), len(esc._obs)
        assert (got_s, got_e) == (slots, errs), spec
        for _, _, slot_b, moved_b, ach in ctl._obs:
            assert isinstance(ach, int) and 0 < ach <= slot_b == moved_b
        for _, err in esc._obs:
            assert isinstance(err, float) and 0.0 < err < 0.1
        ctl._obs.clear()
        esc._obs.clear()


def test_err_probe_value_matches_jax_codec(rng):
    """The probe's relative error is the JAX package's formula on the
    first wire row: within 1e-4 of the JAX codec's value."""
    x = tp_like(rng, (1, 4096))
    c = treg.codec_from_spec("taco:escalate=bf16@0.1")
    esc = policy.ErrorEscalationController()
    cc.all_gather_c(torch.from_numpy(x), None, 1, c, c)
    cc.drain_probes()
    (_, err), = esc._obs
    j = jreg.codec_from_spec("taco:jnp")
    dec = np.asarray(j.decode_wire(j.encode_wire(jnp.asarray(x)), 4096,
                                   jnp.float32))
    want = np.linalg.norm(dec - x) / (np.linalg.norm(x) + 1e-12)
    assert abs(err - want) <= 1e-4 * want
    assert 0.01 < err < 0.05


# --------------------------------------------------------------------------
# the negotiated hop across processes (gloo)
# --------------------------------------------------------------------------

def _negotiated_task(rank, p, group, pl):
    """Bootstrap (static, probed) -> negotiated == static bit for bit ->
    a dense spike overflows on every rank -> one resync replay."""
    from repro_torch.core import collectives as tcc
    from repro_torch.core.registry import codec_from_spec
    ident = codec_from_spec("none")
    out = {}
    for transport in pl["transports"]:
        codec = codec_from_spec(f"taco+zle:slot=auto{transport}")
        static = codec_from_spec(f"taco+zle{transport}")
        x = torch.from_numpy(pl["sparse"][rank]).to(torch.bfloat16)
        spike = torch.from_numpy(pl["dense"][rank]).to(torch.bfloat16)
        ctl = tcc.SlotController()

        def hops(c, v):
            return [tcc.all_gather_c(v, group, 1, c, ident),
                    tcc.psum_scatter_c(v, group, 1, c, ident)]
        boot = hops(ctl.negotiate(codec), x)
        assert ctl.finish_step() is False
        neg = ctl.negotiate(codec)
        got, want = hops(neg, x), hops(static, x)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(a, b) for a, b in zip(boot, want))
        assert ctl.finish_step() is False
        hops(ctl.negotiate(codec), spike)
        overflow = ctl.finish_step()
        replay = hops(ctl.negotiate(codec), spike)
        assert ctl.finish_step() is False
        assert all(torch.equal(a, b)
                   for a, b in zip(replay, hops(static, spike)))
        out[transport] = (neg.moved_frac, overflow, ctl.resyncs,
                          tcc.moved_slot_bytes(neg, x.numel())
                          < tcc.wire_slot_bytes(codec, x.numel()))
    return out


@pytest.mark.parametrize("p", [2, 4])
def test_negotiated_hop_in_gloo_group(p, tmp_path, rng):
    sparse = np.stack([sparse_flat(rng, dense_rows=1) for _ in range(p)])
    dense = np.stack([dense_flat(rng) for _ in range(p)])
    res = run_group(tmp_path, p, _negotiated_task,
                    {"transports": TRANSPORTS, "sparse": sparse,
                     "dense": dense})
    for transport in TRANSPORTS:
        per_rank = [r[transport] for r in res]
        assert all(r == per_rank[0] for r in per_rank), per_rank
        frac, overflow, resyncs, narrower = per_rank[0]
        assert min(frac) < 1.0 and narrower and overflow and resyncs == 1


# --------------------------------------------------------------------------
# controllers against the JAX package's, on the same observation stream
# --------------------------------------------------------------------------

def _rows(rep):
    return [{k: v for k, v in r.items() if k != "t"} for r in rep.rows]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_controller_matches_jax(seed):
    spec = "tp=taco+zle:slot=auto:chunks=4:headroom=0.25"
    tp, jp = treg.from_spec(spec), jreg.from_spec(_jax_spec(spec))
    trep, jrep = ttel.Reporter(), jtel.Reporter()
    tctl, jctl = cc.SlotController(trep), jcc.SlotController(jrep)
    tctl.apply(tp)
    jctl.apply(jp)
    tkey, jkey = cc._slot_key(tp.tp_fwd), jcc._slot_key(jp.tp_fwd)
    rng = np.random.default_rng(seed)
    slot_b = 10_000
    for _ in range(40):
        tneg, jneg = tctl.negotiate(tp.tp_fwd), jctl.negotiate(jp.tp_fwd)
        assert tneg.moved_frac == jneg.moved_frac
        frac = tneg.moved_frac
        for chunk in range(4):
            moved = slot_b if frac is None else int(np.ceil(slot_b
                                                            * frac[chunk]))
            ach = int(rng.integers(100, slot_b) if rng.random() < 0.2
                      else rng.integers(100, 2500))
            tctl._obs.append((tkey, chunk, slot_b, moved, ach))
            jctl._obs.append((jkey, chunk, slot_b, moved, ach))
        assert tctl.finish_step() == jctl.finish_step()
        assert (tctl.renegotiations, tctl.resyncs, tctl.overflows) == \
            (jctl.renegotiations, jctl.resyncs, jctl.overflows)
    assert tctl.metrics() == jctl.metrics()
    assert _rows(trep) == _rows(jrep) and trep.rows
    assert tctl.resyncs > 0 and tctl.renegotiations > 1


def test_slot_controller_observe_sample_matches_jax(rng):
    for spec in ("taco+zle:slot=auto", "taco+zle:slot=auto:chunks=4",
                 "sdp4bit+zle:slot=auto"):
        t, j = treg.codec_from_spec(spec), \
            jreg.codec_from_spec(_jax_spec(spec))
        for sample in (sparse_flat(rng), dense_flat(rng)):
            tctl, jctl = cc.SlotController(), jcc.SlotController()
            tctl.observe_sample(t, bf16(sample))
            jctl.observe_sample(j, jnp.asarray(sample, jnp.bfloat16))
            assert [o[1:] for o in tctl._obs] == [o[1:] for o in jctl._obs]
            tctl.finish_step()
            jctl.finish_step()
            assert tctl.negotiate(t).moved_frac == \
                jctl.negotiate(j).moved_frac
    with pytest.raises(ValueError):
        cc.SlotController().observe_sample(treg.codec_from_spec("taco+zle"),
                                           bf16(sparse_flat(rng)))


@pytest.mark.parametrize("seed,hold", [(0, 1), (1, 3), (2, 6)])
def test_escalation_controller_matches_jax(seed, hold):
    spec = f"tp_fwd=int8:g256:escalate=bf16@0.05:hold={hold}"
    tp, jp = treg.from_spec(spec), jreg.from_spec(spec)
    trep, jrep = ttel.Reporter(), jtel.Reporter()
    tctl = policy.ErrorEscalationController(reporter=trep)
    jctl = jpolicy.ErrorEscalationController(reporter=jrep)
    tctl.apply(tp)
    jctl.apply(jp)
    tkey, jkey = cc._slot_key(tp.tp_fwd), jcc._slot_key(jp.tp_fwd)
    rng = np.random.default_rng(seed)
    for _ in range(60):
        if not tctl.escalated(tp.tp_fwd):
            err = float(rng.choice([0.005, 0.3]))
            tctl._obs.append((tkey, err))
            jctl._obs.append((jkey, err))
        assert tctl.finish_step() is False and jctl.finish_step() is False
        assert tctl.escalated(tp.tp_fwd) == jctl.escalated(jp.tp_fwd)
        assert tctl.metrics() == jctl.metrics()
        assert treg.to_spec(tctl.apply(tp)) == jreg.to_spec(jctl.apply(jp))
    assert _rows(trep) == _rows(jrep)
    assert tctl.escalations >= 1 and tctl.deescalations >= 1


def test_escalation_holds_then_deescalates():
    """The JAX package's hand-traced schedule (hold=3, thr=0.05,
    DECAY=0.75): 0.2 fires; held while silent until 0.2 * 0.75^k < 0.05."""
    plan = treg.from_spec("tp_fwd=int8:g256:escalate=bf16@0.05:hold=3")
    ctl = policy.ErrorEscalationController()
    ctl.apply(plan)
    key = cc._slot_key(plan.tp_fwd)
    ctl._obs.append((key, 0.2))
    ctl.finish_step()
    assert ctl.escalated(plan.tp_fwd)
    assert ctl.apply(plan).tp_fwd == treg.fallback_codec("bf16")
    for _ in range(4):
        ctl.finish_step()
        assert ctl.escalated(plan.tp_fwd)
    ctl.finish_step()
    assert not ctl.escalated(plan.tp_fwd) and ctl.deescalations == 1
    assert ctl.apply(plan) == plan
    assert ctl.metrics()["comm/tp_fwd_err_ema"] == pytest.approx(
        0.2 * 0.75 ** 5)


def test_escalated_codec_has_own_slot_key_and_skips_negotiation():
    plan = treg.from_spec("tp=taco+zle:slot=auto:escalate=tahquant@0.05")
    fb = treg.fallback_codec("tahquant")
    assert cc._slot_key(plan.tp_fwd) != cc._slot_key(fb)
    ctls = policy.default_controllers(plan)
    assert [type(c) for c in ctls] == \
        [policy.ErrorEscalationController, cc.SlotController]
    engine = policy.PolicyEngine(plan, lambda p: p, controllers=ctls)
    esc = engine.controller(policy.ErrorEscalationController)
    esc._obs.append((cc._slot_key(plan.tp_fwd), 0.9))
    engine.finish_step()
    resolved = engine.plan_at()
    assert resolved.tp_fwd == fb and resolved.tp_bwd == fb
    assert getattr(resolved.tp_fwd, "slot", None) != "auto"


# --------------------------------------------------------------------------
# PolicyEngine
# --------------------------------------------------------------------------

class FakeReplayer:
    """Demands exactly ``n`` replays, then is satisfied."""
    may_replay = True

    def __init__(self, n=1):
        self.pending, self.ticks = n, 0

    def apply(self, plan):
        return plan

    def finish_step(self):
        self.ticks += 1
        if self.pending > 0:
            self.pending -= 1
            return True
        return False

    def metrics(self):
        return {"fake/ticks": float(self.ticks)}


def test_engine_warmup_dispatch():
    plan = treg.from_spec("tp=taco,warmup=3")
    engine = policy.PolicyEngine(plan, lambda p: p)
    for step in range(8):
        fn, resolved = engine.fn_for(step)
        assert resolved == plan.at_step(step) and fn == resolved
        assert engine.warmup_active(step) == (step < 3)
    assert engine.compiled_count == 2
    assert engine.plan_at() == plan


def test_engine_replay_loop():
    plan = treg.from_spec("tp=taco")
    ctl = FakeReplayer(n=2)
    engine = policy.PolicyEngine(plan, lambda p: p, controllers=(ctl,))
    assert engine.replayable
    calls = []
    out, ran = engine.run(0, lambda fn: calls.append(fn) or "ok")
    assert out == "ok" and ran == plan
    assert len(calls) == 3 and ctl.ticks == 3
    assert engine.metrics() == {"fake/ticks": 3.0}
    assert isinstance(ctl, policy.StepController)


def test_engine_replayable_and_default_controllers():
    esc_plan = treg.from_spec("tp=taco:escalate=bf16@0.05")
    assert not policy.PolicyEngine(
        esc_plan, lambda p: p,
        controllers=policy.default_controllers(esc_plan)).replayable
    assert policy.PolicyEngine(
        esc_plan, lambda p: p,
        controllers=(policy.ErrorEscalationController(),
                     cc.SlotController())).replayable
    assert policy.default_controllers(treg.from_spec("tp=taco")) == ()
    (e,) = policy.default_controllers(esc_plan)
    assert isinstance(e, policy.ErrorEscalationController)
    (s,) = policy.default_controllers(treg.from_spec("tp=taco+zle:slot=auto"))
    assert isinstance(s, cc.SlotController)
    (w,) = policy.default_controllers(
        treg.from_spec("tp=taco+zle:slot=auto,warmup=5"))
    assert isinstance(w, cc.SlotController)
    mine = cc.SlotController()
    assert policy.default_controllers(treg.from_spec("tp=taco"),
                                      slot_controller=mine) == (mine,)
    # the same composition as the JAX package's, spec by spec
    for spec in PLAN_SPECS:
        assert [type(c).__name__ for c in policy.default_controllers(
            treg.from_spec(spec))] == \
            [type(c).__name__ for c in jpolicy.default_controllers(
                jreg.from_spec(_jax_spec(spec)))]


def test_engine_end_to_end_escalation_over_hop(rng):
    """Outlier traffic through a real compressed all-gather fires the
    escalation, the engine swaps to the fallback variant and back, and
    builds exactly two variants (the JAX package's test)."""
    plan = treg.from_spec("tp_fwd=int8:g256:escalate=bf16@0.02:hold=3")

    def build(p):
        return lambda v: cc.all_gather_c(v, None, 0, p.tp_fwd, ID)
    engine = policy.PolicyEngine(
        plan, build, controllers=policy.default_controllers(plan))
    base = rng.standard_normal(256 * 64).astype(np.float32)
    spiked = base.copy()
    spiked[::256] = 200.0
    normal, burst = bf16(base).reshape(1, -1), bf16(spiked).reshape(1, -1)
    ran = []
    for step in range(16):
        x = burst if 3 <= step < 8 else normal
        _, p = engine.run(None, lambda fn: fn(x))
        ran.append(p)
    m = engine.metrics()
    assert m["comm/escalations"] >= 1 and m["comm/deescalations"] >= 1
    assert any(p != plan for p in ran)
    assert ran[0] == plan == ran[-1]
    assert engine.compiled_count == 2


# --------------------------------------------------------------------------
# the trainer and the serve engine on the engine
# --------------------------------------------------------------------------

def _trainer(spec, steps=4, build_step=None):
    from repro_torch import configs
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = configs.smoke_config(configs.get_config("qwen2-0.5b"))
    model = Model(cfg, configs.make_plan(cfg, 1, 1), device="cpu")
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 2), cfg)
    oc = OptConfig(lr_max=1e-3, lr_min=1e-4, warmup_steps=2,
                   total_steps=steps)
    kw = {} if build_step is None else {"build_step": build_step}
    return Trainer(model, ParallelCtx(plan=treg.from_spec(spec)), oc,
                   TrainerConfig(total_steps=steps, log_every=100), data,
                   **kw)


def test_trainer_escalates_with_bounded_variants():
    tr = _trainer("tp=taco:escalate=bf16@1e-6:hold=3,warmup=2", steps=8)
    _, _, hist = tr.run(resume=False)
    assert len(hist) == 8 and all(np.isfinite(h["loss"]) for h in hist)
    m = tr.policy.metrics()
    assert m["comm/escalations"] >= 1 and m["comm/tp_fwd_escalated"] == 1.0
    assert tr.policy.compiled_count <= 3 and tr.slots is None
    assert [h["plan"] for h in hist[:3]] == \
        ["baseline", "baseline", "tp=taco:escalate=bf16@1e-06:hold=3"]
    assert hist[3]["plan"] == "baseline"           # escalated after step 2
    assert hist[3]["comm/escalations"] == 1.0
    assert hist[2]["comm/warmup_active"] == 0.0
    assert hist[1]["comm/warmup_active"] == 1.0


def _seed_narrow(tr, rng):
    """A watermark from a mostly-zero sample: the first negotiated step is
    too narrow for the dense hops of a step."""
    x = np.zeros((1, 8192), np.float32)
    x[0, :64] = rng.normal(0, 0.02, 64)
    tr.slots.observe_sample(tr.ctx.plan.tp_fwd, bf16(x))
    assert tr.slots.finish_step() is False
    assert max(tr.slots.negotiate(tr.ctx.plan.tp_fwd).moved_frac) < 0.2


def _leaves(tree):
    from repro_torch.optim import adamw
    return [t.detach().clone() for t in adamw.leaves(tree)]


def _state(params, opt):
    return _leaves(params) + _leaves({k: opt[k]
                                      for k in ("master", "mu", "nu")})


@pytest.mark.parametrize("pipeline", [False, True], ids=["step", "pipeline"])
def test_trainer_replay_after_overflow_is_bitwise(pipeline, rng):
    """Step 0 runs a negotiated bound too narrow for its hops, overflows,
    and is replayed at the static bound: params and optimizer state are
    untouched by the failed attempt, and the run equals one under the
    static ``taco+zle`` (no negotiation) bit for bit.  The pipeline step
    (one stage, two microbatches) goes through the same engine."""
    build = None
    if pipeline:
        from repro_torch.train import pipeline_parallel as ppl

        def build(m, c, o):
            return ppl.build_pipeline_train_step(
                m, c, o, ppl.PipeConfig(stages=1, microbatches=2))
    auto = _trainer("tp=taco+zle:slot=auto", steps=3, build_step=build)
    _seed_narrow(auto, rng)
    static = _trainer("tp=taco+zle", steps=3, build_step=build)
    attempts, applied = [], []
    inner, build_inner = auto._attempt, auto._build_step

    def spy(fn, params, batch):
        out = inner(fn, params, batch)
        attempts.append(_leaves(params))
        return out

    def counted_build(plan):
        step = build_inner(plan)
        apply = step.apply

        def counted(*a):
            applied.append(plan)
            return apply(*a)
        step.apply = counted
        return step
    auto._attempt, auto.policy._build = spy, counted_build
    want0 = _leaves(static.model.init(0))
    p_a, o_a, h_a = auto.run(resume=False)
    p_s, o_s, h_s = static.run(resume=False)
    assert auto.slots.resyncs == 1 and auto.slots.overflows == 1
    assert len(attempts) == 4                # step 0 twice, then 1 and 2
    for got in attempts[:2]:                 # both attempts of step 0 left
        assert all(torch.equal(a, b) for a, b in zip(got, want0))
    assert len(applied) == 3                 # the failed attempt: no update
    assert [h["loss"] for h in h_a] == [h["loss"] for h in h_s]
    assert all(torch.equal(a, b)
               for a, b in zip(_state(p_a, o_a), _state(p_s, o_s)))
    assert h_a[-1]["comm/slot_resyncs"] == 1.0
    assert h_a[-1]["comm/tp_fwd_slot_auto"] == 1.0


def _engine(spec, slot_controller=None, collect=False, max_batch=2):
    from repro_torch.configs import get_config, make_plan, smoke_config
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine
    cfg = smoke_config(get_config("qwen2-0.5b"))
    model = Model(cfg, make_plan(cfg, 1, 1, remat=False), device="cpu")
    ctx = ParallelCtx(plan=treg.from_spec(spec))
    return ServeEngine(model, ctx, model.init(0), max_batch=max_batch,
                       max_len=32,
                       prefill_buckets=(4, 8), device="cpu",
                       collect_logits=collect,
                       slot_controller=slot_controller)


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 503, n).astype(np.int32) for n in lens]


def test_serve_engine_escalates():
    eng = _engine("tp=taco:escalate=bf16@1e-6:hold=2")
    for p in _prompts((5, 3)):
        eng.submit(p, max_new=4)
    eng.run_until_drained()
    s = eng.summary()
    assert s["comm/escalations"] >= 1
    assert eng.policy.compiled_count <= 2
    assert all(len(r.tokens) == 4 for r in eng.sched.done)


def test_serve_replayed_tick_tokens_unchanged(rng):
    """A shared controller seeded from a half-zero sample of the decode
    hop's geometry (4 slots x d 128: two 256-element blocks, the second
    zero) makes the first negotiated decode tick too narrow: it overflows
    and is replayed at the static bound, and every token (and logit)
    equals an engine's under the static ``taco+zle``."""
    spec = "tp=taco+zle:slot=auto"
    shared = cc.SlotController()
    x = np.zeros((1, 4 * 128), np.float32)
    x[0, :256] = rng.normal(0, 0.02, 256)
    shared.observe_sample(treg.from_spec(spec).tp_fwd, bf16(x))
    assert shared.finish_step() is False
    assert max(shared.negotiate(treg.from_spec(spec).tp_fwd).moved_frac) < 1
    runs = {}
    for name, eng in (("auto", _engine(spec, shared, True, 4)),
                      ("static", _engine("tp=taco+zle", None, True, 4))):
        reqs = [eng.submit(p, max_new=5) for p in _prompts((4, 6, 3), 7)]
        eng.run_until_drained()
        runs[name] = ([r.tokens for r in reqs],
                      [np.stack(r.logit_rows) for r in reqs], eng)
    assert shared.resyncs >= 1 and runs["auto"][2].slots is shared
    assert runs["auto"][0] == runs["static"][0]
    for a, b in zip(runs["auto"][1], runs["static"][1]):
        np.testing.assert_array_equal(a, b)
    s = runs["auto"][2].summary()
    assert s["comm/slot_resyncs"] == float(shared.resyncs)
    assert s["comm/tp_fwd_slot_auto"] == 1.0
