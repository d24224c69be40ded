"""The route by configuration of ``repro_torch.kernels.ops``, held against
the JAX package's ``_impl_for`` (``repro/kernels/ops.py``).

The reference sends every configuration its Pallas kernels do not cover to
its oracle; the port sends the same configurations to the plain versions,
on the card too, and every other one to its CUDA kernels.  Held here, for
every TACO spec of ``benchmarks/accuracy.py`` and ``benchmarks/blocksize.py``
(their ``jnp`` token dropped: the port takes no TPU implementation token)
and the ablation specs of the port's F1 list:

  * what the reference sends to its oracle, the port sends to ``ref``;
  * everything else, the production specs, the block sizes of the sweep
    and a bf16 compute dtype among them, goes to the kernels, which are
    built for each of those block sizes and both compute dtypes.

Then the dispatch itself, on a stand-in CUDA tensor: a configuration with
no kernel calls the plain version and counts in ``ops.plain_routes``, a
covered one reaches the kernel wrapper, a block size the kernels are not
built for raises there, and nothing is caught.  Last, each ablation
configuration's hop on the port's plain path against the JAX oracle on the
same input.
"""
import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tp_like
from repro.core.codecs import pack_wire as jpack
from repro.core.registry import codec_from_spec as jspec
from repro.kernels import ops as jops
from repro_torch.core import ash
from repro_torch.core.registry import codec_from_spec
from repro_torch.kernels import ash_compress, ash_decompress, ops, ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAIN = ["taco", "taco:folded", "taco:folded:chunks=4"]
ABLATIONS = ["taco:hadamard", "taco:notransform", "taco:tensorscale",
             "taco:b128", "taco:cdbfloat16"]
#: the ablations with no kernel, in either package
NO_KERNEL = ["taco:hadamard", "taco:notransform", "taco:tensorscale"]


def _accuracy_specs():
    """The TACO entries of ``SPECS`` in benchmarks/accuracy.py, as codec
    specs without ``tp=`` and ``jnp``."""
    tree = ast.parse((ROOT / "benchmarks" / "accuracy.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "SPECS":
            specs = ast.literal_eval(node.value).values()
            return [s.removeprefix("tp=").replace(":jnp", "")
                    for s in specs if s.startswith("tp=taco")]
    raise AssertionError("no SPECS in benchmarks/accuracy.py")


def _blocksize_specs():
    """``taco:b<B>`` for each block size of the sweep in
    benchmarks/blocksize.py."""
    tree = ast.parse((ROOT / "benchmarks" / "blocksize.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.For) and getattr(node.target, "id", "") \
                == "b" and isinstance(node.iter, ast.List):
            return [f"taco:b{b}" for b in ast.literal_eval(node.iter)]
    raise AssertionError("no block-size sweep in benchmarks/blocksize.py")


SPECS = sorted(set(_accuracy_specs() + _blocksize_specs() + ABLATIONS
                   + MAIN))


def reference_route(spec):
    """``"jnp"`` where the reference's ``_impl_for`` sends ``spec`` to its
    oracle on the TPU (impl ``pallas``), else ``"pallas"``."""
    cfg = dataclasses.replace(jspec(spec).cfg, impl="pallas")
    return jops._impl_for(cfg)


def test_the_benchmark_specs_are_read():
    assert "taco:notransform:tensorscale" in SPECS
    assert {"taco:b32", "taco:b512"} <= set(SPECS)
    assert len(SPECS) >= 14


@pytest.mark.parametrize("spec", SPECS)
def test_route_agrees_with_the_reference(spec):
    cfg = codec_from_spec(spec).cfg
    assert ops.supported(cfg) == (reference_route(spec) == "pallas")
    if ops.supported(cfg):                # the kernels are built for it
        ash_compress.check_supported(cfg)


def test_the_kernels_cover_every_block_size_and_dtype_the_reference_does():
    covered = {s for s in SPECS if reference_route(s) == "pallas"}
    assert set(MAIN) | {"taco:b32", "taco:b64", "taco:b128", "taco:b512",
                        "taco:cdbfloat16"} <= covered
    for spec in covered:
        ash_compress.check_supported(codec_from_spec(spec).cfg)
    assert {s for s in SPECS if not ops.supported(codec_from_spec(s).cfg)} \
        == {s for s in SPECS if reference_route(s) == "jnp"} >= set(NO_KERNEL)


@pytest.mark.parametrize("spec", ["taco", "taco:b32", "taco:b128",
                                  "taco:b512", "taco:cdbfloat16",
                                  "taco:b64:cdbfloat16"])
def test_kernel_args_are_the_plain_versions_rotation_entry(spec):
    """The 1/sqrt(B) a kernel scales its rotation by is the entry of the
    plain version's H / sqrt(B) in the compute dtype, exactly."""
    cfg = codec_from_spec(spec).cfg
    b, bf, inv = ash_compress.kernel_args(cfg)
    h = ash.hadamard_matrix(cfg.block_size, cfg.torch_compute_dtype)
    assert (b, bf) == (cfg.block_size, int(cfg.compute_dtype == "bfloat16"))
    assert inv == float(h[0, 0]) == -float(h[1, 1])


class OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda")


def _operands(cfg, card=False):
    b = cfg.block_size
    lay = ref._layout(cfg, b)
    wrap = (lambda a: a.as_subclass(OnCard)) if card else (lambda a: a)
    x = wrap(torch.zeros(1, b))
    q = wrap(torch.zeros(1, b, dtype=cfg.format_spec.dtype))
    s = wrap(torch.ones(1, ash_compress.groups(cfg)))
    a = wrap(torch.ones(1))
    w = wrap(torch.zeros(1, lay.total_bytes, dtype=torch.uint8))
    return {"compress_blocks": (x, cfg),
            "decompress_blocks": (q, s, a, cfg),
            "decompress_reduce": (q[None], s[None], a[None], cfg),
            "compress_wire": (x, cfg),
            "decompress_wire": (w, b, cfg),
            "decompress_reduce_wire": (w, b, cfg)}


PLAIN = {"compress_blocks": "compress_blocks_ref",
         "decompress_blocks": "decompress_blocks_ref",
         "decompress_reduce": "decompress_reduce_ref",
         "compress_wire": "compress_wire_ref",
         "decompress_wire": "decompress_wire_ref",
         "decompress_reduce_wire": "decompress_reduce_wire_ref"}
WRAPPER = {"compress_blocks": ash_compress, "compress_wire": ash_compress,
           "decompress_blocks": ash_decompress,
           "decompress_reduce": ash_decompress,
           "decompress_wire": ash_decompress,
           "decompress_reduce_wire": ash_decompress}


@pytest.mark.parametrize("spec", NO_KERNEL)
def test_uncovered_cuda_tensor_takes_the_plain_version(spec, monkeypatch):
    """Each of the six operators sends a CUDA tensor under a configuration
    with no kernel to its plain version (and counts it) and never to the
    kernel wrapper; the plain version's error is not caught."""
    cfg = codec_from_spec(spec).cfg
    called = []
    for op, name in PLAIN.items():
        monkeypatch.setattr(ref, name,
                            lambda *a, _op=op, **k: called.append(_op) or
                            torch.zeros(1))

        def wrapper(*a, _op=op, **k):
            raise AssertionError(f"{_op}: kernel wrapper reached")
        monkeypatch.setattr(WRAPPER[op], op, wrapper)
    before = dict(ops.plain_routes)
    for op, args in _operands(cfg, card=True).items():
        getattr(ops, op)(*args)
    assert called == list(PLAIN)
    assert {k: ops.plain_routes[k] - before[k] for k in PLAIN} == \
        dict.fromkeys(PLAIN, 1)

    def boom(*a, **k):
        raise RuntimeError("plain version failed")
    monkeypatch.setattr(ref, "compress_blocks_ref", boom)
    with pytest.raises(RuntimeError, match="plain version failed"):
        ops.compress_blocks(*_operands(cfg, card=True)["compress_blocks"])


@pytest.mark.parametrize("spec", ["taco", "taco:b128", "taco:cdbfloat16"])
def test_covered_cuda_tensor_reaches_the_kernel_wrapper(spec):
    """Under a configuration with kernels (the production one, another
    block size, a bf16 compute dtype) a CUDA tensor goes to the kernel
    wrapper, which raises here (no CUDA runtime): no plain route."""
    if torch.cuda.is_available():
        pytest.skip("the stand-in tensor holds host memory")
    cfg = codec_from_spec(spec).cfg
    before = dict(ops.plain_routes)
    for op, args in _operands(cfg, card=True).items():
        with pytest.raises(AssertionError, match="not compiled with CUDA"):
            getattr(ops, op)(*args)
    assert ops.plain_routes == before


def test_a_block_size_the_kernels_are_not_built_for_raises_on_the_card():
    """B = 1024 has a kernel in the reference, not in the port: a CUDA
    tensor raises at the wrapper instead of taking the plain version."""
    cfg = codec_from_spec("taco:b1024").cfg
    before = dict(ops.plain_routes)
    for op, args in _operands(cfg, card=True).items():
        with pytest.raises(NotImplementedError, match="CUDA wire kernels"):
            getattr(ops, op)(*args)
    assert ops.plain_routes == before


@pytest.mark.parametrize("spec", ABLATIONS + ["taco"])
def test_cpu_tensors_never_count_as_plain_routes(spec):
    cfg = codec_from_spec(spec).cfg
    before = dict(ops.plain_routes)
    for op, args in _operands(cfg).items():
        getattr(ops, op)(*args)
    assert ops.plain_routes == before


@pytest.mark.parametrize("spec", ABLATIONS)
def test_ablation_hop_matches_the_jax_oracle(spec):
    """Each ablation configuration's plain versions (what the CPU runs, and
    the card for a configuration with no kernel; the kernels are held
    against them on the card), on the CPU against the JAX package's
    oracle: the wire rows under the parity rule of ``ref`` (its bf16
    allowances for ``cdbfloat16``), and the decoded hop within the decode
    tolerance of the compute dtype in relative norm.

    Under ``cdbfloat16`` the JAX oracle's encode emits bf16 alpha and s
    where its wire layout declares f32, so its own ``pack_wire`` refuses
    them; its components are widened (exactly) to the declared dtype
    here, as the port's plain version does, and JAX decodes its own
    unwidened components."""
    rng = np.random.default_rng(4242)
    n = 256 * 48                      # 36864 payload bytes over 3 slots
    x = tp_like(rng, (3, n))
    codec, jc = codec_from_spec(spec), jspec(spec.replace("taco",
                                                          "taco:jnp", 1))
    got = codec.encode_wire(torch.from_numpy(x))
    enc = jc.encode(jnp.asarray(x))
    wide = (enc[0],) + tuple(a.astype(jnp.float32) for a in enc[1:])
    want = torch.from_numpy(np.array(jpack(wide, jc.wire_layout(n))))
    ref.check_wire_parity(got, want, n, codec.cfg)
    dec = codec.decode_wire(want, n, torch.float32)
    jdec = torch.from_numpy(np.array(jc.decode(enc, n, jnp.float32)))
    rtol = ref.BF16_RTOL if codec.cfg.compute_dtype == "bfloat16" else \
        ref.DECODE_RTOL
    assert float((dec - jdec).norm() / jdec.norm()) < rtol


@pytest.mark.parametrize("spec", ABLATIONS)
def test_hop_parity_check_on_the_cpu(spec):
    """``ref.check_hop_parity`` (the card-vs-CPU hop check of the F1 phase)
    passes with the CPU on both sides, and counts its decode errors."""
    x = torch.from_numpy(tp_like(np.random.default_rng(7), (2, 256 * 48)))
    stats = ref.check_hop_parity(codec_from_spec(spec), x, "cpu")
    assert stats["flipped"] == 0
    assert stats["decode_rel_err"] == stats["decode_sum_rel_err"] == 0.0
