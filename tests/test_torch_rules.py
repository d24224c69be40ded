"""Rules of the port, as tests:

  * nothing in ``src/repro_torch``, ``chip_smoke.py`` or the port's
    examples imports ``jax``, ``ml_dtypes`` (the card's machine has
    neither) or the JAX package ``repro`` — only torch, numpy, the
    standard library and the port itself;
  * the entry points (``Model``, ``ServeEngine``, the serve launcher) run
    on CUDA unless the caller asks for the CPU, and raise without a card;
  * a CUDA tensor reaches the kernel or an error, never the plain version
    (no ``try`` around a launch, no fallback).
"""
import ast
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("torch_*.py"))
ALLOWED = set(sys.stdlib_module_names) | {"torch", "numpy", "repro_torch",
                                          "__future__"}


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_only_torch_numpy_stdlib(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "ml_dtypes", "repro"), \
            f"{path}: {mod}"
        assert top in ALLOWED, f"{path}: imports {mod}"


def test_no_try_around_kernel_launches():
    for name in ("ash_compress.py", "ash_decompress.py", "ops.py"):
        tree = ast.parse((ROOT / "src" / "repro_torch" / "kernels"
                          / name).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), name


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def smoke_model(device):
    from repro_torch.configs import get_config, make_plan, smoke_config
    from repro_torch.models.model import Model
    cfg = smoke_config(get_config("qwen2-0.5b"))
    return Model(cfg, make_plan(cfg, 1, 1), device=device)


def test_entry_points_raise_without_cuda(no_card):
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServeEngine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smoke_model(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smoke_model("cuda")
    model = smoke_model("cpu")
    assert model.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, ParallelCtx(), model.init(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1"])


def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    """A tensor that reports a CUDA device goes to the launch path (which
    fails here, with no CUDA runtime) and never to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("the stand-in tensor holds host memory; on a card the "
                    "gpu-marked tests show the launches")
    from repro_torch.core.registry import codec_from_spec
    from repro_torch.kernels import ash_compress, ash_decompress, ref

    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    for name in ("compress_wire_ref", "decompress_wire_ref",
                 "decompress_reduce_wire_ref"):
        monkeypatch.setattr(ref, name, boom)

    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    cfg = codec_from_spec("taco").cfg
    x = torch.zeros(1, 256).as_subclass(OnCard)
    w = torch.zeros(1, 264, dtype=torch.uint8).as_subclass(OnCard)
    calls = [lambda: ash_compress.compress_wire(x, cfg),
             lambda: ash_decompress.decompress_wire(w, 256, cfg),
             lambda: ash_decompress.decompress_reduce_wire(w, 256, cfg)]
    for call in calls:
        with pytest.raises(AssertionError, match="not compiled with CUDA"):
            call()
    # a CUDA tensor outside the kernels' coverage (a block size they are
    # not built for) raises, too
    with pytest.raises(NotImplementedError, match="CUDA wire kernels"):
        ash_compress.compress_wire(x, codec_from_spec("taco:b1024").cfg)
