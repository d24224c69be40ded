"""The port's shape suites, per-arch config modules and launcher argument
plumbing against the JAX package's: every ``ShapeSuite`` and ``cells(cfg)``
of every arch, each per-arch ``CONFIG`` field by field, the ``--policy``
alias resolver (``launch/_args.py``) in the four cases of
``tests/test_registry.py::test_launcher_policy_alias_resolver``, and
``--policy`` through both port launchers giving the plan of
``--comm-spec``.  Pure Python but for the launcher cases, which build a
smoke model on the CPU."""
import argparse
import dataclasses
import importlib
import warnings

import pytest

import repro.configs as jconfigs
from repro.launch import _args as jargs
from repro_torch import configs as tconfigs
from repro_torch.core.registry import to_spec
from repro_torch.launch import _args as targs
from test_torch_dist import one_thread  # noqa: F401  (autouse)

#: the JAX package's per-arch config modules (``configs/<name>.py``)
ARCH_MODULES = ["gpt_13b", "gpt_2_7b", "gpt_350m", "gpt_6_7b", "grok1_314b",
                "h2o_danube_18b", "hymba_15b", "internvl2_1b", "llama32_3b",
                "llama4_maverick_400b", "qwen15_32b", "qwen25_7b",
                "qwen2_0_5b", "rwkv6_16b", "whisper_small"]


def test_shape_suites_equal_the_references():
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    for name, suite in tconfigs.SHAPES.items():
        assert dataclasses.asdict(suite) == \
            dataclasses.asdict(jconfigs.SHAPES[name])
        assert isinstance(suite, tconfigs.ShapeSuite)


def test_package_exports_equal_the_references():
    assert sorted(tconfigs.__all__) == sorted(jconfigs.__all__)
    assert tconfigs.list_configs() == jconfigs.list_configs()
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED


@pytest.mark.parametrize("arch", jconfigs.list_configs())
def test_cells_equal_the_references(arch):
    """``cells`` and ``applicable`` of every arch: the same shapes run and
    the same skip, with the same reason."""
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert tconfigs.cells(tcfg) == jconfigs.cells(jcfg)
    for shape in tconfigs.SHAPES:
        assert tconfigs.applicable(tcfg, shape) == \
            jconfigs.applicable(jcfg, shape)


@pytest.mark.parametrize("module", ARCH_MODULES)
def test_per_arch_config_module_equals_the_reference(module):
    tmod = importlib.import_module(f"repro_torch.configs.{module}")
    jmod = importlib.import_module(f"repro.configs.{module}")
    assert tmod.__all__ == jmod.__all__ == ["CONFIG"]
    assert dataclasses.asdict(tmod.CONFIG) == dataclasses.asdict(jmod.CONFIG)
    assert tmod.CONFIG is tconfigs.get_config(tmod.CONFIG.name)


def test_every_arch_has_a_config_module():
    """The 15 modules cover every registered arch, once."""
    names = sorted(importlib.import_module(f"repro_torch.configs.{m}")
                   .CONFIG.name for m in ARCH_MODULES)
    assert names == sorted(tconfigs.list_configs())


def _resolver_cases(mod):
    """The four cases of the JAX package's resolver test, on ``mod``'s
    functions: (spec, warned) each."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--comm-spec", default=None, dest="comm_spec")
    mod.add_policy_alias(ap)
    out = []
    for argv in ([], ["--comm-spec", "tp=taco:chunks=4"],
                 ["--policy", "baseline"],
                 ["--policy", "baseline", "--comm-spec", "tp=taco"]):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            spec = mod.resolve_comm_spec(ap.parse_args(argv))
        out.append((spec, [w.category for w in got]))
    return out


def test_policy_alias_resolver_four_cases():
    """Explicit --comm-spec wins, explicit --policy warns, an untouched
    default warns nothing; the same answers and warnings as the JAX
    package's resolver."""
    got = _resolver_cases(targs)
    assert got == [("taco", []), ("tp=taco:chunks=4", []),
                   ("baseline", [DeprecationWarning]),
                   ("tp=taco", [DeprecationWarning])]
    assert got == _resolver_cases(jargs)
    assert targs.DEFAULT_SPEC == jargs.DEFAULT_SPEC


LAUNCH = ["--device", "cpu", "--smoke"]


def _train_spec(argv):
    from repro_torch.launch import train
    trainer, _ = train.build_trainer(train.parse_args(
        LAUNCH + ["--steps", "1", "--seq", "32", "--batch", "2"] + argv))
    return to_spec(trainer.ctx.plan)


def _serve_spec(argv):
    from repro_torch.launch import serve
    eng, _ = serve.build_engine(serve.parse_args(
        LAUNCH + ["--requests", "1", "--gen", "2"] + argv))
    return to_spec(eng.ctx.plan)


@pytest.mark.parametrize("build", [_train_spec, _serve_spec],
                         ids=["train", "serve"])
def test_policy_through_the_launchers(build):
    """``--policy`` in both launchers gives the plan of ``--comm-spec``
    (with a DeprecationWarning); neither flag gives ``taco``; an explicit
    ``--comm-spec`` wins over ``--policy``."""
    spec = "tp=taco:folded,warmup=2"
    want = build(["--comm-spec", spec])
    with pytest.warns(DeprecationWarning):
        assert build(["--policy", spec]) == want
    with pytest.warns(DeprecationWarning):
        assert build(["--policy", "baseline", "--comm-spec", spec]) == want
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        assert build([]) == "tp=taco"


def test_train_launcher_defaults_through_the_resolver():
    """The train launcher's ``--comm-spec`` defaults to None, which the
    resolver turns into ``DEFAULT_SPEC``, as in the JAX launchers."""
    from repro_torch.launch import serve, train
    for launcher in (train, serve):
        args = launcher.parse_args([])
        assert args.comm_spec is None and args.policy is None
        assert targs.resolve_comm_spec(args) == targs.DEFAULT_SPEC
