"""The port's example twins (``examples/torch_*.py``) at their CI sizes on
the CPU: the quickstart, the gpt-100m example at ``--scale tiny``, the
serving example at smoke widths, and the compression demo, whose
statistics and quantizer comparison are held to the JAX demo's
(``examples/compression_demo.py``) on the same numpy tensor."""
import dataclasses
import importlib.util
import math
import pathlib
import re
import zlib

import numpy as np
import pytest

from conftest import tp_like
from repro_torch.core.registry import CommSpecError
from test_torch_dist import one_thread  # noqa: F401  (autouse)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def load(name):
    """An example script as a module (``examples/`` is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_trains(capsys):
    hist = load("torch_quickstart").main(["--device", "cpu", "--steps", "6"])
    assert [h["step"] for h in hist] == list(range(6))
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert "TACO-compressed TP communication" in capsys.readouterr().out


def test_train_lm_at_tiny_scale(capsys):
    """``--scale tiny`` under the default ``tp=taco,grad_rs=sdp4bit``;
    gpt-100m is the JAX example's config field by field."""
    mod = load("torch_train_lm")
    hist = mod.main(["--scale", "tiny", "--steps", "3", "--batch", "4",
                     "--device", "cpu"])
    assert len(hist) == 3 and all(math.isfinite(h["loss"]) for h in hist)
    out = capsys.readouterr().out
    assert "comm spec: tp=taco,grad_rs=sdp4bit" in out
    jmod = load("train_lm")
    assert dataclasses.asdict(mod.GPT_100M) == \
        dataclasses.asdict(jmod.GPT_100M)
    assert (mod.GPT_100M.n_layers, mod.GPT_100M.d_model) == (12, 768)


def test_train_lm_rejects_the_tpu_impl_token():
    """The JAX example's default spec names its ``jnp`` implementation,
    which the port refuses (it picks the kernel by the tensor's device)."""
    with pytest.raises(CommSpecError, match="TPU implementation"):
        load("torch_train_lm").main(["--scale", "tiny", "--steps", "1",
                                     "--device", "cpu", "--comm-spec",
                                     "tp=taco:jnp,grad_rs=sdp4bit"])


def test_serve_decode_serves_every_request(capsys):
    done = load("torch_serve_decode").main(
        ["--device", "cpu", "--requests", "3", "--gen", "5"])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.tokens) == 5 for r in done)
    assert "served 3 requests, 15 generated tokens" in \
        capsys.readouterr().out


_NUM = re.compile(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?")


def _sections(text):
    """The printed numbers of each report line, by the line's label."""
    out = {}
    for line in text.splitlines():
        if "=" not in line or line.startswith("=="):
            continue
        label = line.split("=")[0].strip()
        out[label] = [float(v) for v in _NUM.findall(line.split("=", 1)[1])]
    return out


def test_compression_demo_matches_the_reference(monkeypatch, capsys):
    """Both demos on one TP-like numpy tensor: the same statistics (the
    same numpy code), each quantizer's relRMSE and small-value error
    within one unit of the coarser printed digit, 1e-4 (the port's plain
    versions and the JAX package's oracle may round a code apart), the
    block RMS spreads within 1% (printed to three digits).  On this
    tensor every printed number is equal."""
    t = tp_like(np.random.default_rng(zlib.crc32(b"demo")),
                (2, 128, 128)).reshape(-1)
    got = {}
    for name, capture in (("torch_compression_demo",
                           lambda device=None: t),
                          ("compression_demo", lambda: t)):
        mod = load(name)
        monkeypatch.setattr(mod, "capture_tp_tensor", capture)
        mod.main(*([["--device", "cpu"]] if name.startswith("torch")
                   else []))
        got[name] = _sections(capsys.readouterr().out)
    port, ref = got["torch_compression_demo"], got["compression_demo"]
    # n / std / max, three P(|x| < eps), kurtosis, six quantizers, three
    # block-RMS spreads
    assert port.keys() == ref.keys() and len(port) == 14
    for label, want in ref.items():
        have = port[label]
        assert len(have) == len(want), label
        if "relRMSE" in label:
            np.testing.assert_allclose(have, want, rtol=0, atol=1e-4,
                                       err_msg=label)
        elif "block-RMS" in label:
            np.testing.assert_allclose(have, want, rtol=1e-2, err_msg=label)
        else:
            assert have == want, label
