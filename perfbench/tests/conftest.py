"""The benchmark's own tests (run: ``python -m pytest perfbench/tests``;
``-m gpu`` for those that need the card).  The port's sources and the
checkout's root go on the path; the smoke cells shrink a cell to the
port's reduced configuration for CPU runs."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def smoke_cell(name: str, **traffic):
    """The cell ``name`` at the port's smoke configuration (2 layers, d
    128, vocabulary 503) and batch 2 x 64, or ``traffic``'s sizes."""
    from perfbench import harness
    from repro_torch.configs import get_config, smoke_config
    cell = harness.load_cell(name)
    sc = smoke_config(get_config(cell["config"]["port_name"]))
    cfg = dict(cell["config"])
    for k in harness._PORT_KEYS:
        cfg[k] = getattr(sc, k)
    cell["config"] = cfg
    cell["traffic"] = dict(cell["traffic"], **({"batch": 2, "seq": 64}
                                              | traffic))
    return cell


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
