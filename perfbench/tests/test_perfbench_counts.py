"""The yardstick's arithmetic against hand counts, and its hop counts
and packed bytes against the port's dry run at smoke size."""
import json

import pytest

from conftest import ROOT, smoke_cell
from perfbench import counts

GPT = json.loads((ROOT / "perfbench/configs/gpt-2.7b.json").read_text())
TACO = json.loads((ROOT / "perfbench/traffic/train.taco.json").read_text())
BASE = json.loads((ROOT / "perfbench/traffic/train.baseline.json")
                  .read_text())


def test_gpt_flops_by_hand():
    d, f, v, L = 2560, 10240, 51200, 32
    n = L * (4 * d * d + 2 * d * f) + v * d
    assert counts.matmul_params(GPT) == n == 2_647_654_400
    pairs = 2048 * 2049 // 2
    attn = 12 * 80 * 32 * pairs * L * 4
    assert counts.model_flops(GPT, 4, 2048) == 6 * n * 8192 + attn


def test_window_pairs_by_hand():
    assert counts.attended_pairs(8, None) == 36
    assert counts.attended_pairs(8, 3) == 1 + 2 + 3 * 6
    assert counts.attended_pairs(8, 8) == 36


def test_gpt_hops_and_bytes_by_hand():
    assert counts.hops_per_step(GPT, "full") == {"all_gather": 194,
                                                 "reduce_scatter": 162}
    assert counts.bytes_per_element(TACO["hop_codec"]) == 1.03125
    assert counts.hop_bytes_per_token(GPT, TACO) == 356 * 2560 * 1.03125
    assert counts.hop_bytes_per_token(GPT, BASE) == 356 * 2560 * 2
    n = 4 * 2048 * 2560
    wire = 1.03125 * n
    least = 356 * ((2 * n + wire) / 3.35e12 + (wire + 4 * n) / 3.35e12)
    assert counts.codec_least_s(GPT, TACO) == pytest.approx(least, rel=1e-12)
    assert counts.codec_least_s(GPT, BASE) == 0.0


def test_peaks():
    assert counts.PEAK_BF16_FLOPS == pytest.approx(989.43e12, rel=1e-4)


@pytest.mark.parametrize("cell", ["gpt-2.7b.train.taco",
                                  "gpt-2.7b.train.baseline"])
def test_hops_equal_the_dry_run(cell):
    from repro_torch.configs import get_config, make_plan, smoke_config
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.core.registry import from_spec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import Model
    c = smoke_cell(cell)
    arch = smoke_config(get_config(c["config"]["port_name"]))
    model = Model(arch, make_plan(arch, 1, 1), device="cpu")
    suite = ShapeSuite("smoke", c["traffic"]["seq"], c["traffic"]["batch"],
                       "train")
    plan = from_spec(c["traffic"]["comm_spec"])
    got = dryrun.tp_traffic(model, suite, plan, Mesh((1, 1, 1)))
    hops = counts.hops_per_step(c["config"], c["traffic"]["remat"])
    assert (got["all_gather"], got["reduce_scatter"]) == \
        (hops["all_gather"], hops["reduce_scatter"])
    if c["traffic"]["hop_codec"]["kind"] != "identity":
        n = counts.hop_elements(c["config"], c["traffic"])
        assert got["packed_bytes"] == sum(hops.values()) * n * \
            counts.bytes_per_element(c["traffic"]["hop_codec"])
