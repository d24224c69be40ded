"""The benchmark's yardstick arithmetic: the card's peaks, a training
step's model FLOPs, its TP hops and the bytes they pack, and the least
time its TACO codec work needs.  Everything is counted from the
configuration file's widths and the traffic file, never read from the
program, so a later change to the program cannot move it.

Peaks of one NVIDIA H100 SXM (80 GB HBM3), each from its factors
(Hopper whitepaper): dense bf16 132 SMs x 4,096 FLOP a clock x 1.830 GHz
= 989.4 TFLOP/s; f32 outside the tensor cores 132 x 128 lanes x 2 x 1.98
GHz = 66.9 TFLOP/s (the data sheet's 67, which the kernel bounds use);
HBM3 3.35 TB/s (the data sheet's; 5,120 bits x 2 x 2.619 GHz = 3.352).
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 132 * 4096 * 1.830e9
F32_OPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def matmul_params(cfg) -> int:
    """Weights that enter a matrix product in one step: every layer's
    projections and the head.  The
    input embedding is a lookup, not a product."""
    d, hd, f = cfg["d_model"], cfg["head_dim"], cfg["d_ff"]
    q, kv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    layer = d * q + 2 * d * kv + q * d
    layer += (2 if cfg["mlp"] == "gelu" else 3) * d * f
    vocab = -(-cfg["vocab_size"] // 128) * 128
    return cfg["n_layers"] * layer + vocab * d


def attended_pairs(seq: int, window: int | None) -> int:
    """(query, key) pairs of one causal sequence: all earlier positions,
    or the last ``window`` of them."""
    if window is None or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def model_flops(cfg, batch: int, seq: int) -> float:
    """FLOPs of one training step as the model needs them, nothing
    recomputed: 6 N T for the products with weights (forward 2, backward
    4), and the attention's score and value products, 4 hd H FLOPs a
    (query, key) pair forward and twice that backward."""
    pairs = cfg["n_layers"] * attended_pairs(seq, cfg.get("window"))
    attn = 12 * cfg["head_dim"] * cfg["n_heads"] * pairs * batch
    return 6.0 * matmul_params(cfg) * batch * seq + attn


def hops_per_step(cfg, remat: str) -> dict:
    """TP hops of one Megatron-SP training step, by collective: each
    layer enters (all-gather) and leaves (reduce-scatter) twice, the
    embedding leaves once and the final norm enters once; recompute
    (``remat`` other than ``"none"``) runs every entry and every exit but
    the layer's last again; the backward runs each forward hop's
    conjugate."""
    n = cfg["n_layers"]
    fwd = 2 * n + 1
    re_ag, re_rs = (2 * n, n) if remat != "none" else (0, 0)
    return {"all_gather": fwd + re_ag + fwd,
            "reduce_scatter": fwd + re_rs + fwd}


def bytes_per_element(codec) -> float:
    """Wire bytes an element of a hop packs: raw bf16 for the identity;
    for TACO one payload byte, and an f32 scale (and alpha, dual
    metadata) a block."""
    if codec["kind"] == "identity":
        return 2.0
    meta = 1 if codec["metadata"] == "folded" else 2
    return 1.0 + 4.0 * meta / codec["block"]


def hop_elements(cfg, traffic) -> int:
    """Elements of one hop: the batch's whole residual stream."""
    return traffic["batch"] * traffic["seq"] * cfg["d_model"]


def hop_bytes_per_token(cfg, traffic) -> float:
    hops = sum(hops_per_step(cfg, traffic["remat"]).values())
    return hops * cfg["d_model"] * bytes_per_element(traffic["hop_codec"])


def codec_least_s(cfg, traffic) -> float:
    """The least time a step's TACO codec work needs on the card: for
    each hop, the compress (bf16 in, the wire out; 16 f32 operations an
    element) and the decompress or peer-summed decompress (the wire in,
    the compute dtype out; 11 an element), each the larger of its bytes
    over the HBM rate and its operations over the f32 rate.  0 under an
    identity codec."""
    codec = traffic["hop_codec"]
    if codec["kind"] == "identity":
        return 0.0
    n = hop_elements(cfg, traffic)
    wire = n * bytes_per_element(codec)
    out = 4 if codec["compute_dtype"] == "float32" else 2
    comp = max((2 * n + wire) / HBM_BYTES_PER_S, 16.0 * n / F32_OPS)
    decomp = max((wire + out * n) / HBM_BYTES_PER_S, 11.0 * n / F32_OPS)
    hops = sum(hops_per_step(cfg, traffic["remat"]).values())
    return hops * (comp + decomp)
