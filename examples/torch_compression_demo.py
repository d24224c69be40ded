"""Paper §3 / Fig. 4-6 / Fig. 8 on the PyTorch port: why TP intermediate
tensors need ASH + dual-scale FP8 — the twin of
``examples/compression_demo.py``.

Captures a row-parallel partial output from the port's model (layer 0's
attention of smoke qwen2-0.5b, before its reduction), prints its
distribution statistics, and compares the quantizers as the paper's
analysis figures do.  Runs on the card unless ``--device cpu`` (the
configurations without a kernel — tensor scales, no transform — take the
plain versions there, as ``kernels/ops.py`` routes them).

    PYTHONPATH=src python examples/torch_compression_demo.py
    PYTHONPATH=src python examples/torch_compression_demo.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, make_plan, smoke_config
from repro_torch.core import ash
from repro_torch.core.taco import TacoConfig, compress, decompress

#: the quantizers compared, the JAX demo's (the port has no ``impl``)
CONFIGS = {
    "naive FP8 cast (zero-collapse)": TacoConfig(
        transform="none", scale_granularity="tensor"),
    "INT8 per-tensor": TacoConfig(
        fmt="int8", transform="none", scale_granularity="tensor"),
    "std Hadamard + DS": TacoConfig(transform="hadamard"),
    "DS only (no transform)": TacoConfig(transform="none"),
    "TACO (ASH + DS, E4M3)": TacoConfig(),
    "TACO with E5M2": TacoConfig(fmt="e5m2"),
}


def capture_tp_tensor(device=None) -> np.ndarray:
    """Row-parallel partial output of a real (smoke) attention layer: layer
    0 of smoke qwen2-0.5b (weights from seed 3) on bf16 standard normals
    (numpy seed 0), as f32."""
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import Model

    cfg = smoke_config(get_config("qwen2-0.5b"))
    plan = make_plan(cfg, 1, 1, remat=False)
    model = Model(cfg, plan, device=device)
    params = model.init(3)
    ctx = ParallelCtx(plan=from_spec("baseline"))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (2, 128, cfg.d_model))).to(
        model.device, torch.bfloat16)
    lp = tree_map(lambda a: a[0], params["segments"][0])
    with torch.no_grad():
        out = attn_mod.attention_apply(x, lp["attn"], cfg, plan, ctx,
                                       causal=True, window=None)
    return out.float().cpu().numpy()


def report(t: np.ndarray, device) -> None:
    """The JAX demo's three tables for the flat f32 tensor ``t``."""
    print("== TP intermediate tensor statistics (paper Fig. 4) ==")
    print(f"  n={t.size}  std={t.std():.5f}  |x|_max={np.abs(t).max():.4f}")
    for eps in [1e-3, 1e-2, 1e-1]:
        frac = np.mean(np.abs(t) < eps)
        print(f"  P(|x| < {eps:g}) = {frac:.4f}")
    kurt = np.mean((t - t.mean()) ** 4) / t.var() ** 2
    print(f"  kurtosis = {kurt:.1f}  (3 = Gaussian; >> 3 = dense zero peak"
          " + long tail)")

    x = torch.from_numpy(t.reshape(-1, 4096)).to(device)
    print("\n== quantizer comparison on this tensor (Fig. 5/6/8) ==")
    small = np.abs(t) < 1e-2
    for name, cfg in CONFIGS.items():
        xh = decompress(compress(x, cfg), cfg, shape=x.shape, dtype=x.dtype)
        rel = float(torch.linalg.norm(xh - x) / torch.linalg.norm(x))
        xs = xh.cpu().numpy().reshape(-1)
        srel = np.mean(np.abs(xs[small] - t[small])
                       / np.maximum(np.abs(t[small]), 1e-4))
        print(f"  {name:34s} relRMSE={rel:.5f}  small-val relerr={srel:.4f}")

    print("\n== ASH energy dispersal (Fig. 8) ==")
    blocks, _ = ash.block_partition(x, 256)
    z_std, _ = ash.ash_forward(blocks)
    z_had = blocks @ ash.hadamard_matrix(256, device=blocks.device)
    for name, z in [("input blocks", blocks), ("std Hadamard", z_had),
                    ("ASH", z_std)]:
        z = z.cpu().numpy()
        rms = np.sqrt(np.mean(z ** 2, axis=-1))
        print(f"  {name:14s} block-RMS spread: min={rms.min():.2e} "
              f"median={np.median(rms):.2e} max={rms.max():.2e} "
              f"(ratio {rms.max() / max(rms.min(), 1e-30):.1e})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from repro_torch.models.model import resolve_device
    device = resolve_device(args.device)
    report(capture_tp_tensor(device).reshape(-1), device)


if __name__ == "__main__":
    main()
