"""Continuous-batching serving example of the PyTorch port — the twin of
``examples/serve_decode.py``: the engine admits a handful of requests
with different prompt lengths into one fixed slot table, prefills them in
chunks, and greedy-decodes every in-flight row per tick through the
TACO-compressed TP AllReduce (the decode path uses the two-shot
compressed AllReduce, since seq == 1 cannot be sequence-sharded).
Per-request latency lines come from the engine's telemetry.  Smoke
widths, as the JAX example; runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_serve_decode.py --arch qwen2-0.5b
    PYTHONPATH=src python examples/torch_serve_decode.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config, make_plan, smoke_config
from repro_torch.core.parallel import ParallelCtx
from repro_torch.core.registry import from_spec
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4, dest="max_batch")
    ap.add_argument("--comm-spec", dest="comm_spec", default="tp=taco",
                    help="compression plan spec (docs/COMPRESSION.md)")
    ap.add_argument("--no-compress", action="store_true",
                    help="shorthand for --comm-spec baseline")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = smoke_config(get_config(args.arch))
    model = Model(cfg, make_plan(cfg, tp=1, fsdp=1, remat=False),
                  device=args.device)
    params = model.init(0)
    comm_plan = from_spec("baseline" if args.no_compress else args.comm_spec)
    eng = ServeEngine(model, ParallelCtx(plan=comm_plan), params,
                      max_batch=args.max_batch,
                      max_len=max(64, args.prompt_len + args.gen + 1),
                      prefill_buckets=(8, max(8, args.prompt_len)),
                      device=model.device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        # staggered prompt lengths: requests finish at different ticks,
        # so retirement / admission churn exercises continuous batching
        n = max(1, args.prompt_len - 3 * i)
        eng.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                   max_new=args.gen)

    t0 = time.time()
    done = eng.run_until_drained()
    dt = time.time() - t0

    for row in (r.latency_row() for r in done):
        print("request rid={rid}: prompt={prompt_len} new={new_tokens} "
              "ttft={ttft_s:.3f}s decode={ms:.2f}ms/tok total={total_s:.3f}s"
              .format(ms=(row["decode_s_per_tok"] or 0.0) * 1e3, **row))
    s = eng.summary()
    total = s.get("total_new_tokens", 0)
    print(f"arch={cfg.name} served {s['requests']} requests, "
          f"{total} generated tokens")
    print(f"throughput {total / dt:.1f} tok/s on {model.device} "
          f"({'baseline' if args.no_compress else 'TACO-compressed'} TP)")
    print("sample token ids:", np.asarray(done[0].tokens[:16]))
    return done


if __name__ == "__main__":
    main()
