"""The port's serving engine on the CPU (plain versions): requests drain,
and every request's tokens equal the port's own unbatched decode of the
same prompt.  Token equality is held under ``baseline``: under ``taco``
the two-shot AllReduce compresses the whole flattened (B, D) hop in
256-element blocks, so a block's scales depend on its neighbouring rows
and batched and unbatched runs legitimately differ."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, make_plan, smoke_config
from repro_torch.core.parallel import ParallelCtx
from repro_torch.core.registry import from_spec
from repro_torch.launch import serve
from repro_torch.models.model import Model
from repro_torch.serve import serve_step as ss
from repro_torch.serve.engine import ServeEngine
from test_torch_dist import one_thread  # noqa: F401  (autouse)

MAX_LEN = 32


def setup(spec="baseline"):
    cfg = smoke_config(get_config("qwen2-0.5b"))
    model = Model(cfg, make_plan(cfg, 1, 1, remat=False), device="cpu")
    ctx = ParallelCtx(plan=from_spec(spec))
    return model, ctx, model.init(0)


def prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 503, n).astype(np.int32) for n in lens]


def solo(model, ctx, params, prompt, max_new):
    """Unbatched greedy decode with a scalar position."""
    cache = ss.init_cache(model, 1, MAX_LEN)
    for t, tok in enumerate(prompt):
        nxt = ss.decode_forward(params, torch.tensor([[int(tok)]]), cache, t,
                                model, ctx)
    toks = [int(nxt[0, 0])]
    for t in range(len(prompt), len(prompt) + max_new - 1):
        nxt = ss.decode_forward(params, nxt, cache, t, model, ctx)
        toks.append(int(nxt[0, 0]))
    return toks


def test_engine_drains_and_matches_unbatched_decode():
    model, ctx, params = setup()
    eng = ServeEngine(model, ctx, params, max_batch=2, max_len=MAX_LEN,
                      prefill_buckets=(4, 8), device="cpu")
    lens, new = (5, 9, 3, 6), (6, 3, 5, 4)   # staggered: retire mid-batch
    reqs = [eng.submit(p, max_new=n)
            for p, n in zip(prompts(lens, 3), new)]
    done = eng.run_until_drained()
    assert len(done) == 4 and eng.sched.idle()
    assert eng.prefill_steps == sum(lens)
    for req, p, n in zip(reqs, prompts(lens, 3), new):
        assert req.tokens == solo(model, ctx, params, p, n), req.rid
    s = eng.summary()
    assert s["requests"] == 4 and s["total_new_tokens"] == sum(new)
    assert s["comm/tp_fwd_bytes_per_elem"] == 2.0
    assert "recompiles" not in s
    assert s["decode_ms_per_tok_p50"] > 0 and s["ttft_ms_p50"] > 0


def test_engine_taco_drains_with_finite_logits():
    model, ctx, params = setup("taco")
    eng = ServeEngine(model, ctx, params, max_batch=2, max_len=MAX_LEN,
                      collect_logits=True, device="cpu")
    reqs = [eng.submit(p, max_new=4) for p in prompts((4, 7, 2))]
    eng.run_until_drained()
    for r in reqs:
        assert len(r.tokens) == 4
        assert all(np.isfinite(row).all() for row in r.logit_rows)
    assert eng.summary()["comm/tp_fwd_bytes_per_elem"] == \
        pytest.approx(1.0 + 8.0 / 256)


def test_per_slot_and_scalar_positions_agree():
    model, ctx, params = setup("baseline")
    toks = torch.from_numpy(prompts((2,), 1)[0].reshape(2, 1)).long()
    c1, c2 = ss.init_cache(model, 2, 8), ss.init_cache(model, 2, 8)
    a = ss.decode_forward(params, toks, c1, 3, model, ctx,
                          return_logits=True)
    b = ss.decode_forward(params, toks, c2, torch.tensor([3, 3]), model, ctx,
                          return_logits=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for s1, s2 in zip(c1, c2):
        assert all(torch.equal(s1[k], s2[k]) for k in s1)


def test_cache_exhaustion_truncates_request():
    model, ctx, params = setup()
    eng = ServeEngine(model, ctx, params, max_batch=1, max_len=8,
                      device="cpu")
    req = eng.submit(prompts((5,))[0], max_new=10)
    eng.run_until_drained()
    assert 1 <= len(req.tokens) < 10


def test_launcher_on_cpu(capsys):
    s = serve.main(["--device", "cpu", "--requests", "2", "--prompt-len",
                    "3", "--gen", "3", "--max-batch", "2", "--qps", "1000",
                    "--comm-spec", "taco_folded"])
    assert s["requests"] == 2 and s["total_new_tokens"] == 6
    out = capsys.readouterr().out
    assert "tp=taco:folded" in out and "serving done" in out
    # a TP group of 2 is started by torchrun (tests/test_torch_dist.py runs
    # one); a data axis is not ported
    with pytest.raises(ValueError, match="torchrun"):
        serve.main(["--device", "cpu", "--mesh", "1,1,2"])
    with pytest.raises(NotImplementedError, match="data axes"):
        serve.main(["--device", "cpu", "--mesh", "1,2,1"])
