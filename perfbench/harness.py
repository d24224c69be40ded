"""One run of one cell: the program built, set up, timed, checked.

The cell's files are found by name from ``BENCHMARK.json``: its
configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``), its limits (``limits/<cell>.json``) and
its per-layer metrics' readers (``metrics/<metric>.py``).

The program is the port, driven through its training launcher
(``repro_torch.launch.train.build_trainer``) and stepped by the trainer's
own ``_step``, as ``Trainer.run`` steps it: the batch placed, the policy
engine's attempt (forward, backward, every hop), the optimizer update,
the loss read back.  Set-up draws the weights and hands them to the
trainer, then runs the traffic's checked steps, which warm every shape
of the cell and are the steps the reference follows.  The window runs
whole steps until its seconds have passed (a traced run: the first
``TRACE_SECONDS`` of them, so that reading the trace stays within the
run's time).  After it the program's state
is freed and the reference (``reference/``) runs the checked steps again
in f32, and ``check.judge`` decides ``correct``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import pathlib
import time

import torch

from perfbench import check, inputs, tracing
from perfbench.reference import taco as ref_taco
from perfbench.reference import train as ref_train

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve().parent
#: the longest window a traced run traces: reading a 50 s trace of the
#: taco cell took ~200 s, near a run's limit
TRACE_SECONDS = 20.0


def load_cell(name: str, root: pathlib.Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])]
    end_to_end = [m for m in bench["end_to_end"]
                  if name in m.get("workloads", [name])]
    return {"name": name, "chips": w["chips"], "config": cfg,
            "traffic": traffic, "limits": limits["limits"],
            "per_layer": per_layer, "end_to_end": end_to_end}


def reader(metric: str):
    """The ``read(record)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


#: configuration file keys that the port's ``ArchConfig`` holds as well
_PORT_KEYS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab_size", "qkv_bias", "mlp", "norm",
              "norm_eps", "pos", "rope_theta", "window", "tie_embeddings")


def check_program(trainer, cfg: dict, traffic: dict) -> None:
    """The program runs what the files state: the configuration's widths
    and kinds, the traffic's plan, optimizer and recompute."""
    pc = trainer.model.cfg
    diff = {k: (cfg[k], getattr(pc, k)) for k in _PORT_KEYS
            if cfg[k] != getattr(pc, k)}
    plan = trainer.model.plan
    if (plan.tp, plan.fsdp, plan.remat_policy if plan.remat else "none") != \
            (1, 1, traffic["remat"]):
        diff["plan"] = (traffic["remat"], plan)
    codec = traffic["hop_codec"]
    tp = trainer.ctx.plan
    if codec["kind"] == "identity":
        if not tp.tp_identity:
            diff["hop_codec"] = (codec, tp)
    else:
        c = tp.tp_fwd.cfg
        want = (codec["block"], codec["fmt"], codec["metadata"], codec["tau"],
                codec["eps"], codec["scale_eps"], codec["compute_dtype"],
                "ash", "block", None, 1)
        got = (c.block_size, c.fmt, c.metadata, c.tau, c.eps, c.scale_eps,
               c.compute_dtype, c.transform, c.scale_granularity,
               c.quant_group_size, tp.tp_fwd.chunks)
        if want != got or tp.tp_bwd != tp.tp_fwd:
            diff["hop_codec"] = (codec, tp)
    opt, oc = traffic["optimizer"], trainer.oc
    if not all(math.isclose(a, b, rel_tol=1e-9) for a, b in zip(
            (oc.lr_max, oc.lr_min, oc.warmup_steps, oc.total_steps, oc.b1,
             oc.b2, oc.eps, oc.weight_decay, oc.clip_norm),
            (opt["lr"], opt["lr"] * opt["lr_min_ratio"], opt["warmup_steps"],
             opt["total_steps"], opt["b1"], opt["b2"], opt["eps"],
             opt["weight_decay"], opt["clip_norm"]))):
        diff["optimizer"] = (opt, oc)
    if diff:
        raise RuntimeError(f"the program does not run the cell's files: "
                           f"{diff}")


def build_program(cfg: dict, traffic: dict, seed: int, device: str,
                  smoke: bool, spans: tracing.Spans):
    """The port's trainer for the cell, its data the benchmark's batches,
    its policy engine's attempts and its optimizer updates recorded as
    spans."""
    from repro_torch.launch.train import build_trainer
    args = argparse.Namespace(
        arch=cfg["port_name"], smoke=smoke, steps=traffic["optimizer"][
            "total_steps"], seq=traffic["seq"], batch=traffic["batch"],
        comm_spec=traffic["comm_spec"], policy=None,
        lr=traffic["optimizer"]["lr"], seed=seed, device=device,
        mesh=traffic["mesh"], sp=1, sp_mode="ulysses", ckpt=None,
        resume=False)
    trainer, _ = build_trainer(args)
    check_program(trainer, cfg, traffic)
    trainer.data = inputs.Batches(seed, traffic["batch"], traffic["seq"],
                                  cfg["vocab_size"], trainer.model.device,
                                  spans)
    trainer.policy.run = spans.wrap("policy.run", trainer.policy.run)
    build = trainer.build_step

    def build_step(model, ctx, oc):
        fn = build(model, ctx, oc)
        fn.apply = spans.wrap("apply", fn.apply)
        return fn
    trainer.build_step = build_step
    return trainer


@contextlib.contextmanager
def tapped(tap):
    """While open, the port's one-axis hops (``core.collectives._ag_one``
    and ``_rs_one``, which every TP all-gather and reduce-scatter runs,
    the backward's included) report their input and output to
    ``tap.hop(x, y, first, backward)``."""
    from repro_torch.core import collectives as cc
    ag, rs = cc._ag_one, cc._rs_one

    def wrap(fn, scatter: bool):
        def hop(x, group, dim, codec):
            y = fn(x, group, dim, codec)
            tap.hop(x, y, dim if scatter else None,
                    torch._C._current_autograd_node() is not None)
            return y
        return hop
    cc._ag_one, cc._rs_one = wrap(ag, False), wrap(rs, True)
    try:
        yield tap
    finally:
        cc._ag_one, cc._rs_one = ag, rs


class Phases:
    """The phase of each hop of one step, in order (True: inside the
    backward pass, a recompute's hops included)."""

    def __init__(self):
        self.seq: list = []

    def hop(self, x, y, first, backward: bool) -> None:
        self.seq.append(backward)


class Picks:
    """The hops that ``reference.taco.Tap`` keeps, found by their places
    in an earlier step of the same shapes (``phases``) and copied to the
    host as they run, so that the tap holds no tensor of the program's:
    the run's peak memory stays the program's.  Nothing is kept where the
    step's hops differ in number from that step's."""

    def __init__(self, phases: list):
        fb = phases.index(True) if True in phases else 0
        self.at = {} if fb == 0 else dict(zip(
            (fb - 1, fb, len(phases) - 1), ref_taco.Tap.NAMES))
        self.n, self.i, self.kept = len(phases), 0, {}

    def hop(self, x, y, first, backward: bool) -> None:
        name = self.at.get(self.i)
        self.i += 1
        if name is not None:
            self.kept[name] = (_to_host(x), _to_host(y), first)

    def records(self) -> dict:
        return self.kept if self.i == self.n else {}


def _to_host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def program_steps(trainer, cfg, traffic, seed, device) -> tuple:
    """Set-up's steps: the weights drawn and handed over, the checked
    steps run, the last with three hops copied to the host (their places
    found in the step before); returns ``(params, opt_state, readings)``
    with the readings the check compares, taken before the state moves
    on."""
    params = inputs.weights(cfg, seed, device)
    if inputs.shapes(params) != inputs.shapes(trainer.model.abstract_params()):
        raise RuntimeError("the program's parameter layout is not the "
                           "benchmark's (inputs.layout)")
    params, opt_state, _ = trainer.init_state(params)
    dev = trainer.model.device
    readings = {}
    last = traffic["checked_steps"] - 1
    phases = Phases()
    for i in range(last + 1):
        tap = {last - 1: phases, last: Picks(phases.seq)}.get(i)
        with tapped(tap) if tap is not None else contextlib.nullcontext():
            params, opt_state = trainer._step(i, params, opt_state, dev)
        if i == last:
            readings["hops"] = tap.records()
        if i == 0:
            readings["grad"] = ref_train.first_grad_norms(
                opt_state["mu"], traffic["optimizer"])
    readings["loss"] = [h["loss"] for h in trainer.history]
    readings["change"] = ref_train.change_norms(
        opt_state["master"], inputs.initial_leaf(cfg, seed, dev))
    return params, opt_state, readings


def reference(cfg, traffic, seed, device, prec="f32", rows=None,
              stale=False) -> dict:
    """The reference's readings of the checked steps (``prec``,
    ``rows`` and ``stale`` as ``reference.train.follow`` takes them)."""
    w = inputs.weights(cfg, seed, device)
    w = ref_train.like_tree(w, [t.float() for _, t in
                            ref_train.named_leaves(w)])
    data = inputs.Batches(seed, traffic["batch"], traffic["seq"],
                          cfg["vocab_size"], device)
    batches = [data.batch(i) for i in range(traffic["checked_steps"])]
    return ref_train.follow(w, inputs.initial_leaf(cfg, seed, device),
                            batches, cfg, traffic["hop_codec"],
                            traffic["optimizer"], prec, rows, stale)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", smoke: bool = False,
             program_hook=None) -> tuple[dict, list]:
    """One run: ``(result, check_lines)``.  ``t_start`` is the process's
    start on ``time.perf_counter``.  ``smoke`` builds the port's reduced
    configuration (the tests' CPU runs, with a cell whose files state
    it); ``program_hook(trainer)``, given, may change the program under
    test before it runs (the tests' planted faults)."""
    cfg, traffic = cell["config"], cell["traffic"]
    if traffic["hop_codec"]["kind"] != "identity" and \
            torch.device(device).type == "cuda":
        # built once into build/kernels/ of the checkout, loaded after
        from repro_torch.kernels import build
        build.build_all()
    spans = tracing.Spans()
    trainer = build_program(cfg, traffic, seed, device, smoke, spans)
    if program_hook is not None:
        program_hook(trainer)
    params, opt_state, prog = program_steps(trainer, cfg, traffic, seed,
                                            device)
    dev = trainer.model.device
    _sync(device)
    tokens = traffic["batch"] * traffic["seq"]
    tracer = tracing.DeviceTrace() if trace else None
    span = min(seconds, TRACE_SECONDS) if trace else seconds
    if tracer is not None:
        tracer.start()
    t0, w0 = time.perf_counter(), time.time_ns()
    setup_s = t0 - t_start
    step, steps = traffic["checked_steps"], []
    while True:
        a = time.time_ns()
        with spans.span("step"):
            params, opt_state = trainer._step(step, params, opt_state, dev)
        steps.append((a, time.time_ns()))
        step += 1
        if time.perf_counter() - t0 >= span:
            break
    t1, w1 = time.perf_counter(), time.time_ns()
    if tracer is not None:
        tracer.stop()
    window_s = t1 - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    losses = [h["loss"] for h in trainer.history]
    del params, opt_state, trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference(cfg, traffic, seed, device)
    ok, numbers, read = check.judge(prog, ref, cell["limits"],
                                    traffic["hop_codec"])
    failed = sum(not math.isfinite(x) for x in losses)
    result = {"correct": bool(ok and failed == 0), "attempted": len(losses),
              "failed": failed}
    if trace:
        rec = tracing.record(cell, spans, steps, (w0, w1), tracer.events)
        metrics = {}
        for m in cell["per_layer"]:
            value = reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        e2e = {"train_tok_s": tokens * len(steps) / window_s,
               "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell["end_to_end"]}
    result["device"] = device_info(dev, peak)
    if trace:
        result["device"]["busy_s"] = tracing.busy_s(rec)
        result["device"]["window_s"] = rec["window_s"]
        result["breakdown"] = tracing.breakdown(rec)
    result["check"] = {k: {"value": v["value"], "limit": v["limit"]}
                       for k, v in numbers.items()}
    lines = ["window steps_ms: " + " ".join(f"{(b - a) / 1e6:.1f}"
                                            for a, b in steps)]
    lines += [f"read {k}: {v!r} (not compared; worst at {w})"
              for k, (v, w) in read.items()]
    lines += [f"check {k}: {v['value']!r} (limit {v['limit']!r}; worst at "
              f"{v['where']})" for k, v in numbers.items()]
    return result, lines


def device_info(dev: torch.device, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(peak)}
