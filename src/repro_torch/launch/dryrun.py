"""Dry run of the production meshes: a shape and memory check, and the
roofline terms, of every arch x shape cell — the counterpart of the JAX
package's ``launch/dryrun.py``.

The JAX dry run lowers and compiles each cell for 256 or 512 placeholder
devices and reads XLA's memory and cost analyses.  PyTorch compiles
nothing ahead of a run, so this one builds the port's ``Model`` for rank
0 of the production mesh (``launch/mesh.py`` ``make_production_mesh``:
single-pod ``(1, 16, 16)``, multi-pod ``(2, 16, 16)`` over ``("pod",
"data", "model")``) and counts, allocating nothing on any device:

  --mode check     rank 0's exact bytes: its parameter shards (``model.
                   specs()`` cut on the ``meta`` device as ``Model.shard``
                   cuts them), its grads (as the parameters), its AdamW
                   state (``optim/adamw.py`` ``abstract_opt_state``) for a
                   training shape, its decode cache (``serve_step.
                   cache_shapes`` at its rows of the batch) for a decode
                   shape; the verdict against the card's 80 GB.  Activation
                   memory is not estimated: ``chip_smoke.py`` phase 14
                   measures a step's peak on the card.
  --mode roofline  check + the three terms of ``launch/roofline.py`` for
                   one H100 rank: compute from the model's FLOPs
                   (``model_flops_for``, the JAX package's), memory from
                   the persistent bytes read once a step, collectives from
                   the port's own wire accounting of each hop
                   (``core/collectives.py`` ``gather_wire_bytes`` /
                   ``scatter_wire_bytes`` / ``a2a_wire_bytes`` /
                   ``wire_slot_bytes``) times the hops a step runs under
                   ``--comm-spec`` (``transformer.tp_hops_per_step``).

XLA's cost analysis counts a ``lax.scan`` body once, so the JAX package
fits unrolled depth variants (``models/analysis_mode.py``); counting from
the config has no such undercount, so nothing here extrapolates.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --mode check
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k --mesh multi --comm-spec taco --mode roofline

Prints ``== dry-run: N ok, K skipped (spec), E errors`` and exits 1 on
any error.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import (ASSIGNED, SHAPES, applicable, get_config,
                                 make_plan)
from repro_torch.core import collectives as cc
from repro_torch.core.codecs import IdentityCodec, TacoCodec
from repro_torch.core.parallel import CommPlan
from repro_torch.core.registry import from_spec, to_spec
from repro_torch.data.pipeline import split_positions
from repro_torch.launch import roofline as rl
from repro_torch.launch._args import add_policy_alias, resolve_comm_spec
from repro_torch.launch.mesh import (Mesh, make_production_mesh,
                                     mesh_axis_info, sp_axis_info)
from repro_torch.models import transformer
from repro_torch.models.layers import COMPUTE_DTYPE, tree_map
from repro_torch.models.model import Model, _stacked_ids
from repro_torch.optim import adamw
from repro_torch.serve import serve_step as ss

#: the card's device memory (the H100 SXM data sheet's 80 GB)
CARD_BYTES = 80e9


def model_flops_for(cfg, suite) -> float:
    """The JAX package's model FLOPs of a cell: 6 N D for a training step,
    2 N_active a token for a decode step (one token a sequence)."""
    n = cfg.active_param_count()
    if suite.kind == "train":
        return 6.0 * n * suite.seq_len * suite.global_batch
    return 2.0 * n * suite.global_batch  # one token per sequence


def cell_model(cfg, mesh: Mesh) -> Model:
    """The port's ``Model`` of rank 0 of ``mesh`` on the CPU (nothing is
    allocated until ``init``), planned as the JAX dry run plans it."""
    fsdp_axes, _, tp, fsdp = mesh_axis_info(mesh)
    sp_axis, sp = sp_axis_info(mesh)
    plan = make_plan(cfg, tp, fsdp)
    return Model(cfg, plan, device="cpu", fsdp_axes=fsdp_axes,
                 sp_axis=sp_axis, sp=sp)


def batch_rows(model, suite) -> int:
    """Rank 0's rows of the global batch: split over the fsdp axes (a
    decode batch that does not split stays whole on every rank, as the JAX
    dry run leaves ``long_500k``'s one row replicated)."""
    fsdp = model.plan.fsdp
    if suite.global_batch % fsdp == 0:
        return suite.global_batch // fsdp
    if suite.kind == "train":
        raise ValueError(f"global batch {suite.global_batch} does not "
                         f"split over fsdp {fsdp}")
    return suite.global_batch


def abstract_params(model):
    """Rank 0's parameter shards as ``meta`` tensors: each leaf of
    ``model.abstract_params()`` cut as ``Model.shard`` cuts it."""
    specs = model.specs()
    stacked = _stacked_ids(specs)
    return tree_map(lambda s, t: model.shard(s, t, id(s) in stacked), specs,
                    model.abstract_params())


def nbytes(tree) -> int:
    """Bytes of the tensor leaves of ``tree`` (a host int counts none)."""
    return sum(t.numel() * t.element_size() for t in adamw.leaves(tree)
               if isinstance(t, torch.Tensor))


def memory(model, suite) -> dict:
    """Rank 0's persistent bytes of a cell, by kind, and their total."""
    params = abstract_params(model)
    out = {"params": nbytes(params)}
    if suite.kind == "train":
        out["grads"] = out["params"]
        out["opt_state"] = nbytes(adamw.abstract_opt_state(params))
    else:
        shapes = ss.cache_shapes(model, batch_rows(model, suite),
                                 suite.seq_len)
        out["cache"] = sum(math.prod(shape) * torch.empty(
            (), dtype=dt).element_size()
            for seg in shapes for shape, dt in seg.values())
    out["total"] = sum(out.values())
    return out


def _hop_positions(cfg, seq_len: int) -> int:
    """Positions of the residual stream a TP hop moves: an encoder's and
    a decoder's half each (encoder-decoder), patches and tokens (patch
    frontend), else the sequence."""
    key, n_stub, s_tok = split_positions(cfg, seq_len)
    return s_tok + (n_stub if key == "patches" else 0)


def _ring(mesh: Mesh, axis: str) -> tuple:
    """(size, stride) of the rank groups along ``axis``."""
    k = mesh.axes.index(axis)
    return mesh.shape[k], math.prod(mesh.shape[k + 1:])


def _split_tp(comm_plan: CommPlan) -> tuple:
    """(forward-codec plan, backward-codec plan, every-layer plan): the
    plan with one direction's codec made the identity, each other, and a
    plan compressing every hop (the count of all hops, raw ones
    included)."""
    fwd = dataclasses.replace(comm_plan, tp_bwd=IdentityCodec())
    bwd = dataclasses.replace(comm_plan, tp_fwd=IdentityCodec())
    every = CommPlan(tp_fwd=TacoCodec(), tp_bwd=TacoCodec())
    return fwd, bwd, every


def tp_traffic(model, suite, comm_plan: CommPlan, mesh: Mesh,
               sp_mode: str = "ulysses") -> dict:
    """The TP (and sp) hops of one step of rank 0, by kind, with the
    bytes they pack and send.  A training step: the all-gathers and
    reduce-scatters of ``tp_hops_per_step`` (each compressed hop through
    its direction's codec; the hops of skipped layers move raw bf16), and
    the sp hops; a decode step: one two-shot AllReduce a hop
    (``2L + 1``, ``3L + 1`` for the encoder-decoder).  ``packed`` is the
    bytes the compress kernels write for the slots a rank encodes (each
    compressed hop's ``wire_slot_bytes``); ``link`` is what a rank sends
    its peers (0 on a group of one)."""
    cfg, plan = model.cfg, model.plan
    tp = plan.tp
    sp = model.sp
    rows = batch_rows(model, suite)
    d = cfg.d_model
    item = torch.empty((), dtype=COMPUTE_DTYPE).element_size()

    def slot(codec, n, chunks=None):
        b = cc.wire_slot_bytes(codec, n, chunks=chunks)
        return float(n * item if b is None else b)

    out = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0,
           "all_to_all": 0, "permute": 0, "packed_bytes": 0.0,
           "link_bytes": 0.0, "sp_link_bytes": 0.0}
    if suite.kind != "train":
        n = rows * d
        hops = (3 if cfg.family == "encdec" else 2) * cfg.n_layers + 1
        c = comm_plan.tp_fwd
        out["all_reduce"] = hops
        if not isinstance(c, IdentityCodec):
            # the reduce-scatter shot encodes tp slots, the gather shot one
            out["packed_bytes"] = hops * (tp + 1) * slot(c, n // tp)
        out["link_bytes"] = hops * (
            cc.scatter_wire_bytes((n,), COMPUTE_DTYPE, tp, c)
            + cc.gather_wire_bytes((n // tp,), COMPUTE_DTYPE, tp, c))
        return out
    s = _hop_positions(cfg, suite.seq_len) // sp
    n_full = rows * s * d                 # one reduce-scatter's input
    n_local = n_full // tp                # one all-gather's slot
    fwd, bwd, every = _split_tp(comm_plan)
    counted = {"all_gather": 0, "reduce_scatter": 0}
    for p, codec in ((fwd, comm_plan.tp_fwd), (bwd, comm_plan.tp_bwd)):
        if isinstance(codec, IdentityCodec):
            continue
        h = transformer.tp_hops_per_step(cfg, plan, p, sp, sp_mode)
        for kind in counted:
            counted[kind] += h[kind]
        out["packed_bytes"] += h["all_gather"] * slot(codec, n_local) \
            + h["reduce_scatter"] * tp * slot(codec, n_local)
        out["link_bytes"] += \
            h["all_gather"] * cc.gather_wire_bytes(
                (n_local,), COMPUTE_DTYPE, tp, codec) \
            + h["reduce_scatter"] * cc.scatter_wire_bytes(
                (n_full,), COMPUTE_DTYPE, tp, codec)
    every_h = transformer.tp_hops_per_step(cfg, plan, every, sp, sp_mode)
    raw = IdentityCodec()
    for kind, fn, shape in (("all_gather", cc.gather_wire_bytes, n_local),
                            ("reduce_scatter", cc.scatter_wire_bytes,
                             n_full)):
        k = every_h[kind] - counted[kind]         # hops moving raw bf16
        out[kind] = every_h[kind]
        out["link_bytes"] += k * fn((shape,), COMPUTE_DTYPE, tp, raw)
    out["compressed"] = counted
    # every sp hop runs, an identity codec's moving raw bf16
    h = transformer.tp_hops_per_step(
        cfg, plan, dataclasses.replace(comm_plan, sp=TacoCodec()), sp,
        sp_mode)
    if sp > 1:
        # Ulysses: q, k, v in (3 x the local heads), the output back (1x);
        # the ring: k and v a permute (2x), each of a rank's positions
        heads = rows * s * plan.q_local * cfg.hd
        c = comm_plan.sp
        out["all_to_all"], out["permute"] = h["all_to_all"], h["permute"]
        per_a2a = (cc.a2a_wire_bytes((3 * heads,), COMPUTE_DTYPE, sp, c)
                   + cc.a2a_wire_bytes((heads,), COMPUTE_DTYPE, sp, c)) / 2
        out["sp_link_bytes"] = h["all_to_all"] * per_a2a \
            + h["permute"] * slot(c, 2 * heads, chunks=1)
    return out


def fsdp_traffic(model, suite, comm_plan: CommPlan, mesh: Mesh) -> dict:
    """Bytes rank 0 sends a step over each fsdp axis: a weight gather of
    each fsdp-sharded leaf a forward (innermost axis first, through the
    ``weight_ag`` codec), once more in a layer's recompute under remat,
    and its gradient's reduce-scatter (outermost axis first, through
    ``grad_rs``) in a training step.  One gather a leaf a forward: a tied
    table's second use is not counted."""
    plan = model.plan
    specs = model.specs()
    stacked = _stacked_ids(specs)
    axes = [a for a in model.fsdp_axes if mesh.size(a) > 1]
    out = {a: 0.0 for a in model.fsdp_axes}
    if not axes:
        return out
    train = suite.kind == "train"
    remat = plan.remat and plan.remat_policy != "none"

    def leaf(spec):
        if spec.fsdp_dim is None:
            return
        n = math.prod(spec.shape) // (plan.tp if spec.tp_dim is not None
                                      else 1)
        gathers = 1 + (train and remat and id(spec) in stacked)
        local = n // plan.fsdp
        for a in reversed(model.fsdp_axes):       # innermost first
            p = mesh.size(a)
            out[a] += gathers * cc.gather_wire_bytes(
                (local,), COMPUTE_DTYPE, p, comm_plan.weight_ag)
            if train:
                out[a] += cc.scatter_wire_bytes(
                    (local * p,), COMPUTE_DTYPE, p, comm_plan.grad_rs)
            local *= p
    tree_map(leaf, specs)
    return out


def roofline(model, suite, comm_plan: CommPlan, mesh: Mesh,
             sp_mode: str = "ulysses") -> dict:
    """The three roofline terms of one H100 rank for the cell."""
    chips = math.prod(mesh.shape)
    mem = memory(model, suite)
    tpt = tp_traffic(model, suite, comm_plan, mesh, sp_mode)
    tp_size, tp_stride = _ring(mesh, "model")
    coll = {"tp": (tpt["link_bytes"], rl.link_bw(tp_size, tp_stride))}
    if model.sp > 1:
        coll["sp"] = (tpt["sp_link_bytes"],
                      rl.link_bw(*_ring(mesh, "seq")))
    for a, b in fsdp_traffic(model, suite, comm_plan, mesh).items():
        coll[f"fsdp:{a}"] = (b, rl.link_bw(*_ring(mesh, a)))
    mf = model_flops_for(model.cfg, suite)
    roof = rl.analyze(mf / chips, mem["total"], coll, chips, mf)
    return {**roof.summary(), "hops": {k: v for k, v in tpt.items()
                                       if not k.endswith("_bytes")},
            "tp_packed_bytes": tpt["packed_bytes"]}


def _fmt_gb(b: float) -> str:
    return f"{b / 1e9:8.3f}"


def run_cell(arch: str, shape: str, mesh_kind: str, spec: str,
             out_dir: str | None = None, *, mode: str = "check", sp: int = 1,
             sp_mode: str = "ulysses") -> dict:
    cfg = get_config(arch)
    ok, reason = applicable(cfg, shape)
    suite = SHAPES[shape]
    if ok and sp > 1 and suite.kind != "train":
        ok, reason = False, ("--sp shards the train sequence axis; the "
                             "serve path decodes without one")
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "policy": spec,
           "mode": mode}
    if sp > 1:
        rec["sp"] = sp
    model = None
    if ok:
        try:
            mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                        sp=sp)
            model = cell_model(cfg, mesh)
        except NotImplementedError as e:       # refused by design
            ok, reason = False, f"not ported: {e}"
        except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
            rec.update({"status": "error", "error": f"{type(e).__name__}: "
                        f"{e}", "traceback": traceback.format_exc()})
    if not ok:
        rec.update({"status": "skipped", "reason": reason})
        print(f"SKIP  {arch:28s} {shape:12s} {mesh_kind:6s} — {reason}",
              flush=True)
    elif model is not None:
        try:
            t0 = time.time()
            if suite.seq_len % sp:
                raise ValueError(f"shape {shape} seq_len {suite.seq_len} "
                                 f"not divisible by sp={sp}")
            comm_plan = from_spec(spec)
            mem = memory(model, suite)
            verdict = "fits" if mem["total"] <= CARD_BYTES else "over"
            plan = model.plan
            rec.update({"status": "ok", "devices": math.prod(mesh.shape),
                        "mesh_shape": list(mesh.shape),
                        "comm_spec": to_spec(comm_plan), "sp": sp,
                        "sp_mode": sp_mode if sp > 1 else None,
                        "plan": {"tp": plan.tp, "fsdp": plan.fsdp,
                                 "heads_pad": plan.heads_pad,
                                 "kv_mode": plan.kv_mode,
                                 "vocab_pad": plan.vocab_pad},
                        "memory": mem, "card_bytes": CARD_BYTES,
                        "verdict": verdict,
                        "activations": "not estimated: chip_smoke.py "
                                       "phase 14 measures a step's peak"})
            parts = " ".join(f"{k}={_fmt_gb(v)}" for k, v in mem.items()
                             if k != "total")
            line = (f"OK    {arch:28s} {shape:12s} {mesh_kind:6s} "
                    f"{spec:12s} {parts} total={_fmt_gb(mem['total'])} GB "
                    f"of {CARD_BYTES / 1e9:.0f}: {verdict} (activations "
                    "not estimated)")
            if mode == "roofline":
                roof = roofline(model, suite, comm_plan, mesh, sp_mode)
                rec["roofline"] = roof
                line += (f" compute={roof['compute_s'] * 1e3:9.2f}ms "
                         f"memory={roof['memory_s'] * 1e3:9.2f}ms "
                         f"coll={roof['collective_s'] * 1e3:9.2f}ms "
                         f"dom={roof['dominant']}")
            rec["seconds"] = round(time.time() - t0, 3)
            print(line, flush=True)
        except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
            rec.update({"status": "error",
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()})
    if rec.get("status") == "error":
        print(f"ERROR {arch:28s} {shape:12s} {mesh_kind:6s} — "
              f"{rec['error'][:300]}", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        ptag = spec.replace(",", "+").replace("=", "-").replace(":", ".")
        fn = f"{arch}__{shape}__{mesh_kind}__{ptag}__{mode}.json"
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--comm-spec", default=None, dest="comm_spec",
                    help="compression plan spec or alias (default: taco)")
    add_policy_alias(ap)
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel axis size; carves a 'seq' axis "
                         "out of the data axis of the production mesh "
                         "(train shapes only)")
    ap.add_argument("--sp-mode", default="ulysses", dest="sp_mode",
                    choices=["ulysses", "ring"])
    ap.add_argument("--mode", default="check", choices=["check", "roofline"])
    ap.add_argument("--all", action="store_true",
                    help="every arch and shape not pinned by --arch / "
                         "--shape (the default when neither is given)")
    ap.add_argument("--out", default=None,
                    help="write one JSON record a cell into this directory")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    spec = resolve_comm_spec(args)
    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    results = [run_cell(arch, shape, mesh_kind, spec, args.out,
                        mode=args.mode, sp=args.sp, sp_mode=args.sp_mode)
               for mesh_kind in meshes for arch in archs for shape in shapes]
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skipped (spec), {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
