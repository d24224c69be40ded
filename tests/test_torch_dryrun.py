"""The port's dry run (``launch/dryrun.py``), roofline (``launch/
roofline.py``), ``make_production_mesh`` and ``abstract_opt_state``
against the JAX package: rank 0's parameter, optimizer-state and cache
bytes of every ``ASSIGNED`` arch x applicable shape x both production
meshes equal those computed from the JAX ``Model.abstract_params()`` /
``partition_specs()`` (and ``cache_shapes`` / ``cache_pspecs``) and the
mesh's axis sizes — pure arithmetic, no device; ``model_flops_for``
equals the JAX function; the ``Roofline`` arithmetic as
``tests/test_dryrun.py::test_roofline_terms_math`` checks it; and the
counted bytes equal what the port allocates at smoke size on the CPU."""
import dataclasses
import math
import os

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro.serve import serve_step as jss
from repro_torch import configs as tconfigs
from repro_torch.core.registry import from_spec
from repro_torch.launch import dryrun, roofline as rl
from repro_torch.launch.mesh import (AXES, SP_AXES, Mesh,
                                     make_production_mesh, mesh_axis_info)
from repro_torch.optim import adamw as tadamw
from repro_torch.serve import serve_step as tss
from test_torch_dist import one_thread  # noqa: F401  (autouse)

#: the JAX production meshes' axis sizes (``make_production_mesh``:
#: (16, 16) over data, model; (2, 16, 16) over pod, data, model)
JAX_MESH = {"single": {"data": 16, "model": 16},
            "multi": {"pod": 2, "data": 16, "model": 16}}


def jax_model_flops_for():
    """The JAX dry run's ``model_flops_for``.  Importing that module sets
    XLA_FLAGS to 512 host devices for the next backend start, so the
    backend is started first (this process keeps its devices) and the
    variable is put back."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import model_flops_for
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return model_flops_for


def _local_bytes(shape, dtype, pspec, sizes) -> int:
    """Bytes of rank 0's shard of a global array under ``pspec``."""
    n = math.prod(shape)
    for entry in pspec:
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                n //= sizes[axis]
    return n * np.dtype(dtype).itemsize


def jax_rank0_bytes(arch, shape, mesh_kind) -> dict:
    """Rank 0's bytes from the JAX package's abstract arrays and
    partition specs."""
    from jax.sharding import PartitionSpec as P
    sizes = JAX_MESH[mesh_kind]
    cfg = jconfigs.get_config(arch)
    fsdp_axes = tuple(a for a in sizes if a != "model")
    plan = jconfigs.make_plan(cfg, sizes["model"],
                              math.prod(sizes[a] for a in fsdp_axes))
    model = JModel(cfg, plan, fsdp_axes=fsdp_axes, tp_axis="model")
    suite = jconfigs.SHAPES[shape]
    leaves = jax.tree_util.tree_leaves

    def total(tree, specs):
        return sum(_local_bytes(a.shape, a.dtype, p, sizes) for a, p in zip(
            leaves(tree), leaves(specs, is_leaf=lambda x: isinstance(x, P)),
            strict=True))

    params = model.abstract_params()
    pspecs = model.partition_specs()
    out = {"params": total(params, pspecs)}
    if suite.kind == "train":
        out["opt_state"] = total(jadamw.abstract_opt_state(params),
                                 jadamw.opt_state_pspecs(pspecs))
    else:
        cspecs = jss.cache_pspecs(model)
        if suite.global_batch % plan.fsdp:       # replicated, as the dry run
            cspecs = jax.tree_util.tree_map(
                lambda s: P(*((s[0], None) + tuple(s[2:]))), cspecs,
                is_leaf=lambda s: isinstance(s, P))
        out["cache"] = total(
            jss.cache_shapes(model, suite.global_batch, suite.seq_len),
            cspecs)
    return out


def _cells():
    for arch in jconfigs.ASSIGNED:
        for shape, ok, _ in jconfigs.cells(jconfigs.get_config(arch)):
            if ok:
                yield arch, shape


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", jconfigs.ASSIGNED)
def test_rank0_bytes_equal_the_references(arch, mesh_kind):
    """Params, AdamW state (the JAX step's int32 scalar aside: the port
    keeps the step on the host) and cache of every applicable shape."""
    cfg = tconfigs.get_config(arch)
    for a, shape in _cells():
        if a != arch:
            continue
        model = dryrun.cell_model(cfg, make_production_mesh(
            multi_pod=mesh_kind == "multi"))
        got = dryrun.memory(model, tconfigs.SHAPES[shape])
        want = jax_rank0_bytes(arch, shape, mesh_kind)
        assert got["params"] == want["params"], shape
        if "opt_state" in want:
            assert got["grads"] == got["params"]
            assert got["opt_state"] == want["opt_state"] - 4, shape
        else:
            assert got["cache"] == want["cache"], shape
        assert got["total"] == sum(v for k, v in got.items()
                                   if k != "total")


@pytest.mark.parametrize("arch", jconfigs.ASSIGNED)
def test_model_flops_for_equals_the_reference(arch):
    jflops = jax_model_flops_for()
    for shape in tconfigs.SHAPES:
        assert dryrun.model_flops_for(tconfigs.get_config(arch),
                                      tconfigs.SHAPES[shape]) == \
            jflops(jconfigs.get_config(arch), jconfigs.SHAPES[shape])


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("sp", [1, 2, 4])
def test_production_mesh(multi, sp):
    """The JAX package's production shapes, the pod axis of one rank made
    explicit on the single-pod mesh; ``sp`` carved out of data."""
    mesh = make_production_mesh(multi_pod=multi, sp=sp)
    pod = 2 if multi else 1
    if sp == 1:
        assert (mesh.shape, mesh.axes) == ((pod, 16, 16), AXES)
    else:
        assert (mesh.shape, mesh.axes) == ((pod, 16 // sp, sp, 16), SP_AXES)
    assert mesh.rank == 0 and set(mesh.groups.values()) == {None}
    assert mesh_axis_info(mesh)[2:] == (16, pod * 16 // sp)
    with pytest.raises(ValueError, match="does not divide"):
        make_production_mesh(multi_pod=multi, sp=3)


def test_abstract_opt_state_is_init_opt_states_shapes():
    """Meta tensors of the shapes and f32 dtype of ``init_opt_state``'s
    state, nothing allocated; the JAX package's state minus its step."""
    cfg = tconfigs.smoke_config(tconfigs.get_config("qwen2-0.5b"))
    model = dryrun.cell_model(cfg, Mesh())
    params = model.init(0)
    real = tadamw.init_opt_state(params)
    abstract = tadamw.abstract_opt_state(params)
    assert abstract["step"] == real["step"] == 0
    for key in ("master", "mu", "nu"):
        for a, r in zip(tadamw.leaves(abstract[key]),
                        tadamw.leaves(real[key]), strict=True):
            assert a.device.type == "meta" and a.shape == r.shape
            assert a.dtype == r.dtype == torch.float32
    jcfg = jconfigs.smoke_config(jconfigs.get_config("qwen2-0.5b"))
    jst = jadamw.abstract_opt_state(
        JModel(jcfg, jconfigs.make_plan(jcfg, 1, 1)).abstract_params())
    assert [tuple(a.shape) for a in tadamw.leaves(abstract["master"])] == \
        [tuple(a.shape) for a in jax.tree_util.tree_leaves(jst["master"])]


def _storage(tree) -> int:
    seen = {}
    for t in tadamw.leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "hymba-1.5b",
                                  "whisper-small"])
def test_counted_bytes_are_the_allocated_storage(arch):
    """At smoke size on the CPU, the check's params + AdamW bytes equal the
    storage of ``Model.init`` and ``init_opt_state``, and its cache bytes
    the storage of ``serve_step.init_cache`` (what ``chip_smoke.py`` phase
    14a holds on the card at full width)."""
    cfg = tconfigs.smoke_config(tconfigs.get_config(arch))
    model = dryrun.cell_model(cfg, Mesh())
    train = tconfigs.ShapeSuite("t", 64, 2, "train")
    decode = tconfigs.ShapeSuite("d", 64, 2, "decode")
    mem = dryrun.memory(model, train)
    params = model.init(0)
    assert mem["params"] == _storage(params)
    assert mem["opt_state"] == _storage(tadamw.init_opt_state(params))
    assert dryrun.memory(model, decode)["cache"] == \
        _storage(tss.init_cache(model, 2, 64))


def test_roofline_terms_math():
    """1 TFLOP, 1 GB of HBM and 100 MB over a 50 GB/s link on 4 chips."""
    roof = rl.analyze(1e12, 1e9, {"tp": (1e8, 50e9)}, 4, model_flops=2e12)
    assert abs(roof.compute_s - 1e12 / rl.PEAK_FLOPS) < 1e-9
    assert abs(roof.memory_s - 1e9 / rl.HBM_BW) < 1e-9
    assert abs(roof.collective_s - 1e8 / 50e9) < 1e-12
    assert roof.dominant == "collective"
    assert (roof.flops, roof.hbm_bytes, roof.collective_bytes) == \
        (4e12, 4e9, 4e8)
    assert roof.useful_ratio is None and roof.model_flops == 2e12
    assert roof.summary()["coll_by_kind"] == {"tp": 1e8}


def test_roofline_constants_are_derived():
    """Each constant from its factors: 132 SMs x 4096 dense bf16 FLOP a
    clock x 1.83 GHz is the published 989.4 TFLOP/s; a 5120-bit bus at
    2 x 2.619 GHz is the data sheet's 3.35 TB/s within 0.1% (the kernel
    bounds of ``chip_smoke.py``); 128 f32 lanes x 2 at 1.98 GHz its 67
    TFLOP/s within 0.2%."""
    assert abs(rl.PEAK_FLOPS / 989.4e12 - 1) < 1e-4
    assert abs(rl.HBM_BW / 3.35e12 - 1) < 1e-3
    assert abs(rl.F32_FLOPS / 67e12 - 1) < 2e-3
    assert (rl.NVLINK_BW, rl.NET_BW) == (450e9, 50e9)
    assert rl.link_bw(8) == rl.link_bw(2, 4) == rl.NVLINK_BW
    assert rl.link_bw(16) == rl.link_bw(16, 16) == rl.link_bw(2, 256) == \
        rl.NET_BW
    assert rl.link_bw(1) == float("inf")


def test_cli_check_all_cells():
    """The acceptance command: every cell checked or skipped, no error,
    exactly the cells the JAX ``applicable`` skips reported as skipped."""
    recs = []
    for mesh_kind in ("single", "multi"):
        for arch in tconfigs.ASSIGNED:
            for shape in tconfigs.SHAPES:
                recs.append(dryrun.run_cell(arch, shape, mesh_kind, "taco"))
    skipped = {(r["arch"], r["shape"]) for r in recs
               if r["status"] == "skipped"}
    want = {(a, s) for a in jconfigs.ASSIGNED
            for s, ok, _ in jconfigs.cells(jconfigs.get_config(a)) if not ok}
    assert skipped == want
    assert all(r["status"] in ("ok", "skipped") for r in recs)
    assert all(r["verdict"] == "fits" for r in recs if r["status"] == "ok")


def test_cli_main_prints_the_summary(capsys, tmp_path):
    assert dryrun.main(["--arch", "rwkv6-1.6b", "--mesh", "both", "--out",
                        str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "== dry-run: 8 ok, 0 skipped (spec), 0 errors" in out
    assert len(list(tmp_path.iterdir())) == 8
    with pytest.warns(DeprecationWarning):
        assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k",
                            "--policy", "baseline", "--mode",
                            "roofline"]) == 0
    out = capsys.readouterr().out
    assert "baseline" in out and "dom=collective" in out


def test_roofline_shows_the_saved_tp_bytes():
    """On the production mesh every compressed TP hop sends the codec's
    bytes: TACO's dual wire over bf16 is (1 + 8/256) / 2 of the baseline's
    link bytes a step, SDP4bit's gradient reduce-scatters fewer bytes than
    raw, and the 16-wide model axis crosses the node's network."""
    cfg = tconfigs.get_config("qwen2-0.5b")
    suite = tconfigs.SHAPES["train_4k"]
    mesh = make_production_mesh()
    model = dryrun.cell_model(cfg, mesh)
    base = dryrun.roofline(model, suite, from_spec("baseline"), mesh)
    taco = dryrun.roofline(model, suite, from_spec("taco"), mesh)
    dp = dryrun.roofline(model, suite, from_spec("tp=taco,grad_rs=sdp4bit"),
                         mesh)
    assert taco["coll_by_kind"]["tp"] / base["coll_by_kind"]["tp"] == \
        (1 + 8 / 256) / 2
    assert dp["coll_by_kind"]["fsdp:data"] < base["coll_by_kind"]["fsdp:data"]
    assert base["coll_s_by_kind"]["tp"] == \
        base["coll_by_kind"]["tp"] / rl.NET_BW
    assert base["hops"]["all_gather"] == taco["hops"]["all_gather"] == 146
    assert base["hops"]["compressed"] == {"all_gather": 0,
                                         "reduce_scatter": 0}
    assert taco["useful_ratio"] is None
    assert taco["compute_s"] == dryrun.model_flops_for(cfg, suite) / 256 \
        / rl.PEAK_FLOPS


@pytest.mark.parametrize("sp_mode", ["ulysses", "ring"])
def test_roofline_at_sp(sp_mode):
    """A seq axis of 2: the sp hops run and move bytes over their ring."""
    cfg = tconfigs.get_config("qwen2-0.5b")
    mesh = make_production_mesh(sp=2)
    model = dryrun.cell_model(cfg, mesh)
    r = dryrun.roofline(model, tconfigs.SHAPES["train_4k"],
                        from_spec("tp=taco,sp=taco:folded"), mesh, sp_mode)
    kind = "all_to_all" if sp_mode == "ulysses" else "permute"
    assert r["hops"][kind] == 24 * 2 * 3 // (1 if sp_mode == "ulysses"
                                             else 2)
    assert r["coll_by_kind"]["sp"] > 0


def test_one_rank_traffic_is_phase_3s_launches():
    """qwen2-0.5b at 12 layers, batch 4 x 2048 on one rank under taco (the
    cell ``chip_smoke.py`` phase 3 trains): 74 all-gathers and 62
    reduce-scatters a step (its 74 K3 and 62 K4 launches, 136 K1), each
    packing 7,340,032 elements at the trainer's ``comm/tp_fwd_bytes_per_
    elem``, and nothing sent."""
    cfg = dataclasses.replace(tconfigs.get_config("qwen2-0.5b"), n_layers=12)
    mesh = Mesh()
    model = dryrun.cell_model(cfg, mesh)
    plan = from_spec("taco")
    t = dryrun.tp_traffic(model, tconfigs.ShapeSuite("p3", 2048, 4, "train"),
                          plan, mesh)
    assert (t["all_gather"], t["reduce_scatter"]) == (74, 62)
    assert t["compressed"] == {"all_gather": 74, "reduce_scatter": 62}
    n = 4 * 2048 * 896
    assert t["packed_bytes"] == \
        136 * n * plan.wire_bytes_per_element()["tp_fwd"]
    assert t["link_bytes"] == 0


# --------------------------------------------------------------------------
# the other public names this slice gives a twin
# --------------------------------------------------------------------------

def test_abstract_params_are_the_references_global_shapes():
    """``Model.abstract_params``: the JAX package's global (padded) shapes,
    bf16, on the ``meta`` device."""
    cfg = tconfigs.get_config("hymba-1.5b")
    model = dryrun.cell_model(cfg, make_production_mesh(multi_pod=True))
    jcfg = jconfigs.get_config("hymba-1.5b")
    jm = JModel(jcfg, jconfigs.make_plan(jcfg, 16, 32))
    got = tadamw.leaves(model.abstract_params())
    want = jax.tree_util.tree_leaves(jm.abstract_params())
    assert [tuple(a.shape) for a in got] == [tuple(a.shape) for a in want]
    assert {(a.device.type, a.dtype) for a in got} == \
        {("meta", torch.bfloat16)}


def test_format_name_and_layer_plans_are_the_references():
    import typing

    from repro.core import quant as jquant
    from repro.core import registry as jreg
    from repro_torch.core import quant as tquant
    from repro_torch.core import registry as treg
    assert typing.get_args(tquant.FormatName) == \
        typing.get_args(jquant.FormatName)
    spec = "tp=taco:folded,skip_first=2,skip_last=1"
    got = treg.from_spec(spec).layer_plans(6)
    want = jreg.from_spec(spec).layer_plans(6)
    assert [treg.to_spec(p) for p in got] == [jreg.to_spec(p) for p in want]
    assert [p.tp_identity for p in got] == [True, True, False, False,
                                            False, True]


def test_extract_slot_copies_one_row_of_the_cache():
    """``ServeEngine.extract_slot``: every leaf's rows of one slot, as the
    JAX engine's one-row view of its paged cache."""
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.serve.engine import ServeEngine
    cfg = tconfigs.smoke_config(tconfigs.get_config("rwkv6-1.6b"))
    model = dryrun.cell_model(cfg, Mesh())
    eng = ServeEngine(model, ParallelCtx(plan=from_spec("baseline")),
                      model.init(0), max_batch=3, max_len=16, device="cpu")
    req = eng.submit(np.arange(5, dtype=np.int32), max_new=4)
    while not req.tokens:                   # prefilled and installed
        eng.tick()
    row = eng.extract_slot(req.slot)
    assert len(row) == len(eng.cache)
    for seg, full in zip(row, eng.cache):
        assert seg.keys() == full.keys()
        for k, v in seg.items():
            assert v.shape[1] == 1
            assert torch.equal(v, full[k][:, req.slot:req.slot + 1])
            assert v.data_ptr() != full[k].data_ptr()
