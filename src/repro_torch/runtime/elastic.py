"""Elastic scaling: restart a run on another mesh — the JAX package's
``repro/runtime/elastic.py`` for the port's meshes.

The checkpoint layout is mesh-independent (one global tensor per leaf), so
elasticity reduces to (1) checking that the new mesh keeps the model's
padding-relevant plan dimensions, and (2) cutting each rank's shards from
the global tensors (``Trainer.try_restore``, ``Model.cut_params``).

Compatible reshapes (no tensor surgery needed):
  * any change of the (pod, data) split at fixed tp — fsdp shards are
    storage-only;
  * tp changes that keep the SAME RunPlan paddings (heads_pad, vocab_pad,
    kv layout).
Incompatible reshapes (padded dims change) need a reshape step, which
``replan`` reports instead of corrupting weights.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, RunPlan, make_plan


@dataclasses.dataclass(frozen=True)
class ReshardReport:
    ok: bool
    reason: str
    old_plan: RunPlan
    new_plan: RunPlan


def replan(cfg: ArchConfig, old_plan: RunPlan, new_tp: int,
           new_fsdp: int, **kw) -> ReshardReport:
    """Check whether a checkpoint written under ``old_plan`` can be
    restored onto a (new_tp, new_fsdp) mesh without tensor surgery."""
    new_plan = make_plan(cfg, new_tp, new_fsdp, **kw)
    mismatches = []
    for field in ("heads_pad", "kv_mode", "kv_pad", "vocab_pad"):
        a, b = getattr(old_plan, field), getattr(new_plan, field)
        if a != b:
            mismatches.append(f"{field}: {a} -> {b}")
    if mismatches:
        return ReshardReport(
            False,
            "padded parameter shapes change; run a reshape pass first: "
            + "; ".join(mismatches),
            old_plan, new_plan)
    return ReshardReport(True, "compatible (storage resharding only)",
                         old_plan, new_plan)


def elastic_restore(trainer_cls, model_factory, cfg, old_plan, mesh,
                    comm_plan, *args, **kwargs):
    """Check the reshape and construct a trainer bound to the new mesh (a
    ``launch.mesh.Mesh``): ``model_factory(cfg, new_plan, mesh)`` builds
    this rank's model, the trainer gets ``mesh.parallel_ctx(comm_plan)``
    and ``args`` / ``kwargs`` after it.  Raises on incompatible
    reshapes."""
    from repro_torch.launch.mesh import mesh_axis_info
    _, _, tp, fsdp = mesh_axis_info(mesh)
    report = replan(cfg, old_plan, tp, fsdp)
    if not report.ok:
        raise ValueError(f"elastic restart rejected: {report.reason}")
    model = model_factory(cfg, report.new_plan, mesh)
    return trainer_cls(model, mesh.parallel_ctx(comm_plan), *args, **kwargs)
