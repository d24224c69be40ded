"""The comparison that decides ``correct``.

Both sides give, for the first steps of the same weights on the same
batches: each step's loss, each parameter's norm of the first step's
gradient as AdamW's first moment took it, each parameter's norm of its
change over the steps (``reference/train.py``), and three TP hops of the
last step, each its input and output (``reference/taco.py`` ``Tap``: the
final norm's entry, its cotangent, the embedding's cotangent).  These
numbers are read, and each that has a limit in ``limits/<cell>.json`` is
compared with it:

- ``loss_gap``: the largest ``|loss - loss_ref| / loss_ref`` of the
  steps (a cell may leave it out of its limits: read, not compared);
- ``grad_gap``: the worst parameter's ``|norm - norm_ref|``, over the
  larger of its reference norm and the median parameter's;
- ``change_gap``: the same of the change;
- ``act_gap``: the worst of the three hops' ``|x - x_ref| / |x_ref|``,
  the side's hop input against the reference's, element by element: the
  activations after every layer and the cotangents after the whole
  backward, at a step whose weights have moved;
- ``hop_gap`` (a cell whose hops run a codec): the worst of the three
  hops' ``|y - rt(x)| / |x - rt(x)|``, the side's hop output against the
  reference's round trip ``rt`` of the side's own hop input (rounded to
  bf16, the cells' activation dtype, in the numerator): 0 for the plain
  version's round trip, about 1 for a hop whose codec is left out or
  whose output is carried in e4m3.

``grad_gap`` and ``change_gap`` leave out the parameters whose reference
gradient is under a thousandth of the median parameter's: a key's bias,
under the softmax, has a gradient of zero to rounding, so its norm is
attention's rounding error and AdamW moves it by rounding alone.
"""
from __future__ import annotations

import math
import statistics

import torch

from perfbench.reference import taco

#: every number that ``gaps`` reads (``hop_gap`` under a codec only)
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "act_gap", "hop_gap")
#: the dtype in which every cell's configuration carries its activations
ACT_DTYPE = torch.bfloat16
#: parameters whose reference gradient is below this share of the median
#: parameter's are left out of ``grad_gap`` and ``change_gap``
GRAD_FLOOR = 1e-3


def _worst(prog: dict, ref: dict, keep) -> tuple[float, str]:
    med = statistics.median(ref[k] for k in keep)
    worst, where = 0.0, ""
    for k in keep:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, where = gap, k
    return worst, where


def _worse(new: float, old: float) -> bool:
    """``new`` is the worse reading: larger, or NaN (which stays)."""
    return math.isnan(new) or (not math.isnan(old) and new > old)


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def hop_numbers(prog: dict, ref: dict, codec: dict) -> dict:
    """``act_gap`` and, under a codec, ``hop_gap``, each ``(value,
    where)``: the worst of the three hops, inf where a side lacks one or
    its shape differs from the reference's."""
    act = hop = (-math.inf, "")
    for name in taco.Tap.NAMES:
        if name not in prog or name not in ref:
            return {"act_gap": (math.inf, name),
                    "hop_gap": (math.inf, name)}
        xr = ref[name][0]
        x, y, first = (t.to(xr.device) if torch.is_tensor(t) else t
                       for t in prog[name])
        a = _norm(x.float() - xr.float()) / max(_norm(xr), 1e-30) \
            if x.shape == xr.shape else math.inf
        if _worse(a, act[0]):
            act = (a, name)
        if codec["kind"] != "identity":
            rt = taco.round_trip(x, codec, first)
            h = _norm(y.float() - rt.to(ACT_DTYPE).float()) / \
                max(_norm(x.float() - rt), 1e-30)
            if _worse(h, hop[0]):
                hop = (h, name)
    out = {"act_gap": act}
    if codec["kind"] != "identity":
        out["hop_gap"] = hop
    return out


def gaps(prog: dict, ref: dict, codec: dict) -> dict:
    """``{number: (value, where)}`` of the numbers read; ``codec`` is the
    cell's hop codec."""
    loss = max((abs(a - b) / abs(b) if math.isfinite(a) else math.inf,
                f"step {i}")
               for i, (a, b) in enumerate(zip(prog["loss"], ref["loss"])))
    if set(prog["grad"]) != set(ref["grad"]):
        raise ValueError("the program's parameters are not the reference's")
    names = sorted(ref["grad"])
    med = statistics.median(ref["grad"][k] for k in names)
    moved = [k for k in names if ref["grad"][k] >= GRAD_FLOOR * med]
    return {"loss_gap": loss,
            "grad_gap": _worst(prog["grad"], ref["grad"], moved),
            "change_gap": _worst(prog["change"], ref["change"], moved),
            **hop_numbers(prog["hops"], ref["hops"], codec)}


def judge(prog: dict, ref: dict, limits: dict,
          codec: dict) -> tuple[bool, dict, dict]:
    """(correct, compared, read): ``compared`` the numbers that have a
    limit, ``{number: {"value", "limit", "where"}}``, correct when each is
    at most its limit; ``read`` the others, ``{number: (value, where)}``,
    which no fault or control separates from sound runs and which are
    therefore not compared."""
    compared, read, ok = {}, {}, True
    numbers = gaps(prog, ref, codec)
    for name in limits:
        numbers.setdefault(name, (math.inf, "not read"))
    for name, (value, where) in numbers.items():
        if name not in limits:
            read[name] = (value, where)
            continue
        compared[name] = {"value": value, "limit": limits[name],
                          "where": where}
        ok = ok and value <= limits[name]
    return ok, compared, read
