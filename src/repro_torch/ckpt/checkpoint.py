"""Fault-tolerant checkpointing — the JAX package's ``repro/ckpt/
checkpoint.py`` for torch tensors, with its layout on disk.

  * atomic commit: the leaves are written to ``step_XXXXXXXX.tmp``, each
    file fsync'd, the manifest written LAST, then the directory renamed —
    a crash mid-save never corrupts the latest checkpoint;
  * keep-last-k garbage collection;
  * mesh-independent layout: every leaf is a full (global, padded) array,
    so a restart may use another mesh; the caller cuts its shards;
  * the run's compression spec is persisted and checked on restore
    (:class:`CommSpecMismatch`).

One ``.npy`` per leaf, in the JAX package's pytree order (sorted dict keys,
list order), each manifest entry keyed by the leaf's path in
``jax.tree_util.keystr`` form (``['opt']['mu']['segments'][0]['attn']
['wq']``) with its dtype name and shape.  bf16 leaves are written with
numpy's ``'<V2'`` descriptor, as ``np.save`` writes an ``ml_dtypes``
bfloat16 array, and read back through their raw 16 bits: a checkpoint
written by either package restores in the other, and the two packages
write byte-identical files for the same state.  A Python int leaf (the
optimizer's step count) is saved as an int32 0-d array.
"""
from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.models.layers import tree_map

MANIFEST = "manifest.json"
#: the ``.npy`` descriptor numpy writes for an ml_dtypes bfloat16 array
BF16_DESCR = "<V2"


class CommSpecMismatch(ValueError):
    """Checkpoint was written under a different compression plan than the
    one the restoring run is configured with."""


def _leaf_paths(tree, path: str = "") -> list:
    """``(keystr, leaf)`` of every leaf of nested dicts / lists, in the JAX
    package's pytree order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaf_paths(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _leaf_paths(t, f"{path}[{i}]")]
    return [(path, tree)]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(host array, manifest dtype name); bf16 as its raw int16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy(), "bfloat16"
        arr = t.cpu().numpy()
    elif isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write(path: str, arr: np.ndarray, dtype: str) -> None:
    with open(path, "wb") as f:
        if dtype == "bfloat16":
            arr = np.ascontiguousarray(arr)
            np.lib.format.write_array_header_1_0(
                f, {"descr": BF16_DESCR, "fortran_order": False,
                    "shape": arr.shape})
            f.write(arr.data)
        else:
            np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())


def save(ckpt_dir: str, step: int, state, *, keep_last: int = 3,
         comm_spec: str | None = None) -> str:
    """``state``: nested dicts / lists of global tensors (any device),
    numpy arrays or ints.  ``comm_spec``: the run's normalized
    compression-plan spec (``core.registry.to_spec``), persisted in the
    manifest so a restore can check the restoring run's plan.  Returns the
    committed step directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    names = []
    for i, (name, leaf) in enumerate(_leaf_paths(state)):
        arr, dtype = _to_numpy(leaf)
        fn = f"leaf_{i:05d}.npy"
        _write(os.path.join(tmp, fn), arr, dtype)
        names.append({"key": name, "file": fn, "dtype": dtype,
                      "shape": list(arr.shape)})
    manifest = {"step": step, "time": time.time(), "leaves": names}
    if comm_spec is not None:
        manifest["comm_spec"] = comm_spec
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic commit
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, d, MANIFEST)):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _manifest(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", MANIFEST)) as f:
        return json.load(f)


def read_comm_spec(ckpt_dir: str, step: int | None = None) -> str | None:
    """The compression-plan spec a checkpoint was saved under (None for
    pre-spec checkpoints or when no checkpoint exists)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None
    try:
        return _manifest(ckpt_dir, step).get("comm_spec")
    except FileNotFoundError:
        return None


def leaf_keys(ckpt_dir: str, step: int | None = None) -> list[str]:
    """The manifest's leaf keys, in order (of the latest step by
    default)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    return [m["key"] for m in _manifest(ckpt_dir, step)["leaves"]]


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return "int32"


def _from_numpy(arr: np.ndarray, dtype: str):
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, template, step: int | None = None, *,
            device=None, prefix: str = "",
            expect_comm_spec: str | None = None):
    """Restore into the structure of ``template``: nested dicts / lists
    whose leaves are tensors (any device, ``meta`` included) giving each
    leaf's global shape and dtype, or ints (read back as ints).  Returns
    ``(tree, step)``; each tensor on ``device`` (default: the template
    leaf's).  ``prefix``: restore only the leaves whose key starts with
    it, the subtree at that path (``"['params']"`` of a trainer
    checkpoint).

    Raises ``ValueError`` on a leaf-count, key, shape or dtype mismatch,
    naming the first mismatching key.  ``expect_comm_spec``: when given AND
    the manifest recorded a spec, the two normalized specs must match —
    :class:`CommSpecMismatch` otherwise.  Checkpoints from before spec
    persistence restore without the check."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest = _manifest(ckpt_dir, step)
    saved_spec = manifest.get("comm_spec")
    if expect_comm_spec is not None and saved_spec is not None \
            and saved_spec != expect_comm_spec:
        raise CommSpecMismatch(
            f"checkpoint {d} was saved with comm spec {saved_spec!r} but "
            f"this run is configured with {expect_comm_spec!r}; pass the "
            "matching --comm-spec (or start a fresh run / resume=False)")
    metas = [m for m in manifest["leaves"] if m["key"].startswith(prefix)]
    flat = _leaf_paths(template)
    if len(flat) != len(metas):
        raise ValueError(f"checkpoint {d} has {len(metas)} leaves under "
                         f"{prefix!r}, the template {len(flat)}")
    out = []
    for meta, (key, tmpl) in zip(metas, flat):
        want = (prefix + key, _dtype_name(tmpl),
                list(tmpl.shape) if isinstance(tmpl, torch.Tensor) else [])
        got = (meta["key"], meta["dtype"], meta["shape"])
        if got != want:
            raise ValueError(f"checkpoint {d}: leaf {meta['key']} is "
                             f"(key, dtype, shape) {got}, the template "
                             f"wants {want}")
        arr = np.load(os.path.join(d, meta["file"]))
        if tuple(arr.shape) != tuple(meta["shape"]):
            raise ValueError(f"checkpoint {d}: {meta['file']} holds shape "
                             f"{arr.shape}, the manifest {meta['shape']}")
        if isinstance(tmpl, torch.Tensor):
            dev = tmpl.device if device is None else device
            out.append(_from_numpy(arr, meta["dtype"]).to(dev))
        else:
            out.append(int(arr))
    it = iter(out)
    return tree_map(lambda _: next(it), template), manifest["step"]

