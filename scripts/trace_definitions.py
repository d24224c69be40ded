"""What a profiler trace counts as device time, two ways, over the same
calls: the device-only trace that ``chip_smoke.py`` takes
(``ProfilerActivity.CUDA``) and a host-and-device trace (``CPU`` and
``CUDA``).  The calls: SDP4bit weight-gradient reduce-scatters over the
pod mesh's 1-rank NCCL groups (the hop ``chip_smoke.py`` phase 6
replays), and an all-gather, a reduce-scatter and an all-reduce of
``torch.distributed`` over a 1-rank NCCL group.

Prints, per definition and per call, every device-side event name with
its count, its total ms and whether the profiler marks it a user
annotation (a host range drawn on the device's timeline), then one JSON
line of the totals with and without annotations.  Needs one card.

    python3 scripts/trace_definitions.py
"""
from __future__ import annotations

import json
import pathlib
import socket
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

N = 1 << 24          # elements a call: 32 MiB of bf16


def _events(fn, activities) -> dict:
    """(name, is annotation) -> (count, total ms) of the device-side
    events of one call of ``fn``, after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        key = (e.name[:72], bool(getattr(e, "is_user_annotation", False)))
        n, ms = out.get(key, (0, 0.0))
        out[key] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("trace_definitions: no CUDA device")
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity

    from repro_torch.core import collectives as cc
    from repro_torch.core.codecs import Sdp4BitCodec
    from repro_torch.launch.mesh import init_mesh
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mesh = init_mesh((1, 1, 1), "cuda", init_method=f"tcp://127.0.0.1:{port}",
                     world_size=1, rank=0)
    g = mesh.groups["model"]
    x = torch.randn((N // 2560, 2560), device="cuda", dtype=torch.bfloat16)
    out = torch.empty_like(x)
    codec = Sdp4BitCodec()
    calls = {
        "sdp4bit rs (pod, data)": lambda: [
            cc._rs_impl(x, mesh.fsdp_groups, 0, codec) for _ in range(4)],
        "all_gather_into_tensor": lambda: [
            dist.all_gather_into_tensor(out, x, group=g) for _ in range(4)],
        "reduce_scatter_tensor": lambda: [
            dist.reduce_scatter_tensor(out, x, group=g) for _ in range(4)],
        "all_reduce": lambda: [dist.all_reduce(x, group=g) for _ in range(4)],
    }
    defs = {"device only": [ProfilerActivity.CUDA],
            "host and device": [ProfilerActivity.CPU, ProfilerActivity.CUDA]}
    totals = {}
    for call, fn in calls.items():
        for name, acts in defs.items():
            ev = _events(fn, acts)
            every = sum(ms for _, ms in ev.values())
            marks = sum(ms for (_, ann), (_, ms) in ev.items() if ann)
            totals[f"{call} | {name}"] = {"device_ms": every,
                                          "annotation_ms": marks,
                                          "without_annotations_ms":
                                              every - marks}
            print(f"{call} | {name}: {every:.4f} ms in all, "
                  f"{marks:.4f} ms in annotations")
            for (ev_name, ann), (n, ms) in sorted(ev.items(),
                                                  key=lambda kv: -kv[1][1]):
                print(f"    {ms:10.4f} ms  x{n:<4d} "
                      f"{'annotation ' if ann else ''}{ev_name}")
    dist.destroy_process_group()
    print(json.dumps(totals))


if __name__ == "__main__":
    main()
