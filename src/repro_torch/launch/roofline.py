"""Roofline terms of one NVIDIA H100 SXM rank — the twin of the JAX
package's ``launch/roofline.py``, whose constants are a TPU v5e's.

Three terms per (arch x shape x mesh), in seconds, each per rank:

    compute    = FLOPs            / PEAK_FLOPS (dense bf16 tensor cores)
    memory     = HBM bytes        / HBM_BW
    collective = link bytes       / the link rate of the group's hops

The JAX package reads FLOPs and bytes from an XLA ``Compiled``
(``cost_analysis``) and the collective bytes from its HLO text
(``parse_collectives``).  PyTorch compiles nothing ahead of the run, so
:func:`analyze` takes per-rank counts instead: the dry run
(``launch/dryrun.py``) counts the model's FLOPs, the persistent bytes a
step reads and the port's own wire accounting of every hop.  There is no
HLO to parse, so ``parse_collectives`` has no twin.

Every constant is derived below from its factors, not copied from a data
sheet's bottom line.  Sources: NVIDIA H100 Tensor Core GPU Architecture
whitepaper (Hopper whitepaper) for the SM count, the per-SM rates, the
memory interface and NVLink 4; NVIDIA DGX H100 / HGX H100 system
documentation for one 400 Gb/s ConnectX-7 NIC per GPU.
"""
from __future__ import annotations

import dataclasses

#: streaming multiprocessors of the H100 SXM5 (Hopper whitepaper)
SMS = 132
#: dense bf16 FLOP per SM per clock: 4 fourth-generation tensor cores an
#: SM, each 512 dense FP16/BF16 FMAs (1,024 FLOPs) a clock, twice the A100
#: SM's rate clock for clock (Hopper whitepaper)
BF16_FLOP_PER_SM_CLOCK = 4 * 512 * 2
#: the SM clock behind NVIDIA's published dense bf16 peak (989.4 TFLOP/s =
#: 132 x 4096 x 1.830 GHz).  It is NOT the maximum SM clock that
#: ``nvidia-smi --query-gpu=clocks.max.sm`` reports for the part (1980
#: MHz): the tensor-core peak is quoted at this lower boost clock.
TENSOR_CLOCK_HZ = 1830e6
#: dense bf16 FLOP/s: 132 x 4096 x 1.830e9 = 9.894e14
PEAK_FLOPS = SMS * BF16_FLOP_PER_SM_CLOCK * TENSOR_CLOCK_HZ

#: f32 FLOP/s outside the tensor cores: 128 FP32 lanes an SM, an FMA (2
#: FLOPs) each a clock, at the 1980 MHz maximum SM clock: 132 x 128 x 2 x
#: 1.98e9 = 6.69e13 (the data sheet's 67 TFLOP/s, which ``chip_smoke.py``
#: bounds the kernels with)
F32_FLOPS = SMS * 128 * 2 * 1980e6

#: HBM3 of the 80 GB part: five stacks on ten 512-bit controllers, a
#: 5,120-bit bus (Hopper whitepaper), at a 2,619 MHz memory clock, double
#: data rate (``nvidia-smi --query-gpu=clocks.max.memory`` reads the
#: clock): 5120 / 8 x 2 x 2.619e9 = 3.352e12 B/s.  ``chip_smoke.py`` bounds
#: the kernels at the data sheet's 3.35 TB/s, 0.07% below.
HBM_BW = 5120 / 8 * 2 * 2619e6

#: NVLink 4 inside one 8-GPU HGX node: 18 links a GPU at 25 GB/s each way
#: (Hopper whitepaper: 900 GB/s both ways), 450 GB/s each way through the
#: NVSwitches to any other GPU of the node
NVLINK_BW = 18 * 25e9
#: across nodes: one 400 Gb/s ConnectX-7 NIC a GPU (DGX H100), 50 GB/s
#: each way
NET_BW = 400e9 / 8
#: GPUs of one HGX node that NVLink joins
GPUS_PER_NODE = 8


def link_bw(size: int, stride: int = 1) -> float:
    """Bytes/s each way a rank of a ring over ``size`` ranks gets, the
    ranks ``stride`` apart in the mesh's row-major rank order: NVLink 4
    when the whole group lies inside one 8-GPU node, else the node's
    network, since a ring over nodes moves every chunk across the slowest
    hop at its rate.  On the 256 / 512-rank production meshes a 16-wide
    model axis spans two nodes, and the data and pod axes (stride 16)
    cross nodes at every hop."""
    if size <= 1:
        return float("inf")
    within = (size - 1) * stride < GPUS_PER_NODE and \
        GPUS_PER_NODE % (size * stride) == 0
    return NVLINK_BW if within else NET_BW


@dataclasses.dataclass
class Roofline:
    """The JAX package's fields.  ``flops``, ``hbm_bytes`` and
    ``collective_bytes`` are totals over the ``chips`` ranks; the three
    times are per rank.  ``useful_ratio`` (model FLOPs over compiled
    FLOPs) is None: nothing is compiled ahead of the run."""

    flops: float
    hbm_bytes: float
    collective_bytes: float
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float | None
    collectives: dict            # kind -> {"bytes": per rank, "s": seconds}

    def summary(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes, "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "coll_by_kind": {k: v["bytes"] for k, v in
                             self.collectives.items()},
            "coll_s_by_kind": {k: v["s"] for k, v in
                               self.collectives.items()},
        }


def analyze(flops: float, hbm_bytes: float, collectives: dict,
            n_devices: int, model_flops: float) -> Roofline:
    """The roofline of one step from per-rank counts: ``flops`` and
    ``hbm_bytes`` of one rank, and ``collectives`` mapping a kind to
    ``(link bytes a rank sends, link bytes/s)``; the collective term is
    the sum of each kind's bytes over its rate (kinds run one after
    another, as the hops of a step do)."""
    coll = {k: {"bytes": float(b), "s": float(b) / bw}
            for k, (b, bw) in collectives.items()}
    link = sum(v["bytes"] for v in coll.values())
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm_bytes / HBM_BW
    collective_s = sum(v["s"] for v in coll.values())
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return Roofline(flops * n_devices, hbm_bytes * n_devices,
                    link * n_devices, n_devices, compute_s, memory_s,
                    collective_s, dominant, model_flops, None, coll)
