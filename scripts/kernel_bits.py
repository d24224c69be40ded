"""The TACO kernels' outputs on fixed inputs, to hold two checkouts (a
kernel before and after a redesign) to the same bits.

    python3 scripts/kernel_bits.py save OUT.pt [CHECKOUT]    # on a card
    python3 scripts/kernel_bits.py compare A.pt B.pt
    python3 scripts/kernel_bits.py views                     # on a card

``save`` runs K1 to K6 of CHECKOUT (a checkout of the repo, built there
by its own ``kernels/build.py``; by default the one the script lies in)
on seeded inputs (every block size the kernels are built for under both
compute dtypes and both metadata layouts, the other payload formats,
group sizes from 1 to 128) and saves their outputs.  It also prints how
many payload codes K2 flips against the plain version on 4 Mi elements at
B = 32, 64 and 256, the rate the parity rule of
``repro_torch.kernels.ref`` allows for.  ``compare`` holds two such files
bit for bit, the sign of zero included.  ``views`` runs K5 and K6 of the
checkout the script lies in on copies of each spec's wire that are views
at byte offsets 1, 2 and 3 of a larger buffer, and fails unless each
output equals the one on the aligned wire bit for bit.
"""
from __future__ import annotations

import pathlib
import sys

import torch

SPECS = ([f"taco:b{b}{cd}{m}" for b in (32, 64, 128, 256, 512)
          for cd in ("", ":cdbfloat16") for m in ("", ":folded")]
         + ["taco:e5m2", "taco:int8", "taco:g1", "taco:g4",
            "taco:g64:folded", "taco:int8:g128", "taco:e5m2:g16:folded"])


SLOTS, N = 3, 512 * 24


def _use(checkout: str | None = None) -> None:
    """Import the port from CHECKOUT (default: this one); needs a card."""
    root = pathlib.Path(checkout or pathlib.Path(__file__).resolve()
                        .parents[1]).resolve()
    sys.path.insert(0, str(root / "src"))
    if not torch.cuda.is_available():
        sys.exit("kernel_bits: no CUDA device")


def _input(i: int) -> torch.Tensor:
    """Spec ``i``'s seeded input, (SLOTS, N) bf16 on the card."""
    gen = torch.Generator().manual_seed(i)
    x = torch.randn((SLOTS, N), generator=gen) * 0.02
    x[:, ::97] *= 100                               # a long tail
    return x.cuda().to(torch.bfloat16)


def save(out_path: str, checkout: str | None = None) -> None:
    _use(checkout)
    from repro_torch.core.registry import codec_from_spec
    from repro_torch.kernels import ash_compress, ash_decompress, ref
    out = {}
    slots, n = SLOTS, N
    for i, spec in enumerate(SPECS):
        cfg = codec_from_spec(spec).cfg
        x = _input(i)
        out[f"K2 {spec}"] = ash_compress.compress_wire(x, cfg)
        blocks = x.reshape(-1, cfg.block_size)
        out[f"K1 {spec}"] = torch.cat([
            t.reshape(-1).view(torch.uint8)
            for t in ash_compress.compress_blocks(blocks, cfg)])
        wire = ref.compress_wire_ref(x, cfg)
        out[f"K5 {spec}"] = ash_decompress.decompress_wire(wire, n, cfg)
        out[f"K6 {spec}"] = ash_decompress.decompress_reduce_wire(wire, n,
                                                                  cfg)
        q, s, a = ref._block_fields(wire, n, cfg)
        out[f"K3 {spec}"] = ash_decompress.decompress_blocks(
            q.reshape(-1, cfg.block_size), s.reshape(-1, s.shape[-1]),
            None if a is None else a.reshape(-1), cfg)
        out[f"K4 {spec}"] = ash_decompress.decompress_reduce(q, s, a, cfg)
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in out.items()}, out_path)
    print(f"kernel_bits: saved {len(out)} outputs to {out_path}")
    for spec in ("taco:b32", "taco:b64", "taco:b256"):
        cfg = codec_from_spec(spec).cfg
        n = 1 << 22
        x = torch.randn((1, n), generator=torch.Generator().manual_seed(7))
        x *= 0.02
        x[:, ::499] *= 100
        x = x.cuda()
        dq = (ref.payload_codes(ash_compress.compress_wire(x, cfg)[:, :n],
                                cfg)
              - ref.payload_codes(ref.compress_wire_ref(x, cfg)[:, :n],
                                  cfg)).abs()
        flipped = int((dq != 0).sum())
        print(f"kernel_bits: {spec} f32 in, n = {n}: K2 flips {flipped} "
              f"payload codes against the plain version ({flipped / n:.2e} "
              f"of the bytes), by at most {int(dq.max())}")


def views() -> None:
    _use()
    from repro_torch.core.registry import codec_from_spec
    from repro_torch.kernels import ash_decompress, ref
    kernels = {"K5": ash_decompress.decompress_wire,
               "K6": ash_decompress.decompress_reduce_wire}
    differ, held = [], 0
    for i, spec in enumerate(SPECS):
        cfg = codec_from_spec(spec).cfg
        wire = ref.compress_wire_ref(_input(i), cfg)
        want = {k: fn(wire, N, cfg) for k, fn in kernels.items()}
        for off in (1, 2, 3):
            buf = torch.empty(wire.numel() + off, dtype=torch.uint8,
                              device=wire.device)
            view = buf[off:].view(wire.shape)
            view.copy_(wire)
            if view.data_ptr() % 4 != off:
                sys.exit(f"kernel_bits: view at {view.data_ptr():#x}, want "
                         f"{off} mod 4")
            for k, fn in kernels.items():
                held += 1
                if not torch.equal(_bits(fn(view, N, cfg)), _bits(want[k])):
                    differ.append(f"{k} {spec} offset {off}")
    torch.cuda.synchronize()
    print(f"kernel_bits: {held} outputs on wire views at byte offsets 1-3 "
          f"held bit for bit against the aligned wire (sign of zero "
          f"included): {held - len(differ)} equal, differ: {differ}")
    if differ:
        sys.exit(1)


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


def compare(a_path: str, b_path: str) -> None:
    a, b = torch.load(a_path), torch.load(b_path)
    if a.keys() != b.keys():
        sys.exit("kernel_bits: the two files hold different outputs")
    differ = [k for k in a if a[k].shape != b[k].shape
              or not torch.equal(_bits(a[k]), _bits(b[k]))]
    print(f"kernel_bits: {len(a)} outputs compared bit for bit (sign of "
          f"zero included): {len(a) - len(differ)} equal, differ: {differ}")
    if differ:
        sys.exit(1)


if __name__ == "__main__":
    if len(sys.argv) in (3, 4) and sys.argv[1] == "save":
        save(*sys.argv[2:])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        compare(sys.argv[2], sys.argv[3])
    elif sys.argv[1:] == ["views"]:
        views()
    else:
        sys.exit(__doc__)
