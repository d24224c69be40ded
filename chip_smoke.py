"""On-card smoke check of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card, from the repo root

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, started together), then:

  1. kernels: holds the six TACO kernels against their plain PyTorch
     versions on the card (K1 and K2 bit for bit at an f32 compute dtype,
     ``ref.check_compress_wire``; otherwise the parity rule of
     ``repro_torch.kernels.ref``):
     the wire kernels K2, K5, K6 (``compress_wire``, ``decompress_wire``,
     ``decompress_reduce_wire``) at the serve shape (slots=1, n=3584 = 4 x
     896) and n = 4096 x 896; the block kernels K1, K3, K4
     (``compress_blocks``, ``decompress_blocks``, ``decompress_reduce``) at
     the serve shape, at one ring chunk (n = 1,835,008) and at the
     training hop's (n = 4 x 2048 x 896); dual and folded, P in {1, 4},
     the other payload formats, group scales (g32, g64, g128), a scale
     floor, all-zero blocks, rows with a rotated group planted at 0 (e5m2
     g8, int8 g1), wire rows at 4-byte offsets (folded, n = 1792,
     3 slots), a ragged row count (4099 rows), inputs that are unaligned
     views (which must give the aligned copy's bytes), and every block size
     the kernels are built for (B = 32 .. 512) under an f32 and a bf16
     compute dtype (the bf16 allowances of the parity rule).  Each
     block form must equal its wire form bit for bit (pack(K1) == K2,
     K3(unpack) == K5, K4(unpack) == K6), and under folded f32 metadata K3
     must equal K4 on one peer bit for bit.  K5 and K6 on a wire that is a
     view at byte offset 1, 2 or 3 must equal K5 and K6 on the aligned
     wire bit for bit.  Each kernel is timed (device time from the
     profiler, per-call time with CUDA events) beside its bound and its
     plain version, K1, K3 and K4 also at the P = 4 stack a rank's
     reduce-scatter receives at tp = 4 ("tp4 hop"), and both routes of
     one training hop (wire kernels vs block kernels + pack/unpack) are
     timed.  Phase 1c
     holds K7 (``compress_blocks_butterfly``, on no path) against its
     plain version at the serve and training shapes with B = 256 and at
     B = 32, 64, 128 and 512, and times it at every one of them (beside K1
     at B = 256), with its bound share, its achieved bytes/s beside a
     device copy's, its elements a lane and its registers.  Phase 1d
     runs one hop of each ablation configuration (``F1_SPECS``) on the
     card against the same hop on the CPU: ``b128`` (its wire bit for
     bit) and ``cdbfloat16`` through the kernels,
     the configurations with no kernel (another transform, tensor scales)
     through the plain versions by the route of ``repro_torch.kernels.ops``
     (and no kernel launch);
  2. serving: drives the serve launcher (``repro_torch.launch.serve``) on
     full-width qwen2-0.5b (24 layers, d 896, vocab 151936, bf16, weights
     from --seed) under ``baseline`` and then ``taco``; every decode tick
     under ``taco`` must launch exactly 98 compress, 49 decompress-reduce
     and 49 decompress wire kernels and no block kernel, and none under
     ``baseline``; one decode tick is profiled;
  3. training: drives the train launcher (``repro_torch.launch.train``) on
     full-width qwen2-0.5b, cut to ``QWEN_LAYERS`` (12) of its 24 layers
     (the script's time; every later qwen2-0.5b training run shares that
     depth), batch 4 x seq 2048, seed 0, lr 3e-4, under
     ``baseline`` and ``taco``, 2 warm + 4 timed steps each; every taco
     step must launch exactly the block-kernel counts derived from the
     code (``want_per_step``: 136 K1, 74 K3, 62 K4) and no wire kernel,
     ``baseline`` none; every loss finite, taco's within 5e-2 relative of
     baseline's at every step; one more step each is profiled (wall,
     device busy, idle share, TACO kernel time);
  4. reference: the smoke-size taco decode and one smoke-size taco train
     step (wire and block routes) on the card must agree with the plain
     versions on the CPU;
  5. process group: a 1-rank NCCL group on the card.  At smoke size the
     hops (forward and backward) and the loss under the chunked ring of
     ``tp=taco:folded:chunks=4`` (pipelined and serial) must equal the
     monolithic ``tp=taco:folded`` bit for bit; then full-width training
     (as phase 3) and serving (as phase 2) run under that spec with the
     group passed, both at ``QWEN_LAYERS``: four times the block-kernel
     launches per step (one per ring chunk), four times the wire-kernel
     launches per tick, losses within 5e-2 of phase 3's baseline;
  6. data parallelism: 1-rank NCCL groups for pod, data and model
     (``launch.mesh.init_mesh``), so that every hop of both fsdp stages
     goes through ``torch.distributed``.  At smoke size under
     ``tp=taco,grad_rs=sdp4bit`` every weight gather's backward runs the
     SDP4bit codec at the pod and the data stage, the ring
     ``grad_rs=sdp4bit:chunks=4`` (pipelined and serial) gives the
     monolithic hop's loss and grads bit for bit, one train step on the
     card agrees with the CPU (loss 1e-3, grad norm 5e-2), and the codec
     at a full-width weight gradient holds the parity rule of
     ``core/dp_compress.py`` against the CPU; then full-width training (as
     phase 3) under that spec: the launches of phase 3's taco (the codec
     launches no TACO kernel), losses within 5e-2 of phase 3's baseline,
     and one step's weight-gradient hops replayed and profiled for the
     codec's device time;
  7. the pipeline step (``train/pipeline_parallel.py``, 3D): 1-rank NCCL
     groups for pipe, data and model (``launch.mesh.init_mesh`` with
     ``PIPE_AXES``).  At smoke size (gpt-2.7b cut to 4 layers, d 256) the
     pipeline step at pipe = 1 over 4 microbatches equals the plain step
     (loss 1e-3, grad norm 5e-2) and makes no ``torch.distributed`` call
     for its boundary hops (no peer at pipe = 1), and the card equals the
     CPU under ``taco3d`` and ``weight_ag=int8``; then full-width
     gpt-2.7b (d 2560, vocab 51200) cut to 4 of its 32 layers, batch 4
     x seq 2048 in 4 microbatches, 2 warm + 4 timed steps, under
     ``baseline`` and ``taco3d``: launches 4 x phase 3's per-microbatch
     counts (at 4 layers 192 K1, 104 K3, 88 K4), losses within 5e-2 of
     baseline's, and one step's
     boundary hops (TahQuant) and weight gathers (``Int8Codec``) replayed
     at full width, card against CPU (codes apart from ties, scales bit
     for bit) and profiled;
  8. checkpoint and restart: qwen2-0.5b as phase 3 through the train
     launcher (``--ckpt``) on phase 6's groups under
     ``tp=taco,grad_rs=sdp4bit``, 6 steps with a checkpoint every 3 in a
     temporary directory (the global state gathered through NCCL, one
     ``.npy`` a leaf), then again with a failure injected at step 4: the
     trainer restores step 3 and replays.  The restored state must equal
     the saved state bit for bit, the replayed run's losses and final
     params and optimizer state the uninterrupted run's, and each of the 7
     executed steps launch phase 3's taco counts; save and restore times
     and GB/s are printed with the card's name and power limit.  Then the
     serve launcher's ``--ckpt`` builds an engine from the checkpoint, and
     its greedy tokens on 2 requests must equal those of an engine built
     from the in-memory params;
  9. the policy layer, on phase 5's group.  9a: one training hop at full
     width (n = 7,340,032 bf16, the last 3/4 of the sequence rows zero)
     under ``tp=taco+zle:slot=auto`` and its ring
     ``tp=taco+zle:folded:chunks=4:slot=auto``: the static bootstrap, a
     negotiated hop that moves less than the bound and equals the static
     hop bit for bit (all-gather and reduce-scatter), a dense spike that
     overflows and one resync replay bit-exact; the card's ZLE bytes equal
     the CPU's, and the ZLE stage's device time (encode and decode) is
     printed beside K1's and K3's.  9b: training through the train
     launcher (as phase 3, on the group) under ``tp=taco+zle:slot=auto``
     and ``tp=taco:escalate=bf16@0.005:hold=2``: every attempt at a step
     launches ``want_per_step``'s kernels for the plan variant it ran
     (taco's, plus one decompress a hop for the error probes; none while
     escalated), losses within 5e-2 of phase 3's baseline, the plans and
     ``comm/*`` policy keys printed step by step, and the escalation run
     must escalate.  9c: serving (as phase 2) under
     ``tp=taco+zle:slot=auto:escalate=bf16@0.005:hold=2``, every decode
     attempt's wire launches matching its resolved plan (98 / 49 / 49 plus
     98 probe decodes, or none while escalated); then an engine forced
     through one overflow replay (a shared controller seeded from a
     mostly-zero sample) gives the greedy tokens of an engine under the
     static ``tp=taco+zle``;
 10. sequence parallelism under ``sp=taco:folded``, on phase 5's group.
     One card cannot hold two ranks, and at sp = 1 both attention
     flavours run the monolithic core (as in the JAX package), so the
     sp hops' kernels are held at full-width sp = 2 shapes instead
     (``SP_HOPS``): 10a/10b, the Ulysses in-hop (4 x 1024 x 14 x 192)
     and out-hop (4 x 2048 x 7 x 64) through ``all_to_all_c`` and the
     ring's KV hop (4 x 1024 x 14 x 128) through ``ppermute_c``, forward
     and backward: one K1 and one K3 a hop each way, no plain route, the
     card's wires against the CPU's by the parity rule and their K3
     decode against the plain decode, the hop's output and gradient the
     decode of its wires bit for bit, the all-to-all's bytes against
     ``a2a_wire_bytes``, and each hop's device time; 10c (in phase 1b),
     K1/K3/K4 on the two-peer stacks a rank of sp = 2 decodes; 10d, the
     ring's online-softmax fold of one full-width layer (2 sequence
     blocks) against ``attention_core`` within one bf16 output ulp (atol
     2e-2, the JAX package's ``check_sp.py`` contract); 10e, phase 3's
     taco cell through the train launcher with the seq mesh's 1-rank
     groups, ``--sp-mode ulysses`` and ``ring``, 3 steps each: phase 3's
     launches every step and its first losses bit for bit;
 11. the MoE family: grok-1-314b at full width (d 6144, 48 / 8 heads of
     128, 8 experts of d_ff 32768, top-2, geglu, vocab 131072) cut to 2
     of its 64 layers (11.45 B weights, drawn once from seed 0 and shared
     by every run).  11a: serving as phase 2 (6 requests, prompt 16, 16
     new tokens, max batch 4, 16 req/s) through the serve launcher's
     engine (``launch.serve.make_engine``; the launcher has no depth
     flag) under ``baseline`` and ``taco``: every taco decode attempt
     launches 10 K2, 5 K5 and 5 K6 (2 x 2 + 1 hops), prefill as phase 2
     counts it, no block kernel, no plain route, every token in range, one
     tick profiled.  11b: ``build_train_step(...).grads`` (every hop, no
     update: AdamW's f32 state would not fit the card) on two SyntheticLM
     batches of 2 x 2048 (one dispatch group, capacity 1281 an expert)
     under ``baseline`` and ``taco``: every call launches 26 K1, 14 K3
     and 12 K4, no plain route, losses and balance losses finite, taco's
     loss within 5e-2 of baseline's, peak memory printed and one call
     profiled.  11c: ``moe_apply`` card against CPU at d 256 (8 experts,
     top-2, 512 tokens): routing equal but for tokens within a bf16 ulp of
     a tie (counted), rows that route alike within 2e-2, the balance loss
     within 1e-5.  Phase 1 times K2/K5/K6 at the grok decode hop (4 x
     6144) and phase 1b K1/K3/K4 at its training hop (2 x 2048 x 6144);
 12. the recurrent families at full width: hymba-1.5b (hybrid: 32 layers
     in five segments, full [0], swa [1-14], full [15], swa [16-30], full
     [31]; d 1600, 25 / 5 heads of 64, window 1024, SSM d_state 16) and
     rwkv6-1.6b (24 layers, d 2048, 32 heads of 64, d_ff 7168), the f32
     matmul switches printed and held off (the recurrences are f32
     einsums).  For each, 12a: serving as phase 2 at full depth (the serve
     launcher, baseline and taco): every taco decode attempt and prefill
     call launches 2 x (2L + 1) K2, 2L + 1 K6 and 2L + 1 K5 (130 / 65 / 65
     hymba, 98 / 49 / 49 rwkv), no block kernel, no plain route; rwkv also
     through a forced overflow under ``ZLE_SPEC`` (one replayed
     tick, from the state the failed run read), its greedy tokens those
     of the static stack's engine.  12b: training through the train
     launcher (batch 4 x seq 2048, per-layer recompute, SyntheticLM seed
     1234, ``REC_WARM`` warm + ``SP_TRAIN_STEPS`` timed steps, layers as
     ``REC_TRAIN_LAYERS``) under baseline and taco: every attempt launches
     ``want_per_step``'s K1 / K3 / K4 (356 / 194 / 162 hymba; rwkv 268 /
     146 / 122 at 24 layers, 92 / 50 / 42 at 8), no plain route, taco's
     losses within 5e-2 of baseline's, peak memory and one profiled step
     (busy, idle share, top ops).  12c:
     smoke size, card against CPU: a taco step's loss and grad norm
     within 1e-3 and 5e-2 (both routes), taco decode logits within 5e-2,
     and the f32 recurrent state after a 16-token prefill within 1e-3.
     12d: the device time of one layer's SSM scan and RWKV chunk
     recurrence at full width, forward and forward + backward.
     Phase 1 times K2/K5/K6 at the decode hops (4 x 1600, 4 x 2048), phase
     1b K1/K3/K4 at the training hops (4 x 2048 x 1600, 4 x 2048 x 2048).
 13. the encoder-decoder and the patch frontend at full width:
     whisper-small (12 encoder + 12 decoder layers, d 768, 12 heads of 64,
     d_ff 3072, vocab 51865, layernorm, gelu, sinusoid positions; stub
     frame embeddings, each decoder layer a cross-attention) and
     internvl2-1b (24 layers, d 896, 14 / 2 heads of 64, vocab 151655; 256
     stub patch embeddings in front of the tokens).  For each, 13a:
     serving as phase 2 (the serve launcher, baseline and taco; whisper
     at full depth, internvl at ``QWEN_LAYERS``): every taco decode
     attempt and prefill call launches 2 x hops K2, hops K6 and hops K5,
     hops = 3L + 1 for whisper (74 / 37 / 37) and 2L + 1 for internvl
     (50 / 25 / 25 at 12 layers), no block kernel, no plain
     route, one tick profiled; whisper decodes against its zero cross
     cache, as the JAX package's engine does (its cross-attention adds 0,
     its hops run).  13b: training through the train launcher (batch 4 x
     seq 2048: whisper's encoder and decoder 1024 positions each, internvl
     256 patches and 1792 tokens; per-layer recompute, SyntheticLM seed
     1234, ``REC_WARM`` warm + ``SP_TRAIN_STEPS`` timed steps, layers as
     ``FRONT_LAYERS``) under baseline and taco: every attempt
     launches ``want_per_step``'s K1 / K3 / K4 (342 / 183 / 159 whisper,
     136 / 74 / 62 internvl at 12 layers), no plain route, taco's losses
     within 5e-2 of baseline's, peak memory and one profiled step.  13c:
     smoke size, card against CPU: a taco step's loss and grad norm
     within 1e-3 and 5e-2 (both routes), taco decode logits within 5e-2,
     whisper's against a seeded nonzero cross cache.  Phase 1 times
     K2/K5/K6 at whisper's decode hop (4 x 768), phase 1b K1/K3/K4 at its
     training hop (4 x 1024 x 768).
 14. the JAX package's tools in the port.  14a: the dry run's check
     (``launch/dryrun.py``) of phase 3's cell (qwen2-0.5b at
     ``QWEN_LAYERS``, batch 4 x 2048, one rank): its params and AdamW
     bytes equal the storage of the state phase 3's taco trainer
     allocated on the card (the step's peak printed beside them).  14b:
     the dry run's hops a step equal phase 3's counted K3 / K4 launches
     (74 / 62, their sum K1's 136) and its packed bytes the trainer's
     ``comm/tp_*_bytes_per_elem`` keys, with no second step run.  14c:
     the four example twins in this process (``examples/torch_*.py``):
     the quickstart, ``torch_train_lm`` at gpt-100m's full width (12 x
     768) launching ``want_per_step``'s K1 / K3 / K4 with 0 plain routes
     and a first loss near ln 32000 plus the head's init term, the
     serving example (wire kernels) and the compression demo.  14d: one
     smoke training step under a codec registered through
     ``register_codec`` that delegates to taco equals the ``tp=taco``
     step bit for bit.  14e: ``launch/roofline.py``'s constants beside
     the card's SM count and its ``nvidia-smi`` clocks.

Every training and serving run of phases 2, 3, 5, 6, 7, 8, 9, 10, 11, 12,
13 and 14 (but the compression demo's rows without a kernel) must take
only kernels: ``ops.plain_routes`` stays 0.  Nothing is
caught: any failure exits non-zero.  The line before the last is the
kernel table as JSON; the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

B_PER_S = 3.35e12          # H100 SXM HBM3 bytes/s (data sheet)
F32_OP_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
SERVE_N = 4 * 896          # one decode hop of qwen2-0.5b at max-batch 4
LARGE_N = 4096 * 896
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_N = TRAIN_BATCH * TRAIN_SEQ * 896   # one training hop of qwen2-0.5b
RING_N = TRAIN_N // 4                     # one chunk of the ring's hop
ODD_N = 1792               # folded, mb G = 7 odd: total = 4 mod 8
BLOCK_SIZES = (32, 64, 128, 256, 512)     # the kernels' (ash_compress)
F1_SPECS = ("taco:hadamard", "taco:notransform", "taco:tensorscale",
            "taco:b128", "taco:cdbfloat16")
TRAIN_WARM, TRAIN_STEPS = 2, 6            # 2 warm steps, then 4 timed
#: the depth of every qwen2-0.5b training run (phases 3, 5, 6, 8, 9 and
#: 10, at full width) and of phase 5's ring serving: half of its 24 layers,
#: so that the script with phase 12 stays inside its limit;
#: the runs compared with phase 3's share its depth
QWEN_LAYERS = 12
#: the __global__ function each kernel wrapper launches
KERNEL_FN = {"compress_wire": "compress_wire_kernel",
             "decompress_wire": "decompress_wire_kernel",
             "decompress_reduce_wire": "decompress_reduce_wire_kernel",
             "compress_blocks": "compress_blocks_kernel",
             "decompress_blocks": "decompress_blocks_kernel",
             "decompress_reduce": "decompress_reduce_kernel",
             "compress_blocks_butterfly": "compress_blocks_butterfly_kernel"}
RING_SPEC = "tp=taco:folded:chunks=4"     # the paper's spec: the chunked ring
DP_SPEC = "tp=taco,grad_rs=sdp4bit"       # TACO on TP, SDP4bit on the data axes
PIPE_SPEC = "taco3d"                      # + TahQuant at the stage boundaries
PIPE_ARCH, PIPE_MICRO = "gpt-2.7b", 4     # phase 7: full width, 4 microbatches
#: phase 7's depth: an eighth of gpt-2.7b's 32 layers, so that the whole
#: script stays well inside its 1200 s limit (phase 7 carries its own
#: baseline, so its depth is the one to cut)
PIPE_LAYERS = 4
#: one TP hop of phase 7's step: a microbatch (batch / M rows) x d 2560
PIPE_N = TRAIN_BATCH // PIPE_MICRO * TRAIN_SEQ * 2560
TRAIN_SIZE = "--no-smoke"                 # full width and depth
#: phase 8: steps, a checkpoint every RESTART_EVERY, a failure injected at
#: RESTART_FAIL; then RESTART_REQUESTS requests of RESTART_GEN tokens
#: served from the checkpoint
RESTART_STEPS, RESTART_EVERY, RESTART_FAIL = 6, 3, 4
RESTART_REQUESTS, RESTART_GEN = 2, 8
DEVICE = "cuda"                           # where phase 1b's tensors live
#: phase 9: the lossless stack with negotiated slots (and its ring), the
#: escalation policy, and both on the decode path
ZLE_SPEC = "tp=taco+zle:slot=auto"
ZLE_RING_SPEC = "tp=taco+zle:folded:chunks=4:slot=auto"
ESC_SPEC = "tp=taco:escalate=bf16@0.005:hold=2"
POLICY_SERVE_SPEC = "tp=taco+zle:slot=auto:escalate=bf16@0.005:hold=2"
#: phase 10: the sp hops of full-width qwen2-0.5b at sp = 2 (batch 4 x seq
#: 2048, tp 1, 14 heads of 64 after the kv expansion, bf16): each the
#: tensor one rank of sp = 2 sends, with its all-to-all's (split, concat)
#: dims (None: the ring's permute)
SP_SPEC = "sp=taco:folded"
SP_HOPS = (("ulysses in", (TRAIN_BATCH, TRAIN_SEQ // 2, 14, 192), (2, 1)),
           ("ulysses out", (TRAIN_BATCH, TRAIN_SEQ, 7, 64), (1, 2)),
           ("ring kv", (TRAIN_BATCH, TRAIN_SEQ // 2, 14, 128), None))
SP_TRAIN_STEPS = 3
#: phase 11: grok-1-314b at full width cut to MOE_LAYERS of its 64 layers;
#: its decode hop (max-batch 4 x d 6144) and training hop (2 x 2048 x
#: 6144: MOE_BATCH x MOE_SEQ tokens, one dispatch group of 4096)
MOE_ARCH, MOE_LAYERS = "grok-1-314b", 2
MOE_BATCH, MOE_SEQ, MOE_CALLS = 2, 2048, 2
MOE_SERVE_N = 4 * 6144
MOE_TRAIN_N = MOE_BATCH * MOE_SEQ * 6144
#: 11c: moe_apply card vs CPU at a small width
MOE_SMALL = dict(d=256, experts=8, top_k=2, tokens=512)
#: phase 12: the recurrent families at full width, hymba-1.5b (hybrid: 32
#: layers in five full / SWA segments) and rwkv6-1.6b (24 layers); their
#: decode hops (max-batch 4 x d) and training hops (batch x seq x d)
REC_ARCHS = ("hymba-1.5b", "rwkv6-1.6b")
HYMBA_SERVE_N, RWKV_SERVE_N = 4 * 1600, 4 * 2048
HYMBA_TRAIN_N = TRAIN_BATCH * TRAIN_SEQ * 1600
RWKV_TRAIN_N = TRAIN_BATCH * TRAIN_SEQ * 2048
#: 12b: the layers each family trains (None: its full depth).  rwkv is one
#: segment, so its depth is the first to cut for the script's time; hymba
#: runs all 32 layers, its five segments being what the slice brings
REC_TRAIN_LAYERS = {"hymba-1.5b": None, "rwkv6-1.6b": 8}
#: 12b: one warm step, then SP_TRAIN_STEPS timed ones
REC_WARM, REC_STEPS = 1, 1 + SP_TRAIN_STEPS
#: phase 13: the encoder-decoder (whisper-small) and the patch frontend
#: (internvl2-1b) at full width; whisper's decode hop (max-batch 4 x d 768)
#: and training hop (batch x seq/2 x d: its encoder and its decoder run
#: half the sequence each); internvl's are qwen2-0.5b's
FRONT_ARCHS = ("whisper-small", "internvl2-1b")
WHISPER_SERVE_N = 4 * 768
WHISPER_TRAIN_N = TRAIN_BATCH * TRAIN_SEQ // 2 * 768
#: 13a / 13b: the layers each arch serves and trains at (None: its full
#: depth); internvl2-1b at the depth its twin qwen2-0.5b trains at
FRONT_LAYERS = {"whisper-small": None, "internvl2-1b": QWEN_LAYERS}
#: the short names of the kernel line's launches by path
FRONT_SHORT = {"whisper-small": "whisp", "internvl2-1b": "intvl"}


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
    fail(f"no port sources under {SRC}: run from a checkout of the repo")
sys.path.insert(0, str(SRC))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def call_ms(fn, iters: int = 50) -> float:
    """Mean CUDA-event time per call of ``fn`` over ``iters`` calls in a
    row, after a warm-up.  At small shapes the host's launch path, not the
    device, sets this pace."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _traced(fn, iters: int) -> list:
    """The device activities (kernels, copies, fills) of ``iters`` calls
    of ``fn``, from one profiler session that traces the device only.
    Every device time of this script is a sum of these.  A host-and-device
    trace would add the ``nccl:*`` range of each ``torch.distributed``
    call, drawn on the device's timeline over the copy it encloses, and so
    count that copy twice (``scripts/trace_definitions.py``); it also
    costs minutes on a training step's ~10^5 ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_profile(fn, iters: int = 20, sessions: int = 3,
                   warm: bool = True) -> dict:
    """Mean device time per call of ``fn`` by activity name, in ms, after
    one warm-up call (``warm``).  The profiler's trace now and then drops
    a launch, which can only lower a name's total, so each name keeps its
    largest total over ``sessions`` profiler sessions.  Raises if no
    device time is traced."""
    if warm:
        fn()
    torch.cuda.synchronize()
    best: dict = {}
    for _ in range(sessions):
        by_name: dict = {}
        for e in _traced(fn, iters):
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / iters / 1e3
        for k, v in by_name.items():
            best[k] = max(best.get(k, 0.0), v)
    if sum(best.values()) <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return best


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time per call of ``fn`` (all its device activity)."""
    return sum(device_profile(fn, iters).values())


def kernel_ms(fn, kernel: str, iters: int = 20,
              sessions: int = 10) -> tuple[float, int]:
    """Device time of one launch of the TACO kernel ``kernel`` (its
    ``__global__`` name) that ``fn`` launches once per call: the mean over
    its traced launches, from profiler sessions of ``iters`` calls until
    ``iters`` launches are traced (at most ``sessions``); returns it with
    the number of launches traced."""
    # the demangled ("taco::name<...>(...)") or mangled ("4taco22name...")
    # name, and not a longer kernel name that ends with this one
    pat = re.compile(r"(taco::|\d)" + re.escape(kernel) + r"(?![a-z_])")
    fn()
    torch.cuda.synchronize()
    times: list = []
    for _ in range(sessions):
        times += [e.time_range.elapsed_us() / 1e3
                  for e in _traced(fn, iters) if pat.search(e.name)]
        if len(times) >= iters:
            break
    if not times:
        raise RuntimeError(f"the profiler recorded no {kernel} launch")
    return sum(times) / len(times), len(times)


def profile_tick(eng, calls: int = 5) -> dict:
    """Where one full-table decode tick's time goes: host wall per call,
    device busy time per call (profiler), the idle share, and the TACO
    wire kernels' device time."""
    from repro_torch.serve import serve_step as ss
    tok = torch.ones((eng.max_batch, 1), dtype=torch.long, device="cuda")
    pos = torch.arange(eng.max_batch, device="cuda")

    def fn():
        return ss.decode_forward(eng.params, tok, eng.cache, pos, eng.model,
                                 eng.ctx)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / calls * 1e3
    prof = device_profile(fn, calls)
    busy = sum(prof.values())
    wire = sum(v for k, v in prof.items() if "compress" in k)
    top = sorted(prof.items(), key=lambda kv: -kv[1])[:4]
    return {"wall_ms": wall, "device_ms": busy, "idle_share": 1 - busy / wall,
            "taco_kernels_ms": wire,
            "top": [(k[:60], round(v, 5)) for k, v in top]}


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time in ms for ``nbytes`` moved and ``ops`` f32 operations."""
    tb, to = nbytes / B_PER_S * 1e3, ops / F32_OP_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def tp_like(gen, shape, scale=0.02, tail=2.0, frac=0.002):
    """TP-intermediate-like tensor: dense near-zero body + long tail."""
    x = gen.normal(0.0, scale, size=shape).astype(np.float32)
    flat = x.reshape(-1)
    k = max(1, int(flat.size * frac))
    idx = gen.choice(flat.size, size=k, replace=False)
    flat[idx] = gen.normal(0.0, tail, size=k).astype(np.float32)
    return torch.from_numpy(x)


def planted(gen, rows: int, b: int) -> torch.Tensor:
    """f32 rows z @ H / sqrt(B) of seeded normal z with one aligned group of
    8 values of z per row at 0: the rotation cancels there, so another
    order of its sums puts those values' codes, and their group's scale,
    far apart (``tests/test_torch_compress_order.py``)."""
    from repro_torch.core.ash import hadamard_matrix
    z = gen.normal(size=(rows, b))
    start = 8 * gen.integers(0, b // 8, size=rows)
    z[np.arange(rows)[:, None], start[:, None] + np.arange(8)] = 0.0
    h = hadamard_matrix(b, torch.float64).numpy()
    return torch.from_numpy((z @ h).astype(np.float32))


def compress_launch(name: str, cfg, dtype, rows: int, regs: dict) -> dict:
    """K1's or K2's launch for ``rows`` block rows of ``dtype`` under
    ``cfg`` (``ash_compress.geometry``: elements a lane, lanes a row, rows
    a warp, the persistent grid) and the registers and spilled bytes that
    ``-Xptxas -v`` printed for its instantiation (``regs``:
    ``ptxas_registers`` of the ash_compress build; None where the library
    was not built in this run)."""
    from repro_torch.kernels import ash_compress as ac
    b = cfg.block_size
    bf = int(cfg.torch_compute_dtype == torch.bfloat16)
    geo = ac.geometry(b, dtype, rows, ac.sms(torch.cuda.current_device()),
                      bf16_compute=bool(bf))
    tin = "13__nv_bfloat16" if dtype == torch.bfloat16 else "f"
    pat = re.compile(rf"{KERNEL_FN[name]}I{tin}Li{b}ELi{geo.e}ELb{bf}E")
    reg = next((v for k, v in regs.items() if pat.search(k)), (None, None))
    return {"e": geo.e, "lanes": geo.lanes,
            "rows_per_warp": geo.rows_per_warp, "grid": geo.grid,
            "registers": reg[0], "spilled": reg[1]}


def compress_note(r: dict) -> str:
    return (f"      E = {r['e']}, {r['lanes']} lanes a row, "
            f"{r['rows_per_warp']} rows a warp, grid {r['grid']}; registers "
            f"{r['registers']}, spilled bytes {r['spilled']}; "
            f"{r['bound_ms'] / r['ms']:.1%} of the bound")


def phase_kernels(logs: dict | None = None) -> dict:
    from repro_torch.core.registry import codec_from_spec
    from repro_torch.kernels import ref
    from repro_torch.kernels.ash_compress import compress_wire, wire_geometry
    from repro_torch.kernels.ash_decompress import (decompress_reduce_wire,
                                                    decompress_wire)
    gen = np.random.default_rng(0)
    dev = torch.device("cuda")
    rows = {}
    regs = ptxas_registers((logs or {}).get("ash_compress", ""))

    def case(spec, n, in_dtype, peers, timed=False, label="", x=None):
        cfg = codec_from_spec(spec).cfg
        if x is None:
            x = tp_like(gen, (peers, n))
        x = x.to(dev, in_dtype)
        w_k = compress_wire(x, cfg)
        w_p = ref.compress_wire_ref(x, cfg)
        torch.cuda.synchronize()
        # bit for bit where ref.plain_bits holds (f32 compute), else the
        # parity rule
        stats = ref.check_compress_wire(w_k, w_p, n, cfg)
        dec_k = ref.decompress_wire_ref(w_k, n, cfg)
        dec_p = ref.decompress_wire_ref(w_p, n, cfg)
        if stats["flipped"] == 0:      # a flipped code moves its whole block
            ref.check_decoded_close(dec_k, dec_p, cfg)
        err_c = float((dec_k - dec_p).abs().max())
        d_k = decompress_wire(w_p, n, cfg)
        err_d = ref.check_decoded_close(
            d_k, ref.decompress_wire_ref(w_p, n, cfg), cfg)
        r_k = decompress_reduce_wire(w_p, n, cfg)
        err_r = ref.check_decoded_close(
            r_k, ref.decompress_reduce_wire_ref(w_p, n, cfg), cfg)
        print(f"  {label:6s} {spec:16s} n={n:8d} P={peers} "
              f"in={str(in_dtype)[6:]:8s} bitwise={stats['bitwise']} "
              f"flipped={stats['flipped']} "
              f"meta_rel={stats['meta_rel_err']:.2e} "
              f"err compress={err_c:.2e} decompress={err_d:.2e} "
              f"reduce={err_r:.2e}")
        if not timed:
            return
        _, _, _, _, total = wire_geometry(cfg, n)
        isz = x.element_size()
        x1 = x[:1].contiguous()
        w1 = w_p[:1].contiguous()
        work = {
            "compress_wire": (
                lambda: compress_wire(x1, cfg),
                lambda: ref.compress_wire_ref(x1, cfg),
                n * isz + total, 16.0 * n, err_c),
            "decompress_wire": (
                lambda: decompress_wire(w1, n, cfg),
                lambda: ref.decompress_wire_ref(w1, n, cfg),
                total + 4 * n, 11.0 * n, err_d),
            "decompress_reduce_wire": (
                lambda: decompress_reduce_wire(w_p, n, cfg),
                lambda: ref.decompress_reduce_wire_ref(w_p, n, cfg),
                peers * total + 4 * n, (2.0 * peers + 9) * n, err_r),
        }
        for name, (kern, plain, nbytes, ops, err) in work.items():
            (ms, events), plain_ms = kernel_ms(kern, KERNEL_FN[name]), \
                device_ms(plain)
            per_call, plain_call = call_ms(kern), call_ms(plain)
            b_ms, b_by = bound(nbytes, ops)
            print(f"    {name:24s} {label:6s} device: kernel {ms:.6f} ms "
                  f"({events} launches traced)  "
                  f"plain {plain_ms:.6f} ms  bound {b_ms:.6f} ms ({b_by}); "
                  f"per call: kernel {per_call:.6f} ms  plain "
                  f"{plain_call:.6f} ms")
            r = rows.setdefault(name, {})[label] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "max_abs_err": err, "call_ms": per_call,
                "plain_call_ms": plain_call}
            if name == "compress_wire":
                r.update(compress_launch(name, cfg, x1.dtype,
                                         n // cfg.block_size, regs))
                print(compress_note(r))

    print("phase 1: kernels vs plain versions; K2 bit for bit at f32 "
          "compute (ref.plain_bits), else at most "
          f"{ref.PAYLOAD_FLIP_FRACTION} of payload bytes "
          f"differ, by one code; metadata rtol {ref.META_RTOL}; decoded "
          f"rtol {ref.DECODE_RTOL} atol {ref.DECODE_ATOL}")
    case("taco", SERVE_N, torch.bfloat16, 1, timed=True, label="serve")
    case("taco:folded", SERVE_N, torch.bfloat16, 1)
    case("taco", SERVE_N, torch.bfloat16, 4)
    case("taco:folded", SERVE_N, torch.float32, 4)
    case("taco:e5m2", SERVE_N, torch.bfloat16, 1)
    case("taco:int8", SERVE_N, torch.float32, 1)
    case("taco:g64", SERVE_N, torch.bfloat16, 4)
    case("taco:folded:g32", SERVE_N, torch.bfloat16, 1)
    case("taco:g128", SERVE_N, torch.float32, 4)
    case("taco:folded", ODD_N, torch.bfloat16, 3)     # slots at 4 mod 8
    case("taco:e5m2:g32", 256 * 4099, torch.bfloat16, 1)   # ragged rows
    for b in BLOCK_SIZES:                  # every block size, both dtypes
        case(f"taco:b{b}", SERVE_N, torch.bfloat16, 4)
        case(f"taco:b{b}:cdbfloat16:folded", SERVE_N, torch.bfloat16, 4)
    case("taco:cdbfloat16:int8:g32", SERVE_N, torch.float32, 4)
    case("taco", LARGE_N, torch.bfloat16, 4, timed=True, label="large")
    # phase 11's decode hop: grok-1-314b at max-batch 4 (d 6144)
    case("taco", MOE_SERVE_N, torch.bfloat16, 1, timed=True,
         label="grok decode")
    # phase 12's decode hops: hymba-1.5b and rwkv6-1.6b at max-batch 4
    case("taco", HYMBA_SERVE_N, torch.bfloat16, 1, timed=True,
         label="hymba decode")
    case("taco", RWKV_SERVE_N, torch.bfloat16, 1, timed=True,
         label="rwkv decode")
    # phase 13's decode hop: whisper-small at max-batch 4 (internvl2-1b's
    # is the serve hop)
    case("taco", WHISPER_SERVE_N, torch.bfloat16, 1, timed=True,
         label="whisper decode")
    case("taco:seps1e-20", 1024, torch.float32, 1)
    # rows with a rotated group planted at 0 (a generator of their own)
    pgen = np.random.default_rng(29)
    for spec in ("taco:e5m2:g8", "taco:e5m2:g8:folded", "taco:int8:g1"):
        case(spec, 64 * 256, torch.float32, 4, label="plant",
             x=planted(pgen, 4 * 64, 256).reshape(4, -1))
    z = torch.zeros((1, 1024), device=dev)       # all-zero blocks: s floor
    cfg = codec_from_spec("taco").cfg
    ref.check_compress_wire(compress_wire(z, cfg),
                            ref.compress_wire_ref(z, cfg), 1024, cfg)
    return rows


@contextlib.contextmanager
def wire_budget(elems: int):
    """Set the codecs' wire-form slot budget (``ops.
    WIRE_FUSED_MAX_SLOT_ELEMS``) for the block: 0 sends every hop to the
    block kernels, a huge value every hop to the wire kernels."""
    from repro_torch.kernels import ops
    old = ops.WIRE_FUSED_MAX_SLOT_ELEMS
    ops.WIRE_FUSED_MAX_SLOT_ELEMS = elems
    try:
        yield
    finally:
        ops.WIRE_FUSED_MAX_SLOT_ELEMS = old


def hold_blocks(x, cfg, peers: int, n: int, where: str) -> dict:
    """K1, K3 and K4 against their plain versions on ``x`` (``peers`` rows
    of ``n`` elements, on the card): K1's q, alpha and s bit for bit where
    ``ref.plain_bits`` holds (f32 compute), else its wire under the parity
    rule; K3 and K4 on the plain version's blocks within the decode
    tolerance, and K3 == K4 at P = 1 under folded f32 metadata bit for bit.
    Returns the parity stats, each kernel's max abs error, and the operands
    a timing of the three takes."""
    from repro_torch.kernels import ops, ref
    b = cfg.block_size
    blocks = x.reshape(-1, b)
    mb = n // b
    # K1 against its plain version: its bits, or the wire parity rule
    q, a, s = ops.compress_blocks(blocks, cfg)
    qp, ap, sp = ref.compress_blocks_ref(blocks, cfg)
    torch.cuda.synchronize()
    if ref.plain_bits(cfg):
        def bits(t):            # -0 apart from +0
            return t.view(torch.uint8 if t.element_size() == 1 else
                          torch.int32)
        for name, k, p in (("q", q, qp), ("alpha", a, ap), ("s", s, sp)):
            if not torch.equal(bits(k), bits(p)):
                raise AssertionError(f"{where}: K1's {name} is not the plain "
                                     "version's")
    w_k = ref.blocks_to_wire(q, a, s, cfg, peers, n)
    w_p = ref.blocks_to_wire(qp, ap, sp, cfg, peers, n)
    stats = ref.check_compress_wire(w_k, w_p, n, cfg)
    dec_k = ref.decompress_wire_ref(w_k, n, cfg)
    dec_p = ref.decompress_wire_ref(w_p, n, cfg)
    if stats["flipped"] == 0:      # a flipped code moves its whole block
        ref.check_decoded_close(dec_k, dec_p, cfg)
    err_c = float((dec_k - dec_p).abs().max())
    del dec_k, dec_p, w_k, w_p
    # K3 and K4 on the plain version's blocks
    alpha = None if cfg.metadata == "folded" else ap
    scale = sp / ap[:, None] if alpha is None else sp
    k3 = ops.decompress_blocks(qp, scale, alpha, cfg)
    err_d = ref.check_decoded_close(
        k3, ref.decompress_blocks_ref(qp, scale, alpha, cfg), cfg)
    # K3 against K4 on one peer: under folded f32 metadata K4 does K3's
    # arithmetic (its sum starts from +0, which torch.equal counts equal
    # to -0)
    if alpha is None and cfg.torch_compute_dtype == torch.float32 and \
            not torch.equal(k3, ops.decompress_reduce(
                qp[None], scale[None], None, cfg)):
        raise AssertionError(f"{where}: K3 != K4 at P=1")
    del k3
    q3 = qp.reshape(peers, mb, b)
    s3 = scale.reshape(peers, mb, -1)
    a3 = None if alpha is None else alpha.reshape(peers, mb)
    err_r = ref.check_decoded_close(
        ops.decompress_reduce(q3, s3, a3, cfg),
        ref.decompress_reduce_ref(q3, s3, a3, cfg), cfg)
    return {"stats": stats, "compress_blocks": err_c,
            "decompress_blocks": err_d, "decompress_reduce": err_r,
            "blocks": blocks, "s": s, "qp": qp, "alpha": alpha,
            "scale": scale, "q3": q3, "s3": s3, "a3": a3}


def phase_blocks(logs: dict | None = None) -> dict:
    """K1, K3, K4 against their plain versions, each block form against
    its wire form bit for bit, and both routes of a whole hop timed; K1's
    launch geometry and registers beside its times (``logs``: the build's
    output)."""
    from repro_torch.core.codecs import pack_wire, unpack_wire
    from repro_torch.core.registry import codec_from_spec
    from repro_torch.kernels import ops, ref
    gen = np.random.default_rng(1)
    dev = torch.device(DEVICE)
    rows, hops = {}, {}
    regs = ptxas_registers((logs or {}).get("ash_compress", ""))

    def case(spec, n, in_dtype, peers, timed=False, label="", x=None,
             offset=0):
        codec = codec_from_spec(spec)
        cfg = codec.cfg
        if x is None:
            # offset > 0: a contiguous view that starts ``offset`` elements
            # into its storage, so its loads are not 16-byte aligned
            x = tp_like(gen, (peers * n + offset,)).to(dev, in_dtype)[
                offset:].view(peers, n)
        h = hold_blocks(x, cfg, peers, n, f"{spec} n={n}")
        stats, err_c, err_d, err_r = h["stats"], h["compress_blocks"], \
            h["decompress_blocks"], h["decompress_reduce"]
        blocks, s, qp, alpha, scale, q3, s3, a3 = (h[k] for k in (
            "blocks", "s", "qp", "alpha", "scale", "q3", "s3", "a3"))
        # route identity, bit for bit: pack(K1) == K2, K3(unpack) == K5,
        # K4(unpack) == K6
        wire = ops.compress_wire(x, cfg)
        layout = codec.wire_layout(n)
        if not torch.equal(pack_wire(codec.encode(x), layout), wire):
            raise AssertionError(f"{spec} n={n}: pack_wire(K1) != K2")
        if offset and not (torch.equal(wire, ops.compress_wire(
                x.clone(), cfg)) and all(torch.equal(a, b) for a, b in zip(
                    ops.compress_blocks(blocks, cfg),
                    ops.compress_blocks(blocks.clone(), cfg)))):
            raise AssertionError(f"{spec} n={n}: an unaligned view differs "
                                 "from its aligned copy")
        enc = unpack_wire(wire, layout)
        if not torch.equal(codec.decode(enc, n, torch.float32),
                           ops.decompress_wire(wire, n, cfg).float()):
            raise AssertionError(f"{spec} n={n}: K3(unpack) != K5")
        if not torch.equal(codec.decode_sum(enc, n, torch.float32),
                           ops.decompress_reduce_wire(wire, n, cfg)
                           .float().reshape(-1)):
            raise AssertionError(f"{spec} n={n}: K4(unpack) != K6")
        print(f"  {label:10s} {spec:16s} n={n:8d} P={peers} "
              f"in={str(in_dtype)[6:]:8s}{' offset ' * bool(offset)}"
              f"{offset or ''} bitwise={stats['bitwise']} "
              f"flipped={stats['flipped']} "
              f"meta_rel={stats['meta_rel_err']:.2e} err compress_blocks="
              f"{err_c:.2e} decompress_blocks={err_d:.2e} "
              f"decompress_reduce={err_r:.2e}; block == wire bitwise")
        if not timed:
            return
        # each call's own elements: K1 and K3 take all P peers' blocks
        # (P n elements), K4 sums the P peers into n
        m = blocks.shape[0]
        groups = s.shape[-1]
        isz = x.element_size()
        pn = peers * n
        # the P peers' scales, and their alpha: K1 writes it at every
        # layout, K3 and K4 read it only under dual metadata
        scales = 4 * m * groups
        meta = scales + (0 if alpha is None else 4 * m)
        work = {
            "compress_blocks": (
                lambda: ops.compress_blocks(blocks, cfg),
                lambda: ref.compress_blocks_ref(blocks, cfg),
                pn * isz + pn + scales + 4 * m, 16.0 * pn, err_c),
            "decompress_blocks": (
                lambda: ops.decompress_blocks(qp, scale, alpha, cfg),
                lambda: ref.decompress_blocks_ref(qp, scale, alpha, cfg),
                pn + meta + 4 * pn, 11.0 * pn, err_d),
            "decompress_reduce": (
                lambda: ops.decompress_reduce(q3, s3, a3, cfg),
                lambda: ref.decompress_reduce_ref(q3, s3, a3, cfg),
                pn + meta + 4 * n, (2.0 * peers + 9) * n, err_r),
        }
        for name, (kern, plain, nbytes, nops, err) in work.items():
            (ms, events), plain_ms = kernel_ms(kern, KERNEL_FN[name]), \
                device_ms(plain)
            per_call, plain_call = call_ms(kern), call_ms(plain)
            b_ms, b_by = bound(nbytes, nops)
            print(f"    {name:24s} {label:10s} device: kernel {ms:.7f} ms "
                  f"({events} launches traced)  "
                  f"plain {plain_ms:.7f} ms  bound {b_ms:.7f} ms ({b_by}, "
                  f"{b_ms / ms:.1%} of it); per call: kernel "
                  f"{per_call:.7f} ms  plain {plain_call:.7f} ms")
            r = rows.setdefault(name, {})[label] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "max_abs_err": err, "call_ms": per_call,
                "plain_call_ms": plain_call}
            if name == "compress_blocks" and DEVICE == "cuda":
                r.update(compress_launch(name, cfg, blocks.dtype, m, regs))
                print(compress_note(r))
        if label != "train":
            return
        # both routes of one whole hop (the codec's wire methods)
        total = layout.total_bytes
        legs = {
            "encode": lambda: codec.encode_wire(x),
            "decode": lambda: codec.decode_wire(wire, n, x.dtype),
            "decode_sum": lambda: codec.decode_sum_wire(wire, n, x.dtype)}
        for leg, fn in legs.items():
            for route, budget in (("wire", 1 << 62), ("blocks", 0)):
                with wire_budget(budget):
                    prof = device_profile(fn)
                    per_call = call_ms(fn)
                busy = sum(prof.values())
                kern = sum(v for k, v in prof.items() if "compress" in k)
                print(f"    hop {leg:10s} route {route:6s} device "
                      f"{busy:.6f} ms (TACO kernels {kern:.6f} ms, other "
                      f"{busy - kern:.6f} ms) per call {per_call:.6f} ms")
                hops.setdefault(leg, {})[route] = {
                    "device_ms": busy, "kernel_ms": kern, "call_ms": per_call,
                    "wire_bytes": total}

    def wire_views(spec, n, slots):
        """K5 and K6 on a wire that is a view at byte offset 1, 2 and 3 of
        a larger buffer equal K5 and K6 on the aligned wire bit for bit."""
        cfg = codec_from_spec(spec).cfg
        x = tp_like(gen, (slots, n)).to(dev, torch.bfloat16)
        wire = ops.compress_wire(x, cfg)
        want = {"K5": ops.decompress_wire(wire, n, cfg),
                "K6": ops.decompress_reduce_wire(wire, n, cfg)}
        for off in (1, 2, 3):
            buf = torch.empty(wire.numel() + off, dtype=torch.uint8,
                              device=dev)
            view = buf[off:].view(wire.shape)
            view.copy_(wire)
            if view.data_ptr() % 4 != off:
                raise AssertionError(f"view at {view.data_ptr():#x}, want "
                                     f"{off} mod 4")
            got = {"K5": ops.decompress_wire(view, n, cfg),
                   "K6": ops.decompress_reduce_wire(view, n, cfg)}
            for k in want:
                if not torch.equal(got[k], want[k]):
                    raise AssertionError(f"{spec} n={n}: {k} on a view at "
                                         f"byte offset {off} != {k} aligned")
        torch.cuda.synchronize()
        print(f"  wire view  {spec:16s} n={n:8d} slots={slots} byte offsets "
              f"1-3: K5 == K5 aligned and K6 == K6 aligned bitwise")

    print("phase 1b: block kernels K1/K3/K4 vs plain versions (K1's q, "
          "alpha, s bit for bit at f32 compute, else the same rule), "
          "block form == wire form bit for bit, and K3 == K4 at P=1 under "
          "folded f32 metadata bit for bit")
    case("taco", SERVE_N, torch.bfloat16, 1, timed=True, label="serve")
    case("taco:folded", SERVE_N, torch.bfloat16, 1)
    case("taco", SERVE_N, torch.bfloat16, 4)
    case("taco:folded", SERVE_N, torch.float32, 4)
    case("taco:e5m2", SERVE_N, torch.bfloat16, 1)
    case("taco:int8", SERVE_N, torch.float32, 1)
    case("taco:g64", SERVE_N, torch.bfloat16, 4)
    case("taco:folded:g32", SERVE_N, torch.bfloat16, 1)
    case("taco:int8:g128", SERVE_N, torch.bfloat16, 4)
    case("taco:seps1e-20", 1024, torch.float32, 1)
    case("taco", 1024, torch.float32, 1, x=torch.zeros((1, 1024), device=dev))
    case("taco:folded", ODD_N, torch.bfloat16, 3)     # slots at 4 mod 8
    case("taco:folded:g32", ODD_N, torch.float32, 3)
    case("taco", 256 * 4099, torch.bfloat16, 1)        # ragged rows
    case("taco:g64", SERVE_N, torch.bfloat16, 4, offset=1)   # unaligned
    case("taco:e5m2", SERVE_N, torch.float32, 4, offset=3)
    for b in BLOCK_SIZES:                  # every block size, both dtypes
        case(f"taco:b{b}:folded", SERVE_N, torch.bfloat16, 4)
        case(f"taco:b{b}:cdbfloat16", SERVE_N, torch.bfloat16, 4)
    case("taco:b128:cdbfloat16:e5m2:g32", ODD_N, torch.float32, 3, offset=1)
    pgen = np.random.default_rng(30)      # rows with a group planted at 0
    for spec in ("taco:e5m2:g8", "taco:int8:g1:folded"):
        case(spec, 64 * 256, torch.float32, 4, label="plant",
             x=planted(pgen, 4 * 64, 256).to(dev).reshape(4, -1))
    wire_views("taco:g64", SERVE_N, 4)                 # B = 256, dual
    wire_views("taco:folded", ODD_N, 3)                # rows at 4 mod 8
    wire_views("taco:b512:e5m2:g32", SERVE_N, 1)       # 16 codes a lane
    wire_views("taco:b64:cdbfloat16:int8", SERVE_N, 2)  # 2 codes a lane
    wire_views("taco:b32:folded:g1", SERVE_N, 1)       # 1 code a lane
    case("taco:folded", RING_N, torch.bfloat16, 1, timed=True,
         label="ring chunk")
    case("taco", TRAIN_N, torch.bfloat16, 1, timed=True, label="train")
    case("taco:folded", TRAIN_N, torch.bfloat16, 1)
    case("taco", TRAIN_N, torch.bfloat16, 4)
    # the P = 4 stack a rank's reduce-scatter receives at tp = 4
    case("taco", TRAIN_N // 4, torch.bfloat16, 4, timed=True, label="tp4 hop")
    # a TP hop of phase 7's gpt-2.7b pipeline step (tp=taco of taco3d)
    case("taco", PIPE_N, torch.bfloat16, 1, timed=True, label="pipe hop")
    # a TP hop of phase 11's grok-1-314b gradient step
    case("taco", MOE_TRAIN_N, torch.bfloat16, 1, timed=True,
         label="grok train")
    # the TP hops of phase 12's training steps
    case("taco", HYMBA_TRAIN_N, torch.bfloat16, 1, timed=True,
         label="hymba train")
    case("taco", RWKV_TRAIN_N, torch.bfloat16, 1, timed=True,
         label="rwkv train")
    # the TP hop of phase 13's whisper-small step (internvl2-1b's is the
    # train hop)
    case("taco", WHISPER_TRAIN_N, torch.bfloat16, 1, timed=True,
         label="whisper train")
    # phase 10c: the stacks a rank of sp = 2 decodes (two peers' slots of
    # each sp hop of SP_HOPS)
    for label, shape, dims in SP_HOPS:
        n = math.prod(shape)
        case("taco:folded", n // 2 if dims else n, torch.bfloat16, 2,
             timed=label == "ulysses in", label=f"sp {label}")
    torch.cuda.empty_cache()
    return {"rows": rows, "hops": hops}


def ptxas_registers(log: str) -> dict:
    """Registers and spilled bytes (stores + loads) of each entry function
    in an ``nvcc -Xptxas -v`` log, by mangled name."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            out.setdefault(entry, [0, 0])[1] = int(m.group(1)) + \
                int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.setdefault(entry, [0, 0])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def phase_butterfly(logs: dict | None = None) -> dict:
    """K7 (``compress_blocks_butterfly``) against its plain version under
    the parity rule: bf16 in, e4m3, at the serve shape (n = 3584) and the
    training hop's (n = 7,340,032) with B = 256, and at the training hop's
    n with B = 32, 64, 128 and 512.  K7 is timed at every one of these
    shapes beside its bound and plain version, with its bound share, its
    achieved bytes/s ((3n + 8M) / time) beside a bf16 ``copy_`` of the
    training hop's n (4n bytes / time: the rate this card reaches at this
    size), its launch geometry (elements a lane, lanes a row) and the
    registers and spills ``-Xptxas -v`` printed for its instantiation in
    ``logs`` (the build's output); K1 at the B = 256 shapes."""
    from repro_torch.core.taco import TacoConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import fwht_butterfly as fb
    regs = ptxas_registers((logs or {}).get("fwht_butterfly", ""))
    src = torch.empty(TRAIN_N, dtype=torch.bfloat16, device=DEVICE)
    dst = torch.empty_like(src)
    copy_ms = device_ms(lambda: dst.copy_(src))
    copy_tb_s = 4 * TRAIN_N / copy_ms / 1e9
    print(f"    copy_ bf16 n={TRAIN_N}: {copy_ms:.7f} ms, {copy_tb_s:.4f} "
          f"TB/s (read + write)")
    del src, dst
    gen = np.random.default_rng(2)
    rows = {}
    for label, n, b in (("serve", SERVE_N, 256), ("train", TRAIN_N, 256),
                        ("train B=32", TRAIN_N, 32),
                        ("train B=64", TRAIN_N, 64),
                        ("train B=128", TRAIN_N, 128),
                        ("train B=512", TRAIN_N, 512)):
        cfg = TacoConfig(block_size=b)
        blocks = tp_like(gen, (1, n)).to(DEVICE, torch.bfloat16).reshape(-1, b)
        m = blocks.shape[0]
        q, a, s = fb.compress_blocks_butterfly(blocks, cfg)
        qp, ap, sp = ref.compress_blocks_butterfly_ref(blocks, cfg)
        torch.cuda.synchronize()
        w_k = ref.blocks_to_wire(q, a, s, cfg, 1, n)
        w_p = ref.blocks_to_wire(qp, ap, sp, cfg, 1, n)
        stats = ref.check_wire_parity(w_k, w_p, n, cfg)
        dec_k = ref.decompress_wire_ref(w_k, n, cfg)
        dec_p = ref.decompress_wire_ref(w_p, n, cfg)
        if stats["flipped"] == 0:
            ref.check_decoded_close(dec_k, dec_p)
        err = float((dec_k - dec_p).abs().max())
        del dec_k, dec_p, w_k, w_p
        print(f"  {label:11s} n={n:8d} B={b:3d} in=bfloat16 e4m3 "
              f"flipped={stats['flipped']} meta_rel="
              f"{stats['meta_rel_err']:.2e} err compress_blocks_butterfly="
              f"{err:.2e}")
        e = fb.KEPT_E[b]
        reg = next((v for k, v in regs.items() if re.search(
            rf"kernelI13__nv_bfloat16Li{b}ELi{e}ELi0E", k)), None)
        work = {
            "compress_blocks_butterfly": (
                lambda: fb.compress_blocks_butterfly(blocks, cfg),
                lambda: ref.compress_blocks_butterfly_ref(blocks, cfg),
                # per element: square-add 2, alpha 1, log2(B) butterfly
                # adds, 1/sqrt(B) 1, |z| and max 2, z/s 1, clip 2, cast 1
                (9.0 + np.log2(b)) * n),
            "compress_blocks": (
                lambda: ops.compress_blocks(blocks, cfg),
                lambda: ref.compress_blocks_ref(blocks, cfg), 16.0 * n)}
        if b != 256:
            del work["compress_blocks"]
        for name, (kern, plain, nops) in work.items():
            (ms, events), plain_ms = kernel_ms(kern, KERNEL_FN[name]), \
                device_ms(plain)
            per_call, plain_call = call_ms(kern), call_ms(plain)
            # bf16 in, one payload byte out, alpha and s f32 per row
            b_ms, b_by = bound(2 * n + n + 8 * m, nops)
            print(f"    {name:26s} {label:6s} device: kernel {ms:.6f} ms "
                  f"({events} launches traced)  plain {plain_ms:.6f} ms  "
                  f"bound {b_ms:.7f} ms ({b_by}); per call: kernel "
                  f"{per_call:.6f} ms  plain {plain_call:.6f} ms")
            r = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "max_abs_err": err, "call_ms": per_call,
                 "plain_call_ms": plain_call}
            if name == "compress_blocks_butterfly":
                r.update(share=b_ms / ms, tb_s=(3 * n + 8 * m) / ms / 1e9,
                         copy_tb_s=copy_tb_s, e=e, lanes=b // e,
                         flipped=stats["flipped"],
                         meta_rel_err=stats["meta_rel_err"],
                         registers=reg and reg[0], spilled=reg and reg[1])
                print(f"      share {r['share']:.3f} of the bound; "
                      f"{r['tb_s']:.4f} TB/s (copy_ {copy_tb_s:.4f}); E = "
                      f"{e}, {b // e} lanes a row; registers "
                      f"{r['registers']}, spilled bytes {r['spilled']}")
            rows.setdefault(name, {})[label] = r
        del blocks, q, a, s, qp, ap, sp
    torch.cuda.empty_cache()
    return rows


def phase_nonfinite() -> dict:
    """K1-K7 on rows holding NaN or inf against their plain versions on
    the card (``ref.check_kernels_nonfinite``): 64 TP-like bf16 rows a
    shape with ``ref.NONFINITE_KINDS`` planted (a NaN, +inf, -inf, an
    element whose square overflows, zeros) at B = 256 and 64, at every
    format, both compute dtypes and both metadata forms (one group a row
    dual, groups of 8 folded); and the fewest rows (+2) at which K1 / K2
    take ``KEPT_E`` at an f32 compute dtype.  K1, K2 and K7 under
    ``ref.NONFINITE_RULE`` (every row's bits where they give the plain
    version's), K3-K6 NaN where the plain version is
    (``tests/test_torch_gpu.py`` adds f32 input and every group size of
    both forms).  Prints the cases held (a kernel on a configuration) and
    the values apart; any value apart fails the run."""
    from repro_torch.core.taco import TacoConfig
    from repro_torch.kernels import ash_compress as ac
    from repro_torch.kernels import ref
    gen = np.random.default_rng(3)
    sms = ac.sms(torch.cuda.current_device())
    held = {"cases": 0, "apart": 0, "shapes": 0}
    for b in (256, 64):
        kept = sms * (ac.THREADS // 32) * (32 * ac.KEPT_E[b] // b) + 2
        for m in (64, kept):
            x, rows = ref.plant_nonfinite(tp_like(gen, (m, b)), gen)
            x = x.to(DEVICE, torch.bfloat16)
            for fmt in ("e4m3", "e5m2", "int8"):
                for cd in ("float32", "bfloat16")[:1 if m == kept else 2]:
                    for meta, gs in (("dual", None), ("folded", 8)):
                        r = ref.check_kernels_nonfinite(x, TacoConfig(
                            block_size=b, fmt=fmt, compute_dtype=cd,
                            quant_group_size=gs, metadata=meta), rows)
                        held["cases"] += r["kernels"]
                        held["apart"] += r["apart"]
            held["shapes"] += 1
    torch.cuda.synchronize()
    print(f"  {held['cases']} cases held on {held['shapes']} shapes (B = 256 "
          f"and 64; {len(ref.NONFINITE_KINDS)} planted rows each), "
          f"{held['apart']} values apart ({ref.NONFINITE_RULE})")
    return held


def phase_f1(kernels) -> dict:
    """One hop of each ablation configuration (``F1_SPECS``: encode to the
    wire, decode, peer-sum decode) on the card against the same hop on the
    CPU, held by ``ref.check_hop_parity`` (the wire bit for bit where
    ``ref.plain_bits`` holds, ``b128``; else the parity rule, under a bf16
    compute dtype one bf16 ulp and a flip in 1e-3 of the payload bytes),
    by the route of ``kernels.ops``: a configuration with no kernel
    (another transform, tensor scales) runs its plain versions, launches
    no kernel and counts every operator call in ``ops.plain_routes``;
    ``b128`` and ``cdbfloat16`` launch the kernels and count nothing
    there."""
    from repro_torch.core.registry import codec_from_spec
    from repro_torch.kernels import ops, ref
    gen = np.random.default_rng(4)
    out = {}
    for spec in F1_SPECS:
        codec = codec_from_spec(spec)
        x = tp_like(gen, (4, 256 * 512))
        for c in kernels.values():
            c.launches = 0
        for k in ops.plain_routes:
            ops.plain_routes[k] = 0
        stats = ref.check_hop_parity(codec, x, DEVICE)
        launched = {k: c.launches for k, c in kernels.items() if c.launches}
        routes = {k: v for k, v in ops.plain_routes.items() if v}
        want = "kernels" if ops.supported(codec.cfg) else "plain"
        if (want == "kernels") != bool(launched) or \
                (want == "plain") != bool(routes):
            raise AssertionError(f"{spec}: want {want}; kernels launched "
                                 f"{launched}, plain routes {routes}")
        print(f"  {spec:18s} (slots 4, n {x.shape[1]}) card vs CPU: bitwise "
              f"{stats['bitwise']}, flipped "
              f"{stats['flipped']}, meta_rel {stats['meta_rel_err']:.2e}, "
              f"decode {stats['decode_rel_err']:.2e}, decode_sum "
              f"{stats['decode_sum_rel_err']:.2e}; {want}: launched "
              f"{launched}, plain routes {routes}")
        out[spec] = dict(stats, route=want, launched=launched,
                         plain_routes=routes)
    for c in kernels.values():
        c.launches = 0
    for k in ops.plain_routes:
        ops.plain_routes[k] = 0
    return out


def no_plain_routes(label: str) -> None:
    """A main-path run took only kernels: ``ops.plain_routes`` is 0."""
    from repro_torch.kernels import ops
    if any(ops.plain_routes.values()):
        raise AssertionError(f"{label}: plain routes on the card "
                             f"{ops.plain_routes}")
    print(f"  {label}: plain routes {ops.plain_routes}")


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_group_parity(group) -> None:
    """Smoke size through the 1-rank NCCL group, on both codec routes: the
    hops of a smoke training step (batch 2 x seq 64 x d 128, bf16), forward
    and backward, and the smoke model's loss, under the ring of
    ``RING_SPEC`` (``schedule`` pipelined and serial) must equal the
    monolithic ``tp=taco:folded`` bit for bit."""
    from repro_torch.configs import get_config, make_plan, smoke_config
    from repro_torch.core import collectives as cc
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model
    gen = np.random.default_rng(3)
    x = tp_like(gen, (2, 64, 128)).to(DEVICE, torch.bfloat16)
    ct = tp_like(gen, (2, 64, 128)).to(DEVICE, torch.bfloat16)
    cfg = smoke_config(get_config("qwen2-0.5b"))
    model = Model(cfg, make_plan(cfg, 1, 1))
    params = model.init(0)
    batch = SyntheticLM.place(SyntheticLM(DataConfig(cfg.vocab_size, 64, 2))
                              .batch(0), model.device)

    def run(spec):
        plan = from_spec(spec)
        c = plan.tp_fwd
        out = []
        for fn in (cc.all_gather_c, cc.psum_scatter_c):
            xx = x.clone().requires_grad_(True)
            y = fn(xx, group, 1, c, c)
            y.backward(ct)
            out += [y.detach(), xx.grad]
        out.append(cc.allreduce_g(x, group, c, c))
        with torch.no_grad():
            loss_sum, count, _ = model.loss_parts(
                params, batch, ParallelCtx(plan=plan, group=group))
        out.append(loss_sum / count)
        return out

    for route, budget in (("wire", 1 << 62), ("blocks", 0)):
        with wire_budget(budget), nccl_calls() as calls:
            mono = run("tp=taco:folded")
            for spec in (RING_SPEC, RING_SPEC + ":schedule=serial"):
                for i, (got, want) in enumerate(zip(run(spec), mono)):
                    if not torch.equal(got, want):
                        raise AssertionError(f"{spec}, {route} route: output "
                                             f"{i} differs from the "
                                             "monolithic hop")
        print(f"  smoke {route:6s} route: {RING_SPEC} (pipelined, serial) =="
              f" tp=taco:folded bit for bit (AG, RS fwd+bwd, AR, loss "
              f"{float(mono[-1]):.6f}); torch.distributed calls "
              f"{({k: v for k, v in calls.items() if v})}")


def want_per_step(cfg, model_plan, comm_plan, ticks: int = 1, sp: int = 1,
                  sp_mode: str = "ulysses") -> dict:
    """Block-kernel launches per training step, derived from the code: each
    compressed hop of ``models.transformer.tp_hops_per_step`` runs one
    compress and one decompress (all-gather) or decompress-reduce
    (reduce-scatter) per ring chunk (``chunks=1``: the monolithic hop);
    each sp hop over a seq group of ``sp`` ranks (an all-to-all or a
    permute, never chunked) one compress and one decompress.
    Under ``escalate=`` each hop also decodes one wire row back for its
    error probe (``collectives._err_probe``, on chunk 0 of a ring): one
    more decompress a hop.  The pipeline step
    (``train/pipeline_parallel.py``) runs the whole model's hops of its
    stage once a tick: ``ticks`` = M + P - 1 (at pipe = 1 each tick is one
    microbatch's step).  An identity TP plan launches none."""
    from repro_torch.core import collectives as cc
    from repro_torch.models import transformer
    hops = transformer.tp_hops_per_step(cfg, model_plan, comm_plan, sp,
                                        sp_mode)
    sp_hops = ticks * (hops["all_to_all"] + hops["permute"])
    chunks = {cc.ring_chunks(comm_plan.tp_fwd), cc.ring_chunks(comm_plan.tp_bwd)}
    if len(chunks) != 1:
        raise AssertionError(f"forward and backward codecs chunk apart: "
                             f"{chunks}")
    probed = {getattr(comm_plan.tp_fwd, "escalate", None) is not None,
              getattr(comm_plan.tp_bwd, "escalate", None) is not None}
    if len(probed) != 1:
        raise AssertionError("forward and backward codecs probe apart")
    on = ticks * (not comm_plan.tp_identity)
    k = chunks.pop() * on
    ag, rs = hops["all_gather"] * k, hops["reduce_scatter"] * k
    probes = (hops["all_gather"] + hops["reduce_scatter"]) * on \
        * probed.pop()
    return {"compress_blocks": ag + rs + sp_hops,
            "decompress_blocks": ag + probes + sp_hops,
            "decompress_reduce": rs, "compress_wire": 0, "decompress_wire": 0,
            "decompress_reduce_wire": 0, "compress_blocks_butterfly": 0}


def count_attempts(trainer, counters, rows: list) -> None:
    """Every attempt at a step (``Trainer._attempt``: the phase with every
    hop of the step; a replayed step makes two) appends ``(plan, kernel
    launches)`` to ``rows``, the plan being the variant the engine built
    that step function for."""
    names = list(counters)
    inner = trainer._attempt

    def attempt(fn, params, batch):
        before = [counters[k].launches for k in names]
        out = inner(fn, params, batch)
        plan = next(p for p, f in trainer.policy._fns.items() if f is fn)
        rows.append((plan, [counters[k].launches - b
                            for k, b in zip(names, before)]))
        return out
    trainer._attempt = attempt


@contextlib.contextmanager
def nccl_calls():
    """Count the ``torch.distributed`` calls the port makes inside the
    block, by name (the port calls them as attributes of the module)."""
    import torch.distributed as dist
    names = ("all_gather_into_tensor", "all_to_all_single", "all_reduce",
             "reduce_scatter_tensor", "batch_isend_irecv", "broadcast")
    counts = dict.fromkeys(names, 0)
    saved = {n: getattr(dist, n) for n in names}

    def counted(name):
        def call(*a, **k):
            counts[name] += 1
            return saved[name](*a, **k)
        return call
    for n in names:
        setattr(dist, n, counted(n))
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


@contextlib.contextmanager
def depth(launcher, layers):
    """Within the block, the launcher module's config lookup
    (``launcher.get_config``) gives the arch cut to ``layers`` layers
    (None: its full depth); the launchers have no depth flag, as the JAX
    package's have none."""
    full = launcher.get_config
    if layers is not None:
        launcher.get_config = lambda name: dataclasses.replace(
            full(name), n_layers=layers)
    try:
        yield
    finally:
        launcher.get_config = full


def launcher_trainer(spec, groups, layers=QWEN_LAYERS):
    """Full-width qwen2-0.5b cut to ``layers`` layers through the train
    launcher's entry points (``groups``: a TP process group, a
    ``launch.mesh.Mesh`` or None): (trainer, launches a step as
    derived)."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import Mesh
    args = train.parse_args([
        "--arch", "qwen2-0.5b", TRAIN_SIZE, "--comm-spec", spec,
        "--steps", str(TRAIN_STEPS), "--seq", str(TRAIN_SEQ), "--batch",
        str(TRAIN_BATCH), "--lr", "3e-4", "--seed", "0"])
    mesh = groups if isinstance(groups, Mesh) else None
    group = None if mesh is not None else groups
    with depth(train, layers):
        trainer, cfg = train.build_trainer(args, group=group, mesh=mesh)
    return trainer, lambda plan: want_per_step(cfg, trainer.model.plan, plan)


def engine_at(layers):
    """``make`` of :func:`phase_serve`: the serve launcher's engine on the
    arch cut to ``layers`` layers (None: its full depth)."""
    def make(args, group):
        from repro_torch.launch import serve
        with depth(serve, layers):
            return serve.build_engine(args, group)
    return make


def phase_train(counters, runs, make=launcher_trainer,
                sessions: int = 1, replay=None, steps: int = TRAIN_STEPS,
                warm: int = TRAIN_WARM) -> dict:
    """Training runs, one per ``(label, spec, groups)``, each built by
    ``make(spec, groups) -> (trainer, launches a step)`` (default: the
    train launcher on qwen2-0.5b as phase 3; the launches a dict, or a
    function of the plan variant an attempt ran): per-attempt launches,
    losses, wall and peak memory, and one step profiled ``sessions``
    times; under a compressed ``grad_rs`` codec also the codec's device
    time a step (:func:`grad_codec_profile`), and ``replay(ctx,
    one_step)`` when given (its dict under ``"replay"``).  ``make``'s
    trainer runs ``steps`` steps, of which the first ``warm`` are not
    timed."""
    from repro_torch.core.codecs import IdentityCodec
    from repro_torch.kernels import ops
    names = list(counters)
    out = {}
    for label, spec, groups in runs:
        trainer, want = make(spec, groups)
        want_of = want if callable(want) else (lambda plan, w=want: w)
        attempts = []
        count_attempts(trainer, counters, attempts)
        inner = trainer.step_fn_for
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        for k in ops.plain_routes:
            ops.plain_routes[k] = 0
        with nccl_calls() as calls:
            params, opt, hist = trainer.run()
        launches = dict(zip(names, (counters[k].launches for k in names)))
        state = storage_bytes(params, opt)
        no_plain_routes(f"train {label}")
        peak = torch.cuda.max_memory_allocated() / 2**20
        want_row = [want_of(trainer.ctx.plan)[k] for k in names]
        per_step = [row for _, row in attempts]
        wants = [[want_of(plan)[k] for k in names] for plan, _ in attempts]
        if per_step != wants or len(attempts) < steps:
            raise AssertionError(f"{label}: per-attempt launches "
                                 f"{per_step}, want {wants} ({names})")
        if [launches[k] for k in names] != \
                [sum(col) for col in zip(*wants)]:
            raise AssertionError(f"{label}: launches {launches}")
        for h in hist:
            if not np.isfinite(h["loss"]) or not np.isfinite(h["grad_norm"]):
                raise AssertionError(f"{label}: non-finite step {h}")
            print(f"  {label:8s} step {h['step']} loss {h['loss']:.6f} "
                  f"grad_norm {h['grad_norm']:.6f} lr {h['lr']:.3e} "
                  f"wall {h['ms']:.3f} ms tok/s {h['tok_per_s']:.1f}")
        timed = hist[warm:]
        mean_ms = sum(h["ms"] for h in timed) / len(timed)
        print(f"  {label:8s} ({spec}, groups "
              f"{'none' if groups is None else type(groups).__name__}, "
              f"{trainer.model.cfg.name}) "
              f"{len(timed)} timed steps: mean wall {mean_ms:.3f}"
              f" ms/step, {TRAIN_BATCH * TRAIN_SEQ / mean_ms * 1e3:.1f} tok/s"
              f", peak memory {peak:.1f} MiB, launches/step "
              f"{dict(zip(names, want_row))}, torch.distributed calls per "
              f"step {({k: v / steps for k, v in calls.items() if v})}")
        # one more step, timed alone and then profiled
        batch = trainer.data.place(trainer.data.batch(steps),
                                   trainer.model.device)
        fn = inner(steps)

        def one():
            fn(params, opt, batch)
        # the run's steps warmed this step function
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof = device_profile(one, iters=1, sessions=sessions, warm=False)
        busy = sum(prof.values())
        taco_ms = sum(v for k, v in prof.items() if "compress" in k)
        top = [(k[:50], round(v, 3))
               for k, v in sorted(prof.items(), key=lambda kv: -kv[1])[:6]]
        print(f"    one step: wall {wall:.3f} ms, device busy {busy:.3f} ms,"
              f" idle share {1 - busy / wall:.3f}, TACO kernels "
              f"{taco_ms:.3f} ms; top {top}")
        out[label] = {"hist": hist, "launches": launches, "per_step": want_row,
                      "attempts": attempts, "state_bytes": state,
                      "cfg": trainer.model.cfg,
                      "peak_mib": peak, "mean_ms": mean_ms,
                      "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / mean_ms * 1e3,
                      "step_profile": {"wall_ms": wall, "device_ms": busy,
                                       "idle_share": 1 - busy / wall,
                                       "taco_kernels_ms": taco_ms}}
        if trainer.ctx.plan.grad_rs != IdentityCodec():
            out[label]["grad_codec"] = grad_codec_profile(trainer.ctx, one)
        if replay is not None:
            out[label]["replay"] = replay(trainer.ctx, one)
        trainer._attempt = inner = fn = None
        del trainer, params, opt, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def grad_codec_profile(ctx, one_step) -> dict:
    """Device time a training step spends in its weight gradients' codec
    hops (the ``grad_rs`` reduce-scatter of every weight gather's
    backward, both fsdp stages): the hops of one step are captured (shape,
    dim), then replayed on bf16 tensors of those shapes through the same
    collective and profiled: all the device activity of the replay, the
    codec's ops and whatever the collectives launch."""
    from repro_torch.core import collectives as cc
    hops = []
    impl = cc._rs_impl

    def capture(x, group, dim, codec):
        if group is ctx.fsdp_groups:
            hops.append((tuple(x.shape), dim))
        return impl(x, group, dim, codec)
    cc._rs_impl = capture
    try:
        one_step()
    finally:
        cc._rs_impl = impl
    torch.cuda.synchronize()
    bufs = {shape: torch.randn(shape, device="cuda", dtype=torch.bfloat16)
            for shape in {h[0] for h in hops}}

    def replay():
        for shape, dim in hops:
            cc._rs_impl(bufs[shape], ctx.fsdp_groups, dim, ctx.plan.grad_rs)
    prof = device_profile(replay, iters=1)
    codec = sum(prof.values())
    top = [(k[:60], round(v, 3)) for k, v in
           sorted(prof.items(), key=lambda kv: -kv[1])[:6]]
    elems = sum(int(np.prod(s)) for s, _ in hops)
    print(f"    grad_rs codec a step: {len(hops)} weight-gradient hops of "
          f"{elems} elements in all, each over {len(ctx.fsdp_groups)} "
          f"stages; device {codec:.3f} ms; top {top}")
    del bufs
    torch.cuda.empty_cache()
    return {"hops": len(hops), "elements": elems, "codec_ms": codec,
            "top": top}


def mesh_loss_grads(model, params, batch, ctx):
    """The train step's loss and finalized grads, without the update."""
    from repro_torch.core.collectives import psum_exact
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import dp_axes
    flat = adamw.leaves(params)
    for q in flat:
        q.requires_grad_(True)
    loss_sum, count, _ = model.loss_parts(params, batch, ctx)
    dp = tuple(ctx.axis_group(a) for a in dp_axes(model))
    loss = psum_exact(loss_sum, dp) / \
        psum_exact(count.detach(), dp).clamp_min(1.0)
    loss.backward()
    grads = [torch.zeros_like(q) if q.grad is None else q.grad for q in flat]
    for q in flat:
        q.grad = None
        q.requires_grad_(False)
    grads = adamw.finalize_grads(grads, model, ctx.comm, ctx.fsdp_groups)
    return loss.detach(), grads


def phase_dp_parity(mesh) -> None:
    """Smoke size through the mesh's 1-rank NCCL groups (pod, data,
    model): under ``DP_SPEC`` every weight gather's backward crosses the
    codec at both fsdp stages (2 x 16 hops); the ring ``chunks=4``
    (pipelined and serial) gives the monolithic hop's loss and grads bit
    for bit; one train step on the card agrees with the CPU (no groups,
    the plain path; loss 1e-3, grad norm 5e-2 relative); and the codec at
    one full-width weight gradient (the MLP's w1, 896 x 4864, bf16) on the
    card holds the parity rule of ``core/dp_compress.py`` against the
    CPU."""
    from repro_torch.configs import get_config, make_plan, smoke_config
    from repro_torch.core import collectives as cc
    from repro_torch.core import dp_compress
    from repro_torch.core.codecs import Sdp4BitCodec
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import build_train_step
    cfg = smoke_config(get_config("qwen2-0.5b"))
    plan = make_plan(cfg, 1, 1)
    cpu, gpu = Model(cfg, plan, device="cpu"), Model(cfg, plan)
    init = cpu.init(0)
    host = SyntheticLM(DataConfig(cfg.vocab_size, 64, 2)).batch(0)
    batch = SyntheticLM.place(host, gpu.device)
    hops = []
    one = cc._rs_one

    def counted(x, group, dim, codec):
        if isinstance(codec, Sdp4BitCodec):
            hops.append(group)
        return one(x, group, dim, codec)
    cc._rs_one = counted
    try:
        with nccl_calls() as calls:
            mono = mesh_loss_grads(gpu, tree_map(lambda a: a.cuda(), init),
                                   batch, mesh.parallel_ctx(from_spec(DP_SPEC)))
    finally:
        cc._rs_one = one
    if hops != list(mesh.fsdp_groups) * 16:
        raise AssertionError(f"{len(hops)} grad_rs codec hops, want 2 x 16 "
                             "(pod, then data)")
    for spec in (DP_SPEC + ":chunks=4", DP_SPEC + ":chunks=4:schedule=serial"):
        loss, grads = mesh_loss_grads(gpu, tree_map(lambda a: a.cuda(), init),
                                      batch, mesh.parallel_ctx(from_spec(spec)))
        if not torch.equal(loss, mono[0]) or \
                not all(torch.equal(a, b) for a, b in zip(grads, mono[1])):
            raise AssertionError(f"{spec}: loss or grads differ from the "
                                 "monolithic hop")
    print(f"  smoke {DP_SPEC} through the 1-rank pod / data / model groups: "
          f"{len(hops)} grad_rs codec hops (pod, data per weight gather); "
          f"chunks=4 (pipelined, serial) == monolithic bit for bit (loss "
          f"{float(mono[0]):.6f}, {len(mono[1])} grads); torch.distributed "
          f"calls {({k: v for k, v in calls.items() if v})}")
    oc = adamw.OptConfig(lr_max=1e-3, lr_min=1e-4, warmup_steps=2,
                         total_steps=10)
    res = {}
    for where, model, ctx, b in (
            ("cpu", cpu, ParallelCtx(plan=from_spec(DP_SPEC)), host),
            ("card", gpu, mesh.parallel_ctx(from_spec(DP_SPEC)), batch)):
        params = tree_map(lambda a: a.to(model.device).clone(), init)
        _, _, m = build_train_step(model, ctx, oc)(
            params, adamw.init_opt_state(params), b)
        res[where] = (float(m["loss"]), float(m["grad_norm"]))
    (lc, gc_), (lg, gg) = res["cpu"], res["card"]
    rl, rg = abs(lg - lc) / lc, abs(gg - gc_) / gc_
    if not (np.isfinite(lg) and np.isfinite(gg)) or rl > 1e-3 or rg > 5e-2:
        raise AssertionError(f"{DP_SPEC} train step: card vs CPU loss "
                             f"{rl:.3e}, grad norm {rg:.3e} relative")
    print(f"  smoke {DP_SPEC} train step: card (groups) vs CPU (none) loss "
          f"{rl:.3e}, grad norm {rg:.3e} relative")
    codec = Sdp4BitCodec()
    x = tp_like(np.random.default_rng(6), (896, 4864)).bfloat16()
    n = x.numel()
    row = x.reshape(1, n)
    got = codec.encode_wire(row.cuda())
    want = codec.encode_wire(row)
    par = dp_compress.check_wire_parity(got, want, n, codec.block,
                                        x=row.float())
    exact = dp_compress.check_wire_parity(want, want, n, codec.block)
    worst = dp_compress.check_decoded(
        codec.decode_sum_wire(want.cuda(), n, torch.float32),
        codec.decode_sum_wire(want, n, torch.float32), exact["bound"],
        codec.block)
    print(f"  sdp4bit at a full-width w1 gradient (n = {n}): card vs CPU "
          f"{par['flipped']} of {par['codes']} codes differ ({par['at_ties']}"
          f" at ties), scales rel err {par['scale_rel_err']:.3e}; decode of "
          f"one wire {worst:.3e} of its bound")


# --------------------------------------------------------------------------
# phase 7: the pipeline step (3D: TACO on TP, SDP4bit on data, TahQuant at
# the stage boundaries) on full-width gpt-2.7b
# --------------------------------------------------------------------------

def pipe_trainer(mesh):
    """``make`` of :func:`phase_train` for the pipeline step: full-width
    gpt-2.7b (d 2560, 32 heads of 80, d_ff 10240, vocab 51200, learned
    positions, layernorm, gelu) cut to ``PIPE_LAYERS`` layers, through
    ``train.pipeline_parallel.build_pipeline_train_step`` on the pipe
    mesh, ``PIPE_MICRO`` microbatches, per-layer recompute, weights from
    seed 0, synthetic tokens (seed 1234), the train launcher's schedule
    (lr 3e-4 -> 3e-5)."""
    def make(spec, groups):
        import dataclasses

        from repro_torch.configs import get_config, make_plan
        from repro_torch.core.registry import from_spec
        from repro_torch.data.pipeline import DataConfig, SyntheticLM
        from repro_torch.models.model import Model
        from repro_torch.optim.adamw import OptConfig
        from repro_torch.train import pipeline_parallel as ppl
        from repro_torch.train.trainer import Trainer, TrainerConfig
        cfg = dataclasses.replace(get_config(PIPE_ARCH),
                                  n_layers=PIPE_LAYERS)
        ctx = mesh.parallel_ctx(from_spec(spec))
        model = Model(cfg, make_plan(cfg, ctx.tp_size, ctx.fsdp_size),
                      **mesh.model_kwargs())
        pc = ppl.PipeConfig(stages=mesh.size("pipe"),
                            microbatches=PIPE_MICRO)
        data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_SEQ,
                                      TRAIN_BATCH), cfg)
        oc = OptConfig(lr_max=3e-4, lr_min=3e-5,
                       warmup_steps=max(TRAIN_STEPS // 20, 5),
                       total_steps=TRAIN_STEPS)
        trainer = Trainer(
            model, ctx, oc, TrainerConfig(total_steps=TRAIN_STEPS, seed=0),
            data, build_step=lambda m, c, o: ppl.build_pipeline_train_step(
                m, c, o, pc))
        return trainer, want_per_step(cfg, model.plan, ctx.plan,
                                      ticks=PIPE_MICRO + pc.stages - 1)
    return make


def _int8_parity(codec, x, where: str) -> dict:
    """``x`` (a card tensor) as one hop row through ``codec`` (a per-group
    int8 codec: encode -> pack -> unpack -> decode) on the card and on the
    CPU: the codes must match apart from ties (``z / s`` within 1e-6 of
    k + 1/2 in f64), the scales bit for bit, and the decode of one wire
    bit for bit."""
    row = x.detach().reshape(1, -1)
    n = row.shape[-1]
    row = torch.nn.functional.pad(row, (0, (-n) % codec.group))
    pn = row.shape[-1]
    card = codec.encode_wire(row).cpu()
    host_row = row.cpu()
    host = codec.encode_wire(host_row)
    q, jq = card[0, :pn].view(torch.int8), host[0, :pn].view(torch.int8)
    s, js = card[0, pn:].view(torch.float32), host[0, pn:].view(torch.float32)
    if not torch.equal(s, js):
        raise AssertionError(f"{where}: scales differ card vs CPU")
    flipped = int((q != jq).sum())
    ties = 0
    if flipped:
        z = host_row.double().reshape(-1, codec.group) / \
            js.double()[:, None]
        frac = (z - torch.floor(z) - 0.5).abs().reshape(-1)
        diff = (q != jq)
        ties = int((diff & (frac < 1e-6)).sum())
        if ties != flipped:
            raise AssertionError(f"{where}: {flipped - ties} codes differ "
                                 "card vs CPU away from a tie")
    dec = codec.decode_wire(host.to(x.device), pn, x.dtype).cpu()
    if not torch.equal(dec, codec.decode_wire(host, pn, x.dtype)):
        raise AssertionError(f"{where}: decode differs card vs CPU")
    return {"codes": pn, "flipped": flipped, "at_ties": ties}


def pipe_replay(ctx, one_step) -> dict:
    """One taco3d step of the pipeline's hops, held and replayed at full
    width.  The hop inputs are captured: each boundary hop's activation or
    cotangent (1 x 2048 x 2560 bf16), each fsdp weight gather's shard, and
    the step's first TP all-gather and reduce-scatter input.  K1, K3 and
    K4 are held against their plain versions on the two TP inputs
    (:func:`hold_blocks`).  The boundary hops and weight gathers run
    through ``TahQuantCodec`` and ``Int8Codec`` (``weight_ag=int8``) on the
    card against the CPU (:func:`_int8_parity`, every distinct gathered
    weight once), and are replayed on the card through the same
    collectives for their device time a step (all the replay's device
    activity)."""
    from repro_torch.core import collectives as cc
    from repro_torch.core.codecs import Int8Codec, TacoCodec, TahQuantCodec
    pp_hops, gathers, tp_in = [], [], {}
    impls = {n: getattr(cc, n) for n in ("_pp_impl", "_ag_impl", "_rs_impl")}

    def pp_capture(x, group, perm, codec):
        pp_hops.append((x.detach().clone(), group, perm))
        return impls["_pp_impl"](x, group, perm, codec)

    def ag_capture(x, group, dim, codec):
        if group is ctx.fsdp_groups:
            gathers.append((x.detach(), dim))
        if isinstance(codec, TacoCodec):
            tp_in.setdefault("all-gather", (x.detach().clone(), codec))
        return impls["_ag_impl"](x, group, dim, codec)

    def rs_capture(x, group, dim, codec):
        if isinstance(codec, TacoCodec):
            tp_in.setdefault("reduce-scatter", (x.detach().clone(), codec))
        return impls["_rs_impl"](x, group, dim, codec)
    cc._pp_impl, cc._ag_impl, cc._rs_impl = pp_capture, ag_capture, rs_capture
    try:
        one_step()
    finally:
        for n, fn in impls.items():
            setattr(cc, n, fn)
    torch.cuda.synchronize()
    holds = {}
    for kind, (x, codec) in tp_in.items():
        h = hold_blocks(x.reshape(1, -1), codec.cfg, 1, x.numel(),
                        f"3d step TP {kind}")
        holds[kind] = {"shape": list(x.shape), "flipped": h["stats"]["flipped"],
                       **{k: h[k] for k in ("compress_blocks",
                                            "decompress_blocks",
                                            "decompress_reduce")}}
        print(f"    TP {kind} input of the step {list(x.shape)} "
              f"{str(x.dtype)[6:]}: K1 vs plain flipped "
              f"{h['stats']['flipped']}, max abs err K1 "
              f"{h['compress_blocks']:.2e} K3 {h['decompress_blocks']:.2e} "
              f"K4 {h['decompress_reduce']:.2e}")
    if sorted(holds) != ["all-gather", "reduce-scatter"]:
        raise AssertionError(f"TP hops of the 3d step held: {sorted(holds)}")
    tq, i8 = TahQuantCodec(), Int8Codec()
    tally = {"tahquant": dict(codes=0, flipped=0, at_ties=0),
             "int8": dict(codes=0, flipped=0, at_ties=0)}
    t0 = time.monotonic()
    for i, (x, _, _) in enumerate(pp_hops):
        for k, v in _int8_parity(tq, x, f"boundary hop {i}").items():
            tally["tahquant"][k] += v
    distinct = {}
    for x, _ in gathers:
        distinct.setdefault((x.data_ptr(), tuple(x.shape)), x)
    for key, x in distinct.items():
        for k, v in _int8_parity(i8, x, f"weight {tuple(x.shape)}").items():
            tally["int8"][k] += v
    parity_s = time.monotonic() - t0

    def replay_pp():
        for x, group, perm in pp_hops:
            cc._pp_impl(x, group, ((0, 0),) if not perm else perm, tq)

    def replay_ag():
        for x, dim in gathers:
            cc._ag_impl(x, ctx.fsdp_groups, dim, i8)
    pp_ms = sum(device_profile(replay_pp, iters=1, sessions=1).values())
    ag_ms = sum(device_profile(replay_ag, iters=1, sessions=1).values())
    out = {"boundary_hops": len(pp_hops),
           "boundary_shape": list(pp_hops[0][0].shape) if pp_hops else [],
           "weight_gathers": len(gathers), "distinct_weights": len(distinct),
           "gathered_elements": sum(x.numel() for x, _ in gathers),
           "tahquant": tally["tahquant"], "int8": tally["int8"],
           "tahquant_ms": pp_ms, "int8_ms": ag_ms, "tp_holds": holds,
           "parity_s": parity_s}
    print(f"    replay: {len(pp_hops)} boundary hops of "
          f"{out['boundary_shape']} (no peer at pipe = 1: each is sent to "
          f"itself here) through tahquant, card vs CPU "
          f"{tally['tahquant']['flipped']} of {tally['tahquant']['codes']} "
          f"codes differ ({tally['tahquant']['at_ties']} at ties), scales "
          f"bit for bit; device {pp_ms:.3f} ms a step")
    print(f"    replay: {len(gathers)} weight gathers ({len(distinct)} "
          f"distinct weights, {out['gathered_elements']} elements) through "
          f"int8, card vs CPU {tally['int8']['flipped']} of "
          f"{tally['int8']['codes']} codes differ ({tally['int8']['at_ties']}"
          f" at ties), scales bit for bit; device {ag_ms:.3f} ms a step; "
          f"parity on the CPU {parity_s:.1f} s")
    del pp_hops, gathers, distinct, tp_in
    torch.cuda.empty_cache()
    return out


def phase_pipe_parity(mesh) -> None:
    """Smoke size (gpt-2.7b cut to 4 layers, d 256) through the pipe
    mesh's 1-rank NCCL groups (pipe, data, model): the pipeline step at
    pipe = 1, ``PIPE_MICRO`` microbatches, under ``baseline`` equals
    ``build_train_step`` on the same batch (loss 1e-3, grad norm 5e-2
    relative: the microbatches sum the loss in another order, in bf16);
    under ``PIPE_SPEC`` and ``weight_ag=int8`` the card (groups) equals
    the CPU (no groups; loss 1e-3, grad norm 5e-2, as phase 4).  The
    boundary hop has no peer at pipe = 1: it makes no ``torch.distributed``
    call; every weight gather under ``weight_ag=int8`` runs the codec at
    the data stage."""
    import dataclasses

    from repro_torch.configs import get_config, make_plan, smoke_config
    from repro_torch.core import collectives as cc
    from repro_torch.core.codecs import Int8Codec
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train import pipeline_parallel as ppl
    from repro_torch.train.train_step import build_train_step
    cfg = dataclasses.replace(smoke_config(get_config(PIPE_ARCH)),
                              n_layers=4, d_model=256, n_heads=16,
                              n_kv_heads=16, d_ff=1024)
    plan = make_plan(cfg, 1, 1)
    kw = mesh.model_kwargs()
    cpu, gpu = Model(cfg, plan, device="cpu", **kw), Model(cfg, plan, **kw)
    init = cpu.init(0)
    host = SyntheticLM(DataConfig(cfg.vocab_size, 64, 8), cfg).batch(0)
    batch = SyntheticLM.place(host, gpu.device)
    oc = adamw.OptConfig(lr_max=1e-3, lr_min=1e-4, warmup_steps=2,
                         total_steps=10)
    pc = ppl.PipeConfig(stages=1, microbatches=PIPE_MICRO)

    def pipe(model, ctx, oc):
        return ppl.build_pipeline_train_step(model, ctx, oc, pc)

    def run(build, model, ctx, b):
        params = tree_map(lambda a: a.to(model.device).clone(), init)
        _, _, m = build(model, ctx, oc)(params,
                                        adamw.init_opt_state(params), b)
        return float(m["loss"]), float(m["grad_norm"])

    def close(a, b, label):
        rl, rg = abs(a[0] - b[0]) / b[0], abs(a[1] - b[1]) / b[1]
        if not (np.isfinite(a[0]) and np.isfinite(a[1])) or rl > 1e-3 or \
                rg > 5e-2:
            raise AssertionError(f"{label}: loss {rl:.3e}, grad norm "
                                 f"{rg:.3e} relative")
        return rl, rg
    hops, gathers = [], []
    pp_impl, ag_one = cc._pp_impl, cc._ag_one

    def pp_count(x, group, perm, codec):
        hops.append(perm)
        return pp_impl(x, group, perm, codec)

    def ag_count(x, group, dim, codec):
        if isinstance(codec, Int8Codec):
            gathers.append(group)
        return ag_one(x, group, dim, codec)
    base = mesh.parallel_ctx(from_spec("baseline"))
    with nccl_calls() as calls:
        cc._pp_impl = pp_count
        try:
            piped = run(pipe, gpu, base, batch)
        finally:
            cc._pp_impl = pp_impl
    plain = run(build_train_step, gpu, base, batch)
    rl, rg = close(piped, plain, "pipeline vs plain step")
    want = sum(ppl.boundary_hops_per_step(pc).values())
    if hops != [()] * want or calls["batch_isend_irecv"]:
        raise AssertionError(f"boundary hops {hops}, batch_isend_irecv "
                             f"{calls['batch_isend_irecv']}")
    print(f"  smoke {cfg.name} (4 layers, d 256), {PIPE_MICRO} microbatches "
          f"at pipe = 1: pipeline vs plain step loss {rl:.3e}, grad norm "
          f"{rg:.3e} relative; {len(hops)} boundary hops, none with a peer "
          f"(no torch.distributed call); torch.distributed calls "
          f"{({k: v for k, v in calls.items() if v})}")
    for spec in (PIPE_SPEC, "weight_ag=int8"):
        plan_ = from_spec(spec)
        cc._ag_one = ag_count
        try:
            card = run(pipe, gpu, mesh.parallel_ctx(plan_), batch)
        finally:
            cc._ag_one = ag_one
        host_res = run(pipe, cpu, ParallelCtx(plan=plan_,
                                              fsdp_axes=mesh.fsdp_axes), host)
        rl, rg = close(card, host_res, f"{spec} card vs CPU")
        n_int8 = len(gathers)
        if spec == "weight_ag=int8" and (
                not n_int8 or set(map(id, gathers)) !=
                {id(mesh.groups["data"])}):
            raise AssertionError(f"{n_int8} int8 weight gathers")
        gathers.clear()
        print(f"  smoke {spec} pipeline step: card (groups) vs CPU (none) "
              f"loss {rl:.3e}, grad norm {rg:.3e} relative"
              + (f"; {n_int8} int8 weight gathers at the data stage"
                 if n_int8 else ""))


# --------------------------------------------------------------------------
# phase 8: checkpoint, restart after an injected failure, and serving from
# the checkpoint
# --------------------------------------------------------------------------

def restart_trainer(mesh, ckpt_dir: str, injector=None):
    """Full-width qwen2-0.5b through the train launcher's entry points
    (``--ckpt``) on the 1-rank pod / data / model groups of phase 6, under
    ``DP_SPEC``: ``RESTART_STEPS`` steps, a checkpoint every
    ``RESTART_EVERY`` (the launcher's own default is max(steps / 4, 10)),
    the last one kept."""
    from repro_torch.launch import train
    args = train.parse_args([
        "--arch", "qwen2-0.5b", TRAIN_SIZE, "--comm-spec", DP_SPEC,
        "--steps", str(RESTART_STEPS), "--seq", str(TRAIN_SEQ), "--batch",
        str(TRAIN_BATCH), "--lr", "3e-4", "--seed", "0", "--ckpt", ckpt_dir])
    with depth(train, QWEN_LAYERS):
        trainer, cfg = train.build_trainer(args, mesh=mesh)
    trainer.tc.ckpt_every, trainer.tc.keep_last = RESTART_EVERY, 1
    trainer.injector = injector
    return trainer, want_per_step(cfg, trainer.model.plan, trainer.ctx.plan)


def _timed(fn, into: list):
    """``fn`` timed (host wall, after a synchronize) into ``into``."""
    def call(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        into.append(time.perf_counter() - t0)
        return out
    return call


def _state_leaves(params, opt) -> list:
    from repro_torch.optim import adamw
    return adamw.leaves(params) + adamw.leaves(
        {k: opt[k] for k in ("master", "mu", "nu")})


def _greedy(eng, prompts) -> list:
    reqs = [eng.submit(p, max_new=RESTART_GEN) for p in prompts]
    eng.run_until_drained()
    return [list(r.tokens) for r in reqs]


def phase_restart(counters, mesh, smi: str) -> dict:
    """Train ``RESTART_STEPS`` steps with a checkpoint every
    ``RESTART_EVERY`` (``Trainer.save``: the global state gathered through
    the 1-rank NCCL groups, written by ``ckpt/checkpoint.py``), then again
    with a failure injected at step ``RESTART_FAIL``: the trainer restores
    the last checkpoint and replays.  The restored state must equal the
    saved state bit for bit, the replayed run's losses and final params
    the uninterrupted run's, and every executed step launch
    ``want_per_step``'s kernels (the counts of the replayed run, set to 0
    before it).  Then the serve launcher's ``--ckpt`` builds an engine
    from the checkpoint: its greedy tokens on ``RESTART_REQUESTS``
    requests must equal those of an engine built from the in-memory
    params."""
    import shutil
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.serve.engine import ServeEngine
    names = list(counters)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(root).free / 1e9
        saves, restores, nbytes = [], [], []
        snapshot, restored_diff, per_step = {}, [], []

        def saving(trainer):
            """``trainer.save``, timed, its leaves' bytes counted, and the
            state that step RESTART_EVERY saves kept for the restore's
            check."""
            save = _timed(trainer.save, saves)

            def call(step, params, opt):
                if step == RESTART_EVERY and trainer.injector is not None:
                    snapshot["leaves"] = [t.clone() for t in
                                          _state_leaves(params, opt)]
                    snapshot["step"] = opt["step"]
                save(step, params, opt)
                d = pathlib.Path(trainer.tc.ckpt_dir) / f"step_{step:08d}"
                nbytes.append(sum(f.stat().st_size
                                  for f in d.glob("leaf_*.npy")))
            return call

        trainer, want = restart_trainer(mesh, f"{root}/ref")
        trainer.save = saving(trainer)
        params, opt, hist = trainer.run(resume=False)
        ref_losses = [h["loss"] for h in hist]
        ref_params = [t.clone() for t in _state_leaves(params, opt)]
        del trainer, params, opt, hist
        shutil.rmtree(f"{root}/ref")
        gc.collect()
        torch.cuda.empty_cache()

        trainer, _ = restart_trainer(mesh, f"{root}/run",
                                     FailureInjector([RESTART_FAIL]))
        restore = _timed(trainer.try_restore, restores)

        def restoring(params, opt):
            out = restore(params, opt)
            got = _state_leaves(out[0], out[1])
            restored_diff.append(sum(
                not torch.equal(a, b)
                for a, b in zip(got, snapshot["leaves"], strict=True)))
            if out[1]["step"] != snapshot["step"] or out[2] != RESTART_EVERY:
                raise AssertionError(f"restored step {out[2]}, opt step "
                                     f"{out[1]['step']}")
            snapshot.clear()
            return out
        trainer.save = saving(trainer)
        trainer.try_restore = restoring
        attempts = []
        count_attempts(trainer, counters, attempts)
        for c in counters.values():
            c.launches = 0
        for k in ops.plain_routes:
            ops.plain_routes[k] = 0
        params, opt, hist = trainer.run(resume=False)
        per_step = [row for _, row in attempts]
        launches = {k: counters[k].launches for k in names}
        no_plain_routes("train restart")
        want_row = [want[k] for k in names]
        executed = RESTART_STEPS + RESTART_FAIL - RESTART_EVERY
        if len(per_step) != executed or \
                any(row != want_row for row in per_step):
            raise AssertionError(f"restart: per-step launches {per_step}, "
                                 f"want {executed} x {want_row}")
        if restored_diff != [0]:
            raise AssertionError(f"restored state vs saved: {restored_diff}"
                                 " leaves differ (want one restore, 0)")
        losses = [h["loss"] for h in hist]
        final = _state_leaves(params, opt)
        diff = sum(not torch.equal(a, b)
                   for a, b in zip(final, ref_params, strict=True))
        if len(set(nbytes)) != 1 or len(nbytes) != 4:
            raise AssertionError(f"checkpoint bytes {nbytes}")
        gb = nbytes[0] / 1e9
        print(f"  {smi}: {RESTART_STEPS} steps of {DP_SPEC}, a checkpoint "
              f"every {RESTART_EVERY} ({len(final)} leaves, {gb:.3f} GB "
              f"each; {free:.1f} GB free under {root}); failure injected "
              f"at step {RESTART_FAIL}")
        for label, secs in (("save (gather + write)", saves),
                            ("restore (read + cut + to the card)",
                             restores)):
            print(f"    {label}: " + ", ".join(
                f"{t:.3f} s ({gb / t:.3f} GB/s)" for t in secs))
        print(f"    restored state vs saved state: {restored_diff[0]} of "
              f"{len(final)} leaves differ (bitwise)")
        print(f"    uninterrupted losses {ref_losses}")
        print(f"    replayed losses      {losses}")
        print(f"    final params and optimizer state: {diff} of "
              f"{len(final)} leaves differ from the uninterrupted run's; "
              f"launches {launches} over {executed} executed steps")
        if losses != ref_losses or diff:
            raise AssertionError(f"the replayed run differs: {diff} leaves,"
                                 f" losses {losses} vs {ref_losses}")
        trainer._attempt = None
        del trainer, ref_params, final
        gc.collect()
        torch.cuda.empty_cache()

        # serving from the checkpoint (the last, step RESTART_STEPS)
        args = serve.parse_args([
            "--arch", "qwen2-0.5b", "--no-smoke", "--comm-spec", "taco",
            "--max-batch", str(RESTART_REQUESTS), "--requests",
            str(RESTART_REQUESTS), "--prompt-len", "16", "--gen",
            str(RESTART_GEN), "--seed", "0", "--ckpt", f"{root}/run"])
        with depth(serve, QWEN_LAYERS):
            eng, cfg = serve.build_engine(args)
        mem = ServeEngine(eng.model, eng.ctx, params,
                          max_batch=eng.max_batch, max_len=eng.max_len,
                          prefill_buckets=eng.buckets)
        gen = np.random.default_rng(8)
        prompts = [gen.integers(0, cfg.vocab_size, 16).astype(np.int32)
                   for _ in range(RESTART_REQUESTS)]
        toks, want_toks = _greedy(eng, prompts), _greedy(mem, prompts)
        if toks != want_toks or any(len(t) != RESTART_GEN for t in toks):
            raise AssertionError(f"--ckpt engine tokens {toks}, in-memory "
                                 f"{want_toks}")
        print(f"    serve --ckpt (taco): {RESTART_REQUESTS} requests, "
              f"greedy tokens equal the in-memory params' engine: {toks}")
        eng = mem = None
        del params, opt
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "save_s": saves, "restore_s": restores,
            "bytes": nbytes, "leaves_differ": diff}


# --------------------------------------------------------------------------
# phase 9: the policy layer (ZLE stacks, negotiated slots, escalation)
# --------------------------------------------------------------------------

def phase_zle_hop(group, kernels, smi: str) -> dict:
    """One training hop at full width (``TRAIN_N`` bf16 elements, the
    last 3/4 of the sequence rows zero) through the 1-rank NCCL group,
    under ``ZLE_SPEC`` and its ring ``ZLE_RING_SPEC``: bootstrap at the
    static bound, a negotiated hop that moves less than the bound and
    equals the static hop bit for bit (all-gather and reduce-scatter), a
    dense spike that overflows, one resync replay bit-exact at the static
    bound.  The card's ZLE bytes of an inner wire equal the CPU port's bit
    for bit.  The ZLE stage's device time at this hop (encode and decode
    apart) is printed beside K1's and K3's."""
    from repro_torch.core import collectives as cc
    from repro_torch.core import lossless as zle
    from repro_torch.core.codecs import pack_wire, unpack_wire
    from repro_torch.core.registry import from_spec
    gen = np.random.default_rng(9)
    shape = (TRAIN_BATCH, TRAIN_SEQ, 896)
    x = tp_like(gen, shape).to(DEVICE, torch.bfloat16)
    x[:, TRAIN_SEQ // 4:] = 0                 # padded sequence rows
    dense = tp_like(gen, shape).to(DEVICE, torch.bfloat16)
    ident = cc.Identity
    out = {}
    for spec in (ZLE_SPEC, ZLE_RING_SPEC):
        codec = from_spec(spec).tp_fwd
        static = from_spec(spec.replace(":slot=auto", "")).tp_fwd
        ctl = cc.SlotController()

        def hops(c, v):
            return [cc.all_gather_c(v, group, 1, c, ident),
                    cc.psum_scatter_c(v, group, 1, c, ident)]
        bound_b = cc.wire_slot_bytes(codec, TRAIN_N)
        boot_c = ctl.negotiate(codec)
        if boot_c.moved_frac is not None or \
                cc.moved_slot_bytes(boot_c, TRAIN_N) != bound_b:
            raise AssertionError(f"{spec}: bootstrap is not the static bound")
        boot = hops(boot_c, x)
        if ctl.finish_step():
            raise AssertionError(f"{spec}: the static bootstrap overflowed")
        neg = ctl.negotiate(codec)
        moved_b = cc.moved_slot_bytes(neg, TRAIN_N)
        ach_b = int(cc.achieved_slot_bytes(codec, x.reshape(1, -1)).sum())
        want = hops(static, x)
        got = hops(neg, x)
        if moved_b >= bound_b or not all(
                torch.equal(a, b) for a, b in zip(got + boot, want + want)):
            raise AssertionError(f"{spec}: negotiated {moved_b} of {bound_b}"
                                 " bytes, or its hop differs from the static"
                                 " hop")
        if ctl.finish_step():
            raise AssertionError(f"{spec}: the negotiated hop overflowed")
        hops(ctl.negotiate(codec), dense)
        if not ctl.finish_step():
            raise AssertionError(f"{spec}: the dense spike did not overflow")
        replay = hops(ctl.negotiate(codec), dense)
        if ctl.finish_step() or ctl.resyncs != 1 or not all(
                torch.equal(a, b)
                for a, b in zip(replay, hops(static, dense))):
            raise AssertionError(f"{spec}: resync {ctl.resyncs}, or the "
                                 "replay differs from the static hop")
        print(f"  {smi}: {spec}, n {TRAIN_N}: bound {bound_b} B, achieved "
              f"{ach_b} B ({ach_b / bound_b:.4f}), negotiated moved "
              f"{moved_b} B ({moved_b / bound_b:.4f}, frac "
              f"{neg.moved_frac}); negotiated == static bit for bit (AG, "
              f"RS); dense spike: overflow, {ctl.resyncs} resync, replay =="
              f" static bit for bit")
        out[spec] = {"bound_b": bound_b, "achieved_b": ach_b,
                     "moved_b": moved_b, "frac": neg.moved_frac}
    # the card's ZLE bytes of an inner wire == the CPU port's
    codec = from_spec(ZLE_SPEC).tp_fwd
    flat = x.reshape(1, -1)
    inner = codec.inner.encode_wire(flat)
    w = inner.shape[-1]
    card = zle.zle_encode(inner)
    cpu = zle.zle_encode(inner.cpu())
    if not all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)) or \
            not torch.equal(zle.zle_decode(card[1], card[2], w), inner):
        raise AssertionError("ZLE bytes on the card differ from the CPU's")
    lay = codec.wire_layout(TRAIN_N)
    zwire = pack_wire(card, lay)

    def encode():
        pack_wire(zle.zle_encode(inner), lay)

    def decode():
        _, bm, data = unpack_wire(zwire, lay)
        zle.zle_decode(bm, data, w)
    enc_ms, dec_ms = device_ms(encode, 10), device_ms(decode, 10)
    k1, _ = kernel_ms(lambda: codec.inner.encode_wire(flat),
                      KERNEL_FN["compress_blocks"], iters=10)
    k3, _ = kernel_ms(lambda: codec.inner.decode_wire(inner, TRAIN_N,
                                                     torch.bfloat16),
                      KERNEL_FN["decompress_blocks"], iters=10)
    enc_call, dec_call = call_ms(encode, 10), call_ms(decode, 10)
    print(f"  {smi}: ZLE bytes card == CPU bit for bit ({w} B inner wire, "
          f"{int(card[0][0, 0])} B achieved); device ms at this hop: ZLE "
          f"encode {enc_ms:.4f} (per call {enc_call:.4f}), ZLE decode "
          f"{dec_ms:.4f} (per call {dec_call:.4f}); K1 {k1:.4f}, K3 "
          f"{k3:.4f}")
    out["zle_ms"] = {"encode": enc_ms, "decode": dec_ms, "k1": k1, "k3": k3,
                     "encode_call": enc_call, "decode_call": dec_call}
    return out


def print_policy_run(label: str, r: dict) -> None:
    """The step-by-step plans, launches and ``comm/*`` policy keys of a
    phase 9 training run (the launches by attempt, when a step was
    replayed)."""
    from repro_torch.core.registry import to_spec
    attempts = r["attempts"]
    for i, h in enumerate(r["hist"]):
        keys = {k[5:]: round(v, 6) for k, v in h.items()
                if k.startswith("comm/") and isinstance(v, float)
                and any(t in k for t in ("slot", "negotiated", "achieved",
                                         "err_ema", "escalat", "wire_var"))}
        row = attempts[i][1] if len(attempts) == len(r["hist"]) else "-"
        print(f"    {label} step {h['step']}: ran {h['plan']}, launches "
              f"{row}, loss {h['loss']:.6f}, {keys}")
    if len(attempts) != len(r["hist"]):
        print(f"    {label} attempts: "
              f"{[(to_spec(p_), row) for p_, row in attempts]}")


def phase_policy_serve(kernels, smi: str) -> dict:
    """Serving under ``POLICY_SERVE_SPEC`` through the serve launcher (as
    phase 2; every decode attempt's launches match its resolved plan),
    then :func:`forced_replay` on qwen2-0.5b."""
    run = phase_serve(kernels, [("policy", POLICY_SERVE_SPEC, None)])
    r = run["policy"]
    states = [("esc" if plan.tp_identity else "taco", row)
              for plan, row in r["attempts"]]
    print(f"    policy ticks (plan, [compress, reduce, decompress]): "
          f"{states}; {r['engine_metrics']}")
    forced_replay("qwen2-0.5b", smi, seed=10)
    return r


def forced_replay(arch: str, smi: str, seed: int) -> dict:
    """Two engines on the same full-width ``arch`` and prompts: one under
    ``ZLE_SPEC`` with a shared controller seeded from a mostly-zero
    sample (its first negotiated tick is too narrow for the dense decode
    hop: one overflow, one replay at the static bound, from the cache the
    failed run read), one under the static stack, each serving
    ``RESTART_REQUESTS`` requests of ``RESTART_GEN`` tokens on a table of
    4 slots.  Their greedy tokens must be equal."""
    from repro_torch.core import collectives as cc
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec, to_spec
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServeEngine
    args = serve.parse_args([
        "--arch", arch, "--no-smoke", "--comm-spec",
        ZLE_SPEC.replace(":slot=auto", ""), "--max-batch", "4",
        "--requests", str(RESTART_REQUESTS), "--prompt-len", "16", "--gen",
        str(RESTART_GEN), "--seed", "0"])
    static, cfg = serve.build_engine(args)
    shared = cc.SlotController()
    auto_plan = from_spec(ZLE_SPEC)
    sample = torch.zeros((1, static.max_batch * cfg.d_model),
                         device=DEVICE, dtype=torch.bfloat16)
    sample[0, :256] = 0.02
    shared.observe_sample(auto_plan.tp_fwd, sample)
    if shared.finish_step():
        raise AssertionError("the seeding sample overflowed")
    frac = shared.negotiate(auto_plan.tp_fwd).moved_frac
    auto = ServeEngine(static.model, ParallelCtx(plan=auto_plan),
                       static.params, max_batch=static.max_batch,
                       max_len=static.max_len, prefill_buckets=static.buckets,
                       device=static.device.type, slot_controller=shared)
    gen = np.random.default_rng(seed)
    prompts = [gen.integers(0, cfg.vocab_size, 16).astype(np.int32)
               for _ in range(RESTART_REQUESTS)]
    t_auto, t_static = _greedy(auto, prompts), _greedy(static, prompts)
    if shared.resyncs != 1 or t_auto != t_static:
        raise AssertionError(f"{arch} replayed engine: {shared.resyncs} "
                             f"resyncs, tokens {t_auto} vs {t_static}")
    print(f"  {smi}: {arch} under {ZLE_SPEC}: seeded frac {frac}: "
          f"{shared.overflows} overflow, {shared.resyncs} replayed tick; "
          f"greedy tokens == the static {to_spec(static.ctx.plan)} "
          f"engine's: {t_auto}")
    auto = static = None
    gc.collect()
    torch.cuda.empty_cache()
    return {"overflows": shared.overflows, "resyncs": shared.resyncs,
            "frac": list(frac), "tokens": t_auto}


# --------------------------------------------------------------------------
# phase 10: sequence parallelism (the sp hops, the ring's fold, a 1-rank
# seq group through the launcher)
# --------------------------------------------------------------------------

@contextlib.contextmanager
def a2a_bytes():
    """Count the bytes that ``dist.all_to_all_single`` calls move inside the
    block (the input of each call)."""
    import torch.distributed as dist
    moved = [0]
    inner = dist.all_to_all_single

    def call(out, inp, *a, **k):
        moved[0] += inp.numel() * inp.element_size()
        return inner(out, inp, *a, **k)
    dist.all_to_all_single = call
    try:
        yield moved
    finally:
        dist.all_to_all_single = inner


def phase_sp_hops(group, counters, smi: str) -> dict:
    """10a, 10b: each hop of ``SP_HOPS`` under ``SP_SPEC`` through the
    1-rank NCCL group (an all-to-all through ``all_to_all_c``, the ring's
    KV block through ``ppermute_c`` over the pair ``(0, 0)``), forward and
    backward.  At sp = 1 the hop encodes and decodes its one slot: one K1
    and one K3 each way and no plain route.  The card's wire rows against
    the CPU port's by the parity rule, K3's decode of them against the
    plain decode, the hop's output and its gradient the decode of the
    card's wires (the gradient the conjugate hop's) bit for bit, and the
    bytes the all-to-all moved against ``a2a_wire_bytes``.  Returns the
    launches and each hop's device time."""
    from repro_torch.core import collectives as cc
    from repro_torch.core.registry import from_spec
    from repro_torch.kernels import ops, ref
    codec = from_spec(SP_SPEC).sp
    cfg = codec.cfg
    gen = np.random.default_rng(10)
    names = list(counters)
    want = dict.fromkeys(names, 0)
    want.update(compress_blocks=1, decompress_blocks=1)
    for c in counters.values():
        c.launches = 0
    for k in ops.plain_routes:
        ops.plain_routes[k] = 0
    rows, hops = [], []
    for label, shape, dims in SP_HOPS:
        n = math.prod(shape)
        x = tp_like(gen, shape).to(DEVICE, torch.bfloat16)
        ct = tp_like(gen, shape).to(DEVICE, torch.bfloat16)

        def hop(v, g, back=False, dims=dims):
            if dims is None:
                return cc.ppermute_c(v, g, ((0, 0),), codec, codec)
            split, concat = dims[::-1] if back else dims
            return cc.all_to_all_c(v, g, split, concat, codec, codec)

        def rows_of(v, back=False, dims=dims):
            split = 0 if dims is None else dims[back]
            return torch.movedim(v, split, 0).reshape(1, -1)
        xx = x.clone().requires_grad_(True)
        before = [counters[k].launches for k in names]
        with a2a_bytes() as moved:
            y = hop(xx, group)
        fwd = [counters[k].launches - b for k, b in zip(names, before)]
        y.backward(ct)
        torch.cuda.synchronize()
        bwd = [counters[k].launches - b - f
               for k, b, f in zip(names, before, fwd)]
        if fwd != [want[k] for k in names] or bwd != fwd:
            raise AssertionError(f"sp {label}: launches forward {fwd}, "
                                 f"backward {bwd} ({names})")
        hops.append(dict(zip(names, (f + b for f, b in zip(fwd, bwd)))))
        # the card's wires against the CPU's, and what the hop decoded
        for v, back, got in ((x, False, y.detach()), (ct, True, xx.grad)):
            r = rows_of(v, back)
            wire = codec.encode_wire(r)
            stats = ref.check_compress_wire(wire,
                                            codec.encode_wire(r.cpu()), n,
                                            cfg)
            err = ref.check_decoded_close(
                codec.decode_wire(wire, n, torch.float32),
                codec.decode_wire(wire.cpu(), n, torch.float32), cfg)
            dec = codec.decode_wire(wire, n, torch.bfloat16)
            split = 0 if dims is None else dims[back]
            lead = torch.movedim(got, split, 0)
            if not torch.equal(lead.reshape(1, -1), dec):
                raise AssertionError(f"sp {label}: the hop's "
                                     f"{'gradient' if back else 'output'} is"
                                     " not the decode of its wire")
            rows.append((label, back, stats["flipped"], err))
        slot = cc.wire_slot_bytes(codec, n, chunks=1)
        half = cc.a2a_wire_bytes(shape, torch.bfloat16, 2, codec)
        if dims is not None and (
                moved[0] != slot
                or half != cc.wire_slot_bytes(codec, n // 2, chunks=1)
                or cc.a2a_wire_bytes(shape, torch.bfloat16, 1, codec) != 0):
            raise AssertionError(f"sp {label}: moved {moved[0]} B, slot "
                                 f"{slot} B, a2a_wire_bytes at sp 2 {half}")
        with torch.no_grad():
            ms = device_ms(lambda: hop(x, group), 5)
        sent = (f"the all-to-all moved {moved[0]} B through the 1-rank "
                f"group (its one slot, chunks=1); a rank of sp = 2 puts "
                f"{half:.0f} B on the wire (a2a_wire_bytes)") if dims else \
            (f"the permute's wire row is {slot} B (a copy on the 1-rank "
             "group), what a rank of sp = 2 sends a hop")
        print(f"  {smi}: sp {label} {tuple(shape)} n={n}: launches a hop "
              f"K1 1, K3 1 (forward and backward), plain routes 0; {sent};"
              f" device {ms:.4f} ms a hop; wire card vs CPU: flipped "
              f"{[r[2] for r in rows[-2:]]}, decode max abs err "
              f"{[f'{r[3]:.2e}' for r in rows[-2:]]}")
        del x, ct, xx, y
    no_plain_routes("sp hops")
    # the hops' own launches (the checks' and the timing's not counted)
    launches = {k: sum(h[k] for h in hops) for k in names}
    return {"launches": launches, "hops": hops}


def phase_sp_fold(smi: str) -> dict:
    """10d: the ring's online-softmax fold at full width on the card: one
    layer's q, k, v (bf16, (4, 2048, 14, 64), seeded) cut into 2 sequence
    blocks; each q block folds the KV blocks in the order its rank of sp =
    2 receives them (its own, then the peer's) through ``_block_partial``
    and ``_merge_partial``; against ``attention_core`` on the whole
    sequence within one bf16 output ulp, as the JAX package's
    ``tests/multidev/check_sp.py`` states it (atol 2e-2, one ulp at the
    outputs' magnitude); the largest distance in ulps of each element's
    own magnitude and the elements apart are printed."""
    from repro_torch.models import attention as ta
    gen = torch.Generator().manual_seed(12)
    q, k, v = (torch.randn((TRAIN_BATCH, TRAIN_SEQ, 14, 64), generator=gen)
               .to(DEVICE, torch.bfloat16) for _ in range(3))
    full = ta.attention_core(q, k, v, causal=True, window=None).float()
    sp, s = 2, TRAIN_SEQ // 2
    worst = apart = 0.0
    ulps = 0.0
    for i in range(sp):
        qf = q[:, i * s:(i + 1) * s].transpose(1, 2).float() / np.sqrt(64)
        q_pos = i * s + torch.arange(s, device=DEVICE)
        state = None
        for t in range(sp):
            src = (i - t) % sp
            blk = slice(src * s, (src + 1) * s)
            part = ta._block_partial(
                qf, k[:, blk].transpose(1, 2), v[:, blk].transpose(1, 2),
                ta._block_bias(q_pos, src * s + torch.arange(
                    s, device=DEVICE), causal=True, window=None))
            state = part if state is None else ta._merge_partial(state, part)
        acc, _, l = state
        got = (acc / l.clamp_min(1e-30)[..., None]).transpose(1, 2).to(
            torch.bfloat16).float()
        want = full[:, i * s:(i + 1) * s]
        diff = (got - want).abs()
        worst = max(worst, float(diff.max()))
        apart += float((diff > 0).sum())
        big = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
        ulps = max(ulps, float((diff / torch.exp2(
            torch.floor(torch.log2(big)) - 7)).max()))
        if worst > 2e-2:
            raise AssertionError(f"ring fold, block {i}: {worst} from "
                                 "attention_core (atol 2e-2)")
    print(f"  {smi}: ring fold at full width (2 blocks of {s}) vs "
          f"attention_core: max |difference| {worst:.3e} (atol 2e-2), "
          f"{apart:.0f} of {full.numel()} elements apart, at most "
          f"{ulps:.3g} bf16 ulps of their own magnitude")
    return {"max_abs": worst, "apart": apart, "ulps": ulps}


def phase_sp_train(counters, trained, mesh) -> dict:
    """10e: phase 3's taco cell through the train launcher with the seq
    mesh's 1-rank groups (``mesh``, a seq group of one rank threaded
    through) under ``tp=taco,`` + ``SP_SPEC``, once with each
    ``--sp-mode``, ``SP_TRAIN_STEPS`` steps: at sp = 1 both flavours run
    the monolithic core and move no sp hop, as in the JAX package, so every
    attempt launches phase 3's taco counts and the losses are phase 3's
    first ones bit for bit."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    names = list(counters)
    base = trained["taco"]
    out = {}
    for mode in ("ulysses", "ring"):
        args = train.parse_args([
            "--arch", "qwen2-0.5b", TRAIN_SIZE, "--comm-spec",
            f"tp=taco,{SP_SPEC}", "--steps", str(SP_TRAIN_STEPS), "--seq",
            str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--lr", "3e-4",
            "--seed", "0", "--sp-mode", mode])
        with depth(train, QWEN_LAYERS):
            trainer, cfg = train.build_trainer(args, mesh=mesh)
        if not trainer.ctx.sp_active or trainer.ctx.sp_size() != 1:
            raise AssertionError(f"sp {mode}: no 1-rank seq group")
        want = want_per_step(cfg, trainer.model.plan, trainer.ctx.plan,
                             sp=1, sp_mode=mode)
        if [want[k] for k in names] != base["per_step"]:
            raise AssertionError(f"sp {mode}: derived launches {want}, "
                                 f"phase 3 {base['per_step']}")
        attempts = []
        count_attempts(trainer, counters, attempts)
        for c in counters.values():
            c.launches = 0
        for k in ops.plain_routes:
            ops.plain_routes[k] = 0
        _, _, hist = trainer.run()
        no_plain_routes(f"train sp {mode}")
        per = [row for _, row in attempts]
        if per != [base["per_step"]] * SP_TRAIN_STEPS:
            raise AssertionError(f"sp {mode}: launches {per}, want phase "
                                 f"3's {base['per_step']} a step")
        losses = [h["loss"] for h in hist]
        first = [h["loss"] for h in base["hist"][:SP_TRAIN_STEPS]]
        if losses != first:
            raise AssertionError(f"sp {mode}: losses {losses}, phase 3's "
                                 f"{first}")
        print(f"  train sp {mode} (tp=taco,{SP_SPEC}, a 1-rank seq group): "
              f"{SP_TRAIN_STEPS} steps, launches a step phase 3's "
              f"{dict(zip(names, base['per_step']))}, losses {losses} == "
              f"phase 3's bit for bit; wall "
              f"{[round(h['ms'], 3) for h in hist]} ms")
        out[mode] = dict(zip(names, (counters[k].launches for k in names)))
        trainer._attempt = None
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 11: the MoE family (grok-1-314b at full width, MOE_LAYERS layers)
# --------------------------------------------------------------------------

def moe_model():
    """Full-width grok-1-314b cut to MOE_LAYERS of its 64 layers, its
    weights drawn once (seed 0) on the card: (serve model, train model,
    params).  Both models take the same weights: their plans differ only
    in recompute (the serve launcher's and the train launcher's)."""
    import dataclasses

    from repro_torch.configs import get_config, make_plan
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    serve_model = Model(cfg, make_plan(cfg, 1, 1, remat=False))
    train_model = Model(cfg, make_plan(cfg, 1, 1))
    return serve_model, train_model, serve_model.init(0)


def phase_moe(kernels, smi: str) -> dict:
    """Phase 11: the weights drawn once, then 11a, 11b and 11c.  11b holds
    the weights (21.3 GiB), their bf16 grads and a recomputed layer's
    saved tensors (its f32 attention ~13 GiB), so the allocator grows its
    segments in place from here on: no fragmentation left over from the
    earlier phases."""
    from repro_torch.optim import adamw
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    t0 = time.monotonic()
    serve_model, train_model, params = moe_model()
    torch.cuda.synchronize()
    print(f"  {MOE_ARCH}, {MOE_LAYERS} layers: "
          f"{sum(p.numel() for p in adamw.leaves(params)) / 1e9:.3f} B "
          f"weights, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, drawn in "
          f"{time.monotonic() - t0:.1f} s")
    served = phase_serve(kernels, [("moe base", "baseline", None),
                                   ("moe taco", "taco", None)],
                         arch=MOE_ARCH, make=moe_engine(serve_model, params))
    print(f"  {smi}: moe serving peak memory "
          f"{[round(r['engine_peak_mib'], 1) for r in served.values()]} MiB")
    grads = phase_moe_grads(kernels, train_model, params, smi)
    del params, serve_model, train_model
    gc.collect()
    torch.cuda.empty_cache()
    small = phase_moe_small(smi)
    print(f"  phase 11 took {time.monotonic() - t0:.1f} s")
    return {"served": served, "grads": grads, "small": small}


def moe_engine(model, params):
    """``make`` of :func:`phase_serve` for phase 11: the serve launcher's
    engine (``launch.serve.make_engine``) around ``model`` and the weights
    drawn once.  The launcher has no depth flag (nor has the JAX
    package's), so the engine is built from its pieces."""
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.launch import serve

    def make(args, group):
        ctx = ParallelCtx(plan=from_spec(serve.resolve_comm_spec(args)),
                          group=group)
        return serve.make_engine(args, model, ctx, params), model.cfg
    return make


def phase_moe_grads(counters, model, params, smi: str) -> dict:
    """11b: ``train_step.build_train_step(...).grads`` (every hop of a step,
    no update: AdamW's f32 state of 11.45 B weights does not fit one card)
    on MOE_CALLS SyntheticLM batches of MOE_BATCH x MOE_SEQ, under
    ``baseline`` and ``taco``: every call launches :func:`want_per_step`'s
    block kernels (one dispatch group of 4096 tokens; per-layer
    recompute, phase 3's plan), no plain route; losses and the balance
    loss finite, taco's loss within 5e-2 of baseline's; one more call
    profiled."""
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import build_train_step
    cfg = model.cfg
    data = SyntheticLM(DataConfig(cfg.vocab_size, MOE_SEQ, MOE_BATCH), cfg)
    batches = [data.place(data.batch(i), model.device)
               for i in range(MOE_CALLS)]
    names = list(counters)
    out = {}
    for label in ("baseline", "taco"):
        ctx = ParallelCtx(plan=from_spec(label))
        step = build_train_step(model, ctx, adamw.OptConfig())
        want = want_per_step(cfg, model.plan, ctx.plan)
        auxes = []
        inner = model.loss_parts

        def loss_parts(p, b, c, inner=inner, auxes=auxes):
            parts = inner(p, b, c)
            auxes.append(parts[2].detach())
            return parts
        model.loss_parts = loss_parts
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        for k in ops.plain_routes:
            ops.plain_routes[k] = 0
        rows, losses, walls = [], [], []
        for b in batches:
            before = [counters[k].launches for k in names]
            t0 = time.perf_counter()
            loss = step.grads(params, b)[1]      # the grads go at once
            losses.append(float(loss.detach()))
            walls.append((time.perf_counter() - t0) * 1e3)
            rows.append({k: counters[k].launches - n
                         for k, n in zip(names, before)})
        launches = {k: counters[k].launches for k in names}
        no_plain_routes(f"moe grads {label}")
        peak = torch.cuda.max_memory_allocated() / 2**20
        if any(row != want for row in rows):
            raise AssertionError(f"moe grads {label}: launches a call "
                                 f"{rows}, want {want}")
        aux = [float(a) for a in auxes]
        if not all(np.isfinite(v) for v in losses + aux):
            raise AssertionError(f"moe grads {label}: losses {losses}, "
                                 f"aux {aux}")

        def one(step=step):
            step.grads(params, batches[0])
        torch.cuda.synchronize()
        prof = device_profile(one, iters=1, sessions=1, warm=False)
        model.loss_parts = inner
        busy = sum(prof.values())
        taco_ms = sum(v for k, v in prof.items() if "compress" in k)
        top = [(k[:50], round(v, 3))
               for k, v in sorted(prof.items(), key=lambda kv: -kv[1])[:6]]
        print(f"  {smi}: moe grads {label}: losses {losses} (the "
              f"cross-entropy), aux {aux} (summed over the layers), wall "
              f"{[round(w, 3) for w in walls]} ms a call, launches a call "
              f"{rows[0]}, peak memory {peak:.1f} MiB; one profiled call: "
              f"device busy {busy:.3f} ms, TACO kernels {taco_ms:.3f} ms; "
              f"top {top}")
        out[label] = {"losses": losses, "aux": aux, "walls_ms": walls,
                      "launches": launches, "per_call": rows[0],
                      "peak_mib": peak, "device_ms": busy,
                      "taco_kernels_ms": taco_ms}
        del step, one
        gc.collect()
        torch.cuda.empty_cache()
    for p in adamw.leaves(params):
        p.requires_grad_(False)
    for a, b in zip(out["baseline"]["losses"], out["taco"]["losses"]):
        if abs(b - a) / abs(a) > 5e-2:
            raise AssertionError(f"moe grads: taco loss {b} vs baseline {a}")
    return out


def phase_moe_small(smi: str) -> dict:
    """11c: ``moe_apply`` on the card against the CPU at a small width
    (MOE_SMALL: d 256, 8 experts, top-2, 512 tokens, geglu, one group):
    every token routes alike (its experts, in order, and which choices
    are kept) but those whose CPU logits lie within one bf16 ulp of a tie
    (the gap between neighbours among its top k + 1, against 2^-8 of its
    largest |logit|), which are counted; the rows that route alike agree
    within 2e-2 relative, the balance loss within 1e-5."""
    import types

    from repro_torch.configs.base import MoeConfig
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.models import moe
    d, e, k, t = (MOE_SMALL[n] for n in ("d", "experts", "top_k", "tokens"))
    cfg = types.SimpleNamespace(moe=MoeConfig(e, k), mlp="geglu")
    gen = np.random.default_rng(11)

    def bf16(shape, scale):
        return torch.from_numpy((gen.normal(size=shape) * scale)
                                .astype(np.float32)).bfloat16()
    x = bf16((1, t, d), 1.0)
    p = {"router": bf16((d, e), 0.01), "w1": bf16((e, d, 4 * d), 0.02),
         "w3": bf16((e, d, 4 * d), 0.02), "w2": bf16((e, 4 * d, d), 0.02)}
    ctx = ParallelCtx()
    cap = moe._capacity(t, e, k, cfg.moe.capacity_factor)

    def run(dev):
        xx = x.to(dev)
        pp = {n: v.to(dev) for n, v in p.items()}
        out, aux = moe.moe_apply(xx, pp, cfg, None, ctx)
        _, _, top_e, _ = moe.route(xx[0], pp["router"], e, k)
        _, _, keep, order = moe.dispatch(top_e, t, e, k, cap)
        kept = torch.empty_like(keep)
        kept[order] = keep
        return (out[0].float().cpu(), float(aux), top_e.cpu(),
                kept.reshape(t, k).cpu())
    oc, ac, ec, kc = run("cpu")
    og, ag, eg, kg = run("cuda")
    logits = x[0].float() @ p["router"].float()
    srt = logits.sort(-1, descending=True).values
    gap = (srt[:, :k] - srt[:, 1:k + 1]).min(-1).values
    near = gap < logits.abs().max(-1).values * 2.0 ** -8
    alike = (ec == eg).all(-1) & (kc == kg).all(-1)
    if bool((~alike & ~near).any()):
        raise AssertionError(f"moe_apply card vs CPU: tokens "
                             f"{torch.nonzero(~alike & ~near).flatten()} "
                             "route apart, not within a bf16 ulp of a tie")
    err = ((og - oc).norm(dim=-1) / oc.norm(dim=-1).clamp_min(1e-30))[alike]
    if float(err.max()) > 2e-2 or abs(ag - ac) > 1e-5:
        raise AssertionError(f"moe_apply card vs CPU: worst alike row "
                             f"{float(err.max())}, aux {ag} vs {ac}")
    r = {"tokens": t, "apart": int((~alike).sum()),
         "near_ties": int(near.sum()), "worst_rel": float(err.max()),
         "aux_apart": abs(ag - ac), "dropped": int((~kc).sum())}
    print(f"  {smi}: 11c moe_apply card vs CPU (d {d}, {e} experts, top-{k},"
          f" {t} tokens): {r}")
    return r


# --------------------------------------------------------------------------
# phase 12: the recurrent families (hymba-1.5b and rwkv6-1.6b at full width)
# --------------------------------------------------------------------------

def tf32_switches() -> dict:
    """The switches that would let f32 matmuls (the recurrences' einsums)
    run in TF32 on the card; every one must be off."""
    sw = {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "float32_matmul_precision": torch.get_float32_matmul_precision()}
    print(f"  f32 matmul switches: {sw}")
    if sw["matmul.allow_tf32"] or sw["float32_matmul_precision"] != "highest":
        raise AssertionError(f"f32 matmuls may run in TF32: {sw}")
    return sw


def rec_trainer(arch: str, layers):
    """``make`` of :func:`phase_train` for 12b and 13b: ``arch`` at full
    width through the train launcher's entry points (batch TRAIN_BATCH x seq
    TRAIN_SEQ, REC_STEPS steps, per-layer recompute, SyntheticLM tokens
    from its seed 1234), cut to ``layers`` layers when given
    (:func:`depth`)."""
    from repro_torch.launch import train

    def make(spec, groups):
        args = train.parse_args([
            "--arch", arch, TRAIN_SIZE, "--comm-spec", spec, "--steps",
            str(REC_STEPS), "--seq", str(TRAIN_SEQ), "--batch",
            str(TRAIN_BATCH), "--lr", "3e-4", "--seed", "0"])
        with depth(train, layers):
            trainer, cfg = train.build_trainer(args, group=groups)
        if trainer.data.dc.seed != 1234:
            raise AssertionError(f"{arch}: data seed {trainer.data.dc.seed}")
        return trainer, lambda plan: want_per_step(cfg, trainer.model.plan,
                                                   plan)
    return make


def rec_state_error(arch: str) -> dict:
    """12c, the state: smoke ``arch`` in f32 under ``baseline``, a
    16-token prefill (batch 2, token by token through ``decode_forward``)
    on the card and on the CPU from the same weights: each recurrent
    state leaf's relative error (Frobenius)."""
    import repro_torch.models.attention as ta
    import repro_torch.models.layers as tl
    import repro_torch.models.rwkv as trwkv
    import repro_torch.models.ssm as tssm
    import repro_torch.models.transformer as ttr
    import repro_torch.serve.serve_step as ss
    from repro_torch.configs import get_config, make_plan, smoke_config
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import Model
    mods = (tl, ta, ttr, trwkv, tssm, ss)
    saved = [m.COMPUTE_DTYPE for m in mods]
    for m in mods:
        m.COMPUTE_DTYPE = torch.float32
    try:
        cfg = smoke_config(get_config(arch))
        plan = make_plan(cfg, 1, 1, remat=False)
        ctx = ParallelCtx(plan=from_spec("baseline"))
        cpu, gpu = Model(cfg, plan, device="cpu"), Model(cfg, plan)
        p_cpu = cpu.init(0, dtype=torch.float32)
        p_gpu = tree_map(lambda a: a.to(gpu.device), p_cpu)
        c_cpu, c_gpu = ss.init_cache(cpu, 2, 32), ss.init_cache(gpu, 2, 32)
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (2, 16)))
        for t in range(16):
            ss.decode_forward(p_cpu, toks[:, t:t + 1], c_cpu, t, cpu, ctx)
            ss.decode_forward(p_gpu, toks[:, t:t + 1].cuda(), c_gpu, t, gpu,
                              ctx)
        errs = {}
        for i, (a, b) in enumerate(zip(c_cpu, c_gpu)):
            for k in sorted(a):
                if k in ss.STATE_LEAVES:
                    errs[f"seg{i}.{k}"] = float(
                        (b[k].cpu().float() - a[k].float()).norm()
                        / a[k].float().norm())
    finally:
        for m, dt in zip(mods, saved):
            m.COMPUTE_DTYPE = dt
    return errs


def phase_rec_reference(arch: str) -> dict:
    """12c: smoke ``arch`` on the card (kernels) against the CPU (plain
    versions), the same weights: one taco train step at seq 128 (two RWKV
    chunks) by both routes and teacher-forced taco decode logits, at
    phase 4's bounds (:func:`phase_reference_train`,
    :func:`phase_reference`); the recurrent state after a 16-token prefill
    within 1e-3 (:func:`rec_state_error`)."""
    out = {"step": phase_reference_train(arch, seq=128),
           "logits": phase_reference(arch), "state": rec_state_error(arch)}
    if not out["state"] or max(out["state"].values()) > 1e-3:
        raise AssertionError(f"{arch}: card vs CPU state {out['state']}")
    print(f"  smoke {arch}: f32 state after a 16-token prefill, card vs "
          f"CPU {out['state']} (bound 1e-3)")
    return out


def rec_layer_ms(smi: str) -> dict:
    """12d: the device time of one layer's recurrence at full width, the
    forward alone and forward + backward: the SSM scan
    (``ssm._assoc_scan_chunked``, chunk 256) on hymba-1.5b's f32 decay and
    drive (TRAIN_BATCH x TRAIN_SEQ x 1600 x 16), and the RWKV chunk
    recurrence (``rwkv._chunk_recurrence``, chunk 64) on rwkv6-1.6b's r,
    k, v (bf16) and log decays (f32), TRAIN_BATCH x TRAIN_SEQ x 32 heads
    x 64.  A training step runs each layer's forward twice (full
    recompute) and its backward once."""
    from repro_torch.models import rwkv, ssm
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(25)
    b, s = TRAIN_BATCH, TRAIN_SEQ

    def draw(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEVICE) * scale) \
            .to(dtype).requires_grad_(True)
    decay = torch.rand((b, s, 1600, 16), generator=gen, device=DEVICE) \
        .mul_(0.5).add_(0.5).requires_grad_(True)
    drive, h0 = draw((b, s, 1600, 16), scale=0.1), draw((b, 1600, 16))
    r, k, v = (draw((b, s, 32, 64), torch.bfloat16) for _ in range(3))
    logw = (-torch.exp(torch.randn((b, s, 32, 64), generator=gen,
                                   device=DEVICE) * 0.5 - 3.0)) \
        .requires_grad_(True)
    u, s0 = draw((32, 64)), draw((b, 32, 64, 64))
    calls = {
        "ssm scan": lambda: ssm._assoc_scan_chunked(decay, drive, h0, 256)[0],
        "rwkv recurrence": lambda: rwkv._chunk_recurrence(
            r, k, v, logw, u, s0, 64)[0]}
    out = {}
    for name, fn in calls.items():
        with torch.no_grad():
            fwd = device_ms(fn, iters=3)

        def both(fn=fn):
            fn().float().sum().backward()
        out[name] = {"forward_ms": fwd, "fwd_bwd_ms": device_ms(both,
                                                               iters=3)}
        print(f"  {smi}: {name}, one layer at full width: forward "
              f"{out[name]['forward_ms']:.3f} ms, forward + backward "
              f"{out[name]['fwd_bwd_ms']:.3f} ms of device time")
    del decay, drive, h0, r, k, v, logw, u, s0
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_recurrent(kernels, smi: str) -> dict:
    """Phase 12: for each of REC_ARCHS, 12a serving at full width and
    depth as phase 2 (the serve launcher's engine, 6 requests, baseline
    and taco: every taco decode attempt launches 2 x (2L + 1) K2, 2L + 1
    K6 and 2L + 1 K5, no block kernel, no plain route); then rwkv's forced
    overflow replay (:func:`forced_replay`); 12b training through the train
    launcher (:func:`rec_trainer`) under baseline and taco, every attempt
    launching :func:`want_per_step`'s block kernels, no plain route, taco's
    losses within 5e-2 of baseline's, peak memory and one profiled step;
    each family's models freed before the next; 12c
    (:func:`phase_rec_reference`); then 12d (:func:`rec_layer_ms`)."""
    t0 = time.monotonic()
    out = {"tf32": tf32_switches()}
    for arch in REC_ARCHS:
        t1 = time.monotonic()
        served = phase_serve(kernels, [(f"{arch} base", "baseline", None),
                                       (f"{arch} taco", "taco", None)],
                             arch=arch)
        replay = forced_replay(arch, smi, seed=12) \
            if arch == "rwkv6-1.6b" else None
        layers = REC_TRAIN_LAYERS[arch]
        trained = phase_train(kernels, [("base", "baseline", None),
                                        ("taco", "taco", None)],
                              make=rec_trainer(arch, layers), sessions=1,
                              steps=REC_STEPS, warm=REC_WARM)
        check_losses(trained["base"], trained["taco"], f"{arch} taco")
        for label, r in trained.items():
            prof = r["step_profile"]
            print(f"  {smi}: {arch} ({layers or 'all'} layers) {label}: "
                  f"{r['mean_ms']:.3f} ms/step, {r['tok_per_s']:.1f} tok/s, "
                  f"peak {r['peak_mib']:.1f} MiB, one step device busy "
                  f"{prof['device_ms']:.3f} ms, idle share "
                  f"{prof['idle_share']:.3f}")
        ref = phase_rec_reference(arch)
        out[arch] = {"served": served, "replay": replay, "trained": trained,
                     "reference": ref, "seconds": time.monotonic() - t1}
        print(f"  {arch} took {out[arch]['seconds']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    out["layer_ms"] = rec_layer_ms(smi)
    print(f"  phase 12 took {time.monotonic() - t0:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 13: the encoder-decoder and the patch frontend (whisper-small and
# internvl2-1b at full width)
# --------------------------------------------------------------------------

def phase_frontends(kernels, smi: str) -> dict:
    """Phase 13: for each of FRONT_ARCHS, 13a serving as phase 2 (the serve
    launcher's engine, 6 requests, baseline and taco: every taco decode
    attempt and prefill call launches :func:`serve_want`'s wire kernels
    at the arch's hops, no block kernel, no plain route) at
    FRONT_LAYERS; 13b training through the train launcher
    (:func:`rec_trainer`, FRONT_LAYERS) under baseline and taco,
    every attempt launching :func:`want_per_step`'s block kernels, no
    plain route, taco's losses within 5e-2 of baseline's, peak memory and
    one profiled step; 13c card vs CPU at smoke size
    (:func:`phase_reference_train`, :func:`phase_reference`)."""
    t0 = time.monotonic()
    out = {}
    for arch in FRONT_ARCHS:
        t1 = time.monotonic()
        served = phase_serve(kernels, [(f"{arch} base", "baseline", None),
                                       (f"{arch} taco", "taco", None)],
                             arch=arch,
                             make=engine_at(FRONT_LAYERS[arch]))
        layers = FRONT_LAYERS[arch]
        trained = phase_train(kernels, [("base", "baseline", None),
                                        ("taco", "taco", None)],
                              make=rec_trainer(arch, layers), sessions=1,
                              steps=REC_STEPS, warm=REC_WARM)
        check_losses(trained["base"], trained["taco"], f"{arch} taco")
        for label, r in trained.items():
            prof = r["step_profile"]
            print(f"  {smi}: {arch} ({layers or 'all'} layers) {label}: "
                  f"{r['mean_ms']:.3f} ms/step, {r['tok_per_s']:.1f} "
                  f"positions/s, peak {r['peak_mib']:.1f} MiB, one step "
                  f"device busy {prof['device_ms']:.3f} ms, idle share "
                  f"{prof['idle_share']:.3f}")
        ref = {"step": phase_reference_train(arch),
               "logits": phase_reference(arch)}
        out[arch] = {"served": served, "trained": trained, "reference": ref,
                     "seconds": time.monotonic() - t1}
        print(f"  {arch} took {out[arch]['seconds']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  phase 13 took {time.monotonic() - t0:.1f} s")
    return out


def check_losses(base: dict, other: dict, label: str) -> float:
    """``other``'s loss within 5e-2 relative of ``base``'s at every step;
    returns the worst relative difference."""
    worst = 0.0
    for a, b in zip(base["hist"], other["hist"], strict=True):
        r = abs(b["loss"] - a["loss"]) / abs(a["loss"])
        if r > 5e-2:
            raise AssertionError(f"step {a['step']}: {label} loss {b['loss']}"
                                 f" vs baseline {a['loss']} ({r:.3e} "
                                 f"relative)")
        worst = max(worst, r)
    print(f"  {label} vs baseline loss: worst relative difference "
          f"{worst:.3e} (bound 5e-2)")
    return worst


def phase_reference_train(arch: str = "qwen2-0.5b", seq: int = 64) -> tuple:
    """Smoke-size ``arch``, one taco train step at ``seq`` on the card
    (kernels, both routes) against the CPU (plain versions), same weights
    and batch: loss within 1e-3 and grad norm within 5e-2 relative, the
    bounds of tests/test_torch_train.py.  Returns the worst (loss, grad
    norm) differences."""
    from repro_torch.configs import get_config, make_plan, smoke_config
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import build_train_step
    cfg = smoke_config(get_config(arch))
    plan = make_plan(cfg, 1, 1)
    ctx = ParallelCtx(plan=from_spec("taco"))
    oc = adamw.OptConfig(lr_max=1e-3, lr_min=1e-4, warmup_steps=2,
                         total_steps=10)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, seq, 2), cfg).batch(0)
    cpu, gpu = Model(cfg, plan, device="cpu"), Model(cfg, plan)
    init = cpu.init(0)
    worst = (0.0, 0.0)
    for route, budget in (("wire", 1 << 62), ("blocks", 0)):
        with wire_budget(budget):
            res = {}
            for where, model in (("cpu", cpu), ("card", gpu)):
                params = tree_map(lambda a: a.to(model.device).clone(), init)
                step = build_train_step(model, ctx, oc)
                _, _, m = step(params, adamw.init_opt_state(params),
                               SyntheticLM.place(batch, model.device))
                res[where] = (float(m["loss"]), float(m["grad_norm"]))
        (lc, gc_), (lg, gg) = res["cpu"], res["card"]
        if not (np.isfinite(lg) and np.isfinite(gg)):
            raise AssertionError(f"{arch}: non-finite train step on the card")
        rl, rg = abs(lg - lc) / lc, abs(gg - gc_) / gc_
        if rl > 1e-3 or rg > 5e-2:
            raise AssertionError(f"{arch} {route}: card vs CPU loss {rl:.3e},"
                                 f" grad norm {rg:.3e} relative")
        print(f"  smoke {arch} taco train step at seq {seq}, {route} route: "
              f"card vs CPU loss {rl:.3e}, grad norm {rg:.3e} relative")
        worst = (max(worst[0], rl), max(worst[1], rg))
    return worst


def serve_want(plan, hops: int) -> list:
    """Wire-kernel launches [compress, decompress-reduce, decompress] of
    one decode forward under ``plan``: per AllReduce hop of the decode path
    and ring chunk two compress, one decompress-reduce and one decompress
    wire kernel; under ``escalate=`` each of a hop's two transports also
    decodes one wire row back for its error probe (on chunk 0 of a ring):
    two more decompress a hop."""
    from repro_torch.core import collectives as cc
    if plan.tp_identity:
        return [0, 0, 0]
    chunks = cc.ring_chunks(plan.tp_fwd)
    probes = 2 * hops if getattr(plan.tp_fwd, "escalate", None) else 0
    return [2 * hops * chunks, hops * chunks, hops * chunks + probes]


def count_decode_attempts(eng, counters, rows: list) -> None:
    """Every decode attempt of ``eng`` (a tick, or its replay) appends
    ``(plan, [compress, reduce, decompress] wire launches)`` to ``rows``:
    the step functions the engine's ``PolicyEngine`` built, and will
    build, are wrapped."""
    def wrap(plan, fn):
        def run(tok, pos):
            before = [c.launches for c in counters]
            out = fn(tok, pos)
            rows.append((plan, [c.launches - b
                                for c, b in zip(counters, before)]))
            return out
        return run
    pe = eng.policy
    pe._fns = {p_: wrap(p_, f) for p_, f in pe._fns.items()}
    build = pe._build
    pe._build = lambda plan: wrap(plan, build(plan))


def phase_serve(kernels, runs, arch: str = "qwen2-0.5b",
                make=None) -> dict:
    """Full-width serving of ``arch`` (default qwen2-0.5b) through the
    serve launcher's entry points, one run per ``(label, spec, group)``,
    the engine built by ``make(args, group) -> (engine, cfg)`` (default:
    the launcher's ``build_engine``): every decode attempt (a tick, or a
    replayed tick) and every prefill forward of a compressed run launches
    :func:`serve_want`'s wire kernels for the plan it ran (per hop of the
    decode path, layers x 2 + 1 AllReduce hops (49 on qwen2-0.5b; layers
    x 3 + 1 for an encoder-decoder), and ring chunk: two compress, one
    decompress-reduce and one decompress; prefill runs the declared
    plan), and no block kernel."""
    from repro_torch.core import collectives as cc
    from repro_torch.core.registry import from_spec
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serve.engine import _tp_hops_per_token
    counters = [kernels["compress_wire"], kernels["decompress_reduce_wire"],
                kernels["decompress_wire"]]
    make = make or serve.build_engine
    out = {}
    for label, spec, group in runs:
        args = serve.parse_args([
            "--arch", arch, "--no-smoke", "--comm-spec", spec,
            "--max-batch", "4", "--requests", "6", "--prompt-len", "16",
            "--gen", "16", "--qps", "16", "--seed", "0"])
        eng, cfg = make(args, group)
        attempts = []
        count_decode_attempts(eng, counters, attempts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in kernels.values():
            c.launches = 0
        for k in ops.plain_routes:
            ops.plain_routes[k] = 0
        with nccl_calls() as calls:
            s, wall = serve.drive(eng, args, cfg)
        launches = [c.launches for c in counters]
        no_plain_routes(f"serve {label}")
        blocks = {k: kernels[k].launches for k in (
            "compress_blocks", "decompress_blocks", "decompress_reduce")}
        if any(blocks.values()):
            raise AssertionError(f"{label}: decode hops reached the block "
                                 f"kernels {blocks}")
        done = eng.sched.done
        if len(done) != 6 or any(len(r.tokens) != 16 for r in done):
            raise AssertionError(f"{label}: not every request finished")
        if any(not 0 <= t < cfg.vocab_size for r in done for t in r.tokens):
            raise AssertionError(f"{label}: token id out of range")
        hops = _tp_hops_per_token(cfg)
        ticks = [row for _, row in attempts]
        wants = [serve_want(plan, hops) for plan, _ in attempts]
        if ticks != wants or len(attempts) < s["decode_steps"]:
            raise AssertionError(f"{label}: per-attempt launches {ticks}, "
                                 f"want {wants}")
        per_prefill = serve_want(from_spec(spec), hops)
        if launches != [sum(col) + k * s["prefill_steps"] for col, k in
                        zip(zip(*wants), per_prefill)]:
            raise AssertionError(f"{label}: launches {launches} over "
                                 f"{len(attempts)} decode attempts and "
                                 f"{s['prefill_steps']} prefill calls")
        toks = s["total_new_tokens"]
        print(f"  {label:8s} ({spec}, tp group "
              f"{'none' if group is None else eng.ctx.tp_size}) "
              f"requests={s['requests']} tokens={toks} "
              f"wall={wall:.3f}s tok/s={toks / wall:.2f} "
              f"p50={s['decode_ms_per_tok_p50']:.3f} "
              f"p99={s['decode_ms_per_tok_p99']:.3f} ms/tok "
              f"ttft p50={s['ttft_ms_p50']:.3f} p99={s['ttft_ms_p99']:.3f} "
              f"ms decode_ticks={s['decode_steps']} "
              f"prefill_calls={s['prefill_steps']} "
              f"launches[compress,reduce,decompress]={launches} "
              f"per_tick={ticks[0]} "
              f"max_mem={torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
              f"torch.distributed calls {({k: v for k, v in calls.items() if v})}")
        prof = profile_tick(eng)
        cc.drain_probes()           # the profiled calls' probes, if any
        print(f"    one decode tick: wall {prof['wall_ms']:.3f} ms, device "
              f"busy {prof['device_ms']:.3f} ms, idle share "
              f"{prof['idle_share']:.3f}, taco kernels "
              f"{prof['taco_kernels_ms']:.4f} ms; top {prof['top']}")
        out[label] = dict(s, wall_s=wall, launches=launches, tick=prof,
                          engine_peak_mib=torch.cuda.max_memory_allocated()
                          / 2**20,
                          attempts=attempts, engine_metrics=eng.policy.metrics())
        eng.policy._fns = eng.policy._build = None  # break the self-cycle
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_reference(arch: str = "qwen2-0.5b") -> float:
    """Smoke-size ``arch``, taco: teacher-forced decode logits on the card
    (kernels) against the CPU run (plain versions), same weights; an
    encoder-decoder's cross cache (``xk`` / ``xv``) seeded alike on both
    with normals, so that its cross-attention adds a term."""
    from repro_torch.configs import get_config, make_plan, smoke_config
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.core.registry import from_spec
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import Model
    from repro_torch.serve import serve_step as ss
    cfg = smoke_config(get_config(arch))
    plan = make_plan(cfg, 1, 1, remat=False)
    ctx = ParallelCtx(plan=from_spec("taco"))
    cpu, gpu = Model(cfg, plan, device="cpu"), Model(cfg, plan)
    p_cpu = cpu.init(0)
    p_gpu = tree_map(lambda a: a.to(gpu.device), p_cpu)
    c_cpu, c_gpu = ss.init_cache(cpu, 4, 32), ss.init_cache(gpu, 4, 32)
    gen = torch.Generator().manual_seed(13)
    for seg_c, seg_g in zip(c_cpu, c_gpu):
        for k in ("xk", "xv"):
            if k in seg_c:
                seg_c[k].copy_(torch.randn(seg_c[k].shape, generator=gen))
                seg_g[k].copy_(seg_c[k])
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 8)))
    worst = 0.0
    for t in range(8):
        _, lc = ss.decode_forward(p_cpu, toks[:, t:t + 1], c_cpu, t, cpu,
                                  ctx, return_logits=True)
        _, lg = ss.decode_forward(p_gpu, toks[:, t:t + 1].cuda(), c_gpu, t,
                                  gpu, ctx, return_logits=True)
        lg = lg.cpu()
        if not (torch.isfinite(lg).all() and torch.isfinite(lc).all()):
            raise AssertionError(f"{arch}: non-finite logits")
        rel = float((lg - lc).norm() / lc.norm())
        worst = max(worst, rel)
    # bf16 matmuls round differently on the card and the CPU; the taco
    # hop then re-quantizes slightly different inputs (see
    # tests/test_torch_model.py for the same bound against JAX)
    if worst > 5e-2:
        raise AssertionError(f"{arch}: card vs CPU logits rel err {worst}")
    print(f"  smoke {arch} taco: card vs CPU logits rel err {worst:.3e}")
    return worst


def storage_bytes(*trees) -> dict:
    """Bytes of the storages under the tensor leaves of ``trees`` (each
    storage once), by tree: what the allocator handed out for them, less
    its rounding of each block to 512 bytes."""
    from repro_torch.optim.adamw import leaves
    out = []
    for tree in trees:
        seen = {}
        for t in leaves(tree):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
        out.append(sum(seen.values()))
    return out


def load_example(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: phase 14c: the example twins' arguments (torch_train_lm at its
#: default, full-width scale)
TWIN_ARGS = {"torch_quickstart": ["--steps", "10"],
             "torch_train_lm": ["--steps", "4"],
             "torch_serve_decode": [], "torch_compression_demo": []}


def phase_dryrun_cell(trained: dict) -> dict:
    """14a / 14b: the dry run (``launch/dryrun.py``) of phase 3's cell
    (qwen2-0.5b at ``QWEN_LAYERS`` layers, batch 4 x 2048, mesh (1, 1,
    1)) against what phase 3's taco run allocated and launched: params +
    AdamW bytes equal the storage of the trainer's state; the hops a step
    equal the counted K3 (all-gathers) and K4 (reduce-scatters) launches,
    their sum K1's; each hop packs ``comm/tp_*_bytes_per_elem`` bytes an
    element, and one rank sends nothing."""
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.core.registry import from_spec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    taco = trained["taco"]
    cfg = taco["cfg"]
    n = TRAIN_BATCH * TRAIN_SEQ * cfg.d_model     # one hop's elements
    suite = ShapeSuite("phase 3", TRAIN_SEQ, TRAIN_BATCH, "train")
    mesh = Mesh()
    model = dryrun.cell_model(cfg, mesh)
    mem = dryrun.memory(model, suite)
    params_b, opt_b = taco["state_bytes"]
    print(f"  14a dry run: params {mem['params']} B, AdamW "
          f"{mem['opt_state']} B, grads {mem['grads']} B; the trainer's "
          f"storage: params {params_b} B, AdamW {opt_b} B; the step's peak "
          f"{taco['peak_mib']:.1f} MiB (activations, grads and the "
          "allocator's 512-byte rounding on top)")
    if (mem["params"], mem["opt_state"]) != (params_b, opt_b):
        raise AssertionError(f"14a: dry run {mem} != allocated params "
                             f"{params_b} B, AdamW {opt_b} B")
    plan = from_spec("taco")
    t = dryrun.tp_traffic(model, suite, plan, mesh)
    per = dict(zip(("compress_blocks", "decompress_blocks",
                    "decompress_reduce"), taco["per_step"]))
    row = taco["hist"][-1]
    per_elem = {k: row[f"comm/{k}_bytes_per_elem"]
                for k in ("tp_fwd", "tp_bwd")}
    hops = t["all_gather"] + t["reduce_scatter"]
    print(f"  14b dry run: {t['all_gather']} all-gathers + "
          f"{t['reduce_scatter']} reduce-scatters a step, "
          f"{t['packed_bytes']:.0f} B packed ({t['packed_bytes'] / hops / n} "
          f"B an element a hop), {t['link_bytes']:.0f} B sent; phase 3 "
          f"counted {per} a step, comm keys {per_elem}")
    if (t["all_gather"], t["reduce_scatter"], hops) != (
            per["decompress_blocks"], per["decompress_reduce"],
            per["compress_blocks"]):
        raise AssertionError(f"14b: dry-run hops {t} vs launches {per}")
    if t["packed_bytes"] != hops * n * per_elem["tp_fwd"] or \
            per_elem["tp_fwd"] != per_elem["tp_bwd"] or t["link_bytes"]:
        raise AssertionError(f"14b: dry-run bytes {t} vs {per_elem}")
    return {"memory": mem, "allocated": {"params": params_b,
                                         "opt_state": opt_b},
            "peak_mib": taco["peak_mib"], "traffic": t,
            "launches_per_step": per, "comm_bytes_per_elem": per_elem}


def phase_twins(counters) -> dict:
    """14c: the four example twins in this process on the card, with
    ``TWIN_ARGS``: ``torch_quickstart``, ``torch_train_lm`` at gpt-100m's
    full width (12 x 768, steps of 8 x 512 under
    ``tp=taco,grad_rs=sdp4bit``: ``want_per_step``'s K1 / K3 / K4 every
    step, no wire kernel, 0 plain routes, the first loss within 0.1 of ln
    32000 + 768 x 4e-4 / 2, the head's init term),
    ``torch_serve_decode`` (smoke widths: wire kernels, 0 plain routes)
    and ``torch_compression_demo`` (its tensor-scale and no-transform
    rows take the plain versions by design)."""
    from repro_torch.configs import make_plan
    from repro_torch.core.registry import from_spec
    from repro_torch.kernels import ops
    names = list(counters)
    out = {}

    def reset():
        for c in counters.values():
            c.launches = 0
        for k in ops.plain_routes:
            ops.plain_routes[k] = 0

    def read():
        return {k: counters[k].launches for k in names}

    dev = ["--device", DEVICE]
    for name, argv in TWIN_ARGS.items():
        main_path = name != "torch_compression_demo"
        mod = load_example(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset()
        res = mod.main(argv + dev)
        torch.cuda.synchronize()
        launches = read()
        seconds = time.perf_counter() - t0
        if main_path:
            no_plain_routes(f"14c {name}")
        out[name] = {"launches": launches, "seconds": seconds}
        print(f"  14c {name}: {seconds:.1f} s, launches "
              f"{({k: v for k, v in launches.items() if v})}")
        if name == "torch_train_lm":
            args = mod.parse_args(argv)
            cfg = mod.config(args.scale)
            want = want_per_step(cfg, make_plan(cfg, 1, 1),
                                 from_spec(args.comm_spec))
            if len(res) != args.steps or launches != {
                    k: v * args.steps for k, v in want.items()} or \
                    not launches["compress_blocks"]:
                raise AssertionError(f"14c train_lm: launches {launches}, "
                                     f"want {want} a step")
            first = res[0]["loss"]
            expect = math.log(cfg.vocab_size) + cfg.d_model * 4e-4 / 2
            print(f"  14c torch_train_lm: losses "
                  f"{[round(h['loss'], 6) for h in res]}, first vs ln V + "
                  f"d 4e-4 / 2 = {expect:.4f}: {first - expect:+.4f}; "
                  f"{[round(h['ms'], 3) for h in res]} ms a step")
            if not all(np.isfinite(h["loss"]) for h in res) or \
                    abs(first - expect) > 0.1:
                raise AssertionError(f"14c train_lm: losses {res}")
            out[name].update(losses=[h["loss"] for h in res],
                             ms=[h["ms"] for h in res], per_step=want)
        elif name == "torch_serve_decode":
            if not launches["compress_wire"] or any(
                    len(r.tokens) != r.max_new for r in res):
                raise AssertionError(f"14c serve_decode: {launches}")
        elif name == "torch_quickstart":
            if len(res) != int(argv[1]) or not all(
                    np.isfinite(h["loss"]) for h in res):
                raise AssertionError(f"14c quickstart: {res}")
    return out


def phase_registered_codec(counters) -> dict:
    """14d: a codec registered through ``registry.register_codec`` that
    delegates every method to taco: one smoke training step (grads, then
    AdamW) on the card under ``tp=delegate`` equals the step under
    ``tp=taco`` bit for bit, loss, metrics and every updated parameter,
    through the same kernel launches.  The registration is taken out
    again."""
    from repro_torch.configs import get_config, make_plan, smoke_config
    from repro_torch.core import registry
    from repro_torch.core.codecs import TacoCodec
    from repro_torch.core.parallel import ParallelCtx
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import build_train_step

    @dataclasses.dataclass(frozen=True)
    class Delegate:
        inner: TacoCodec = TacoCodec()
        granule = property(lambda self: self.inner.granule)
        chunks = property(lambda self: self.inner.chunks)

        def wire_layout(self, n):
            return self.inner.wire_layout(n)

        def encode(self, x):
            return self.inner.encode(x)

        def decode(self, enc, n, dtype):
            return self.inner.decode(enc, n, dtype)

        def decode_sum(self, enc, n, dtype):
            return self.inner.decode_sum(enc, n, dtype)

        def encode_wire(self, x):
            return self.inner.encode_wire(x)

        def decode_wire(self, wire, n, dtype):
            return self.inner.decode_wire(wire, n, dtype)

        def decode_sum_wire(self, wire, n, dtype):
            return self.inner.decode_sum_wire(wire, n, dtype)

        def bytes_per_element(self, in_dtype=None):
            return self.inner.bytes_per_element()

    taco = registry.get_codec("taco")
    registry.register_codec("delegate", Delegate,
                            lambda args: Delegate(taco.parse(args)),
                            lambda c: taco.unparse(c.inner))
    try:
        cfg = smoke_config(get_config("qwen2-0.5b"))
        model = Model(cfg, make_plan(cfg, 1, 1), device=DEVICE)
        batch = SyntheticLM.place(SyntheticLM(DataConfig(
            cfg.vocab_size, 64, 2), cfg).batch(0), model.device)
        oc = adamw.OptConfig(lr_max=1e-3, warmup_steps=1, total_steps=4)
        res = {}
        for spec in ("tp=delegate", "tp=taco"):
            plan = registry.from_spec(spec)
            if not isinstance(plan.tp_fwd, registry.Codec):
                raise AssertionError(f"14d: {spec} is no Codec")
            params = model.init(0)
            for c in counters.values():
                c.launches = 0
            step = build_train_step(model, ParallelCtx(plan=plan), oc)
            params, _, m = step(params, adamw.init_opt_state(params), batch)
            torch.cuda.synchronize()
            res[spec] = ([m["loss"], m["grad_norm"]] + adamw.leaves(params),
                         {k: c.launches for k, c in counters.items()
                          if c.launches})
        (got, lg), (want, lw) = res.values()
        same = all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
        print(f"  14d tp=delegate (registered, delegating to taco) vs "
              f"tp=taco: loss {float(got[0]):.6f} / {float(want[0]):.6f}, "
              f"{len(got) - 2} params, bitwise equal {same}; launches "
              f"{lg} / {lw}")
        if not same or lg != lw or not lg:
            raise AssertionError("14d: the registered codec's step differs "
                                 "from taco's")
        return {"equal": same, "launches": lg, "loss": float(got[0])}
    finally:
        registry._CODECS.pop("delegate", None)
        registry._CODEC_NAME_BY_CLS.pop(Delegate, None)


def phase_roofline_constants() -> dict:
    """14e: ``launch/roofline.py``'s H100 constants beside the card's own
    SM count and the clocks ``nvidia-smi`` reports."""
    from repro_torch.launch import roofline as rl
    props = torch.cuda.get_device_properties(0)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.max.memory,"
         "clocks.sm,clocks.mem", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    out = {"sms": rl.SMS, "card_sms": props.multi_processor_count,
           "tensor_clock_hz": rl.TENSOR_CLOCK_HZ,
           "peak_flops": rl.PEAK_FLOPS, "f32_flops": rl.F32_FLOPS,
           "hbm_bw": rl.HBM_BW, "nvlink_bw": rl.NVLINK_BW,
           "net_bw": rl.NET_BW, "card_memory_bytes": props.total_memory,
           "nvidia_smi_max_sm_max_mem_sm_mem": clocks}
    print(f"  14e roofline constants: {out}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    import torch.distributed as dist

    from repro_torch.core.parallel import init_tp_group
    from repro_torch.launch.mesh import PIPE_AXES, SP_AXES, init_mesh
    from repro_torch.kernels import (ash_compress, ash_decompress, build,
                                     fwht_butterfly)
    t_start = t0 = time.monotonic()
    logs = build.build_all()
    print(f"kernels built in {time.monotonic() - t0:.1f}s")
    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log.strip()}")
    kernels = {"compress_blocks": ash_compress.compress_blocks,
               "decompress_blocks": ash_decompress.decompress_blocks,
               "decompress_reduce": ash_decompress.decompress_reduce,
               "compress_wire": ash_compress.compress_wire,
               "decompress_wire": ash_decompress.decompress_wire,
               "decompress_reduce_wire": ash_decompress.decompress_reduce_wire,
               "compress_blocks_butterfly":
                   fwht_butterfly.compress_blocks_butterfly}
    rows = phase_kernels(logs)
    blocks = phase_blocks(logs)
    rows.update(blocks["rows"])
    print("phase 1c: K7 (compress_blocks_butterfly) vs its plain version "
          "(same rule), timed beside K1")
    for name, by_label in phase_butterfly(logs).items():
        for label, r in by_label.items():
            key = f"{label}, beside K7" if name == "compress_blocks" else label
            rows.setdefault(name, {})[key] = r
    print("phase 1d: F1, the ablation configurations on the card "
          "(kernels, or the plain versions by the route of kernels.ops) vs "
          "the CPU")
    phase_f1(kernels)
    print(f"phase 1e ({time.monotonic() - t_start:.0f} s): K1-K7 on rows "
          "holding NaN or inf vs their plain versions")
    phase_nonfinite()
    print(f"phase 2 ({time.monotonic() - t_start:.0f} s): serving "
          "full-width qwen2-0.5b")
    served = phase_serve(kernels, [("baseline", "baseline", None),
                                   ("taco", "taco", None)])
    print(f"phase 3 ({time.monotonic() - t_start:.0f} s): training "
          f"full-width qwen2-0.5b at {QWEN_LAYERS} layers, batch "
          f"{TRAIN_BATCH} x "
          f"seq {TRAIN_SEQ}, {TRAIN_WARM} warm + "
          f"{TRAIN_STEPS - TRAIN_WARM} timed steps")
    trained = phase_train(kernels, [("baseline", "baseline", None),
                                    ("taco", "taco", None)])
    check_losses(trained["baseline"], trained["taco"], "taco")
    print(f"phase 4 ({time.monotonic() - t_start:.0f} s): reference "
          "checks at smoke size")
    phase_reference()
    phase_reference_train()
    print(f"phase 5 ({time.monotonic() - t_start:.0f} s): a 1-rank NCCL "
          f"process group on the card, {RING_SPEC}")
    group = init_tp_group("cuda",
                          init_method=f"tcp://127.0.0.1:{free_port()}",
                          world_size=1, rank=0, timeout_s=300)
    phase_group_parity(group)
    ring_train = phase_train(kernels, [("ring", RING_SPEC, group)])["ring"]
    check_losses(trained["baseline"], ring_train, "ring")
    ring_serve = phase_serve(kernels, [("ring", RING_SPEC, group)],
                             make=engine_at(QWEN_LAYERS))["ring"]
    print(f"phase 6 ({time.monotonic() - t_start:.0f} s): 1-rank NCCL "
          f"groups for pod, data and model on the card, "
          f"{DP_SPEC}")
    mesh = init_mesh((1, 1, 1), "cuda")
    phase_dp_parity(mesh)
    dp_train = phase_train(kernels, [("dp", DP_SPEC, mesh)])["dp"]
    check_losses(trained["baseline"], dp_train, "dp")
    taco_prof = trained["taco"]["step_profile"]
    dp_prof = dp_train["step_profile"]
    print(f"  one profiled step: taco (phase 3) device busy "
          f"{taco_prof['device_ms']:.3f} ms, TACO kernels "
          f"{taco_prof['taco_kernels_ms']:.3f} ms; dp device busy "
          f"{dp_prof['device_ms']:.3f} ms, TACO kernels "
          f"{dp_prof['taco_kernels_ms']:.3f} ms, grad_rs codec "
          f"{dp_train['grad_codec']['codec_ms']:.3f} ms; peak "
          f"{dp_train['peak_mib']:.1f} MiB (taco "
          f"{trained['taco']['peak_mib']:.1f})")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 7 ({time.monotonic() - t_start:.0f} s): the pipeline step "
          f"on 1-rank NCCL groups for pipe, data and model, {PIPE_ARCH} at "
          f"full width cut to {PIPE_LAYERS} layers, {PIPE_MICRO} "
          "microbatches, baseline and "
          f"{PIPE_SPEC}; at pipe = 1 the boundary hop has no peer (torch "
          "refuses a send to its own rank and NCCL two ranks on one card),"
          " so TahQuant and int8 are held card vs CPU on a replay of one "
          "step's hops")
    pipe_mesh = init_mesh((1, 1, 1), "cuda", axes=PIPE_AXES)
    phase_pipe_parity(pipe_mesh)
    threed = phase_train(kernels, [("pp base", "baseline", pipe_mesh)],
                         make=pipe_trainer(pipe_mesh), sessions=1)
    threed.update(phase_train(kernels, [("3d", PIPE_SPEC, pipe_mesh)],
                              make=pipe_trainer(pipe_mesh), sessions=1,
                              replay=pipe_replay))
    check_losses(threed["pp base"], threed["3d"], "3d")
    for label, r in threed.items():
        prof = r["step_profile"]
        print(f"  {label}: {r['mean_ms']:.3f} ms/step, {r['tok_per_s']:.1f} "
              f"tok/s, device busy {prof['device_ms']:.3f} ms, idle share "
              f"{prof['idle_share']:.3f}, TACO kernels "
              f"{prof['taco_kernels_ms']:.3f} ms, peak {r['peak_mib']:.1f} "
              "MiB" + (f", grad_rs codec {r['grad_codec']['codec_ms']:.3f} "
                       f"ms" if "grad_codec" in r else ""))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 8 ({time.monotonic() - t_start:.0f} s): checkpoint, "
          "restart after an injected failure and serving from the "
          f"checkpoint, qwen2-0.5b as phase 3 on the phase 6 groups, "
          f"{DP_SPEC}")
    restart = phase_restart(kernels, mesh, smi)
    print(f"phase 9 ({time.monotonic() - t_start:.0f} s): the policy layer "
          f"on phase 5's 1-rank NCCL group: one training hop under "
          f"{ZLE_SPEC} and {ZLE_RING_SPEC}, then training under {ZLE_SPEC} "
          f"and {ESC_SPEC}, then serving under {POLICY_SERVE_SPEC}")
    zle_hop = phase_zle_hop(group, kernels, smi)
    policy_train = phase_train(kernels, [("zle", ZLE_SPEC, group),
                                         ("escalate", ESC_SPEC, group)],
                               sessions=1)
    for label, r in policy_train.items():
        check_losses(trained["baseline"], r, label)
        print_policy_run(label, r)
        print(f"  {smi}: {label}: {r['mean_ms']:.3f} ms/step, "
              f"{r['tok_per_s']:.1f} tok/s, one step device busy "
              f"{r['step_profile']['device_ms']:.3f} ms, idle share "
              f"{r['step_profile']['idle_share']:.3f}")
    apart = max(abs(a["loss"] - b["loss"]) for a, b in
                zip(policy_train["zle"]["hist"], trained["taco"]["hist"]))
    print(f"  zle losses vs phase 3's taco: max |difference| {apart:.3e} "
          "(the stage is lossless and the bound negotiated to cover it)")
    esc = policy_train["escalate"]["hist"][-1]
    if esc["comm/escalations"] < 1:
        raise AssertionError(f"{ESC_SPEC}: never escalated ({esc})")
    policy_serve = phase_policy_serve(kernels, smi)
    print(f"phase 10 ({time.monotonic() - t_start:.0f} s): sequence "
          f"parallelism under {SP_SPEC}: the sp hops of full-width "
          "qwen2-0.5b at sp = 2 through phase 5's 1-rank NCCL group (one "
          "card: sp = 1 moves no sp byte), the ring's fold at full width, "
          "and phase 3's taco cell with a 1-rank seq group threaded "
          "through")
    sp_hops = phase_sp_hops(group, kernels, smi)
    sp_fold = phase_sp_fold(smi)
    sp_train = phase_sp_train(kernels, trained,
                              init_mesh((1, 1, 1, 1), "cuda", axes=SP_AXES))
    # phase 11 needs no group; the groups' NCCL buffers go first
    dist.destroy_process_group()
    print(f"phase 11 ({time.monotonic() - t_start:.0f} s): the MoE family, "
          f"{MOE_ARCH} at full width cut to {MOE_LAYERS} of its 64 layers "
          "(d 6144, 48 / 8 heads of 128, 8 experts of d_ff 32768, top-2, "
          "vocab 131072), weights drawn once: 11a serving under baseline "
          "and taco, 11b TrainStep.grads under baseline and taco, 11c "
          "moe_apply card vs CPU")
    moe = phase_moe(kernels, smi)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 12 ({time.monotonic() - t_start:.0f} s): the recurrent "
          "families at full width, hymba-1.5b (32 layers: full [0], swa "
          "[1-14], full [15], swa [16-30], full [31]; d 1600, SSM d_state "
          "16) and rwkv6-1.6b (24 layers, d 2048, 32 heads of 64): 12a "
          "serving under baseline and taco (and rwkv's forced overflow "
          f"replay under {ZLE_SPEC}), 12b training under baseline "
          f"and taco (layers {REC_TRAIN_LAYERS}), 12c card vs CPU at smoke "
          "size")
    rec = phase_recurrent(kernels, smi)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 13 ({time.monotonic() - t_start:.0f} s): the "
          "encoder-decoder and the patch frontend at full width, "
          "whisper-small (12 + 12 layers, d 768, stub frames, "
          "cross-attention) and internvl2-1b (24 layers, d 896, 256 stub "
          "patches): 13a serving and 13b training under baseline and taco "
          f"(layers {FRONT_LAYERS}), 13c card vs CPU at smoke size")
    front = phase_frontends(kernels, smi)
    gc.collect()
    torch.cuda.empty_cache()
    t14 = time.monotonic()
    print(f"phase 14 ({t14 - t_start:.0f} s): the JAX package's tools in "
          "the port: 14a / 14b the dry run of phase 3's cell against its "
          "allocation and launches, 14c the four example twins, 14d a "
          "codec registered through register_codec, 14e the roofline "
          "constants")
    tools = {"dryrun": phase_dryrun_cell(trained)}
    tools["twins"] = phase_twins(kernels)
    tools["registered"] = phase_registered_codec(kernels)
    tools["roofline"] = phase_roofline_constants()
    tools["seconds"] = time.monotonic() - t14
    print(f"  phase 14: {tools['seconds']:.1f} s")
    meta = {
        "compress_blocks": ("src/repro_torch/kernels/csrc/ash_compress.cu",
                            "src/repro/kernels/ash_compress.py:76", "train"),
        "decompress_blocks": ("src/repro_torch/kernels/csrc/ash_decompress.cu",
                              "src/repro/kernels/ash_decompress.py:48",
                              "train"),
        "decompress_reduce": ("src/repro_torch/kernels/csrc/ash_decompress.cu",
                              "src/repro/kernels/ash_decompress.py:96",
                              "train"),
        "compress_wire": ("src/repro_torch/kernels/csrc/ash_compress.cu",
                          "src/repro/kernels/ash_compress.py:199", "serve"),
        "decompress_wire": ("src/repro_torch/kernels/csrc/ash_decompress.cu",
                            "src/repro/kernels/ash_decompress.py:171",
                            "serve"),
        "decompress_reduce_wire": (
            "src/repro_torch/kernels/csrc/ash_decompress.cu",
            "src/repro/kernels/ash_decompress.py:231", "serve"),
        "compress_blocks_butterfly": (
            "src/repro_torch/kernels/csrc/fwht_butterfly.cu",
            "src/repro/kernels/fwht_butterfly.py:53", "train"),
    }
    wire_names = ("compress_wire", "decompress_reduce_wire", "decompress_wire")
    # launches on each main path: the count set to 0 before it, read after
    by_path = {
        "serve taco": dict(zip(wire_names, served["taco"]["launches"])),
        "train taco": trained["taco"]["launches"],
        "train ring": ring_train["launches"],
        "train dp": dp_train["launches"],
        "train 3d": threed["3d"]["launches"],
        "train restart": restart["launches"],
        "serve ring": dict(zip(wire_names, ring_serve["launches"])),
        "train zle": policy_train["zle"]["launches"],
        "train escalate": policy_train["escalate"]["launches"],
        "serve policy": dict(zip(wire_names, policy_serve["launches"])),
        "sp": sp_hops["launches"],
        "train sp ulysses": sp_train["ulysses"],
        "train sp ring": sp_train["ring"],
        "serve moe": dict(zip(wire_names,
                              moe["served"]["moe taco"]["launches"])),
        "train moe": moe["grads"]["taco"]["launches"]}
    for arch in REC_ARCHS:
        short = arch.split("-")[0][:5]
        by_path[f"serve {short}"] = dict(zip(
            wire_names, rec[arch]["served"][f"{arch} taco"]["launches"]))
        by_path[f"train {short}"] = rec[arch]["trained"]["taco"]["launches"]
    for arch in FRONT_ARCHS:
        short = FRONT_SHORT[arch]
        by_path[f"serve {short}"] = dict(zip(
            wire_names, front[arch]["served"][f"{arch} taco"]["launches"]))
        by_path[f"train {short}"] = front[arch]["trained"]["taco"][
            "launches"]
    by_path["train lm twin"] = tools["twins"]["torch_train_lm"]["launches"]
    by_path["serve twin"] = tools["twins"]["torch_serve_decode"]["launches"]
    launches = dict(by_path["serve taco"])
    launches.update({k: by_path["train taco"][k]
                     for k in ("compress_blocks", "decompress_blocks",
                               "decompress_reduce",
                               "compress_blocks_butterfly")})
    table = []
    for name, (source, replaces, path) in meta.items():
        r = rows[name][path]
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "call_ms": r["call_ms"], "plain_call_ms": r["plain_call_ms"],
            "path": path,
            "launches_by_path": {p_: c.get(name, 0)
                                 for p_, c in by_path.items()},
            "shapes": {k: v for k, v in rows[name].items() if k != path}})
    print(f"train hop routes: {json.dumps(blocks['hops'])}")
    print(f"phase 9 ZLE hop: {json.dumps(zle_hop)}")
    print(f"phase 10 sp: {json.dumps({'hops': sp_hops, 'fold': sp_fold})}")
    print(f"phase 11 moe: "
          f"{json.dumps({k: moe[k] for k in ('grads', 'small')})}")
    print("phase 12 recurrent: " + json.dumps({
        arch: {"trained": {k: {kk: r[kk] for kk in (
            "per_step", "peak_mib", "mean_ms", "tok_per_s", "step_profile")}
            for k, r in rec[arch]["trained"].items()},
            "served": {k: {kk: r[kk] for kk in (
                "launches", "wall_s", "decode_ms_per_tok_p50",
                "decode_ms_per_tok_p99", "tick", "engine_peak_mib")}
                for k, r in rec[arch]["served"].items()},
            "replay": rec[arch]["replay"], "reference": rec[arch]["reference"],
            "seconds": rec[arch]["seconds"]} for arch in REC_ARCHS} | {
                "layer_ms": rec["layer_ms"]}))
    print("phase 13 frontends: " + json.dumps({
        arch: {"trained": {k: {kk: r[kk] for kk in (
            "per_step", "peak_mib", "mean_ms", "tok_per_s", "step_profile")}
            for k, r in front[arch]["trained"].items()},
            "served": {k: {kk: r[kk] for kk in (
                "launches", "wall_s", "decode_ms_per_tok_p50",
                "decode_ms_per_tok_p99", "ttft_ms_p50", "tick",
                "engine_peak_mib")}
                for k, r in front[arch]["served"].items()},
            "reference": front[arch]["reference"],
            "seconds": front[arch]["seconds"]} for arch in FRONT_ARCHS}))
    print(f"phase 14 tools: {json.dumps(tools, default=str)}")
    print(f"chip_smoke: {time.monotonic() - t_start:.1f}s in all")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
