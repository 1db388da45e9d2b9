#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`polyaxon_tpu_torch/`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the hand-written kernels from the
checkout's sources, holds each against its plain PyTorch version, then
drives the port's two main paths at the full width of the `llama3-1b`
preset (random weights from a fixed seed): inference, then training; then
the rest of the model zoo through the Trainer at the widths of the repo's
BASELINE configurations.

1. build     — nvcc the kernel sources, all at once, with their ptxas
               reports, and g++ the gang's launcher (`native/
               launcher.cpp`: two workers must see their rendezvous
               environment); then the SASS of each library (`cuobjdump
               --dump-sass`): the HGMMA (wgmma) instructions of each kernel
               instance, which every bf16 flash instance and both
               instances of int8_matmul's prefill kernel must have and no
               f32 instance (nor `int8_fma_kernel`) may;
2. kernel    — the forward kernel, then the backward kernels (dq, dk/dv),
               against their plain versions at the main-path shape and a
               few others, with each kernel's median ms, the plain
               version's, one PyTorch library call's (a yardstick the port
               never calls) and the card's lower bound for the same work,
               and the TFLOP/s of each kernel's (causal) work;
               then int8_matmul at llama3-1b's four projection shapes for
               M = 1, 8 (decode), 256, 264 (the step scheduler's chunk,
               and 8 decode rows + a chunk) and 2048 (prefill), bf16 and
               f32, and bf16 at 9 and 16 rows, and the grouped q/k/v and
               gate/up launches at the same rows, each deterministic, its
               weights cycled past the L2 as a decode step finds them, with
               torch.matmul on the bf16 weights as the yardstick; one
               layer's four launches summed at M = 8 (decode) and at 256
               and 2048 (prefill, against cuBLAS); then the
               whole autograd chain (forward kernel, both backward
               kernels) against autograd through the plain forward, with a
               cotangent on lse;
2b. ring-hops — ring attention's hops at llama3-1b attention width (B=1,
               S=8192, H=32, KV=8, D=64, bf16, causal) over a ring of
               n=4 (2048-token chunks), in one process: each hop shape
               (the causal own chunk, a non-causal other chunk) through
               the flash kernels against their plain versions (the
               backward with a cotangent on lse, as the merge gives it),
               with times, bounds and SDPA's; then every rank's hops
               through `parallel.ring.flash_hop` (what `_ring_body_flash`
               runs), the K/V chunks sliced where the ring would receive
               them, held against `flash_attention` on the whole sequence
               in o, dq, dk and dv (RING_TOL, per row), with n^2 launches
               of each kernel (masked hops are computed, as in the
               reference);
3. forward   — the full-sequence forward on [1, 4096] tokens through the
               flash kernel (one launch per layer); its bf16 logits must
               sit as close to an f32 copy of the same weights as the bf16
               einsum-attention path does;
4. serve     — a ModelServer on the per-request path (`batching: false`)
               answering three POST /generate requests over HTTP, each
               equal to a direct generate() call, and GET /healthz;
4b. serve-batched — the batched paths on the same model: three server
               configs (`dense`: the coalescer over bucketed dense groups;
               `paged`: the paged KV pool of 2048 x 128-token pages with the
               prefix cache; `step`: the pool with chunked prefill and the
               continuous-batching step scheduler) under one traffic — two
               waves of 8 concurrent greedy requests of 64 new tokens,
               prompts of 128-2048 tokens, 8 of them behind one shared
               1024-token prefix — then one non-streamed and one streamed
               request (SSE) and, on dense and paged, one sampled request.
               Every row is held against the direct generate() of that row
               (a divergence passes only at a bf16 near-tie: the reference
               path's top-2 gap under 2^-6 of its top logit), the stream
               against the non-streamed tokens, the sampled pair dense
               against paged; no KV page may leak, the paged configs must
               hit the prefix cache and the step scheduler must run mixed
               steps. Prints TTFT, decode tokens/s, step ms and the pool per
               config; then one decode step at B=8 and a 2112-slot frontier,
               dense and paged, timed and under torch.profiler (top device
               ops, the device's idle share);
4c. serve-fast — the same traffic on the step config three more times:
               `spec` (n-gram speculation, 4 drafts a window), `draft` (+
               a 2-layer draft model by layer truncation and the
               adaptive controller of K), `int8` (int8 weights quantized
               on load, through int8_matmul, and the int8 paged pool).
               spec and draft rows are held against the step config's
               rows (the near-tie rule), spec's sampled row against
               dense's, and drafts must have been proposed; the int8 pool
               is exactly its formula's 4,563,402,752 bytes; no page
               leaks and the prefix cache hits; the stream equals the
               non-streamed tokens. Two numBeams 4 requests (one with an
               eos) on the spec server equal the port's direct
               beam_search, numBeams 1 the greedy row. Prints TTFT,
               decode tokens/s, step ms, tokens per step and accept rate
               per config, the decode weight bytes before and after
               quantization, then profiles an int8 decode step (which
               must launch int8_matmul 4 times a layer: q/k/v grouped, o,
               gate/up grouped, down, counted by the wrapper and by the
               kernels on the device in all 33 timed and profiled runs;
               torch.profiler's trace drops events) and a verify window at
               B=8, frontier 2112. After the kernel
               counts are read: every other int8 row of each wave
               (INT8_HELD: 2 behind the shared prefix, the second wave's
               on prefix hits, and 2 without) against the int8 module's
               own on a direct int8 pool (the near-tie rule), and int8
               against bf16 teacher-forced on 2048 tokens, the argmax
               agreeing at >= 0.75 of the positions past a near-tie;
4f. serve-mesh — the step and int8 configs on decode meshes
               (`parallel.mesh.decode_mesh`, `serving/mesh.py`), 4 of
               serve-batched's prompts, one at a time: (a) on a one-rank
               `nccl` mesh beside a one-device server, rows equal bit for
               bit, forward commands = prefill chunks + decode steps,
               64 int8 launches a forward, a logits gather a sampled
               forward; (b) meanwhile two processes of this script
               (`--serve-mesh-rank`) on the one card under `gloo`,
               `{model: 2}`: rows against (a)'s one-device rows (the
               near-tie rule), 64 int8 launches a forward on each rank,
               step ms, TTFT, the collectives' share, weight and pool
               bytes a rank. Then every serving feature (MESH_FEATURES):
               (a) beams, n-gram speculation, a 2-layer draft on int8,
               two tenants on int8 adapters with one slot, the spill
               tier (the demoted pages one device's bytes) and a handoff
               from the mesh's prefill role to a one-device decode
               replica, each bit for bit against one device, int8
               launches on the wrapper's and the card's counts; (b)
               speculation and the tenants under the near-tie rule; each
               part's accept rate, forwards, commands by op, spill bytes
               and decode step p50;
4d. serve-tenants — multi-tenant serving on `llama3-1b` with rank-16 LoRA
               on all seven projections (random bf16 weights from seed 0)
               and three adapters (`seed:1..3`) behind three tenants, two
               adapter slots beyond the checkpoint's own. First, outside
               the counted path, the per-row LoRA delta on the card against
               the merged-adapter product per row (fp and int8 bases, bf16
               and f32, decode B=8 and a 256-row chunk) and the grouped
               int8 launch of q/k/v and gate/up with per-row slots (one
               launch each). Then the step config on that model without
               tenants (the yardstick), and `tenants` (the step config with
               a 64-page pool, the spill tier in RAM) and `tenants-int8`
               (+ int8 weights and pool, the spill tier on disk) under one
               traffic: a mixed wave, a burst at the tenant capped at 2
               outstanding rows (which must shed tenant_quota there alone),
               a flood that demotes the shared 1024-token prefix to the
               spill tier, and a wave that restores it (the pages must hold
               the demoted bytes) and brings an evicted adapter back from
               its spill tier. No page, adapter pin or tenant charge
               remains. Prints TTFT, decode tokens/s against the yardstick,
               adapter load and restore ms, the KV restore and mirror-copy
               ms and the spill bytes. The counts are read here; after
               them, every served row must equal its solo reference (the
               model with that adapter in its one slot: generate(), or the
               int8 module on a direct int8 pool) or diverge at a near-tie
               (TENANT_NEAR_TIE) or at top-k's edge (edge_flip), and a
               decode step at B=8, frontier 2112,
               with and without slots (the launches the slots add) and on
               the int8 base (64 int8 launches);
4e. serve-fleet — the serving fleet on the bf16 `llama3-1b` width at 4 of
               its 16 layers (FLEET_LAYERS, a cut; after 4c,
               before 4d): a `role: prefill` and a `role: decode` replica
               behind the port's Router (ReplicaSetManager over
               InProcessReplicas, one module, a pool each) and a monolithic
               `direct` replica, all on the step config with a 64-page
               pool; `fleet` (bf16) and `fleet-int8` (int8 weights and
               pool). 12 requests of 32 new tokens, prompts of 128-2048
               tokens, in waves of 2: two behind one 1024-token prefix (the
               router's affinity may send the second to the decode
               replica), a sampled one, two sent again streamed, and one
               under a fault at serving.kv_import, which must fall back
               and still answer; the rest of the waves streamed and timed
               at the client. Routed rows equal direct's or diverge at a
               near-tie (compare_rows; a sampled row also at top-k's edge,
               edge_flip, printed beside the direct replica's answer for it
               with its pages warm in its own prefix cache), streams equal
               the non-streamed rows (the same rule); every request the
               prefill replica took was handed off or is the one fallback;
               exports equal the decode side's acknowledged imports, and
               each export's replay, in the router's stitched /tracez,
               was admitted on the adopted pages; no page leaks and the
               lease table ends empty; that /tracez holds the router's, the
               prefill replica's and the decode replica's spans; /sloz and
               /queryz answer with the objectives and the history; an SLO
               set to breach writes a flight-recorder bundle with a
               torch.profiler trace; the routed replicas of fleet-int8
               launch int8_matmul (counted apart from the direct
               replica's). Prints the client's TTFT and decode tokens/s,
               handoff bytes, and per handoff from its own trace the
               capture, ship, adopt host and wire ms, the write's host ms,
               and the router's own ms per request (one process, one GIL:
               the semantics and costs, not throughput scaling);
5. train     — `Trainer(program).run()`: 8 AdamW steps on [1, 4096]
               synthetic_text tokens, mixed precision, remat, fused LM
               loss, flash attention, with a profiler window over one step;
               every loss finite, the last below the first, each kernel
               launched the expected number of times per step;
5b. train-mesh — a one-rank `nccl` process group, then the train program
               with `attention: ring` through `Trainer(..., mesh_axes=
               {data, fsdp, model, context: 1})`, the mesh path (DTensor
               parameters, ring attention dispatching to flash at n=1), at
               the same width and depth: its per-step losses against
               `train`'s (TRAIN_MESH_TOL), the launches `train` counts,
               its step time beside `train`'s and its peak memory;
6. train-vs-einsum — 3 steps from the same weights with `attention:
               flash` and `attention: xla` at [1, 2048]: per-step loss and
               grad_norm distances (step 0 from the same weights moves with
               attention's rounding alone), and the distance of the updated
               weights;
7. train-resume — checkpoints (the train program without its profile
               window, 4 steps, keep 1, under build/chip_smoke/resume/):
               trainer P is sent a real SIGTERM at step 3 and must raise
               Preempted(3) with step 3 saved; trainer R resumes
               (`resume: true`) from P's state bit for bit (a sum of each
               tensor's integer view) and the schedule at 3 and trains
               step 3; with a local and a durable tier, trainer Q restores
               after the durable copy is corrupted and must fall back to
               the local copy. At full size P saves at its boundary, 3, on
               both tiers; at 2 layers (one tier) P saves 2 and flushes 3,
               and R saves 4 once, the final save a no-op (RESUME_CASES:
               the disk writes stay under ~40 GB). Prints the bytes per
               checkpoint, the stall of each boundary save, the background
               write and upload seconds, the restore seconds, the step
               spans, the snapshot's device time and the peak memory.
               The full-size case is a run of the port's RunStore: its
               spec a jaxjob program that trains on a token_file corpus
               (2^24 uint32 tokens from numpy seed 0, the native loader)
               and pins `serving` (int8 weights, a 256-page pool, chunked
               prefill, maxBatch 8), its durable tier the run's outputs;
               its timeline holds the preemption and the resume;
7b. serve-run — after R, before Q corrupts the durable step 3:
               `ModelServer.from_run(uuid[:8], store=...)` with one
               override (maxQueue 16). The step is 3, the config the
               spec's plus the override, the served params P's at its
               save bit for bit (fp leaves, and each projection's fp
               weight as it reached the card with the int8 weight and
               scale quantized from it), and the card's peak over from_run
               under the params' bytes plus 10% (the Adam moments are never
               read). Then 8 greedy requests of 32 new tokens over HTTP,
               streamed and timed at the client, prompts of 128-2048
               corpus tokens, which must launch int8_matmul; after the
               counts are read every other row (RUN_HELD, 128 to 1773
               tokens) is held against the int8 module's rows on a direct
               pool (the near-tie rule). Prints from_run's
               seconds (read, to-device, quantize), the bytes read, the
               peak, TTFT and decode tokens/s. Then the same run served by
               the CLI in a child process, `python -m polyaxon_tpu_torch
               serve -uid <run> --max-queue 16` on the run's store (its
               start-up timed): 4 greedy requests, each row held against
               the in-process server's row (the near-tie rule);
7c. cli      — the port's CLI: `main(["check", "-f", f])` on every file of
               examples/; `main(["run", "-f", <Polyaxonfile>, "-P",
               "steps=6"])` in this process on a `transformer_lm` program
               at the preset's width with 2 layers (a cut; flash, mixed,
               remat, an `observability:` block, no checkpoints): the run
               succeeds, `ops metrics` shows 6 training steps and the host
               and device gauges of the SystemMonitor, and the flash
               launches are PER_STEP's for 2 layers and 6 steps; then
               `python -m polyaxon_tpu_torch run -f examples/mnist.yaml -P
               steps=20` as a child process. Prints the run's steps/s, the
               launches, the serve child's answers and the seconds;
7d. sweep    — `main(["run", "-f", "examples/lm_asha.yaml"])`, the file as
               shipped (ASHA, 16 trials of a 4-layer LM at 50-400 steps,
               concurrency 4): exit 0, the sweep succeeded, the trials are
               the ones the search manager gives when fed their own losses
               (16), each succeeded with a finite loss, `best` is the
               least loss, the placement is one group of one GPU (no
               topology: the YAML's 2x4 is not this pool), `ops ls
               --sweep` lists the trials. Prints the wall seconds, trials
               per hour and the mean seconds a trial spends outside its
               training steps. Its trials attend by einsum (seq 256);
7e. pipeline — a `dag` Polyaxonfile written by the phase: a `search` node
               (a grid over PIPELINE_LRS on 7c's program, 6 steps each)
               and `train-best` after it, taking `{{ ops.search.outputs.
               best.lr }}`: the DAG succeeds, train-best's spec carries
               the winner's lr, and each of the three training runs
               launches PER_STEP's flash kernels for 2 layers and 6 steps.
               Prints the wall seconds and each node's;
8. train-rules — the remat policies `nothing`, `dots` and
               `dots_no_batch`, 4 steps each at the preset's width with 4
               layers (RULES_LAYERS, a cut; median step seconds, peak
               memory, the flash launches per layer and step);
               then lamb, lion, adafactor, rmsprop and adagrad (and adamw
               beside them) for 3 steps each at the preset's width with 2
               layers: every loss finite, each rule's state bytes,
               adafactor's far under adamw's;
9. train-zoo — `Trainer(program).run()`, 6 steps each, on each BASELINE
               configuration at full width on its procedural stream:
               `mlp` (mnist.yaml, f32, batch 128), `resnet50` (224 px,
               1000 classes, SGD Nesterov, cosine, mixed, batch 64 of the
               YAML's 1024), `vit` S/16 (224 px, `attention: xla`: its 196
               tokens are no multiple of the kernels' 128-row q block;
               AdamW, mixed, 128), `bert` (bert.yaml: bert-base, seq 512,
               remat, `attention: flash`, mixed, 32 of 256), `seq2seq`
               `small` (128/128, flash, mixed, 32) and `transformer_lm` at
               llama3-1b's width with 8 switch experts (capacity 1.25) at 4
               layers, seq 2048, flash, fused loss, mixed. Each prints its
               median step seconds, images or tokens per second, peak
               memory and losses; every loss finite, the MLP's falling
               (in 6 steps of 1000 classes ViT's and ResNet's rise: each
               batch raises its own classes, the next holds mostly
               others), each path's
               flash launches exactly what its code launches (BERT 24/12/12
               a step, seq2seq 12/12/12, MoE 4/4/4; none elsewhere) and
               every BatchNorm statistic of ResNet-50 moved. Then BERT-
               base's bf16 logits through the flash kernels (non-causal)
               against the einsum path on the same weights (relative
               Frobenius, limit BERT_FLASH_VS_XLA) and against an f32 copy
               (as the forward phase's rule);
9b. train-zoo-context — train-zoo's BERT-base program (batch 32, seq 512)
               for ZOO_CONTEXT_STEPS steps on {context: 2}: two processes
               of `chip_smoke.py --zoo-context-rank R` on the one card
               under `gloo` (NCCL refuses two ranks on one device), each
               holding 256 tokens of every sequence, self-attention on
               the ring (2 hops a layer, K/V through the host). Losses,
               grad norms and the loss's change against train-zoo's one-
               device run of the same seed and stream (ZOO_CONTEXT_TOL),
               the same on both ranks, and each rank's flash launches
               train-zoo's BERT count a step times the 2 hops (48/24/24).
               Logs in `build/chip_smoke/zoo_context/`;
7f. sched    — the scheduler on a store of its own: `fleet init --chips
               1`, a quota on the `elastic` project (`maxChips: 1`), and
               the port's agent draining 7c's program (SCHED_PROGRAM: its
               width and 2 layers, batch 2, vocabulary SCHED_VOCAB so one
               checkpoint stays ~2.3 GB of the disk's budget): a
               priority-0 run evicted at its step SCHED_EVICT_AFTER's log
               point by a priority-5 submission (checkpoint, release,
               requeue at priority 0, resume), its losses before and after
               held against an uninterrupted Trainer of the same program
               whose stream restarts at the eviction step as a resumed
               run's does (SCHED_TOL); an elastic gang (`replicas: 2`, 2
               chips, floor 1) granted the fleet's one chip, trained in
               process with grad_accum 2; an interval `schedule:` registered by `run` firing twice
               under a bounded `agent serve`; `serve --replicas 1 --route`
               holding the card under queue `serving` until SIGTERM; and
               the reservations file empty at the end;
7g. remote   — the remote control plane on a store of its own: `python
               -m polyaxon_tpu_torch streams start` as a child process
               and the port's agent serving that store in a thread here
               on the card. With POLYAXON_STREAMS_URL set, `main(["run",
               "-f", cli-lm.yaml, "-P", "steps=6", "--watch"])` POSTs
               7c's program (the preset's width, 2 layers), the agent
               trains it, exactly 24/12/12 flash launches; `ops
               ls|get|metrics|statuses|logs` over HTTP print what they
               print from the store itself, and `GET /runs?watch=` from
               the cursor before the POST returns the run's transitions
               in order through `succeeded`; 50 GETs each of the run's
               `/metrics` and `/status` (p50, p95) and a watcher's lag
               behind each event's commit. A second run of 200 steps is
               POSTed and stopped by `ops stop` after its first logged
               step: `stopped`, fewer steps. A container job (a script
               written by the phase) attaches through
               `tracking.init()`, runs `flash_attention` forward and
               backward on the card at the preset's head shape against
               the plain version (TOL, BWD_TOL), and logs the errors and
               milliseconds with `log_metrics` and a file with
               `log_artifact`, read back over HTTP by
               `RunClient(base_url=)`. `top --once` names the two runs
               active in its frame; `project create|ls|get` and `store
               recover`. The children are ended in a `finally`.

    python3 chip_smoke.py --zoo TAG [--seeds N ...] [--lrs X ...]

runs one train-zoo configuration alone (TAG as in ZOO_CASES, e.g.
`vit-s16`) for each seed and learning rate given, with every check of
phase 9, and prints its lines and the card's name and power limit: a
second look at a loss curve. It builds no kernel, so a configuration
that launches one fails there.

    python3 chip_smoke.py --zoo-context-faults

runs train-zoo's BERT-base on one device, then 9b sound and with each of
ZOO_CONTEXT_FAULTS planted in its rank processes at run time, and prints
each run's errors against ZOO_CONTEXT_TOL (which limits caught it).

Every phase prints JSON lines; any failed check raises and the script exits
non-zero. The kernel counters are zeroed just before each main path
(2b's ring drive, phases 3-4, then 4b, then 4c, then each config of 4e,
then 4d, then phases 5, 5b, 7 (7b zeroes and reads its own, then puts 7's back), 7c's run,
7d, 7e, 7f, 7g's first run, 8, each configuration of 9 and each rank of 9b) and read just after it, so `launches` counts the main paths only (4b launches none:
decode attends by einsum, as the reference's does; 4c, 4d and 7b launch
int8_matmul for every projection of their int8 configs). The `wall` line
gives the seconds of each group of phases. The last lines are the kernels JSON line, the card's name
and power limit from nvidia-smi, and {"ok": true, "device": {...}}.
Without CUDA, or without the rest of the checkout beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

HERE = Path(__file__).resolve().parent
ARTIFACTS = HERE / "build" / "chip_smoke"  # profile trace, checkpoints (git-ignored)

# NVIDIA H100 SXM data sheet, dense: tensor-core bf16, CUDA-core f32, HBM3
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
PRESET = "llama3-1b"
FORWARD_TOKENS = 4096
CSRC = "polyaxon_tpu_torch/ops/csrc"
# the bf16 instances, which must run their products as wgmma (HGMMA in the
# SASS): the forward, dq and dk/dv at each head dim, and int8_matmul's
# prefill kernel; the f32 instances (`<float, D>`, `int8_fma_kernel`) run on
# the CUDA cores and must hold none
WGMMA_INSTANCES = [
    f"{kernel}<{d}>"
    for kernel in ("flash_fwd_wgmma_kernel", "flash_dq_wgmma_kernel", "flash_dkv_wgmma_kernel")
    for d in (32, 64, 128)
] + [f"int8_wgmma_kernel<{n}>" for n in (128, 256)]
SCALAR_INSTANCES = ["int8_fma_kernel"]
KERNEL_ROWS = {  # name → (source, the TPU kernel it replaces)
    "flash_fwd": (f"{CSRC}/flash_fwd.cu", "polyaxon_tpu/ops/flash_attention.py:35"),
    "flash_dq": (f"{CSRC}/flash_bwd.cu", "polyaxon_tpu/ops/flash_attention.py:128"),
    "flash_dkv": (f"{CSRC}/flash_bwd.cu", "polyaxon_tpu/ops/flash_attention.py:176"),
    # no Pallas kernel there: XLA's mixed int8 x bf16 dot_general of Int8Dense
    "int8_matmul": (f"{CSRC}/int8_matmul.cu", "polyaxon_tpu/models/quant.py:85"),
}
# o is held per row: max |err| over the head_dim vector of each (b, s, h)
# over that row's max |o_ref|, so the late causal rows, whose |o| is small
# (an average over thousands of keys), are held as tightly as the early
# ones. bf16: each side rounds p (the kernel against its running max, the
# plain version against the row max) and o to bf16, up to 2^-8 relative
# each, so the two sides may sit 2^-7 apart; 2^-6 leaves 2x room above
# that. f32: sum order only. lse is absolute.
TOL = {"bfloat16": (2.0 ** -6, 1e-3), "float32": (1e-5, 1e-4)}  # (o row-rel, lse)
# forward logits: the bf16 flash path must sit as close to the same weights
# in f32 (einsum attention) as the bf16 einsum path does — bf16 rounding,
# not the kernel, sets the error — within this slack on the relative
# Frobenius error, or under the floor
FORWARD_REL_SLACK = 1.5
FORWARD_REL_FLOOR = 1e-2
# ... and directly against the bf16 einsum path on the same weights: the two
# differ only in how attention rounds. This reads 0.0168 (llama3-1b, 4096
# tokens, NVIDIA H100 80GB HBM3 at 700 W), about the 0.0153 that either
# bf16 path reads against f32; the limit leaves 1.5x room
FORWARD_REL_VS_EINSUM = 2.5e-2
# dq, dk and dv are held per row like o (max |err| of each (b, s, head)
# vector over that row's max |ref|). bf16: both sides round ds (and p) to
# bf16 at the same points from nearly the same f32 values, so those
# roundings rarely differ; each side rounds its output to bf16 (2^-8
# relative), so the two may sit 2^-7 apart; 2^-6 leaves 2x room. f32: sum
# order only, 1e-4 (ds = p * (dp - delta) may cancel).
BWD_TOL = {"bfloat16": 2.0 ** -6, "float32": 1e-4}
# the autograd chain in f32 at the main shape, per row: sum order only
CHAIN_TOL = 1e-4
TRAIN_TOKENS = 4096
TRAIN_STEPS = 8
TRAIN_PROGRAM = {
    "model": {"name": "transformer_lm", "config": {
        "preset": PRESET, "attention": "flash", "fused_lm_loss": True}},
    "data": {"name": "synthetic_text", "batchSize": 1,
             "config": {"seq_len": TRAIN_TOKENS, "vocab_size": 128256}},
    "optimizer": {"name": "adamw", "learningRate": 3e-4,
                  "schedule": {"name": "cosine", "warmup_steps": 2}},
    "train": {"steps": TRAIN_STEPS, "logEvery": 1, "precision": "mixed",
              "remat": True, "profileStart": 1, "profileStop": 2},
}
# launches per training step, from the code: each layer's attention runs
# the forward kernel once in the forward and once more when remat
# recomputes the forward for the backward, and each backward kernel once
PER_STEP = {"flash_fwd": 2, "flash_dq": 1, "flash_dkv": 1}  # x n_layers
# train-mesh: the train program on a one-rank mesh; its per-step losses
# against train's, relative (the same kernels and products in the same
# order: only the mesh path's f32 sums of the metrics differ)
TRAIN_MESH_AXES = {"data": 1, "fsdp": 1, "model": 1, "context": 1}
TRAIN_MESH_TOL = 1e-4
TRAIN_REFERENCE: dict = {}  # train's losses and step time, for train-mesh
# train-stages: the train program with pipeline_stages 4 (the blocks'
# weights stacked [4, 4, ...]) on a one-rank {pipeline: 1} mesh, where the
# stages run as a plain loop over stages and layers from train's initial
# weights; its losses against train's, relative, as train-mesh's (the same
# kernels and products on slices of the stacked weights: the mesh path's
# f32 sums of the metrics and of the clipping norm differ)
STAGES = 4
STAGES_MESH_AXES = {"pipeline": 1}
# ring-hops: llama3-1b attention over a ring of RING["n"] chunks
RING = dict(B=1, S=8192, H=32, KV=8, D=64, n=4, causal=True, dtype="bfloat16")
# the ring's hops against whole-sequence flash, per row: o carries one
# bf16 rounding of each hop's o_i (merged in f32) beyond the whole
# kernel's; dq, dk and dv each add up n bf16 hop gradients (a query chunk
# meets n key chunks, a key chunk n query chunks). Read on the card (NVIDIA
# H100 80GB HBM3, 700 W): o 0.0095, dq 0.0153, dk 0.0161, dv 0.0137
RING_TOL = {"o": 2.0 ** -6, "dq": 2.0 ** -5, "dk": 2.0 ** -5, "dv": 2.0 ** -5}
EINSUM_TOKENS = 2048  # the einsum path keeps [32, S, S] scores per layer
EINSUM_STEPS = 3
# flash vs einsum training, both bf16, from the same weights (per-step
# loss and grad_norm relative; the update's relative Frobenius distance):
# limits set from one reading with 1.5x room: 3.19e-5, 5.93e-4 and 0.0458
# (NVIDIA H100 80GB HBM3, 700 W). Both paths round to bf16 at different
# points (flash rounds the unnormalised p before P.V, the einsum path the
# normalised probabilities); Adam turns that noise in the smallest
# gradients into sign flips of their updates, so the updates differ far
# more than the losses do.
TRAIN_VS_EINSUM = {"loss": 5e-5, "grad_norm": 9e-4, "update": 7e-2}
PRESET_LAYERS, PRESET_PARAMS = 16, 1_498_482_688  # llama3-1b's depth and size
RULES_STEPS = 4  # steps of each remat policy
RULES_LAYERS = 4  # the remat policies at the preset's width, depth cut from 16
# train-zoo: the BASELINE configurations through the port's Trainer at their
# full width on their procedural streams, ZOO_STEPS steps each (the step
# seconds are the median of the steps after the first). `launches` is what
# the code launches a step: BERT's remat runs each layer's forward kernel
# twice; seq2seq's 6 encoder (non-causal) and 6 decoder (causal) layers
# once each; the MoE model's 4 layers once each
ZOO_STEPS = 6
ZOO_PROFILE_STEP = 3  # the torch.profiler window: this step alone
# examples/bert.yaml's rule; its schedule `linear_warmup` is a name neither
# package's build_schedule knows, so a constant after a linear warmup
ZOO_ADAMW = {"name": "adamw", "learningRate": 1e-4,
             "config": {"weight_decay": 0.01, "b2": 0.98},
             "schedule": {"name": "constant", "warmup_steps": 2}}
ZOO_CASES = [
    dict(tag="mlp", unit="images", descend=True, launches={}, program={
        "model": {"name": "mlp", "config": {"hidden": [512, 256], "num_classes": 10,
                                            "input_dim": 784}},
        "data": {"name": "mnist", "batchSize": 128},
        "optimizer": {"name": "adamw", "learningRate": 1e-3},
        "train": {"precision": "float32"}}),
    dict(tag="resnet50", unit="images", descend=False, launches={}, program={
        "model": {"name": "resnet50", "config": {"num_classes": 1000}},
        "data": {"name": "synthetic_imagenet", "batchSize": 64},
        "optimizer": {"name": "sgd", "learningRate": 0.1,
                      "config": {"momentum": 0.9, "nesterov": True},
                      "schedule": {"name": "cosine", "warmup_steps": 2}},
        "train": {"precision": "mixed"}}),
    dict(tag="vit-s16", unit="images", descend=False, launches={}, program={
        "model": {"name": "vit", "config": {"variant": "S/16", "num_classes": 1000,
                                            "image_size": 224, "attention": "xla"}},
        "data": {"name": "synthetic_imagenet", "batchSize": 128},
        # vit_hyperband.yaml's defaults. With 1000 classes and 128 images a
        # batch, 6 batches hold ~0.8 images of a class: each step raises the
        # logits of its batch's classes and the next batch holds mostly
        # others, so the loss rises (at lr 1e-3 and 1e-4, seeds 0-2) and is
        # not required to fall here; the reference's test requires it of a
        # 10-class ViT, as tests/test_torch_zoo_trainer.py does on the CPU
        "optimizer": {"name": "adamw", "learningRate": 1e-3,
                      "config": {"weight_decay": 0.01}},
        "train": {"precision": "mixed"}}),
    dict(tag="bert-base", unit="tokens", descend=False,
         launches={"flash_fwd": 24, "flash_dq": 12, "flash_dkv": 12}, program={
             # examples/bert.yaml: its num_layers/hidden_dim/... are not BERT's
             # keys, so both packages build bert-base
             "model": {"name": "bert", "config": {
                 "num_layers": 12, "hidden_dim": 768, "num_heads": 12, "mlp_dim": 3072,
                 "vocab_size": 30522, "max_len": 512, "attention": "flash"}},
             "data": {"name": "synthetic_mlm", "batchSize": 32,
                      "config": {"seq_len": 512, "vocab_size": 30522}},
             "optimizer": ZOO_ADAMW,
             "train": {"precision": "mixed", "remat": True}}),
    dict(tag="seq2seq-small", unit="tokens", descend=False,
         launches={"flash_fwd": 12, "flash_dq": 12, "flash_dkv": 12}, program={
             "model": {"name": "seq2seq", "config": {"preset": "small", "src_len": 128,
                                                     "tgt_len": 128, "attention": "flash"}},
             "data": {"name": "synthetic_seq2seq", "batchSize": 32,
                      "config": {"src_len": 128, "tgt_len": 128, "vocab_size": 32128}},
             "optimizer": {"name": "adamw", "learningRate": 3e-4,
                           "schedule": {"name": "cosine", "warmup_steps": 2}},
             "train": {"precision": "mixed"}}),
    # llama3-1b's width with 8 switch experts, depth cut to 4 layers (f32
    # masters, grads and AdamW of its 2.2 B parameters are ~35 GB)
    dict(tag="moe-llama3-1b-4l", unit="tokens", descend=False,
         launches={"flash_fwd": 4, "flash_dq": 4, "flash_dkv": 4}, program={
             "model": {"name": "transformer_lm", "config": {
                 "preset": PRESET, "n_layers": 4, "n_experts": 8, "capacity_factor": 1.25,
                 "seq_len": 2048, "attention": "flash", "fused_lm_loss": True}},
             "data": {"name": "synthetic_text", "batchSize": 1,
                      "config": {"seq_len": 2048, "vocab_size": 128256}},
             "optimizer": {"name": "adamw", "learningRate": 3e-4,
                           "schedule": {"name": "cosine", "warmup_steps": 2}},
             "train": {"precision": "mixed"}}),
]
# BERT-base's logits with `attention: flash` against `attention: xla` on the
# same bf16 weights, [ZOO_BERT_ROWS, 512] tokens: relative Frobenius. Both
# round attention to bf16 at different points; a prior from the llama3-1b
# forward check (0.0168 read there, limit 2.5e-2), and the flash path must
# sit as close to an f32 copy as the einsum path does (FORWARD_REL_SLACK)
ZOO_BERT_ROWS = 8
BERT_FLASH_VS_XLA = 2.5e-2
# train-zoo-mesh: each ZOO_CASES configuration again on a one-rank `nccl`
# mesh under its sharding rules (DTensor parameters), ZOO_STEPS steps so
# the schedules decay as train-zoo's do, from the same seeded weights and
# stream. ResNet-50 takes BatchNorm's statistics through the global
# reduction (sums of x and x^2 over a global count) and the MoE runs under
# an expert axis of 1. Losses against train-zoo's, relative: the f32 MLP
# within 1e-5 (the mesh's loss is a sum over a count where train-zoo's is
# a mean, and the clipping norm reduces over DTensor shards: the last f32
# bits); the bf16 (mixed) models within 2e-3 (a last-bit f32 difference
# in a BatchNorm statistic or an update flips some bf16 roundings
# downstream, 2^-8 each, averaged over the batch). Running statistics
# (ResNet-50's 106 buffers, max over channels relative to each buffer's
# largest) within 2^-7: a flipped bf16 rounding moves a channel's
# statistic by up to 2^-8 of it, and six steps of momentum compound a few
# (read: 2.2e-4 to 1.4e-3 over three runs); a statistic of the wrong count
# or of a part of the batch sits 1e-1 or more away
ZOO_MESH_AXES = {"data": 1, "fsdp": 1, "model": 1}
ZOO_MESH_TOL = {"float32": 1e-5, "mixed": 2e-3}
ZOO_MESH_STATS_TOL = 2.0 ** -7
ZOO_REFERENCE: dict = {}  # train-zoo's losses, statistics, step time, memory
# train-zoo-context: train-zoo's BERT-base on {context: 2}, two processes on
# the one card under gloo, self-attention on the ring. Against train-zoo's
# one-device run, relative (zoo_context_errors): the worst step's loss and
# grad norm, and the loss's change over the steps (the loss itself moves
# only ~2.6e-3 in 3 steps, so a run whose updates went wrong still sits
# near it). Each limit lies between the sound run's reading and the
# smallest reading of a planted fault that it must catch
# (`--zoo-context-faults`, ZOO_CONTEXT_FAULTS; H100 80GB HBM3, 700 W):
# loss sound 2.8e-5, faults 3.5e-4 (own chunk only) to 1.0; grad norm
# sound 2.1e-3, faults 2.0e-2 (local positions) to 1.0; loss change sound
# 8.5e-3, faults 0.19 to 1.05 (own chunk only reads 1.1e-2 there: the
# loss and the grad norm catch it)
ZOO_CONTEXT_TAG = "bert-base"
ZOO_CONTEXT_STEPS = 3
ZOO_CONTEXT_AXES = {"context": 2}
ZOO_CONTEXT_TOL = {"loss": 1e-4, "grad_norm": 6e-3, "loss_change": 4e-2}
ZOO_CONTEXT_FAULTS = ("local-positions", "local-count", "own-chunk-only",
                      "kv-grads-dropped")
ZOO_CONTEXT_TIMEOUT_S = 300
# serve-batched: three server configs on the full model under one traffic,
# two waves of 8 concurrent greedy requests of SERVE_NEW tokens, 8 of the
# 16 prompts behind one shared SERVE_PREFIX-token system prefix
SERVE_NEW = 64
SERVE_PREFIX = 1024
SERVE_PROMPT_LENS = (128, 2048)
SERVE_SEED = 3
SERVE_BASE = {"max_batch": 8, "max_wait_ms": 50.0}
SERVE_CONFIGS = {
    "dense": {"batching": True},
    "paged": {"kv_pool_pages": 2048, "kv_page_tokens": 128, "prefix_cache": True},
    # 8 decode rows plus one 256-token prefill slice, with room
    "step": {"kv_pool_pages": 2048, "kv_page_tokens": 128, "prefix_cache": True,
             "chunked_prefill": True, "prefill_chunk_tokens": 256,
             "max_step_tokens": 2304},
}
# 16 layers x (k, v) x 8 kv heads x 64 x 2 bytes = 32 KiB a token, x 2048
# pages of 128 tokens = 8 GiB
SERVE_POOL_BYTES = PRESET_LAYERS * 2 * 8 * 64 * 2 * 2048 * 128
SAMPLED_ON = ("dense", "paged")
SAMPLED_BODY = {"tokens": [list(range(1000, 1300))], "maxNewTokens": SERVE_NEW,
                "temperature": 0.8, "topK": 50, "seed": 7}
# a greedy divergence passes only where the reference path's top-2 logit
# gap is under this share of its top logit (a bf16 near-tie)
NEAR_TIE = 2.0 ** -6
PROFILE_BATCH, PROFILE_SLOTS = 8, 2112  # the decode step that is profiled
# int8_matmul: llama3-1b's projections (K, N) — q/o, k/v, gate/up, down —
# at decode rows (1, 8), the step scheduler's rows (256: a prefill chunk;
# 264: 8 decode rows + a chunk) and a prefill slab (2048), bf16 and f32,
# and bf16 at 9 and 16 rows, the first the wgmma kernel takes. Held per
# row against the plain version: bf16 within 2^-7 (each side rounds the
# f32 sum to bf16 once, up to 2^-8 relative each), f32 within 1e-5 (sum
# order); two calls give the same bits
INT8_SHAPES = {"q_o": (2048, 2048), "k_v": (2048, 512), "gate_up": (2048, 8192),
               "down": (8192, 2048)}
INT8_ROWS = (1, 8, 256, 264, 2048)
INT8_SEAM_ROWS = (9, 16)
INT8_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
INT8_DECODE_M = 8  # the main-path row of the kernels line: one decode step
INT8_PREFILL_ROWS = (256, 2048)  # the prefill-layer lines
# one layer's launches as the model makes them: (K, the N of each member)
INT8_LAYER = {"qkv": (2048, (2048, 512, 512)), "o": (2048, (2048,)),
              "gate_up": (2048, (8192, 8192)), "down": (8192, (2048,))}
INT8_GROUPS = ("qkv", "gate_up")  # timed beside their single projections
# the same layer on a rank of a `model: 2` decode mesh (serve-mesh (b)):
# q/k/v and gate/up hold half their rows, o and down half their columns
INT8_SHARD_LAYER = {"qkv": (2048, (1024, 256, 256)), "o": (1024, (2048,)),
                    "gate_up": (2048, (4096, 4096)), "down": (4096, (2048,))}
# a verify window of serve-mesh (b)'s speculation: 2 rows x (K + 1 = 5)
INT8_VERIFY_M = 10
# the decode kernel's row, a verify window's and a prefill chunk's
INT8_SHARD_ROWS = (INT8_DECODE_M, INT8_VERIFY_M, 256)
INT8_COLD_BYTES = 160 << 20  # weight copies cycled per timing: past the 50 MB L2
# serve-fast: the step config with speculation (n-gram drafts, K = 4), with
# a 2-layer draft model (layer truncation; the half-depth "auto" draft was
# checked at full depth before and costs the most time of this phase) and
# the adaptive controller, and with int8 weights and the int8 pool; the
# same traffic
FAST_CONFIGS = {
    "spec": {**SERVE_CONFIGS["step"], "speculate": True, "draft_tokens": 4},
    "draft": {**SERVE_CONFIGS["step"], "speculate": True, "draft_tokens": 4,
              "draft_model": (("n_layers", 2),), "adaptive_draft": True},
    "int8": {**SERVE_CONFIGS["step"], "quantize": True, "kv_quant": "int8"},
}
SAMPLED_FAST = "spec"  # the sampled request, held against dense's
# 2 (k, v) x 16 layers x 2048 x 128 slots x 8 kv heads x (64 payload bytes
# + a 4-byte f32 scale)
INT8_POOL_BYTES = 2 * PRESET_LAYERS * 2048 * 128 * 8 * (64 + 4)
BEAM_PROMPT, BEAMS = 300, 4
# int8 vs bf16 teacher-forced on one prompt: the argmax agrees at >= 0.75 of
# the positions whose bf16 top-2 gap is >= NEAR_TIE of the top logit (the
# reference's own floor, tests/test_generate.py:346-347)
INT8_AGREE = 0.75
INT8_TF_TOKENS = 2048
# serve-mesh: the step config on a decode mesh. (a) one `nccl` rank,
# `ModelServer(mesh=decode_mesh({batch: 1, model: 1}))`, the step and int8
# configs beside a one-device server of the same config: 4 of
# serve-batched's first wave (2 behind the shared prefix, 2 not), MESH_NEW
# new tokens each, posted one at a time (concurrent requests make the scheduler's steps depend on
# their arrival order), equal to the one-device rows bit for bit (where
# they part from serve-batched's / serve-fast's concurrent rows is
# reported). (b) two
# processes on the one card under `gloo`, `{model: 2}`, int8 then bf16, on
# the first MESH_B_PROMPTS of them, MESH_B_NEW new tokens each (a step
# takes ~0.19 s there: 34 collectives through host memory, two processes
# time-sliced on one card), held against (a)'s one-device rows
# under the near-tie rule (two halves' sum rounds unlike one product)
MESH_PROMPTS = (0, 1, 4, 5)
MESH_NEW = 32  # (a)'s new tokens a row (held against serve-batched's first 32)
MESH_B_PROMPTS, MESH_B_NEW = 2, 16
MESH_POOL_PAGES = 256  # 32768 slots: the rows' pages and the prefix's, with room
MESH_CONFIGS = {
    "step": {**SERVE_CONFIGS["step"], "kv_pool_pages": MESH_POOL_PAGES},
    "int8": {**FAST_CONFIGS["int8"], "kv_pool_pages": MESH_POOL_PAGES},
}
MESH_B_TIMEOUT_S = 420
# serve-mesh's features: every serving feature on the mesh. (a) each beside
# a one-device server of its config, on the first MESH_FEATURE_PROMPTS
# prompts, MESH_FEATURE_NEW new tokens, posted one at a time, rows equal
# bit for bit: beam search (numBeams 2, inline), n-gram speculation (K =
# 4), a 2-layer draft model on int8 weights and the int8 pool (64 int8
# launches a forward of the target and 8 a forward of the draft, on the
# wrapper's count and the card's), two tenants on int8 adapters
# (MESH_ADAPTERS) with one adapter slot (acme, globex, acme: two evictions
# and a restore), the spill tier (a MESH_SPILL_PAGES-page pool; the target
# prompt's prefix demoted by a flood and restored on its next hit, the
# demoted pages one device's bytes) and the prefill role handing off to a
# one-device decode replica behind the port's router (against a one-device
# prefill replica in its place). (b) runs `spec` and `tenants-int8` on its
# two rows of MESH_B_NEW tokens, held against (a)'s one-device rows under
# the near-tie rule (the tenants' TENANT_NEAR_TIE)
MESH_FEATURE_PROMPTS, MESH_FEATURE_NEW = 2, 16
MESH_ADAPTERS = {"a1": "seed:1", "a2": "seed:2"}
MESH_TENANTS = [{"name": "acme", "adapter": "a1"}, {"name": "globex", "adapter": "a2"}]
MESH_TENANT_ORDER = ("acme", "globex", "acme")
# the CPU test's spill traffic (tests/test_torch_spill.py) at 128-token
# pages: a 6-page-and-a-token target, six floods of its length, the target
MESH_SPILL_PAGES, MESH_SPILL_FLOOD, MESH_SPILL_SEED = 24, 6, 12
MESH_FEATURES = {
    "beams": MESH_CONFIGS["step"],
    "spec": {**MESH_CONFIGS["step"], "speculate": True, "draft_tokens": 4},
    "draft-int8": {**MESH_CONFIGS["int8"], "speculate": True, "draft_tokens": 4,
                   "draft_model": (("n_layers", 2),)},
    "tenants-int8": {**MESH_CONFIGS["int8"], "adapter_slots": 1},
    "spill": {**MESH_CONFIGS["step"], "kv_pool_pages": MESH_SPILL_PAGES,
              "spill_ram_bytes": 1 << 30},
    "handoff": {**MESH_CONFIGS["step"], "role": "prefill"},
}
MESH_B_FEATURES = ("spec", "tenants-int8")
# serve-tenants: llama3-1b with rank-16 LoRA on all seven projections (alpha
# 16), three synthetic adapters (`seed:<n>`, 22.5 MB each in bf16) behind
# three tenants, two adapter slots beyond the checkpoint's own, so the
# third adapter evicts an idle one to the adapter spill tier. The pool is
# 64 pages: wave 1 caches the shared prefix (8 pages), the flood's three
# 2000-token rows need more than is free, so the idle prefix is demoted to
# the spill tier (RAM in `tenants`, disk in `tenants-int8`) and wave 2
# restores it.
# 8 new tokens a row: the same pages, sheds, spills and restores as 32
# give, with a quarter of their decode steps and of the solo references'
# steps, so the script keeps within half its time limit
TENANT_RANK, TENANT_NEW, TENANT_SLOTS, TENANT_SEED, TENANT_BURST = 16, 8, 2, 8, 4
TENANT_ADAPTERS = {"a1": "seed:1", "a2": "seed:2", "a3": "seed:3"}
TENANTS = [
    {"name": "acme", "adapter": "a1"},
    {"name": "globex", "adapter": "a2"},
    {"name": "initech", "adapter": "a3", "max_outstanding": 2},
]
TENANT_STEP = {**SERVE_CONFIGS["step"], "kv_pool_pages": 64}
TENANT_CONFIGS = {
    "tenants": {**TENANT_STEP, "spill_ram_bytes": 4 << 30,
                "spill_dir": str(ARTIFACTS / "spill" / "tenants")},
    "tenants-int8": {**TENANT_STEP, "quantize": True, "kv_quant": "int8",
                     "spill_ram_bytes": 0, "spill_dir": str(ARTIFACTS / "spill" / "int8")},
}
# the per-row LoRA delta against the merged-adapter product per row: bf16
# rounds the base product, the two rank-r products and the sum once each
# (2^-8 relative at most each, well under 2^-7 together); f32 is sum order
TENANT_LORA_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
# served rows against their solo references: compare_rows's near-tie rule,
# widened once for the adapter path. Its bf16 rounding differs from the solo
# reference's (other lanes and buckets take other GEMM shapes, and the rank-16
# deltas round on their own): on an H100 the served logits moved up to 0.094
# (3 bf16 ulps, 2.3% of a 4.125 top logit) and a greedy row flipped at a
# 0.094 gap (2.2%). The rule is the next power of two above that move
TENANT_NEAR_TIE = 2.0 ** -5
# a top-k sampled row may also flip at the mask's edge: a token within this
# many bf16 ulps of the k-th logit may be in one path's mask and out of the
# other's (on the card a sampled row's token sat 1 ulp above the 50th logit
# of the reference's prefill and under it in its decode step)
TENANT_EDGE_ULPS = 2
# serve-fleet: three replicas of the step config with a 64-page pool. The
# waves of FLEET_WAVE rows fit it: a 2048-token row reserves 17 pages, and
# its harvest (which the export reads) copies up to 15 more, so two such
# rows and one harvest take 49 of the 63 usable pages
FLEET_NEW, FLEET_SEED, FLEET_WAVE, FLEET_REQUESTS = 32, 11, 2, 12
FLEET_LAYERS = 4  # the fleet runs the preset's width at 4 of its 16 layers
FLEET_STEP = {**SERVE_CONFIGS["step"], "kv_pool_pages": 64}
FLEET_CONFIGS = {
    "fleet": FLEET_STEP,
    "fleet-int8": {**FLEET_STEP, "quantize": True, "kv_quant": "int8"},
}
FLEET_SAMPLE = {"temperature": 0.8, "topK": 50, "seed": 7}
FLEET_SLOS = [
    {"name": "avail", "kind": "availability", "objective": 0.99, "windows": [5, 30]},
    {"name": "latency", "kind": "latency", "objective": 0.95, "threshold_ms": 30000,
     "windows": [5, 30]},
]
# on the direct replica: a latency objective no request meets, so its breach
# edge writes a flight-recorder bundle with a FLEET_PROFILE_S profile window
FLEET_BREACH_SLO = {"name": "breach", "kind": "latency", "objective": 0.99,
                    "threshold_ms": 1, "windows": [1, 2]}
FLEET_PROFILE_S = 0.5


# serve-moe: llama3-1b's full width and depth with 8 switch experts a block
# (capacity 1.25, top-1 routing; 6.9 B parameters in bf16). The experts see
# no pad mask and take their capacity from the S of each forward, as the
# reference's do, so a served row is held against a direct call that
# reproduces its padding, its prefill chunks and its prefix hit
# (moe_direct_rows), never against an unpadded generate. serve-batched's
# first wave on the step config, MOE_NEW new tokens a row, posted one at a
# time (a concurrent wave's prefix hits would depend on arrival order),
# then the same wave on int8 weights (q/k/v/o only: the router and the
# experts stay bf16) and the int8 pool, then n-gram speculation (K = 4,
# not adaptive) on the dense coalescer for MOE_SPEC_PROMPTS at
# MOE_SPEC_NEW tokens, each row against a direct spec_generate of its
# bucketed, left-padded prompt
MOE_MODEL = {"preset": PRESET, "attention": "flash", "n_experts": 8, "capacity_factor": 1.25}
MOE_NEW = 32
MOE_POOL_PAGES = 512  # 8 rows of up to 17 pages and their harvests, with room
MOE_CONFIGS = {
    "step": {**SERVE_CONFIGS["step"], "kv_pool_pages": MOE_POOL_PAGES},
    "int8": {**SERVE_CONFIGS["step"], "kv_pool_pages": MOE_POOL_PAGES, "quantize": True,
             "kv_quant": "int8"},
    "spec": {"batching": True, "speculate": True, "draft_tokens": 4},
}
MOE_SPEC_PROMPTS, MOE_SPEC_NEW = (0, 4), 16
# an int8 MoE forward, from the code: q/k/v grouped (models.quant.project)
# and o; the experts' SwiGLU is no QUANT_TARGETS projection
MOE_INT8_PER_LAYER = 2
# train-scan: the train program at RULES_LAYERS layers for 4 steps (mixed,
# remat, flash), unscanned and then with scan_layers from the same initial
# weights and stream. No clipping and element-wise AdamW: the stacked
# parameters' gradients are the per-layer ones copied into one tensor, so
# the losses agree bit for bit; the grad_norm metric sums the squares of
# [L, ...] tensors instead of L separate ones (f32 sum order)
SCAN_GRAD_NORM_TOL = 1e-5
SCAN_SERVE_PROMPTS, SCAN_SERVE_NEW = (0, 4), 16


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2, rounds: int = 3) -> float:
    """Device time of one call: CUDA events around `reps` calls issued back
    to back, over `reps`; the median of `rounds` such runs. The host
    enqueues ahead of the device, so a call's launch overhead is hidden
    wherever its device work outlasts it (events around a single call
    count the host's gap before the launch as device time)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(fn, reps: int, rounds: int = 3) -> float:
    """Device time of one call without the host's cost of launching it:
    `reps` calls captured in one CUDA graph, replayed between CUDA events,
    over `reps`; the median of `rounds` replays. For kernels shorter than
    the host's dispatch of a call (decode's int8 projections run a few
    microseconds), where `cuda_ms` reads the host."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch asks
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def row_rel_err(out, ref) -> float:
    """max over rows of max |out - ref| / max |ref|; a row is the last dim.
    A row whose max |ref| is below a thousandth of the whole tensor's (dq of
    the first causal query is 0 up to rounding) is held against that
    thousandth instead, so rounding noise on a vanishing row is not read as
    a relative error of 1e24."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().amax(-1)
    scale = ref.abs().amax(-1)
    floor = max(1e-3 * scale.max().item(), 1e-30)
    return (err / scale.clamp_min(floor)).max().item()


def attention_bound(B, S, H, KV, D, causal, dtype) -> tuple[float, str, int]:
    """Least time for the card: the larger of the needed ops over the
    dtype's peak and each input read / output written once over HBM rate.
    → (bound ms, what bounds it, operations)."""
    import torch

    pairs = S * (S + 1) // 2 if causal else S * S  # (query, key) pairs attended
    ops = 4 * B * H * pairs * D  # two products of 2 ops per multiply-add
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = size * (2 * B * S * H * D + 2 * B * S * KV * D) + 4 * B * H * S
    t_ops = ops / PEAK_OPS[str(dtype).removeprefix("torch.")]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), ops


def hgmma_counts(library: Path) -> dict[str, int]:
    """HGMMA (wgmma) instructions in each kernel instance of a built
    library (flash instances by template arguments, int8_matmul's kernels
    by name), from the CUDA toolkit's `cuobjdump --dump-sass`."""
    from polyaxon_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(tool), "--dump-sass", str(library)],
        capture_output=True, text=True, timeout=300, check=True,
    ).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            m = re.search(r"(flash_(?:fwd|dq|dkv)(?:_wgmma)?_kernel)I(f)?Li(\d+)E", line)
            i8 = re.search(r"(int8_[a-z]+_kernel)(?:ILi(\d+)E)?", line)
            name = (f"{m.group(1)}<{'float, ' if m.group(2) else ''}{m.group(3)}>" if m
                    else i8.group(1) + (f"<{i8.group(2)}>" if i8.group(2) else "") if i8
                    else line.split("Function : ")[1].strip())
            counts[name] = 0
        elif name is not None and "HGMMA" in line:
            counts[name] += 1
    return counts


def phase_build() -> None:
    """nvcc every kernel source at once (one compiler per source), with the
    gang's launcher (g++) beside them; then the SASS of each library must
    hold HGMMA in every bf16 instance and none in an f32 one, and the
    launcher must inject the rendezvous environment."""
    from concurrent.futures import ThreadPoolExecutor

    from polyaxon_tpu_torch.native import launcher_path
    from polyaxon_tpu_torch.ops import _build

    names = sorted({Path(src).stem for src, _ in KERNEL_ROWS.values()})

    def build(name):
        t0 = time.perf_counter()
        path = _build.build(name)
        return name, path, time.perf_counter() - t0

    with ThreadPoolExecutor(len(names) + 1) as pool:
        launcher = pool.submit(launcher_path)
        built = list(pool.map(build, names))
        launcher = launcher.result()
    gang = subprocess.run(
        [launcher, "--num-workers", "2", "--coordinator", "127.0.0.1:29511", "--",
         "/bin/sh", "-c", 'echo "$RANK/$WORLD_SIZE@$MASTER_ADDR:$MASTER_PORT"'],
        capture_output=True, text=True, timeout=60,
    )
    ranks = sorted(ln for ln in gang.stdout.splitlines() if "@" in ln)
    emit({"phase": "build", "source": "launcher", "binary": str(Path(launcher).relative_to(HERE)),
          "workers": ranks})
    check(gang.returncode == 0 and ranks == ["0/2@127.0.0.1:29511", "1/2@127.0.0.1:29511"],
          f"the launcher's workers saw {ranks} (exit {gang.returncode})")
    counts = {}
    for name, path, seconds in built:
        _build.load(name)
        log = path.with_name(path.name + ".log")
        ptxas = [
            ln.strip() for ln in log.read_text().splitlines()
            if "Used" in ln or "spill" in ln or "Compiling entry" in ln
        ] if log.exists() else []
        emit({
            "phase": "build", "source": name, "seconds": seconds,
            "library": str(path.relative_to(HERE)), "ptxas": ptxas,
        })
        lib_counts = hgmma_counts(path)
        emit({"phase": "build-sass", "source": name, "hgmma": lib_counts})
        counts.update(lib_counts)
    missing = [k for k in WGMMA_INSTANCES if not counts.get(k)]
    check(not missing, f"no HGMMA in the SASS of {missing}")
    check(all(k in counts for k in SCALAR_INSTANCES), f"{SCALAR_INSTANCES} not in the SASS")
    scalar = [k for k, n in counts.items() if ("<float, " in k or k in SCALAR_INSTANCES) and n]
    check(not scalar, f"HGMMA in the SASS of the f32 instances {scalar}")


KERNEL_CASES = [
    # the main path: llama3-1b attention at 4096 tokens, the model's blocks
    dict(case="main", B=1, S=4096, H=32, KV=8, D=64, causal=True,
         dtype="bfloat16", block_q=128, block_kv=512),
    dict(case="non-causal-mha-d128-f32", B=2, S=1024, H=8, KV=8, D=128,
         causal=False, dtype="float32", block_q=128, block_kv=128),
    dict(case="blocks-64x256-d32", B=2, S=2048, H=16, KV=4, D=32, causal=True,
         dtype="bfloat16", block_q=64, block_kv=256),
    dict(case="short-seq-gqa8-f32", B=3, S=48, H=8, KV=1, D=64, causal=True,
         dtype="float32", block_q=16, block_kv=48),
    dict(case="seq-200-gqa2-bf16", B=1, S=200, H=4, KV=2, D=64, causal=False,
         dtype="bfloat16", block_q=8, block_kv=40),
    # the head width of an 8B-class Llama (D=128), causal GQA
    dict(case="d128-causal-gqa4-bf16", B=1, S=2048, H=32, KV=8, D=128, causal=True,
         dtype="bfloat16", block_q=128, block_kv=128),
    # ragged S (200 is no multiple of the 64-row tiles), causal, GQA 2
    dict(case="seq-200-causal-gqa2-bf16", B=1, S=200, H=4, KV=2, D=64, causal=True,
         dtype="bfloat16", block_q=8, block_kv=40),
    # train-zoo's shapes: BERT-base's encoder (non-causal, one query head per
    # kv head), seq2seq-small's encoder (non-causal, G=1) and decoder
    # self-attention (causal, G=1), and the MoE model's attention at 2048
    # tokens (causal GQA 32/8)
    dict(case="bert-base-b32-s512", B=32, S=512, H=12, KV=12, D=64, causal=False,
         dtype="bfloat16", block_q=128, block_kv=512),
    # a rank's share of BERT-base's heads under examples/bert.yaml's
    # `model: 2` (6 of 12)
    dict(case="bert-base-model2-b32-s512", B=32, S=512, H=6, KV=6, D=64, causal=False,
         dtype="bfloat16", block_q=128, block_kv=512),
    dict(case="seq2seq-small-enc-b32-s128", B=32, S=128, H=8, KV=8, D=64, causal=False,
         dtype="bfloat16", block_q=128, block_kv=128),
    dict(case="seq2seq-small-dec-b32-s128", B=32, S=128, H=8, KV=8, D=64, causal=True,
         dtype="bfloat16", block_q=128, block_kv=128),
    dict(case="moe-llama3-1b-s2048", B=1, S=2048, H=32, KV=8, D=64, causal=True,
         dtype="bfloat16", block_q=128, block_kv=512),
]


def phase_kernels() -> dict:
    """Each case: kernel vs plain version, times. Returns the main case."""
    import torch
    from torch.nn import functional as F

    from polyaxon_tpu_torch.ops.flash_attention import (
        flash_attention_lse,
        flash_attention_reference,
    )

    results = {}
    for i, c in enumerate(KERNEL_CASES):
        dtype = getattr(torch, c["dtype"])
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        B, S, H, KV, D = c["B"], c["S"], c["H"], c["KV"], c["D"]
        q, k, v = (
            torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))
        )
        causal = c["causal"]

        def kernel():
            return flash_attention_lse(
                q, k, v, causal=causal, block_q=c["block_q"], block_kv=c["block_kv"]
            )

        def plain():
            return flash_attention_reference(q, k, v, causal=causal)

        def library():  # yardstick only: the port never calls it
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=KV != H,
            )

        o, lse = kernel()
        o_ref, lse_ref = plain()
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        rel_o = row_rel_err(o, o_ref)
        err_lse = (lse - lse_ref).abs().max().item()
        tol_o, tol_lse = TOL[c["dtype"]]
        lib_o = library().transpose(1, 2)
        rel_lib = row_rel_err(lib_o, o_ref)
        bound_ms, bound_by, ops = attention_bound(B, S, H, KV, D, causal, dtype)
        ms = cuda_ms(kernel, reps=20)
        res = {
            "phase": "kernel", "kernel": "flash_fwd", **c,
            "max_abs_err_o": err_o, "row_rel_err_o": rel_o,
            "max_abs_err_lse": err_lse,
            "tol_row_rel_o": tol_o, "tol_lse": tol_lse,
            "library_row_rel_err_o": rel_lib,
            "ms": ms,
            "plain_ms": cuda_ms(plain, reps=5),
            "library_ms": cuda_ms(library, reps=20),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "x_bound": ms / bound_ms, "tflops": ops / ms / 1e9,
        }
        emit(res)
        check(
            rel_o <= tol_o and err_lse <= tol_lse,
            f"flash_fwd disagrees with its plain version on {c['case']}: "
            f"o row-relative {rel_o} (tol {tol_o}), lse {err_lse} (tol {tol_lse})",
        )
        results[c["case"]] = res
        del q, k, v, o, lse, o_ref, lse_ref, lib_o
        torch.cuda.empty_cache()
    return results["main"]


def backward_bound(B, S, H, KV, D, causal, dtype) -> dict:
    """Least time for dq and for dk/dv: operations (dq 3 products, 6 ops per
    (query, key) pair and head dim; dk/dv 4 products, 8) over the dtype's
    peak, or each input read and output written once over HBM rate.
    name → (bound ms, what bounds it, operations)."""
    import torch

    pairs = S * (S + 1) // 2 if causal else S * S
    size = torch.tensor([], dtype=dtype).element_size()
    peak = PEAK_OPS[str(dtype).removeprefix("torch.")]
    q_bytes, kv_bytes, stats = size * B * S * H * D, size * B * S * KV * D, 8 * B * H * S
    out = {}
    for name, ops_per, written in (
        ("flash_dq", 6, q_bytes), ("flash_dkv", 8, 2 * kv_bytes)
    ):
        ops = ops_per * B * H * pairs * D
        t_ops = ops / peak
        t_bytes = (2 * q_bytes + 2 * kv_bytes + stats + written) / PEAK_BYTES_PER_S
        out[name] = (
            max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", ops
        )
    return out


def phase_backward_kernels() -> dict:
    """Each case: dq, dk, dv of the kernels against the plain backward,
    per row, with times. Returns the main case's rows by kernel name."""
    import torch
    from torch.nn import functional as F

    from polyaxon_tpu_torch.ops import flash_attention as fa

    rows = {}
    for i, c in enumerate(KERNEL_CASES):
        dtype = getattr(torch, c["dtype"])
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        B, S, H, KV, D, causal = c["B"], c["S"], c["H"], c["KV"], c["D"], c["causal"]
        q, do = (
            torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
            for _ in range(2)
        )
        k, v = (
            torch.randn((B, S, KV, D), generator=gen, device="cuda").to(dtype)
            for _ in range(2)
        )
        scale = D ** -0.5
        with torch.no_grad():
            o, lse = fa.flash_attention_lse(
                q, k, v, causal=causal, block_q=c["block_q"], block_kv=c["block_kv"]
            )
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()

        def dq_kernel():
            return fa.FLASH_DQ(q, k, v, do, lse, delta, causal=causal, scale=scale)

        def dkv_kernel():
            return fa.FLASH_DKV(q, k, v, do, lse, delta, causal=causal, scale=scale)

        def plain():
            return fa.flash_attention_bwd_reference(
                q, k, v, o, lse, do, delta, causal=causal
            )

        # yardstick only, the port never calls it: the backward of
        # scaled_dot_product_attention (fwd+bwd minus fwd), dq and dk/dv
        # together
        lq, lk, lv = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        ldo = do.transpose(1, 2)

        def lib_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(
                    lq, lk, lv, is_causal=causal, enable_gqa=KV != H
                )

        def lib_fwd_bwd():
            out = F.scaled_dot_product_attention(
                lq, lk, lv, is_causal=causal, enable_gqa=KV != H
            )
            return torch.autograd.grad(out, (lq, lk, lv), ldo)

        got = (dq_kernel(), *dkv_kernel())
        want = plain()
        torch.cuda.synchronize()
        tol = BWD_TOL[c["dtype"]]
        errs = {
            name: (row_rel_err(a, b), (a.float() - b.float()).abs().max().item())
            for name, a, b in zip(("dq", "dk", "dv"), got, want)
        }
        lib_err = {
            name: row_rel_err(a.transpose(1, 2), b)
            for name, a, b in zip(("dq", "dk", "dv"), lib_fwd_bwd(), want)
        }
        bounds = backward_bound(B, S, H, KV, D, causal, dtype)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        library_ms = cuda_ms(lib_fwd_bwd, reps=10) - cuda_ms(lib_fwd, reps=10)
        times = {"flash_dq": cuda_ms(dq_kernel, reps=10),
                 "flash_dkv": cuda_ms(dkv_kernel, reps=10)}
        for name, outs in (("flash_dq", ("dq",)), ("flash_dkv", ("dk", "dv"))):
            res = {
                "phase": "kernel", "kernel": name, **c,
                **{f"row_rel_err_{o}": errs[o][0] for o in outs},
                **{f"max_abs_err_{o}": errs[o][1] for o in outs},
                **{f"library_row_rel_err_{o}": lib_err[o] for o in outs},
                "tol_row_rel": tol,
                "ms": times[name],
                "plain_ms": plain_ms, "plain_covers": "dq, dk and dv",
                "library_ms": library_ms, "library_covers": "dq, dk and dv",
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "x_bound": times[name] / bounds[name][0],
                "tflops": bounds[name][2] / times[name] / 1e9,
            }
            emit(res)
            if c["case"] == "main":
                rows[name] = res
        bad = {o: e[0] for o, e in errs.items() if not e[0] <= tol}
        check(not bad, f"flash backward disagrees with its plain version on "
                       f"{c['case']}: row-relative {bad} (tol {tol})")
        del q, k, v, o, lse, do, delta, got, want, lq, lk, lv, ldo
        torch.cuda.empty_cache()
    return rows


def phase_autograd_chain() -> None:
    """Forward kernel then both backward kernels through autograd, with
    cotangents on o and lse, against autograd through the plain forward:
    f32 at the main-path shape, per row."""
    import torch

    from polyaxon_tpu_torch.ops import flash_attention as fa

    B, S, H, KV, D = 1, FORWARD_TOKENS, 32, 8, 64
    gen = torch.Generator(device="cuda").manual_seed(300)
    leaves = [
        torch.randn(shape, generator=gen, device="cuda")
        for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))
    ]
    do = torch.randn((B, S, H, D), generator=gen, device="cuda")
    dlse = torch.randn((B, H, S), generator=gen, device="cuda")
    before = [kern.launches for kern in fa.KERNELS]
    grads = []
    for fn in (fa.flash_attention_lse, fa.flash_attention_reference):
        q, k, v = (t.clone().requires_grad_() for t in leaves)
        o, lse = fn(q, k, v, causal=True)
        torch.autograd.backward([o, lse], [do, dlse])
        grads.append((q.grad, k.grad, v.grad))
        del o, lse, q, k, v
        torch.cuda.empty_cache()
    launched = [kern.launches - n for kern, n in zip(fa.KERNELS, before)]
    errs = {
        name: row_rel_err(a, b) for name, a, b in zip(("dq", "dk", "dv"), *grads)
    }
    emit({"phase": "kernel-chain", "B": B, "S": S, "H": H, "KV": KV, "D": D,
          "dtype": "float32", "causal": True, "lse_cotangent": True,
          **{f"row_rel_err_{k}": v for k, v in errs.items()}, "tol_row_rel": CHAIN_TOL,
          "launches": dict(zip((k.name for k in fa.KERNELS), launched))})
    check(launched == [1, 1, 1], f"the autograd chain launched {launched}")
    check(all(e <= CHAIN_TOL for e in errs.values()),
          f"autograd chain disagrees with the plain forward's: {errs}")
    del grads, leaves
    torch.cuda.empty_cache()


def int8_bound(M, K, Ns, dtype) -> tuple[float, str]:
    """Least time for one launch of y_i = (x . wq_i^T) * scale_i over the
    members' widths Ns: x read once for the whole group, each wq_i and
    scale_i read once and each y_i written once over the HBM rate, against
    2MK sum(Ns) operations at the peak of x's dtype (the products run in
    bf16 on the tensor cores, or in f32 on the CUDA cores). → (ms, what
    bounds it)."""
    size = 2 if dtype == "bfloat16" else 4
    N = sum(Ns)
    nbytes = M * K * size + N * K + 4 * N + M * N * size
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2 * M * N * K / PEAK_OPS[dtype]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def int8_case(M: int, K: int, Ns, dt: str, tag: str, launch=None,
              kernel: str = "int8_matmul") -> dict:
    """One int8_matmul call (a group when Ns has several widths) on x [M, K]
    against random weights quantized per row: each member held per row
    against the plain version, two calls equal bit for bit; then its
    device time with the weights cycled past the L2, as a decode step
    finds them (every layer's projections are read once a step), by CUDA
    graph replay (`ms`); the same call dispatched from Python back to back
    (`host_ms`, what an eager step pays); the plain versions; and one
    torch.matmul on the concatenated bf16 weights (`library_ms`, twice the
    weight bytes; a yardstick the port never calls). `launch(x, pairs)`
    (default `int8_matmul_group`) is what is held and timed: another
    build of the kernel can stand in for it under the name `kernel`."""
    import torch

    from polyaxon_tpu_torch.models.quant import quantize_kernel
    from polyaxon_tpu_torch.ops.int8_matmul import (
        INT8_MATMUL, int8_matmul_group, int8_matmul_reference,
    )

    dtype = getattr(torch, dt)
    gen = torch.Generator(device="cuda").manual_seed(K + sum(Ns) + M)
    pairs = [quantize_kernel(torch.randn((n, K), generator=gen, device="cuda") / K ** 0.5)
             for n in Ns]
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    launch = launch or int8_matmul_group
    ys = launch(x, pairs)
    again = launch(x, pairs)
    refs = [int8_matmul_reference(x, wq, scale) for wq, scale in pairs]
    torch.cuda.synchronize()
    rel = max(row_rel_err(y, r) for y, r in zip(ys, refs))
    err = max((y.float() - r.float()).abs().max().item() for y, r in zip(ys, refs))
    same = all(torch.equal(a, b) for a, b in zip(ys, again))
    nbytes = sum(n * K for n in Ns)
    copies = max(1, -(-INT8_COLD_BYTES // nbytes))
    sets = [[(wq.clone(), scale) for wq, scale in pairs] for _ in range(copies)]
    wbf = [torch.cat([(wq.float() * scale[:, None]).to(torch.bfloat16) for wq, scale in pairs])
           for _ in range(max(1, -(-INT8_COLD_BYTES // (2 * nbytes))))]
    xb = x.to(torch.bfloat16)
    it = {"k": 0, "l": 0}

    def call():
        it["k"] = (it["k"] + 1) % copies
        return launch(x, sets[it["k"]])

    def library():
        it["l"] = (it["l"] + 1) % len(wbf)
        return torch.matmul(xb, wbf[it["l"]].T)

    ms = graph_ms(call, reps=max(20, 2 * copies))
    host_ms = cuda_ms(call, reps=max(20, 2 * copies))
    plain_ms = graph_ms(lambda: [int8_matmul_reference(x, wq, s) for wq, s in pairs], reps=5)
    lib_ms = graph_ms(library, reps=max(20, 2 * len(wbf)))
    bound_ms, bound_by = int8_bound(M, K, Ns, dt)
    own = launch is int8_matmul_group  # the plan is this build's
    tile_n, splits = INT8_MATMUL.plan(M, K, Ns, dtype) if own else (None, None)
    res = {
        "phase": "kernel", "kernel": kernel, "shape": tag, "M": M, "K": K,
        "N": list(Ns), "dtype": dt, "row_rel_err": rel, "max_abs_err": err,
        "tol_row_rel": INT8_TOL[dt], "deterministic": same, "ms": ms, "host_ms": host_ms,
        "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
        "bound_by": bound_by,
        "x_bound": ms / bound_ms, "tflops": 2 * M * sum(Ns) * K / ms / 1e9,
        "gb_per_s": (nbytes + M * K * dtype.itemsize) / ms / 1e6,
        "tile_n": tile_n, "k_splits": splits, "cold_weight_copies": copies,
    }
    emit(res)
    check(rel <= INT8_TOL[dt], f"{kernel} disagrees with its plain version at {tag} "
          f"M={M} {dt}: row-relative {rel} (tol {INT8_TOL[dt]})")
    check(same, f"{kernel} at {tag} M={M} {dt}: two calls differ")
    del sets, wbf, pairs, x, ys, again, refs
    torch.cuda.empty_cache()
    return res


def int8_layer(rows: dict, M: int, names=INT8_LAYER) -> dict:
    """One layer's four launches at M rows, bf16 (INT8_LAYER), summed from
    the kernel phase's rows."""
    keys = ("ms", "host_ms", "plain_ms", "library_ms", "bound_ms")
    layer = {k: sum(rows[(name, M)][k] for name in names) for k in keys}
    layer["max_abs_err"] = max(rows[(name, M)]["max_abs_err"] for name in names)
    layer["x_bound"] = layer["ms"] / layer["bound_ms"]
    by_ops = sum(rows[(name, M)]["bound_ms"] for name in names
                 if rows[(name, M)]["bound_by"] == "operations")
    layer["bound_by"] = "operations" if 2 * by_ops > layer["bound_ms"] else "bytes"
    return layer


def phase_int8_kernel() -> dict:
    """int8_matmul against its plain version (int8_case): each of
    llama3-1b's four projection shapes alone for M in INT8_ROWS, bf16 and
    f32, and at INT8_SEAM_ROWS in bf16; the grouped q/k/v and gate/up
    launches beside them. Then one layer's four launches, as the model
    makes them: a decode step's (M = INT8_DECODE_M, the kernels-line row)
    and a prefill's (INT8_PREFILL_ROWS, against cuBLAS on bf16 weights)."""
    import torch

    rows = {}
    single = {"q_o": "o", "down": "down"}  # the single projections a layer launches
    for shape, (K, N) in INT8_SHAPES.items():
        for M in INT8_ROWS + INT8_SEAM_ROWS:
            for dt in ("bfloat16", "float32"):
                if dt == "float32" and M in INT8_SEAM_ROWS:
                    continue
                res = int8_case(M, K, (N,), dt, shape)
                if dt == "bfloat16" and shape in single:
                    rows[(single[shape], M)] = res
    for name in INT8_GROUPS:
        K, Ns = INT8_LAYER[name]
        for M in INT8_ROWS:
            for dt in ("bfloat16", "float32"):
                res = int8_case(M, K, Ns, dt, name)
                if dt == "bfloat16":
                    rows[(name, M)] = res
    decode = int8_layer(rows, INT8_DECODE_M)
    emit({"phase": "kernel-int8-decode-layer", "M": INT8_DECODE_M, "launches": len(INT8_LAYER),
          **decode, "device": device_line()})
    for M in INT8_PREFILL_ROWS:
        layer = int8_layer(rows, M)
        flops = 2 * M * sum(K * sum(Ns) for K, Ns in INT8_LAYER.values())
        emit({"phase": "kernel-int8-prefill-layer", "M": M, "launches": len(INT8_LAYER),
              "ms": layer["ms"], "bound_ms": layer["bound_ms"], "x_bound": layer["x_bound"],
              "tflops": flops / layer["ms"] / 1e9, "cublas_ms": layer["library_ms"],
              "plain_ms": layer["plain_ms"], "host_ms": layer["host_ms"],
              "device": device_line()})
    shard = {}
    for name, (K, Ns) in INT8_SHARD_LAYER.items():
        for M in INT8_SHARD_ROWS:
            shard[(name, M)] = int8_case(M, K, Ns, "bfloat16", f"{name}-model2")
    for M in INT8_SHARD_ROWS:
        layer = int8_layer(shard, M, INT8_SHARD_LAYER)
        emit({"phase": "kernel-int8-shard-layer", "mesh": {"model": 2}, "M": M,
              "kernel": "int8_gemv_kernel" if M <= 8 else "int8_wgmma_kernel",
              "launches": len(INT8_SHARD_LAYER), **layer, "device": device_line()})
    torch.cuda.empty_cache()
    return decode


def ring_drive(q, k, v, n: int, causal: bool):
    """Every rank's hops of a ring of `n` in one process: rank idx's query
    chunk against each K/V chunk the ring brings it, through
    `parallel.ring.flash_hop` in `_ring_body_flash`'s order, the chunks
    sliced where the ring would receive them; the ranks' outputs
    concatenated along the sequence."""
    import torch

    from polyaxon_tpu_torch.parallel.ring import flash_hop

    s, scale = q.shape[1] // n, q.shape[-1] ** -0.5
    outs = []
    for idx in range(n):
        qi = q[:, idx * s:(idx + 1) * s]
        o = lse = None
        for t in range(n):
            src = (idx - t) % n
            kc, vc = (x[:, src * s:(src + 1) * s] for x in (k, v))
            o, lse = flash_hop(qi, kc, vc, o, lse, scale=scale, causal=causal and t == 0,
                               keep=not causal or t == 0 or src < idx)
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=1)


def phase_ring_hops(kernels) -> dict:
    """The ring's hop shapes through the kernels against their plain
    versions, with times; then the ring drive against whole-sequence flash.
    Returns the drive's launches (the counters zeroed just before it)."""
    import torch
    from torch.nn import functional as F

    from polyaxon_tpu_torch.ops import flash_attention as fa

    r = RING
    dtype = getattr(torch, r["dtype"])
    B, S, H, KV, D, n = r["B"], r["S"], r["H"], r["KV"], r["D"], r["n"]
    s, scale = S // n, D ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(300)
    q, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((B, S, KV, D), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    rows = []
    for causal in (True, False):  # the own chunk, then another rank's
        qh, kh, vh, doh = q[:, :s], k[:, s:2 * s], v[:, s:2 * s], do[:, :s]
        if causal:
            kh, vh = k[:, :s], v[:, :s]
        with torch.no_grad():
            o, lse = fa.flash_attention_lse(qh, kh, vh, causal=causal)
        o_ref, lse_ref = fa.flash_attention_reference(qh, kh, vh, causal=causal)
        dlse = torch.randn((B, H, s), generator=gen, device="cuda")
        delta = ((doh.float() * o.float()).sum(-1).transpose(1, 2) - dlse).contiguous()
        got = (fa.FLASH_DQ(qh, kh, vh, doh, lse, delta, causal=causal, scale=scale),
               *fa.FLASH_DKV(qh, kh, vh, doh, lse, delta, causal=causal, scale=scale))
        want = fa.flash_attention_bwd_reference(qh, kh, vh, o, lse, doh, delta, causal=causal)
        torch.cuda.synchronize()
        errs = {"o": row_rel_err(o, o_ref), "lse": (lse - lse_ref).abs().max().item(),
                **{g: row_rel_err(a, b) for g, a, b in zip(("dq", "dk", "dv"), got, want)}}
        tol_o, tol_lse = TOL[r["dtype"]]
        tol_b = BWD_TOL[r["dtype"]]
        check(errs["o"] <= tol_o and errs["lse"] <= tol_lse
              and all(errs[g] <= tol_b for g in ("dq", "dk", "dv")),
              f"ring hop (causal={causal}) disagrees with the plain version: {errs}")
        lq, lk, lv = (t.transpose(1, 2).detach().requires_grad_() for t in (qh, kh, vh))

        def lib_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                                      enable_gqa=True)

        def lib_fwd_bwd():
            out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                                 enable_gqa=True)
            return torch.autograd.grad(out, (lq, lk, lv), doh.transpose(1, 2))

        fwd_bound = attention_bound(B, s, H, KV, D, causal, dtype)
        bwd_bound = backward_bound(B, s, H, KV, D, causal, dtype)
        lib_fwd_ms = cuda_ms(lib_fwd, reps=10)
        lib_bwd_ms = cuda_ms(lib_fwd_bwd, reps=10) - lib_fwd_ms
        plain_bwd_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(
            qh, kh, vh, o, lse, doh, delta, causal=causal), reps=3, warmup=1)
        timed = {
            "flash_fwd": (lambda: fa.flash_attention_lse(qh, kh, vh, causal=causal),
                          fwd_bound, cuda_ms(lambda: fa.flash_attention_reference(
                              qh, kh, vh, causal=causal), reps=3, warmup=1), lib_fwd_ms),
            "flash_dq": (lambda: fa.FLASH_DQ(qh, kh, vh, doh, lse, delta, causal=causal,
                                             scale=scale),
                         bwd_bound["flash_dq"], plain_bwd_ms, lib_bwd_ms),
            "flash_dkv": (lambda: fa.FLASH_DKV(qh, kh, vh, doh, lse, delta, causal=causal,
                                               scale=scale),
                          bwd_bound["flash_dkv"], plain_bwd_ms, lib_bwd_ms),
        }
        for name, (fn, bound, plain_ms, lib_ms) in timed.items():
            ms = cuda_ms(fn, reps=10)
            row = {"phase": "ring-hop", "kernel": name, "causal": causal,
                   "shape": [B, s, H, KV, D], "dtype": r["dtype"], "errors": errs,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "library_covers": "SDPA forward" if name == "flash_fwd"
                   else "SDPA backward (dq, dk and dv)",
                   "plain_covers": "forward" if name == "flash_fwd" else "dq, dk and dv",
                   "bound_ms": bound[0], "bound_by": bound[1], "x_bound": ms / bound[0],
                   "launches_per_ring": (1 if causal else n - 1) * n}
            emit(row)
            rows.append(row)
        del lq, lk, lv, o, lse, o_ref, lse_ref, got, want, delta, dlse
    # the whole sequence through the kernels, the yardstick of the drive
    qf, kf, vf = (t.detach().requires_grad_() for t in (q, k, v))
    whole = fa.flash_attention(qf, kf, vf, causal=r["causal"])
    whole.backward(do)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    torch.cuda.synchronize()
    for kern in kernels:  # the ring's hops start here
        kern.launches = 0
    t0 = time.perf_counter()
    out = ring_drive(qr, kr, vr, n, r["causal"])
    out.backward(do)
    torch.cuda.synchronize()
    drive_ms = (time.perf_counter() - t0) * 1e3
    launches = {kern.name: kern.launches for kern in kernels}  # ... and end here
    errs = {"o": row_rel_err(out, whole), "dq": row_rel_err(qr.grad, qf.grad),
            "dk": row_rel_err(kr.grad, kf.grad), "dv": row_rel_err(vr.grad, vf.grad)}
    expected = {"flash_fwd": n * n, "flash_dq": n * n, "flash_dkv": n * n}
    emit({"phase": "ring-hops", **r, "s_local": s, "row_rel_err": errs, "tol": RING_TOL,
          "launches": launches, "expected_launches": expected,
          "drive_wall_ms": drive_ms})
    check(all(errs[x] <= RING_TOL[x] for x in errs),
          f"the ring's hops disagree with whole-sequence flash: {errs} (tol {RING_TOL})")
    check(all(launches.get(name, 0) == m for name, m in expected.items()),
          f"ring launches {launches}, expected {expected}")
    del q, k, v, do, qf, kf, vf, qr, kr, vr, whole, out
    torch.cuda.empty_cache()
    return launches


def phase_train_mesh() -> dict:
    """The train program on a one-rank `nccl` mesh (`attention: ring`, which
    dispatches to flash at n=1) against train's losses; returns the
    launches."""
    import torch

    from polyaxon_tpu_torch.ops.flash_attention import KERNELS
    from polyaxon_tpu_torch.runtime import Trainer

    program = json.loads(json.dumps(TRAIN_PROGRAM))
    program["model"]["config"]["attention"] = "ring"
    for key in ("profileStart", "profileStop"):
        program["train"].pop(key)
    one_rank_group()
    try:
        torch.cuda.reset_peak_memory_stats()
        stamps = []
        trainer = Trainer(program, mesh_axes=TRAIN_MESH_AXES,
                          log_fn=lambda step, m: stamps.append(time.perf_counter()))
        cfg = trainer.module.cfg
        for kern in KERNELS:  # the mesh path starts here
            kern.launches = 0
        result = trainer.run()
        torch.cuda.synchronize()
        launches = {kern.name: kern.launches for kern in KERNELS}  # ... and ends here
        gaps = [b - a for a, b in zip(stamps, stamps[1:])]
        step_s = statistics.median(gaps[1:])
        losses = [h["loss"] for h in result.history]
        ref = TRAIN_REFERENCE["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        expected = {k: PER_STEP[k] * cfg.n_layers * TRAIN_STEPS for k in PER_STEP}
        emit({
            "phase": "train-mesh", "mesh_axes": TRAIN_MESH_AXES, "backend": "nccl",
            "attention": "ring", "n_layers": cfg.n_layers, "steps": TRAIN_STEPS,
            "tokens_per_step": TRAIN_TOKENS, "losses": losses, "train_losses": ref,
            "max_rel_loss_vs_train": rel, "tol": TRAIN_MESH_TOL,
            "median_step_seconds": step_s,
            "train_median_step_seconds": TRAIN_REFERENCE["step_s"],
            "step_time_vs_train": step_s / TRAIN_REFERENCE["step_s"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "train_peak_mem_gb": TRAIN_REFERENCE["peak_mem_gb"],
            "launches": launches, "expected_launches": expected,
        })
        check(len(losses) == len(ref) and rel <= TRAIN_MESH_TOL,
              f"train-mesh losses {losses} against train's {ref}: {rel} > {TRAIN_MESH_TOL}")
        check(launches == expected, f"train-mesh launches {launches}, expected {expected}")
        del trainer, result
    finally:
        leave_group()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_forward(model) -> None:
    """Full-sequence forward through the flash kernel, held against the
    same weights on the einsum attention path."""
    import torch

    from polyaxon_tpu_torch.models.transformer import Transformer
    from polyaxon_tpu_torch.ops.flash_attention import FLASH_FWD

    cfg = model.cfg
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, FORWARD_TOKENS), generator=gen).cuda()
    before = FLASH_FWD.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = model(tokens)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = FLASH_FWD.launches - before
    check(
        launches == cfg.n_layers,
        f"forward launched flash_fwd {launches} times, expected {cfg.n_layers}",
    )
    check(
        tuple(logits.shape) == (1, FORWARD_TOKENS, cfg.vocab_size)
        and bool(torch.isfinite(logits).all()),
        f"forward logits malformed: shape {tuple(logits.shape)}",
    )
    flash = logits.float()
    del logits

    def einsum_logits(dtype):
        ref_model = Transformer(
            dataclasses.replace(cfg, attention="xla"), device="cuda", dtype=dtype
        )
        ref_model.load_state_dict(model.state_dict())  # bf16 → f32 is exact
        out = ref_model(tokens).float()
        del ref_model
        torch.cuda.empty_cache()
        return out

    einsum = einsum_logits(model.dtype)
    exact = einsum_logits(torch.float32)

    def rel(a):
        return ((a - exact).norm() / exact.norm()).item()

    rel_flash, rel_einsum = rel(flash), rel(einsum)
    rel_vs_einsum = ((flash - einsum).norm() / einsum.norm()).item()
    top1 = (flash.argmax(-1) == exact.argmax(-1)).float().mean().item()
    max_abs = (flash - exact).abs().max().item()
    del flash, einsum, exact
    torch.cuda.empty_cache()
    limit = max(FORWARD_REL_SLACK * rel_einsum, FORWARD_REL_FLOOR)
    emit({
        "phase": "forward", "preset": PRESET, "tokens": FORWARD_TOKENS,
        "n_layers": cfg.n_layers, "flash_launches": launches,
        "seconds": seconds, "tokens_per_s": FORWARD_TOKENS / seconds,
        "rel_err_flash_bf16_vs_f32": rel_flash,
        "rel_err_einsum_bf16_vs_f32": rel_einsum, "rel_err_limit": limit,
        "rel_err_flash_vs_einsum_bf16": rel_vs_einsum,
        "rel_err_vs_einsum_limit": FORWARD_REL_VS_EINSUM,
        "max_abs_err_flash_bf16_vs_f32": max_abs, "top1_agree_vs_f32": top1,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    check(
        rel_flash <= limit,
        f"flash bf16 logits rel err {rel_flash} vs f32 exceeds {limit}",
    )
    check(
        rel_vs_einsum <= FORWARD_REL_VS_EINSUM,
        f"flash bf16 logits rel err {rel_vs_einsum} vs the bf16 einsum path "
        f"exceeds {FORWARD_REL_VS_EINSUM}",
    )


def _http(url: str, body=None, headers=None) -> dict:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json", **(headers or {})},
        method="POST" if data is not None else "GET",
    )
    with urllib.request.urlopen(req, timeout=300) as resp:
        check(resp.status == 200, f"{url} answered {resp.status}")
        return json.loads(resp.read())


def phase_serve(model) -> None:
    import torch

    from polyaxon_tpu_torch.models.generate import generate
    from polyaxon_tpu_torch.serving.batching import ServingConfig
    from polyaxon_tpu_torch.serving.server import ModelServer

    server = ModelServer(
        model, None, ServingConfig(batching=False, max_batch=1), model_name=PRESET
    )
    port = server.start("127.0.0.1", 0)
    url = f"http://127.0.0.1:{port}"
    try:
        health = _http(url + "/healthz")
        check(health.get("status") == "ok", f"/healthz said {health}")
        gen = torch.Generator().manual_seed(2)
        for plen in (5, 37, 130):
            prompt = torch.randint(0, model.cfg.vocab_size, (1, plen), generator=gen)
            body = {"tokens": prompt.tolist(), "maxNewTokens": 16}
            t0 = time.perf_counter()
            out = _http(url + "/generate", body)["tokens"]
            latency = time.perf_counter() - t0
            direct = generate(model, prompt, max_new_tokens=16).cpu().tolist()
            emit({
                "phase": "serve", "prompt_len": plen, "new_tokens": 16,
                "latency_ms": latency * 1e3, "equal_direct": out == direct,
            })
            check(out == direct, f"/generate differs from generate() at P={plen}")
            check(len(out[0]) == plen + 16, "wrong response length")
    finally:
        server.stop()


def _post_all(url: str, bodies: list, codes: bool = False) -> list:
    """POST every body at once, one thread each; the answers in order. A
    failed request raises here, not inside its thread — or, with `codes`,
    each answer is (HTTP status, JSON body) and only a failure to get an
    answer raises."""
    import threading
    import urllib.error

    out: list = [None] * len(bodies)

    def one(i):
        try:
            out[i] = _http(url + "/generate", bodies[i])
            if codes:
                out[i] = (200, out[i])
        except urllib.error.HTTPError as e:
            out[i] = (e.code, json.loads(e.read())) if codes else e
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out[i] = e

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    for i, o in enumerate(out):
        if not isinstance(o, tuple if codes else dict):
            raise SmokeFailure(f"request {i} failed: {o!r}")
    return out


def _sse(url: str, body: dict) -> list:
    """POST /generate?stream=1 and parse every `data:` frame."""
    req = urllib.request.Request(
        url + "/generate?stream=1", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        check(resp.status == 200, f"stream answered {resp.status}")
        raw = resp.read().decode()
    return [json.loads(f[len("data: "):]) for f in raw.split("\n\n") if f]


def serve_traffic(vocab: int) -> list:
    """Two waves of 8 prompts of SERVE_PROMPT_LENS tokens from a seeded
    generator; in each wave 4 start with the shared SERVE_PREFIX-token
    system prefix, so the second wave's find it in the prefix cache."""
    import torch

    gen = torch.Generator().manual_seed(SERVE_SEED)

    def toks(n):
        return torch.randint(0, vocab, (n,), generator=gen).tolist()

    def length(lo, hi):
        return int(torch.randint(lo, hi + 1, (1,), generator=gen))

    lo, hi = SERVE_PROMPT_LENS
    prefix = toks(SERVE_PREFIX)
    shared = [prefix + toks(length(lo, hi - SERVE_PREFIX)) for _ in range(8)]
    other = [toks(length(lo, hi)) for _ in range(8)]
    return [shared[:4] + other[:4], shared[4:] + other[4:]]


def sampler_logits(logits, sample):
    """What a sampled row's pick compares (`sample` = (temperature, top_k,
    seed, generation index)): the logits over the temperature, top-k
    masked, plus that row's Gumbel noise, as generate's sampler makes them."""
    from polyaxon_tpu_torch.models.generate import _gumbel, _top_k_mask

    temperature, top_k, seed, g = sample
    logits = _top_k_mask((logits / temperature)[None], top_k)[0]
    return logits + _gumbel(logits.shape, seed, g, logits.device)


def top2_gap(logits) -> float:
    """(top1 - top2) / |top1| of one row of logits."""
    import torch

    top = torch.topk(logits, 2).values
    return float((top[0] - top[1]) / top[0].abs())


def next_token_gap(model, tokens: list, sample=None) -> float:
    """The reference path's top-2 gap at the token after `tokens`, over its
    top logit (top2_gap) of the dense-cache prefill's last logits — or, for
    a sampled row, of the logits its sampler compares (sampler_logits)."""
    import torch

    x = torch.tensor([tokens], device=model.device)
    logits = model(x, cache=model.make_cache(1), pos=0)[0, -1].float()
    return top2_gap(logits if sample is None else sampler_logits(logits, sample))


def compare_rows(model, got: list, ref: list, prompt_len: int, sample=None,
                 gaps=None):
    """None when `got` equals `ref`; else the first differing generated
    position and the reference path's top-2 gap there (from `gaps`, one per
    generated token, where the reference recorded them; else recomputed
    by next_token_gap). On bf16 another batch shape may take other GEMM
    kernels, so a divergence passes only at a near-tie: a gap under
    NEAR_TIE of the top logit."""
    if got == ref:
        return None
    j = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b) - prompt_len
    check(j >= 0, "a response changed its prompt")
    if sample is not None:
        sample = (*sample, j)
    gap = gaps[j] if gaps is not None else next_token_gap(model, ref[:prompt_len + j], sample)
    check(gap < NEAR_TIE, f"divergence at generated token {j} with top-2 gap "
          f"{gap} (>= {NEAR_TIE}): not a near-tie")
    return {"position": j, "gap": gap}


def run_serve_config(model, name: str, waves: list, reference: list, *,
                     config: dict = None, phase: str = "serve-batched",
                     sampled: bool = None, pool_bytes: int = None,
                     extra=None) -> dict:
    """One server config under the traffic: the two waves of concurrent
    greedy requests (each row held against `reference`'s, unless it is
    None: the int8 server's rows are held after the kernel counts are read,
    by check_int8_rows), then a non-streamed and a streamed request of one
    shared-prefix prompt, then (dense, paged, or when `sampled`) the
    sampled request; `extra(url)` runs last, on the
    live server. The pool is gated twice: /statsz's bytes (the formula
    admission budgets with) and the bytes of the live pool tensors. Returns
    the answers, the sampled row, the final /statsz, extra's result and
    the server (stopped)."""
    import torch

    from polyaxon_tpu_torch.serving.batching import ServingConfig
    from polyaxon_tpu_torch.serving.server import ModelServer

    torch.cuda.reset_peak_memory_stats()
    config = ServingConfig(**SERVE_BASE, **(config or SERVE_CONFIGS[name]))
    server = ModelServer(model, None, config, model_name=PRESET, device=model.device)
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    extra_out = None
    try:
        t0 = time.perf_counter()
        answers = []
        for wave in waves:
            answers += _post_all(url, [
                {"tokens": [p], "maxNewTokens": SERVE_NEW} for p in wave
            ])
        wall = time.perf_counter() - t0
        steps = server._m_decode_step.summary()["count"]  # the waves' steps
        stats = _http(url + "/statsz")
        body = {"tokens": [waves[1][0]], "maxNewTokens": SERVE_NEW}
        whole = _http(url + "/generate", body)["tokens"][0]
        events = _sse(url, body)
        sampled_row = None
        if name in SAMPLED_ON if sampled is None else sampled:
            sampled_row = _http(url + "/generate", SAMPLED_BODY)["tokens"][0]
        final = _http(url + "/statsz")
        if extra is not None:
            extra_out = extra(url)
        live_pool_bytes = None
        if server._kv is not None:
            live_pool_bytes = sum(t.numel() * t.element_size()
                                  for layer in server._kv.cache for t in layer)
    finally:
        server.stop()
    prompts = [p for wave in waves for p in wave]
    divergences = []
    for i, (p, a) in enumerate(zip(prompts, answers)):
        row = a["tokens"][0]
        check(len(row) == len(p) + SERVE_NEW,
              f"{name}: response {i} has {len(row)} tokens, not {len(p) + SERVE_NEW}")
        if reference is None:
            continue
        d = compare_rows(model, row, reference[i], len(p))
        if d is not None:
            divergences.append({"row": i, **d})
    streamed = [t for ev in events if "tokens" in ev for t in ev["tokens"]]
    check(events[-1].get("done") is True, f"{name}: the stream did not end with done")
    check(body["tokens"][0] + streamed == whole,
          f"{name}: streamed chunks differ from the non-streamed tokens")
    after = server.stats()  # after the drain in stop()
    kv = after["kv"]
    if kv["enabled"]:
        check(kv["active_rows"] == 0 and kv["pages_reserved"] == 0,
              f"{name}: rows still hold pages after the traffic: {kv}")
        check(kv["pages_used"] == 1 + kv["prefix"]["held_pages"],
              f"{name}: pages leaked: {kv['pages_used']} used, scratch + "
              f"{kv['prefix']['held_pages']} held by the prefix cache")
        pool_bytes = SERVE_POOL_BYTES if pool_bytes is None else pool_bytes
        check(kv["kv_pool_bytes"] == pool_bytes,
              f"{name}: /statsz gives a pool of {kv['kv_pool_bytes']} bytes, not {pool_bytes}")
        check(live_pool_bytes == pool_bytes,
              f"{name}: the pool tensors hold {live_pool_bytes} bytes, not {pool_bytes}")
        check(kv["prefix"]["hits"] >= 1, f"{name}: no prefix-cache hit")
    chunked = final["chunked"]
    if chunked["enabled"]:
        check(chunked["steps"] > chunked["prefill_only_steps"],
              f"{name}: the scheduler ran no mixed step: {chunked}")
    generated = SERVE_NEW * len(prompts)
    spec = stats["speculation"]
    line = {
        "phase": phase, "config": name, "device": device_line(),
        "requests": len(prompts), "waves": len(waves), "new_tokens": SERVE_NEW,
        "prompt_lens": [len(p) for p in prompts],
        "wall_seconds": wall, "decode_tokens_per_s": generated / wall,
        "ttft_ms_p50": stats["ttft_ms"]["p50"], "ttft_ms_p95": stats["ttft_ms"]["p95"],
        "decode_step_ms_p50": stats["decode_step_ms"]["p50"],
        # decode tokens (after each row's first) over the decode steps or
        # verify windows run (the paged group path times chunks instead)
        "decode_steps": steps,
        "tokens_per_step": (generated - len(prompts)) / steps if steps else None,
        "accept_rate": spec["accept_rate"], "proposed": spec["proposed"],
        "accepted": spec["accepted"], "effective_k": spec["effective_k"],
        "latency_ms_p50": stats["latency_ms"]["p50"],
        "mean_batch_occupancy": stats["mean_batch_occupancy"],
        # None: held later (the int8 rows, check_int8_rows)
        "rows_diverged": None if reference is None else len(divergences),
        "divergences": divergences,
        "stream_chunks": sum(1 for ev in events if "tokens" in ev),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if kv["enabled"]:
        line.update({
            "kv_pool_bytes": kv["kv_pool_bytes"], "live_pool_bytes": live_pool_bytes,
            "pages_hwm": kv["pages_hwm"],
            "pages_total": kv["pages_total"], "rows_admitted_hwm": kv["active_rows_hwm"],
            "dense_equivalent_rows": kv["dense_equivalent_rows"],
            "prefix_hits": kv["prefix"]["hits"], "prefix_misses": kv["prefix"]["misses"],
        })
    if chunked["enabled"]:
        line.update({k: chunked[k] for k in ("steps", "prefill_only_steps", "prefill_chunks")})
        line["step_tokens_p50"] = chunked["step_tokens"]["p50"]
    emit(line)
    return {"sampled": sampled_row, "answers": [a["tokens"][0] for a in answers],
            "stats": final, "extra": extra_out, "server": server}


def profile_decode_step(model) -> None:
    """One decode step at B=PROFILE_BATCH, each row's frontier at slot
    PROFILE_SLOTS - 1, through the dense cache (whose window is the whole
    seq_len) and through the paged pool (a PROFILE_SLOTS-slot table rounded
    up to pages): its median time (CUDA events around back-to-back steps,
    so host gaps count), then one step under torch.profiler — the top
    device ops and the device's idle share of the step."""
    import torch

    from polyaxon_tpu_torch.models.generate import make_paged_cache
    from polyaxon_tpu_torch.models.kv_pages import PagedKVLayout

    B, S, dev = PROFILE_BATCH, PROFILE_SLOTS, model.device
    gen = torch.Generator().manual_seed(4)
    tok = torch.randint(0, model.cfg.vocab_size, (B, 1), generator=gen).to(dev)
    pad = torch.zeros(B, dtype=torch.long, device=dev)
    layout = PagedKVLayout(128, 1 + B * -(-S // 128))
    n_pages = layout.pages_for(S)
    tables = 1 + torch.arange(B * n_pages, device=dev).reshape(B, n_pages)
    caches = {"dense": model.make_cache(B), "paged": make_paged_cache(model, layout)}
    steps = {
        "dense": lambda: model(tok, cache=caches["dense"], pos=S - 1, pad=pad),
        "paged": lambda: model(tok, cache=caches["paged"], pos=S - 1, pad=pad,
                               pages=tables, kv_layout=layout),
    }
    for name, fn in steps.items():
        profile_step(fn, {
            "phase": "serve-profile", "path": name, "batch": B, "window_slots": (
                model.cfg.seq_len if name == "dense" else n_pages * layout.page_tokens),
            "frontier": S,
        })
    del caches
    torch.cuda.empty_cache()


def profile_step(fn, fields: dict) -> dict:
    """`fn` (one decode step or verify window): its median time (CUDA events
    around back-to-back calls, so host gaps count), then one call under
    torch.profiler — the top device ops, the device's idle share and the
    int8 kernel's device time. Emits `fields` with the numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ms = cuda_ms(fn, reps=10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(_device_time_us(e) for e in kernels) / 1e3
    int8 = [e for e in kernels if "int8_" in e.key]
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    line = {
        **fields, "device": device_line(),
        "step_ms_median": ms, "profiled_step_wall_ms": wall_ms,
        "kernel_ms_total": busy_ms if kernels else "not measured",
        "device_idle_share": (1 - busy_ms / wall_ms) if kernels else "not measured",
        "kernel_launches": sum(e.count for e in kernels),
        "int8_kernel_ms": sum(_device_time_us(e) for e in int8) / 1e3 if kernels
        else "not measured",
        "int8_kernel_launches": sum(e.count for e in int8),
        "top_kernels": [
            {"name": e.key[:90], "ms": _device_time_us(e) / 1e3, "count": e.count}
            for e in kernels[:12]
        ],
        # where the host's time goes: operators and CUDA runtime calls
        "top_host_ops": [
            {"name": e.key[:60], "self_cpu_ms": e.self_cpu_time_total / 1e3,
             "count": e.count}
            for e in host[:10]
        ],
    }
    emit(line)
    return line


def phase_serve_batched(model) -> dict:
    """The batched serving paths on the full-size model: the dense, paged
    and step configs under the same traffic, each row held against the
    port's direct generate(); then one decode step profiled."""
    import torch

    from polyaxon_tpu_torch.models.generate import generate

    waves = serve_traffic(model.cfg.vocab_size)
    prompts = [p for wave in waves for p in wave]
    t0 = time.perf_counter()
    reference = [
        generate(model, torch.tensor([p]), max_new_tokens=SERVE_NEW)[0].tolist()
        for p in prompts
    ]
    emit({"phase": "serve-batched-reference", "rows": len(prompts),
          "seconds": time.perf_counter() - t0})
    sampled, answers = {}, {}
    for name in SERVE_CONFIGS:
        out = run_serve_config(model, name, waves, reference)
        sampled[name], answers[name] = out["sampled"], out["answers"]
        del out
        gc.collect()
        torch.cuda.empty_cache()
    a, b = (sampled[n] for n in SAMPLED_ON)
    body = SAMPLED_BODY
    d = compare_rows(model, b, a, len(body["tokens"][0]),
                     sample=(body["temperature"], body["topK"], body["seed"]))
    emit({"phase": "serve-batched-sampled", "configs": list(SAMPLED_ON),
          "equal": a == b, "divergence": d})
    profile_decode_step(model)
    return {"waves": waves, "step": answers["step"], "sampled": sampled["dense"]}


def beam_requests(url: str, prompt: list) -> dict:
    """Two numBeams requests on the live server (the per-request path): one
    without eos, and one whose eos is a token the first beam emits; then
    numBeams 1, which is the greedy batched path."""
    plain = {"tokens": [prompt], "maxNewTokens": SERVE_NEW, "numBeams": BEAMS}
    first = _http(url + "/generate", plain)["tokens"][0]
    eos = first[len(prompt) + SERVE_NEW // 4]
    with_eos = {**plain, "eosId": eos, "lengthPenalty": 1.2}
    second = _http(url + "/generate", with_eos)["tokens"][0]
    one = _http(url + "/generate", {**plain, "numBeams": 1})["tokens"][0]
    return {"bodies": [plain, with_eos], "beams": [first, second], "one": one}


def check_beams(model, out: dict) -> dict:
    """Each beam response equals the port's direct beam_search of the same
    prompt on the card; numBeams 1 equals greedy (up to a bf16 near-tie)."""
    import torch

    from polyaxon_tpu_torch.models.generate import beam_search, generate

    t0 = time.perf_counter()
    for body, got in zip(out["bodies"], out["beams"]):
        direct = beam_search(
            model, torch.tensor(body["tokens"]), max_new_tokens=body["maxNewTokens"],
            num_beams=body["numBeams"], eos_id=body.get("eosId"),
            length_penalty=body.get("lengthPenalty", 1.0),
        )[0].tolist()
        check(got == direct, f"numBeams {body['numBeams']} (eos {body.get('eosId')}) "
              "differs from the direct beam_search")
    prompt = out["bodies"][0]["tokens"]
    greedy = generate(model, torch.tensor(prompt), max_new_tokens=SERVE_NEW)[0].tolist()
    d = compare_rows(model, out["one"], greedy, len(prompt[0]))
    line = {"phase": "serve-fast-beams", "num_beams": BEAMS, "prompt_len": len(prompt[0]),
            "new_tokens": SERVE_NEW, "eos_id": out["bodies"][1]["eosId"],
            "beams_equal_direct": True, "one_beam_divergence": d,
            "direct_seconds": time.perf_counter() - t0}
    emit(line)
    return line


def int8_pool_rows(qmodel, prompts: list, new: int = SERVE_NEW, samples=None,
                   kv_quant: str = "int8") -> tuple:
    """The int8 server's rows by the direct path: each prompt greedy through
    the int8 module on a paged pool of its own (int8, or the module's dtype
    with `kv_quant="none"`; one-shot prefill,
    then one step a token at B=1), so the quantize-on-write, the scale
    scatter, the page gather and the dequantize meet the served rows'
    chunked prefill, prefix-cache harvest and batched steps. `samples`
    gives per prompt None (greedy) or (temperature, top_k, seed): that
    row draws from the served rows' (seed, generation index) stream.
    Returns the rows and, per row, each generated token's top-2 gap over
    the top logit, with the row's noise where it samples (the near-tie
    rule reads them)."""
    import torch

    from polyaxon_tpu_torch.models.generate import _gumbel, _top_k_mask, make_paged_cache
    from polyaxon_tpu_torch.models.kv_pages import PagedKVLayout

    pt = SERVE_CONFIGS["step"]["kv_page_tokens"]
    n_pages = -(-(max(len(p) for p in prompts) + new) // pt)
    layout = PagedKVLayout(pt, 1 + n_pages, kv_quant=kv_quant)
    cache = make_paged_cache(qmodel, layout)  # each prompt overwrites its slots
    dev = qmodel.device
    table = torch.arange(1, 1 + n_pages, device=dev)[None]
    pad = torch.zeros(1, dtype=torch.long, device=dev)
    rows, gaps = [], []
    with torch.inference_mode():
        for i, p in enumerate(prompts):
            sample = None if samples is None else samples[i]
            x = torch.tensor([p], device=dev)
            row, gap = list(p), []
            for j in range(new):
                logits = qmodel(x, cache=cache, pad=pad, pages=table, pos=len(row) - x.shape[1],
                                kv_layout=layout)[0, -1].float()
                if sample is not None:
                    temperature, top_k, seed = sample
                    logits = _top_k_mask((logits / temperature)[None], top_k)[0]
                    logits = logits + _gumbel(logits.shape, seed, j, logits.device)
                top = torch.topk(logits, 2).values
                gap.append(float((top[0] - top[1]) / top[0].abs()))
                row.append(int(logits.argmax()))
                x = torch.tensor([[row[-1]]], device=dev)
            rows.append(row)
            gaps.append(gap)
    del cache
    return rows, gaps


def int8_teacher_forced(model, qmodel) -> dict:
    """One INT8_TF_TOKENS-token prompt through the bf16 module and its int8
    quantization (full-sequence forward, the same weights): the int8 argmax
    agrees with the bf16 argmax at >= INT8_AGREE of the positions whose bf16
    top-2 gap is >= NEAR_TIE of the top logit; the max row-relative logit
    error is printed."""
    import torch

    gen = torch.Generator().manual_seed(6)
    x = torch.randint(0, model.cfg.vocab_size, (1, INT8_TF_TOKENS), generator=gen).to(model.device)
    ref = model(x)[0].float()
    top = torch.topk(ref, 2, dim=-1).values
    confident = (top[:, 0] - top[:, 1]) >= NEAR_TIE * top[:, 0].abs()
    check(bool(confident.any()), "no position of the bf16 forward is past a near-tie")
    got = qmodel(x)[0].float()
    agree = (got.argmax(-1) == ref.argmax(-1))[confident].float().mean().item()
    rel = row_rel_err(got, ref)
    line = {"phase": "serve-fast-int8-tokens", "tokens": INT8_TF_TOKENS,
            "confident_positions": int(confident.sum()), "argmax_agree": agree,
            "agree_floor": INT8_AGREE, "max_row_rel_logit_err": rel,
            "argmax_agree_all": (got.argmax(-1) == ref.argmax(-1)).float().mean().item()}
    emit(line)
    check(agree >= INT8_AGREE, f"int8 argmax agrees with bf16 at {agree} of the confident "
          f"positions (floor {INT8_AGREE})")
    return line


def profile_fast_step(model, qmodel) -> None:
    """One decode step of the int8 module on the int8 pool and one verify
    window of K = 4 drafts (B x 5 tokens) of the bf16 module on the bf16
    pool, both at B=PROFILE_BATCH and frontier PROFILE_SLOTS, as
    profile_decode_step profiles the plain step."""
    import numpy as np
    import torch

    from polyaxon_tpu_torch.models.generate import make_paged_cache
    from polyaxon_tpu_torch.models.kv_pages import PagedKVLayout
    from polyaxon_tpu_torch.models.spec_decode import spec_verify_paged
    from polyaxon_tpu_torch.ops.int8_matmul import INT8_MATMUL

    B, S, dev = PROFILE_BATCH, PROFILE_SLOTS, model.device
    K = FAST_CONFIGS["spec"]["draft_tokens"]
    gen = torch.Generator().manual_seed(4)
    tok = torch.randint(0, model.cfg.vocab_size, (B, 1), generator=gen).to(dev)
    fed = torch.randint(0, model.cfg.vocab_size, (B, K + 1), generator=gen).numpy()
    pad = torch.zeros(B, dtype=torch.long, device=dev)
    pages = 1 + B * -(-(S + K) // 128)
    int8_layout = PagedKVLayout(128, pages, kv_quant="int8")
    layout = PagedKVLayout(128, pages)
    n_pages = layout.pages_for(S + K)
    tables = 1 + torch.arange(B * n_pages, device=dev).reshape(B, n_pages)
    int8_pool = make_paged_cache(qmodel, int8_layout)
    pool = make_paged_cache(model, layout)
    zeros = np.zeros(B, np.int64)
    steps = {
        "int8": lambda: qmodel(tok, cache=int8_pool, pos=S - 1, pad=pad, pages=tables,
                               kv_layout=int8_layout),
        "spec": lambda: spec_verify_paged(
            model, pool, fed, np.zeros(B, bool), zeros, tables.cpu().numpy(), zeros,
            np.full(B, S - 1), np.ones(B, np.int64), kv_layout=layout,
            temperature=0.0, top_k=None, eos_id=None),
    }
    # the int8 step's projections: one grouped q/k/v, o, one grouped
    # gate/up and down a layer; counted by the wrapper where it launches and
    # by the kernels themselves on the device (torch.profiler's trace can
    # drop events: launch_gate_probe, PERF.md)
    before, on_card = INT8_MATMUL.launches, INT8_MATMUL.device_launches()
    steps["int8"]()
    torch.cuda.synchronize()
    int8_launches = INT8_MATMUL.launches - before
    ran = INT8_MATMUL.device_launches() - on_card
    want = len(INT8_LAYER) * qmodel.cfg.n_layers
    check(int8_launches == want and ran == want,
          f"an int8 decode step launched int8_matmul {int8_launches} times and the card ran "
          f"{ran} of its kernels, not {want}")
    for name, fn in steps.items():
        on_card = INT8_MATMUL.device_launches()
        line = profile_step(fn, {
            "phase": "serve-fast-profile", "path": name, "batch": B,
            "window_tokens": 1 if name == "int8" else K + 1, "frontier": S,
            "window_slots": n_pages * layout.page_tokens,
            **({"int8_matmul_launches_a_step": int8_launches} if name == "int8" else {}),
        })
        if name == "int8":
            # profile_step ran the step 10 x 3 + 2 times timed, then once profiled
            ran = INT8_MATMUL.device_launches() - on_card
            runs = 10 * 3 + 2 + 1
            emit({"phase": "serve-fast-profile-launches", "device_int8_launches": ran,
                  "runs": runs, "profiler_int8_launches": line["int8_kernel_launches"]})
            check(ran == want * runs,
                  f"the card ran {ran} int8 kernels in {runs} int8 steps, not {want * runs}")
    del int8_pool, pool
    torch.cuda.empty_cache()


def phase_serve_fast(model, batched: dict) -> tuple:
    """The fast decode on the full-size model, each config under
    serve-batched's traffic on the step path: `spec` and `draft` rows held
    against the step config's rows (a divergence only at a bf16 near-tie of
    the reference path), their sampled row against dense's, proposals made;
    `int8` with the formula's pool bytes; all with no leaked page and a
    prefix hit, the stream equal to the non-streamed tokens. Beams on the
    spec server equal the direct beam_search. Then a decode step of each
    kind profiled. Returns the int8 module and its served rows, for
    check_int8_rows and the teacher-forced check (which run after the
    kernel counts of this path are read)."""
    import torch

    from polyaxon_tpu_torch.models.quant import decode_weight_bytes

    waves, step_rows = batched["waves"], batched["step"]
    prompts = [p for wave in waves for p in wave]
    qmodel, lines = None, {}
    beam_prompt = waves[0][4][:BEAM_PROMPT]
    for name, config in FAST_CONFIGS.items():
        out = run_serve_config(
            model, name, waves, None if config.get("quantize") else step_rows,
            config=config, phase="serve-fast",
            sampled=name == SAMPLED_FAST,
            pool_bytes=INT8_POOL_BYTES if config.get("kv_quant") == "int8"
            else SERVE_POOL_BYTES,
            extra=(lambda url: beam_requests(url, beam_prompt)) if name == "spec" else None,
        )
        spec = out["stats"]["speculation"]
        if config.get("speculate"):
            check(spec["proposed"] > 0, f"{name}: no draft was proposed: {spec}")
        if name == SAMPLED_FAST:
            body = SAMPLED_BODY
            d = compare_rows(model, out["sampled"], batched["sampled"],
                             len(body["tokens"][0]),
                             sample=(body["temperature"], body["topK"], body["seed"]))
            emit({"phase": "serve-fast-sampled", "config": name,
                  "equal_dense": out["sampled"] == batched["sampled"], "divergence": d})
            lines["beams"] = out["extra"]
        if config.get("quantize"):
            qmodel, int8_answers = out["server"].module, out["answers"]
            emit({"phase": "serve-fast-int8-weights", "device": device_line(),
                  "decode_weight_bytes_bf16": decode_weight_bytes(model),
                  "decode_weight_bytes_int8": decode_weight_bytes(qmodel),
                  "bytes_saved": out["stats"]["quant"]["bytes_saved"],
                  "kv_pool_bytes": out["stats"]["kv"]["kv_pool_bytes"],
                  "kv_pool_bytes_bf16": SERVE_POOL_BYTES,
                  "rows_equal_bf16_step": sum(
                      a == b for a, b in zip(out["answers"], step_rows)),
                  "rows": len(prompts)})
        if name == "draft":
            emit({"phase": "serve-fast-adaptive", "controller": spec.get("controller"),
                  "draft_model": spec["draft_model"]})
        del out
        gc.collect()
        torch.cuda.empty_cache()
    check_beams(model, lines["beams"])
    profile_fast_step(model, qmodel)
    return qmodel, int8_answers


# the int8 rows held against the direct path: every other row of each
# wave of 8 (2 behind the shared prefix, which the second wave's find in
# the prefix cache, and 2 without); all 16 took 40-49 s of the script
INT8_HELD = tuple(range(0, 16, 2))


def check_int8_rows(qmodel, waves: list, answers: list) -> None:
    """The int8 server's INT8_HELD rows held against the int8 module's own
    rows on a direct int8 pool (int8_pool_rows): equal, or diverging only
    at a near-tie of that reference path."""
    t0 = time.perf_counter()
    prompts = [p for wave in waves for p in wave]
    reference, gaps = int8_pool_rows(qmodel, [prompts[i] for i in INT8_HELD])
    divergences = []
    for j, i in enumerate(INT8_HELD):
        d = compare_rows(qmodel, answers[i], reference[j], len(prompts[i]), gaps=gaps[j])
        if d is not None:
            divergences.append({"row": i, **d})
    emit({"phase": "serve-fast-int8-rows", "config": "int8", "rows": list(INT8_HELD),
          "rows_diverged": len(divergences), "divergences": divergences,
          "seconds": time.perf_counter() - t0})


def mesh_feature_config(name: str):
    """The ServingConfig of serve-mesh's feature `name` (MESH_FEATURES)."""
    from polyaxon_tpu_torch.serving.batching import ServingConfig
    from polyaxon_tpu_torch.serving.tenancy import normalize_adapters, normalize_tenants

    extra = {}
    if name.startswith("tenants"):
        extra = {"adapters": normalize_adapters(MESH_ADAPTERS),
                 "tenants": normalize_tenants(MESH_TENANTS)}
    return ServingConfig(**SERVE_BASE, **MESH_FEATURES[name], **extra)


def mesh_feature_bodies(name: str, prompts: list, vocab: int, new: int) -> list:
    """The bodies serve-mesh drives feature `name` with: `prompts` (one for
    beams, their first rows for the tenants by MESH_TENANT_ORDER), or the
    spill traffic, each with `new` new tokens."""
    import torch

    if name == "beams":
        return [{"tokens": [prompts[1]], "maxNewTokens": new, "numBeams": 2}]
    if name.startswith("tenants"):
        return [{"tokens": [prompts[i % 2]], "maxNewTokens": new, "tenant": t}
                for i, t in enumerate(MESH_TENANT_ORDER)]
    if name == "spill":
        gen = torch.Generator().manual_seed(MESH_SPILL_SEED)
        pt = MESH_FEATURES["spill"]["kv_page_tokens"]
        target, *flood = [torch.randint(0, vocab, (6 * pt + 1,), generator=gen).tolist()
                          for _ in range(1 + MESH_SPILL_FLOOD)]
        return [{"tokens": [t], "maxNewTokens": new} for t in [target, *flood, target]]
    return [{"tokens": [p], "maxNewTokens": new} for p in prompts]


def drive_mesh_feature(model, server, name: str, bodies: list) -> dict:
    """Serve-mesh's drive of one feature on `server` (a mesh's or one
    device's): the rows, /statsz and what the feature adds — the demoted
    payloads of the spill tier (host tensors by chain head) and, for the
    handoff, the replicas' handoff blocks. The handoff runs `server` as the
    prefill replica beside a one-device decode replica of `model` behind
    the port's router."""
    from polyaxon_tpu_torch.serving.batching import ServingConfig
    from polyaxon_tpu_torch.serving.router import P2CBalancer, Router
    from polyaxon_tpu_torch.serving.server import ModelServer

    if name == "beams":  # inline, as the server runs beam search
        rows = [server.generate(b)["tokens"][0] for b in bodies]
        out = {"rows": rows, "stats": server.stats()}
        server.stop()
        return out
    demoted = {}
    if name == "spill":
        put = server._kv._spill.put

        def record(payload):
            demoted[payload.hashes[-1]] = [[t.clone() for t in page] for page in payload.pages]
            return put(payload)

        server._kv._spill.put = record
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    decode = router = None
    try:
        target = url
        if name == "handoff":
            decode = ModelServer(model, None, ServingConfig(
                **SERVE_BASE, **{**MESH_FEATURES[name], "role": "decode"}),
                model_name=PRESET, device=model.device)
            # no prefix affinity: the decode replica holding the adopted
            # shared prefix would take the next prompt without a handoff
            router = Router([url, f"http://127.0.0.1:{decode.start('127.0.0.1', 0)}"],
                            balancer=P2CBalancer(seed=7), poll_interval_s=0.1,
                            affinity=False)
            target = f"http://127.0.0.1:{router.start('127.0.0.1', 0)}"
            deadline = time.perf_counter() + 60
            while time.perf_counter() < deadline:
                router.poll_once()
                reps = router.stats()["replicas"]
                if len(reps) == 2 and all(r["healthy"] for r in reps):
                    break
                time.sleep(0.05)
        t0 = time.perf_counter()
        rows = [_http(target + "/generate", b)["tokens"][0] for b in bodies]
        wall = time.perf_counter() - t0
        out = {"rows": rows, "wall_seconds": wall, "stats": _http(url + "/statsz"),
               "demoted": demoted}
        if decode is not None:
            out["handoff"] = {"prefill": out["stats"]["handoff"],
                              "decode": decode.stats()["handoff"]}
        return out
    finally:
        if router is not None:
            router.stop()
        if decode is not None:
            decode.stop()
        server.stop()


def adapter_gap(module, source: str, tokens: list) -> float:
    """The one-device int8 path's top-2 gap over its top logit after
    `tokens`, with the adapter of `source` in slot 0 of the slot-stacked
    module (restored after), as tenant_references reads it."""
    import torch

    from polyaxon_tpu_torch.serving.adapters import adapter_template, ref_path, synth_adapter

    template = adapter_template(module)
    leaves = {ref_path(n): p for n, p in module.named_parameters() if ref_path(n) in template}
    values = synth_adapter(template, int(source[len("seed:"):]))
    with torch.inference_mode():
        saved = {p: t[0].clone() for p, t in leaves.items()}
        for p, t in leaves.items():
            t[0].copy_(values[p].to(t.device, t.dtype))
        try:
            return top2_gap(_one_shot_logits(module, tokens, int8=True))
        finally:
            for p, t in leaves.items():
                t[0].copy_(saved[p])


def mesh_b_rank(rank: int, port: int, spec_path: str, out_path: str) -> int:
    """One process of serve-mesh (b): rank `rank` of a two-rank `gloo`
    world on the one card, `{model: 2}`. Each rank builds the bf16 preset
    (seed 0) and serves the int8 then the step config on the mesh, then
    MESH_B_FEATURES (the tenants on the preset with rank-16 LoRA); rank 0
    posts the spec's prompts one at a time over HTTP, the other follows.
    Writes its rows (rank 0), its int8 launches and decode forwards, its
    weight and pool bytes, and (rank 0) the step ms, TTFT and the share of
    the forwards' host time spent inside collectives."""
    import torch
    import torch.distributed as dist

    from polyaxon_tpu_torch.models import build_model
    from polyaxon_tpu_torch.ops.int8_matmul import INT8_MATMUL
    from polyaxon_tpu_torch.parallel.mesh import decode_mesh
    from polyaxon_tpu_torch.serving.batching import ServingConfig
    from polyaxon_tpu_torch.serving.mesh import MeshModule
    from polyaxon_tpu_torch.serving.server import ModelServer

    with open(spec_path) as f:
        spec = json.load(f)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    timed = {"collective_s": 0.0, "forward_s": 0.0}

    def timing(fn, key):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                timed[key] += time.perf_counter() - t0
        return wrapped

    dist.all_reduce = timing(dist.all_reduce, "collective_s")
    dist.all_gather = timing(dist.all_gather, "collective_s")
    MeshModule.__call__ = timing(MeshModule.__call__, "forward_s")
    out = {"rank": rank, "configs": {}}
    with torch.inference_mode():
        model = build_model("transformer_lm", {"preset": PRESET}, device="cuda",
                            dtype=torch.bfloat16, seed=0).module.eval()
        mesh = decode_mesh({"model": 2})
        for name in ("int8", "step"):
            INT8_MATMUL.launches = 0
            timed.update(collective_s=0.0, forward_s=0.0)
            server = ModelServer(model, None, ServingConfig(**SERVE_BASE, **MESH_CONFIGS[name]),
                                 model_name=PRESET, device="cuda", mesh=mesh)
            row = {"weight_bytes": server.mesh_shard_bytes}
            if server.is_follower:
                server.follow()
                w = server._world
                row["pool_bytes"] = sum(t.numel() * t.element_size()
                                        for c in w.caches.values() for layer in c for t in layer)
            else:
                url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
                try:
                    row["rows"] = [_http(url + "/generate", {"tokens": [p], "maxNewTokens":
                                                             spec["new"]})["tokens"][0]
                                   for p in spec["prompts"]]
                    stats = _http(url + "/statsz")
                finally:
                    server.stop()
                w = server._world
                row.update(pool_bytes=stats["kv"]["kv_pool_bytes_per_rank"],
                           ttft_ms_p50=stats["ttft_ms"]["p50"],
                           decode_step_ms_p50=stats["decode_step_ms"]["p50"],
                           collective_s=timed["collective_s"], forward_s=timed["forward_s"],
                           collective_share=timed["collective_s"] / timed["forward_s"])
            row.update(forwards=w.ops.get("forward", 0), int8_launches=INT8_MATMUL.launches)
            out["configs"][name] = row
            del server
            gc.collect()
        # the features of (b): speculation (on a model of its own: the step
        # config's holds its shards), and the tenants on a LoRA model
        for name in MESH_B_FEATURES:
            INT8_MATMUL.launches = 0
            base = build_model(
                "transformer_lm", {"preset": PRESET, **(
                    {"lora_rank": TENANT_RANK} if name.startswith("tenants") else {})},
                device="cuda", dtype=torch.bfloat16, seed=0).module.eval()
            bodies = mesh_feature_bodies(name, spec["prompts"], base.cfg.vocab_size,
                                         spec["new"])[:MESH_B_PROMPTS]
            server = ModelServer(base, None, mesh_feature_config(name), model_name=PRESET,
                                 device="cuda", mesh=mesh)
            row = {}
            if server.is_follower:
                row["commands"] = server.follow()
            else:
                url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
                try:
                    row["rows"] = [_http(url + "/generate", b)["tokens"][0] for b in bodies]
                    stats = _http(url + "/statsz")
                finally:
                    server.stop()
                row.update(commands=server._world.commands,
                           accept_rate=stats["speculation"]["accept_rate"],
                           ttft_ms_p50=stats["ttft_ms"]["p50"],
                           decode_step_ms_p50=stats["decode_step_ms"]["p50"])
            w = server._world
            row.update(ops=dict(w.ops), forwards=w.ops.get("forward", 0),
                       int8_launches=INT8_MATMUL.launches)
            out["configs"][name] = row
            del server, base
            gc.collect()
    with open(out_path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def start_mesh_b(prompts: list) -> dict:
    """serve-mesh (b)'s two processes (`mesh_b_rank`), started now; their
    start-up overlaps (a)."""
    from polyaxon_tpu_torch.native import free_port

    d = ARTIFACTS / "serve_mesh"
    d.mkdir(parents=True, exist_ok=True)
    spec = d / "spec.json"
    spec.write_text(json.dumps({"prompts": prompts, "new": MESH_B_NEW}))
    port = free_port()
    procs = []
    for rank in range(2):
        out = d / f"rank{rank}.json"
        out.unlink(missing_ok=True)
        log = open(d / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--serve-mesh-rank", str(rank),
             "--serve-mesh-port", str(port), "--serve-mesh-spec", str(spec),
             "--serve-mesh-out", str(out)],
            stdout=log, stderr=subprocess.STDOUT, cwd=str(HERE)), log, out))
    return {"procs": procs, "t0": time.perf_counter()}


def finish_mesh_b(started: dict) -> list:
    """Wait for (b)'s processes for what is left of MESH_B_TIMEOUT_S; their
    results by rank. A failed or late rank fails the phase with its log's
    tail (phase_serve_mesh ends what is still running)."""
    results = []
    for rank, (proc, log, out) in enumerate(started["procs"]):
        left = MESH_B_TIMEOUT_S - (time.perf_counter() - started["t0"])
        try:
            code = proc.wait(timeout=max(1.0, left))
        except subprocess.TimeoutExpired:
            code = "timeout"
        if code != 0:
            check(False, f"serve-mesh (b) rank {rank} exited {code}:\n"
                  f"{Path(log.name).read_text()[-3000:]}")
        results.append(json.loads(out.read_text()))
    return results


def phase_serve_mesh(model, batched: dict, int8_rows: list, kernels) -> dict:
    """serve-mesh (see MESH_PROMPTS): (a) on one `nccl` rank in this
    process, (b) in two more. The kernel counters are set to 0 just before
    each mesh server's drive and read just after; (a)'s int8 launches must
    be 64 a forward (16 layers x q/k/v, o, gate/up, down) and the mesh's
    forward commands the prefill chunks plus decode steps it ran; each
    rank of (b) launches 64 a forward too. Returns the counts of (a)."""
    t_phase = time.perf_counter()
    wave = batched["waves"][0]
    prompts = [wave[i] for i in MESH_PROMPTS]
    started = start_mesh_b(prompts[:MESH_B_PROMPTS])
    try:
        return _serve_mesh_parts(model, batched, int8_rows, kernels, prompts, started,
                                 t_phase)
    finally:
        for proc, log, _ in started["procs"]:  # (b) ends with the phase, whatever happened
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def _serve_mesh_parts(model, batched, int8_rows, kernels, prompts, started, t_phase):
    """phase_serve_mesh's (a), then (b)'s results once its processes end."""
    import torch

    from polyaxon_tpu_torch.parallel.mesh import decode_mesh
    from polyaxon_tpu_torch.serving.batching import ServingConfig
    from polyaxon_tpu_torch.serving.server import ModelServer

    per_forward = len(INT8_LAYER) * model.cfg.n_layers
    served = {"step": [batched["step"][i] for i in MESH_PROMPTS],
              "int8": [int8_rows[i] for i in MESH_PROMPTS]}
    served = {name: [None if r is None else r[:len(p) + MESH_NEW]
                     for r, p in zip(rows, prompts)] for name, rows in served.items()}
    launches = {k.name: 0 for k in kernels}
    plain, one_device = {}, {}

    def drive(server):
        url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
        try:
            t0 = time.perf_counter()
            rows = [_http(url + "/generate", {"tokens": [p], "maxNewTokens": MESH_NEW})
                    ["tokens"][0] for p in prompts]
            return rows, time.perf_counter() - t0, _http(url + "/statsz")
        finally:
            server.stop()

    one_rank_group()
    try:
        for name, config in MESH_CONFIGS.items():
            cfg = ServingConfig(**SERVE_BASE, **config)
            alone = ModelServer(model, None, cfg, model_name=PRESET, device=model.device)
            plain[name], _, alone_stats = drive(alone)
            one_device[name] = alone.module  # the int8 module: (b)'s reference path
            del alone
            server = ModelServer(model, None, cfg, model_name=PRESET, device=model.device,
                                 mesh=decode_mesh({"batch": 1, "model": 1}))
            for k in kernels:  # the mesh's path starts here
                k.launches = 0
            rows, wall, stats = drive(server)
            counts = {k.name: k.launches for k in kernels}  # ... and ends here
            for k, n in counts.items():
                launches[k] += n
            w = server._world
            forwards = w.ops.get("forward", 0)
            chunks = int(server._m_prefill_chunks.value)
            steps = server._m_decode_step.summary()["count"]
            check(rows == plain[name], f"serve-mesh (a) {name}: the one-rank mesh's rows "
                  "differ from the one-device server's")
            check(forwards == chunks + steps and forwards > 0,
                  f"serve-mesh (a) {name}: {forwards} forward commands for {chunks} prefill "
                  f"chunks and {steps} decode steps")
            check(w.logit_gathers == steps + len(prompts),
                  f"serve-mesh (a) {name}: {w.logit_gathers} logit gathers, not "
                  f"{steps} steps + {len(prompts)} final chunks")
            want = per_forward * forwards if config.get("quantize") else 0
            check(counts["int8_matmul"] == want,
                  f"serve-mesh (a) {name}: {counts['int8_matmul']} int8 launches for "
                  f"{forwards} forwards, not {want}")
            # serve-batched's / serve-fast's rows of these prompts came out of
            # concurrent waves, whose steps group rows by arrival order
            # (their own gate held them to the near-tie rule): where they
            # part from the one-device order's rows is reported, not gated
            parted = [next((j - len(p) for j, (a, b) in enumerate(zip(row, ref)) if a != b),
                           None) for p, row, ref in zip(prompts, rows, served[name])
                      if ref is not None]
            emit({"phase": "serve-mesh", "part": "a", "config": name, "device": device_line(),
                  "mesh": stats["mesh"], "rows": len(rows), "equal_one_device": True,
                  "rows_equal_served": parted.count(None),
                  "served_parts_at": [j for j in parted if j is not None],
                  "commands": w.commands, "ops": w.ops, "logit_gathers": w.logit_gathers,
                  "int8_launches_a_forward": counts["int8_matmul"] / forwards,
                  "wall_seconds": wall, "ttft_ms_p50": stats["ttft_ms"]["p50"],
                  "decode_step_ms_p50": stats["decode_step_ms"]["p50"],
                  "one_device_decode_step_ms_p50": alone_stats["decode_step_ms"]["p50"],
                  "one_device_ttft_ms_p50": alone_stats["ttft_ms"]["p50"],
                  "weight_bytes": server.mesh_shard_bytes,
                  "pool_bytes": stats["kv"]["kv_pool_bytes_per_rank"]})
            del server
            gc.collect()
            torch.cuda.empty_cache()
        feature_refs = _serve_mesh_features(model, kernels, prompts, launches)
    finally:
        leave_group()
    # (b): the two processes' rows against (a)'s one-device rows
    ranks = finish_mesh_b(started)
    for name in ("int8", "step"):
        rows0 = ranks[0]["configs"][name]
        divergences = []
        for i, row in enumerate(rows0["rows"]):
            d = compare_rows(one_device[name], row,
                             plain[name][i][:len(prompts[i]) + MESH_B_NEW], len(prompts[i]))
            if d is not None:
                divergences.append({"row": i, **d})
        for r in ranks:
            c = r["configs"][name]
            want = per_forward * c["forwards"] if name == "int8" else 0
            check(c["forwards"] > 0 and c["int8_launches"] == want,
                  f"serve-mesh (b) {name}: rank {r['rank']} launched int8_matmul "
                  f"{c['int8_launches']} times for {c['forwards']} forwards, not {want}")
        check(ranks[1]["configs"][name]["forwards"] == rows0["forwards"],
              f"serve-mesh (b) {name}: the follower ran another count of forwards")
        emit({"phase": "serve-mesh", "part": "b", "config": name, "device": device_line(),
              "mesh": {"model": 2}, "backend": "gloo", "rows": len(rows0["rows"]),
              "rows_diverged": len(divergences), "divergences": divergences,
              "decode_step_ms_p50": rows0["decode_step_ms_p50"],
              "ttft_ms_p50": rows0["ttft_ms_p50"],
              "collective_share": rows0["collective_share"],
              "forwards": rows0["forwards"],
              "int8_launches_a_forward": [r["configs"][name]["int8_launches"]
                                          / r["configs"][name]["forwards"] for r in ranks],
              "weight_bytes": [r["configs"][name]["weight_bytes"] for r in ranks],
              "pool_bytes": [r["configs"][name]["pool_bytes"] for r in ranks]})
    for name in MESH_B_FEATURES:
        ref = feature_refs[name]
        rows0 = ranks[0]["configs"][name]
        divergences = []
        for i, (row, want, body) in enumerate(zip(rows0["rows"], ref["rows"], ref["bodies"])):
            plen = len(body["tokens"][0])
            want = want[:plen + MESH_B_NEW]
            if name.startswith("tenants"):
                if row == want:
                    continue
                j = next(k for k, (a, b) in enumerate(zip(row, want)) if a != b)
                check(j >= plen, f"serve-mesh (b) {name}: a response changed its prompt")
                source = MESH_ADAPTERS[{t["name"]: t["adapter"] for t in MESH_TENANTS}
                                       [body["tenant"]]]
                gap = adapter_gap(ref["module"], source, want[:j])
                check(gap < TENANT_NEAR_TIE, f"serve-mesh (b) {name}: divergence at "
                      f"generated token {j - plen} with top-2 gap {gap}: not a near-tie")
                divergences.append({"row": i, "position": j - plen, "gap": gap})
            else:
                d = compare_rows(model, row, want, plen)
                if d is not None:
                    divergences.append({"row": i, **d})
        per_forward_b = per_forward if "int8" in name else 0
        for r in ranks:
            c = r["configs"][name]
            check(c["forwards"] > 0 and c["int8_launches"] == per_forward_b * c["forwards"],
                  f"serve-mesh (b) {name}: rank {r['rank']} launched int8_matmul "
                  f"{c['int8_launches']} times for {c['forwards']} forwards")
        check(ranks[1]["configs"][name]["commands"] == rows0["commands"],
              f"serve-mesh (b) {name}: the follower ran another count of commands")
        emit({"phase": "serve-mesh", "part": "b", "config": name, "device": device_line(),
              "mesh": {"model": 2}, "backend": "gloo", "rows": len(rows0["rows"]),
              "rows_diverged": len(divergences), "divergences": divergences,
              "near_tie": TENANT_NEAR_TIE if name.startswith("tenants") else NEAR_TIE,
              "ops": rows0["ops"], "forwards": rows0["forwards"],
              "accept_rate": rows0.get("accept_rate"),
              "decode_step_ms_p50": rows0["decode_step_ms_p50"],
              "ttft_ms_p50": rows0["ttft_ms_p50"]})
    emit({"phase": "serve-mesh-wall", "seconds": time.perf_counter() - t_phase})
    del one_device, feature_refs
    return launches


def _serve_mesh_features(model, kernels, prompts, launches) -> dict:
    """serve-mesh (a)'s features (MESH_FEATURES) on the one-rank mesh, each
    beside a one-device server of its config; adds the mesh drives' kernel
    counts to `launches`. Returns, for (b), MESH_B_FEATURES' bodies,
    one-device rows and (for the tenants) the one-device module."""
    import torch

    from polyaxon_tpu_torch.models import build_model
    from polyaxon_tpu_torch.ops.int8_matmul import INT8_MATMUL
    from polyaxon_tpu_torch.parallel.mesh import decode_mesh
    from polyaxon_tpu_torch.serving.server import ModelServer

    per_layer = len(INT8_LAYER)
    lmodel = build_model("transformer_lm", {"preset": PRESET, "attention": "flash",
                                            "lora_rank": TENANT_RANK},
                         device="cuda", dtype=torch.bfloat16, seed=0).module.eval()
    refs = {}
    for name in MESH_FEATURES:
        base = lmodel if name.startswith("tenants") else model
        bodies = mesh_feature_bodies(name, prompts[:MESH_FEATURE_PROMPTS],
                                     model.cfg.vocab_size, MESH_FEATURE_NEW)
        alone = ModelServer(base, None, mesh_feature_config(name), model_name=PRESET,
                            device=model.device)
        ref = drive_mesh_feature(model, alone, name, bodies)
        if name in MESH_B_FEATURES:
            refs[name] = {"bodies": bodies, "rows": ref["rows"], "module": alone.module}
        del alone
        server = ModelServer(base, None, mesh_feature_config(name), model_name=PRESET,
                             device=model.device, mesh=decode_mesh({"batch": 1, "model": 1}))
        torch.cuda.synchronize()
        on_card = INT8_MATMUL.device_launches()
        for k in kernels:  # the mesh's path starts here
            k.launches = 0
        got = drive_mesh_feature(model, server, name, bodies)
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in kernels}  # ... and ends here
        ran = INT8_MATMUL.device_launches() - on_card
        for k, n in counts.items():
            launches[k] += n
        ops = dict(server._world.ops)
        check(got["rows"] == ref["rows"], f"serve-mesh (a) {name}: the one-rank mesh's rows "
              "differ from the one-device server's")
        forwards, drafts = ops.get("forward", 0), ops.get("draft_forward", 0)
        want = 0
        if MESH_FEATURES[name].get("quantize"):
            draft_layers = dict(MESH_FEATURES[name].get("draft_model") or ()).get("n_layers", 0)
            want = per_layer * (model.cfg.n_layers * forwards + draft_layers * drafts)
        check(forwards > 0 and counts["int8_matmul"] == want and ran == want,
              f"serve-mesh (a) {name}: int8_matmul launched {counts['int8_matmul']} times "
              f"and the card ran {ran} of its kernels for {forwards} forwards and {drafts} "
              f"draft forwards, not {want}")
        stats, one_stats = got["stats"], ref["stats"]
        line = {"phase": "serve-mesh", "part": "a", "config": name, "device": device_line(),
                "rows": len(got["rows"]), "equal_one_device": True, "ops": ops,
                "commands": sum(ops.values()), "forwards": forwards, "draft_forwards": drafts,
                "int8_launches": counts["int8_matmul"], "device_int8_launches": ran,
                "accept_rate": stats["speculation"]["accept_rate"],
                "decode_step_ms_p50": stats["decode_step_ms"]["p50"],
                "one_device_decode_step_ms_p50": one_stats["decode_step_ms"]["p50"],
                "wall_seconds": got.get("wall_seconds")}
        if name == "beams":
            check(ops.get("reorder", 0) > 0, "serve-mesh (a) beams: no cache reorder ran")
        if name.startswith("tenants"):
            ad = stats["tenancy"]["adapters"]
            check(ad["evictions"] >= 2 and ad["restores"] >= 1,
                  f"serve-mesh (a) {name}: {ad['evictions']} evictions, {ad['restores']} "
                  "restores of an adapter, not 2 and 1")
            line.update(adapter_evictions=ad["evictions"], adapter_restores=ad["restores"])
        if name == "spill":
            spill = stats["kv"]["spill"]
            check(spill["restores"] >= 1, "serve-mesh (a) spill: the prefix never came back")
            check(got["demoted"].keys() == ref["demoted"].keys() and all(
                torch.equal(a, b) for h in got["demoted"]
                for pa, pb in zip(got["demoted"][h], ref["demoted"][h]) for a, b in zip(pa, pb)),
                "serve-mesh (a) spill: the demoted pages differ from one device's")
            line.update(spill_bytes=spill["spilled_bytes"], spill_restores=spill["restores"],
                        demoted_entries=len(got["demoted"]), demoted_equal_one_device=True)
        if name == "handoff":
            for tag, out in (("mesh", got), ("one device", ref)):
                h = out["handoff"]
                check(h["prefill"]["exports"] == len(bodies) and h["prefill"]["fallbacks"] == 0
                      and h["decode"]["imports"] == len(bodies),
                      f"serve-mesh (a) handoff ({tag} prefill): {h}")
            line.update(handoff_bytes=got["handoff"]["prefill"]["bytes"],
                        handoff_exports=got["handoff"]["prefill"]["exports"])
        emit(line)
        del server
        gc.collect()
        torch.cuda.empty_cache()
    del lmodel
    return refs


def lora_card_case(base: str, dt: str, shape: str, M: tuple, ix: list,
                   device: str = "cuda") -> dict:
    """One projection of the tenants model with slot-stacked adapters on
    the card: its output against the merged-adapter dense product of each
    row (W + (alpha/r) A_b B_b, in f32 from the same parameters), held per
    row (max |err| of a row over the row's max |ref|)."""
    import torch

    from polyaxon_tpu_torch.models.quant import Int8LoRALinear, quantize_kernel
    from polyaxon_tpu_torch.models.transformer import LoRADense

    dtype = getattr(torch, dt)
    K, N = INT8_SHAPES[shape]
    B, S = M
    gen = torch.Generator(device=device).manual_seed(11)
    w = torch.randn(N, K, generator=gen, device=device) * K ** -0.5
    a = torch.randn(TENANT_SLOTS + 1, K, TENANT_RANK, generator=gen, device=device) * 0.05
    b = torch.randn(TENANT_SLOTS + 1, TENANT_RANK, N, generator=gen, device=device) * 0.05
    x = torch.randn(B, S, K, generator=gen, device=device).to(dtype)
    cls = LoRADense if base == "fp" else Int8LoRALinear
    mod = cls(K, N, TENANT_RANK, 16.0, slots=TENANT_SLOTS + 1, device=device, dtype=dtype)
    with torch.inference_mode():
        if base == "fp":
            mod.weight.copy_(w)
            dense = mod.weight.float()
        else:
            wq, scale = quantize_kernel(w)
            mod.weight.copy_(wq)
            mod.scale.copy_(scale)
            dense = mod.weight.float() * mod.scale[:, None]
        mod.lora_a.copy_(a)
        mod.lora_b.copy_(b)
        ixt = torch.tensor(ix, device=device)
        out = mod(x, ixt).float()
        ref = torch.stack([
            x[r].float() @ (dense.T + (16.0 / TENANT_RANK)
                            * (mod.lora_a[i].float() @ mod.lora_b[i].float()))
            for r, i in enumerate(ix)
        ])
    err = row_rel_err(out, ref)
    return {"base": base, "dtype": dt, "shape": shape, "B": B, "S": S,
            "max_row_rel_err": err, "tol": TENANT_LORA_TOL[dt]}


def phase_lora_card(device: str = "cuda") -> None:
    """The plain pieces the tenants path adds, on the card, before the
    path's launches are counted: the per-row LoRA delta of slot-stacked
    adapters (index gather + two batched products) against the merged-
    adapter dense product per row, at decode (B=8) and a 256-row prefill
    chunk, bf16 and f32, on the bf16 base and on the int8 base (through
    int8_matmul); and on the int8 base, q/k/v and gate/up with per-row
    slots still one grouped int8_matmul launch each."""
    import torch

    from polyaxon_tpu_torch.models.quant import Int8LoRALinear, project
    from polyaxon_tpu_torch.ops.int8_matmul import INT8_MATMUL

    decode_ix = [0, 1, 2, 1, 2, 0, 2, 1]
    for base in ("fp", "int8"):
        for dt in ("bfloat16", "float32"):
            for shape in INT8_SHAPES:
                for M, ix in (((8, 1), decode_ix), ((1, 256), [2])):
                    line = lora_card_case(base, dt, shape, M, ix, device)
                    emit({"phase": "serve-tenants-lora", **line})
                    check(line["max_row_rel_err"] <= line["tol"],
                          f"slot-stacked LoRA {line} past its tolerance")
    gen = torch.Generator(device=device).manual_seed(12)
    for group, (K, Ns) in (("qkv", INT8_LAYER["qkv"]), ("gate_up", INT8_LAYER["gate_up"])):
        projs = []
        for n in Ns:
            p = Int8LoRALinear(K, n, TENANT_RANK, 16.0, slots=TENANT_SLOTS + 1, device=device,
                               dtype=torch.bfloat16)
            with torch.inference_mode():
                p.weight.copy_(torch.randint(-127, 128, (n, K), generator=gen, device=device))
                p.lora_a.normal_(0.0, 0.05, generator=gen)
                p.lora_b.normal_(0.0, 0.05, generator=gen)
            projs.append(p)
        x = torch.randn(8, 1, K, generator=gen, device=device).to(torch.bfloat16)
        ix = torch.tensor(decode_ix, device=device)
        with torch.inference_mode():
            before = INT8_MATMUL.launches
            grouped = project(x, tuple(projs), ix)
            torch.cuda.synchronize(device)
            launched = INT8_MATMUL.launches - before
            alone = [p(x, ix) for p in projs]
        err = max(row_rel_err(g.float(), a.float()) for g, a in zip(grouped, alone))
        emit({"phase": "serve-tenants-lora-group", "group": group, "int8_launches": launched,
              "max_row_rel_err_vs_members": err})
        check(launched == 1, f"{group} with per-row slots ran {launched} int8 launches, not 1")
        check(err <= TENANT_LORA_TOL["bfloat16"],
              f"{group}: the grouped launch sits {err} from its members' own launches")


def tenant_traffic(vocab: int) -> dict:
    """The serve-tenants traffic, from a seeded generator: wave 1 mixes two
    adapter tenants and the default tenant (acme's two rows behind the
    shared SERVE_PREFIX-token prefix; a sampled row each for globex and
    default); the burst sends TENANT_BURST rows at the capped tenant beside
    one default row; the flood (default, 4 new tokens) needs more pages
    than the pool has free, so the idle prefix entries are evicted to the
    spill tier; wave 2 brings acme back (its prefix and its adapter come
    back from the spill tiers) beside globex and default."""
    import torch

    gen = torch.Generator().manual_seed(TENANT_SEED)

    def toks(n):
        return torch.randint(0, vocab, (n,), generator=gen).tolist()

    def body(tenant, prompt, seed=None, new=TENANT_NEW):
        b = {"tokens": [prompt], "maxNewTokens": new}
        if tenant:
            b["tenant"] = tenant
        if seed is not None:
            b.update({"temperature": 0.8, "topK": 50, "seed": seed})
        return b

    prefix = toks(SERVE_PREFIX)
    return {
        "prefix": prefix,
        "wave1": [body("acme", prefix + toks(100)), body("acme", prefix + toks(120)),
                  body("globex", toks(90)), body("globex", toks(110), seed=5),
                  body(None, toks(100)), body(None, toks(80), seed=9)],
        "burst": [body("initech", toks(100 + i)) for i in range(TENANT_BURST)]
        + [body(None, toks(120))],
        "flood": [body(None, toks(2000), new=4) for _ in range(3)],
        "wave2": [body("acme", prefix + toks(150)), body("acme", toks(70)),
                  body("globex", toks(100)), body(None, toks(60))],
    }


def _instrument_kv(kv) -> dict:
    """Wrap the KV manager's spill points to record what the run does:
    every demoted payload by its chain head, the host ms of each mirror
    capture (a blocking device-to-host copy into pinned memory) and the
    pages it copied, and the ms of each restore — its host part at
    admission (take from RAM or disk, new pages, queue) and its device
    write (flush_restores, synchronized)."""
    import torch

    rec = {"demoted": {}, "mirror_ms": [], "mirror_pages": 0, "restore_host_ms": [],
           "restore_flush_ms": []}
    put, capture, restore, flush = (kv._spill.put, kv._capture_mirror,
                                    kv._maybe_restore, kv.flush_restores)

    def put_rec(payload):
        rec["demoted"][payload.hashes[-1]] = payload
        return put(payload)

    def capture_rec(new_ids):
        t0 = time.perf_counter()
        out = capture(new_ids)
        rec["mirror_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["mirror_pages"] += len(new_ids)
        return out

    def restore_rec(tokens, limit, namespace=""):
        before = kv.spill_restores
        t0 = time.perf_counter()
        restore(tokens, limit, namespace)
        if kv.spill_restores > before:
            rec["restore_host_ms"].append((time.perf_counter() - t0) * 1e3)

    def flush_rec():
        t0 = time.perf_counter()
        n = flush()
        if n:
            torch.cuda.synchronize()
            rec["restore_flush_ms"].append((time.perf_counter() - t0) * 1e3)
        return n

    kv._spill.put, kv._capture_mirror = put_rec, capture_rec
    kv._maybe_restore, kv.flush_restores = restore_rec, flush_rec
    return rec


def _instrument_registry(reg) -> dict:
    """Time each adapter materialization (a cold load from `seed:` or a
    restore from the adapter spill tier) by its kind."""
    rec = {"load_ms": [], "restore_ms": []}
    load = reg._load_into

    def load_rec(e, slot):
        before = reg.restores
        t0 = time.perf_counter()
        load(e, slot)
        kind = "restore_ms" if reg.restores > before else "load_ms"
        rec[kind].append((time.perf_counter() - t0) * 1e3)

    reg._load_into = load_rec
    return rec


def run_tenant_config(model, name: str, traffic: dict) -> dict:
    """One serve-tenants config under the traffic: wave 1, the burst (which
    must shed tenant_quota at the capped tenant alone), the flood (which
    must demote the shared prefix to the spill tier), wave 2 (which must
    restore it — the pages holding exactly the demoted bytes — and hit
    it). No page, reservation, adapter pin or tenant charge may remain
    after the drain. Returns the answered rows (wave 1, the admitted burst
    rows, wave 2), their bodies, the server's module and the numbers."""
    import shutil

    import torch

    from polyaxon_tpu_torch.models.kv_pages import page_hashes
    from polyaxon_tpu_torch.serving.batching import ServingConfig
    from polyaxon_tpu_torch.serving.server import ModelServer
    from polyaxon_tpu_torch.serving.tenancy import normalize_adapters, normalize_tenants

    config = TENANT_CONFIGS[name]
    spill_dir = Path(config["spill_dir"])
    shutil.rmtree(spill_dir, ignore_errors=True)
    gc.collect()  # the last config's server and pool
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = ModelServer(model, None, ServingConfig(
        **SERVE_BASE, **config, adapters=normalize_adapters(TENANT_ADAPTERS),
        tenants=normalize_tenants(TENANTS), adapter_slots=TENANT_SLOTS,
    ), model_name=PRESET, device=model.device)
    kv = server._kv
    kv_rec = _instrument_kv(kv)
    reg_rec = _instrument_registry(server._adapter_registry)
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    try:
        t0 = time.perf_counter()
        wave1 = [a["tokens"][0] for a in _post_all(url, traffic["wave1"])]
        wall = time.perf_counter() - t0
        burst = _post_all(url, traffic["burst"], codes=True)
        during = _http(url + "/statsz")
        _post_all(url, traffic["flood"])
        spilled = _http(url + "/statsz")["kv"]["spill"]
        t0 = time.perf_counter()
        wave2 = [a["tokens"][0] for a in _post_all(url, traffic["wave2"])]
        wall += time.perf_counter() - t0
        stats = _http(url + "/statsz")
        # the shared prefix came back from the spill tier into fresh pages:
        # they hold exactly the bytes that were demoted
        prefix = traffic["prefix"]  # acme's, in the namespace of its adapter
        head = page_hashes(prefix, kv.layout.page_tokens, kv.prefix.hash_fn, "a1")[-1]
        check(head in kv_rec["demoted"], f"{name}: the shared prefix was never demoted")
        with kv._lock:
            _, pages = kv.prefix.peek(prefix + [0], max_tokens=len(prefix), namespace="a1")
            restored = [[kv.cache[i][f][pid].cpu() for i, f in kv.leaves] for pid in pages]
        want = kv_rec["demoted"][head].pages
        check(len(restored) == len(want) == SERVE_PREFIX // kv.layout.page_tokens,
              f"{name}: {len(restored)} prefix pages resident after the restore, "
              f"{len(want)} demoted")
        check(all(torch.equal(a, b) for pa, pb in zip(restored, want)
                  for a, b in zip(pa, pb)),
              f"{name}: the restored prefix pages differ from the demoted bytes")
    finally:
        server.stop()
    after = server.stats()
    shutil.rmtree(spill_dir, ignore_errors=True)
    # the capped tenant's burst: tenant_quota at initech alone, the rest served
    initech = [c for (c, _), b in zip(burst, traffic["burst"]) if b.get("tenant") == "initech"]
    quota = [o.get("reason") for c, o in burst if c != 200]
    check(set(quota) == {"tenant_quota"} and initech.count(503) == len(quota) >= 1,
          f"{name}: the burst answered {[c for c, _ in burst]} ({quota})")
    check(burst[-1][0] == 200, f"{name}: the default row of the burst was refused")
    shed = during["tenancy"]["tenants"]
    check(shed["initech"]["shed"] == len(quota) and all(
        v["shed"] == 0 for t, v in shed.items() if t != "initech"),
        f"{name}: sheds by tenant {shed}")
    kv_after = after["kv"]
    check(kv_after["active_rows"] == 0 and kv_after["pages_reserved"] == 0
          and kv_after["pages_used"] == 1 + kv_after["prefix"]["held_pages"],
          f"{name}: pages leaked: {kv_after}")
    ten = after["tenancy"]
    check(all(a["refs"] == 0 for a in ten["adapters"]["adapters"].values()),
          f"{name}: an adapter slot is still pinned: {ten['adapters']}")
    check(all(t["outstanding"] == 0 and t["tokens"] == 0 for t in ten["tenants"].values()),
          f"{name}: a tenant is still charged: {ten['tenants']}")
    spill = stats["kv"]["spill"]
    check(spilled["spills"] >= 1, f"{name}: the flood demoted nothing: {spilled}")
    tier = "restored_disk" if not config["spill_ram_bytes"] else "restored_ram"
    check(spill["restores"] >= 1 and spill[tier] >= 1,
          f"{name}: the prefix was not restored from {tier}: {spill}")
    check(ten["adapters"]["restores"] >= 1 and ten["adapters"]["evictions"] >= 1,
          f"{name}: no adapter was evicted and restored: {ten['adapters']}")
    admitted = [o["tokens"][0] for (c, o), b in zip(burst, traffic["burst"]) if c == 200]
    bodies = traffic["wave1"] + [b for (c, _), b in zip(burst, traffic["burst"]) if c == 200] \
        + traffic["wave2"]
    generated = TENANT_NEW * (len(traffic["wave1"]) + len(traffic["wave2"]))
    adapter_load = server._m_adapter_load.summary()
    line = {
        "phase": "serve-tenants", "config": name, "device": device_line(),
        "requests": len(traffic["wave1"]) + len(traffic["burst"]) + len(traffic["flood"])
        + len(traffic["wave2"]), "new_tokens": TENANT_NEW,
        "waves_decode_tokens_per_s": generated / wall,
        "ttft_ms_p50": stats["ttft_ms"]["p50"], "ttft_ms_p95": stats["ttft_ms"]["p95"],
        "decode_step_ms_p50": stats["decode_step_ms"]["p50"],
        "burst_codes": [c for c, _ in burst], "tenant_quota_sheds": len(quota),
        "adapter_loads": ten["adapters"]["loads"], "adapter_restores": ten["adapters"]["restores"],
        "adapter_evictions": ten["adapters"]["evictions"],
        "adapter_load_ms_p50": adapter_load["p50"], "adapter_load_ms_max": adapter_load["max"],
        "adapter_cold_load_ms": reg_rec["load_ms"], "adapter_restore_ms": reg_rec["restore_ms"],
        "adapter_spill_bytes": ten["adapter_spill"]["spilled_bytes"],
        "kv_spills": spill["spills"], "kv_spill_bytes": spill["spilled_bytes"],
        "kv_restores": spill["restores"], "restored_ram": spill["restored_ram"],
        "restored_disk": spill["restored_disk"],
        "restore_host_ms": kv_rec["restore_host_ms"],
        "restore_flush_ms": kv_rec["restore_flush_ms"],
        "mirror_pages": kv_rec["mirror_pages"],
        "mirror_ms_per_page": (sum(kv_rec["mirror_ms"]) / kv_rec["mirror_pages"]
                               if kv_rec["mirror_pages"] else None),
        "page_bytes": sum(t.numel() * t.element_size() for t in want[0]),
        "prefix_hits": stats["kv"]["prefix"]["hits"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(line)
    return {"rows": wave1 + admitted + wave2, "bodies": bodies, "module": server.module,
            "line": line}


def _one_shot_logits(module, tokens: list, int8: bool):
    """The reference path's next-token logits after `tokens` (f32): one B=1
    prefill with no adapter_ix (slot 0) — through a dense cache on the bf16
    module, through a direct int8 pool on the int8 one (as
    int8_pool_rows's prefill)."""
    import torch

    from polyaxon_tpu_torch.models.generate import make_paged_cache
    from polyaxon_tpu_torch.models.kv_pages import PagedKVLayout

    dev = module.device
    x = torch.tensor([tokens], device=dev)
    if not int8:
        return module(x, cache=module.make_cache(1), pos=0)[0, -1].float()
    pt = SERVE_CONFIGS["step"]["kv_page_tokens"]
    n_pages = -(-len(tokens) // pt)
    layout = PagedKVLayout(pt, 1 + n_pages, kv_quant="int8")
    table = torch.arange(1, 1 + n_pages, device=dev)[None]
    return module(x, cache=make_paged_cache(module, layout), pad=torch.zeros(1, dtype=torch.long,
                  device=dev), pages=table, pos=0, kv_layout=layout)[0, -1].float()


def edge_flip(raw, got: int, ref: int, sample) -> bool:
    """Whether a top-k sampled row's divergence is a flip at the mask's
    edge: one of the two tokens lies within TENANT_EDGE_ULPS bf16 ulps of
    the k-th logit of `raw` (the reference's logits), and the sampler's pick
    on `raw` is one of the two tokens with that token in the mask and the
    other with it out — paths that round differently put it on either side."""
    import math

    import torch

    from polyaxon_tpu_torch.models.generate import _gumbel

    temperature, top_k, seed, g = sample
    kth = float(torch.topk(raw, top_k).values[-1])
    ulp = 2.0 ** (math.floor(math.log2(abs(kth))) - 7)
    picked = sampler_logits(raw, sample)
    noised = raw / temperature + _gumbel(raw.shape, seed, g, raw.device)
    for t in (got, ref):
        if abs(float(raw[t]) - kth) > TENANT_EDGE_ULPS * ulp:
            continue
        inside, outside = picked.clone(), picked.clone()
        inside[t], outside[t] = noised[t], float("-inf")
        if {int(torch.argmax(inside)), int(torch.argmax(outside))} == {got, ref}:
            return True
    return False


def tenant_references(module, bodies: list, rows: list, int8: bool) -> dict:
    """Each served row against its solo reference: the served slot-stacked
    module with the row's adapter (the tenant's, or the checkpoint's own for
    the default tenant) in slot 0 and no adapter_ix — generate() on the
    bf16 module, or the int8 module on a direct int8 pool (int8_pool_rows)
    for the int8 config. A row equals its reference or diverges where the
    reference's top-2 gap over its top logit (for a sampled row: of the
    logits its sampler compares) is under TENANT_NEAR_TIE — or, for a top-k
    sampled row, at the mask's edge (edge_flip)."""
    import torch

    from polyaxon_tpu_torch.models.generate import generate
    from polyaxon_tpu_torch.serving.adapters import adapter_template, ref_path, synth_adapter

    template = adapter_template(module)
    sources = dict(TENANT_ADAPTERS)
    by_tenant = {t["name"]: t["adapter"] for t in TENANTS}
    leaves = {ref_path(n): p for n, p in module.named_parameters() if ref_path(n) in template}
    saved = {p: t.detach().clone() for p, t in leaves.items()}
    groups: dict = {}
    for i, b in enumerate(bodies):
        groups.setdefault(by_tenant.get(b.get("tenant"), ""), []).append(i)
    divergences, equal = [], 0
    with torch.inference_mode():
        for adapter, idx in groups.items():
            values = (synth_adapter(template, int(sources[adapter][len("seed:"):]))
                      if adapter else {p: t[0] for p, t in saved.items()})
            for p, t in leaves.items():
                t[0].copy_(values[p].to(t.device, t.dtype))
            samples = [
                (bodies[i]["temperature"], bodies[i]["topK"], bodies[i]["seed"])
                if "temperature" in bodies[i] else None for i in idx
            ]
            prompts = [bodies[i]["tokens"][0] for i in idx]
            if int8:
                refs, _ = int8_pool_rows(module, prompts, new=TENANT_NEW, samples=samples)
            else:
                refs = [
                    generate(module, torch.tensor([p]), max_new_tokens=TENANT_NEW,
                             **({} if s is None else
                                {"temperature": s[0], "top_k": s[1], "seed": [s[2]]})
                             )[0].tolist()
                    for p, s in zip(prompts, samples)
                ]
            for k, i in enumerate(idx):
                got, ref, plen = rows[i], refs[k], len(prompts[k])
                if got == ref:
                    equal += 1
                    continue
                j = next(n for n, (a, b) in enumerate(zip(got, ref)) if a != b)
                check(j >= plen, f"row {i}: a response changed its prompt")
                raw = _one_shot_logits(module, ref[:j], int8)
                sample = None if samples[k] is None else (*samples[k], j - plen)
                gap = top2_gap(raw if sample is None else sampler_logits(raw, sample))
                edge = sample is not None and edge_flip(raw, got[j], ref[j], sample)
                divergences.append({
                    "row": i, "adapter": adapter or "base", "sampled": sample is not None,
                    "position": j - plen, "served": got[j], "reference": ref[j],
                    "gap_rel": gap, "top_k_edge_flip": edge,
                    "near_tie": gap < TENANT_NEAR_TIE or edge,
                })
        for p, t in leaves.items():
            t.copy_(saved[p])
    return {"rows": len(rows), "rows_equal": equal, "near_tie": TENANT_NEAR_TIE,
            "divergences": divergences}


def profile_tenant_step(lmodel, stacked: dict) -> dict:
    """One decode step at B=PROFILE_BATCH, frontier PROFILE_SLOTS, on the
    paged pool: the LoRA model with its one adapter, then the served
    slot-stacked modules with the rows on different slots (bf16 pool; the
    int8 module on the int8 pool, whose step must still launch int8_matmul
    4 times a layer). Emits each step's time, launches and device time
    (profile_step) and the launches the slots add."""
    import torch

    from polyaxon_tpu_torch.models.generate import make_paged_cache
    from polyaxon_tpu_torch.models.kv_pages import PagedKVLayout
    from polyaxon_tpu_torch.ops.int8_matmul import INT8_MATMUL

    B, S, dev = PROFILE_BATCH, PROFILE_SLOTS, lmodel.device
    gen = torch.Generator().manual_seed(4)
    tok = torch.randint(0, lmodel.cfg.vocab_size, (B, 1), generator=gen).to(dev)
    pad = torch.zeros(B, dtype=torch.long, device=dev)
    ix = torch.tensor([(b % (TENANT_SLOTS + 1)) for b in range(B)], device=dev)
    lines = {}
    for name, module, quant in (("lora", lmodel, "none"),
                                ("lora-slots", stacked["tenants"], "none"),
                                ("int8-slots", stacked["tenants-int8"], "int8")):
        layout = PagedKVLayout(128, 1 + B * -(-S // 128), kv_quant=quant)
        n_pages = layout.pages_for(S)
        tables = 1 + torch.arange(B * n_pages, device=dev).reshape(B, n_pages)
        pool = make_paged_cache(module, layout)
        kw = {} if name == "lora" else {"adapter_ix": ix}

        def step(module=module, pool=pool, tables=tables, layout=layout, kw=kw):
            return module(tok, cache=pool, pos=S - 1, pad=pad, pages=tables, kv_layout=layout,
                          **kw)

        fields = {"phase": "serve-tenants-profile", "path": name, "batch": B, "frontier": S,
                  "adapter_slots": None if name == "lora" else [int(i) for i in ix]}
        if quant == "int8":
            before = INT8_MATMUL.launches
            step()
            torch.cuda.synchronize()
            n = INT8_MATMUL.launches - before
            want = len(INT8_LAYER) * module.cfg.n_layers
            check(n == want, f"an int8 step with adapter slots launched int8_matmul {n} "
                  f"times, not {want}")
            fields["int8_matmul_launches_a_step"] = n
        lines[name] = profile_step(step, fields)
        del pool
        torch.cuda.empty_cache()
    added = lines["lora-slots"]["kernel_launches"] - lines["lora"]["kernel_launches"]
    emit({"phase": "serve-tenants-step", "device": device_line(),
          "step_ms_lora": lines["lora"]["step_ms_median"],
          "step_ms_lora_slots": lines["lora-slots"]["step_ms_median"],
          "step_ms_int8_slots": lines["int8-slots"]["step_ms_median"],
          "launches_lora": lines["lora"]["kernel_launches"],
          "launches_lora_slots": lines["lora-slots"]["kernel_launches"],
          "launches_added_by_slots": added})
    return lines


def phase_serve_tenants(lmodel) -> dict:
    """Multi-tenant serving on the full-width LoRA model, the path whose
    launches are counted: the step config on the tenants' LoRA model without
    tenants (the yardstick for decode tokens/s), then `tenants` and
    `tenants-int8` under tenant_traffic. Returns each config's
    run_tenant_config result by name, for check_tenant_rows and
    profile_tenant_step once the counts are read."""
    from polyaxon_tpu_torch.serving.batching import ServingConfig
    from polyaxon_tpu_torch.serving.server import ModelServer

    traffic = tenant_traffic(lmodel.cfg.vocab_size)
    # the yardstick: the same two waves, tenant-less, on the step config
    plain = [{k: v for k, v in b.items() if k != "tenant"}
             for b in traffic["wave1"] + traffic["wave2"]]
    server = ModelServer(lmodel, None, ServingConfig(**SERVE_BASE, **TENANT_STEP),
                         model_name=PRESET, device=lmodel.device)
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    try:
        t0 = time.perf_counter()
        _post_all(url, plain[:len(traffic["wave1"])])
        _post_all(url, plain[len(traffic["wave1"]):])
        wall = time.perf_counter() - t0
        stats = _http(url + "/statsz")
    finally:
        server.stop()
    emit({"phase": "serve-tenants", "config": "step-lora", "device": device_line(),
          "waves_decode_tokens_per_s": TENANT_NEW * len(plain) / wall,
          "ttft_ms_p50": stats["ttft_ms"]["p50"], "ttft_ms_p95": stats["ttft_ms"]["p95"],
          "decode_step_ms_p50": stats["decode_step_ms"]["p50"]})
    del server
    return {name: run_tenant_config(lmodel, name, traffic) for name in TENANT_CONFIGS}


def check_tenant_rows(served: dict) -> None:
    """Each config's served rows against their solo references
    (tenant_references): equal, or diverging only at a near-tie."""
    for name, out in served.items():
        t0 = time.perf_counter()
        ref = tenant_references(out["module"], out["bodies"], out["rows"],
                                int8=TENANT_CONFIGS[name].get("quantize", False))
        emit({"phase": "serve-tenants-rows", "config": name, **ref,
              "seconds": time.perf_counter() - t0})
        bad = [d for d in ref["divergences"] if not d["near_tie"]]
        check(not bad, f"{name}: rows diverge from their solo references past a near-tie: {bad}")


def fleet_traffic(vocab: int) -> list:
    """FLEET_REQUESTS bodies of FLEET_NEW new tokens, prompts of
    SERVE_PROMPT_LENS tokens from a seeded generator, each a dict with its
    `body` and `kind`: rows 0 and 4 behind one shared SERVE_PREFIX-token
    prefix, row 5 sampled, rows 2 and 6 also sent streamed, the last under
    the handoff fault."""
    import torch

    gen = torch.Generator().manual_seed(FLEET_SEED)

    def toks(n):
        return torch.randint(0, vocab, (n,), generator=gen).tolist()

    lo, hi = SERVE_PROMPT_LENS
    prefix = toks(SERVE_PREFIX)
    out = []
    for i in range(FLEET_REQUESTS):
        n = int(torch.randint(lo, hi + 1, (1,), generator=gen))
        prompt = prefix + toks(max(1, n - SERVE_PREFIX)) if i in (0, 4) else toks(n)
        body = {"tokens": [prompt], "maxNewTokens": FLEET_NEW}
        if i == 5:
            body.update(FLEET_SAMPLE)
        kind = ("fault" if i == FLEET_REQUESTS - 1 else "stream" if i in (2, 6)
                else "sampled" if i == 5 else "greedy")
        out.append({"body": body, "kind": kind})
    return out


def _sse_timed(url: str, body: dict, rid: str) -> dict:
    """POST /generate?stream=1 as request `rid`, reading each `data:` frame
    as it arrives: the row (the prompt and the streamed tokens), the
    client's TTFT (the send to the first frame with tokens, ms) and its
    decode seconds (that frame to the last frame with tokens)."""
    req = urllib.request.Request(
        url + "/generate?stream=1", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", "X-Request-Id": rid}, method="POST",
    )
    events, first, last = [], None, None
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        check(resp.status == 200, f"stream {rid} answered {resp.status}")
        for line in resp:
            if not line.startswith(b"data: "):
                continue
            events.append(json.loads(line[len(b"data: "):]))
            if events[-1].get("tokens"):
                last = time.perf_counter()
                first = last if first is None else first
    check(bool(events) and events[-1].get("done") is True, f"stream {rid} did not end with done")
    check(not any("error" in ev for ev in events), f"stream {rid} failed: {events}")
    check(first is not None, f"stream {rid} sent no token")
    return {"row": body["tokens"][0] + [x for ev in events if "tokens" in ev for x in ev["tokens"]],
            "ttft_ms": (first - t0) * 1e3, "decode_s": last - first}


def _fleet_drive(url: str, traffic: list, tag: str, fault=None) -> dict:
    """The traffic against one URL (the router or the direct replica), each
    request with the X-Request-Id `<tag>-<index>`: the non-fault bodies in
    waves of FLEET_WAVE concurrent requests — streamed and timed at the
    client (_sse_timed), but for the "stream" rows, which go whole here and
    again streamed one at a time after the waves (ids `<tag>-<index>-s`) —
    then the fault body alone, whole (under `fault`, a chaos plan, when
    given). Returns the rows by index, the streamed repeats, and the
    client's TTFT ms and decode seconds of each timed row."""
    import threading

    from polyaxon_tpu_torch.chaos import active

    idx = [i for i, t in enumerate(traffic) if t["kind"] != "fault"]
    rows, timed = {}, {}

    def one(i):
        body, rid = traffic[i]["body"], f"{tag}-{i}"
        try:
            if traffic[i]["kind"] == "stream":
                rows[i] = _http(url + "/generate", body, {"X-Request-Id": rid})["tokens"][0]
            else:
                timed[i] = _sse_timed(url, body, rid)
                rows[i] = timed[i]["row"]
        except BaseException as e:  # noqa: BLE001 — raised below
            rows[i] = e

    for w in range(0, len(idx), FLEET_WAVE):
        threads = [threading.Thread(target=one, args=(i,)) for i in idx[w:w + FLEET_WAVE]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        time.sleep(0.3)  # the router's poll sees the new /kvz heads
    for i in idx:
        check(isinstance(rows.get(i), list), f"{tag}: request {i} failed: {rows.get(i)!r}")
    streamed = {i: _sse_timed(url, t["body"], f"{tag}-{i}-s")["row"]
                for i, t in enumerate(traffic) if t["kind"] == "stream"}
    for i, t in enumerate(traffic):
        if t["kind"] == "fault":
            with active(fault) if fault is not None else contextlib.nullcontext():
                rows[i] = _http(url + "/generate", t["body"],
                                {"X-Request-Id": f"{tag}-{i}"})["tokens"][0]
    return {"rows": rows, "streamed": streamed,
            "ttft_ms": [timed[i]["ttft_ms"] for i in sorted(timed)],
            "decode_tokens_per_s": [(FLEET_NEW - 1) / timed[i]["decode_s"] for i in sorted(timed)]}


def fleet_handoffs(name: str, stitched: dict, traffic: list, page_tokens: int) -> list:
    """Each acknowledged handoff in the router's stitched traces (`stitched`:
    id -> (traffic index, /tracez payload)), read from that one trace: the
    prefill replica's (r0) kv_export and kv_handoff spans and the decode
    replica's (r1) kv_plan on the replay. The replay must be admitted on the
    adopted chain — a hit for the exported pages, capped as admission caps
    any hit, below the prompt's last token: a replay that re-prefilled the
    prompt answers the same tokens, so no other gate would see a broken
    adopt. Returns per handoff the pages, the capture and ship ms, the
    decode side's adopt host ms (which the import's answer carries back)
    and the wire ms, the ship less that adopt."""
    out = []
    for rid, (i, tz) in stitched.items():
        def spans(span, replica):
            return [s for s in tz["spans"]
                    if s["name"] == span and s["attrs"].get("replica") == replica]

        ship = spans("kv_handoff", "r0")
        if not ship:
            continue
        export, plan = spans("kv_export", "r0"), spans("kv_plan", "r1")
        check(len(ship) == len(export) == len(plan) == 1,
              f"{name}: {rid} holds {len(export)} exports, {len(ship)} ships, "
              f"{len(plan)} decode-side plans")
        plen = len(traffic[i]["body"]["tokens"][0])
        pages = export[0]["attrs"]["pages"]
        want = min(pages, (plen - 1) // page_tokens) * page_tokens
        hit = plan[0]["attrs"]
        check(hit["prefix_hit"] == (want > 0) and hit["prefix_len"] == want,
              f"{name}: {rid}'s replay was admitted with a {hit['prefix_len']}-token prefix "
              f"(hit {hit['prefix_hit']}), not on its {pages} adopted pages ({want} tokens)")
        ship_ms, adopt_ms = ship[0]["dur_s"] * 1e3, ship[0]["attrs"]["adopt_ms"]
        out.append({"id": rid, "row": i, "pages": pages, "prefix_len": hit["prefix_len"],
                    "capture_ms": export[0]["dur_s"] * 1e3, "ship_ms": ship_ms,
                    "adopt_host_ms": adopt_ms, "wire_ms": ship_ms - adopt_ms})
    return out


def phase_serve_fleet(model, name: str, kernels) -> dict:
    """One fleet config: the prefill and decode replicas behind the Router
    (ReplicaSetManager over InProcessReplicas), the direct replica beside
    them, the traffic through both; the fleet's gates on the handoff, the
    pools, the traces, /sloz, /queryz and the flight recorder. The kernel
    counts are set to 0 just before the routed drive and read just after,
    then again around the direct replica's drive. Returns the rows for
    check_fleet_rows (run after the kernel counts are read), both drives'
    launches, the direct replica's module (the near-tie reference) and,
    for each sampled row, that row re-sent to the direct replica with its
    prompt's pages warm in the direct replica's own prefix cache (the
    witness check_fleet_rows reports where a sampled row diverges)."""
    import shutil

    from polyaxon_tpu_torch.chaos import Fault, FaultPlan
    from polyaxon_tpu_torch.retry import RetryPolicy
    from polyaxon_tpu_torch.serving.batching import ServingConfig
    from polyaxon_tpu_torch.serving.replicas import InProcessReplica, ReplicaSetManager
    from polyaxon_tpu_torch.serving.router import P2CBalancer, Router
    from polyaxon_tpu_torch.serving.server import ModelServer
    from polyaxon_tpu_torch.telemetry.stats import summarize

    root = ARTIFACTS / "fleet" / name
    shutil.rmtree(root, ignore_errors=True)
    traffic = fleet_traffic(model.cfg.vocab_size)
    cfg = FLEET_CONFIGS[name]

    def replica(role):
        return ModelServer(
            model, None, ServingConfig(**SERVE_BASE, **cfg, role=role),
            model_name=PRESET, device=model.device, slos=FLEET_SLOS,
            history={"dir": str(root / f"history-{role}"), "interval_s": 0.5},
        )

    mgr = ReplicaSetManager(
        lambda i: InProcessReplica(lambda: replica(("prefill", "decode")[i])),
        replicas=2, retry=RetryPolicy(max_retries=1, backoff=0.5),
    )
    router = Router(mgr.endpoints, balancer=P2CBalancer(seed=FLEET_SEED),
                    poll_interval_s=0.1)
    mgr.attach_router(router)
    direct = ModelServer(
        model, None, ServingConfig(**SERVE_BASE, **cfg), model_name=PRESET,
        device=model.device, slos=[FLEET_BREACH_SLO], debug_dir=str(root / "debug"),
        slo_profile_s=FLEET_PROFILE_S,
    )
    rtag = f"{name}-routed"
    t_phase = time.perf_counter()
    try:
        mgr.start()
        rurl = f"http://127.0.0.1:{router.start('127.0.0.1', 0)}"
        router.poll_once()
        pre, dec = mgr.replica(0).server, mgr.replica(1).server
        purl, durl = mgr.endpoints()
        # the faulted request's import fails at its first hit
        fault = FaultPlan([Fault("serving.kv_import", "raise", at=0)], seed=FLEET_SEED)
        for kern in kernels:  # the routed fleet's path starts here
            kern.launches = 0
        routed = _fleet_drive(rurl, traffic, rtag, fault)
        routed_launches = {kern.name: kern.launches for kern in kernels}  # ... ends here
        check(fault.faults[0].fired == 1, "the handoff fault never fired")
        xurl = f"http://127.0.0.1:{direct.start('127.0.0.1', 0)}"
        # the breach SLO is evaluated here, not by its cadence: its
        # profile window must not slow the direct replica's traffic
        direct.slo_engine.stop()
        direct.slo_engine.evaluate()  # the breach objective's first sample
        for kern in kernels:  # the direct replica's drive starts here
            kern.launches = 0
        ref = _fleet_drive(xurl, traffic, f"{name}-direct")
        direct_launches = {kern.name: kern.launches for kern in kernels}  # ... ends here
        breach = direct.slo_engine.evaluate()
        check(breach[0]["breached"], f"the breach SLO did not breach: {breach}")
        # one request inside the profile window, so its steps are traced
        _http(xurl + "/generate", {"tokens": [traffic[0]["body"]["tokens"][0][:256]],
                                   "maxNewTokens": 8})
        direct.flight_recorder.wait_profiles(60)
        # the witness: each sampled row sent to the direct replica twice,
        # the second time on its own harvested pages — the prefix hit
        # splits the prompt's prefill at its last full page, as the decode
        # replica's replay after a handoff does
        warm = {}
        for i, t in enumerate(traffic):
            if t["kind"] == "sampled":
                for k in range(2):
                    rid = f"{name}-warm-{i}-{k}"
                    row = _http(xurl + "/generate", t["body"], {"X-Request-Id": rid})["tokens"][0]
                plan = [s["attrs"] for s in direct.traces.get(rid)["spans"]
                        if s["name"] == "kv_plan"]
                warm[i] = {"row": row, "prefix_len": plan[0]["prefix_len"]}
        # the router's view of every request, stitched across replicas
        stitched = {}
        for i, t in enumerate(traffic):
            for rid in [f"{rtag}-{i}"] + ([f"{rtag}-{i}-s"] if t["kind"] == "stream" else []):
                stitched[rid] = (i, _http(rurl + "/tracez?id=" + rid))
        sloz = {u: _http(u + "/sloz") for u in (purl, durl)}
        for hist in (pre, dec):
            hist.history_sampler.sample_once()
        queryz = _http(durl + "/queryz?series=serving.requests&agg=max")
        qlist = _http(purl + "/queryz")
        rstats = _http(rurl + "/statsz")
        dstats = _http(durl + "/statsz")
    finally:
        router.stop()
        mgr.stop()
        direct.stop()
    wall_phase = time.perf_counter() - t_phase
    # ---- the handoff's accounting
    hp, hd = pre.stats()["handoff"], dec.stats()["handoff"]
    check(hp["fallbacks"] == 1, f"{name}: fallbacks {hp['fallbacks']}, not the faulted "
          f"one; prefill kv: {pre.stats()['kv']}")
    check(hp["exports"] >= 1, f"{name}: no request was handed off")
    check(hp["exports"] == hd["leases"]["completed"],
          f"{name}: {hp['exports']} exports but {hd['leases']['completed']} imports")
    # every request the prefill replica took was handed off or fell back
    took = int(pre.telemetry.counter("serving.http_requests").value)
    check(took == hp["exports"] + hp["fallbacks"],
          f"{name}: the prefill replica took {took} requests: {hp}")
    check(pre.stats()["requests"] == hp["fallbacks"],
          f"{name}: the prefill replica decoded rows beyond its fallback")
    check(hd["leases"]["active"] == 0 and hp["leases"]["active"] == 0,
          f"{name}: the lease table is not empty: {hd['leases']}")
    # ... and every export's replay decoded on the pages it adopted
    handoffs = fleet_handoffs(name, stitched, traffic, cfg["kv_page_tokens"])
    check(len(handoffs) == hp["exports"],
          f"{name}: {hp['exports']} exports but {len(handoffs)} handoffs in the router's traces")
    for tag, srv in (("prefill", pre), ("decode", dec), ("direct", direct)):
        kv = srv.stats()["kv"]
        check(kv["active_rows"] == 0 and kv["pages_reserved"] == 0,
              f"{name} {tag}: rows still hold pages: {kv}")
        check(kv["pages_used"] == 1 + kv["prefix"]["held_pages"],
              f"{name} {tag}: pages leaked: {kv['pages_used']} used, "
              f"{kv['prefix']['held_pages']} held by the prefix cache")
        check(kv.get("handoff", {}).get("pending_pages", 0) == 0,
              f"{name} {tag}: adopted pages never written")
    # ---- traces, SLOs, history, the flight recorder
    handed = handoffs[0]["id"]
    tz = stitched[handed][1]
    spans = tz["spans"]
    reps = {s["attrs"].get("replica") for s in spans if s["attrs"].get("remote")}
    names = {s["name"] for s in spans}
    check(reps == {"r0", "r1"} and {"balance", "kv_export", "kv_handoff"} <= names
          and tz["attrs"]["stitched"] == 2,
          f"{name}: /tracez of {handed} does not stitch both replicas: {sorted(names)}")
    for u, z in sloz.items():
        check([o["name"] for o in z["slos"]] == ["avail", "latency"],
              f"{name}: /sloz of {u} lacks the objectives: {z}")
    check(queryz["points"], f"{name}: /queryz returned no history: {queryz}")
    check("serving.kv_handoff_ms" in qlist["series"], f"{name}: /queryz series: {qlist}")
    # each breach edge writes a bundle; one profiler window runs at a time
    traces = [Path(b) / "profile" / "trace.json" for b in direct.flight_recorder.dumps]
    traces = [json.loads(t.read_text()) for t in traces if t.is_file()]
    check(any("traceEvents" in t for t in traces),
          f"{name}: no flight-recorder bundle holds a torch.profiler trace")
    events = [e for t in traces for e in t.get("traceEvents", [])]
    profile_events = {"bundles": len(direct.flight_recorder.dumps), "events": len(events),
                      "kernel_events": sum(1 for e in events if e.get("cat") == "kernel")}
    shutil.rmtree(root, ignore_errors=True)
    # ---- the numbers
    added = []
    for t in router.traces.dump():
        if t["status"] == "ok":
            up = sum(s["dur_s"] for s in t["spans"] if s["name"] == "upstream_attempt"
                     and not s["attrs"].get("remote"))
            added.append(t["dur_ms"] - up * 1e3)

    def per_handoff(key):
        return summarize([h[key] for h in handoffs])["mean"]

    ttft = {k: summarize(d["ttft_ms"]) for k, d in (("router", routed), ("direct", ref))}
    rate = {k: summarize(d["decode_tokens_per_s"]) for k, d in (("router", routed), ("direct", ref))}
    emit({
        "phase": "serve-fleet", "config": name, "device": device_line(),
        "note": "three replicas in one process share one GIL: semantics and costs, "
                "not throughput scaling",
        "requests": len(traffic), "new_tokens": FLEET_NEW, "wave": FLEET_WAVE,
        "prompt_lens": [len(t["body"]["tokens"][0]) for t in traffic],
        # at the client, over the streamed rows of the waves
        "client_timed_requests": len(routed["ttft_ms"]),
        "ttft_ms_router_p50": ttft["router"]["p50"], "ttft_ms_router_p95": ttft["router"]["p95"],
        "ttft_ms_direct_p50": ttft["direct"]["p50"], "ttft_ms_direct_p95": ttft["direct"]["p95"],
        # (FLEET_NEW - 1) tokens over the first token to the last, a request
        "decode_tokens_per_s_router_p50": rate["router"]["p50"],
        "decode_tokens_per_s_direct_p50": rate["direct"]["p50"],
        "handoff_exports": hp["exports"], "handoff_imports": hd["imports"],
        "handoff_fallbacks": hp["fallbacks"], "affinity_hits": rstats["affinity"]["hits"],
        "handoff_bytes_per_request": hp["bytes"] / max(1, hp["exports"]),
        # per handoff, from its own trace; means over the handoffs
        "handoff_capture_ms": per_handoff("capture_ms"),
        "handoff_ship_ms": per_handoff("ship_ms"),
        "handoff_adopt_host_ms": per_handoff("adopt_host_ms"),
        "handoff_wire_ms": per_handoff("wire_ms"),
        "handoff_wire_ms_min": min(h["wire_ms"] for h in handoffs),
        "handoff_write_host_ms": dec.telemetry.histogram(
            "serving.kv_handoff_write_ms").summary()["mean"],
        "replay_prefix_tokens": [h["prefix_len"] for h in handoffs],
        "router_added_ms_mean": statistics.mean(added) if added else None,
        "router_added_ms_p50": statistics.median(added) if added else None,
        "decode_imports_pages": dstats["kv"].get("handoff", {}).get("adopted_pages"),
        "flight_recorder_profile_events": profile_events,
        "phase_seconds": wall_phase,
    })
    return {"config": name, "traffic": traffic, "routed": routed, "ref": ref,
            "module": direct.module, "warm": warm,
            "launches": {"routed": routed_launches, "direct": direct_launches}}


def check_fleet_rows(fleet: dict) -> None:
    """Routed rows against the direct replica's: equal, or diverging only at
    a near-tie (compare_rows, on the direct replica's module); each stream
    against its non-streamed row by the same rule. On the int8 pool the
    reference is the int8 module's own rows on a direct int8 pool
    (int8_pool_rows, as serve-fast holds its int8 rows), with that path's
    gaps, for the routed rows, the direct replica's and the streams. A
    sampled row may also flip at top-k's edge (edge_flip, as serve-tenants
    holds its sampled rows); where a sampled row diverges, the line shows
    the witness beside it: that row from the direct replica with its
    prompt's pages warm in its own prefix cache (the prefix hit, and
    whether the row is the routed one)."""
    t0 = time.perf_counter()
    model, traffic = fleet["module"], fleet["traffic"]
    bodies = [t["body"] for t in traffic]
    samples = [(b["temperature"], b["topK"], b["seed"]) if "temperature" in b else None
               for b in bodies]
    int8 = FLEET_CONFIGS[fleet["config"]].get("kv_quant") == "int8"
    if int8:
        ref_rows, ref_gaps = int8_pool_rows(model, [b["tokens"][0] for b in bodies],
                                            FLEET_NEW, samples)
    out = {"routed": [], "direct": [], "streams": []}
    for i, body in enumerate(bodies):
        plen = len(body["tokens"][0])
        got, direct = fleet["routed"]["rows"][i], fleet["ref"]["rows"][i]
        check(len(got) == len(direct) == plen + FLEET_NEW,
              f"{fleet['config']}: row {i} has {len(got)} tokens")
        pairs = {"routed": got}
        if i in fleet["routed"]["streamed"]:
            pairs["streams"] = fleet["routed"]["streamed"][i]
        if int8:
            pairs["direct"] = direct
        for kind, row in pairs.items():
            try:
                if int8:
                    d = compare_rows(model, row, ref_rows[i], plen, gaps=ref_gaps[i])
                elif kind == "streams":
                    d = compare_rows(model, row, got, plen)
                else:
                    d = compare_rows(model, row, direct, plen, sample=samples[i])
            except SmokeFailure as e:  # held below, after every row is reported
                d = {"not_near_tie": str(e)}
                if samples[i] is not None:
                    # a top-k sampled row may flip at the mask's edge
                    # (edge_flip, the rule serve-tenants holds its sampled
                    # rows to), judged on the reference path's logits
                    ref = ref_rows[i] if int8 else (got if kind == "streams" else direct)
                    j = next(n for n, (a, b) in enumerate(zip(row, ref)) if a != b)
                    raw = _one_shot_logits(model, ref[:j], int8)
                    if edge_flip(raw, row[j], ref[j], (*samples[i], j - plen)):
                        d = {"position": j - plen, "top_k_edge_flip": True}
                    w = fleet["warm"][i]
                    d["witness"] = {"warm_prefix_len": w["prefix_len"],
                                    "warm_token": w["row"][j], "token": row[j],
                                    "reference_token": ref[j],
                                    "warm_equals_row": w["row"] == row,
                                    # the reference path's logits there
                                    "kth_logit": float(raw.topk(samples[i][1]).values[-1]),
                                    "token_logit": float(raw[row[j]]),
                                    "reference_token_logit": float(raw[ref[j]])}
            if d is not None:
                out[kind].append({"row": i, "sampled": samples[i] is not None, **d})
    emit({"phase": "serve-fleet-rows", "config": fleet["config"],
          "reference": "int8_pool_rows" if int8 else "direct replica",
          "rows": len(traffic), "rows_diverged": len(out["routed"]),
          "divergences": out["routed"], "direct_diverged": out["direct"],
          "streams_diverged": out["streams"], "seconds": time.perf_counter() - t0})
    bad = [d for ds in out.values() for d in ds if "not_near_tie" in d]
    check(not bad, f"{fleet['config']}: rows diverge past a near-tie: {bad}")


def _device_time_us(evt) -> float:
    """Self device time of a profiler row; the attribute's name changed
    across PyTorch versions."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_kernels(prof) -> list:
    """A profile's kernel rows, most device time first: operator rows and the
    device ranges of annotations (Optimizer.step#...) repeat their kernels'
    time, so they are left out."""
    import torch

    return sorted(
        (e for e in prof.key_averages()
         if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)),
        key=_device_time_us, reverse=True,
    )


def phase_train() -> dict:
    """`Trainer(program).run()` at llama3-1b width; returns the launches."""
    import torch

    from polyaxon_tpu_torch.ops.flash_attention import KERNELS
    from polyaxon_tpu_torch.runtime import Trainer
    from polyaxon_tpu_torch.telemetry import train_step_flops

    torch.cuda.reset_peak_memory_stats()
    stamps, events = [], []

    def log_fn(step, metrics):
        stamps.append((step, time.perf_counter(), metrics))

    t0 = time.perf_counter()
    trainer = Trainer(
        TRAIN_PROGRAM, artifacts_dir=str(ARTIFACTS), log_fn=log_fn,
        event_fn=lambda kind, body: events.append(kind),
    )
    build_s = time.perf_counter() - t0
    cfg = trainer.module.cfg
    for kern in KERNELS:  # the training path starts here
        kern.launches = 0
    t0 = time.perf_counter()
    result = trainer.run()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    run_s = t_end - t0
    launches = {kern.name: kern.launches for kern in KERNELS}  # ... and ends here
    losses = [h["loss"] for h in result.history]
    # a log point is read one step late, so consecutive reads are one step
    # apart on the device; the first interval holds the first step's set-up
    gaps = [b[1] - a[1] for a, b in zip(stamps, stamps[1:])]
    step_s = statistics.median(gaps[1:]) if len(gaps) > 1 else float("nan")
    # ... and the rate over all the work after the profiled step, which a
    # slow step moves. The profiler stops with a device sync and writes its
    # trace just before the read of the step before it, so the device is
    # idle at that read and the steps after the profiled one all run
    # between it and the sync after run().
    prof_stop = TRAIN_PROGRAM["train"]["profileStop"]
    window_steps = TRAIN_STEPS - prof_stop
    window_s = t_end - stamps[prof_stop - 2][1]
    window_tokens_per_s = window_steps * TRAIN_TOKENS / window_s
    n_params = sum(p.numel() for p in trainer.module.parameters())
    # the reference's formula takes the model's seq_len (8192) in the
    # attention term; the run feeds TRAIN_TOKENS per sequence
    flops = train_step_flops(n_params, cfg.n_layers, cfg.dim, cfg.seq_len, TRAIN_TOKENS)
    flops_fed = train_step_flops(n_params, cfg.n_layers, cfg.dim, TRAIN_TOKENS, TRAIN_TOKENS)
    expected = {k: PER_STEP[k] * cfg.n_layers * TRAIN_STEPS for k in PER_STEP}
    emit({
        "phase": "train", "preset": PRESET, "tokens_per_step": TRAIN_TOKENS,
        "steps": TRAIN_STEPS, "n_params": n_params, "losses": losses,
        "grad_norms": [h["grad_norm"] for h in result.history],
        "learning_rates": [h["learning_rate"] for h in result.history],
        "launches": launches, "expected_launches": expected,
        "build_seconds": build_s, "run_seconds": run_s,
        "median_step_seconds": step_s, "tokens_per_s": TRAIN_TOKENS / step_s,
        "window_seconds": window_s, "window_steps": window_steps,
        "window_tokens_per_s": window_tokens_per_s,
        "flops_per_step": flops, "mfu_vs_989_tflops": flops / step_s / PEAK_OPS["bfloat16"],
        "mfu_vs_989_tflops_fed_seq": flops_fed / step_s / PEAK_OPS["bfloat16"],
        "mfu_vs_989_tflops_window": (
            flops * window_tokens_per_s / TRAIN_TOKENS / PEAK_OPS["bfloat16"]),
        # the trainer's own per-window MFU; the first window holds set-up
        # and the last is read right after the one before it (as in the
        # reference), so only the windows between are steady
        "trainer_mfu_steady": [h.get("mfu") for h in result.history[1:-1]],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "events": events,
    })
    check(all(math.isfinite(x) for x in losses), f"non-finite loss in {losses}")
    check(len(losses) == TRAIN_STEPS and losses[-1] < losses[0],
          f"the loss did not fall: {losses}")
    TRAIN_REFERENCE.update(losses=losses, step_s=step_s,
                           peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(launches == expected, f"kernel launches {launches}, expected {expected}")
    prof = trainer.profile
    check(prof is not None, "the profile window produced no profiler")
    kernels = device_kernels(prof)
    busy_ms = sum(_device_time_us(e) for e in kernels) / 1e3
    emit({
        "phase": "train-profile", "step": 1, "kernel_ms_total": busy_ms,
        "median_step_seconds": step_s,
        "device_idle_share_vs_median_step": 1 - busy_ms / 1e3 / step_s,
        "top_kernels": [
            {"name": e.key[:90], "ms": _device_time_us(e) / 1e3, "count": e.count}
            for e in kernels[:15]
        ],
        # the port's own kernels, wherever they rank
        "flash_kernels": {
            re.search(r"flash_\w+", e.key).group(0): {
                "ms": _device_time_us(e) / 1e3, "count": e.count}
            for e in kernels if re.search(r"flash_\w+_kernel", e.key)
        },
    })
    del trainer, result, prof
    torch.cuda.empty_cache()
    return launches


def phase_train_vs_einsum() -> None:
    """3 steps from the same weights with flash and with einsum attention,
    both bf16 at [1, 2048]: per-step loss and grad_norm, and how far the
    two updates of the weights are apart."""
    import torch

    from polyaxon_tpu_torch.runtime import Trainer

    def program(attention):
        return {
            **TRAIN_PROGRAM,
            "model": {"name": "transformer_lm", "config": {
                **TRAIN_PROGRAM["model"]["config"], "attention": attention}},
            "data": {**TRAIN_PROGRAM["data"], "config": {
                **TRAIN_PROGRAM["data"]["config"], "seq_len": EINSUM_TOKENS}},
            "train": {"steps": EINSUM_STEPS, "logEvery": 1, "precision": "mixed",
                      "remat": True},
        }

    runs, start = {}, None
    for attention in ("flash", "xla"):
        trainer = Trainer(program(attention))
        if start is None:
            start = {k: v.detach().to("cpu", copy=True)
                     for k, v in trainer.module.state_dict().items()}
        else:
            trainer.load_state_dict(start)
        history = trainer.run().history
        final = {k: v.detach().to("cpu", copy=True)
                 for k, v in trainer.module.state_dict().items()}
        runs[attention] = (history, final)
        del trainer
        torch.cuda.empty_cache()
    (h_flash, p_flash), (h_ein, p_ein) = runs["flash"], runs["xla"]
    # step 0 runs from the same weights, so only attention's rounding moves
    # it; the later steps add Adam's amplification of that noise
    per_step = {
        key: [abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(h_flash, h_ein)]
        for key in ("loss", "grad_norm")
    }
    rel = {key: max(v) for key, v in per_step.items()}
    num = den = dist = norm = 0.0
    for k, p0 in start.items():
        a, b, p0 = p_flash[k].cuda(), p_ein[k].cuda(), p0.cuda()
        num += (a - b).float().pow(2).sum().item()
        den += (b - p0).float().pow(2).sum().item()
        norm += b.float().pow(2).sum().item()
    rel["update"] = math.sqrt(num / den)
    dist = math.sqrt(num / norm)
    emit({
        "phase": "train-vs-einsum", "tokens": EINSUM_TOKENS, "steps": EINSUM_STEPS,
        "loss_flash": [h["loss"] for h in h_flash],
        "loss_einsum": [h["loss"] for h in h_ein],
        "grad_norm_flash": [h["grad_norm"] for h in h_flash],
        "grad_norm_einsum": [h["grad_norm"] for h in h_ein],
        "rel_diff_loss_per_step": per_step["loss"],
        "rel_diff_grad_norm_per_step": per_step["grad_norm"],
        "max_rel_diff_loss": rel["loss"], "max_rel_diff_grad_norm": rel["grad_norm"],
        "rel_frobenius_update": rel["update"], "rel_frobenius_params": dist,
        "limits": TRAIN_VS_EINSUM,
    })
    bad = {k: v for k, v in rel.items() if not v <= TRAIN_VS_EINSUM[k]}
    check(not bad, f"flash training departs from einsum training: {bad}")

def _state_tensors(tree) -> list:
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _state_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _state_tensors(v)]
    return []


def fingerprint(trainer) -> list[int]:
    """Bit-exact summary of a trainer's state: for each tensor of its
    checkpoint (weights, Adam's mu and nu) the sum of its integer view,
    then the optimizer's count and the step."""
    import torch

    state = trainer.checkpoint_state()
    ints = {4: torch.int32, 2: torch.int16}
    sums = torch.stack([
        t.view(ints[t.element_size()]).sum(dtype=torch.int64)
        for t in _state_tensors(state)
    ])
    return sums.tolist() + [state["optimizer"]["count"], state["step"]]


def resume_program(every, model=None, local=None) -> dict:
    """TRAIN_PROGRAM without its profile window: 4 steps, a save every
    `every` steps (none when None), the newest one kept; `model` overrides
    the model's config (depth, vocabulary)."""
    train = {k: v for k, v in TRAIN_PROGRAM["train"].items()
             if k not in ("profileStart", "profileStop")}
    train["steps"] = 4
    if every:
        train.update(checkpointEvery=every, checkpointKeep=1)
    if local:
        train["checkpointLocalDir"] = str(local)
    data = TRAIN_PROGRAM["data"]
    if model and "vocab_size" in model:
        data = {**data, "config": {**data["config"], "vocab_size": model["vocab_size"]}}
    return {**TRAIN_PROGRAM, "data": data, "model": {"name": "transformer_lm", "config": {
        **TRAIN_PROGRAM["model"]["config"], **(model or {})}}, "train": train}


def _hist(name: str) -> dict:
    """A process-global histogram's summary (zeros before its first use)."""
    from polyaxon_tpu_torch.telemetry import get_registry

    metric = {m.name: m for m in get_registry().metrics()}.get(name)
    return metric.summary() if metric else {"count": 0, "sum": 0.0, "max": None}


def _delta(before: dict, after: dict) -> dict:
    return {"count": after["count"] - before["count"], "sum": after["sum"] - before["sum"]}


def run_resume(case: dict) -> dict:
    """Trainer P, sent a real SIGTERM at the head of step 3 (a save every
    `p_every`), must raise Preempted(3) with step 3 saved; trainer R
    (`resume: true`, a save every `r_every` or none) must start from P's
    state bit for bit and the schedule at 3, and train step 3 (and save 4
    once, the final save a no-op); with two tiers, trainer Q restores after
    the durable copy of the newest step is corrupted and must fall back to
    the local copy. With `run_store` the run is a run of the port's
    RunStore (its durable tier the run's outputs) that trains on a
    token_file corpus through the native loader, and after R, before Q,
    serve-run serves it (phase_serve_run). Returns what it measured; a
    failed check raises."""
    import shutil
    import uuid as uuidlib

    import numpy as np
    import torch

    from polyaxon_tpu_torch.chaos import Fault, FaultPlan, active, corrupt_checkpoint
    from polyaxon_tpu_torch.retry import Preempted
    from polyaxon_tpu_torch.runtime import Trainer, preemption
    from polyaxon_tpu_torch.runtime import checkpoint as ck
    from polyaxon_tpu_torch.store import RunStore
    from polyaxon_tpu_torch.telemetry import get_registry

    root = ARTIFACTS / "resume"
    shutil.rmtree(root, ignore_errors=True)
    durable = root / "ckpt"
    local = root / "ckpt_local" if case["two_tier"] else None
    store = uuid = corpus = None

    def program_of(every) -> dict:
        program = resume_program(every, case["model"], local)
        return corpus_program(program, corpus) if corpus else program

    if case.get("run_store"):
        root.mkdir(parents=True)
        corpus = root / "corpus.bin"
        np.random.default_rng(CORPUS_SEED).integers(
            0, 128256, CORPUS_TOKENS, dtype=np.uint32).tofile(corpus)
        store, uuid = RunStore(root / "home"), uuidlib.uuid4().hex
        store.create_run(uuid, "train-resume", "chip-smoke", {
            "kind": "operation", "name": "train-resume", "component": {
                "kind": "component", "name": "train-resume",
                "run": {"kind": "jaxjob", "program": program_of(case["p_every"])}}})
        for status in ("compiled", "queued", "scheduled", "starting", "running"):
            store.set_status(uuid, status)
        durable = store.outputs_dir(uuid) / "checkpoints"
    check(preemption.install(), "the SIGTERM handler needs the main thread")
    preemption.clear()
    writes = get_registry().counter("checkpoint.tier_writes")
    hists = ("trainer.checkpoint_stall_ms", "checkpoint.write_seconds",
             "checkpoint.host_copy_seconds", "checkpoint.upload_seconds")
    out = {**case}
    torch.cuda.reset_peak_memory_stats()

    def spans(trainer) -> list:
        return [{"name": r["name"], "step": r["attrs"].get("step"), "seconds": r["dur_s"]}
                for r in trainer.tracer.recent(100) if r["name"] in ("step", "checkpoint")]

    def measured(trainer, before, base_writes) -> dict:
        after = {h: _hist(h) for h in hists}
        return {"spans": spans(trainer), "tier_writes": writes.value - base_writes,
                "restore_seconds": [x["dur_s"] for x in trainer.tracer.recent(100)
                                    if x["name"] == "restore"],
                **{h: _delta(before[h], after[h]) for h in hists}}

    # --- P: preempted by a real SIGTERM at the head of step 3
    before, base_writes = {h: _hist(h) for h in hists}, writes.value
    events_p = []
    p = Trainer(program_of(case["p_every"]),
                checkpoint_dir=str(durable),
                event_fn=lambda kind, body: events_p.append((kind, body)))
    if corpus:
        check(p.data.meta["loader"] == "native",
              f"the corpus loader is {p.data.meta['loader']!r}, not the native one")
    try:
        with active(FaultPlan([Fault("trainer.step", "sigterm", step=3)])):
            p.run()
    except Preempted as e:
        check(e.step == 3, f"P was preempted with step {e.step}, expected 3")
    else:
        raise SmokeFailure("P ran to its end: the SIGTERM at step 3 was not seen")
    preemption.clear()
    torch.cuda.synchronize()
    check([b for k, b in events_p if k == "preempted"] == [{"step": 3, "resume_step": 3}],
          f"P's events: {events_p}")
    tiers = {"durable": ck.all_steps(str(durable))}
    if local:
        tiers["local"] = ck.all_steps(str(local))
    check(all(steps == [3] for steps in tiers.values()), f"P left steps {tiers}")
    out["p"] = {"events": events_p, **measured(p, before, base_writes)}
    fp_p = fingerprint(p)
    p_params = params_fingerprint(p.module.state_dict()) if store else None
    p.close()
    out["bytes_per_checkpoint"] = (durable / "3" / ck.STATE_FILE).stat().st_size
    tensors = _state_tensors(p.checkpoint_state())
    out["state_tensor_bytes"] = sum(t.numel() * t.element_size() for t in tensors)
    # what the snapshot costs the device: one clone of every state tensor
    out["snapshot_device_ms"] = cuda_ms(lambda: [t.clone() for t in tensors], reps=1,
                                        warmup=1, rounds=3)
    # ... and the host, once the allocator holds the clones' blocks from an
    # earlier snapshot (a boundary save after the first)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snapshot = [t.clone() for t in _state_tensors(p.checkpoint_state())]
    out["snapshot_host_ms_cached"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    del tensors, snapshot, p
    torch.cuda.empty_cache()

    # --- R: resumed; right after its restore its state is P's, bit for bit
    before, base_writes = {h: _hist(h) for h in hists}, writes.value
    events_r, lrs, fp_r = [], [], []
    r = None

    def on_event(kind, body):
        events_r.append((kind, body))
        if kind == "resumed":
            fp_r.append(fingerprint(r))

    program = program_of(case["r_every"])
    r = Trainer({**program, "train": {**program["train"], "resume": True}},
                checkpoint_dir=str(durable), event_fn=on_event,
                log_fn=lambda step, m: lrs.append((step, m["learning_rate"], m["loss"])))
    r.run()
    torch.cuda.synchronize()
    check([b for k, b in events_r if k == "resumed"] == [{"step": 3, "tier": "durable"}],
          f"R's events: {events_r}")
    check(fp_r == [fp_p], "R's restored state differs from P's")
    want_lr = float(np.float32(r.sched(3)))
    check(len(lrs) == 1 and lrs[0][:2] == (4, want_lr) and want_lr != r.sched(0),
          f"R's first learning_rate {lrs}, expected sched(3) = {want_lr}")
    check(math.isfinite(lrs[0][2]), f"R's loss {lrs[0][2]}")
    out["r"] = {"events": events_r, "learning_rates": lrs, **measured(r, before, base_writes)}
    newest = 3
    if case["r_every"]:
        newest = 4
        n_tiers = 2 if local else 1
        check(out["r"]["tier_writes"] == n_tiers,
              f"R wrote {out['r']['tier_writes']} step copies, expected {n_tiers}: "
              "one save of step 4, the final one a no-op")
        check(ck.all_steps(str(durable)) == [4], "R's save of step 4 is missing")
    r.close()
    del r
    torch.cuda.empty_cache()
    if store:
        for kind, body in events_p + events_r:
            store.log_event(uuid, kind, body)
        store.set_status(uuid, "succeeded")
        labels = [e["label"] for e in store.timeline(uuid)]
        check("preempted (step 3, resume at 3)" in labels and
              "resumed at step 3 from durable tier" in labels and labels[-1] == "-> succeeded",
              f"the run's timeline: {labels}")
        # served before Q corrupts the durable copy of step 3
        out["serve_run_launches"] = phase_serve_run(store, uuid, p_params, corpus)

    # --- Q: the durable copy of the newest step corrupted; the local copy
    if local:
        corrupt_checkpoint(str(durable), step=newest)
        events_q = []
        q = Trainer({**program, "train": {**program["train"], "resume": True}},
                    checkpoint_dir=str(durable),
                    event_fn=lambda kind, body: events_q.append((kind, body)))
        step = q.restore()
        check(step == newest and [b for k, b in events_q if k == "checkpoint_fallback"] == [{
            "corrupt_steps": [newest], "corrupt_copies": [["durable", newest]],
            "restored_step": newest}], f"Q restored {step}; events {events_q}")
        check([b for k, b in events_q if k == "resumed"] == [{"step": newest, "tier": "local"}],
              f"Q's events: {events_q}")
        check((durable / f"{newest}.corrupt").is_dir(),
              "the corrupt durable copy was not quarantined")
        out["q"] = {"events": events_q, "restore_seconds": [
            x["dur_s"] for x in q.tracer.recent(100) if x["name"] == "restore"]}
        q.close()
        del q
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    ck.close_all()
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# The resume runs, sized so the script writes ~42 GB to disk in all: a GPU
# host may cap what one run writes to its disk (deleted files included).
# At full size (17.98 GB a checkpoint) two copies are written: P's boundary
# save of step 3 on the local tier and its upload. The flushed save after a
# boundary (P saving 2, then 3 at the SIGTERM) and R's save of 4 with the
# final no-op run at the preset's width with 2 layers and an 8192-token
# vocabulary (1.86 GB a checkpoint, three writes), on one tier.
RESUME_CASES = [
    {"size": "full", "model": None, "two_tier": True, "p_every": 3, "r_every": None,
     "run_store": True},
    {"size": "2 layers, vocab 8192", "model": {"n_layers": 2, "vocab_size": 8192},
     "two_tier": False, "p_every": 2, "r_every": 2},
]


# serve-run: the full-size resume case is a run of the port's RunStore that
# trains on a token_file corpus (the native loader) of 2^24 uint32 tokens
# below the vocabulary, written by numpy from seed 0, and pins these
# serving knobs; after R it is served by ModelServer.from_run: 8 greedy
# requests of 32 new tokens over HTTP, prompts of 128-2048 corpus tokens.
# The restore may hold at most the params' bytes plus 10% on the card.
CORPUS_TOKENS, CORPUS_SEED = 1 << 24, 0
RUN_SERVING = {"quantize": True, "kvPoolPages": 256, "chunkedPrefill": True, "maxBatch": 8}
RUN_OVERRIDES = {"max_queue": 16}
RUN_PROMPTS, RUN_NEW, RUN_PROMPT_SEED = 8, 32, 5
# the served rows held against the direct path: every other one, 128 to
# 1773 tokens (all 8 took 36-39 s of the script)
RUN_HELD = tuple(range(0, RUN_PROMPTS, 2))
RESTORE_SLACK = 1.10


def corpus_program(program: dict, corpus: Path) -> dict:
    """`program` training on the token_file corpus through the native loader
    (the same sequence length and vocabulary), with the serving pins."""
    data = {"name": "token_file", "batchSize": program["data"]["batchSize"], "config": {
        "path": str(corpus), "seq_len": TRAIN_TOKENS, "dtype": "uint32",
        "loader": "native", "vocab_size": 128256}}
    return {**program, "data": data, "serving": RUN_SERVING}


def params_fingerprint(state: dict) -> dict:
    """name -> the sum of the tensor's integer view (bit-exact summary)."""
    import torch

    ints = {4: torch.int32, 2: torch.int16, 1: torch.int8}
    names = list(state)
    sums = torch.stack([state[n].view(ints[state[n].element_size()]).sum(dtype=torch.int64)
                        for n in names]).tolist()
    return dict(zip(names, sums))


def run_prompts(corpus: Path, vocab: int) -> list:
    """RUN_PROMPTS windows of the corpus, 128-2048 tokens, at seeded starts."""
    import numpy as np

    tokens = np.memmap(corpus, dtype=np.uint32, mode="r")
    rng = np.random.default_rng(RUN_PROMPT_SEED)
    lens = np.linspace(SERVE_PROMPT_LENS[0], SERVE_PROMPT_LENS[1], RUN_PROMPTS).astype(int)
    starts = rng.integers(0, len(tokens) - lens.max(), RUN_PROMPTS)
    prompts = [tokens[s:s + n].astype(np.int64).tolist() for s, n in zip(starts, lens)]
    check(all(0 <= t < vocab for p in prompts for t in p), "a corpus token is out of vocab")
    return prompts


def phase_serve_run(store, uuid: str, p_params: dict, corpus: Path) -> dict:
    """ModelServer.from_run on the resumed run (before Q corrupts its durable
    step 3): the step is 3; the served params are P's at its save, bit for
    bit (every fp leaf, and each projection's fp weight as it reached the
    card, whose int8 weight and scale the served module holds); the card's
    peak over from_run stays under the params' bytes plus 10%; the config is
    the spec's pins plus the override. Then 8 greedy requests over HTTP,
    the RUN_HELD rows held against the int8 module's own rows on a direct
    pool (int8_pool_rows; the near-tie rule). The kernel counts are zeroed
    before from_run and read after the requests (the served path only),
    then put back as they were. Returns the served path's launches."""
    import threading

    import torch

    from polyaxon_tpu_torch.models import quant
    from polyaxon_tpu_torch.ops.flash_attention import KERNELS as FLASH_KERNELS
    from polyaxon_tpu_torch.ops.int8_matmul import INT8_MATMUL
    from polyaxon_tpu_torch.schemas.run_kinds import V1ServingSpec
    from polyaxon_tpu_torch.serving.server import ModelServer

    kernels = (*FLASH_KERNELS, INT8_MATMUL)
    counts_before = {k.name: k.launches for k in kernels}
    arrived = []  # (fp weight, int8 weight, scale) sums per quantize on load
    real_quantize = quant.quantize_kernel

    def recording(w):
        q, scale = real_quantize(w)
        ints = {4: torch.int32, 2: torch.int16}[w.element_size()]
        arrived.append(tuple(t.view(dt).sum(dtype=torch.int64) for t, dt in (
            (w, ints), (q, torch.int8), (scale, torch.int32))))
        return q, scale

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:  # the served run's path starts here
        k.launches = 0
    quant.quantize_kernel = recording
    try:
        t0 = time.perf_counter()
        server = ModelServer.from_run(uuid[:8], store=store, config_overrides=RUN_OVERRIDES)
        torch.cuda.synchronize()
        from_run_s = time.perf_counter() - t0
    finally:
        quant.quantize_kernel = real_quantize
    peak = torch.cuda.max_memory_allocated() - base
    info = server.restore_info
    check(server.step == 3, f"from_run restored step {server.step}, expected 3")
    check(info["bytes_read"] == 4 * PRESET_PARAMS,
          f"read {info['bytes_read']} B of params, expected {4 * PRESET_PARAMS} (f32 masters)")
    check(peak <= RESTORE_SLACK * info["bytes_read"],
          f"from_run peaked at {peak} B on the card, over {RESTORE_SLACK} x the params' "
          f"{info['bytes_read']} B")
    want = dataclasses.replace(V1ServingSpec.from_dict(RUN_SERVING).to_config(), **RUN_OVERRIDES)
    check(server.config == want, f"served config {server.config} is not the spec's {want}")
    # the served params: P's, bit for bit
    served = server.module.state_dict()
    targets = [n for n in p_params if n.endswith(".weight")
               and quant._is_target(quant._split(n)[0])]
    check(len(arrived) == len(targets), f"{len(arrived)} weights quantized on load, "
                                        f"expected {len(targets)}")
    got = params_fingerprint({n: served[n] for n in p_params if n not in targets})
    for name, (w_sum, q_sum, s_sum) in zip(targets, arrived):
        prefix = quant._split(name)[0]
        got[name] = int(w_sum)
        check(int(q_sum) == int(served[name].view(torch.int8).sum(dtype=torch.int64)) and
              int(s_sum) == int(served[f"{prefix}.scale"].view(torch.int32).sum(
                  dtype=torch.int64)), f"{name}: the served int8 weight is not the one quantized")
    bad = [n for n in p_params if got[n] != p_params[n]]
    check(not bad, f"served params differ from P's at its save: {bad[:4]}")
    del served

    prompts = run_prompts(corpus, server.module.cfg.vocab_size)
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    timed: dict = {}

    def one(i):
        try:
            timed[i] = _sse_timed(url, {"tokens": [prompts[i]], "maxNewTokens": RUN_NEW},
                                  f"run-{i}")
        except BaseException as e:  # noqa: BLE001 — raised below
            timed[i] = e

    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(RUN_PROMPTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels}  # ... and ends here
        stats = server.stats()
    finally:
        server.stop()
    for i in range(RUN_PROMPTS):
        check(isinstance(timed.get(i), dict), f"serve-run request {i} failed: {timed.get(i)!r}")
    check(launches["int8_matmul"] > 0, "the served run never launched int8_matmul")
    rows = [timed[i]["row"] for i in range(RUN_PROMPTS)]
    t1 = time.perf_counter()
    for i, (p, row) in enumerate(zip(prompts, rows)):
        check(len(row) == len(p) + RUN_NEW, f"serve-run row {i} has {len(row)} tokens")
    reference, gaps = int8_pool_rows(server.module, [prompts[i] for i in RUN_HELD],
                                     new=RUN_NEW, kv_quant="none")
    divergences = []
    for j, i in enumerate(RUN_HELD):
        d = compare_rows(server.module, rows[i], reference[j], len(prompts[i]), gaps=gaps[j])
        if d is not None:
            divergences.append({"row": i, **d})
    for k in kernels:  # put back the counts of the phase around this one
        k.launches = counts_before[k.name]
    # the CLI serves the same run from a child process while its checkpoint
    # is intact (Q corrupts it next, and the phase then removes it)
    CLI_SERVE.update(serve_child(store.home, uuid, server.module, prompts, rows))
    ttft = [timed[i]["ttft_ms"] for i in range(RUN_PROMPTS)]
    decode = [(RUN_NEW - 1) / timed[i]["decode_s"] for i in range(RUN_PROMPTS)]
    out = {
        "phase": "serve-run", "device": device_line(), "run": uuid, "step": server.step,
        "from_run_s": from_run_s, "read_s": info["read_s"], "to_device_s": info["to_device_s"],
        "quantize_s": info["quantize_s"], "bytes_read": info["bytes_read"],
        "state_file_bytes": Path(info["path"]).stat().st_size,
        "peak_bytes": peak, "peak_over_params": peak / info["bytes_read"],
        "prompt_lens": [len(p) for p in prompts], "new_tokens": RUN_NEW,
        "ttft_ms_p50": statistics.median(ttft), "ttft_ms": ttft,
        "decode_tokens_per_s_p50": statistics.median(decode),
        "decode_tokens_per_s": decode, "wall_s": wall,
        "kv": stats.get("kv"), "launches": launches,
        "rows_held": list(RUN_HELD),
        "rows_diverged": len(divergences), "divergences": divergences,
        "rows_check_s": time.perf_counter() - t1,
    }
    emit(out)
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# cli: the port's CLI. A Polyaxonfile of a transformer_lm program at the
# preset's width with CLI_LAYERS layers (a cut), run in this process by
# `main(["run", ...])` for CLI_STEPS steps; the serve child of serve-run
# answers CLI_SERVE_REQUESTS of serve-run's prompts.
CLI_LAYERS, CLI_STEPS = 2, 6
CLI_SERVE_REQUESTS = 4
CLI_SERVE_READY_S = 600.0
CLI_CHILD_TIMEOUT_S = 600.0
CLI_SERVE: dict = {}  # what serve-run's `serve` child answered, for the cli line
CLI_POLYAXONFILE = """\
version: 1.1
kind: operation
name: cli-lm
component:
  kind: component
  name: cli-lm
  inputs:
  - {{name: steps, type: int, value: 2}}
  run:
    kind: jaxjob
    program:
      model:
        name: transformer_lm
        config: {{preset: {preset}, attention: flash, n_layers: {layers}, fused_lm_loss: true}}
      data:
        name: synthetic_text
        batchSize: 1
        config: {{seq_len: {tokens}, vocab_size: 128256}}
      optimizer:
        name: adamw
        learningRate: 3.0e-4
        schedule: {{name: cosine, warmup_steps: 2}}
      train:
        steps: "{{{{ params.steps }}}}"
        logEvery: 1
        precision: mixed
        remat: true
      observability: {{sampleInterval: 1.0}}
"""


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _stop_child(child) -> None:
    if child.poll() is None:
        child.terminate()  # SIGTERM: a server drains and exits
        try:
            child.wait(timeout=60)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait(timeout=60)


def serve_child(home: Path, uuid: str, module, prompts: list, rows: list) -> dict:
    """`python -m polyaxon_tpu_torch serve -uid <run>` as a child process on
    the run's store, with serve-run's override (its start-up timed: CUDA
    init, the restore of the newest state.pt, the int8 quantize on load):
    CLI_SERVE_REQUESTS concurrent greedy requests of serve-run's prompts,
    each row held against the in-process server's row by compare_rows (the
    near-tie rule, on the served int8 module). The child is stopped before
    this returns."""
    import os
    import threading

    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "POLYAXON_TORCH_DEVICE"}
    env["POLYAXON_HOME"] = str(home)
    log = ARTIFACTS / "serve_child.log"
    argv = [sys.executable, "-m", "polyaxon_tpu_torch", "serve", "-uid", uuid[:8],
            "--port", str(port), "--max-queue", str(RUN_OVERRIDES["max_queue"])]
    url = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    with open(log, "w") as f:
        child = subprocess.Popen(argv, cwd=HERE, env=env, stdout=f, stderr=subprocess.STDOUT)
    try:
        ready_s = None
        while time.perf_counter() - t0 < CLI_SERVE_READY_S:
            if child.poll() is not None:
                raise SmokeFailure(f"the serve child exited with {child.returncode}: "
                                   f"{log.read_text()[-2000:]}")
            try:
                if _http(url + "/readyz").get("ready"):
                    ready_s = time.perf_counter() - t0
                    break
            except Exception:  # noqa: BLE001 — not up yet
                pass
            time.sleep(0.5)
        check(ready_s is not None, f"the serve child was not ready in {CLI_SERVE_READY_S} s")
        answers: dict = {}

        def ask(i):
            try:
                answers[i] = _http(url + "/generate",
                                   {"tokens": [prompts[i]], "maxNewTokens": RUN_NEW})
            except BaseException as e:  # noqa: BLE001 — raised below
                answers[i] = e

        t1 = time.perf_counter()
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(CLI_SERVE_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        answer_s = time.perf_counter() - t1
    finally:
        _stop_child(child)
    check(child.returncode == 0, f"the serve child exited with {child.returncode} on SIGTERM")
    first = log.read_text().splitlines()[:1]
    check(first and first[0].startswith(f"serving transformer_lm (step 3) on {url}"),
          f"the serve child's first line: {first}")
    divergences = []
    for i in range(CLI_SERVE_REQUESTS):
        check(isinstance(answers.get(i), dict), f"serve child request {i}: {answers.get(i)!r}")
        row = answers[i]["tokens"][0]
        check(len(row) == len(prompts[i]) + RUN_NEW, f"serve child row {i}: {len(row)} tokens")
        d = compare_rows(module, row, rows[i], len(prompts[i]))
        if d is not None:
            divergences.append({"row": i, **d})
    return {"ready_s": ready_s, "requests": CLI_SERVE_REQUESTS, "answer_s": answer_s,
            "rows_equal_in_process": CLI_SERVE_REQUESTS - len(divergences),
            "divergences": divergences}


def _cli(main, argv: list) -> tuple:
    """(exit code, stdout) of the port's CLI run in this process."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = main(argv)
    return code, out.getvalue()


@contextlib.contextmanager
def _cli_home(tag: str):
    """A fresh POLYAXON_HOME under ARTIFACTS and no POLYAXON_TORCH_DEVICE
    (the card, as a user runs it) for the length of the block; yields the
    home. Removed after."""
    import os
    import shutil
    import tempfile

    root = Path(tempfile.mkdtemp(prefix=f"{tag}-", dir=ARTIFACTS))
    saved = {k: os.environ.get(k) for k in ("POLYAXON_HOME", "POLYAXON_TORCH_DEVICE")}
    os.environ["POLYAXON_HOME"] = str(root / "home")
    os.environ.pop("POLYAXON_TORCH_DEVICE", None)
    try:
        yield root
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


def phase_cli() -> dict:
    """The port's CLI (phase 7c); returns the run's kernel launches."""
    import os

    from polyaxon_tpu_torch.cli.main import main
    from polyaxon_tpu_torch.ops.flash_attention import KERNELS
    from polyaxon_tpu_torch.store import RunStore

    t0 = time.perf_counter()
    check(CLI_SERVE.get("requests") == CLI_SERVE_REQUESTS, "serve-run's serve child did not run")
    with _cli_home("cli") as root:
        examples = sorted((HERE / "examples").glob("*.yaml"))
        for f in examples:
            code, out = _cli(main, ["check", "-f", str(f)])
            check(code == 0 and json.loads(out)["component"]["run"]["kind"] == "jaxjob",
                  f"check -f {f.name} exited {code}")
        spec = root / "cli-lm.yaml"
        spec.write_text(CLI_POLYAXONFILE.format(preset=PRESET, layers=CLI_LAYERS,
                                                tokens=TRAIN_TOKENS))
        for kern in KERNELS:  # the CLI's run starts here
            kern.launches = 0
        t1 = time.perf_counter()
        code, out = _cli(main, ["run", "-f", str(spec), "-P", f"steps={CLI_STEPS}"])
        run_s = time.perf_counter() - t1
        launches = {kern.name: kern.launches for kern in KERNELS}  # ... and ends here
        check(code == 0 and out.rstrip().endswith("finished: V1Statuses.SUCCEEDED"),
              f"run exited {code}: {out}")
        store = RunStore(root / "home")
        (run,) = store.list_runs()
        code, out = _cli(main, ["ops", "metrics", "-uid", run["uuid"][:8]])
        records = [json.loads(line) for line in out.splitlines()]
        steps = [r["step"] for r in records if "loss" in r]
        check(code == 0 and steps == list(range(1, CLI_STEPS + 1)), f"ops metrics steps {steps}")
        gauges = sorted({k for r in records for k in r if k.startswith("sys.")})
        samples = sum(1 for r in records if "sys.cpu_percent" in r)
        for name in ("sys.cpu_percent", "sys.memory_percent", "sys.memory_used_gb",
                     "sys.gpu0.hbm_used_gb", "sys.gpu0.hbm_percent"):
            check(name in gauges, f"ops metrics has no {name}: {gauges}")
        summary = next(e for e in store.read_events(run["uuid"]) if e["kind"] == "run_summary")
        expected = {k: PER_STEP[k] * CLI_LAYERS * CLI_STEPS for k in PER_STEP}
        check(launches == expected, f"cli run launches {launches}, expected {expected}")
        t2 = time.perf_counter()
        env = {k: v for k, v in os.environ.items()}
        env["POLYAXON_HOME"] = str(root / "home-mnist")
        proc = subprocess.run(
            [sys.executable, "-m", "polyaxon_tpu_torch", "run", "-f",
             str(HERE / "examples" / "mnist.yaml"), "-P", "steps=20"],
            cwd=HERE, env=env, capture_output=True, text=True, timeout=CLI_CHILD_TIMEOUT_S,
        )
        mnist_s = time.perf_counter() - t2
        check(proc.returncode == 0 and "finished: V1Statuses.SUCCEEDED" in proc.stdout,
              f"python -m polyaxon_tpu_torch run mnist exited {proc.returncode}: "
              f"{proc.stdout[-1000:]} {proc.stderr[-2000:]}")
    emit({"phase": "cli", "device": device_line(), "examples_checked": len(examples),
          "layers": CLI_LAYERS, "steps": CLI_STEPS,
          "steps_per_sec": summary["steps_per_sec"], "run_s": run_s,
          "final_loss": summary["final_metrics"].get("loss"), "gauges": gauges,
          "monitor_samples": samples,
          "launches": launches, "expected_launches": expected,
          "mnist_subprocess_s": mnist_s, "serve": CLI_SERVE,
          "seconds": time.perf_counter() - t0})
    return launches


# 7d. the sweep: examples/lm_asha.yaml as shipped
SWEEP_EXAMPLE = "lm_asha.yaml"
# 7e. the pipeline: a grid of two learning rates on 7c's program, then the winner
PIPELINE_LRS = (1.0e-3, 1.0e-6)


def _summary_json(out: str) -> dict:
    """The sweep's JSON summary that `run` prints after the trials' lines."""
    return json.loads(out[out.index("{\n"):])


def _train_seconds(store, uuid: str) -> float:
    """A run's seconds inside its training steps: its steps over the
    steps/s of its run_summary (the step loop's own clock)."""
    summary = next(e for e in store.read_events(uuid) if e["kind"] == "run_summary")
    steps = [m["step"] for m in store.read_metrics(uuid) if "loss" in m]
    return max(steps) / summary["steps_per_sec"]


def _run_seconds(store, uuid: str) -> float:
    """A run's seconds from its first status condition to its last."""
    conds = store.get_status(uuid)["conditions"]
    return conds[-1]["ts"] - conds[0]["ts"]


def phase_sweep() -> dict:
    """The port's Polytune (phase 7d); returns the sweep's kernel launches."""
    import torch

    from polyaxon_tpu_torch.cli.main import main
    from polyaxon_tpu_torch.ops.flash_attention import KERNELS
    from polyaxon_tpu_torch.ops.int8_matmul import INT8_MATMUL
    from polyaxon_tpu_torch.polyaxonfile.reader import read_polyaxonfile
    from polyaxon_tpu_torch.schemas.lifecycle import V1Statuses
    from polyaxon_tpu_torch.store import RunStore
    from polyaxon_tpu_torch.tuner import SweepDriver, build_manager
    from polyaxon_tpu_torch.tuner.placement import device_pool, sub_slices

    kernels = (*KERNELS, INT8_MATMUL)
    path = HERE / "examples" / SWEEP_EXAMPLE
    op = read_polyaxonfile(path)
    matrix = op.matrix
    t0 = time.perf_counter()
    with _cli_home("sweep") as root:
        groups = sub_slices(matrix.concurrency, device_pool())
        check(groups == [[torch.device("cuda", 0)]] and SweepDriver(op)._topology() is None,
              f"the sweep's placement: {groups}")
        for kern in kernels:  # the sweep starts here
            kern.launches = 0
        t1 = time.perf_counter()
        code, out = _cli(main, ["run", "-f", str(path)])
        wall = time.perf_counter() - t1
        launches = {kern.name: kern.launches for kern in kernels}  # ... and ends here
        check(code == 0, f"run -f {SWEEP_EXAMPLE} exited {code}: {out[-2000:]}")
        summary = _summary_json(out)
        trials = summary["trials"]
        check(summary["status"] == "succeeded", f"the sweep settled {summary['status']}")
        for t in trials:
            check(t["status"] == str(V1Statuses.SUCCEEDED) and t["objective"] is not None
                  and math.isfinite(t["objective"]), f"trial {t}")
        # the search manager fed the trials' own losses gives these trials
        # (the JAX package's manager gives the same: tests/test_torch_tuner.py)
        mgr, expected, it = build_manager(matrix), [], iter(trials)
        while not mgr.done:
            observed = []
            for sug in mgr.suggest():
                expected.append({**sug.run_params(), matrix.resource.name: int(sug.resource)})
                observed.append((sug, -next(it)["objective"]))
            mgr.observe(observed)
        check([t["params"] for t in trials] == expected
              and len(trials) == matrix.max_iterations == 16,
              f"{len(trials)} trials, the manager gives {len(expected)}")
        best = min(trials, key=lambda t: t["objective"])
        check(summary["best"]["uuid"] == best["uuid"], "best is not the least loss")
        code, listed = _cli(main, ["ops", "ls", "--sweep", summary["sweep"][:8]])
        check(code == 0 and sorted(line[:8] for line in listed.splitlines())
              == sorted(t["uuid"][:8] for t in trials), f"ops ls --sweep: {listed}")
        store = RunStore(root / "home")
        train_s = [_train_seconds(store, t["uuid"]) for t in trials]
        trial_s = [_run_seconds(store, t["uuid"]) for t in trials]
    steps = [t["params"][matrix.resource.name] for t in trials]
    emit({"phase": "sweep", "device": device_line(), "example": SWEEP_EXAMPLE,
          "trials": len(trials), "groups": [[str(d) for d in g] for g in groups],
          "steps": steps, "best": summary["best"], "wall_s": wall,
          "trials_per_hour": len(trials) * 3600.0 / wall,
          "train_s": sum(train_s), "trial_s_mean": statistics.mean(trial_s),
          "outside_steps_s_mean": (wall - sum(train_s)) / len(trials),
          "launches": launches,
          "launches_of": "every trial, summed: the counters are per process, shared by "
                         "trial threads (one card runs one trial at a time)",
          "seconds": time.perf_counter() - t0})
    return launches


# 7f. sched: the scheduler and the fleet on 7c's program (SCHED_PROGRAM)
SCHED_VOCAB = 32000  # one checkpoint of the 2-layer program: ~2.3 GB, not 4.6
SCHED_BATCH = 2  # an elastic grant of 1 of 2 chips doubles grad_accum: 2 rows
SCHED_STEPS = 6  # the victim's steps
SCHED_SHORT = 3  # the preemptor's, the elastic run's and each firing's
SCHED_EVICT_AFTER = 2  # the victim's log point at which the preemptor arrives
# the victim's losses against an uninterrupted Trainer whose stream restarts
# at the eviction step, relative per step: the same kernels on the same
# inputs, the restored state bit for bit (a prior: TRAIN_MESH_TOL)
SCHED_TOL = 1e-4
SCHED_SERVE_READY_S = 300.0


def sched_program(steps: int, **train) -> dict:
    return {
        "model": {"name": "transformer_lm", "config": {
            "preset": PRESET, "attention": "flash", "n_layers": CLI_LAYERS,
            "fused_lm_loss": True, "vocab_size": SCHED_VOCAB}},
        "data": {"name": "synthetic_text", "batchSize": SCHED_BATCH,
                 "config": {"seq_len": TRAIN_TOKENS, "vocab_size": SCHED_VOCAB}},
        "optimizer": {"name": "adamw", "learningRate": 3.0e-4,
                      "schedule": {"name": "cosine", "warmup_steps": 2}},
        "train": {"steps": steps, "logEvery": 1, "precision": "mixed", "remat": True,
                  **train},
    }


def sched_op(name: str, program: dict, run_extra=None, **extra) -> dict:
    return {"version": 1.1, "kind": "operation", "name": name, **extra,
            "component": {"kind": "component", "name": name,
                          "termination": {"maxRetries": 0},
                          "run": {"kind": "jaxjob", "program": program, **(run_extra or {})}}}


def uninterrupted_losses(program: dict, restart_at: int) -> list:
    """The losses of one Trainer of `program` that runs on without a
    checkpoint or a restart, its data stream started again after step
    `restart_at` as a resumed run's stream is (both packages start a fresh
    stream on resume): the eviction's reference."""
    from polyaxon_tpu_torch.data import build_data
    from polyaxon_tpu_torch.runtime import Trainer

    trainer = Trainer(program)
    steps = trainer.steps
    trainer.steps = restart_at
    history = list(trainer.run().history)
    trainer.steps = steps
    trainer.data = build_data(*trainer._data_args, seed=int(trainer.tspec.seed))
    history += trainer.run().history
    trainer.close()
    return [(h["step"], h["loss"]) for h in history if "loss" in h]


def _serve_reserved(store, uuid: str) -> dict:
    """`serve -uid <uuid> --replicas 1 --route` as a child on the store's
    home: its slot's reservation while it serves, one request through the
    router, then SIGTERM; returns what was seen."""
    import os
    import signal

    from polyaxon_tpu_torch.scheduler.fleet import Fleet

    port = _free_port()
    env = dict(os.environ, POLYAXON_HOME=str(store.home))
    log = ARTIFACTS / "sched_serve.log"
    argv = [sys.executable, "-m", "polyaxon_tpu_torch", "serve", "-uid", uuid[:8],
            "--replicas", "1", "--route", "--port", str(port)]
    t0 = time.perf_counter()
    with open(log, "w") as f:
        child = subprocess.Popen(argv, cwd=HERE, env=env, stdout=f, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    seen: dict = {}
    try:
        while time.perf_counter() - t0 < SCHED_SERVE_READY_S:
            check(child.poll() is None, f"the serve child exited with {child.returncode}: "
                  f"{log.read_text()[-2000:]}")
            try:
                if _http(url + "/readyz").get("ready"):
                    break
            except Exception:  # noqa: BLE001 — not up yet
                pass
            time.sleep(0.5)
        seen["ready_s"] = time.perf_counter() - t0
        seen["reservations"] = Fleet(store).ledger.all()
        out = _http(url + "/generate", {"tokens": [list(range(1, 65))], "maxNewTokens": 8})
        seen["generated"] = len(out["tokens"][0])
    finally:
        if child.poll() is None:
            child.send_signal(signal.SIGTERM)
            try:
                child.wait(timeout=120)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait(timeout=60)
    seen["exit"] = child.returncode
    seen["after_stop"] = Fleet(store).ledger.all()
    return seen


def phase_sched() -> dict:
    """The scheduler and the fleet (phase 7f); returns the kernel launches
    of the runs trained in this process."""
    import threading

    from polyaxon_tpu_torch.cli.main import main
    from polyaxon_tpu_torch.ops.flash_attention import KERNELS
    from polyaxon_tpu_torch.scheduler import Agent
    from polyaxon_tpu_torch.scheduler.fleet import Fleet
    from polyaxon_tpu_torch.schemas.operation import V1Operation
    from polyaxon_tpu_torch.store import RunStore
    from polyaxon_tpu_torch.telemetry import get_registry

    t0 = time.perf_counter()
    line: dict = {"phase": "sched", "device": device_line()}
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    with _cli_home("sched") as root:
        code, out = _cli(main, ["fleet", "init", "--chips", "1"])
        check(code == 0 and out == 'fleet configured: {"chips": 1}\n', f"fleet init: {out}")
        code, out = _cli(main, ["fleet", "quota", "set", "elastic", "--max-chips", "1"])
        check(code == 0, f"fleet quota set: {out}")
        store = RunStore(root / "home")
        agent = Agent(store=store)
        for kern in KERNELS:  # the scheduled runs start here
            kern.launches = 0

        # (1) eviction: the preemptor arrives at the victim's log point
        victim_prog = sched_program(SCHED_STEPS, resume=True)  # a save only on eviction
        victim = agent.submit(V1Operation.from_dict(sched_op("victim", victim_prog)))
        log_metrics = store.log_metrics
        arrived: dict = {}

        def arrive(run_uuid, step, metrics):
            log_metrics(run_uuid, step, metrics)
            if run_uuid == victim and step == SCHED_EVICT_AFTER and not arrived:
                arrived["uuid"] = agent.submit(V1Operation.from_dict(
                    sched_op("preemptor", sched_program(SCHED_SHORT))), priority=5)
                arrived["second_agent_ran"] = Agent(store=store).drain()  # admission: WAIT + evict

        store.log_metrics = arrive
        t1 = time.perf_counter()
        drained = agent.drain()
        line["evict_drain_s"] = time.perf_counter() - t1
        store.log_metrics = log_metrics
        check(drained == 3 and "uuid" in arrived, f"drained {drained}, preemptor {arrived}")
        v, h = store.get_status(victim), store.get_status(arrived["uuid"])
        check(v["status"] == h["status"] == "succeeded", f"victim {v['status']}, "
              f"preemptor {h['status']}")
        check(v["meta"]["preempt_restarts"] == 1 and v["meta"]["priority"] == 0,
              f"victim meta {v['meta']}")
        (evicted,) = [e for e in store.read_events(victim)
                      if e["kind"] == "preempted" and e.get("scheduler")]
        k = evicted["step"]
        order = [(c["type"], c.get("reason")) for c in v["conditions"]]
        check(("retrying", "evicted") in order, f"victim conditions {order}")
        got = [(m["step"], m["loss"]) for m in store.read_metrics(victim) if "loss" in m]
        check(any(s > k for s, _ in got) and any(s <= k for s, _ in got),
              f"victim steps {[s for s, _ in got]} around the eviction at {k}")

        # (2) an elastic gang of 2 (floor 1) on the fleet's one chip: granted
        # 1, it trains in this process with grad_accum doubled
        resizes = get_registry().counter("trainer.elastic_resizes")
        before = resizes.value
        elastic = agent.submit(V1Operation.from_dict(sched_op(
            "elastic", sched_program(SCHED_SHORT), run_extra={"replicas": 2},
            environment={"resources": {"chips": 2, "minChips": 1}})), project="elastic")
        check(agent.drain() == 1, "the elastic run was not drained")
        e = store.get_status(elastic)
        (resize,) = [x for x in store.read_events(elastic) if x["kind"] == "elastic_resize"]
        check(e["status"] == "succeeded" and e["meta"]["granted_chips"] == 1
              and e["meta"]["requested_chips"] == 2 and resize["grad_accum"] == 2
              and resizes.value == before + 1, f"elastic: {e['status']} {e['meta']} {resize}")
        line["elastic"] = {"granted": 1, "requested": 2, "grad_accum": resize["grad_accum"],
                           "losses": [m["loss"] for m in store.read_metrics(elastic)
                                      if "loss" in m]}

        # (3) an interval schedule registered by `run`, fired by `agent serve`
        sched_file = root / "tick.json"
        sched_file.write_text(json.dumps(sched_op(
            "tick", sched_program(SCHED_SHORT),
            schedule={"kind": "interval", "frequency": 1, "maxRuns": 2})))
        code, out = _cli(main, ["run", "-f", str(sched_file)])
        check(code == 0 and "registered (interval)" in out, f"run of a schedule: {out}")

        def fired() -> list:
            return [r["uuid"] for r in store.list_runs() if r["name"] == "tick"
                    and store.get_status(r["uuid"]).get("status") == "succeeded"]

        t1 = time.perf_counter()
        agent.serve(poll_interval=0.2,
                    stop_when=lambda: len(fired()) == 2 or time.perf_counter() - t1 > 180)
        line["schedule_s"] = time.perf_counter() - t1
        check(len(fired()) == 2, f"the schedule fired {len(fired())} run(s) of 2")
        launches = {kern.name: kern.launches for kern in KERNELS}  # ... and ends here
        # forward and backward units: the victim's 6 steps (3, then 3 after
        # the resume), the preemptor's 3, the elastic run's 3 x grad_accum
        # 2, and the two firings' 3 each
        units = SCHED_STEPS + SCHED_SHORT + 2 * SCHED_SHORT + 2 * SCHED_SHORT
        expected = {name: PER_STEP[name] * CLI_LAYERS * units for name in PER_STEP}
        line.update({"launches": launches, "expected_launches": expected})
        check(launches == expected, f"sched launches {launches}, expected {expected}")

        # the victim against one uninterrupted Trainer (outside the count)
        want = dict(uninterrupted_losses(victim_prog, k))
        rel = max(abs(loss - want[step]) / abs(want[step]) for step, loss in got)
        line.update({"eviction_step": k, "victim_steps": [s for s, _ in got],
                     "victim_losses": [x for _, x in got],
                     "uninterrupted_losses": [want[s] for s, _ in got],
                     "victim_max_rel": rel, "tol": SCHED_TOL})
        check(rel <= SCHED_TOL, f"victim losses {got} against {want}: {rel:.3g}")

        # (4) serve --replicas 1 --route holds the card under `serving`
        served = _serve_reserved(store, victim)
        slot = f"serve-{victim[:8]}-r0"
        check(list(served["reservations"]) == [slot]
              and served["reservations"][slot]["queue"] == "serving"
              and served["reservations"][slot]["chips"] == 1,
              f"serving reservations {served['reservations']}")
        check(served["exit"] == 0 and served["after_stop"] == {},
              f"serve exited {served['exit']}, reservations after it {served['after_stop']}")
        line["serve"] = {"ready_s": served["ready_s"], "generated": served["generated"]}
        check(Fleet(store).ledger.all() == {}, "reservations left at the end")
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    return launches


# 7g. remote: the control plane. REMOTE_LONG_STEPS for the run that is
# stopped after its first logged step, REMOTE_GETS timed GETs of each read
# route, the tracked job's attention at the preset's head shape over
# REMOTE_JOB_TOKENS tokens (the kernels' own tolerances, TOL and BWD_TOL)
REMOTE_LONG_STEPS, REMOTE_GETS, REMOTE_JOB_TOKENS = 200, 50, 2048
REMOTE_READY_S, REMOTE_RUN_S = 120.0, 600.0
REMOTE_JOB = """\
import json, sys, tempfile
sys.path.insert(0, {here!r})
import torch
import chip_smoke
from polyaxon_tpu_torch import tracking
from polyaxon_tpu_torch.models.transformer import PRESETS
from polyaxon_tpu_torch.ops import flash_attention as fa

run = tracking.init()
cfg = PRESETS[{preset!r}]
B, S, H, KV = 1, {tokens}, cfg["n_heads"], cfg["n_kv_heads"]
D = cfg["dim"] // H
gen = torch.Generator(device="cuda").manual_seed(5)
q, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(torch.bfloat16)
         for _ in range(2))
k, v = (torch.randn((B, S, KV, D), generator=gen, device="cuda").to(torch.bfloat16)
        for _ in range(2))
q, k, v = (t.requires_grad_() for t in (q, k, v))

def kernel():
    o = fa.flash_attention(q, k, v, causal=True)
    return (o, *torch.autograd.grad(o, (q, k, v), do))

def plain():  # the kernels phase's plain forward and backward
    with torch.no_grad():
        o, lse = fa.flash_attention_reference(q, k, v, causal=True)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        return (o, *fa.flash_attention_bwd_reference(q, k, v, o, lse, do, delta, causal=True))

for kern in fa.KERNELS:
    kern.launches = 0
got = kernel()
launches = {{kern.name: kern.launches for kern in fa.KERNELS}}
want = plain()
err = {{name: chip_smoke.row_rel_err(a, b) for name, a, b in zip(("o", "dq", "dk", "dv"), got, want)}}
tol = {{"o": chip_smoke.TOL["bfloat16"][0], "dq": chip_smoke.BWD_TOL["bfloat16"],
        "dk": chip_smoke.BWD_TOL["bfloat16"], "dv": chip_smoke.BWD_TOL["bfloat16"]}}
out = {{**{{f"{{k}}_row_rel_err": e for k, e in err.items()}},
        "ms": chip_smoke.cuda_ms(kernel, reps=10), "plain_ms": chip_smoke.cuda_ms(plain, reps=3),
        **{{f"launches_{{k}}": n for k, n in launches.items()}}}}
run.log_metrics(step=0, **out)
with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
    json.dump({{**out, "tol": tol, "shape": [B, S, H, KV, D]}}, f)
run.log_artifact(f.name, name="flash_check.json")
bad = {{k: e for k, e in err.items() if not e <= tol[k]}}
print(json.dumps({{"tracked": out, "bad": bad}}), flush=True)
sys.exit(1 if bad or launches != {{"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}} else 0)
"""


def _percentiles(xs: list) -> dict:
    from polyaxon_tpu_torch.telemetry import quantile

    return {"p50": quantile(xs, 0.5), "p95": quantile(xs, 0.95)}


def _timed_gets(url: str, n: int) -> dict:
    """p50 and p95 ms of `n` GETs of `url`."""
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        with urllib.request.urlopen(url, timeout=30) as resp:
            resp.read()
        ms.append((time.perf_counter() - t0) * 1e3)
    return _percentiles(ms)


def _until(pred, timeout: float, what: str, poll: float = 0.1):
    """Poll `pred()` until it returns something truthy; that value."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        got = pred()
        if got:
            return got
        time.sleep(poll)
    raise SmokeFailure(f"{what}: not within {timeout} s")


def phase_remote() -> dict:
    """The remote control plane (phase 7g); returns the kernel launches of
    the run POSTed with `run --watch`."""
    import os
    import threading

    from polyaxon_tpu_torch.cli.main import main
    from polyaxon_tpu_torch.client import RunClient
    from polyaxon_tpu_torch.ops.flash_attention import KERNELS
    from polyaxon_tpu_torch.scheduler import Agent
    from polyaxon_tpu_torch.schemas.lifecycle import DONE_STATUSES
    from polyaxon_tpu_torch.schemas.operation import V1Operation
    from polyaxon_tpu_torch.store import RunStore

    t0 = time.perf_counter()
    line: dict = {"phase": "remote", "device": device_line()}
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    with _cli_home("remote") as root:
        home = root / "home"
        store = RunStore(home)
        port = _free_port()
        url = f"http://127.0.0.1:{port}"
        log = ARTIFACTS / "streams_child.log"
        with open(log, "w") as f:
            child = subprocess.Popen(
                [sys.executable, "-m", "polyaxon_tpu_torch", "streams", "start", "--port",
                 str(port)], cwd=HERE, env=dict(os.environ), stdout=f,
                stderr=subprocess.STDOUT)
        stop = threading.Event()
        agent = threading.Thread(target=Agent(store=store).serve,
                                 kwargs={"poll_interval": 0.2, "stop_when": stop.is_set})
        lags: list = []
        watching = threading.Event()

        def watch(cursor):  # a client long-polling the event log as it commits
            while not watching.is_set():
                with urllib.request.urlopen(f"{url}/runs?watch={cursor}&timeout=2",
                                            timeout=30) as resp:
                    got = json.loads(resp.read())
                now = time.time()
                lags.extend(now - e["ts"] for e in got["events"])
                cursor = got["cursor"]

        watcher = None
        try:
            def ready():
                check(child.poll() is None, f"the streams child exited: {log.read_text()}")
                try:
                    return _http(url + "/readyz").get("ready")
                except Exception:  # noqa: BLE001 — not up yet
                    return False

            _until(ready, REMOTE_READY_S, "the streams child")
            line["server_ready_s"] = time.perf_counter() - t0
            agent.start()
            os.environ["POLYAXON_STREAMS_URL"] = url
            spec = root / "cli-lm.yaml"
            spec.write_text(CLI_POLYAXONFILE.format(preset=PRESET, layers=CLI_LAYERS,
                                                    tokens=TRAIN_TOKENS))
            cursor = store.head_cursor()
            watcher = threading.Thread(target=watch, args=(cursor,), daemon=True)
            watcher.start()
            for kern in KERNELS:  # the run POSTed over HTTP starts here
                kern.launches = 0
            t1 = time.perf_counter()
            code, out = _cli(main, ["run", "-f", str(spec), "-P", f"steps={CLI_STEPS}",
                                    "--name", "remote-lm", "--watch"])
            line["run_watch_s"] = time.perf_counter() - t1
            launches = {kern.name: kern.launches for kern in KERNELS}  # ... and ends here
            check(code == 0 and f"created on {url}" in out and "finished: succeeded" in out,
                  f"remote run --watch exited {code}: {out[-2000:]}")
            expected = {k: PER_STEP[k] * CLI_LAYERS * CLI_STEPS for k in PER_STEP}
            line.update({"launches": launches, "expected_launches": expected})
            check(launches == expected, f"remote run launches {launches}, expected {expected}")
            (run,) = store.list_runs()
            uuid = run["uuid"]
            conds = {c["type"]: c["ts"] for c in store.get_status(uuid)["conditions"]}
            summary = next(e for e in store.read_events(uuid) if e["kind"] == "run_summary")
            line.update({"post_to_running_s": conds["running"] - conds["created"],
                         "steps_per_sec": summary["steps_per_sec"]})
            steps = [m["step"] for m in store.read_metrics(uuid) if "loss" in m]
            check(steps == list(range(1, CLI_STEPS + 1)), f"remote run steps {steps}")

            # the ops verbs over HTTP print what they print from the store
            for argv in (["ops", "ls"], ["ops", "metrics", "-uid", uuid[:8]],
                         ["ops", "statuses", "-uid", uuid[:8]],
                         ["ops", "logs", "-uid", uuid[:8]]):
                remote = _cli(main, argv)
                os.environ.pop("POLYAXON_STREAMS_URL")
                local = _cli(main, argv)
                os.environ["POLYAXON_STREAMS_URL"] = url
                check(remote == local and remote[0] == 0,
                      f"{' '.join(argv)} over HTTP {remote} against the store's {local}")
            code, out = _cli(main, ["ops", "get", "-uid", uuid[:8]])
            got = json.loads(out)
            check(code == 0 and got["status"] == json.loads(json.dumps(
                store.get_status(uuid), default=str))
                  and got["metrics_tail"] == store.read_metrics(uuid)[-5:],
                  f"ops get over HTTP: {out[:1000]}")

            # the watch from the cursor before the POST: the transitions
            events = _http(f"{url}/runs?watch={cursor}&timeout=0")["events"]
            seen = [e["status"] if e["kind"] == "status" else e["kind"]
                    for e in events if e.get("r") == uuid and e["kind"] in ("create", "status")]
            want = ["create", *[c["type"] for c in store.get_status(uuid)["conditions"][1:]]]
            check(seen == want and seen[-1] == "succeeded",
                  f"watch transitions {seen}, the store's {want}")
            line["watch_transitions"] = seen
            line["get_metrics_ms"] = _timed_gets(f"{url}/runs/{uuid}/metrics", REMOTE_GETS)
            line["get_status_ms"] = _timed_gets(f"{url}/runs/{uuid}/status", REMOTE_GETS)

            # a long run stopped over HTTP after its first logged step, and a
            # tracked container job queued behind it
            client = RunClient(base_url=url)
            code, out = _cli(main, ["run", "-f", str(spec), "-P", f"steps={REMOTE_LONG_STEPS}",
                                    "--name", "remote-long"])
            check(code == 0 and f"created on {url}" in out, f"remote run: {out}")
            long_run = out.split()[1]
            job = root / "tracked_job.py"
            job.write_text(REMOTE_JOB.format(here=str(HERE), preset=PRESET,
                                             tokens=REMOTE_JOB_TOKENS))
            tracked = client.create(V1Operation.from_dict({
                "version": 1.1, "kind": "operation", "name": "tracked-flash",
                "component": {"kind": "component", "name": "tracked-flash",
                              "termination": {"maxRetries": 0},
                              "run": {"kind": "job", "container": {
                                  "command": [sys.executable, str(job)]}}}}))
            _until(lambda: [m for m in client.metrics(long_run) if "loss" in m],
                   REMOTE_RUN_S, "the long run's first step")
            code, frame = _cli(main, ["top", "--url", url, "--once"])
            check(code == 0 and "remote-long" in frame and "tracked-flash" in frame
                  and "\x1b" not in frame, f"top --once: {frame}")
            line["top_frame"] = frame.splitlines()
            t1 = time.perf_counter()
            code, out = _cli(main, ["ops", "stop", "-uid", long_run])
            check(code == 0, f"ops stop: {out}")
            status = _until(lambda: client.get(long_run)["status"] in DONE_STATUSES
                            and client.get(long_run)["status"], REMOTE_RUN_S, "the stop")
            line["stop_s"] = time.perf_counter() - t1
            done = [m["step"] for m in client.metrics(long_run) if "loss" in m]
            check(status == "stopped" and 0 < len(done) < REMOTE_LONG_STEPS,
                  f"the long run ended {status} after steps {done}")
            line["stopped_after_steps"] = len(done)

            status = client.wait(tracked, timeout=REMOTE_RUN_S, poll=0.2)
            check(status == "succeeded",
                  f"the tracked job ended {status}: {client.logs(tracked)[-3000:]}")
            (metrics,) = client.metrics(tracked)
            dest = root / "flash_check.json"
            check("flash_check.json" in client.artifacts(tracked), "no artifact over HTTP")
            saved = json.loads(Path(client.download_artifact(
                tracked, "flash_check.json", dest)).read_text())
            check(all(saved[k] == metrics[k] for k in saved if k in metrics)
                  and all(saved[f"{k}_row_rel_err"] <= t for k, t in saved["tol"].items()),
                  f"the tracked job's metrics {metrics} and artifact {saved}")
            line["tracked"] = {k: metrics[k] for k in metrics if k not in ("ts", "step")}
            line["tracked_tol"] = saved["tol"]

            # projects, the store's recovery
            for argv, want_out in ((["project", "create", "remote", "--description", "7g"],
                                    "project remote created\n"),
                                   (["store", "recover"], f"recovered {len(store.list_runs())} "
                                                         "run(s)\n")):
                code, out = _cli(main, argv)
                check(code == 0 and out == want_out, f"{argv}: {out}")
            code, out = _cli(main, ["project", "ls"])
            check(code == 0 and out.splitlines()[0].split()[:2] == ["default", "3"]
                  and out.splitlines()[1].startswith("remote"), f"project ls: {out}")
            code, out = _cli(main, ["project", "get", "remote"])
            check(code == 0 and json.loads(out)["description"] == "7g", f"project get: {out}")
        finally:
            watching.set()
            stop.set()
            os.environ.pop("POLYAXON_STREAMS_URL", None)
            if agent.is_alive():
                agent.join(timeout=REMOTE_READY_S)
            if watcher is not None:
                watcher.join(timeout=30)
            _stop_child(child)
        check(bool(lags), "the watcher saw no event")
        line["watch_lag_s"] = {"n": len(lags), "max": max(lags), **_percentiles(lags)}
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    return launches


def pipeline_polyaxonfile() -> dict:
    """The pipeline phase's `dag` operation: 7c's component with the
    learning rate as an input, swept by `search`, then `train-best`."""
    from polyaxon_tpu_torch.polyaxonfile import yaml_lite

    doc = yaml_lite.safe_load(CLI_POLYAXONFILE.format(preset=PRESET, layers=CLI_LAYERS,
                                                      tokens=TRAIN_TOKENS))
    component = doc["component"]
    component["inputs"].append({"name": "lr", "type": "float", "value": PIPELINE_LRS[0]})
    component["run"]["program"]["optimizer"]["learningRate"] = "{{ params.lr }}"
    return {"version": 1.1, "kind": "operation", "name": "pipeline", "component": {
        "kind": "component", "name": "pipeline", "run": {"kind": "dag", "operations": [
            {"name": "search", "component": component, "params": {"steps": CLI_STEPS},
             "matrix": {"kind": "grid", "params": {
                 "lr": {"kind": "choice", "value": list(PIPELINE_LRS)}}}},
            {"name": "train-best", "dependsOn": ["search"], "component": component,
             "params": {"lr": "{{ ops.search.outputs.best.lr }}", "steps": CLI_STEPS}},
        ]}}}


def phase_pipeline() -> dict:
    """A sweep node feeding a training node through the port's DAG (phase
    7e); returns the pipeline's kernel launches."""
    from polyaxon_tpu_torch.cli.main import main
    from polyaxon_tpu_torch.ops.flash_attention import KERNELS
    from polyaxon_tpu_torch.ops.int8_matmul import INT8_MATMUL
    from polyaxon_tpu_torch.runtime.executor import Executor
    from polyaxon_tpu_torch.store import RunStore

    kernels = (*KERNELS, INT8_MATMUL)
    expected = {k: PER_STEP.get(k, 0) * CLI_LAYERS * CLI_STEPS for k in
                (kern.name for kern in kernels)}
    runs: list = []  # (name, kind, launches) of each execution, in order
    execute = Executor.execute

    def counted(self, compiled):  # each run's own launches (they run one at a time)
        before = {kern.name: kern.launches for kern in kernels}
        status = execute(self, compiled)
        runs.append((compiled.name, compiled.run.kind, compiled.run_uuid,
                     {kern.name: kern.launches - before[kern.name] for kern in kernels}))
        return status

    t0 = time.perf_counter()
    with _cli_home("pipeline") as root:
        spec = root / "pipeline.json"
        spec.write_text(json.dumps(pipeline_polyaxonfile(), indent=1))
        Executor.execute = counted
        try:
            for kern in kernels:  # the pipeline starts here
                kern.launches = 0
            t1 = time.perf_counter()
            code, out = _cli(main, ["run", "-f", str(spec)])
            wall = time.perf_counter() - t1
            launches = {kern.name: kern.launches for kern in kernels}  # ... and ends here
        finally:
            Executor.execute = execute
        check(code == 0 and out.rstrip().endswith("finished: V1Statuses.SUCCEEDED"),
              f"the pipeline exited {code}: {out[-2000:]}")
        store = RunStore(root / "home")
        by_name = {r["name"]: r["uuid"] for r in store.list_runs()}
        sweep = by_name["search-sweep"]
        best = next(e for e in store.read_events(sweep)
                    if e["kind"] == "sweep_summary")["best_params"]
        train_best = store.read_spec(by_name["train-best"])["params"]
        check(best is not None and train_best["lr"] == best["lr"],
              f"train-best's lr {train_best.get('lr')}, the sweep's winner {best}")
        trained = [(name, uuid, n) for name, kind, uuid, n in runs if kind == "jaxjob"]
        check(len(trained) == len(PIPELINE_LRS) + 1
              and all(n == expected for _, _, n in trained),
              f"the pipeline's runs launched {trained}, each should launch {expected}")
        node_s = {"search": _run_seconds(store, sweep),
                  "train-best": _run_seconds(store, by_name["train-best"])}
        losses = {uuid: [m["loss"] for m in store.read_metrics(uuid) if "loss" in m][-1]
                  for _, uuid, _ in trained}
        check(all(math.isfinite(v) for v in losses.values()), f"losses {losses}")
        trial_lrs = [store.read_spec(u)["params"]["lr"] for _, u, _ in trained[:-1]]
        run_s = [_run_seconds(store, u) for _, u, _ in trained]
    emit({"phase": "pipeline", "device": device_line(), "lrs": trial_lrs,
          "best_lr": best["lr"], "final_losses": list(losses.values()),
          "wall_s": wall, "node_s": node_s, "run_s": run_s,
          "launches": launches, "per_run": expected,
          "launches_of": "the three training runs, summed; each launched per_run",
          "seconds": time.perf_counter() - t0})
    return launches


def phase_train_resume() -> dict:
    """Checkpoints, preemption and resume (RESUME_CASES); returns the kernel
    launches of the trainers' steps."""
    import shutil

    from polyaxon_tpu_torch.ops.flash_attention import KERNELS

    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(ARTIFACTS).free
    ckpt_bytes = 12 * PRESET_PARAMS  # f32 masters, mu and nu
    # the full-size case holds a local and a durable copy at once
    check(free > 2.2 * ckpt_bytes, f"{free / 1e9:.1f} GB free; train-resume needs "
                                   f"{2.2 * ckpt_bytes / 1e9:.1f}")
    for kern in KERNELS:  # the training path starts here
        kern.launches = 0
    results = [run_resume(case) for case in RESUME_CASES]
    launches = {kern.name: kern.launches for kern in KERNELS}  # ... and ends here
    # serve-run counts its own path (put back around it) and adds it here
    served = [r.pop("serve_run_launches") for r in results if "serve_run_launches" in r]
    check(len(served) == 1, "serve-run did not run")
    # P trains steps 0-2 and R step 3 in each case
    layer_steps = sum(4 * ((c["model"] or {}).get("n_layers") or PRESET_LAYERS)
                      for c in RESUME_CASES)
    expected = {k: PER_STEP[k] * layer_steps for k in PER_STEP}
    emit({"phase": "train-resume", "preset": PRESET, "disk_free_bytes": free,
          "runs": results, "launches": launches, "expected_launches": expected})
    check(launches == expected, f"kernel launches {launches}, expected {expected}")
    emit({"phase": "serve-run-launches", "launches": served[0]})
    return {name: launches.get(name, 0) + served[0][name] for name in served[0]}


def phase_train_rules() -> dict:
    """The remat policies at the preset's width with RULES_LAYERS layers,
    then the five ported optimizers (and adamw) at 2 layers; returns the
    kernel launches."""
    import torch

    from polyaxon_tpu_torch.ops.flash_attention import KERNELS
    from polyaxon_tpu_torch.runtime import Trainer

    base = resume_program(None)
    launches = {kern.name: 0 for kern in KERNELS}
    policies = {}
    cut = {"name": "transformer_lm",
           "config": {**base["model"]["config"], "n_layers": RULES_LAYERS}}
    for policy in ("nothing", "dots", "dots_no_batch"):
        train = {k: v for k, v in base["train"].items() if k != "remat"}
        losses = []
        trainer = Trainer({**base, "model": cut,
                           "train": {**train, "steps": RULES_STEPS, "rematPolicy": policy}},
                          log_fn=lambda step, m: losses.append(m["loss"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in KERNELS:
            kern.launches = 0
        trainer.run()
        torch.cuda.synchronize()
        run_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        got = {kern.name: kern.launches for kern in KERNELS}
        # the peak of a forward and backward alone (the optimizer step's
        # temporaries set the run's peak): what the policy keeps saved
        batch = trainer._to_device(next(trainer.data.iterator))
        for prm in trainer.module.parameters():
            prm.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resting = torch.cuda.memory_allocated()
        trainer._loss(batch, 0)[0].backward()
        torch.cuda.synchronize()
        fwd_bwd_gb = (torch.cuda.max_memory_allocated() - resting) / 1e9
        del batch
        n_layers = trainer.module.cfg.n_layers
        # each step span reads the step before's loss, so after the first
        # (set-up) a span is one step of the device
        spans = [r["dur_s"] for r in trainer.tracer.recent(100) if r["name"] == "step"]
        policies[policy] = {
            "median_step_seconds": statistics.median(spans[1:]),
            "step_spans": spans, "losses": losses,
            "peak_mem_gb": run_peak_gb, "fwd_bwd_peak_above_resting_gb": fwd_bwd_gb,
            "launches_per_layer_step": {k: v / (n_layers * RULES_STEPS) for k, v in got.items()},
        }
        for k, v in got.items():
            launches[k] += v
        check(got == {k: PER_STEP[k] * n_layers * RULES_STEPS for k in PER_STEP},
              f"{policy}: kernel launches {got}")
        check(all(math.isfinite(x) for x in losses), f"{policy}: non-finite loss")
        del trainer
        torch.cuda.empty_cache()
    optimizers = {}
    for name in ("adamw", "lamb", "lion", "adafactor", "rmsprop", "adagrad"):
        model = {**base["model"]["config"], "n_layers": 2}
        trainer = Trainer({**base, "model": {"name": "transformer_lm", "config": model},
                           "optimizer": {**base["optimizer"], "name": name},
                           "train": {**base["train"], "steps": 3}})
        for kern in KERNELS:
            kern.launches = 0
        history = trainer.run().history
        for kern in KERNELS:
            launches[kern.name] += kern.launches
        state = [t for s in trainer.optimizer.state.values() for t in s.values()
                 if isinstance(t, torch.Tensor)]
        optimizers[name] = {
            "losses": [h["loss"] for h in history],
            "state_bytes": sum(t.numel() * t.element_size() for t in state),
        }
        check(len(history) == 3 and all(math.isfinite(h["loss"]) for h in history),
              f"{name}: losses {optimizers[name]['losses']}")
        del trainer
        torch.cuda.empty_cache()
    emit({"phase": "train-rules", "preset": PRESET, "steps": RULES_STEPS,
          "remat_layers": RULES_LAYERS,
          "remat": policies, "optimizers_2_layers": optimizers})
    check(optimizers["adafactor"]["state_bytes"] < 0.01 * optimizers["adamw"]["state_bytes"],
          "adafactor's factored state is not far under adamw's")
    return launches


def zoo_case(case: dict) -> dict:
    """One BASELINE configuration through `Trainer(program).run()` for
    ZOO_STEPS steps; the flash kernels' counts are set to 0 just before the
    run and read just after. Returns its line."""
    import torch

    from polyaxon_tpu_torch.ops.flash_attention import KERNELS
    from polyaxon_tpu_torch.runtime import Trainer

    stamps = []
    program = {**case["program"], "train": {
        **case["program"]["train"], "steps": ZOO_STEPS, "logEvery": 1,
        "profileStart": ZOO_PROFILE_STEP, "profileStop": ZOO_PROFILE_STEP + 1}}
    t0 = time.perf_counter()
    trainer = Trainer(program, artifacts_dir=str(ARTIFACTS / "zoo" / case["tag"]),
                      log_fn=lambda step, m: stamps.append((time.perf_counter(), m)))
    build_s = time.perf_counter() - t0
    stats = {k: v.clone() for k, v in trainer.module.named_buffers() if "running" in k}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in KERNELS:  # this configuration's path starts here
        kern.launches = 0
    t0 = time.perf_counter()
    result = trainer.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in KERNELS}  # ... and ends here
    losses = [h["loss"] for h in result.history]
    # a log point is read one step late, so consecutive reads are one step
    # of the device apart; the first interval holds the first step's set-up
    gaps = [b[0] - a[0] for a, b in zip(stamps, stamps[1:])]
    step_s = statistics.median(gaps[1:])
    batch = trainer.data.batch_size
    meta = trainer.data.meta
    per_example = (meta.get("seq_len") or meta.get("src_len", 0) + meta.get("tgt_len", 0)
                   if case["unit"] == "tokens" else 1)
    moved = [k for k, v in trainer.module.named_buffers()
             if k in stats and not torch.equal(v, stats[k])]
    kernels = device_kernels(trainer.profile)
    busy_ms = sum(_device_time_us(e) for e in kernels) / 1e3
    line = {
        "phase": "train-zoo", "model": case["tag"], "batch": batch,
        "precision": program["train"]["precision"], "steps": ZOO_STEPS,
        "n_params": sum(p.numel() for p in trainer.module.parameters()),
        "losses": losses, "grad_norms": [h["grad_norm"] for h in result.history],
        "accuracy": [h["accuracy"] for h in result.history if "accuracy" in h],
        "median_step_seconds": step_s,
        f"{case['unit']}_per_s": batch * per_example / step_s,
        "data_wait_frac": [h.get("data_wait_frac") for h in result.history],
        "build_seconds": build_s, "run_seconds": run_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "expected_launches": {k: n * ZOO_STEPS for k, n in case["launches"].items()},
        "batch_stats_moved": f"{len(moved)}/{len(stats)}",
        # one profiled step: the device's kernel time against the median step
        "profiled_step_kernel_ms": busy_ms,
        "device_idle_share_vs_median_step": 1 - busy_ms / 1e3 / step_s,
        "profiled_step_launches": sum(e.count for e in kernels),
        "top_kernels": [{"name": e.key[:80], "ms": _device_time_us(e) / 1e3,
                         "count": e.count} for e in kernels[:6]],
    }
    emit(line)
    check(len(losses) == ZOO_STEPS and all(math.isfinite(x) for x in losses),
          f"{case['tag']}: losses {losses}")
    if case["descend"]:  # as the reference's tests require of these models
        check(losses[-1] < losses[0], f"{case['tag']}: the loss did not fall: {losses}")
    want = {k.name: case["launches"].get(k.name, 0) * ZOO_STEPS for k in KERNELS}
    check(launches == want, f"{case['tag']}: kernel launches {launches}, expected {want}")
    check(len(moved) == len(stats), f"{case['tag']}: BatchNorm statistics that did not "
          f"move: {sorted(set(stats) - set(moved))[:5]}")
    if case["tag"] == "resnet50":
        check(len(stats) == 2 * 53, f"resnet50 has {len(stats)} running buffers, not 106")
    ZOO_REFERENCE[case["tag"]] = {
        "losses": losses, "grad_norms": line["grad_norms"], "step_s": step_s,
        "peak_mem_gb": line["peak_mem_gb"],
        "stats": {k: v.detach().cpu().clone() for k, v in trainer.module.named_buffers()
                  if "running" in k},
    }
    del trainer, result
    gc.collect()
    torch.cuda.empty_cache()
    return line


def bert_flash_vs_xla() -> dict:
    """BERT-base's logits with `attention: flash` against `attention: xla`
    (and both against an f32 copy) on the same seeded weights, in bf16,
    outside any counted path."""
    import torch

    from polyaxon_tpu_torch.data import build_data
    from polyaxon_tpu_torch.models import build_model

    tokens = torch.from_numpy(next(build_data(
        "synthetic_mlm", ZOO_BERT_ROWS, {"seq_len": 512, "vocab_size": 30522}).iterator
    )["inputs"]).cuda()
    model = build_model("bert", {"preset": "bert-base", "attention": "xla"},
                        device="cuda", seed=0).module.eval()
    out = {}
    with torch.inference_mode():
        out["f32"] = model(tokens).float()
        model.to(torch.bfloat16)
        out["xla"] = model(tokens).float()
        for mod in model.modules():  # the same bf16 weights through the kernels
            if hasattr(mod, "backend"):
                mod.backend = "flash"
        out["flash"] = model(tokens).float()
    del model
    rel = {f"{a}_vs_{b}": ((out[a] - out[b]).norm() / out[b].norm()).item()
           for a, b in (("flash", "xla"), ("flash", "f32"), ("xla", "f32"))}
    finite = all(torch.isfinite(v).all().item() for v in out.values())
    line = {"phase": "train-zoo-bert-logits", "rows": ZOO_BERT_ROWS, "seq": 512,
            "rel_frobenius": rel, "limit_flash_vs_xla": BERT_FLASH_VS_XLA}
    emit(line)
    check(finite, "non-finite BERT logits")
    check(rel["flash_vs_xla"] <= BERT_FLASH_VS_XLA,
          f"BERT flash logits {rel['flash_vs_xla']} from the einsum path's")
    check(rel["flash_vs_f32"] <= max(FORWARD_REL_SLACK * rel["xla_vs_f32"], FORWARD_REL_FLOOR),
          f"BERT flash logits sit {rel['flash_vs_f32']} from f32, the einsum path "
          f"{rel['xla_vs_f32']}")
    del out, tokens
    torch.cuda.empty_cache()
    return line


def zoo_probe(tag: str, seeds: list, lrs: list) -> None:
    """ZOO_CASES[tag] through zoo_case once for each (seed, learning rate):
    `train.seed` draws both the weights and the stream; no learning rate
    given keeps the case's."""
    case = next(c for c in ZOO_CASES if c["tag"] == tag)
    for seed in seeds:
        for lr in lrs or [case["program"]["optimizer"]["learningRate"]]:
            program = case["program"]
            zoo_case({**case, "program": {
                **program, "optimizer": {**program["optimizer"], "learningRate": lr},
                "train": {**program["train"], "seed": seed}}})


def phase_train_zoo() -> dict:
    """Each ZOO_CASES configuration, then BERT's flash logits against the
    einsum path; returns the kernel launches summed over the runs."""
    launches: dict = {}
    for case in ZOO_CASES:
        for name, n in zoo_case(case)["launches"].items():
            launches[name] = launches.get(name, 0) + n
    bert_flash_vs_xla()
    return launches


def plant_zoo_context_fault(name: str) -> None:
    """Break this process's context path at run time (the code on disk
    stays as it is), for `--zoo-context-faults`:
    local-positions  — every rank adds positions 0..chunk, not its own;
    local-count      — the masked-LM count is this rank's alone (not
                       summed over `context`: the loss about doubles);
    own-chunk-only   — the ring makes no hop: each rank's queries attend
                       its own chunk of keys alone;
    kv-grads-dropped — the ring's backward sends no K/V cotangent back, so
                       a rank's keys miss the other rank's queries'
                       gradient (the reduce-scatter left out)."""
    import torch

    from polyaxon_tpu_torch.models import bert
    from polyaxon_tpu_torch.parallel import collectives, ring
    from polyaxon_tpu_torch.runtime.trainer import Trainer

    if name == "local-positions":
        chunk = bert.sequence_chunk
        bert.sequence_chunk = lambda full, group: slice(0, chunk(full, group).stop
                                                        - chunk(full, group).start)
    elif name == "local-count":
        Trainer._count = lambda self, out, batch: (batch["labels"] != -100).sum().float()
    elif name == "own-chunk-only":
        ring._ring_body_flash = lambda q, k, v, *, group, n, idx, scale, causal: (
            ring.flash_hop(q, k, v, scale=scale, causal=causal)[0].to(q.dtype))
    elif name == "kv-grads-dropped":
        collectives._PPermute.backward = staticmethod(lambda ctx, *grads: (
            None, None, *[None if g is None else torch.zeros_like(g) for g in grads]))
    else:
        raise ValueError(f"unknown fault {name!r}")


def zoo_context_rank(rank: int, port: int, out_path: str, fault: str | None = None) -> int:
    """One rank of train-zoo-context: train-zoo's BERT-base program on
    {context: 2} in a `gloo` world of two processes on the one card; the
    flash counts are set to 0 just before the run and read just after.
    Writes its losses, grad norms, launches and times to `out_path`.
    `fault`: one of ZOO_CONTEXT_FAULTS, planted first."""
    import torch
    import torch.distributed as dist

    from polyaxon_tpu_torch.ops.flash_attention import KERNELS
    from polyaxon_tpu_torch.runtime import Trainer

    if fault:
        plant_zoo_context_fault(fault)

    case = next(c for c in ZOO_CASES if c["tag"] == ZOO_CONTEXT_TAG)
    program = {**case["program"], "train": {**case["program"]["train"],
                                            "steps": ZOO_CONTEXT_STEPS, "logEvery": 1}}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    try:
        stamps = []
        t0 = time.perf_counter()
        trainer = Trainer(program, mesh_axes=ZOO_CONTEXT_AXES,
                          log_fn=lambda step, m: stamps.append(time.perf_counter()))
        build_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        for kern in KERNELS:  # this rank's path starts here
            kern.launches = 0
        t0 = time.perf_counter()
        result = trainer.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {kern.name: kern.launches for kern in KERNELS}  # ... and ends here
        batch = trainer._to_device(next(trainer.data.iterator))["inputs"]
        out = {
            "rank": rank, "losses": [h["loss"] for h in result.history],
            "grad_norms": [h["grad_norm"] for h in result.history],
            "launches": launches, "build_seconds": build_s, "run_seconds": run_s,
            "step_gaps_s": [b - a for a, b in zip(stamps, stamps[1:])],
            "local_tokens_shape": list(batch.shape),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        trainer.close()
    finally:
        dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(out))
    return 0


def _zoo_context_ranks(fault: str | None = None) -> list:
    """Both ranks' results of train-zoo-context (with `fault` planted),
    two processes on the one card, ended in a `finally`."""
    from polyaxon_tpu_torch.native import free_port

    d = ARTIFACTS / "zoo_context" / (fault or "sound")
    d.mkdir(parents=True, exist_ok=True)
    port = free_port()
    procs = []
    try:
        for rank in range(2):
            out = d / f"rank{rank}.json"
            out.unlink(missing_ok=True)
            log = open(d / f"rank{rank}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--zoo-context-rank",
                 str(rank), "--zoo-context-port", str(port), "--zoo-context-out", str(out),
                 *(["--zoo-context-fault", fault] if fault else [])],
                stdout=log, stderr=subprocess.STDOUT, cwd=str(HERE)), log, out))
        deadline = time.perf_counter() + ZOO_CONTEXT_TIMEOUT_S
        codes = []
        for proc, _, _ in procs:
            try:
                codes.append(proc.wait(timeout=max(1.0, deadline - time.perf_counter())))
            except subprocess.TimeoutExpired:
                codes.append(None)
    finally:
        for proc, log, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    tails = [Path(log.name).read_text()[-2000:] for _, log, _ in procs]
    check(codes == [0, 0], f"train-zoo-context ranks exited {codes}: {tails}")
    return [json.loads(out.read_text()) for _, _, out in procs]


def zoo_context_errors(got: dict, ref: dict) -> dict:
    """Rank 0's run against one device's over ZOO_CONTEXT_STEPS steps,
    relative: the worst step's loss and grad norm, and the loss's change
    from the first step to the last (what the updates did)."""
    n = ZOO_CONTEXT_STEPS
    base = {k: ref[k][:n] for k in ("losses", "grad_norms")}
    rel = {key: max(abs(a - b) / abs(b) for a, b in zip(got[series], base[series]))
           for key, series in (("loss", "losses"), ("grad_norm", "grad_norms"))}
    moved, want = (got["losses"][-1] - got["losses"][0],
                   base["losses"][-1] - base["losses"][0])
    rel["loss_change"] = abs(moved - want) / abs(want)
    return rel


def phase_train_zoo_context() -> dict:
    """train-zoo-context (phase 9b); returns both ranks' flash launches."""
    t0 = time.perf_counter()
    ref = ZOO_REFERENCE[ZOO_CONTEXT_TAG]
    case = next(c for c in ZOO_CASES if c["tag"] == ZOO_CONTEXT_TAG)
    ranks = _zoo_context_ranks()
    hops = ZOO_CONTEXT_AXES["context"]  # the ring's hops a layer
    want = {k: case["launches"].get(k, 0) * hops * ZOO_CONTEXT_STEPS
            for k in ranks[0]["launches"]}
    for r in ranks:
        check(r["losses"] == ranks[0]["losses"] and r["grad_norms"] == ranks[0]["grad_norms"],
              f"rank {r['rank']}'s losses differ from rank 0's: {r['losses']}")
        check(r["launches"] == want, f"rank {r['rank']} launched {r['launches']}, "
              f"expected {want} (the ring's {hops} hops a layer)")
    for series in ("losses", "grad_norms"):
        got = ranks[0][series]
        check(len(got) == ZOO_CONTEXT_STEPS and all(math.isfinite(x) for x in got),
              f"train-zoo-context {series}: {got}")
    rel = zoo_context_errors(ranks[0], ref)
    for key, err in rel.items():
        check(err <= ZOO_CONTEXT_TOL[key], f"train-zoo-context {key} {ranks[0]['losses']} "
              f"{ranks[0]['grad_norms']} against one device's: {err:.3g} > "
              f"{ZOO_CONTEXT_TOL[key]}")
    emit({"phase": "train-zoo-context", "device": device_line(), "model": ZOO_CONTEXT_TAG,
          "mesh_axes": ZOO_CONTEXT_AXES, "steps": ZOO_CONTEXT_STEPS,
          "processes": "2 on one card, gloo",
          "local_tokens_shape": ranks[0]["local_tokens_shape"],
          "losses": ranks[0]["losses"], "one_device_losses": ref["losses"][:ZOO_CONTEXT_STEPS],
          "grad_norms": ranks[0]["grad_norms"],
          "one_device_grad_norms": ref["grad_norms"][:ZOO_CONTEXT_STEPS],
          "max_rel": rel, "tol": ZOO_CONTEXT_TOL,
          "launches_per_rank": [r["launches"] for r in ranks], "expected_per_rank": want,
          "seconds_per_step": [r["run_seconds"] / ZOO_CONTEXT_STEPS for r in ranks],
          "rank0_log_gaps_s": ranks[0]["step_gaps_s"],
          "one_device_step_s": ref["step_s"],
          "build_seconds": [r["build_seconds"] for r in ranks],
          "run_seconds": [r["run_seconds"] for r in ranks],
          "peak_mem_gb": [r["peak_mem_gb"] for r in ranks],
          "seconds": time.perf_counter() - t0})
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


def zoo_context_fault_probe() -> None:
    """`--zoo-context-faults`: train-zoo's BERT-base one-device reference,
    then train-zoo-context sound and with each of ZOO_CONTEXT_FAULTS
    planted; one line each of zoo_context_errors against ZOO_CONTEXT_TOL
    (what the limits must pass and what they must catch)."""
    case = next(c for c in ZOO_CASES if c["tag"] == ZOO_CONTEXT_TAG)
    phase_build()
    emit(zoo_case(case))
    ref = ZOO_REFERENCE[ZOO_CONTEXT_TAG]
    for fault in (None, *ZOO_CONTEXT_FAULTS):
        ranks = _zoo_context_ranks(fault)
        rel = zoo_context_errors(ranks[0], ref)
        emit({"phase": "zoo-context-fault", "device": device_line(), "fault": fault or "none",
              "losses": ranks[0]["losses"], "grad_norms": ranks[0]["grad_norms"],
              "one_device_losses": ref["losses"][:ZOO_CONTEXT_STEPS],
              "one_device_grad_norms": ref["grad_norms"][:ZOO_CONTEXT_STEPS],
              "rel": rel, "tol": ZOO_CONTEXT_TOL,
              "caught": sorted(k for k, e in rel.items() if not e <= ZOO_CONTEXT_TOL[k]),
              "launches_per_rank": [r["launches"] for r in ranks]})


def bn_stats_probe() -> dict:
    """ResNet-50's BatchNorm statistics, two ways, on the same activations
    of one train step on a one-rank mesh (ZOO_MESH_AXES): the mesh path's
    `_batch_stats` (global sums over the count) against one device's
    `_fast_stats` (f32 means). Emits, over the 53 BatchNorms, the largest
    difference of the means and of the variances in units of the f32 ulp
    of the larger value."""
    import torch

    from polyaxon_tpu_torch.models import layers
    from polyaxon_tpu_torch.runtime import Trainer

    case = next(c for c in ZOO_CASES if c["tag"] == "resnet50")
    program = {**case["program"], "train": {**case["program"]["train"], "steps": 1}}
    diffs = []
    plain = layers._batch_stats

    from polyaxon_tpu_torch.parallel.ring import current_mesh

    bound = []

    def both(x32):
        bound.append(current_mesh() is not None)
        mean, var = plain(x32)
        fmean, fvar = layers._fast_stats(x32, (0, 2, 3))
        row = {}
        for name, a, b in (("mean", mean, fmean), ("var", var, fvar)):
            a, b = a.detach().float(), b.detach().float()
            ulp = torch.finfo(torch.float32).eps * torch.maximum(a.abs(), b.abs()).clamp_min(
                torch.finfo(torch.float32).tiny)
            row[name] = {"max_abs": float((a - b).abs().max()),
                         "max_ulps": float(((a - b).abs() / ulp).max()),
                         "rel_to_max": float((a - b).abs().max() / b.abs().max())}
        diffs.append(row)
        return mean, var

    one_rank_group()
    layers._batch_stats = both
    try:
        Trainer(program, mesh_axes=dict(ZOO_MESH_AXES)).run()
        torch.cuda.synchronize()
    finally:
        layers._batch_stats = plain
        leave_group()
    line = {"phase": "bn-stats-probe", "device": device_line(), "batchnorms": len(diffs),
            "mesh_path": all(bound),
            **{f"{k}_{m}": max(d[k][m] for d in diffs)
               for k in ("mean", "var") for m in ("max_abs", "max_ulps", "rel_to_max")}}
    emit(line)
    return line


def bn_drift_probe(steps=(2, 3)) -> list:
    """ResNet-50 (train-zoo's configuration) after k steps on one device
    (twice) and on a one-rank mesh (ZOO_MESH_AXES), for each k of `steps`:
    the losses, and the largest relative difference of the parameters and
    of the BatchNorm running statistics from the first run's. The second
    one-device run tells the mesh path's differences from the card's own
    run-to-run ones."""
    import torch

    from polyaxon_tpu_torch.parallel.params import full_tensors
    from polyaxon_tpu_torch.runtime import Trainer

    case = next(c for c in ZOO_CASES if c["tag"] == "resnet50")
    rows = []
    for k in steps:
        program = {**case["program"], "train": {**case["program"]["train"], "steps": k,
                                                "logEvery": 1}}
        out = {}
        for where in ("one", "again", "mesh"):
            if where == "mesh":
                one_rank_group()
            try:
                trainer = Trainer(program, mesh_axes=dict(ZOO_MESH_AXES) if where == "mesh"
                                  else None)
                result = trainer.run()
                params = full_tensors(dict(trainer.module.named_parameters()))
                out[where] = {
                    "losses": [h["loss"] for h in result.history],
                    "params": {n: t.detach().float().clone() for n, t in params.items()},
                    "stats": {n: t.detach().float().clone()
                              for n, t in trainer.module.named_buffers() if "running" in n},
                }
                trainer.close()
                del trainer
            finally:
                if where == "mesh":
                    leave_group()
            gc.collect()
            torch.cuda.empty_cache()

        def rel(a: dict, b: dict) -> float:
            return max(float((a[n] - b[n]).abs().max() / b[n].abs().max().clamp_min(1e-30))
                       for n in b)

        one = out["one"]
        row = {"steps": k, "losses_one": one["losses"]}
        for other in ("again", "mesh"):  # one device twice, then the mesh
            o = out[other]
            moved = sorted(((float((o["params"][n] - t).abs().max()), n)
                            for n, t in one["params"].items()), reverse=True)
            row[other] = {
                "losses": o["losses"],
                "params_rel": rel(o["params"], one["params"]),
                "params_equal": all(torch.equal(o["params"][n], t)
                                    for n, t in one["params"].items()),
                "params_most_moved": [n for d, n in moved[:3] if d > 0],
                "stats_rel": rel(o["stats"], one["stats"]),
                "stats_equal": all(torch.equal(o["stats"][n], t)
                                   for n, t in one["stats"].items())}
        rows.append(row)
    emit({"phase": "bn-drift-probe", "device": device_line(), "rows": rows})
    return rows


def launch_gate_probe(repeats: int) -> list:
    """serve-fast's profiled int8 decode step (profile_fast_step's: the
    int8 module on an int8 pool, B=PROFILE_BATCH at frontier
    PROFILE_SLOTS), `repeats` times: each time the wrapper's launch count
    for the step and the int8 kernels (and all kernels) in its
    torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from polyaxon_tpu_torch.models import build_model
    from polyaxon_tpu_torch.models.generate import make_paged_cache
    from polyaxon_tpu_torch.models.kv_pages import PagedKVLayout
    from polyaxon_tpu_torch.models.quant import quantize_module
    from polyaxon_tpu_torch.ops.int8_matmul import INT8_MATMUL

    with torch.inference_mode():
        model = build_model("transformer_lm", {"preset": PRESET}, device="cuda",
                            dtype=torch.bfloat16, seed=0).module.eval()
        qmodel, _ = quantize_module(model)
        del model
        B, S, dev = PROFILE_BATCH, PROFILE_SLOTS, qmodel.device
        tok = torch.randint(0, qmodel.cfg.vocab_size, (B, 1),
                            generator=torch.Generator().manual_seed(4)).to(dev)
        layout = PagedKVLayout(128, 1 + B * -(-S // 128), kv_quant="int8")
        n_pages = layout.pages_for(S)
        tables = 1 + torch.arange(B * n_pages, device=dev).reshape(B, n_pages)
        pool = make_paged_cache(qmodel, layout)
        pad = torch.zeros(B, dtype=torch.long, device=dev)

        def step():
            return qmodel(tok, cache=pool, pos=S - 1, pad=pad, pages=tables,
                          kv_layout=layout)

        step()
        torch.cuda.synchronize()
        rows = []
        for i in range(repeats):
            before, on_card = INT8_MATMUL.launches, INT8_MATMUL.device_launches()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            kernels = device_kernels(prof)
            rows.append({"repeat": i, "wrapper": INT8_MATMUL.launches - before,
                         "device": INT8_MATMUL.device_launches() - on_card,
                         "profiler_int8": sum(e.count for e in kernels if "int8_" in e.key),
                         "profiler_all": sum(e.count for e in kernels)})
    emit({"phase": "launch-gate-probe", "device": device_line(), "rows": rows})
    return rows


def one_rank_group():
    """A one-rank `nccl` world for a phase on a mesh (the card machine has
    one GPU; the collectives of a size-1 mesh dim are skipped)."""
    import torch.distributed as dist

    from polyaxon_tpu_torch.native import free_port

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)


def leave_group() -> None:
    import torch.distributed as dist

    from polyaxon_tpu_torch.parallel.ring import set_current_mesh

    set_current_mesh(None)
    dist.destroy_process_group()


def zoo_mesh_case(case: dict) -> dict:
    """ZOO_CASES[tag] on ZOO_MESH_AXES (the MoE with an expert axis of 1)
    for ZOO_STEPS steps, against train-zoo's run of it; the flash kernels'
    counts are set to 0 just before the run and read just after."""
    import torch
    from torch.distributed.tensor import DTensor

    from polyaxon_tpu_torch.ops.flash_attention import KERNELS
    from polyaxon_tpu_torch.runtime import Trainer

    ref = ZOO_REFERENCE[case["tag"]]
    program = {**case["program"], "train": {
        **case["program"]["train"], "steps": ZOO_STEPS, "logEvery": 1}}
    axes = dict(ZOO_MESH_AXES)
    if program["model"]["config"].get("n_experts"):
        axes["expert"] = 1
    stamps = []
    trainer = Trainer(program, mesh_axes=axes,
                      log_fn=lambda step, m: stamps.append(time.perf_counter()))
    dtensors = sum(isinstance(p, DTensor) for p in trainer.module.parameters())
    n_params = sum(1 for _ in trainer.module.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in KERNELS:  # this configuration's mesh path starts here
        kern.launches = 0
    result = trainer.run()
    torch.cuda.synchronize()
    launches = {kern.name: kern.launches for kern in KERNELS}  # ... and ends here
    losses = [h["loss"] for h in result.history]
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    step_s = statistics.median(gaps[1:])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    stats = {k: v.detach().cpu() for k, v in trainer.module.named_buffers() if "running" in k}
    stats_rel = max(((stats[k] - v).abs().max() / v.abs().max()).item()
                    for k, v in ref["stats"].items()) if ref["stats"] else 0.0
    tol = ZOO_MESH_TOL[program["train"]["precision"]]
    line = {
        "phase": "train-zoo-mesh", "model": case["tag"], "mesh_axes": axes,
        "backend": "nccl", "steps": ZOO_STEPS, "dtensor_params": f"{dtensors}/{n_params}",
        "losses": losses, "train_zoo_losses": ref["losses"],
        "max_rel_loss_vs_train_zoo": loss_rel,
        "batch_stats": len(stats), "max_rel_batch_stats_vs_train_zoo": stats_rel,
        "tol": tol, "stats_tol": ZOO_MESH_STATS_TOL, "median_step_seconds": step_s,
        "train_zoo_median_step_seconds": ref["step_s"],
        "step_time_vs_train_zoo": step_s / ref["step_s"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "train_zoo_peak_mem_gb": ref["peak_mem_gb"],
        "launches": launches,
    }
    emit(line)
    check(dtensors == n_params, f"{case['tag']}: {dtensors} of {n_params} parameters "
          "are DTensors on the mesh")
    check(len(losses) == ZOO_STEPS and loss_rel <= tol,
          f"{case['tag']} on the mesh: losses {losses} against train-zoo's "
          f"{ref['losses']}: {loss_rel} > {tol}")
    check(set(stats) == set(ref["stats"]) and stats_rel <= ZOO_MESH_STATS_TOL,
          f"{case['tag']} on the mesh: running statistics {stats_rel} from train-zoo's "
          f"(limit {ZOO_MESH_STATS_TOL})")
    want = {k.name: case["launches"].get(k.name, 0) * ZOO_STEPS for k in KERNELS}
    check(launches == want, f"{case['tag']} on the mesh: launches {launches}, "
          f"expected {want}")
    del trainer, result
    gc.collect()
    torch.cuda.empty_cache()
    return line


def phase_train_zoo_mesh() -> dict:
    """Each ZOO_CASES configuration on a one-rank mesh (`zoo_mesh_case`);
    returns the kernel launches summed over the runs."""
    launches: dict = {}
    one_rank_group()
    try:
        for case in ZOO_CASES:
            for name, n in zoo_mesh_case(case)["launches"].items():
                launches[name] = launches.get(name, 0) + n
    finally:
        leave_group()
    return launches


def stacked_state(state: dict, n_layers: int, stages: int) -> dict:
    """A state dict of the block list (`layers.{i}.*`) → the pipelined
    model's (`pipeline.stages.*`, [stages, layers per stage, ...])."""
    import torch

    out = {k: v for k, v in state.items() if not k.startswith("layers.")}
    names = [k.split(".", 2)[2] for k in state if k.startswith("layers.0.")]
    for name in names:
        stack = torch.stack([state[f"layers.{i}.{name}"] for i in range(n_layers)])
        out[f"pipeline.stages.{name}"] = stack.reshape(
            stages, n_layers // stages, *stack.shape[1:])
    return out


def phase_train_stages() -> dict:
    """The train program with STAGES pipeline stages on a one-rank
    {pipeline: 1} mesh, from train's initial weights, against train's
    losses; returns the launches."""
    import torch

    from polyaxon_tpu_torch.models import build_model
    from polyaxon_tpu_torch.ops.flash_attention import KERNELS
    from polyaxon_tpu_torch.runtime import Trainer

    program = json.loads(json.dumps(TRAIN_PROGRAM))
    program["model"]["config"]["pipeline_stages"] = STAGES
    for key in ("profileStart", "profileStop"):
        program["train"].pop(key)
    one_rank_group()
    try:
        stamps = []
        trainer = Trainer(program, mesh_axes=STAGES_MESH_AXES,
                          log_fn=lambda step, m: stamps.append(time.perf_counter()))
        cfg = trainer.module.cfg
        # train's initial weights: its model from the same seed, stacked
        plain = build_model("transformer_lm", TRAIN_PROGRAM["model"]["config"],
                            device="cuda", seed=int(program["train"].get("seed", 0)))
        trainer.load_state_dict(stacked_state(plain.module.state_dict(), cfg.n_layers,
                                              STAGES))
        del plain
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for kern in KERNELS:  # the pipelined path starts here
            kern.launches = 0
        result = trainer.run()
        torch.cuda.synchronize()
        launches = {kern.name: kern.launches for kern in KERNELS}  # ... and ends here
        gaps = [b - a for a, b in zip(stamps, stamps[1:])]
        step_s = statistics.median(gaps[1:])
        losses = [h["loss"] for h in result.history]
        ref = TRAIN_REFERENCE["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        expected = {k: PER_STEP[k] * cfg.n_layers * TRAIN_STEPS for k in PER_STEP}
        stacked = trainer.module.pipeline.stages.attention.q_proj.weight
        emit({
            "phase": "train-stages", "mesh_axes": STAGES_MESH_AXES, "backend": "nccl",
            "pipeline_stages": STAGES, "n_layers": cfg.n_layers,
            "stacked_q_proj": list(stacked.shape), "steps": TRAIN_STEPS,
            "tokens_per_step": TRAIN_TOKENS, "losses": losses, "train_losses": ref,
            "max_rel_loss_vs_train": rel, "tol": TRAIN_MESH_TOL,
            "median_step_seconds": step_s,
            "train_median_step_seconds": TRAIN_REFERENCE["step_s"],
            "step_time_vs_train": step_s / TRAIN_REFERENCE["step_s"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "train_peak_mem_gb": TRAIN_REFERENCE["peak_mem_gb"],
            "launches": launches, "expected_launches": expected,
        })
        check(list(stacked.shape[:2]) == [STAGES, cfg.n_layers // STAGES],
              f"stacked weights {list(stacked.shape)}")
        check(len(losses) == len(ref) and rel <= TRAIN_MESH_TOL,
              f"train-stages losses {losses} against train's {ref}: {rel} > "
              f"{TRAIN_MESH_TOL}")
        check(launches == expected, f"train-stages launches {launches}, expected {expected}")
        del trainer, result
    finally:
        leave_group()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def moe_direct_rows(module, prompts: list, config: dict, new: int) -> tuple:
    """A step config's rows by direct calls, one prompt after the other as
    the server took them: each row's prefix hit (the longest page-aligned
    prefix an earlier row harvested, at most len - 1 tokens), its suffix
    left-padded to its bucket (the server's ladders), the prefill chunks of
    `prefill_chunk_tokens` over that bucket on a table of its pages (the LM
    head on the last chunk only), then one decode step a token at B=1;
    then the row's full prompt pages are copied into fresh pages and
    indexed, as the server's harvest does. Returns the rows and, per row,
    each generated token's top-2 gap (the near-tie rule reads them)."""
    import numpy as np
    import torch

    from polyaxon_tpu_torch.models.generate import copy_pool_pages, make_paged_cache
    from polyaxon_tpu_torch.models.kv_pages import PagedKVLayout
    from polyaxon_tpu_torch.serving.batching import ServingConfig, choose_buckets

    cfg = ServingConfig(**SERVE_BASE, **config)
    seq_len = module.cfg.seq_len
    prompt_ladder, new_ladder = cfg.ladders(seq_len)
    pt = cfg.kv_page_tokens
    layout = PagedKVLayout(pt, MOE_POOL_PAGES, kv_quant=cfg.kv_quant)
    cache = make_paged_cache(module, layout)
    free = list(range(1, MOE_POOL_PAGES))
    cached: dict = {}  # a page-aligned prompt prefix → its pages
    dev = module.device

    def long(x):
        return torch.as_tensor(x, dtype=torch.long, device=dev)

    rows, gaps = [], []
    for p in prompts:
        L, ppages = 0, ()
        for j in range((len(p) - 1) // pt, 0, -1):
            if tuple(p[:j * pt]) in cached:
                L, ppages = j * pt, cached[tuple(p[:j * pt])]
                break
        sfx = p[L:]
        pb, nb = choose_buckets(len(sfx), new, prompt_ladder, new_ladder, seq_len - L)
        pad = pb - len(sfx)
        own = [free.pop(0) for _ in range(layout.pages_for(L + pb + nb - 1) - L // pt)]
        table = [*ppages, *own]
        kw = dict(cache=cache, pad=long([pad]), pages=long([table]), kv_layout=layout,
                  prefix_lens=long([L]))
        arr = [0] * pad + sfx
        width = min(max(1, cfg.prefill_chunk_tokens), pb)
        for off in range(0, pb, width):
            chunk = long([arr[off:off + width]])
            if off + width < pb:
                module(chunk, return_features=True, pos=L + off, **kw)
            else:
                logits = module(chunk, pos=L + off, **kw)[0, -1].float()
        row, gap, pos = list(p), [], L + pb
        for g in range(new):
            gap.append(top2_gap(logits))
            row.append(int(logits.argmax()))
            if g + 1 < new:
                logits = module(long([[row[-1]]]), pos=np.asarray([pos]), **kw)[0, -1].float()
                pos += 1
        rows.append(row)
        gaps.append(gap)
        k, lp = len(p) // pt, L // pt
        if k > lp and tuple(p[:k * pt]) not in cached:
            new_ids = [free.pop(0) for _ in range(k - lp)]
            copy_pool_pages(cache, table_row=table, start=L + pad, count=(k - lp) * pt,
                            new_ids=new_ids, page_tokens=pt)
            for j in range(lp + 1, k + 1):
                cached.setdefault(tuple(p[:j * pt]), (*ppages, *new_ids[:j - lp]))
    del cache
    return rows, gaps


def moe_spec_direct(module, prompt: list) -> list:
    """The speculative coalescer's row for `prompt` by a direct
    spec_generate: the prompt left-padded to its bucket, as the dense group
    of one row runs it."""
    import numpy as np

    from polyaxon_tpu_torch.models.spec_decode import spec_generate
    from polyaxon_tpu_torch.serving.batching import ServingConfig, choose_buckets

    cfg = ServingConfig(**SERVE_BASE, **MOE_CONFIGS["spec"])
    seq_len = module.cfg.seq_len
    pb, _ = choose_buckets(len(prompt), MOE_SPEC_NEW, *cfg.ladders(seq_len), seq_len)
    arr = np.zeros((1, pb), np.int64)
    arr[0, pb - len(prompt):] = prompt
    out = spec_generate(module, arr, max_new_tokens=MOE_SPEC_NEW,
                        draft_tokens=cfg.draft_tokens, prompt_lengths=[len(prompt)])
    return out[0, pb - len(prompt):].tolist()


def serve_moe_config(model, name: str, prompts: list, new: int, kernels) -> dict:
    """One MoE server config: `prompts` posted one at a time (the kernel
    counts zeroed before and read after), /statsz, no page leaked. Returns
    the rows, the stats, the wall seconds, the launches, the forwards run
    (prefill chunks and decode steps) and the server (stopped)."""
    import torch

    from polyaxon_tpu_torch.ops.int8_matmul import INT8_MATMUL
    from polyaxon_tpu_torch.serving.batching import ServingConfig
    from polyaxon_tpu_torch.serving.server import ModelServer

    server = ModelServer(model, None, ServingConfig(**SERVE_BASE, **MOE_CONFIGS[name]),
                         model_name=PRESET, device=model.device)
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    try:
        torch.cuda.synchronize()
        for kern in kernels:  # this config's served path starts here
            kern.launches = 0
        on_card = INT8_MATMUL.device_launches()
        t0 = time.perf_counter()
        rows = [_http(url + "/generate", {"tokens": [p], "maxNewTokens": new})["tokens"][0]
                for p in prompts]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {kern.name: kern.launches for kern in kernels}  # ... and ends here
        device_int8 = INT8_MATMUL.device_launches() - on_card
        steps = server._m_decode_step.summary()["count"]
        stats = _http(url + "/statsz")
    finally:
        server.stop()
    kv = server.stats()["kv"]
    if kv["enabled"]:
        check(kv["active_rows"] == 0 and kv["pages_reserved"] == 0
              and kv["pages_used"] == 1 + kv["prefix"]["held_pages"],
              f"serve-moe {name}: pages leaked: {kv}")
    for p, row in zip(prompts, rows):
        check(len(row) == len(p) + new, f"serve-moe {name}: a row of {len(row)} tokens")
    chunks = stats["chunked"]["prefill_chunks"] if stats["chunked"]["enabled"] else 0
    return {"rows": rows, "stats": stats, "wall": wall, "launches": launches,
            "device_int8": device_int8, "forwards": chunks + steps, "steps": steps,
            "server": server}


def profile_moe_step(model) -> None:
    """One paged decode step of the MoE model at B=PROFILE_BATCH, each
    row's frontier at PROFILE_SLOTS - 1, as profile_decode_step profiles
    the dense model's: where a step's time goes (device ops, idle share)."""
    import torch

    from polyaxon_tpu_torch.models.generate import make_paged_cache
    from polyaxon_tpu_torch.models.kv_pages import PagedKVLayout

    B, S, dev = PROFILE_BATCH, PROFILE_SLOTS, model.device
    gen = torch.Generator().manual_seed(4)
    tok = torch.randint(0, model.cfg.vocab_size, (B, 1), generator=gen).to(dev)
    pad = torch.zeros(B, dtype=torch.long, device=dev)
    layout = PagedKVLayout(128, 1 + B * -(-S // 128))
    n_pages = layout.pages_for(S)
    tables = 1 + torch.arange(B * n_pages, device=dev).reshape(B, n_pages)
    pool = make_paged_cache(model, layout)
    profile_step(lambda: model(tok, cache=pool, pos=S - 1, pad=pad, pages=tables,
                               kv_layout=layout),
                 {"phase": "serve-moe-profile", "batch": B, "frontier": S,
                  "window_slots": n_pages * layout.page_tokens,
                  "expert_bytes_a_step": sum(
                      p.numel() * p.element_size() for n, p in model.named_parameters()
                      if n.endswith("_kernel"))})
    del pool
    torch.cuda.empty_cache()


def phase_serve_moe(kernels) -> dict:
    """serve-moe (see MOE_MODEL): the step and int8 waves and the
    speculative rows on the MoE model, each row held against its direct
    call under the near-tie rule; returns the served paths' launches."""
    import torch

    from polyaxon_tpu_torch.models import build_model
    from polyaxon_tpu_torch.models.quant import decode_weight_bytes, quantize_module

    t0 = time.perf_counter()
    model = build_model("transformer_lm", MOE_MODEL, device="cuda", dtype=torch.bfloat16,
                        seed=0).module.eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    _, bf16_bytes = decode_weight_bytes(model)
    built_s = time.perf_counter() - t0
    wave = serve_traffic(model.cfg.vocab_size)[0]
    launches = {kern.name: 0 for kern in kernels}
    lines = {}
    for name in ("step", "int8"):
        served = serve_moe_config(model, name, wave, MOE_NEW, kernels)
        for k, n in served["launches"].items():
            launches[k] += n
        module = served["server"].module
        _, served_bytes = decode_weight_bytes(module)
        del served["server"], module
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        if name == "int8":
            direct_module = quantize_module(model)[0]
        else:
            direct_module = model
        ref, gaps = moe_direct_rows(direct_module, wave, MOE_CONFIGS[name], MOE_NEW)
        del direct_module
        torch.cuda.empty_cache()
        direct_s = time.perf_counter() - t1
        divergences = []
        for i, (p, got) in enumerate(zip(wave, served["rows"])):
            d = compare_rows(model, got, ref[i], len(p), gaps=gaps[i])
            if d is not None:
                divergences.append({"row": i, **d})
        stats = served["stats"]
        per_forward = MOE_INT8_PER_LAYER * model.cfg.n_layers
        line = {
            "phase": "serve-moe", "config": name, "device": device_line(),
            "n_experts": model.cfg.n_experts, "capacity_factor": model.cfg.capacity_factor,
            "n_layers": model.cfg.n_layers, "params": n_params,
            "weight_bytes": bf16_bytes, "served_weight_bytes": served_bytes,
            "requests": len(wave), "new_tokens": MOE_NEW,
            "prompt_lens": [len(p) for p in wave], "posted": "one at a time",
            "wall_seconds": served["wall"],
            "decode_tokens_per_s": MOE_NEW * len(wave) / served["wall"],
            "ttft_ms_p50": stats["ttft_ms"]["p50"], "ttft_ms_p95": stats["ttft_ms"]["p95"],
            "decode_step_ms_p50": stats["decode_step_ms"]["p50"],
            "decode_steps": served["steps"], "forwards": served["forwards"],
            "prefill_chunks": stats["chunked"]["prefill_chunks"],
            "prefix_hits": stats["kv"]["prefix"]["hits"],
            "rows_diverged": len(divergences), "divergences": divergences,
            "direct_seconds": direct_s, "launches": served["launches"],
            "int8_device_launches": served["device_int8"],
            "int8_launches_per_forward": (served["device_int8"] / served["forwards"]
                                          if name == "int8" else 0),
        }
        emit(line)
        lines[name] = line
        check(stats["kv"]["prefix"]["hits"] >= 3, f"serve-moe {name}: the shared prefix "
              f"was hit {stats['kv']['prefix']['hits']} times, not 3")
        if name == "int8":
            want = per_forward * served["forwards"]
            check(served["launches"]["int8_matmul"] == want and served["device_int8"] == want,
                  f"serve-moe int8: {served['launches']['int8_matmul']} int8 launches "
                  f"(the card ran {served['device_int8']}) in {served['forwards']} forwards, "
                  f"not {per_forward} a forward")
            check(served_bytes < bf16_bytes, "serve-moe int8: the weights did not shrink")
        del served
    spec = serve_moe_config(model, "spec", [wave[i] for i in MOE_SPEC_PROMPTS], MOE_SPEC_NEW,
                            kernels)
    for k, n in spec["launches"].items():
        launches[k] += n
    del spec["server"]
    divergences = []
    for i, got in zip(MOE_SPEC_PROMPTS, spec["rows"]):
        d = compare_rows(model, got, moe_spec_direct(model, wave[i]), len(wave[i]))
        if d is not None:
            divergences.append({"row": i, **d})
    sp = spec["stats"]["speculation"]
    emit({"phase": "serve-moe", "config": "spec", "device": device_line(),
          "rows": len(MOE_SPEC_PROMPTS), "new_tokens": MOE_SPEC_NEW,
          "draft_tokens": MOE_CONFIGS["spec"]["draft_tokens"], "proposed": sp["proposed"],
          "accepted": sp["accepted"], "accept_rate": sp["accept_rate"],
          "wall_seconds": spec["wall"], "rows_diverged": len(divergences),
          "divergences": divergences, "build_seconds": built_s})
    check(sp["proposed"] > 0, "serve-moe spec: no draft was proposed")
    profile_moe_step(model)
    del model, spec
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train_scan() -> dict:
    """train-scan (see SCAN_GRAD_NORM_TOL): the train program at
    RULES_LAYERS layers, unscanned then scanned from the same initial
    weights; then both modules (bf16, the scanned one's weights stacked
    from the other's) serve SCAN_SERVE_PROMPTS on the step config. Returns
    the scanned run's launches."""
    import torch

    from polyaxon_tpu_torch.models import build_model
    from polyaxon_tpu_torch.models.transformer import stack_layers
    from polyaxon_tpu_torch.ops.flash_attention import KERNELS
    from polyaxon_tpu_torch.runtime import Trainer

    program = resume_program(None, {"n_layers": RULES_LAYERS})
    scan_program = resume_program(None, {"n_layers": RULES_LAYERS, "scan_layers": True})
    plain = Trainer(program)
    init = {k: v.detach().clone() for k, v in plain.module.state_dict().items()}
    ref = plain.run().history
    final = {k: v.detach().clone() for k, v in plain.module.state_dict().items()}
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    scanned = Trainer(scan_program)
    scanned.load_state_dict(stack_layers(init, RULES_LAYERS))
    del init
    torch.cuda.synchronize()
    for kern in KERNELS:  # the scanned training path starts here
        kern.launches = 0
    got = scanned.run().history
    torch.cuda.synchronize()
    launches = {kern.name: kern.launches for kern in KERNELS}  # ... and ends here
    stacked = list(scanned.module.scan.block.attention.q_proj.weight.shape)
    del scanned
    gc.collect()
    torch.cuda.empty_cache()
    losses, ref_losses = [h["loss"] for h in got], [h["loss"] for h in ref]
    norm_rel = max(abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
                   for a, b in zip(got, ref))
    steps = len(ref)
    expected = {k: PER_STEP[k] * RULES_LAYERS * steps for k in PER_STEP}
    # serving: the unscanned module with the trained weights, and the
    # scanned one holding them stacked, on the step config
    config = {"n_layers": RULES_LAYERS, "attention": "flash"}
    flat = build_model("transformer_lm", {"preset": PRESET, **config}, device="cuda",
                       dtype=torch.bfloat16, seed=0).module.eval()
    flat.load_state_dict(final)
    stack = build_model("transformer_lm", {"preset": PRESET, **config, "scan_layers": True},
                        device="cuda", dtype=torch.bfloat16, seed=0).module.eval()
    stack.load_state_dict(stack_layers(final, RULES_LAYERS))
    del final
    prompts = [serve_traffic(flat.cfg.vocab_size)[0][i] for i in SCAN_SERVE_PROMPTS]
    rows = {}
    with torch.inference_mode():
        for tag, module in (("unscanned", flat), ("scanned", stack)):
            server = step_server(module)
            url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
            try:
                rows[tag] = [_http(url + "/generate", {"tokens": [p], "maxNewTokens":
                                                       SCAN_SERVE_NEW})["tokens"][0]
                             for p in prompts]
            finally:
                server.stop()
    del flat, stack
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train-scan", "device": device_line(), "n_layers": RULES_LAYERS,
          "stacked_q_proj": stacked, "steps": steps, "tokens_per_step": TRAIN_TOKENS,
          "losses": losses, "unscanned_losses": ref_losses,
          "losses_bitwise_equal": losses == ref_losses,
          "max_rel_grad_norm": norm_rel, "grad_norm_tol": SCAN_GRAD_NORM_TOL,
          "launches": launches, "expected_launches": expected,
          "served_rows_equal": rows["scanned"] == rows["unscanned"]})
    check(stacked[0] == RULES_LAYERS, f"scanned q_proj {stacked}")
    check(losses == ref_losses, f"train-scan losses {losses} differ from the unscanned "
          f"run's {ref_losses}")
    check(norm_rel <= SCAN_GRAD_NORM_TOL, f"train-scan grad_norm off by {norm_rel}")
    check(launches == expected, f"train-scan launches {launches}, expected {expected}")
    check(rows["scanned"] == rows["unscanned"],
          "the scanned module's served rows differ from the unscanned module's")
    return launches


def step_server(module):
    """A step-config server of `module` on its device."""
    from polyaxon_tpu_torch.serving.batching import ServingConfig
    from polyaxon_tpu_torch.serving.server import ModelServer

    return ModelServer(module, None, ServingConfig(**SERVE_BASE, **SERVE_CONFIGS["step"]),
                       model_name=PRESET, device=module.device)


def max_abs_err(row: dict) -> float:
    """A kernel row's max |kernel - plain|: its own, the forward's o, or the
    largest of the backward's outputs."""
    if "max_abs_err" in row:
        return row["max_abs_err"]
    if "max_abs_err_o" in row:
        return row["max_abs_err_o"]
    return max(v for k, v in row.items() if k.startswith("max_abs_err_"))


def device_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def main(argv: list) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch port")
    parser.add_argument("--zoo", choices=[c["tag"] for c in ZOO_CASES],
                        help="run this train-zoo configuration alone")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--lrs", type=float, nargs="+", default=[])
    parser.add_argument("--launch-gate", type=int, default=0, metavar="N",
                        help="profile serve-fast's int8 decode step N times, logging "
                             "the wrapper's and the profiler's int8 launch counts")
    parser.add_argument("--serve-mesh-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--serve-mesh-port", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--serve-mesh-spec", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--serve-mesh-out", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--zoo-context-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--zoo-context-port", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--zoo-context-out", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--zoo-context-fault", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--zoo-context-faults", action="store_true",
                        help="train-zoo-context sound and with each planted fault, "
                             "against one device's BERT-base run")
    parser.add_argument("--bn-stats", action="store_true",
                        help="ResNet-50's BatchNorm statistics, mesh path against "
                             "one device's, on one step's activations")
    args = parser.parse_args(argv)

    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import polyaxon_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 2
    if Path(polyaxon_tpu_torch.__file__).resolve().parent.parent != HERE:
        print("chip_smoke: polyaxon_tpu_torch imported from outside this checkout",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False

    if args.zoo:
        zoo_probe(args.zoo, args.seeds, args.lrs)
        print(device_line(), flush=True)
        return 0
    if args.serve_mesh_rank is not None:  # a process of serve-mesh (b)
        return mesh_b_rank(args.serve_mesh_rank, args.serve_mesh_port, args.serve_mesh_spec,
                           args.serve_mesh_out)
    if args.zoo_context_rank is not None:  # a process of train-zoo-context
        return zoo_context_rank(args.zoo_context_rank, args.zoo_context_port,
                                args.zoo_context_out, args.zoo_context_fault)
    if args.zoo_context_faults:
        zoo_context_fault_probe()
        print(device_line(), flush=True)
        return 0
    if args.launch_gate or args.bn_stats:
        if args.launch_gate:
            phase_build()
            launch_gate_probe(args.launch_gate)
        if args.bn_stats:
            bn_stats_probe()
            bn_drift_probe()
        print(device_line(), flush=True)
        return 0

    from polyaxon_tpu_torch.models import build_model
    from polyaxon_tpu_torch.ops.flash_attention import KERNELS as FLASH_KERNELS
    from polyaxon_tpu_torch.ops.int8_matmul import INT8_MATMUL

    KERNELS = (*FLASH_KERNELS, INT8_MATMUL)
    phase_s: dict = {}
    t_last = [t_start]

    def stamp(name: str) -> None:  # seconds since the stamp before
        now = time.perf_counter()
        phase_s[name] = now - t_last[0]
        t_last[0] = now

    phase_build()
    rows = {"flash_fwd": phase_kernels(), **phase_backward_kernels(),
            "int8_matmul": phase_int8_kernel()}
    phase_autograd_chain()
    stamp("build+kernels")
    launches_ring = phase_ring_hops(KERNELS)
    stamp("ring-hops")
    with torch.inference_mode():
        model = build_model(
            "transformer_lm", {"preset": PRESET, "attention": "flash"},
            device="cuda", dtype=torch.bfloat16, seed=0,
        ).module.eval()
        warm = torch.zeros((1, FORWARD_TOKENS), dtype=torch.long, device="cuda")
        model(warm)  # first-call set-up (cuBLAS handles, allocator) outside the count
        torch.cuda.synchronize()
        for kern in KERNELS:  # the inference path starts here
            kern.launches = 0
        phase_forward(model)
        phase_serve(model)
        launches = {kern.name: kern.launches for kern in KERNELS}  # ... and ends here
        for name, n in launches_ring.items():
            launches[name] += n
        for kern in KERNELS:  # the batched serving path starts here
            kern.launches = 0
        batched = phase_serve_batched(model)
        served = {kern.name: kern.launches for kern in KERNELS}  # ... and ends here
        # decode and paged prefill attend by einsum (as the reference's
        # XLA decode does): no kernel of the port lies on this path
        emit({"phase": "serve-batched-launches", "launches": served})
        for name, n in served.items():
            launches[name] += n
        stamp("forward+serve+serve-batched")
        for kern in KERNELS:  # the fast decode path starts here
            kern.launches = 0
        qmodel, int8_answers = phase_serve_fast(model, batched)
        fast = {kern.name: kern.launches for kern in KERNELS}  # ... and ends here
        # every int8 projection of the int8 config (prefill and decode)
        emit({"phase": "serve-fast-launches", "launches": fast})
        check(fast["int8_matmul"] > 0, "the int8 config never launched int8_matmul")
        for name, n in fast.items():
            launches[name] += n
        check_int8_rows(qmodel, batched["waves"], int8_answers)
        int8_teacher_forced(model, qmodel)
        del qmodel
        torch.cuda.empty_cache()
        stamp("serve-fast")
        mesh = phase_serve_mesh(model, batched, int8_answers, KERNELS)
        emit({"phase": "serve-mesh-launches", "launches": mesh})
        check(mesh["int8_matmul"] > 0, "serve-mesh never launched int8_matmul")
        for name, n in mesh.items():
            launches[name] += n
        del batched, model, warm
        torch.cuda.empty_cache()
        stamp("serve-mesh")
        # the fleet at the preset's width with FLEET_LAYERS layers (a cut)
        fmodel = build_model(
            "transformer_lm", {"preset": PRESET, "attention": "flash",
                               "n_layers": FLEET_LAYERS},
            device="cuda", dtype=torch.bfloat16, seed=0,
        ).module.eval()
        for name, config in FLEET_CONFIGS.items():
            # the counts are set to 0 and read around each drive, in the phase
            fleet = phase_serve_fleet(fmodel, name, KERNELS)
            emit({"phase": "serve-fleet-launches", "config": name, **fleet["launches"]})
            if config.get("quantize"):  # the prefill and decode replicas' projections
                check(fleet["launches"]["routed"]["int8_matmul"] > 0,
                      f"{name}: the routed replicas never launched int8_matmul")
            for counts in fleet["launches"].values():
                for kname, n in counts.items():
                    launches[kname] += n
            check_fleet_rows(fleet)
            del fleet
            gc.collect()
        del fmodel
        torch.cuda.empty_cache()
        stamp("serve-fleet")
        phase_lora_card()  # the plain pieces, before the path is counted
        lmodel = build_model(
            "transformer_lm", {"preset": PRESET, "attention": "flash",
                               "lora_rank": TENANT_RANK},
            device="cuda", dtype=torch.bfloat16, seed=0,
        ).module.eval()
        for kern in KERNELS:  # the multi-tenant path starts here
            kern.launches = 0
        served = phase_serve_tenants(lmodel)
        tenants = {kern.name: kern.launches for kern in KERNELS}  # ... and ends here
        # the int8 config's projections (prefill and decode) with adapters
        emit({"phase": "serve-tenants-launches", "launches": tenants})
        check(tenants["int8_matmul"] > 0, "tenants-int8 never launched int8_matmul")
        for name, n in tenants.items():
            launches[name] += n
        check_tenant_rows(served)
        profile_tenant_step(lmodel, {name: out["module"] for name, out in served.items()})
        del lmodel, served
        gc.collect()
        torch.cuda.empty_cache()
        stamp("serve-tenants")
        # the MoE model on the batched paths: each config's counts are set to
        # 0 and read around its served requests, in the phase
        moe = phase_serve_moe(KERNELS)
        emit({"phase": "serve-moe-launches", "launches": moe})
        check(moe["int8_matmul"] > 0, "serve-moe never launched int8_matmul")
        for name, n in moe.items():
            launches[name] += n
    torch.cuda.empty_cache()
    stamp("serve-moe")
    check(launches["flash_fwd"] > 0, "the inference path never launched flash_fwd")
    for name, n in phase_train().items():
        launches[name] += n
    stamp("train")
    for name, n in phase_train_mesh().items():
        launches[name] += n
    stamp("train-mesh")
    for name, n in phase_train_stages().items():
        launches[name] += n
    stamp("train-stages")
    for name, n in phase_train_scan().items():
        launches[name] += n
    stamp("train-scan")
    phase_train_vs_einsum()
    stamp("train-vs-einsum")
    for phase, tag in ((phase_train_resume, "train-resume"), (phase_cli, "cli"),
                       (phase_sweep, "sweep"), (phase_pipeline, "pipeline"),
                       (phase_sched, "sched"), (phase_remote, "remote"),
                       (phase_train_rules, "train-rules"), (phase_train_zoo, "train-zoo"),
                       (phase_train_zoo_context, "train-zoo-context"),
                       (phase_train_zoo_mesh, "train-zoo-mesh")):
        for name, n in phase().items():
            launches[name] += n
        stamp(tag)
    check(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start, "phases": phase_s})
    emit({"kernels": [
        {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max_abs_err(rows[name]),
            "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
            "bound_ms": rows[name]["bound_ms"], "bound_by": rows[name]["bound_by"],
            "library_ms": rows[name]["library_ms"],
        }
        for name, (src, replaces) in KERNEL_ROWS.items()
    ]})
    print(device_line(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
