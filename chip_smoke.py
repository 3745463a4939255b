#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100: the serve lane, training, the
learn->AP loop, the accuracy tiers of inference, serving beyond one
batcher (replica pool, cascade, process router), live video streams
with the run telemetry, multi-card training, height-sharded inference,
the tools that measure the port, and the training tools and model I/O.

    python3 chip_smoke.py

Run from the root of a checkout.  The phases print in this order, and any
failed phase ends the run with a non-zero exit code:

1. card: ``nvidia-smi`` name and power limit, the device name, and a check
   that the card is Hopper (compute capability 9.0);
2. build: ``nvcc`` builds every kernel of ``improved_body_parts_torch/csrc``
   for sm_90a (set-up time);
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card.  The decode kernels at the serve lane's shapes (batch 8,
   640x896 maps, 18 keypoint channels, K=64, 30 limbs, M=128) with planted
   sparse peaks, and on dense noise that takes topk_peaks' rare paths (a
   band that keeps more than K, a channel that keeps more than the select
   block's buffer) and gives limb_pair_stats segments of all 20 samples,
   and at the sizes the lane does not compile for (17 channels, radius 1,
   12 samples): integer outputs exactly, topk_peaks' and limb_pair_stats'
   floats bit for bit.  All three decode kernels again, bit for bit, at
   the batcher's other shapes on planted people: batch 1 of 640x896 and
   of 640x512 (its singleton flushes of either bucket) and batch 8 of
   640x512.  The fused greedy assembly on the lane's planted
   peaks and candidates and on random dense records (K=64, M=128, 30
   limbs), at p_max 32, 1 (a full table) and 64 and with remove_recon 1:
   every field bit for bit, with the longest chain's walk steps and
   connections.  The focal-loss kernels at the canonical training shapes
   (4 stacks, batch 4, the 5 scales 128^2..8^2, 50 channels) on sparse GT
   and on a case planted on the kink: the forward within rel 1e-5 and the
   same bits in two runs, the backward bit for bit.  Median times of
   kernel (CUDA events around the wrapper call) and plain version, and
   each kernel's device time apart from its wrapper (torch.profiler over
   20 calls; topk_peaks by pass, beside what reading its maps' slices
   alone takes; focal_fwd by scale);
4. planted serve: a stub network that returns planted people's maps, a few
   requests of different sizes through ``Predictor.predict_decoded_batch``
   and ``decode_device``; every planted person decodes, keypoints within
   1 px, and the fused assembly kernel launched;
5. full width: the ``canonical`` IMHN (4 stacks, 128,998,760 parameters)
   from a seeded init in bf16 autocast, ``predict_decoded_batch`` on 8
   images of 480x640 (the 640x896 bucket).  The decode kernels' launch
   counters are set to 0 just before this run and read just after; every
   decode kernel must have launched.  Then ``predict_decoded_batch_async``
   must return with its device work still queued (an event recorded as
   it returns has not completed): no read back to the host before
   ``resolve()``;

Between phases 5 and 6, the batcher (``serve.DynamicBatcher``, the
entry point users serve through): on phase 4's planted maps, 12
requests from 3 client threads over two buckets through the fused lane
(every planted person within 1 px, ``decode_fused`` 12, every decode
kernel launched), then each fallback level forced: a 2-person table
under 3 people (host ``decode_compact`` of the compact records, with the
native decoder) and top-K 2 (``predict_fast``'s full maps); then at full
width on phase 5's ``canonical`` model: warmup of the 640x896 and
640x512 buckets, 64 requests from 4 threads (max_batch 8, max_wait_ms
25, max_queue 64) with the decode kernels' counters set to 0 just before
and read just after (each must have launched), 0 failed or rejected,
a request record (``obs.reqtrace``, every request sampled) with the five
hops for each request, and the hops of all requests summing to their
e2e latencies within 1 us; it prints imgs/s, p50/p99 e2e, mean
occupancy, each hop's p50 and the dispatcher's host ms per batch; then
8 requests through the host-pool lane (``device_decode=False``).  What
the batcher's threads left on the card (their cuBLAS workspaces) is
released before phase 6, so phase 6's peak memory is its own;

6. training at full width: ``canonical`` in train mode from a seeded init,
   bf16 autocast, SGD; drawn synthetic people through the port's
   ``Transformer`` + ``Heatmapper`` (augmented, 512x512, batch 4, uint8
   wire) into ``make_train_step`` + ``train_epoch``: 2 warm-up steps, then
   10 timed steps with the focal kernels' counters set to 0 just before
   and read just after (5 launches a step each).  Losses finite, params
   and BN running stats moved, every step counted;
7. learn->AP at full width: the protocol of ``cli.synth_ap`` at
   ``CANONICAL_TRAIN.json``'s settings (``synth_canonical``: the flagship
   IMHN, 128,998,760 parameters, remat on, bf16 autocast; 32 drawn
   training images on a 288x384 canvas at a 192x192 input, batch 2, 18
   epochs, seed 0; 12 held-out val images, seed 12345), in this process
   and through the CLIs' own functions: the card machine has no h5py, so
   the training records stay in memory (``data.fixture.fixture_records`` +
   ``data.MemoryDataset``, the records ``build_fixture`` would write) and
   the CLIs' HDF5 path is tested on the CPU only.  ``cli.train.train``
   trains with the async ``CheckpointManager``; the checkpoint of epoch
   16, which had epoch 17's in-place steps run during its write, must
   hold the state_dict and momentum SHA-256 taken as its save returned;
   the last committed checkpoint, restored by
   ``cli.evaluate.load_predictor``, must have the trained model's
   state_dict SHA-256 and the same fused-lane payload on one val image;
   ``validation_oks`` scores it on the fused lane and on the compact lane,
   and the untrained init (``cli.synth_ap.save_fresh_checkpoint``) on the
   fused lane.  Then, after the counts are read, each kernel is held to
   its plain version at this phase's own shapes, with phase 3's
   tolerances: the focal kernels on the five calls of the first training
   step, as the loss made them, and the decode kernels on the first val
   image's ensembled maps, as the fused lane decoded them.  It prints
   train imgs/s, the median step, each save's blocked and writer ms, the
   loss curve, the APs, the device and the five kernels' launches, and
   fails unless the trained AP is at least 0.5, the untrained AP at most
   0.05, last/first loss at most 0.2, the two lanes' APs within 0.01 and
   every kernel launched;
8. accuracy tiers, on phase 7's last committed checkpoint and val set:
   (a) the scale x rotation grids single-scale, scale_search (0.8, 1.0,
   1.2), rotation_search (0, 30, -30) and their product, on the trained
   ``synth_canonical`` built by ``serve.artifacts.checkpoint_predictor``:
   for each grid, the fused and looped grid dispatches on the first 2
   val images (:data:`GRID_AB_IMAGES`) in the compact and decode modes
   (``cli.tta_bench.ab_report``), payloads equal bit for bit, 1 dispatch
   an image fused and entries + 1 looped, ms an image of each; the OKS AP
   of each grid on the compact lane over all 12, and of the multi-scale grid on the fused decode lane with the
   decode kernels' counters set to 0 just before and read just after
   (each must have launched); the host full-map protocol
   (``process_image`` with neither flag) on the multi-scale grid, its AP
   and ``Predictor.predict``'s ms an image; how often each overflow
   fallback was taken.  Gates: multi-scale AP >= 0.5, host protocol AP >=
   0.5.  (b) the three decode kernels bit for bit against their plain
   versions on the first val image's multi-scale mean maps, as the lane
   decoded them, and on planted people at (1, 768, 1151, 50), the mean
   grid of a 427x640 image at that scale grid and boxsize 640, whose
   width is no multiple of 32 (valid = the whole map), each timed as in
   phase 3.  (c) ``canonical`` (seeded init, boxsize 640) on one 427x640
   image through the fused multi-scale grid and ``Predictor.predict``:
   ms an image and peak device memory; ``predict_decoded_async`` with
   the grid makes no synchronizing call (torch's sync debug mode set to
   error around it: no read back to the host before ``resolve()``).  (d) the dtype matrix: the
   trained checkpoint at fp32, bf16 and int8, the fused-lane AP on phase
   7's 12 val images and on 48 of the same seed (the 12 and 36 more), the
   stored bytes of each, and ``canonical``'s ``predict_decoded_batch``
   imgs/s at batch 8 of 480x640 at each dtype.  Gates: the fp32 AP on the
   12 equal to phase 7's, |AP(int8) - AP(bf16)| <= 0.01 on the 48 (on 24
   people one OKS match moves AP by ~0.004), int8 bytes <= 0.35 x fp32.  A ``[8 accuracy tiers]`` summary line closes the phase.
9. the rest of training at full width.  (a) variants: each of
   ``imhn_independent``, ``imhn_light``, ``imhn_wide`` (3 stacks), ``ae``
   and ``imhn_final`` (``final_384``) at published width from a seeded
   init in bf16 autocast, its parameter count checked; one
   ``predict_decoded_batch`` at batch 2 of 480x640 (every decode kernel
   must launch); 2 warm-up and 3 timed train steps at its config's input
   (``final_384`` 384^2 batch 8, the others 512^2 batch 4) on phase 6's
   drawn people, the focal counters set to 0 before the timed steps and
   equal to scales x steps after; ms a step, imgs/s and peak memory; the
   focal kernels held to their plain versions on the first timed step's
   calls at ``ae``'s single scale and ``final_384``'s five (forward rel
   1e-5, backward bit for bit), and their device ms a step at those
   shapes, the inputs rotated over copies 3x the L2 so each call reads
   HBM, beside the bound of those shapes' own bytes.  (b) GT made on the
   device, through the ring: on phase 6's people at 512^2 batch 4, the
   card's labels against the host ``Heatmapper``'s (max abs <= 1e-4);
   then ``cli.train.train`` (``canonical``, one epoch of 12 steps on
   phase 6's records, ``pipeline="shm"``, 2 spawn workers over
   ``MemoryDataset`` records, ``device_gt`` 16, a validation set so the
   eval ring runs, under a ``RunSupervisor`` so the rings are the
   supervised ones): its ``device_prefetch`` feeds the steps; the focal
   counts, the step ms, the data wait ms a step and imgs/s come from its
   report, beside the bytes a batch on the wire and phase 6's sync
   figures.  (c) distillation: ``cli.train.train(teacher=...)`` of
   ``canonical_student`` at 512^2 batch 4 (one epoch of 12 steps, a
   validation set) from a seeded ``canonical`` teacher (eval): 10 focal
   launches a step each way (and 5 forward an eval batch), the
   checkpoint's losses finite, the teacher's ``state_dict`` SHA-256 unchanged.  (d) SWA: 2 epochs of
   ``cli.train.train(swa=True, swa_freq=2)`` resumed from phase 7's last
   checkpoint: BN running stats bit for bit the checkpoint's,
   ``swa_count`` 2, the SWA fields equal after a save and restore, and
   the averaged weights' OKS AP on phase 7's 12 val images (fused lane)
   beside phase 7's, gated at >= 0.5.  (e) supervisor: a supervised
   ``cli.train.train`` (``synth_canonical``, 2 epochs, 16 of phase 7's
   records) asked to stop inside epoch 1, then a second segment that
   resumes from the committed epoch 0 and reaches the target: 2 segments
   in ``RUN.json``, the step count that of an unstopped run; and the
   card's own out-of-memory error (a 64 TiB allocation) classified
   transient.
10. serving beyond one batcher, on phase 7's checkpoint and val set.
   (a) ``serve.EnginePool`` of 2 ``DynamicBatcher``s (wedge timeout 60 s):
   phase 4's planted maps on two stub predictors (every person within
   1 px, both replicas serving); then ``synth_canonical`` fp32 from
   ``serve.checkpoint_predictor`` as 2 ``Predictor.device_replica("cuda")``
   copies (max_batch 8): the 12 val images' OKS AP within 0.005 of phase
   7's fused lane, 64 480x640 requests from 4 threads (imgs/s, e2e p50 /
   p99, occupancy per replica), a second such burst with replica 0
   stopped (drain 0 s) after 4 completions: every future resolves with
   people, failovers >= 1, failed 0, submitted = completed + failed +
   depth; the decode kernels' launches over the path equal the fused-lane
   batches the replicas dispatched, then the three decode kernels bit for
   bit against their plain versions on replica 0's first captured batch.
   (b) ``serve.CascadeEngine`` of ``cascade_predictors`` (an int8 student
   and an fp32 teacher, both phase 7's checkpoint, max_batch 1) under an
   ``EscalationPolicy`` whose person-count threshold (or, where every
   frame holds as many people, a score floor midway between two frames)
   splits the val frames: the escalated frames are those whose direct
   student signals trip the policy, each answer its tier's direct answer
   (within 1e-3), decode launches = both tiers' batches; ms an image of
   the cascade and of the teacher alone, and the cascade's AP.  (c)
   ``serve.ProcessRouter`` of 2 spawned workers, each building
   ``serve.artifacts:checkpoint_predictor`` on the card from a JSON spec
   (the parent builds the kernels first; workers load them): the val
   images' person tables equal bit for bit to an in-process pool's at
   max_batch 1 (the workers keep torch's default, cuDNN TF32 allowed,
   the script's pool runs full fp32); 32 requests from 4
   threads; worker 0 SIGKILLed mid-flight in a second burst of 32: no
   future lost, a fresh pid serving again, the postmortem verified, the
   fleet scrape carrying both ``worker`` labels; worker start s, imgs/s,
   respawn s, and the workers' decode launches after warmup, read from
   their event shards: in each worker generation that reached its stop,
   each decode kernel launched once a request served (one image a
   ``predict_decoded`` call); the SIGKILLed generation's counts die
   with it and are left out.
11. live video streams and the run telemetry, on phase 7's checkpoint
   (``synth_canonical`` fp32, boxsize 192, the fused lane): 4
   ``stream.SyntheticVideo`` streams of 48 drawn 480x640 frames (1, 2, 1
   and 2 people; each frame's index stamped into its pixel (0, 0)),
   every stream closed loop from its own thread.  (a) a
   ``stream.SessionManager`` over one ``DynamicBatcher(max_batch=8,
   emit_signals=True)`` warmed on the full-frame and the ROI bucket,
   under an installed ``obs.CompileWatch``: every stream's futures
   complete in frame order (``stream.read_stamp``), each stream's ledger
   exact and every frame delivered, synthetic AP against the generator
   (``cli.stream_bench.SyntheticAP``) >= 0.5, 0 lane shapes run first
   after warmup, decode launches = the fused-lane batches; it prints
   identity switches, per-stream FPS and e2e p50/p95.  (b) the same
   streams with ``FastPathConfig(roi_width=320)``, then without it
   (the full-frame arm): three-tier conservation exact, ROI answers > 0,
   0 first runs after warmup, AP >= 0.5 in both arms; the tier mix,
   escalation reasons and the on/off aggregate-FPS ratio (reported).
   (c) the same streams over an ``EnginePool`` of 2
   ``Predictor.device_replica`` batchers, replica 0 stopped (drain 0 s)
   after 8 delivered frames: no future lost, every stream in frame
   order with each frame delivered, dropped or failed, failovers >= 1
   and the frames migrated counted, the pool's ledger exact.  (d) the
   three decode kernels bit for bit against their plain versions on a
   captured stream batch of the full-frame bucket and of the ROI bucket.
   (e) an ``obs.HistoryStore`` sampled every 0.25 s over the phase's
   registry during (a)-(c): its shards replay bit for bit, ``/history``
   and ``/query`` answer 200 on an ephemeral port, a
   ``serve.CapacityModel`` is fitted from it and printed; then
   ``cli.train.train`` of ``synth_canonical`` for one epoch of 16 steps
   under ``obs.RunTelemetry(sink, http_port=0, trace_path=...)`` with the
   health sentinel: ``/healthz`` 200, every event line strict JSON, the
   trace saved with its step windows, each focal kernel launched 5 times
   a step and held to its plain version on the first step's calls; then
   2 steps with ``health_grad_norm_limit`` 1e-9: under ``halt``
   ``DivergenceError`` at the first window and ``/healthz`` 503, under
   ``warn`` both windows trained and counted divergent.
12. multi-card training (``parallel``): (a) a one-rank process group
   under NCCL (``initialize_distributed`` with this card, ``make_mesh(1,
   1)``): ``make_train_step(mesh=, rules=)`` of ``canonical`` (bf16
   autocast, batch 4 at 512x512, phase 6's drawn people) for the
   ``replicated`` rules (DDP) and ``imhn_fsdp`` (the port's gather /
   reduce-scatter storage; at one rank the refinement splits nothing):
   each arm's first step from the seeded init against the plain step's
   on the same batch (``replicated``: loss and updated state bit for
   bit; ``imhn_fsdp`` within 1e-6, its difference printed), then 1 + 5
   steps with the focal kernels' counters set to 0 before the 5 and read
   after (5 + 5 a step), the median step ms (CUDA events) beside phase
   6's and the device busy share with its kernel groups (profiler); the
   focal kernels against their plain versions on the first step's calls.
   (b) two gloo ranks over CUDA tensors on the one card (NCCL refuses
   two ranks on one device), spawned: DDP ``replicated`` on float64
   ``canonical`` at 2 rows a rank, against the plain float64 step on the
   same 4 rows: first-step loss within rel 1e-5, reduced grad norm within
   rel 1e-3, cross-rank BN running stats within 1e-5, the two ranks'
   states equal, 5 + 5 focal launches a rank, each rank's focal calls
   held to the plain versions; rank 0 saves the state.  (c) that
   checkpoint restored in this process: ``reshard="adjust"`` gives the
   saved state (SHA-256 equal), ``"refuse"`` raises ``TopologyChanged``
   naming ``process_count``.  One card, so no multi-card speed is
   claimed.
13. height-sharded inference (``Predictor(mesh=)``, ``parallel.
   spatial``), in fp32 with bf16 autocast and TF32 off in both arms:
   (a) a one-rank NCCL mesh (1, 1): phase 7's checkpoint through
   ``predict_decoded`` on the 12 val images, every payload equal to the
   plain predictor's bit for bit.  (b) two gloo ranks over CUDA tensors
   on card 0, spawned: ``canonical`` (seeded, 128,998,760 parameters) on
   one 1536x768 image at boxsize 1536 over mesh (1, 2) (24 bottom rows,
   12 a rank), ``predict``'s maps within 1e-3 x their max of the
   one-process plain predictor's, each rank's peak memory and ms an
   image beside the plain run's, the collectives a forward; phase 7's
   checkpoint over (1, 2): ``predict_decoded`` on the 12 val images
   (each image's people within 1 px of the plain fused lane's, the OKS
   AP within 0.005 of the plain lane's and of phase 7's), the
   ``predict_compact`` and ``predict_fast`` people of one image as
   their plain lanes', each decode kernel 12 launches a rank, and the
   three decode kernels bit for bit on rank 0's gathered maps of the
   first val image; the multi-rank distillation step of ``cli.train``
   (``make_distill_train_step(mesh=)``) in float64, ``canonical_student``
   from a seeded ``canonical`` teacher at 2 rows a rank against the
   plain step on the same 4 rows (loss rel 1e-5, grad norm rel 1e-3, BN
   stats 1e-5, the ranks' states equal, focal 10 + 10 a rank held to
   the plain versions, the teacher unchanged).  (c) four gloo ranks:
   phase 7's lanes over (2, 2) with (b)'s gates, the batch and grid
   lanes refused, and a 640-row input over (1, 4) split 3 / 3 / 2 / 2
   with its maps within 1e-3 x max.  (d) ``cli.stream_bench --devices
   1``: 2 streams x 8 frames on phase 7's checkpoint, ``serve_devices``
   1, every frame delivered.
14. the tools that measure the port, each ``main(argv)`` in this process
   at full width (``canonical``, seeded, 512x512), with TF32 off (the
   script turns it off at its start): (a) ``cli.speed_test`` at batch 8,
   20 timed calls, bf16 autocast and ``--fp32``; (b) ``cli.perf_audit
   --batches 1 8 --iters 10 --repeats 3``: no implied rate above the
   data-sheet peak, the ``FlopCounterMode`` count equal to the analytic
   conv + dense count, the profiler's device ms measured and no more than
   a dispatch's wall ms, the batch-8 chained FPS and its ``vs_baseline``
   printed; (c) ``cli.train_bench --batches 2 4 8 --steps 5 --repeats
   2``: 5 + 5 focal launches a step, the device ms a step no more than
   the step's ms, the focal kernels held to their plain versions on the
   first step's 5 calls with phase 7's tolerances; (d) ``cli.e2e_bench
   --images 8 --planted 3 --batch 8`` over every mode: each mode's people
   within 1 px of the host decode of the planted maps alone, resized as
   the mode's protocol resizes them (the lanes' x4 upsample; the
   full-map protocol's resize to the image), the three decode kernels
   bit for bit on the device-decode batch's captured maps,
   ``device_decode_host_fallback`` printed; then ``--images 2 --planted
   2 --batch 2``: each mode's people within 1 px of the planted joints;
   (e) ``cli.serve_bench --sizes 512 --requests 4 --clients 1,4
   --baseline-clients 4 --rounds 1 --planted 2`` (the sequential arms at
   the batcher's peak load) (``hop_conservation_frac`` >= 0.95 on every
   arm), then ``--proc-only --proc-rounds 1`` (every future of the chaos
   arm resolved, the SIGKILLed worker respawned).  Its rates prove the
   tools run; at these request counts they are not baselines.
15. the training tools and model I/O at full width, (b) first on a
   quiet card, then (c) with its children beside (a) and (e), then (d)
   alone: (a) phase 7's
   checkpoint written as upstream's trainer saves a ``.pth`` (upstream's
   names under ``module.``, ``{'weights', 'epoch': 52, 'train_loss'}``)
   and imported by ``cli.import_torch_checkpoint``: the import's
   fused-lane detections on phase 7's val set equal phase 7's, its AP
   the same, every decode kernel launched; a seeded ``canonical``
   imported the same way gives the source model's batch-8 forward at
   512x512 bit for bit (fp32); (b) ``cli.ckpt_bench --rounds 1 --epochs
   2 --steps 4 --strict`` at ``canonical`` (the sync and async stalls a
   save, their ratio against the 5.0 target, a bit-identical restore,
   the writes overlapping later step / eval spans; the focal kernels
   held on its first step's 5 calls); (c) ``cli.chaos_train --kills 2
   --seed 35 --workers 0 --strict`` at ``canonical`` (8 records, 4
   epochs): a SIGKILL between epoch 1's payload and its commit marker
   (after epoch 0 committed), then a SIGTERM, the control run beside the
   segments; every resume on the last committed epoch, and the last
   segment resumed from a commit; no leaked process or writer thread;
   the control run exited 0 and the final state matches it; (d) ``cli.feed_rate --workers 0,2
   --min-seconds 3 --repeats 1`` at ``canonical`` against phase 14's
   ``train_bench_torch.json``; (e) ``cli.demo --params-dtype`` int8 and
   bf16 on phase 7's first val image, the result image written.

Then one JSON line with every kernel's numbers (``launches`` are phase
7's learn->AP run: the focal kernels in its training, the decode kernels
in the fused-lane evaluation of its checkpoint; the other paths' counts
stand beside them in ``launches_by_path``, phase 8's multi-scale grid as
``grid``, phase 9's paths as ``variants``, ``device_gt``, ``distill``
and ``swa``, phase 10's as ``pool``, ``cascade`` and
``router_stopped_workers`` (the killed worker generation left out),
phase 11's as ``stream``, ``stream_fastpath``, ``stream_pool`` and
``telemetry``, phase 12(a)'s as ``multi_card``, phase 13(b)'s rank 0 as
``spatial`` and ``distill_multi_rank``, phase 14's as ``train_bench``,
``e2e_bench`` and ``serve_bench``, phase 15's as ``upstream_import``
and ``ckpt_bench``; the focal kernels' device ms a
step at ``ae``'s and
``final_384``'s shapes as ``ae_shape_device_ms`` and
``final_384_shape_device_ms`` (inputs rotated past the L2), with
``*_same_inputs_ms``, ``*_bound_ms`` and ``*_bound_by`` beside them; the decode kernels' times at phase 8's grid shape as
``grid_shape_ms`` and ``grid_shape_device_ms``), the time every phase took,
the ``nvidia-smi`` line again, and last ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository around it, the script exits non-zero and prints
no result.  Every number it prints is measured on the card in this run.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH, HEIGHT, WIDTH = 8, 640, 896          # the serve lane's bucket
TOPK, RADIUS, SAMPLES = 64, 2, 20
HBM_BYTES_PER_S = 3.35e12                   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12                      # H100 SXM, outside tensor cores
FLOAT_TOL = 1e-5
# the __global__ kernels each wrapper launches, by source, for device_ms
PEAKS_PASSES = ("peaks_nms_kernel", "peaks_select_kernel")
LIMBS_PASSES = ("limb_pair_stats_kernel",)
ASSEMBLY_PASSES = ("greedy_assemble_kernel",)
P_MAX = 32                                  # the lane's person table
# the batcher's other decode shapes: (batch, bucket height, bucket width,
# valid width of a 480x640 or a 640x480 image) -- singleton flushes of
# either bucket and a full batch of the narrow one
BUCKET_SHAPES = ((1, HEIGHT, WIDTH, 853), (1, HEIGHT, 512, 480),
                 (BATCH, HEIGHT, 512, 480))
# phase 7: CANONICAL_TRAIN.json's learn->AP protocol
SYNTH_AP = dict(config="synth_canonical", train_images=32, val_images=12,
                canvas=(288, 384), epochs=18, seed=0, val_seed=12345)
# phase 8: the grids of the accuracy tiers, the mean grid of a 427x640
# image at scale_search (0.8, 1.0, 1.2) and boxsize 640, and that image
PHASE8_GRIDS = (("single_scale", {}),
                ("multi_scale", {"scale_search": (0.8, 1.0, 1.2)}),
                ("rotation_pm30", {"rotation_search": (0.0, 30.0, -30.0)}),
                ("ms_rot_pm30", {"scale_search": (0.8, 1.0, 1.2),
                                 "rotation_search": (0.0, 30.0, -30.0)}))
GRID_SHAPE = (768, 1151)
SERVE_IMAGE = (427, 640)
DTYPE_VAL_IMAGES = 48     # the dtype matrix's gate: phase 7's val seed
# the grid A/B's parity and timing: phase 7's first 2 val images (6
# passes of each grid an image; the APs take all 12)
GRID_AB_IMAGES = 2
FOCAL_FWD_PASSES = ("focal_fwd",)
FOCAL_BWD_PASSES = ("focal_bwd",)

# internal part order of the canonical skeleton, unit-box positions of a
# standing person (x across, y down, facing the camera)
UNIT_POSE = {
    "nose": (0.50, 0.10), "neck": (0.50, 0.25),
    "Rsho": (0.35, 0.25), "Relb": (0.30, 0.42), "Rwri": (0.28, 0.58),
    "Lsho": (0.65, 0.25), "Lelb": (0.70, 0.42), "Lwri": (0.72, 0.58),
    "Rhip": (0.40, 0.55), "Rkne": (0.40, 0.75), "Rank": (0.40, 0.95),
    "Lhip": (0.60, 0.55), "Lkne": (0.60, 0.75), "Lank": (0.60, 0.95),
    "Reye": (0.45, 0.07), "Leye": (0.55, 0.07),
    "Rear": (0.40, 0.09), "Lear": (0.60, 0.09),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of ``fn()`` in ms (CUDA events around each
    call; a call that reads back to the host is timed to its end)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernels, launches_a_call: int = 1, calls: int = 20,
              windows: int = 3, required: bool = True):
    """Device time of ``fn()`` apart from the host work around it:
    ``utils.profiling.device_window`` over ``calls`` back-to-back calls,
    the CUDA time of each kernel named in ``kernels`` (the ``__global__``
    names of one source) over the launches recorded, times
    ``launches_a_call``.  Returns {kernel: ms a call}.  The profiler can
    drop a kernel at its window's start (the mean is over the launches it
    kept); now and then it records no device activity at all in a
    window, so a window that misses a kernel is profiled again, up to
    ``windows`` times, and the measurement fails only when every window
    missed it -- or, with ``required=False`` (a time the kernels line
    does not carry), gives None for that kernel: not measured."""
    import torch

    from improved_body_parts_torch.utils.profiling import device_window

    fn()
    torch.cuda.synchronize()
    pats = {k: re.compile(rf"(^|\W){k}($|\W)") for k in kernels}
    for window in range(1, windows + 1):
        activity = device_window(fn, calls).activity
        us = dict.fromkeys(kernels, 0.0)
        seen = dict.fromkeys(kernels, 0)
        for name, (ns, n) in activity.items():
            for k, pat in pats.items():
                if pat.search(name):
                    us[k] += ns / 1e3
                    seen[k] += n
        missed = [k for k in kernels if seen[k] == 0]
        if not missed:
            return {k: us[k] / seen[k] * launches_a_call / 1e3
                    for k in kernels}
        print(f"[device_ms] profiler window {window} of {windows} recorded "
              f"no launch of {', '.join(missed)} in {calls} calls",
              flush=True)
    if required:
        fail(f"device_ms: the profiler recorded no launch of "
             f"{', '.join(missed)} in {windows} windows of {calls} calls")
    print(f"[device_ms] {', '.join(missed)}: not measured", flush=True)
    return {k: None if k in missed else us[k] / seen[k] * launches_a_call
            / 1e3 for k in kernels}


def person_joints(sk, x0: float, y0: float, height: float) -> np.ndarray:
    """(num_parts, 2) image coordinates of one planted person."""
    width = 0.5 * height
    return np.array([[x0 + UNIT_POSE[p][0] * width,
                      y0 + UNIT_POSE[p][1] * height] for p in sk.parts],
                    np.float32)


def planted_grid_maps(sk, people, h4: int, w4: int, device):
    """Stride-4 (h4, w4, num_layers) maps of ``people`` (a list of
    (num_parts, 2) image-pixel joints): a Gaussian per keypoint, a
    Gaussian ridge along each limb.  Grid cell (i, j) sits at image pixel
    (4j + 1.5, 4i + 1.5), where the x4 cubic upsample puts it."""
    import torch

    stride = sk.stride
    ys = torch.arange(h4, device=device, dtype=torch.float32)
    xs = torch.arange(w4, device=device, dtype=torch.float32)
    gy = (ys * stride + (stride - 1) / 2)[:, None]            # (h4, 1)
    gx = (xs * stride + (stride - 1) / 2)[None, :]            # (1, w4)
    maps = torch.zeros((h4, w4, sk.num_layers), device=device)
    sig_kp, sig_limb = 7.0, 5.0
    for joints in people:
        j = torch.as_tensor(joints, device=device)
        for c in range(sk.num_parts):
            d2 = (gx - j[c, 0]) ** 2 + (gy - j[c, 1]) ** 2
            ch = sk.heat_start + c
            maps[..., ch] = torch.maximum(
                maps[..., ch], torch.exp(-d2 / (2 * sig_kp ** 2)))
        for li, (a, b) in enumerate(sk.limbs_conn):
            ax, ay = j[a]
            vx, vy = j[b, 0] - ax, j[b, 1] - ay
            t = (((gx - ax) * vx + (gy - ay) * vy)
                 / (vx * vx + vy * vy)).clamp(0, 1)
            d2 = (gx - ax - t * vx) ** 2 + (gy - ay - t * vy) ** 2
            maps[..., li] = torch.maximum(
                maps[..., li], torch.exp(-d2 / (2 * sig_limb ** 2)))
    return maps


class MirrorStub:
    """Stands in for the network: returns fixed stride-4 maps cropped to
    the input size on the image lanes and their exact mirror (width flip +
    channel permutation) on the mirror lanes, so the flip merge returns
    the planted maps unchanged."""

    def __init__(self, sk, maps):
        self.maps = maps
        self.perm = (list(sk.flip_paf_ord)
                     + [sk.paf_layers + i for i in sk.flip_heat_ord])

    def __call__(self, imgs):
        import torch

        n, h, w, _ = imgs.shape
        m = self.maps[:h // 4, :w // 4]
        mirror = m.flip(1)[..., self.perm]
        half = n // 2
        return [[torch.stack([m] * half + [mirror] * half)]]


def planted_error(sk, people, planted, label: str) -> float:
    """Largest keypoint error in px of the decoded ``people`` (a list of
    (COCO keypoints, score)) against the ``planted`` joints, each planted
    person matched to its nearest decoded one; fails unless every person
    decodes, each keypoint within 1 px."""
    check(len(people) == len(planted), f"{label}: decoded {len(people)} "
          f"people, planted {len(planted)}")
    worst = 0.0
    for joints in planted:
        want = {gt: joints[dt] for dt, gt in sk.dt_gt_mapping.items()
                if gt is not None}
        errs = [max(np.hypot(kps[gt][0] - xy[0], kps[gt][1] - xy[1])
                    for gt, xy in want.items())
                for kps, _ in people]
        worst = max(worst, min(errs))
    check(worst <= 1.0, f"{label}: planted keypoints off by {worst:.3f} px")
    return worst


def compare(name, got, want, int_fields, tol=FLOAT_TOL):
    """Max abs error of ``got`` vs ``want`` (equal-length tuples); integer
    and bool fields must match exactly, floats within ``tol`` (0: bit for
    bit)."""
    import torch

    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape, f"{name}: output {i} shape "
              f"{tuple(g.shape)} != {tuple(w.shape)}")
        if i in int_fields:
            check(torch.equal(g.to(w.dtype), w),
                  f"{name}: integer output {i} differs from the plain "
                  f"version in {int((g.to(w.dtype) != w).sum())} places")
        else:
            err = float((g - w).abs().max()) if g.numel() else 0.0
            check(np.isfinite(err) and err <= tol
                  and (tol > 0 or torch.equal(g, w)),
                  f"{name}: float output {i} off by {err}")
            worst = max(worst, err)
    return worst


def read_floor_ms(kp) -> float:
    """Device time of ``peaks_read_probe`` (``csrc/peaks.cu``) over the
    keypoint slice ``kp``: every pixel's channel slice read once, coalesced,
    nothing computed -- what the NMS pass's reads alone cost on this card
    for this layout (profiler, 20 launches)."""
    import ctypes

    import torch

    from improved_body_parts_torch.ops import _build

    n, h, w, c = kp.shape
    check(kp.stride(3) == 1 and kp.stride(1) == w * kp.stride(2)
          and kp.stride(0) == h * kp.stride(1),
          "read probe: the keypoint slice's pixels are not evenly strided")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("peaks", "ibp_peaks_read_probe", (p, i, i, i, p, p))
    sink = torch.zeros(1, device=kp.device)

    def run():
        _build.check(fn(kp.data_ptr(), n * h * w, kp.stride(2), c,
                        sink.data_ptr(),
                        torch.cuda.current_stream().cuda_stream),
                     "peaks_read_probe")

    return device_ms(run, ("peaks_read_probe",))["peaks_read_probe"]


def dense_cases(sk, dev, gen, valid_h, valid_w, kw_pk, kw_st):
    """Phase 3's rare paths at the lane's shapes: keypoint maps of uniform
    noise keep about a ninth of their pixels, so every NMS band keeps more
    than K (the in-band sort) and every channel more than the select
    block's buffer (the merge in rounds); limb endpoints spread over the
    whole map make almost every segment take all S samples.  Each kernel
    is held to its plain version: integers exactly, floats bit for bit."""
    import torch

    from improved_body_parts_torch.ops import cuda_peaks

    noise = torch.rand((BATCH, HEIGHT, WIDTH, sk.num_layers), device=dev,
                       generator=gen)
    kp = noise[..., sk.heat_start:sk.heat_start + sk.num_parts]
    paf = noise[..., :sk.paf_layers]
    got = cuda_peaks.topk_peaks_kernel(kp, valid_h, valid_w, **kw_pk)
    want = cuda_peaks.topk_peaks_plain(kp, valid_h, valid_w, **kw_pk)
    torch.cuda.synchronize()
    compare("topk_peaks (dense)", got, want, {0, 1, 5, 6}, tol=0.0)
    least, most = int(want[6].min()), int(want[6].max())
    check(least > 4096, f"topk_peaks (dense): a channel keeps only {least} "
          "peaks, too few for the merge in rounds")
    shape = (BATCH, sk.num_parts, TOPK)
    x_ref = torch.rand(shape, device=dev, generator=gen) * (WIDTH - 1)
    y_ref = torch.rand(shape, device=dev, generator=gen) * (HEIGHT - 1)
    got = cuda_peaks.limb_pair_stats_kernel(paf, x_ref, y_ref, **kw_st)
    want = cuda_peaks.limb_pair_stats_plain(paf, x_ref, y_ref, **kw_st)
    torch.cuda.synchronize()
    compare("limb_pair_stats (dense)", got, want, {1, 2}, tol=0.0)
    full = float((want[2] == SAMPLES).float().mean())
    check(full > 0.99, f"limb_pair_stats (dense): only {full:.2%} of the "
          f"pairs take all {SAMPLES} samples")
    print(f"[3 kernels] dense noise: topk_peaks keeps {least}..{most} peaks "
          f"a channel (in-band sort, merge in rounds), limb_pair_stats takes "
          f"{SAMPLES} samples in {full:.2%} of {want[2].numel()} pairs; "
          "both equal to their plain versions bit for bit")


def generic_cases(kp, paf, x_ref, y_ref, valid_h, valid_w, kw_pk, kw_st):
    """The instantiations the serve lane does not take, on its maps: 17
    keypoint channels (the generic NMS copy path, an odd channel count)
    with radius 1 (the generic refinement), and 12 limb samples (the
    generic sample loop).  Each is held to its plain version: integers
    exactly, floats bit for bit."""
    import torch

    from improved_body_parts_torch.ops import cuda_peaks

    kw = dict(kw_pk, radius=1)
    sub = kp[..., :17]
    got = cuda_peaks.topk_peaks_kernel(sub, valid_h, valid_w, **kw)
    want = cuda_peaks.topk_peaks_plain(sub, valid_h, valid_w, **kw)
    kw = dict(kw_st, num_samples=12)
    got_st = cuda_peaks.limb_pair_stats_kernel(paf, x_ref, y_ref, **kw)
    want_st = cuda_peaks.limb_pair_stats_plain(paf, x_ref, y_ref, **kw)
    torch.cuda.synchronize()
    compare("topk_peaks (C=17, r=1)", got, want, {0, 1, 5, 6}, tol=0.0)
    compare("limb_pair_stats (S=12)", got_st, want_st, {1, 2}, tol=0.0)
    print("[3 kernels] generic instantiations: topk_peaks at C=17, r=1 and "
          "limb_pair_stats at S=12 equal to their plain versions bit for bit")


def random_records(sk, dev, rng, limbs_from, limbs_to):
    """Batch-8 peak and candidate records at the lane's sizes (K = 64,
    M = 128, 30 limbs), drawn as ``tests/test_assembly.py``
    ``_rand_records`` draws them: candidates point only at valid peaks, in
    rank-descending prior order, validity a prefix; dense, so every channel
    keeps 40..64 peaks and about half the limbs fill all M slots."""
    import torch

    from improved_body_parts_torch.ops.peaks import LimbCandidates, TopKPeaks

    c, k, m, n_limbs = sk.num_parts, TOPK, 2 * TOPK, len(limbs_from)
    counts = rng.integers(40, k + 1, (BATCH, c)).astype(np.int32)
    valid = np.zeros((BATCH, c, k), bool)
    score = rng.uniform(0.1, 1.0, (BATCH, c, k)).astype(np.float32)
    x_ref = rng.uniform(0, WIDTH - 1, (BATCH, c, k)).astype(np.float32)
    y_ref = rng.uniform(0, HEIGHT - 1, (BATCH, c, k)).astype(np.float32)
    shape = (BATCH, n_limbs, m)
    slot_a, slot_b = np.zeros(shape, np.int32), np.zeros(shape, np.int32)
    prior, norm = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    cvalid = np.zeros(shape, bool)
    ccount = np.zeros(shape[:2], np.int32)
    for i in range(BATCH):
        for ch in range(c):
            valid[i, ch, rng.permutation(k)[:counts[i, ch]]] = True
        for li, (ia, ib) in enumerate(zip(limbs_from, limbs_to)):
            a, b = np.nonzero(valid[i, ia])[0], np.nonzero(valid[i, ib])[0]
            pairs = np.stack(np.meshgrid(a, b, indexing="ij"), -1)
            pairs = rng.permutation(pairs.reshape(-1, 2))
            n = m if rng.uniform() < 0.5 else int(rng.integers(0, m + 1))
            sa, sb = pairs[:n, 0], pairs[:n, 1]
            slot_a[i, li, :n], slot_b[i, li, :n] = sa, sb
            prior[i, li, :n] = np.sort(rng.uniform(0.05, 2.0, n))[::-1]
            norm[i, li, :n] = np.hypot(x_ref[i, ia, sa] - x_ref[i, ib, sb],
                                       y_ref[i, ia, sa] - y_ref[i, ib, sb])
            cvalid[i, li, :n] = True
            ccount[i, li] = len(pairs)

    def on(a):
        return torch.from_numpy(a).to(dev)

    xs, ys = np.rint(x_ref).astype(np.int32), np.rint(y_ref).astype(np.int32)
    peaks = TopKPeaks(on(xs), on(ys), on(x_ref), on(y_ref), on(score),
                      on(valid), on(counts))
    cands = LimbCandidates(on(slot_a), on(slot_b), on(prior), on(norm),
                           on(cvalid), on(ccount))
    return peaks, cands


def chain_length(peaks, cands, limbs_from, limbs_to):
    """(walk steps, connections) of the longest image's chain, then of the
    whole batch: per limb the candidates the walk examines (to the first
    invalid one, or to the connection that reaches the limit) and the
    connections it takes."""
    import torch

    from improved_body_parts_torch.ops.cuda_assembly import (
        candidate_walk_plain,
    )

    k = peaks.valid.shape[-1]
    n_peaks = torch.clamp(peaks.count, max=k).long()
    limit = torch.minimum(n_peaks[:, list(limbs_from)],
                          n_peaks[:, list(limbs_to)])
    sel = candidate_walk_plain(cands.slot_a, cands.slot_b, cands.valid,
                               limit, k).long()
    m_cap = sel.shape[-1]
    taken = sel.sum(-1)
    last = (sel * torch.arange(1, m_cap + 1, device=sel.device)).amax(-1)
    prefix = torch.cumprod(cands.valid.long(), -1).sum(-1)
    steps = torch.where(limit == 0, 0,
                        torch.where(taken >= limit, last, prefix))
    steps, taken = steps.sum(-1), taken.sum(-1)
    i = int(torch.argmax(steps + taken))
    return int(steps[i]), int(taken[i]), int(steps.sum()), int(taken.sum())


def assembly_args(sk, params) -> dict:
    """The serve lane's keyword arguments of ``greedy_assemble``."""
    return dict(limbs_from=tuple(a for a, _ in sk.limbs_conn),
                limbs_to=tuple(b for _, b in sk.limbs_conn),
                num_parts=sk.num_parts, p_max=P_MAX,
                len_rate=params.len_rate,
                connection_tole=params.connection_tole,
                remove_recon=params.remove_recon,
                min_parts=params.min_parts,
                min_mean_score=params.min_mean_score)


def hold_decode(sk, maps, valid_h, valid_w, kw_pk, kw_st, kw_asm,
                connect_ration, label, smi, tag="[3 kernels]"):
    """The three decode kernels on one batch of ensembled maps, as the
    lane calls them: ``topk_peaks`` and ``limb_pair_stats`` against their
    plain versions, then ``greedy_assemble`` on the candidates ranked from
    those records; integers exactly, floats bit for bit."""
    import torch

    from improved_body_parts_torch.ops import cuda_assembly, cuda_peaks
    from improved_body_parts_torch.ops.peaks import (
        PairStats,
        TopKPeaks,
        limb_topk_from_stats,
    )

    kp = maps[..., sk.heat_start:sk.heat_start + sk.num_parts]
    paf = maps[..., :sk.paf_layers]
    pk = cuda_peaks.topk_peaks_plain(kp, valid_h, valid_w, **kw_pk)
    got = cuda_peaks.topk_peaks_kernel(kp, valid_h, valid_w, **kw_pk)
    torch.cuda.synchronize()
    compare(f"topk_peaks ({label})", got, pk, {0, 1, 5, 6}, tol=0.0)
    st = cuda_peaks.limb_pair_stats_plain(paf, pk[2], pk[3], **kw_st)
    got = cuda_peaks.limb_pair_stats_kernel(paf, pk[2], pk[3], **kw_st)
    torch.cuda.synchronize()
    compare(f"limb_pair_stats ({label})", got, st, {1, 2}, tol=0.0)
    peaks = TopKPeaks(*pk)
    cands = limb_topk_from_stats(
        PairStats(*st), peaks, valid_h, limbs_from=kw_asm["limbs_from"],
        limbs_to=kw_asm["limbs_to"], connect_ration=connect_ration,
        m_cap=2 * kw_pk["k"])
    want = cuda_assembly.greedy_assemble_plain(peaks, cands, **kw_asm)
    got = cuda_assembly.greedy_assemble_kernel(peaks, cands, **kw_asm)
    torch.cuda.synchronize()
    compare(f"greedy_assemble ({label})", got, want, {1, 2, 3, 4, 5},
            tol=0.0)
    people = int(want[2].sum())
    check(people > 0, f"greedy_assemble ({label}): no person assembled")
    print(f"{tag} {label}: "
          f"{int(torch.clamp(pk[6], max=kw_pk['k']).sum())} kept peaks, "
          f"{int(st[2].sum())} limb samples, "
          f"{int(cands.valid.sum())} accepted candidates, {people} "
          "people; topk_peaks, limb_pair_stats and greedy_assemble "
          f"equal to their plain versions bit for bit [{smi}]")


def lane_kwargs(sk, thre1, spec):
    """``topk_peaks``', ``limb_pair_stats``' and ``greedy_assemble``'s
    keyword arguments, and connect_ration, of a fused-lane spec."""
    (thre2, mid_num, radius, topk, connect_ration), asm = spec
    limbs = dict(limbs_from=tuple(a for a, _ in sk.limbs_conn),
                 limbs_to=tuple(b for _, b in sk.limbs_conn))
    return (dict(thre=thre1, k=topk, radius=radius),
            dict(limbs, num_samples=mid_num, thre2=thre2),
            dict(limbs, num_parts=sk.num_parts,
                 **dict(zip(("p_max", "len_rate", "connection_tole",
                             "remove_recon", "min_parts", "min_mean_score"),
                            asm))),
            connect_ration)


def hold_lane_call(sk, call, label, smi, tag):
    """:func:`hold_decode` on one captured ``Predictor.decode_maps`` call
    (maps, valid_h, valid_w, thre1, spec), as the lane made it."""
    maps, valid_h, valid_w, thre1, spec = call
    hold_decode(sk, maps, valid_h, valid_w, *lane_kwargs(sk, thre1, spec),
                f"{label} {tuple(maps.shape)}, valid "
                f"{int(valid_h[0])}x{int(valid_w[0])}", smi, tag=tag)


def bucket_cases(sk, dev, params, kw_pk, kw_st, smi):
    """Phase 3's decode kernels at the batcher's other shapes
    (``BUCKET_SHAPES``), each on planted people plus noise as at the
    lane's batch of 8 (seeded apart, so the later phases draw as
    before), through :func:`hold_decode`."""
    import torch

    from improved_body_parts_torch.infer.resize import upsample_cubic

    rng = np.random.default_rng(1)
    gen = torch.Generator(device=dev).manual_seed(1)
    kw_asm = assembly_args(sk, params)
    for n, h, w, valid in BUCKET_SHAPES:
        grid = torch.stack([planted_grid_maps(
            sk, [person_joints(sk, x0, rng.uniform(20, 120),
                               rng.uniform(260, 480))
                 for x0 in rng.uniform(0, valid - 260, 3)],
            h // 4, w // 4, dev) for _ in range(n)])
        grid = grid + 0.01 * torch.randn(grid.shape, device=dev,
                                         generator=gen)
        hold_decode(sk, upsample_cubic(grid, sk.stride),
                    torch.full((n,), h, dtype=torch.int32, device=dev),
                    torch.full((n,), valid, dtype=torch.int32, device=dev),
                    kw_pk, kw_st, kw_asm, params.connect_ration,
                    f"batcher shape batch {n}, {h}x{w}, valid width {valid}",
                    smi)


def assembly_cases(sk, dev, params, peaks, cands, rng, smi):
    """Phase 3 for the fused assembly: ``greedy_assemble_kernel`` against
    ``greedy_assemble_plain`` on the card, every ``AssemblyResult`` field
    bit for bit (-0.0 equal to 0.0), on (a) the lane's own planted peaks
    and candidates at p_max 32, (b) random dense records at p_max 32, at
    p_max 1 (which fills the table: person_overflow) and at remove_recon 1
    (the compete rule), and (c) p_max 64.  Each case times the wrapper
    call (events), the kernel on the device (profiler) and the plain
    version (events, one call); the planted case's numbers are the
    kernel's row in the JSON line."""
    import torch

    from improved_body_parts_torch.ops import cuda_assembly

    base = assembly_args(sk, params)
    limbs_from, limbs_to = base["limbs_from"], base["limbs_to"]
    rand = random_records(sk, dev, rng, limbs_from, limbs_to)
    cases = [("planted", peaks, cands, {}),
             ("random dense", *rand, {}),
             ("random dense", *rand, dict(p_max=1)),
             ("random dense", *rand, dict(remove_recon=1)),
             ("planted", peaks, cands, dict(p_max=64)),
             ("random dense", *rand, dict(p_max=64))]
    row = None
    for label, pk, cd, kw in cases:
        kw = dict(base, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = cuda_assembly.greedy_assemble_plain(pk, cd, **kw)
        end.record()
        got = cuda_assembly.greedy_assemble_kernel(pk, cd, **kw)
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        label = (f"{label}, p_max {kw['p_max']}, remove_recon "
                 f"{kw['remove_recon']}")
        compare(f"greedy_assemble ({label})", got, want, {1, 2, 3, 4, 5},
                tol=0.0)
        people, full = int(want[2].sum()), int(want[5].sum())
        if kw["p_max"] == 1:
            check(full > 0, f"greedy_assemble ({label}): no image filled "
                  "its one-person table")
        run = lambda: cuda_assembly.greedy_assemble_kernel(  # noqa: E731
            pk, cd, **kw)
        ms = cuda_ms(run, 20)
        dev_ms = sum(device_ms(run, ASSEMBLY_PASSES).values())
        steps, conns, all_steps, all_conns = chain_length(
            pk, cd, limbs_from, limbs_to)
        print(f"[3 kernels] greedy_assemble ({label}): equal to the plain "
              f"version bit for bit; {people} people, {full} images with a "
              f"full table; kernel {ms:.4f} ms (wrapper call, events), "
              f"{dev_ms:.4f} ms on the device, plain {plain_ms:.2f} ms; "
              f"longest chain {steps} walk steps and {conns} connections, "
              f"{1e3 * dev_ms / max(steps, 1):.3f} us a walk step [{smi}]")
        if row is None:
            n, c, k = pk.score.shape
            lm = cd.valid[0].numel()
            per_image = (c * k + c) * 4 + lm * 17 + cd.count.shape[1] * 4
            out = (kw["p_max"] * (sk.num_parts + 2) * 2 * 4 + kw["p_max"]
                   + 4 + 3)
            row = dict(err=0.0, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                       bytes=n * (per_image + out) + 8 * len(limbs_from),
                       ops=all_steps * 8 + all_conns * 40)
    return row


def hold_focal(calls, ct, label, tag="[3 kernels]"):
    """The focal kernels on each ``(pred, gt, mask, chan)`` call of
    ``calls`` against their plain versions: the forward within rel 1e-5,
    the backward (cotangent ``ct``) bit for bit.  Returns the forward's
    max abs error and the backward's nonzero count."""
    import torch

    from improved_body_parts_torch.ops import cuda_focal

    fwd_err = fwd_rel = 0.0
    nonzero = 0
    for pred, gt, mask, chan in calls:
        got = cuda_focal.focal_fwd_kernel(pred, gt, mask, chan)
        want = cuda_focal.focal_fwd_plain(pred, gt, mask, chan)
        dgot = cuda_focal.focal_bwd_kernel(pred, gt, mask, chan, ct)
        dwant = cuda_focal.focal_bwd_plain(pred, gt, mask, chan, ct)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-30)
        shape = f"{tuple(pred.shape)} {str(pred.dtype)[6:]}"
        check(np.isfinite(err) and rel <= 1e-5,
              f"focal_fwd ({label}, {shape}): rel error {rel:.3g} against "
              "the plain version")
        check(torch.equal(dgot, dwant),
              f"focal_bwd ({label}, {shape}): differs from the plain "
              f"version in {int((dgot != dwant).sum())} places")
        fwd_err, fwd_rel = max(fwd_err, err), max(fwd_rel, rel)
        nonzero += int((dwant != 0).sum())
    shapes = ", ".join(f"{tuple(p.shape)} {str(p.dtype)[6:]}"
                       for p, _, _, _ in calls)
    print(f"{tag} focal ({label}): forward within rel {fwd_rel:.3g} "
          f"of the plain version, backward equal bit for bit, at {shapes}")
    return fwd_err, nonzero


def focal_kernels(cfg, dev):
    """Phase 3 for the focal-loss kernels: forward and backward against
    their plain versions at the canonical training shapes, on sparse GT
    (as ``pallas_focal.parity_benchmark`` builds it) and on a case planted
    on the kink; one step's 5 launches timed together."""
    import torch

    from improved_body_parts_torch.ops import cuda_focal
    from improved_body_parts_torch.ops.losses import _chan_scale

    sk, tr = cfg.skeleton, cfg.train
    stacks, batch = cfg.model.nstack, tr.batch_size_per_device
    c = sk.num_layers
    chan = _chan_scale(c, sk.heat_start, sk.bkg_start, tr.multi_task_weight,
                       tr.keypoint_task_weight, device=dev)
    ct = torch.tensor(tr.nstack_weight, device=dev) * 0.25  # a cotangent
    gen = torch.Generator(device=dev).manual_seed(1)

    def uniform(*shape):
        return torch.rand(shape, device=dev, generator=gen)

    scales = []
    for hw in (sk.height // sk.stride >> s for s in range(5)):
        pred = uniform(stacks, batch, hw, hw, c) * 1.4 - 0.2
        gt = uniform(batch, hw, hw, c) * (uniform(batch, hw, hw, c) > 0.7)
        mask = (uniform(batch, hw, hw, 1) > 0.1).float()
        scales.append((pred, gt, mask))
    kink = [(torch.where(gt >= cuda_focal.FG_THRE, 1.0, 0.0).expand_as(pred)
             .contiguous(), gt, mask) for pred, gt, mask in scales]
    fwd_err, on_kink = 0.0, 0
    for label, case in (("sparse", scales), ("kink", kink)):
        err, nonzero = hold_focal([(p, g, m, chan) for p, g, m in case], ct,
                                  label)
        fwd_err = max(fwd_err, err)
        if label == "kink":
            on_kink += nonzero
    check(on_kink > 0, "focal: the kink case has no gradient")

    def one_step(fn, *extra):
        return lambda: [fn(p, g, m, chan, *extra) for p, g, m in scales]

    in_bytes = sum(p.numel() + g.numel() + m.numel() + c
                   for p, g, m in scales) * 4
    pred_elems = sum(p.numel() for p, _, _ in scales)
    fwd_step = one_step(cuda_focal.focal_fwd_kernel)
    bwd_step = one_step(cuda_focal.focal_bwd_kernel, ct)
    first, again = fwd_step(), fwd_step()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "focal_fwd: two runs on the same inputs give different bits")
    split = []
    for pred, gt, mask in scales:
        by_pass = device_ms(lambda: cuda_focal.focal_fwd_kernel(
            pred, gt, mask, chan), FOCAL_FWD_PASSES)
        split.append(f"{pred.shape[2]}^2: " + " + ".join(
            f"{k} {v:.4f}" for k, v in by_pass.items()))
    print("[3 kernels] focal_fwd device ms a call by scale and pass "
          f"(profiler, 20 calls; same bits in two runs): {'; '.join(split)}")
    return {
        "focal_fwd": dict(
            err=fwd_err,
            ms=cuda_ms(fwd_step, 20),
            device_ms=sum(device_ms(fwd_step, FOCAL_FWD_PASSES,
                                    len(scales)).values()),
            plain_ms=cuda_ms(one_step(cuda_focal.focal_fwd_plain), 5),
            bytes=in_bytes + 5 * stacks * 4,
            ops=pred_elems * 10),  # compare, select, 2 sub, abs, 4 mul, add
        "focal_bwd": dict(
            err=0.0,
            ms=cuda_ms(bwd_step, 20),
            device_ms=sum(device_ms(bwd_step, FOCAL_BWD_PASSES,
                                    len(scales)).values()),
            plain_ms=cuda_ms(one_step(cuda_focal.focal_bwd_plain, ct), 5),
            bytes=in_bytes + 5 * stacks * 4 + pred_elems * 4,
            ops=pred_elems * 16),
    }


def train_full_width(cfg, dev, smi):
    """Phase 6: ``canonical`` trains at full width on drawn synthetic
    people; returns the focal kernels' launches in the 10 timed steps and
    what phase 9 reuses: the drawn records and the sync pipeline's step
    ms, host data ms a batch, imgs/s and bytes a batch."""
    import torch

    from improved_body_parts_torch.data import MemoryDataset, batches
    from improved_body_parts_torch.data.fixture import _synth_image
    from improved_body_parts_torch.data.hdf5_corpus import (
        build_masks,
        iter_records,
    )
    from improved_body_parts_torch.models import build_model
    from improved_body_parts_torch.ops import cuda_focal
    from improved_body_parts_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
        step_decay_schedule,
        train_epoch,
    )
    from improved_body_parts_torch.train.step import to_device
    from improved_body_parts_torch.utils.profiling import device_window

    sk, tr = cfg.skeleton, cfg.train
    bs, warm_steps, steps = tr.batch_size_per_device, 2, 10
    rng = np.random.default_rng(6)
    records = []
    while len(records) < bs * (warm_steps + steps):
        img, persons, _ = _synth_image(rng, 480, 640, 2, sk.width,
                                       drawn=True)
        person_masks = []
        for p in persons:
            m = np.zeros(img.shape[:2], np.uint8)
            x0, y0, bw, bh = [int(v) for v in p["bbox"]]
            m[max(y0, 0): y0 + bh, max(x0, 0): x0 + bw] = 1
            person_masks.append(m)
        mask_miss, mask_all = build_masks(
            img.shape[:2], person_masks, [p["num_keypoints"] for p in persons])
        for rec in iter_records({"width": 640, "height": 480}, 0, 0, persons,
                                "SYNTH", is_validation=False):
            records.append((img, mask_miss, mask_all,
                            np.asarray(rec["joints"]),
                            tuple(rec["objpos"][0]),
                            float(rec["scale_provided"][0])))
    warm_set = MemoryDataset(records[:bs * warm_steps], cfg)
    timed_set = MemoryDataset(records[bs * warm_steps:
                                      bs * (warm_steps + steps)], cfg)

    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0, train=True)
    opt = make_optimizer(model, cfg, step_decay_schedule(
        tr, steps_per_epoch=warm_steps + steps))
    state = create_train_state(model, cfg, opt)
    step = make_train_step(model, cfg, opt)
    losses, events = [], []

    def timed_step(state, *batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = step(state, *batch)
        end.record()
        losses.append(loss)
        events.append((start, end))
        return state, loss

    data_s = [0.0]

    def timed_batches(dataset, epoch):
        it = batches(dataset, bs, epoch, pipeline="sync", wire="uint8")
        while True:
            t = time.perf_counter()
            batch = next(it, None)
            data_s[0] += time.perf_counter() - t
            if batch is None:
                return
            check(batch[0].dtype == np.uint8
                  and batch[0].shape == (bs, sk.height, sk.width, 3),
                  f"training batch images {batch[0].shape}")
            yield batch

    log = []
    state, _ = train_epoch(state, timed_step, timed_batches(warm_set, 0),
                           cfg, 0, print_freq=5, log_fn=log.append)
    torch.cuda.synchronize()
    print(f"[6 training] canonical imhn in train mode, bf16 autocast, "
          f"{warm_steps} warm-up steps at batch {bs} x {sk.height}x"
          f"{sk.width} in {time.perf_counter() - t0:.1f} s (build, "
          "first steps)")

    watch = {n: t.detach().clone() for n, t in model.state_dict().items()
             if n.startswith("backbone.stem.")}
    for fn in (cuda_focal.focal_fwd_kernel, cuda_focal.focal_bwd_kernel):
        fn.launches = 0
    losses.clear()
    events.clear()
    data_s[0] = 0.0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, mean_loss = train_epoch(state, timed_step,
                                   timed_batches(timed_set, 1), cfg, 1,
                                   print_freq=5, log_fn=log.append)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"focal_fwd": cuda_focal.focal_fwd_kernel.launches,
                "focal_bwd": cuda_focal.focal_bwd_kernel.launches}
    peak_mem = torch.cuda.max_memory_allocated()
    for line in log:
        print(f"[6 training] {line}")
    print(f"[6 training] focal kernel launches in {steps} timed steps: "
          f"{launches}")
    for kname, n in launches.items():
        check(n == 5 * steps, f"{kname}: {n} launches in {steps} steps, "
              f"expected {5 * steps}")
    check(len(losses) == steps and bool(torch.isfinite(
        torch.stack(losses)).all()) and np.isfinite(mean_loss),
        "training: a loss is not finite")
    check(state.step == warm_steps + steps,
          f"training: step {state.step} after {warm_steps + steps} steps")
    check(int(opt.count) == warm_steps + steps,
          "training: a step's update was dropped")
    after = model.state_dict()
    for n, before in watch.items():
        if n.endswith(("weight", "bias", "running_mean", "running_var")):
            check(not torch.equal(after[n], before),
                  f"training: {n} did not move")
    step_ms = statistics.median(s.elapsed_time(e) for s, e in events)
    print(f"[6 training] {steps} steps: median step {step_ms:.2f} ms (CUDA "
          f"events around each step), host data "
          f"{1e3 * data_s[0] / steps:.2f} ms per batch of {bs} (sync "
          f"pipeline), {steps * bs / wall_s:.2f} imgs/s "
          f"({1e3 * wall_s / steps:.2f} ms a step, host clock), mean loss "
          f"{mean_loss:.4f}, peak device memory {peak_mem / 2**30:.2f} GiB "
          f"[{smi}]")

    # the step alone, on one batch already on the card: back to back
    # (CUDA events), then its kernels by group (torch.profiler)
    dev_batch = to_device(next(batches(timed_set, bs, 2, wire="uint8")),
                          dev)
    b2b_ms = cuda_ms(lambda: step(state, *dev_batch), 3)
    prof_steps = 2
    window = device_window(lambda: step(state, *dev_batch), prof_steps,
                           cpu=True)
    prof_s = window.wall_s
    groups = {}
    for name, (ns, _) in window.activity.items():
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ns / 1e3
    busy_ms = sum(groups.values()) / 1e3 / prof_steps
    print(f"[6 training] one step on a device batch, back to back: "
          f"{b2b_ms:.2f} ms (CUDA events) [{smi}]")
    if not groups:
        print("[6 training] device busy time: not measured (the profiler "
              "recorded no kernel)")
    else:
        split = ", ".join(f"{g} {t / 1e3 / prof_steps:.2f}"
                          for g, t in sorted(groups.items(),
                                             key=lambda kv: -kv[1]))
        print(f"[6 training] profiled {prof_steps} steps: kernels "
              f"{busy_ms:.2f} ms a step of {1e3 * prof_s / prof_steps:.2f} "
              f"ms wall (device busy {busy_ms * prof_steps / 1e3 / prof_s:.1%}"
              f"); by group, ms a step: {split} [{smi}]")
    host = sorted(window.prof.key_averages(),
                  key=lambda e: -e.self_cpu_time_total)
    print("[6 training] host, self CPU ms a step under the profiler (calls "
          "a step): " + ", ".join(
              f"{e.key} {e.self_cpu_time_total / 1e3 / prof_steps:.2f} "
              f"({e.count // prof_steps})" for e in host[:10]))
    gh, gw = sk.grid_shape
    wire_bytes = bs * (sk.height * sk.width * 3 + gh * gw * 4
                       + gh * gw * sk.num_layers * 4)
    return launches, dict(records=records, step_ms=step_ms,
                          data_ms=1e3 * data_s[0] / steps,
                          imgs_s=steps * bs / wall_s, batch_bytes=wire_bytes)


def same_payload(a, b) -> bool:
    """Field-for-field equality of two fused-lane payloads
    (``DeviceDecoded``, nested named tuples of arrays and numbers)."""
    if isinstance(a, tuple):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_payload(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    return a == b


def first_calls(fn, n: int, store: list):
    """``fn`` wrapped to keep clones of the arguments of its first ``n``
    calls in ``store``."""
    import torch

    def wrapper(*args):
        if len(store) < n:
            store.append(tuple(a.detach().clone()
                               if isinstance(a, torch.Tensor) else a
                               for a in args))
        return fn(*args)
    return wrapper


def learn_to_ap(dev, smi, work):
    """Phase 7: the learn->AP protocol of ``cli.synth_ap`` at
    ``CANONICAL_TRAIN.json``'s settings, in this process (the card
    machine has no h5py, so the drawn records stay in memory:
    ``fixture_records`` + ``MemoryDataset``; the held-out val set is
    written to disk as the CLIs read it), through the CLIs' own code:
    ``cli.train.train`` trains ``synth_canonical`` (the flagship IMHN at
    full width, remat on, bf16 autocast) for 18 epochs with the async
    checkpoint, then the last committed checkpoint, restored by
    ``cli.evaluate.load_predictor``, is scored with ``validation_oks`` on
    the fused lane and on the compact lane, beside the untrained init of
    ``cli.synth_ap.save_fresh_checkpoint``.  The focal kernels are then
    held to their plain versions on the first training step's own
    inputs, and the decode kernels on the first val image's maps.
    Everything is written under ``work``, which the caller removes.
    Returns the five kernels' launches in the training run and the
    fused-lane evaluation, and what phase 8 reuses: the last committed
    checkpoint, the val set and the network's input size."""
    import dataclasses

    import cv2
    import torch

    from improved_body_parts_torch.cli import kernel_launches
    from improved_body_parts_torch.cli.evaluate import load_predictor
    from improved_body_parts_torch.cli.synth_ap import (
        epoch_losses,
        save_fresh_checkpoint,
    )
    from improved_body_parts_torch.cli.train import state_digest, train
    from improved_body_parts_torch.config import (
        InferenceModelParams,
        get_config,
    )
    from improved_body_parts_torch.data import MemoryDataset
    from improved_body_parts_torch.data.fixture import (
        build_val_set,
        fixture_records,
    )
    from improved_body_parts_torch.infer import Predictor
    from improved_body_parts_torch.infer.evaluate import validation_oks
    from improved_body_parts_torch.ops import (
        cuda_assembly,
        cuda_focal,
        cuda_peaks,
        losses,
    )
    from improved_body_parts_torch.train import (
        CheckpointManager,
        latest_checkpoint,
        restore_checkpoint,
    )

    wrappers = (cuda_peaks.topk_peaks_kernel,
                cuda_peaks.limb_pair_stats_kernel,
                cuda_assembly.greedy_assemble_kernel,
                cuda_focal.focal_fwd_kernel, cuda_focal.focal_bwd_kernel)

    def reset():
        for fn in wrappers:
            fn.launches = 0

    def digests(state):
        """SHA-256 of the state's model state_dict and of its momentum."""
        opt = state.optimizer
        names = {p: n for n, p in state.model.named_parameters()}
        return (state_digest(state.model.state_dict()),
                state_digest({names[p]: b for p, b in zip(opt.params,
                                                          opt.momentum)}))

    t_phase = time.perf_counter()
    epochs = SYNTH_AP["epochs"]
    ckpt_dir = os.path.join(work, "ckpt")
    cfg = get_config(SYNTH_AP["config"])
    # cli.synth_ap's train flags: --print-freq 20; the last two epochs
    # and the best stay on disk, not all 18 GB
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=ckpt_dir, print_freq=20, keep_last_n=2))
    sk, tr = cfg.skeleton, cfg.train
    net = sk.height
    # the save of epoch 16 has all of epoch 17's in-place steps after it
    held_epoch, held = epochs - 2, {}
    focal_calls, lane_calls = [], []
    manager_save, focal_l2_fused = CheckpointManager.save, \
        losses.focal_l2_fused

    def save_and_digest(self, state, epoch, *args):
        path = manager_save(self, state, epoch, *args)
        if epoch == held_epoch:  # before the next step can run
            held[epoch] = digests(state)
        return path

    records = fixture_records(
        num_images=SYNTH_AP["train_images"],
        img_size=SYNTH_AP["canvas"], people_per_image=2,
        image_size=net, seed=SYNTH_AP["seed"], drawn=True)
    train_set = MemoryDataset(records, cfg, augment=True,
                              seed=SYNTH_AP["seed"])
    val_dir = os.path.join(work, "val")
    anno = os.path.join(work, "person_keypoints_synth.json")
    n_val = build_val_set(val_dir, anno,
                          num_images=SYNTH_AP["val_images"],
                          img_size=SYNTH_AP["canvas"], people_per_image=2,
                          image_size=net, seed=SYNTH_AP["val_seed"],
                          drawn=True)
    bs = tr.batch_size_per_device
    spe = max(len(train_set) // bs, 1)
    print(f"[7 learn->AP] {SYNTH_AP['config']}: {len(records)} drawn "
          f"training records of {SYNTH_AP['train_images']} images "
          f"{SYNTH_AP['canvas'][0]}x{SYNTH_AP['canvas'][1]}, "
          f"{SYNTH_AP['val_images']} held-out val images "
          f"({n_val} persons), batch {bs} at {net}x{sk.width}, "
          f"{spe} steps an epoch x {epochs} epochs; set up "
          f"in {time.perf_counter() - t_phase:.1f} s")
    log = []
    reset()
    CheckpointManager.save = save_and_digest
    # one training step's five focal calls, as the loss makes them
    losses.focal_l2_fused = first_calls(focal_l2_fused, 5, focal_calls)
    t0 = time.perf_counter()
    try:
        state, report = train(cfg, train_set, epochs, device=dev,
                              seed=SYNTH_AP["seed"], log_fn=log.append)
    finally:
        CheckpointManager.save = manager_save
        losses.focal_l2_fused = focal_l2_fused
    fit_s = time.perf_counter() - t0
    train_launches = kernel_launches()
    model = state.model
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 128_998_760 and model.remat,
          f"synth_canonical: {n_params} parameters, remat "
          f"{model.remat}")
    curve = epoch_losses(ckpt_dir)
    steps = report["steps"]
    check(steps == spe * epochs and state.step == steps,
          f"learn->AP: {steps} steps, state step {state.step}")
    check(len(curve) == epochs and all(np.isfinite(curve)),
          f"learn->AP: losses {curve}")
    ratio = curve[-1] / curve[0]
    blocked, written = report["save_blocked_ms"], report["save_write_ms"]
    nbytes = sum(t.numel() * t.element_size() for t in
                 list(model.state_dict().values())
                 + state.optimizer.momentum)
    print(f"[7 learn->AP] {n_params} parameters (remat, bf16 autocast); "
          f"{steps} steps: median step {report['step_ms_median']:.2f} ms "
          f"(CUDA events around each step), "
          f"{report['train_imgs_per_s']:.2f} train imgs/s (host clock "
          f"over the epochs' batch loops), train {fit_s:.1f} s wall "
          f"[{smi}]")
    print(f"[7 learn->AP] CheckpointManager.save, {len(blocked)} saves "
          f"of a {nbytes / 1e9:.3f} GB state (fp32 parameters, BN stats "
          f"and momentum): blocked median {statistics.median(blocked):.2f}"
          f" ms (max {max(blocked):.2f}; the snapshot into pinned host "
          f"buffers, the first save allocates them), writer median "
          f"{statistics.median(written):.2f} ms (max {max(written):.2f}; "
          f"torch.save + commit, on its thread); "
          f"{sum(n.startswith('epoch_') for n in os.listdir(ckpt_dir))}"
          f" checkpoints retained "
          f"(keep_last_n 2 + the best) [{smi}]")
    print(f"[7 learn->AP] train loss first {curve[0]:.4f} -> last "
          f"{curve[-1]:.4f} (ratio {ratio:.4f}); curve "
          + ", ".join(f"{x:.3f}" for x in curve))

    # the save that had a whole epoch of in-place steps after it: its
    # checkpoint holds the state as it was when save() returned
    path = os.path.join(ckpt_dir, f"epoch_{held_epoch}")
    payload = restore_checkpoint(path)
    check(held_epoch in held and (
        state_digest(payload["model"]),
        state_digest(payload["optimizer"]["momentum"]))
        == held[held_epoch],
        f"learn->AP: {path} differs from the state as it was when its "
        f"save returned, before epoch {held_epoch + 1}'s {spe} in-place "
        "steps (the snapshot did not own its copy)")
    del payload
    print(f"[7 learn->AP] epoch_{held_epoch}: its state_dict and momentum "
          f"have the SHA-256 they had when CheckpointManager.save "
          f"returned, after epoch {held_epoch + 1}'s {spe} in-place "
          "steps ran during its write")

    # the last committed checkpoint in a fresh model, as the evaluate
    # CLI loads it; the trained run's own model beside it
    latest = latest_checkpoint(ckpt_dir)
    check(latest is not None and latest.endswith(f"epoch_{epochs - 1}"),
          f"learn->AP: latest committed checkpoint {latest}")
    restored = load_predictor(SYNTH_AP["config"], latest, device=dev,
                              boxsize=net, params_dtype="fp32")
    check(state_digest(restored.model.state_dict())
          == state_digest(model.state_dict()),
          "learn->AP: the restored state_dict differs from the "
          "trained run's")
    model.eval()
    own = Predictor(model, sk,
                    model_params=InferenceModelParams(boxsize=net),
                    device=dev)
    image = cv2.imread(os.path.join(val_dir, "000000000001.jpg"))
    mine, theirs = (own.predict_decoded(image),
                    restored.predict_decoded(image))
    check(same_payload(mine, theirs), "learn->AP: the restored "
          "checkpoint's fused-lane payload on val image 1 differs from "
          "the trained run's own")
    print(f"[7 learn->AP] {latest}: restored into a fresh model, its "
          f"state_dict has the trained run's SHA-256 and its fused-lane "
          f"payload on val image 1 equals the trained run's field for "
          f"field ({mine.n_people} people, ok {mine.ok})")
    del own

    kw = dict(use_native=True, results_dir=os.path.join(work, "results"))
    reset()
    # the first val image's ensembled maps, as the lane decodes them
    restored.decode_maps = first_calls(restored.decode_maps, 1,
                                       lane_calls)
    t0 = time.perf_counter()
    ap_device = validation_oks(restored, anno, val_dir,
                               device_decode=True,
                               dump_name="synth_trained", **kw)
    eval_s = time.perf_counter() - t0
    eval_launches = kernel_launches()
    del restored.decode_maps
    ap_compact = validation_oks(restored, anno, val_dir, compact=True,
                                dump_name="synth_trained_compact", **kw)
    fresh = load_predictor(
        SYNTH_AP["config"],
        save_fresh_checkpoint(SYNTH_AP["config"],
                              os.path.join(work, "ckpt_fresh"),
                              SYNTH_AP["seed"]),
        device=dev, boxsize=net, params_dtype="fp32")
    ap_fresh = validation_oks(fresh, anno, val_dir, device_decode=True,
                              dump_name="synth_fresh", **kw)
    print(f"[7 learn->AP] OKS AP on the held-out val set: trained "
          f"{ap_device['AP']:.4f} on the fused lane (AP50 "
          f"{ap_device['AP50']:.4f}, AR {ap_device['AR']:.4f}; "
          f"{SYNTH_AP['val_images']} images in {eval_s:.2f} s), "
          f"{ap_compact['AP']:.4f} on the compact lane; untrained "
          f"{ap_fresh['AP']:.4f} [{smi}]")
    launches = {**{k: train_launches[k] for k in ("focal_fwd",
                                                   "focal_bwd")},
                **{k: eval_launches[k] for k in DECODE_KERNELS}}
    print(f"[7 learn->AP] device {torch.cuda.get_device_name(dev)} "
          f"({dev.type}); kernel launches: training {train_launches}, "
          f"the trained checkpoint's fused-lane evaluation "
          f"{eval_launches}")

    # every kernel against its plain version at this phase's shapes,
    # after the counts were read
    check(len(focal_calls) == 5 and len(lane_calls) == 1,
          f"learn->AP: captured {len(focal_calls)} focal calls and "
          f"{len(lane_calls)} lane decodes")
    hold_focal(focal_calls,
               torch.tensor(tr.nstack_weight, device=dev) * 0.25,
               "the first training step's inputs", tag="[7 learn->AP]")
    hold_lane_call(sk, lane_calls[0], "the first val image's maps", smi,
                   tag="[7 learn->AP]")

    for kname, n in launches.items():
        check(n > 0, f"learn->AP: {kname} never launched")
    check(ap_device["AP"] >= 0.5,
          f"learn->AP: trained AP {ap_device['AP']:.4f} < 0.5")
    check(ap_fresh["AP"] <= 0.05,
          f"learn->AP: untrained AP {ap_fresh['AP']:.4f} > 0.05")
    check(ratio <= 0.2, f"learn->AP: last/first loss {ratio:.4f} > 0.2")
    check(abs(ap_compact["AP"] - ap_device["AP"]) <= 0.01,
          f"learn->AP: compact AP {ap_compact['AP']:.4f} and fused AP "
          f"{ap_device['AP']:.4f} differ by more than 0.01")
    print(f"[7 learn->AP] phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches, dict(checkpoint=latest, anno=anno, val_dir=val_dir,
                          net=net, ap_fused=ap_device["AP"],
                          records=records,
                          detections=os.path.join(
                              kw["results_dir"],
                              "person_keypoints_synth_trained.json"))


def time_decode(sk, maps, valid_h, valid_w, kw_pk, kw_st, kw_asm,
                connect_ration):
    """Wrapper-call ms (events, median of 20) and device ms (profiler)
    of the three decode kernels on one batch of maps, as phase 3 times
    them: {kernel: (ms, device_ms)}; a device time the profiler did not
    record in any window is None (not measured)."""
    from improved_body_parts_torch.ops import cuda_assembly, cuda_peaks
    from improved_body_parts_torch.ops.peaks import (
        PairStats,
        TopKPeaks,
        limb_topk_from_stats,
    )

    kp = maps[..., sk.heat_start:sk.heat_start + sk.num_parts]
    paf = maps[..., :sk.paf_layers]
    pk = cuda_peaks.topk_peaks_plain(kp, valid_h, valid_w, **kw_pk)
    st = cuda_peaks.limb_pair_stats_plain(paf, pk[2], pk[3], **kw_st)
    peaks = TopKPeaks(*pk)
    cands = limb_topk_from_stats(
        PairStats(*st), peaks, valid_h, limbs_from=kw_asm["limbs_from"],
        limbs_to=kw_asm["limbs_to"], connect_ration=connect_ration,
        m_cap=2 * kw_pk["k"])
    runs = {"topk_peaks": (lambda: cuda_peaks.topk_peaks_kernel(
                kp, valid_h, valid_w, **kw_pk), PEAKS_PASSES),
            "limb_pair_stats": (lambda: cuda_peaks.limb_pair_stats_kernel(
                paf, pk[2], pk[3], **kw_st), LIMBS_PASSES),
            "greedy_assemble": (lambda: cuda_assembly.greedy_assemble_kernel(
                peaks, cands, **kw_asm), ASSEMBLY_PASSES)}
    out = {}
    for k, (fn, passes) in runs.items():
        dev = device_ms(fn, passes, required=False)
        out[k] = (cuda_ms(fn, 20), None if None in dev.values()
                  else sum(dev.values()))
    return out


def count_calls(counts, key, fn):
    """``fn`` wrapped to add one to ``counts[key]`` at each call."""
    def wrapper(*args, **kwargs):
        counts[key] += 1
        return fn(*args, **kwargs)
    return wrapper


def host_ms(fn, calls: int = 3) -> float:
    """Median host-clock ms of ``fn()``, a call that ends in its fetch."""
    import torch

    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def accuracy_tiers(dev, smi, ctx):
    """Phase 8: the accuracy tiers of inference on the card, after phase
    7 and on its trained checkpoint and val set (``ctx``).

    (a) the scale x rotation grid (:data:`PHASE8_GRIDS`) on the trained
    ``synth_canonical``, built by ``serve.artifacts.checkpoint_predictor``
    at fp32: per grid, ``cli.tta_bench.ab_report`` runs the fused and the
    looped grid on the first :data:`GRID_AB_IMAGES` val images in the
    compact and the decode mode (payloads equal bit for bit, 1 dispatch
    an image fused, entries + 1 looped; one timed round of the compact
    mode), and ``validation_oks`` scores the grid on every val image on
    the compact lane; the multi-scale grid also on the fused decode lane,
    with the decode kernels' counters set to 0 just before and read just
    after (the ``grid`` launches of the kernels line), its first image's
    mean maps captured; and the host full-map protocol (neither flag) on
    the multi-scale grid.  The compact lanes' overflow fallbacks
    (``predict_fast`` for one scale, ``Predictor.predict`` for a grid)
    are counted.  Gates: multi-scale AP >= 0.5, host protocol AP >= 0.5.
    (b) the decode kernels against their plain versions, bit for bit, on
    the captured mean maps and on planted people at (1, 768, 1151, 50)
    (:data:`GRID_SHAPE`, valid = the whole map), timed as in phase 3.
    (c) ``canonical`` (seeded init, boxsize 640) on one 427x640 image:
    the fused multi-scale grid (a 768x1151 mean grid) and
    ``Predictor.predict``, ms an image and peak memory;
    ``predict_decoded_async`` with the grid must make no synchronizing
    call (torch's sync debug mode set to error around it).
    (d) the dtype matrix: the trained checkpoint through
    ``checkpoint_predictor`` at fp32, bf16 and int8, the fused-lane AP
    of each, the stored bytes of each model's parameters and buffers,
    and ``canonical``'s ``predict_decoded_batch`` imgs/s at batch 8 of
    480x640 at each dtype; the APs on phase 7's 12 val images and on
    :data:`DTYPE_VAL_IMAGES` images of the same seed (the first 12 are
    phase 7's).  Gates: fp32 AP on the 12 equal to phase 7's,
    |AP(int8) - AP(bf16)| <= 0.01 on the 48, int8 bytes <= 0.35 x fp32.
    Returns the decode kernels' launches on the multi-scale grid."""
    import dataclasses

    import cv2
    import torch

    from improved_body_parts_torch.cli.tta_bench import ab_report
    from improved_body_parts_torch.config import (
        default_inference_params,
        get_config,
    )
    from improved_body_parts_torch.data.fixture import build_val_set
    from improved_body_parts_torch.infer.evaluate import validation_oks
    from improved_body_parts_torch.infer.resize import upsample_cubic
    from improved_body_parts_torch.serve.artifacts import (
        checkpoint_predictor,
    )
    from improved_body_parts_torch.utils.precision import storage_bytes

    t_phase = time.perf_counter()
    tag = "[8 accuracy tiers]"
    base, _ = default_inference_params()
    grids = {name: dataclasses.replace(base, **over)
             for name, over in PHASE8_GRIDS}
    ms = grids["multi_scale"]
    name_cfg, ckpt, net = SYNTH_AP["config"], ctx["checkpoint"], ctx["net"]
    sk = get_config(name_cfg).skeleton
    val_dir, anno = ctx["val_dir"], ctx["anno"]
    images = [cv2.imread(os.path.join(val_dir, f))
              for f in sorted(os.listdir(val_dir))]
    kw = dict(use_native=True,
              results_dir=os.path.join(os.path.dirname(val_dir), "results"))

    # ------------------------------------- (a) the grid, trained model
    pred = checkpoint_predictor(name_cfg, ckpt, "fp32", boxsize=net,
                                device=dev)
    fallbacks = {"predict_fast": 0, "predict": 0}
    pred.predict_fast = count_calls(fallbacks, "predict_fast",
                                    pred.predict_fast)
    pred.predict = count_calls(fallbacks, "predict", pred.predict)
    aps, lane_ms = {}, {}
    ab_images = images[:GRID_AB_IMAGES]
    t_ab = 0.0
    for name, prm in grids.items():
        n_entries = len(prm.scale_search) * len(prm.rotation_search)
        # one timed round of the compact mode; the decode mode's ms are
        # its parity pass's (the compact rounds warmed the forwards)
        for mode, rounds in (("compact", 1), ("decode", 0)):
            t0 = time.perf_counter()
            rep = ab_report(pred, ab_images, prm, rounds=rounds, mode=mode)
            t_ab += time.perf_counter() - t0
            bad = [i for i, ok in enumerate(rep["payload_equal_per_image"])
                   if not ok]
            check(not bad, f"grid {name} ({mode}): the fused and looped "
                  f"payloads differ on val images {bad}")
            check(rep["ok"], f"grid {name} ({mode}): dispatches an image "
                  f"fused {rep['fused_dispatches_per_image']}, looped "
                  f"{rep['looped_dispatches_per_image']} (want 1 and "
                  f"{n_entries + 1})")
            lane_ms[name, mode] = (rep["fused_ms_per_image"],
                                   rep["looped_ms_per_image"])
        aps[name] = validation_oks(pred, anno, val_dir, params=prm,
                                   compact=True, dump_name=f"grid_{name}",
                                   **kw)["AP"]
        print(f"{tag} grid {name} ({n_entries} entries): fused = looped "
              f"bit for bit on {len(ab_images)} of the {len(images)} val "
              f"images in the compact and decode modes, 1 and "
              f"{n_entries + 1} dispatches an image; "
              f"ms an image (host clock, row fetched) fused/looped: "
              f"compact {lane_ms[name, 'compact'][0]:.2f}/"
              f"{lane_ms[name, 'compact'][1]:.2f}, decode (its parity pass) "
              f"{lane_ms[name, 'decode'][0]:.2f}/"
              f"{lane_ms[name, 'decode'][1]:.2f}; OKS AP on the compact "
              f"lane {aps[name]:.4f} (all {len(images)}) [{smi}]")
    taken = dict(fallbacks)

    lane_calls = []
    decode_maps = pred.decode_maps
    pred.decode_maps = first_calls(decode_maps, 1, lane_calls)
    reset_launches()
    ap_ms_decode = validation_oks(pred, anno, val_dir, params=ms,
                                  device_decode=True,
                                  dump_name="grid_ms_decode", **kw)["AP"]
    grid_launches = read_launches()
    pred.decode_maps = decode_maps
    del pred.predict_fast, pred.predict
    print(f"{tag} multi-scale grid on the fused decode lane: AP "
          f"{ap_ms_decode:.4f}; kernel launches {grid_launches}; overflow "
          f"fallbacks taken by the compact lanes over the 4 grids: full "
          f"maps (predict_fast) {taken['predict_fast']}, host protocol "
          f"(Predictor.predict) {taken['predict']}")
    for kname, n in grid_launches.items():
        check(n > 0, f"grid: {kname} never launched on the multi-scale "
              "grid's fused decode lane")

    t0 = time.perf_counter()
    ap_host = validation_oks(pred, anno, val_dir, params=ms,
                             dump_name="grid_host", **kw)["AP"]
    predict_ms = 1e3 * (time.perf_counter() - t0) / len(images)
    print(f"{tag} host full-map protocol (process_image, neither flag) on "
          f"the multi-scale grid: AP {ap_host:.4f}, {predict_ms:.2f} ms an "
          f"image (host clock, validation_oks over {len(images)} images: "
          f"Predictor.predict, host decode, scoring) [{smi}]")
    check(aps["multi_scale"] >= 0.5, f"grid: multi-scale AP "
          f"{aps['multi_scale']:.4f} < 0.5")
    check(ap_host >= 0.5, f"grid: host protocol AP {ap_host:.4f} < 0.5")

    # ------------------------------- (b) the decode kernels, grid shapes
    check(len(lane_calls) == 1, f"grid: captured {len(lane_calls)} lane "
          "decodes")
    hold_lane_call(sk, lane_calls[0], "the first val image's multi-scale "
                   "mean maps", smi, tag)
    call = lane_calls.pop()
    del lane_calls
    gh, gw = GRID_SHAPE
    rng = np.random.default_rng(8)
    gen = torch.Generator(device=dev).manual_seed(8)
    people = [person_joints(sk, x0, rng.uniform(40, 200),
                            rng.uniform(300, 520))
              for x0 in (60.0, 420.0, 780.0)]
    small = planted_grid_maps(sk, people, gh // 4, -(-gw // 4), dev)[None]
    small = small + 0.01 * torch.randn(small.shape, device=dev,
                                       generator=gen)
    maps = upsample_cubic(small, sk.stride)[:, :, :gw].contiguous()
    vh = torch.full((1,), gh, dtype=torch.int32, device=dev)
    vw = torch.full((1,), gw, dtype=torch.int32, device=dev)
    kws = lane_kwargs(sk, call[3], call[4])
    hold_decode(sk, maps, vh, vw, *kws,
                f"planted people at the grid shape {tuple(maps.shape)}, "
                f"valid {gh}x{gw}", smi, tag=tag)
    timed = time_decode(sk, maps, vh, vw, *kws)
    print(f"{tag} at {tuple(maps.shape)}: " + ", ".join(
        f"{k} {a:.4f} ms (wrapper call, events), "
        + ("not measured" if b is None else f"{b:.4f} ms")
        + " on the device" for k, (a, b) in timed.items()) + f" [{smi}]")
    del maps, small, call

    # -------------------------------- (c) full width at serve size
    big = checkpoint_predictor("canonical", None, "fp32", device=dev)
    image = rng.integers(0, 256, (*SERVE_IMAGE, 3), dtype=np.uint8)
    shapes = []
    big.compact_maps = first_calls(big.compact_maps, 1, shapes)
    big.predict_compact_ms(image, params=ms)              # warm-up
    del big.compact_maps
    grid_shape = tuple(shapes[0][0].shape)
    check(grid_shape == (1, gh, gw, sk.num_layers),
          f"serve-size grid: mean maps {grid_shape}, want "
          f"{(1, gh, gw, sk.num_layers)}")
    del shapes
    torch.cuda.reset_peak_memory_stats()
    fused_ms = host_ms(lambda: big.predict_compact_ms(image, params=ms))
    fused_peak = torch.cuda.max_memory_allocated()
    # the grid only enqueues: no call in predict_decoded_async may wait
    # for the card (torch's sync debug mode raises at a synchronizing
    # call: a read back to the host, a blocking copy); resolve() is the
    # one read back.  An event recorded as it returns can still be done,
    # since the host-bound eager grid leaves the card idle, and a sleep
    # kernel ahead of it fills the launch queue, which blocks the host
    big.predict_decoded(image, params=ms)                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        resolve = big.predict_decoded_async(image, params=ms)
        enqueue_ms = 1e3 * (time.perf_counter() - t0)
    except RuntimeError as err:
        fail(f"serve-size grid: predict_decoded_async waited for the card "
             f"before resolve(): {err}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    decoded = resolve()
    check(decoded.subset.shape == (big.assembly_pmax, sk.num_parts + 2, 2)
          and np.isfinite(decoded.subset).all(),
          "serve-size grid: malformed decode result")
    big.predict(image, ms)                                # warm-up
    torch.cuda.reset_peak_memory_stats()
    full_ms = host_ms(lambda: big.predict(image, ms), calls=2)
    full_peak = torch.cuda.max_memory_allocated()
    print(f"{tag} canonical (seeded init) on one {SERVE_IMAGE[0]}x"
          f"{SERVE_IMAGE[1]} image, multi-scale grid (mean grid "
          f"{gh}x{gw}): fused grid {fused_ms:.2f} ms an image, peak "
          f"device memory {fused_peak / 2**30:.2f} GiB; "
          f"predict_decoded_async enqueued in {enqueue_ms:.2f} ms with no "
          f"synchronizing call; Predictor.predict "
          f"{full_ms:.2f} ms, peak {full_peak / 2**30:.2f} GiB [{smi}]")
    del big

    # --------------------------------------------- (d) the dtype matrix
    # phase 7's val set, and its extension to DTYPE_VAL_IMAGES images of
    # the same seed (its first 12 are phase 7's), on which the gate is
    # taken: on 12 images (24 people) one (person, OKS threshold) match
    # moves AP by ~0.004, the size of the 0.01 bound's own steps
    val_more = os.path.join(os.path.dirname(val_dir), "val_dtype")
    anno_more = os.path.join(os.path.dirname(val_dir),
                             "person_keypoints_dtype.json")
    build_val_set(val_more, anno_more, num_images=DTYPE_VAL_IMAGES,
                  img_size=SYNTH_AP["canvas"], people_per_image=2,
                  image_size=net, seed=SYNTH_AP["val_seed"], drawn=True)
    check(all(np.array_equal(im, cv2.imread(os.path.join(val_more, f)))
              for im, f in zip(images, sorted(os.listdir(val_dir)))),
          "dtype matrix: the extended val set does not start with phase "
          "7's val images")
    dtype_ap, dtype_ap_more, dtype_bytes = {}, {}, {}
    serve_rate, serve_bytes = {}, {}
    batch = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
             for _ in range(BATCH)]
    for dtype in ("fp32", "bf16", "int8"):
        p = pred if dtype == "fp32" else checkpoint_predictor(
            name_cfg, ckpt, dtype, boxsize=net, device=dev)
        dtype_ap[dtype] = validation_oks(
            p, anno, val_dir, device_decode=True,
            dump_name=f"dtype_{dtype}", **kw)["AP"]
        dtype_ap_more[dtype] = validation_oks(
            p, anno_more, val_more, device_decode=True,
            dump_name=f"dtype_{dtype}_more", **kw)["AP"]
        dtype_bytes[dtype] = storage_bytes(p.model)
        del p
        serve = checkpoint_predictor("canonical", None, dtype, device=dev)
        serve_bytes[dtype] = storage_bytes(serve.model)
        serve.predict_decoded_batch(batch)                # warm-up
        serve_rate[dtype] = BATCH * 1e3 / host_ms(
            lambda: serve.predict_decoded_batch(batch))
        del serve
    del pred
    delta = abs(dtype_ap_more["int8"] - dtype_ap_more["bf16"])
    print(f"{tag} dtype matrix, the trained {name_cfg} checkpoint on the "
          f"fused lane, AP on phase 7's {len(images)} val images / on "
          f"{DTYPE_VAL_IMAGES} of the same seed: " + ", ".join(
              f"{d} {dtype_ap[d]:.4f} / {dtype_ap_more[d]:.4f} "
              f"({dtype_bytes[d]} B stored)" for d in dtype_ap)
          + f"; |AP(int8) - AP(bf16)| "
          f"{abs(dtype_ap['int8'] - dtype_ap['bf16']):.4f} / {delta:.4f}; "
          f"canonical predict_decoded_batch at batch {BATCH} of 480x640: "
          + ", ".join(f"{d} {serve_rate[d]:.2f} imgs/s ({serve_bytes[d]} B)"
                      for d in serve_rate) + f" [{smi}]")
    check(dtype_ap["fp32"] == ctx["ap_fused"],
          f"dtype matrix: fp32 AP {dtype_ap['fp32']:.4f} differs from "
          f"phase 7's fused-lane AP {ctx['ap_fused']:.4f}")
    check(delta <= 0.01, f"dtype matrix: |AP(int8) - AP(bf16)| = "
          f"{delta:.4f} > 0.01 on {DTYPE_VAL_IMAGES} val images")
    check(dtype_bytes["int8"] <= 0.35 * dtype_bytes["fp32"],
          f"dtype matrix: int8 stores {dtype_bytes['int8']} B, more than "
          f"0.35 x fp32's {dtype_bytes['fp32']} B")

    print(f"{tag} " + ", ".join(f"{k} AP {v:.4f}" for k, v in aps.items())
          + f", multi-scale fused decode AP {ap_ms_decode:.4f}, host "
          f"protocol AP {ap_host:.4f}; fused/looped ms an image (compact) "
          + ", ".join(f"{k} {lane_ms[k, 'compact'][0]:.2f}/"
                      f"{lane_ms[k, 'compact'][1]:.2f}" for k in grids)
          + f"; fallbacks predict_fast {taken['predict_fast']}, predict "
          f"{taken['predict']}; int8/bf16/fp32 AP on "
          f"{DTYPE_VAL_IMAGES} val images {dtype_ap_more['int8']:.4f}/"
          f"{dtype_ap_more['bf16']:.4f}/{dtype_ap_more['fp32']:.4f}, "
          f"int8 bytes "
          f"{dtype_bytes['int8'] / dtype_bytes['fp32']:.3f} x fp32; phase "
          f"took {time.perf_counter() - t_phase:.1f} s (the grid A/B "
          f"{t_ab:.1f} s)")
    return grid_launches, {k: v for k, v in timed.items()}


def kernel_group(name: str) -> str:
    """The group of a CUDA kernel, by its name, for the step's breakdown."""
    n = name.lower()
    for key, group in (("nccl", "collectives"),
                       ("focal", "focal kernels"), ("sgd", "optimizer"),
                       ("conv", "convolution"), ("xmma", "convolution"),
                       ("cudnn", "convolution"), ("gemm", "matmul"),
                       ("batch_norm", "batch norm"), ("welford", "batch norm"),
                       ("bn_", "batch norm"), ("reduce", "reductions"),
                       ("elementwise", "elementwise"), ("copy", "copies"),
                       ("memcpy", "copies"), ("memset", "copies")):
        if key in n:
            return group
    return "other"


DECODE_KERNELS = ("topk_peaks", "limb_pair_stats", "greedy_assemble")


def decode_kernel_wrappers():
    """{name: wrapper} of the serve lane's three decode kernels."""
    from improved_body_parts_torch.ops import cuda_assembly, cuda_peaks

    return {"topk_peaks": cuda_peaks.topk_peaks_kernel,
            "limb_pair_stats": cuda_peaks.limb_pair_stats_kernel,
            "greedy_assemble": cuda_assembly.greedy_assemble_kernel}


def reset_launches() -> None:
    for fn in decode_kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in decode_kernel_wrappers().items()}


class TimedDispatch:
    """Stands in for a predictor in front of a ``DynamicBatcher``'s fused
    lane: every call is the predictor's own, and the host time of each
    dispatch (what the dispatcher thread spends on a batch: preprocessing,
    upload and the launches) is kept in ``ms``, its (bucket, size) in
    ``batches``; ``fast`` counts full-map fallbacks."""

    def __init__(self, inner):
        self._inner = inner
        self.ms = []
        self.batches = []       # (bucket shape, batch size) of each dispatch
        self.fast = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _timed(self, dispatch, images):
        t0 = time.perf_counter()
        out = dispatch()
        self.ms.append(1e3 * (time.perf_counter() - t0))
        self.batches.append((self._inner.compact_lane_shape(images[0]),
                             len(images)))
        return out

    def predict_decoded_async(self, image, **kw):
        return self._timed(
            lambda: self._inner.predict_decoded_async(image, **kw), [image])

    def predict_decoded_batch_async(self, images, **kw):
        return self._timed(
            lambda: self._inner.predict_decoded_batch_async(images, **kw),
            images)

    def predict_fast_async(self, *a, **kw):
        self.fast += 1
        return self._inner.predict_fast_async(*a, **kw)


def drive(server, images, clients: int):
    """Send ``images`` from ``clients`` threads (image i from thread
    i % clients, each thread submitting its share back to back) and wait
    for every result; returns the results in image order."""
    import threading

    futures = [None] * len(images)
    errors = []

    def client(c):
        try:
            for i in range(c, len(images), clients):
                futures[i] = server.submit(images[i])
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        check(not t.is_alive(), "batcher: a client thread hung")
    check(not errors, f"batcher: submit raised {errors[:1]}")
    return [f.result(timeout=600) for f in futures]


def check_conservation(metrics, rec, label: str) -> float:
    """The hop waterfall of a run: the request recorder ``rec`` (an
    ``obs.reqtrace.ReqTrace`` installed for the run, every request
    sampled) holds a record of each completed request with the five hops
    in order, none negative, and the hops of all requests sum to their
    e2e latencies (``metrics``' exact sums) within 1 us; returns that
    gap in us."""
    from improved_body_parts_torch.serve import HOPS

    records = rec.records()
    check(len(records) == metrics.completed,
          f"{label}: {len(records)} request records for "
          f"{metrics.completed} completed requests")
    for r in records:
        hops = r["nodes"][0]["hops_ms"]
        check(tuple(hops) == HOPS and min(hops.values()) >= 0,
              f"{label}: malformed hops {hops}")
    gap = abs(sum(m.sum for m in metrics.hops.values())
              - metrics.latency.sum) * 1e6
    check(gap <= 1.0, f"{label}: the hops miss e2e by {gap:.3f} us")
    return gap


def planted_batcher(sk, stub_maps, planted, smi):
    """The batcher phase on phase 4's planted maps: 12 requests from 3
    client threads over two buckets through the fused lane, then each
    fallback level forced: a 2-person table under 3 people (the host
    decode of the compact records, native), and top-K 2 under 3 people
    (the full maps of ``predict_fast``)."""
    from improved_body_parts_torch.config import InferenceModelParams
    from improved_body_parts_torch.infer import Predictor, native
    from improved_body_parts_torch.serve import DynamicBatcher

    check(native.native_available(), "batcher: the native decoder did not "
          "build (g++ on native/decoder.cpp)")
    requests = [np.zeros((HEIGHT, w, 3), np.uint8)
                for w in (WIDTH, 640) * 6]
    cases = (("fused", {}, 12, 3),
             ("host compact decode", dict(assembly_pmax=2), 4, 2),
             ("full maps", dict(compact_topk=2), 4, 2))
    for label, kw, n, clients in cases:
        pred = TimedDispatch(Predictor(
            MirrorStub(sk, stub_maps), sk,
            model_params=InferenceModelParams(boxsize=HEIGHT),
            device=stub_maps.device, **kw))
        with DynamicBatcher(pred, max_batch=4, max_wait_ms=25,
                            max_queue=64) as server:
            server.warmup([(HEIGHT, WIDTH), (HEIGHT, 640)])
            pred.fast = 0
            reset_launches()
            results = drive(server, requests[:n], clients)
            launches = read_launches()
            snap = server.metrics.snapshot()
        worst = max(planted_error(sk, people, planted,
                                  f"batcher {label}, request {i}")
                    for i, people in enumerate(results))
        check(snap["completed"] == n and snap["failed"] == 0
              and snap["rejected"] == 0,
              f"batcher {label}: {snap['completed']} of {n} completed, "
              f"{snap['failed']} failed, {snap['rejected']} rejected")
        fused = snap["decode_fused"]
        fallback = snap["decode_host_fallback"]
        if label == "fused":
            check(fused == n and fallback == 0 and pred.fast == 0,
                  f"batcher fused: decode_fused {fused}, fallback "
                  f"{fallback}, full-map runs {pred.fast}")
            for k, v in launches.items():
                check(v > 0, f"batcher fused: {k} never launched")
        else:
            full_maps = label == "full maps"
            check(fused == 0 and fallback == n
                  and pred.fast == (n if full_maps else 0),
                  f"batcher {label}: decode_fused {fused}, fallback "
                  f"{fallback}, full-map runs {pred.fast}")
        print(f"[batcher planted] {label}: {n} requests from {clients} "
              f"threads over buckets {snap['occupancy_histogram']} "
              f"(occupancy histogram), decode_fused {fused}, "
              f"decode_host_fallback {fallback}, full-map runs {pred.fast}, "
              f"{len(planted)} people each within {worst:.3f} px; "
              f"launches {launches} [{smi}]")


def full_width_batcher(pred, rng, smi):
    """The batcher phase at full width on phase 5's ``canonical``
    predictor: warm two buckets, then 64 requests from 4 client threads
    (max_batch 8, max_wait_ms 25, max_queue 64) through the fused lane,
    with the decode kernels' counters set to 0 just before and read just
    after, and a request recorder installed; then 8 requests through the
    host-pool lane.  Returns the counters."""
    from improved_body_parts_torch.obs import reqtrace
    from improved_body_parts_torch.serve import HOPS, DynamicBatcher

    sizes = [(480, 640), (640, 480)]
    images = [rng.integers(0, 256, (*sizes[i % 2], 3), dtype=np.uint8)
              for i in range(64)]
    timed = TimedDispatch(pred)
    rec = reqtrace.ReqTrace(sample=1, emit_to_sink=False)
    with DynamicBatcher(timed, max_batch=8, max_wait_ms=25,
                        max_queue=64) as server:
        t0 = time.perf_counter()
        info = server.warmup(sizes)
        print(f"[batcher full width] warmup of buckets "
              f"{info['bucket_shapes']} at batch sizes "
              f"{info['batch_sizes']}: {info['newly_compiled']} newly "
              f"warmed, {time.perf_counter() - t0:.2f} s")
        timed.ms.clear()
        timed.batches.clear()
        prev = reqtrace.set_reqtrace(rec)
        try:
            reset_launches()
            t0 = time.perf_counter()
            results = drive(server, images, clients=4)
            wall_s = time.perf_counter() - t0
            launches = read_launches()
        finally:
            reqtrace.set_reqtrace(prev)
        snap = server.metrics.snapshot()
        gap = check_conservation(server.metrics, rec, "batcher full width")
    check(len(results) == 64 and all(isinstance(r, list) for r in results),
          "batcher full width: malformed results")
    check(snap["completed"] == 64 and snap["failed"] == 0
          and snap["rejected"] == 0,
          f"batcher full width: {snap['completed']} of 64 completed, "
          f"{snap['failed']} failed, {snap['rejected']} rejected")
    for k, v in launches.items():
        check(v > 0, f"batcher full width: {k} never launched")
    host = sorted(timed.ms)
    lat, hops = snap["latency_ms"], snap["hops_ms"]
    print(f"[batcher full width] 64 requests from 4 threads: "
          f"{snap['imgs_per_sec']:.2f} imgs/s (first submit to last "
          f"completion), {64 / wall_s:.2f} imgs/s (host clock around the "
          f"run), e2e p50 {lat['p50']:.2f} ms, p99 {lat['p99']:.2f} ms, "
          f"mean occupancy {snap['mean_batch_occupancy']:.3f} "
          f"{snap['occupancy_histogram']}, decode_fused "
          f"{snap['decode_fused']}, fallback "
          f"{snap['decode_host_fallback']} [{smi}]")
    print("[batcher full width] hop p50 ms: " + ", ".join(
        f"{h} {hops[h]['p50']:.2f}" for h in HOPS) + "; hop p99 ms: "
        + ", ".join(f"{h} {hops[h]['p99']:.2f}" for h in HOPS)
        + f"; a request record with the five hops for each of the "
        f"{snap['completed']} requests, and their hops sum to their e2e "
        f"latencies within {gap:.4f} us")
    by_size = {}
    for key, ms in zip(timed.batches, timed.ms):
        by_size.setdefault(key, []).append(ms)
    print(f"[batcher full width] dispatcher host ms per batch (the dispatch "
          f"call, host clock): median {statistics.median(host):.2f}, min "
          f"{host[0]:.2f}, max {host[-1]:.2f} over {len(host)} batches; by "
          "bucket and batch, median (batches): " + "; ".join(
              f"{sh[0]}x{sh[1]} batch {n} {statistics.median(v):.2f} "
              f"({len(v)})" for (sh, n), v in sorted(by_size.items()))
          + f"; dispatcher busy {sum(host) / 1e3 / wall_s:.1%} of the run; "
          f"decode kernel launches {launches} [{smi}]")

    with DynamicBatcher(pred, max_batch=8, max_wait_ms=25, max_queue=64,
                        device_decode=False) as server:
        server.warmup(sizes[:1])
        t0 = time.perf_counter()
        results = drive(server, images[:16:2], clients=2)
        pool_s = time.perf_counter() - t0
        snap = server.metrics.snapshot()
    check(len(results) == 8 and snap["completed"] == 8
          and snap["failed"] == 0 and snap["decode_host_fallback"] == 8,
          f"batcher host-pool lane: {snap['completed']} of 8 completed, "
          f"{snap['failed']} failed, {snap['decode_host_fallback']} host "
          "decodes")
    print(f"[batcher full width] host-pool lane (device_decode=False): 8 "
          f"requests completed in {pool_s:.2f} s, decode_host_fallback 8, "
          f"e2e p50 {snap['latency_ms']['p50']:.2f} ms [{smi}]")
    return launches


# ------------------------------------------------ 9. the rest of training
# (variant, base config, stacks) -> published parameter count
VARIANT_COUNTS = {
    ("imhn_independent", "canonical", 4): 128_998_760,
    ("imhn_light", "canonical", 4): 149_504_936,
    ("imhn_wide", "canonical", 3): 152_156_430,
    ("ae", "ae", 4): 138_861_512,
    ("imhn_final", "final_384", 4): 227_066_536,
}
FOCAL_KERNELS = ("focal_fwd", "focal_bwd")
RING_WORKERS, MAX_PEOPLE = 2, 16


def focal_counts() -> dict:
    from improved_body_parts_torch.ops import cuda_focal

    return {"focal_fwd": cuda_focal.focal_fwd_kernel.launches,
            "focal_bwd": cuda_focal.focal_bwd_kernel.launches}


def reset_focal() -> None:
    from improved_body_parts_torch.ops import cuda_focal

    cuda_focal.focal_fwd_kernel.launches = 0
    cuda_focal.focal_bwd_kernel.launches = 0


def variant_config(variant, base, nstack):
    import dataclasses

    from improved_body_parts_torch.config import get_config

    cfg = get_config(base)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, variant=variant, nstack=nstack),
        train=dataclasses.replace(cfg.train,
                                  nstack_weight=(1.0,) * nstack))


def host_batches(cfg, records, n, batch, **kw):
    """``n`` batches of ``batch`` of ``records`` rendered by the port's
    host pipeline at ``cfg``'s input (epoch 0, uint8 wire)."""
    from improved_body_parts_torch.data import MemoryDataset, batches

    ds = MemoryDataset(records[:n * batch], cfg, seed=0)
    out = list(batches(ds, batch, 0, pipeline="sync", wire="uint8", **kw))
    check(len(out) == n, f"host batches: {len(out)} of {n}")
    return out


def timed_steps(step, state, device_batches, label):
    """Run ``step`` on each batch; CUDA events around each.  Returns
    (state, losses, ms a step (median), wall s)."""
    import torch

    from improved_body_parts_torch.train.step import to_device

    dev = next(state.model.parameters()).device
    losses, events = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in device_batches:
        batch = to_device(batch, dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = step(state, *batch)
        end.record()
        losses.append(loss)
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(bool(torch.isfinite(torch.stack(losses)).all()),
          f"{label}: a loss is not finite")
    return (state, losses,
            statistics.median(s.elapsed_time(e) for s, e in events), wall)


def focal_at_shape(calls, ct, shape, smi):
    """The focal kernels' device ms a step on ``calls`` (one step's
    ``(pred, gt, mask, chan)``), beside the bound of these shapes' own
    bytes and operations.  The step's inputs are rotated over copies that
    together hold 3x the L2, so each call finds its inputs evicted from
    L2 and reads them from HBM; the same inputs called again each time
    are timed too (what the L2 saves).  Returns {kernel: {device_ms, same_inputs_ms,
    bound_ms, bound_by, bytes}}."""
    import math

    import torch

    from improved_body_parts_torch.ops import cuda_focal

    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    step_bytes = sum(t.numel() * t.element_size()
                     for call in calls for t in call[:3])
    n = max(2, math.ceil(3 * l2 / step_bytes))
    copies = [calls] + [[(p.clone(), g.clone(), m.clone(), c)
                         for p, g, m, c in calls] for _ in range(n - 1)]
    turn = [0]

    def rotated(kernel, *extra):
        def run():
            step = copies[turn[0] % n]
            turn[0] += 1
            return [kernel(p, g, m, c, *extra) for p, g, m, c in step]
        return run

    pred_elems = sum(p.numel() for p, _, _, _ in calls)
    in_bytes = sum((p.numel() + g.numel() + m.numel() + c.numel()) * 4
                   for p, g, m, c in calls)
    out_fwd = sum(p.shape[0] * 4 for p, _, _, _ in calls)
    work = {"focal_fwd": (cuda_focal.focal_fwd_kernel, (), FOCAL_FWD_PASSES,
                          in_bytes + out_fwd, pred_elems * 10),
            "focal_bwd": (cuda_focal.focal_bwd_kernel, (ct,),
                          FOCAL_BWD_PASSES,
                          in_bytes + ct.numel() * 4 + pred_elems * 4,
                          pred_elems * 16)}
    out = {}
    for k, (kernel, extra, passes, nbytes, ops) in work.items():
        # one launch a call: the profiler missed the first window of each
        # such measurement in one run, so it gets more windows
        hbm = sum(device_ms(rotated(kernel, *extra), passes, len(calls),
                            windows=5).values())
        same = sum(device_ms(lambda: [kernel(*c, *extra) for c in calls],
                             passes, len(calls), windows=5).values())
        by_bytes = nbytes / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
        out[k] = dict(device_ms=hbm, same_inputs_ms=same, bound_ms=bound,
                      bound_by="bytes" if by_bytes else "operations",
                      bytes=nbytes)
        print(f"[9a variants] {k} device ms a step at {shape}'s shapes "
              f"({', '.join(str(tuple(c[0].shape)) for c in calls)}): "
              f"{hbm:.4f} with the inputs rotated over {n} copies "
              f"({n * step_bytes} B; L2 {l2} B), {same:.4f} on the same "
              f"inputs each call (profiler); bound {bound:.4f} "
              f"({out[k]['bound_by']}: {nbytes} B) [{smi}]")
        check(hbm >= 0.9 * bound, f"{k} at {shape}'s shapes: {hbm:.4f} ms "
              f"with the inputs rotated is below 0.9 x its bound "
              f"{bound:.4f} ms: the timing does not read HBM")
    del copies
    return out


def variants_at_full_width(dev, smi, records):
    """Phase 9 (a)."""
    import torch

    from improved_body_parts_torch.infer import Predictor
    from improved_body_parts_torch.models import build_model
    from improved_body_parts_torch.ops import cuda_focal, losses
    from improved_body_parts_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
        step_decay_schedule,
    )

    rng = np.random.default_rng(9)
    images = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
              for _ in range(2)]
    decode, focal = dict.fromkeys(DECODE_KERNELS, 0), \
        dict.fromkeys(FOCAL_KERNELS, 0)
    focal_ms = {}
    for (variant, base, nstack), want in VARIANT_COUNTS.items():
        t0 = time.perf_counter()
        cfg = variant_config(variant, base, nstack)
        sk, tr = cfg.skeleton, cfg.train
        model = build_model(cfg, device=dev, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        check(n_params == want, f"{variant}: {n_params} parameters, "
              f"published {want}")
        pred = Predictor(model, sk)
        reset_launches()
        out = pred.predict_decoded_batch(images)
        torch.cuda.synchronize()
        got = read_launches()
        check(len(out) == 2 and all(np.isfinite(d.subset).all()
                                    for d in out),
              f"{variant}: malformed decode results")
        for k, n in got.items():
            check(n > 0, f"{variant}: {k} never launched serving")
            decode[k] += n
        del pred

        bs, nscale = tr.batch_size_per_device, len(tr.scale_weight)
        data = host_batches(cfg, records, 5, bs)
        model.train()
        opt = make_optimizer(model, cfg, step_decay_schedule(tr, 5))
        state = create_train_state(model, cfg, opt)
        step = make_train_step(model, cfg, opt)
        state, _, _, _ = timed_steps(step, state, data[:2], variant)
        calls, fused = [], losses.focal_l2_fused
        losses.focal_l2_fused = first_calls(fused, nscale, calls)
        reset_focal()
        torch.cuda.reset_peak_memory_stats()
        try:
            state, _, step_ms, wall = timed_steps(step, state, data[2:],
                                                  variant)
        finally:
            losses.focal_l2_fused = fused
        counts = focal_counts()
        peak = torch.cuda.max_memory_allocated()
        for k, n in counts.items():
            check(n == nscale * 3, f"{variant}: {k} launched {n} times in "
                  f"3 steps, expected {nscale * 3}")
            focal[k] += n
        print(f"[9a variants] {variant} ({cfg.name}, {nstack} stacks): "
              f"{n_params} parameters; predict_decoded_batch of 2 480x640 "
              f"launched {got}; train at {sk.height}x{sk.width} batch {bs}: "
              f"{step_ms:.2f} ms a step (median of 3, CUDA events), "
              f"{3 * bs / wall:.2f} imgs/s, peak device memory "
              f"{peak / 2**30:.2f} GiB, focal launches {counts} "
              f"({time.perf_counter() - t0:.1f} s) [{smi}]")
        if variant in ("ae", "imhn_final"):
            shape = "ae" if variant == "ae" else "final_384"
            ct = torch.tensor(tr.nstack_weight, device=dev) * 0.25
            hold_focal(calls, ct, f"{shape}'s first timed step",
                       tag="[9a variants]")
            focal_ms[shape] = focal_at_shape(calls, ct, shape, smi)
        del model, state, opt, step, data, calls
        torch.cuda.empty_cache()
    return {**decode, **focal}, focal_ms


def train_report_counts(label, run, train_steps, eval_batches, fwd_a_step,
                        bwd_a_step):
    """Check the focal counts of one ``cli.train.train`` run: the train
    steps launch ``fwd_a_step`` / ``bwd_a_step`` each, an eval batch 5
    forwards (one a scale)."""
    counts = focal_counts()
    want = {"focal_fwd": fwd_a_step * train_steps + 5 * eval_batches,
            "focal_bwd": bwd_a_step * train_steps}
    check(run["steps"] == train_steps, f"{label}: {run['steps']} train "
          f"steps, expected {train_steps}")
    check(counts == want, f"{label}: focal launches {counts}, expected "
          f"{want} ({train_steps} steps, {eval_batches} eval batches)")
    return counts


def committed_losses(label, ckpt_dir):
    """The last committed checkpoint's train and validation losses,
    checked finite."""
    from improved_body_parts_torch.train import latest_checkpoint
    from improved_body_parts_torch.train.checkpoint import read_commit_meta

    meta = read_commit_meta(latest_checkpoint(ckpt_dir)) or {}
    losses_ = [meta.get("train_loss"), meta.get("metric_value")]
    check(meta.get("metric") == "val_loss"
          and all(isinstance(v, float) and np.isfinite(v) for v in losses_),
          f"{label}: the committed train and val losses {losses_} (metric "
          f"{meta.get('metric')}) are not finite")
    return losses_


def device_gt_through_ring(dev, smi, records, sync, work):
    """Phase 9 (b)."""
    import dataclasses

    import torch

    from improved_body_parts_torch.cli.train import train
    from improved_body_parts_torch.config import get_config
    from improved_body_parts_torch.data import MemoryDataset, batch_wire_format
    from improved_body_parts_torch.ops.gt_device import make_gt_synthesizer
    from improved_body_parts_torch.train import RunSupervisor

    ckpt_dir = os.path.join(work, "ring")
    cfg = get_config("canonical")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=ckpt_dir, keep_last_n=1))
    sk, tr = cfg.skeleton, cfg.train
    bs = tr.batch_size_per_device
    host = host_batches(cfg, records, 1, bs)[0]
    raw = host_batches(cfg, records, 1, bs, raw_gt=MAX_PEOPLE)[0]
    synth = make_gt_synthesizer(sk)
    labels = synth(torch.from_numpy(raw[2]).to(dev),
                   torch.from_numpy(raw[3]).to(dev))
    err = float((labels.cpu() - torch.from_numpy(host[2])).abs().max())
    check(err <= 1e-4, f"device GT: max abs {err:.3g} from the host "
          "Heatmapper's labels")
    gt_ms = cuda_ms(lambda: synth(torch.from_numpy(raw[2]).to(dev),
                                  torch.from_numpy(raw[3]).to(dev)), 10)
    print(f"[9b device GT] the card's labels of a batch of {bs} within "
          f"{err:.3g} (max abs) of the host Heatmapper's; synthesis "
          f"{gt_ms:.3f} ms a batch of {bs} x {MAX_PEOPLE} people (CUDA "
          f"events, copy of the joints included) [{smi}]")

    names, shapes, dtypes = batch_wire_format(cfg, bs, raw_gt=MAX_PEOPLE,
                                              wire="uint8")
    wire_bytes = sum(int(np.prod(s)) * np.dtype(d).itemsize
                     for s, d in zip(shapes, dtypes))
    ds = MemoryDataset(records, cfg, seed=0)
    val = MemoryDataset(records[:2 * bs], cfg, augment=False, seed=1)
    sup = RunSupervisor(ckpt_dir, log_fn=lambda s: None)
    sup.open_segment({"argv": ["phase 9b"]})
    reset_focal()
    t0 = time.perf_counter()
    state, run = train(cfg, ds, 1, device=dev, seed=0, val_dataset=val,
                       workers=RING_WORKERS, pipeline="shm", wire="uint8",
                       device_gt=MAX_PEOPLE, supervisor=sup,
                       log_fn=lambda s: None)
    wall = time.perf_counter() - t0
    steps = len(ds) // bs
    counts = train_report_counts("device GT", run, steps, len(val) // bs,
                                 5, 5)
    losses_ = committed_losses("device GT", ckpt_dir)
    with open(os.path.join(ckpt_dir, "RUN.json")) as f:
        status = json.load(f)["segments"][-1]["status"]
    check(status == "completed", f"device GT: the supervised segment "
          f"ended {status}")
    print(f"[9b device GT] cli.train.train of canonical, one epoch of "
          f"{steps} steps, supervised, pipeline shm ({RING_WORKERS} spawn "
          f"workers over MemoryDataset records, train and eval rings) "
          f"through its device_prefetch, device_gt {MAX_PEOPLE}: median "
          f"step {run['step_ms_median']:.2f} ms (CUDA events), data wait "
          f"{run['data_wait_ms_per_step']:.2f} ms a step, "
          f"{run['train_imgs_per_s']:.2f} imgs/s (its report), "
          f"{wire_bytes} bytes a batch on the wire ({names}); train loss "
          f"{losses_[0]:.4f}, val {losses_[1]:.4f}; focal launches "
          f"{counts}; {wall:.1f} s with the rings' start and the save; "
          f"phase 6 in this run (sync pipeline, host labels): step "
          f"{sync['step_ms']:.2f} ms, host data {sync['data_ms']:.2f} ms a "
          f"batch, {sync['imgs_s']:.2f} imgs/s, {sync['batch_bytes']} bytes "
          f"a batch [{smi}]")
    del state
    torch.cuda.empty_cache()
    return counts


def distill_at_full_width(dev, smi, records, work):
    """Phase 9 (c)."""
    import dataclasses

    import torch

    from improved_body_parts_torch.cli.train import state_digest, train
    from improved_body_parts_torch.config import get_config
    from improved_body_parts_torch.data import MemoryDataset
    from improved_body_parts_torch.models import build_model

    ckpt_dir = os.path.join(work, "distill")
    cfg = get_config("canonical_student")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size_per_device=4, checkpoint_dir=ckpt_dir,
        keep_last_n=1))
    bs = 4
    teacher = build_model(get_config("canonical"), device=dev, seed=1)
    sha = state_digest(teacher.state_dict())
    ds = MemoryDataset(records, cfg, seed=0)
    val = MemoryDataset(records[:2 * bs], cfg, augment=False, seed=1)
    reset_focal()
    state, run = train(cfg, ds, 1, device=dev, seed=0, val_dataset=val,
                       teacher=teacher, log_fn=lambda s: None)
    steps = len(ds) // bs
    counts = train_report_counts("distill", run, steps, len(val) // bs,
                                 10, 10)
    losses_ = committed_losses("distill", ckpt_dir)
    check(state_digest(teacher.state_dict()) == sha,
          "distill: the teacher's state_dict changed")
    print(f"[9c distill] cli.train.train of canonical_student "
          f"({sum(p.numel() for p in state.model.parameters())} parameters)"
          f" from a canonical teacher (seeded, eval) at 512x512 batch {bs}, "
          f"one epoch of {steps} steps (sync pipeline): median step "
          f"{run['step_ms_median']:.2f} ms (CUDA events), "
          f"{run['train_imgs_per_s']:.2f} imgs/s, host data wait "
          f"{run['data_wait_ms_per_step']:.2f} ms a step (its report); "
          f"train loss {losses_[0]:.4f}, val {losses_[1]:.4f}; focal "
          f"launches {counts}; the teacher's SHA-256 unchanged [{smi}]")
    del teacher, state
    torch.cuda.empty_cache()
    return counts


def swa_on_phase7(dev, smi, ctx, work):
    """Phase 9 (d)."""
    import dataclasses

    import torch

    from improved_body_parts_torch.cli import kernel_launches
    from improved_body_parts_torch.cli.evaluate import load_predictor
    from improved_body_parts_torch.cli.train import state_digest, train
    from improved_body_parts_torch.config import get_config
    from improved_body_parts_torch.data import MemoryDataset
    from improved_body_parts_torch.infer.evaluate import validation_oks
    from improved_body_parts_torch.train import (
        latest_checkpoint,
        restore_checkpoint,
    )

    ckpt_dir = os.path.join(work, "swa")
    cfg = get_config(SYNTH_AP["config"])
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=ckpt_dir, print_freq=20))
    base = restore_checkpoint(ctx["checkpoint"])["model"]
    stats = {k: v for k, v in base.items()
             if k.endswith(("running_mean", "running_var"))}
    ds = MemoryDataset(ctx["records"], cfg, augment=True,
                       seed=SYNTH_AP["seed"])
    before = kernel_launches()
    t0 = time.perf_counter()
    state, report = train(cfg, ds, 2, device=dev, seed=SYNTH_AP["seed"],
                          resume=ctx["checkpoint"], swa=True, swa_freq=2,
                          log_fn=lambda s: None)
    train_s = time.perf_counter() - t0
    sd = state.model.state_dict()
    moved = [k for k, v in stats.items() if not torch.equal(sd[k].cpu(), v)]
    check(not moved, f"SWA: BN running stats moved: {moved[:3]}")
    check(state.swa_count == 2, f"SWA: swa_count {state.swa_count}, the "
          "schedule says 2 (start + the cycle's end)")
    latest = latest_checkpoint(ckpt_dir)
    saved = restore_checkpoint(latest)
    names = dict(state.model.named_parameters())
    check(saved["swa_count"] == 2
          and saved["swa_start_step"] == state.swa_start_step
          and state_digest(saved["swa_params"]) == state_digest(names)
          and state_digest({k: saved["model"][k] for k in names})
          == state_digest(state.swa_params),
          "SWA: the checkpoint's SWA fields differ from the state's")
    pred = load_predictor(SYNTH_AP["config"], latest, device=dev,
                          boxsize=ctx["net"], params_dtype="fp32")
    ap = validation_oks(pred, ctx["anno"], ctx["val_dir"],
                        device_decode=True, use_native=True,
                        results_dir=os.path.join(work, "results"),
                        dump_name="synth_swa")["AP"]
    after = kernel_launches()
    counts = {k: after[k] - before[k] for k in after}
    for k, n in counts.items():
        check(n > 0, f"SWA: {k} never launched")
    check(ap >= 0.5, f"SWA: averaged weights' AP {ap:.4f} < 0.5")
    print(f"[9d SWA] {SYNTH_AP['config']}, 2 epochs (swa_freq 2, cyclic "
          f"1e-5 -> 1e-6, BN frozen) from {ctx['checkpoint']}: "
          f"{report['steps']} steps in {train_s:.1f} s, median step "
          f"{report['step_ms_median']:.2f} ms; BN running stats bit for bit "
          f"the checkpoint's; swa_count 2; the SWA fields equal after save "
          f"and restore; OKS AP of the averaged weights {ap:.4f} (fused "
          f"lane, {SYNTH_AP['val_images']} val images) beside phase 7's "
          f"{ctx['ap_fused']:.4f}; launches {counts} [{smi}]")
    del state, pred
    torch.cuda.empty_cache()
    return counts


def supervised_segments(dev, smi, ctx, work):
    """Phase 9 (e)."""
    import dataclasses

    import torch

    from improved_body_parts_torch.cli.train import train
    from improved_body_parts_torch.config import get_config
    from improved_body_parts_torch.data import MemoryDataset
    from improved_body_parts_torch.train import RunSupervisor
    from improved_body_parts_torch.train.supervisor import classify_error

    # the card's own out-of-memory error is a transient failure, as XLA's
    # RESOURCE_EXHAUSTED is to the JAX supervisor
    try:
        torch.empty(1 << 46, dtype=torch.uint8, device=dev)  # 64 TiB
        oom = None
    except torch.cuda.OutOfMemoryError as e:
        oom = f"{type(e).__name__}: {e}"
    check(oom is not None and classify_error(oom) == "transient",
          f"supervisor: the card's out-of-memory error {oom!r} is not "
          "classified transient")
    print(f"[9e supervisor] {oom.splitlines()[0][:160]!r} classified "
          "transient")

    ckpt_dir = os.path.join(work, "supervised")
    cfg = get_config(SYNTH_AP["config"])
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=ckpt_dir, print_freq=2, keep_last_n=1))
    records = ctx["records"][:16]
    spe = len(records) // cfg.train.batch_size_per_device
    sup = RunSupervisor(ckpt_dir, log_fn=lambda s: None)

    class StopInEpoch1(MemoryDataset):
        def sample(self, index, epoch=0, **kw):
            if epoch == 1:
                sup.request_stop()
            return super().sample(index, epoch, **kw)

    t0 = time.perf_counter()
    sup.open_segment({"argv": ["phase 9e", "segment 0"]})
    state, first = train(cfg, StopInEpoch1(records, cfg, seed=0), 2,
                         device=dev, seed=0, supervisor=sup,
                         log_fn=lambda s: None)
    sup2 = RunSupervisor(ckpt_dir, log_fn=lambda s: None)
    rec = sup2.open_segment({"argv": ["phase 9e", "segment 1"]})
    state, second = train(cfg, MemoryDataset(records, cfg, seed=0), 2,
                          device=dev, seed=0, supervisor=sup2,
                          log_fn=lambda s: None)
    with open(os.path.join(ckpt_dir, "RUN.json")) as f:
        run = json.load(f)
    statuses = [s["status"] for s in run["segments"]]
    check(statuses == ["preempted", "completed"]
          and rec["previous_end"] == "preemption",
          f"supervisor: segments {statuses}, previous end "
          f"{rec['previous_end']}")
    check(run["segments"][1].get("resumed_epoch") == 0,
          "supervisor: the second segment did not resume from epoch 0")
    check(state.step == 2 * spe, f"supervisor: step {state.step}, an "
          f"unstopped run takes {2 * spe}")
    print(f"[9e supervisor] {SYNTH_AP['config']}, 2 epochs of {spe} steps: "
          f"segment 0 stopped in epoch 1 after {first['steps']} steps "
          f"(epoch 0 committed), segment 1 resumed from epoch 0 and ran "
          f"{second['steps']} steps to the target; RUN.json segments "
          f"{statuses}; final step {state.step} = an unstopped run's; "
          f"{time.perf_counter() - t0:.1f} s [{smi}]")
    del state
    torch.cuda.empty_cache()


def laps(t0: float, marks) -> str:
    """The seconds between successive ``(label, perf_counter)`` marks,
    from ``t0``: ``"a 1.2, b 3.4"``."""
    out = []
    for label, t in marks:
        out.append(f"{label} {t - t0:.1f}")
        t0 = t
    return ", ".join(out)


def rest_of_training(dev, smi, sync, ctx, work):
    """Phase 9: (a)-(e).  Returns the launches by path and the focal
    kernels' device ms at ``ae``'s and ``final_384``'s shapes."""
    t0 = time.perf_counter()
    records = sync["records"]
    variants, focal_ms = variants_at_full_width(dev, smi, records)
    marks = [("a", time.perf_counter())]
    launches = {"variants": variants,
                "device_gt": device_gt_through_ring(dev, smi, records, sync,
                                                    work)}
    marks.append(("b", time.perf_counter()))
    launches["distill"] = distill_at_full_width(dev, smi, records, work)
    marks.append(("c", time.perf_counter()))
    launches["swa"] = swa_on_phase7(dev, smi, ctx, work)
    marks.append(("d", time.perf_counter()))
    supervised_segments(dev, smi, ctx, work)
    marks.append(("e", time.perf_counter()))
    print(f"[9 rest of training] phase took {marks[-1][1] - t0:.1f} s "
          f"({laps(t0, marks)} s)")
    return {"launches": launches, "focal_device_ms": focal_ms}


# ------------------------------------- 10. serving beyond one batcher
WEDGE_S = 60.0      # far above one dispatch's 51-133 ms of host time
BURST_SHAPE = (480, 640)
# a person table's keypoints are COCO's 17: the wire's width (its default,
# 18, the skeleton's own part count, would return an 18th None)
COCO_PARTS = 17


def val_set(ctx):
    """(ids, images, ground truth) of phase 7's held-out val set."""
    import cv2

    from improved_body_parts_torch.infer.evaluate import (
        load_coco_ground_truth,
    )

    names, gts = load_coco_ground_truth(ctx["anno"])
    ids = sorted(names)
    images = [cv2.imread(os.path.join(ctx["val_dir"], names[i]))
              for i in ids]
    check(all(im is not None for im in images), "phase 10: a val image "
          "did not load")
    return ids, images, gts


def oks_ap(ids, results, gts) -> float:
    """The OKS AP of per-image people ``results`` (in ``ids`` order)."""
    from improved_body_parts_torch.infer.oks import evaluate_oks

    return evaluate_oks({i: gts.get(i, []) for i in ids},
                        dict(zip(ids, results)))["AP"]


def count_decode_chunks(pred, counts: list, idx: int) -> None:
    """Count, in ``counts[idx]``, the fused-lane chunks ``pred`` runs (one
    launch of each decode kernel a chunk)."""
    run = pred._run_chunk

    def counted(mode, *args):
        if mode == "decode":
            counts[idx] += 1
        return run(mode, *args)

    pred._run_chunk = counted


def timed_drive(server, images, clients: int):
    """:func:`drive` that also returns each request's e2e ms (submit to
    its future's completion, host clock) and the wall seconds."""
    import threading

    lat, lock = [], threading.Lock()

    class Timed:
        def submit(self, image):
            t0 = time.perf_counter()
            fut = server.submit(image)

            def done(_):
                with lock:
                    lat.append(1e3 * (time.perf_counter() - t0))

            fut.add_done_callback(done)
            return fut

    t0 = time.perf_counter()
    results = drive(Timed(), images, clients)
    wall = time.perf_counter() - t0
    return results, sorted(lat), wall


def pct(sorted_ms, q: float) -> float:
    return float(np.percentile(np.asarray(sorted_ms), q))


def join_serve_threads(timeout_s: float = 60.0) -> None:
    """Wait out the batchers' stage threads a drain with no time left
    behind (a replica stopped abruptly may still finish a dispatch)."""
    import threading

    deadline = time.time() + timeout_s
    for t in threading.enumerate():
        if t.name.startswith(("serve-", "pool-")):
            t.join(max(0.0, deadline - time.time()))


def occupancy(before: dict, after: dict) -> tuple:
    """(histogram, mean) of the flushes between two occupancy dicts."""
    hist = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    hist = {k: v for k, v in sorted(hist.items()) if v}
    n = sum(hist.values())
    return hist, (sum(k * v for k, v in hist.items()) / n if n else 0.0)


def replica_pool(dev, smi, ctx, stub_maps, planted, val):
    """Phase 10(a): ``EnginePool`` over two ``DynamicBatcher``s.  Returns
    the decode kernels' launches over the path's run and the replicas."""
    import threading

    import torch

    from improved_body_parts_torch.config import (
        InferenceModelParams,
        get_config,
    )
    from improved_body_parts_torch.infer import Predictor
    from improved_body_parts_torch.serve import (
        DynamicBatcher,
        EnginePool,
        checkpoint_predictor,
    )

    sk = get_config(SYNTH_AP["config"]).skeleton
    ids, images, gts = val
    # planted people on two stub replicas (independent predictors: the
    # stub network is no module to copy)
    stubs = [Predictor(MirrorStub(sk, stub_maps), sk,
                       model_params=InferenceModelParams(boxsize=HEIGHT),
                       device=dev) for _ in range(2)]
    requests = [np.zeros((HEIGHT, w, 3), np.uint8) for w in (WIDTH, 640) * 4]
    with EnginePool([DynamicBatcher(p, max_batch=4, max_wait_ms=25)
                     for p in stubs], wedge_timeout_s=WEDGE_S) as pool:
        pool.warmup([(HEIGHT, WIDTH), (HEIGHT, 640)])
        results = drive(pool, requests, clients=2)
        served = [e.metrics.completed for e in pool.engines]
    worst = max(planted_error(sk, people, planted,
                              f"pool planted request {i}")
                for i, people in enumerate(results))
    check(all(n > 0 for n in served), f"pool planted: replicas served "
          f"{served}")
    print(f"[10a pool] planted maps through a 2-replica EnginePool: "
          f"{len(requests)} requests, replicas served {served}, "
          f"{len(planted)} people each within {worst:.3f} px")

    base = checkpoint_predictor(SYNTH_AP["config"], ctx["checkpoint"],
                                params_dtype="fp32", boxsize=ctx["net"],
                                device=dev)
    reps = [base.device_replica("cuda") for _ in range(2)]
    del base
    chunks = [0, 0]
    for i, r in enumerate(reps):
        count_decode_chunks(r, chunks, i)
    lane_calls = []
    engines = [DynamicBatcher(r, max_batch=8, max_wait_ms=25,
                              max_queue=128) for r in reps]
    rng = np.random.default_rng(10)
    burst = [rng.integers(0, 256, (*BURST_SHAPE, 3), dtype=np.uint8)
             for _ in range(64)]
    sizes = sorted({im.shape[:2] for im in images} | {BURST_SHAPE})
    pool = EnginePool(engines, wedge_timeout_s=WEDGE_S, drain_timeout_s=10.0)
    with pool:
        t0 = time.perf_counter()
        info = pool.warmup(sizes)
        warm_s = time.perf_counter() - t0
        # replica 0's first served batch, as its lane decodes it
        reps[0].decode_maps = first_calls(reps[0].decode_maps, 1,
                                          lane_calls)
        chunks[:] = [0, 0]
        reset_launches()
        got = drive(pool, images, clients=4)
        ap = oks_ap(ids, got, gts)
        before = [dict(e.metrics.occupancy) for e in engines]
        _, lat, wall = timed_drive(pool, burst, clients=4)
        occ = [occupancy(b, dict(e.metrics.occupancy))
               for b, e in zip(before, engines)]
        c0 = pool.metrics.completed

        def stop_replica_0():
            deadline = time.time() + 120
            while pool.metrics.completed < c0 + 4 and time.time() < deadline:
                time.sleep(0.002)
            stop_state["in_flight"] = engines[0].metrics.depth
            engines[0].stop(drain_timeout_s=0.0)

        stop_state = {}
        stopper = threading.Thread(target=stop_replica_0)
        stopper.start()
        again = drive(pool, burst, clients=4)
        stopper.join(timeout=120)
        counters = pool.counters()
        m = pool.metrics
        states = [s["state"] for s in pool.replica_states()]
    join_serve_threads()
    torch.cuda.synchronize()
    launches = read_launches()
    n_chunks = sum(chunks)
    check(len(again) == 64 and all(isinstance(r, list) for r in again),
          "pool failover: a future resolved without people")
    check(counters["failovers"] >= 1 and m.failed == 0,
          f"pool failover: failovers {counters['failovers']}, failed "
          f"{m.failed}")
    check(m.submitted == m.completed + m.failed + m.depth and m.depth == 0,
          f"pool: submitted {m.submitted} != completed {m.completed} + "
          f"failed {m.failed} + depth {m.depth}")
    check(abs(ap - ctx["ap_fused"]) <= 0.005,
          f"pool: AP {ap:.4f} against phase 7's fused lane "
          f"{ctx['ap_fused']:.4f}")
    for k, v in launches.items():
        check(v == n_chunks and v > 0, f"pool: {k} launched {v} times for "
              f"{n_chunks} fused-lane batches dispatched")
    print(f"[10a pool] synth_canonical fp32, 2 device_replica copies, "
          f"max_batch 8: warmup of {info['bucket_shapes']} x "
          f"{info['batch_sizes']} in {warm_s:.2f} s; {len(images)} val "
          f"images: OKS AP {ap:.4f} (phase 7's fused lane "
          f"{ctx['ap_fused']:.4f}) [{smi}]")
    print(f"[10a pool] burst of 64 {BURST_SHAPE[0]}x{BURST_SHAPE[1]} "
          f"requests from 4 threads: {64 / wall:.2f} imgs/s, e2e p50 "
          f"{pct(lat, 50):.2f} ms, p99 {pct(lat, 99):.2f} ms; occupancy "
          + "; ".join(f"replica {i} {h} (mean {mo:.3f})"
                      for i, (h, mo) in enumerate(occ)) + f" [{smi}]")
    print(f"[10a pool] second burst with replica 0 stopped (drain 0 s) "
          f"after 4 completions, {stop_state.get('in_flight')} requests "
          f"in flight on it: all 64 resolved with people, failovers "
          f"{counters['failovers']}, resubmitted {counters['resubmitted']}, "
          f"fenced {counters['fenced']}, replica states {states}; pool "
          f"submitted {m.submitted} = completed {m.completed} + failed "
          f"{m.failed} + depth {m.depth}")
    print(f"[10a pool] decode kernel launches over the val run and both "
          f"bursts {launches}, equal to the {n_chunks} fused-lane batches "
          f"the replicas dispatched ({chunks})")
    check(len(lane_calls) == 1, "pool: no decode_maps call captured")
    hold_lane_call(sk, lane_calls[0], "replica 0's first served batch",
                   smi, tag="[10a pool]")
    del reps[0].decode_maps
    return launches, reps


def cascade_tiers(dev, smi, ctx, val):
    """Phase 10(b): ``CascadeEngine`` of an int8 student and an fp32
    teacher on phase 7's checkpoint.  Returns the decode launches."""
    from improved_body_parts_torch.infer.decode import device_signals
    from improved_body_parts_torch.infer.pipeline import device_decode_fn
    from improved_body_parts_torch.serve import (
        CascadeEngine,
        DynamicBatcher,
        EscalationPolicy,
        cascade_predictors,
    )

    ids, images, gts = val
    name, ckpt = SYNTH_AP["config"], ctx["checkpoint"]
    student, teacher = cascade_predictors(name, name, ckpt, ckpt, "int8",
                                          "fp32", boxsize=ctx["net"],
                                          device=dev)
    sd, td = device_decode_fn(student), device_decode_fn(teacher)
    sigs, direct_s, direct_t = [], [], []
    for im in images:
        d = student.predict_decoded(im)
        sigs.append(device_signals(d))
        direct_s.append(sd(d, im))
        direct_t.append(td(teacher.predict_decoded(im), im))
    counts = sorted(s.n_people for s in sigs)
    if counts[0] != counts[-1]:
        # the person-count threshold that splits the frames most evenly
        max_people = min(sorted(set(counts))[:-1], key=lambda v: abs(
            sum(c > v for c in counts) - len(counts) / 2))
        policy = EscalationPolicy(max_people=max_people)
    else:
        # every frame has the same count: the count threshold keeps all,
        # the score floor (midway between two frames) splits them
        scores = sorted(s.min_mean_score for s in sigs)
        k = len(scores) // 2
        policy = EscalationPolicy(max_people=counts[0],
                                  score_floor=(scores[k - 1] + scores[k]) / 2)
    reasons = [policy.reason(s) for s in sigs]
    n_esc = sum(r is not None for r in reasons)
    check(0 < n_esc < len(images), f"cascade: {n_esc} of {len(images)} "
          f"frames escalate under {policy}")
    want = [t if r is not None else s
            for r, s, t in zip(reasons, direct_s, direct_t)]
    chunks = [0, 0]
    count_decode_chunks(student, chunks, 0)
    count_decode_chunks(teacher, chunks, 1)
    cascade = CascadeEngine.build(student, teacher, policy=policy,
                                  max_batch=1, max_wait_ms=1)
    with cascade:
        cascade.warmup(sorted({im.shape[:2] for im in images}),
                       batch_sizes=(1,))
        chunks[:] = [0, 0]
        reset_launches()
        got, lat, wall = timed_drive(cascade, images, clients=1)
        launches = read_launches()
        chunks = list(chunks)
    snap = cascade.metrics.snapshot()
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(len(g) == len(w), f"cascade frame {i}: {len(g)} people, its "
              f"tier's direct answer {len(w)}")
        for (gk, gs), (wk, ws) in zip(g, w):
            worst = max([worst, abs(gs - ws)] + [
                max(abs(a[0] - b[0]), abs(a[1] - b[1]))
                for a, b in zip(gk, wk) if a is not None and b is not None])
            check(all((a is None) == (b is None) for a, b in zip(gk, wk)),
                  f"cascade frame {i}: other parts than its tier's answer")
    check(worst <= 1e-3, f"cascade: answers off their tiers' direct "
          f"answers by {worst}")
    check(snap["escalated_teacher"] == n_esc
          and snap["degraded_student_answer"] == 0 and snap["failed"] == 0
          and snap["answered_student"] == len(images) - n_esc,
          f"cascade: {snap} against {n_esc} predicted escalations")
    for k, v in launches.items():
        check(v == sum(chunks) and v > 0, f"cascade: {k} launched {v} "
              f"times for {sum(chunks)} batches ({chunks})")
    with DynamicBatcher(teacher, max_batch=1, max_wait_ms=1) as server:
        server.warmup(sorted({im.shape[:2] for im in images}),
                      batch_sizes=(1,))
        teacher_only, t_lat, t_wall = timed_drive(server, images, clients=1)
    ap = oks_ap(ids, got, gts)
    print(f"[10b cascade] {policy}: {n_esc} of {len(images)} val frames "
          f"escalate as the student's direct signals predict "
          f"(escalation rate {snap['escalation_rate']:.4f}, by reason "
          f"{snap['escalations']}); every answer its tier's direct answer "
          f"within {worst:.3g}; ms an image, one client: cascade "
          f"{1e3 * wall / len(images):.2f}, teacher only "
          f"{1e3 * t_wall / len(images):.2f}; OKS AP: cascade {ap:.4f}, "
          f"student {oks_ap(ids, direct_s, gts):.4f}, teacher "
          f"{oks_ap(ids, teacher_only, gts):.4f}; decode launches "
          f"{launches} = student + teacher batches {chunks} [{smi}]")
    return launches


def read_worker_generations(paths) -> list:
    """One record a spawned worker generation in the event shards: its
    pid, and, where it reached ``worker_stop``, the requests it served
    and each decode kernel's launches after its warmup (``worker_stop``
    minus ``worker_warm``); a generation killed before its stop has
    ``stopped`` False and no counts."""
    gens = []
    for path in paths:
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec["event"] == "run_start":
                    gen = {"pid": None, "stopped": False}
                    gens.append(gen)
                    warm = {"served": 0, "kernel_launches": {
                        k: 0 for k in DECODE_KERNELS}}
                elif rec["event"] == "worker_start":
                    gen["pid"] = rec["pid"]
                elif rec["event"] == "worker_warm":
                    warm = rec
                elif rec["event"] == "worker_stop":
                    gen.update(stopped=True,
                               served=rec["served"] - warm["served"],
                               launches={k: rec["kernel_launches"][k]
                                         - warm["kernel_launches"][k]
                                         for k in DECODE_KERNELS})
    return gens


def process_router(dev, smi, ctx, val, reps, work):
    """Phase 10(c): ``ProcessRouter`` of 2 spawned workers, each building
    ``serve.artifacts:checkpoint_predictor`` on the card from a JSON
    spec.  Returns the workers' decode launches."""
    import signal

    from improved_body_parts_torch.obs import Registry
    from improved_body_parts_torch.obs.fleet import verify_postmortem
    from improved_body_parts_torch.serve import (
        DynamicBatcher,
        EnginePool,
        ProcessRouter,
    )

    ids, images, gts = val
    spec = "improved_body_parts_torch.serve.artifacts:checkpoint_predictor"
    kw = dict(config=SYNTH_AP["config"], checkpoint=ctx["checkpoint"],
              params_dtype="fp32", boxsize=ctx["net"], device=dev.type)
    sink = os.path.join(work, "router_events.jsonl")
    sizes = sorted({im.shape[:2] for im in images} | {BURST_SHAPE})
    rng = np.random.default_rng(11)
    burst = [rng.integers(0, 256, (*BURST_SHAPE, 3), dtype=np.uint8)
             for _ in range(32)]

    # the in-process pool at the workers' batch (1)
    with EnginePool([DynamicBatcher(r, max_batch=1, max_wait_ms=1)
                     for r in reps], wedge_timeout_s=WEDGE_S) as pool:
        pool.warmup(sizes, batch_sizes=(1,))
        ref = drive(pool, images, clients=2)
    reg = Registry()
    t0 = time.perf_counter()
    router = ProcessRouter(spec, num_workers=2, spec_kwargs=kw,
                           sink_path=sink, restart_after_s=1.0,
                           wedge_timeout_s=WEDGE_S, drain_timeout_s=30.0,
                           max_image_hw=BURST_SHAPE, num_parts=COCO_PARTS,
                           max_people=P_MAX, slots=40,
                           warmup_timeout_s=300.0)
    router.register_into(reg)
    try:
        router.start()
        router.warmup(sizes, batch_sizes=[1])
        start_s = time.perf_counter() - t0
        pids = [w.worker_stats()["pid"] for w in router.workers]
        got = drive(router, images, clients=2)
        check(all(isinstance(r, tuple) and r[1] is not None for r in got),
              "router: a result without its escalation signals")
        same = sum(people == want for (people, _), want in zip(got, ref))
        check(same == len(images), f"router: {len(images) - same} of "
              f"{len(images)} val person tables differ from the in-process "
              f"pool's at max_batch 1; first: {got[0][0][:1]} against "
              f"{ref[0][:1]}")
        _, lat, wall = timed_drive(router, burst, clients=4)
        c0 = router.metrics.completed
        kill = {}

        def killer():
            # kill mid-serve: after two completions, at a moment worker
            # 0's flight ring ends in a pickup (a request on the card)
            deadline = time.time() + 120
            w0 = router.workers[0]

            def serving():
                recs = w0.flight_records()["records"]
                return bool(recs) and recs[-1]["kind"] in ("pickup",
                                                           "exec_done")

            while time.time() < deadline and not (
                    router.metrics.completed >= c0 + 2
                    and w0.worker_info()["in_flight"] > 0 and serving()):
                time.sleep(0.001)
            kill["in_flight"] = w0.worker_info()["in_flight"]
            kill["t"] = time.perf_counter()
            os.kill(pids[0], signal.SIGKILL)

        import threading

        t = threading.Thread(target=killer)
        t.start()
        try:
            again = drive(router, burst, clients=4)
        except Exception as e:  # noqa: BLE001 -- reported as the gate
            fail(f"router: a future failed across the SIGKILL: {e!r}")
        t.join(timeout=120)
        check(len(again) == 32 and all(isinstance(r, tuple) for r in again),
              "router: a future resolved without people across the kill")
        w0 = router.workers[0]
        deadline = time.time() + 300
        served0 = None
        while time.time() < deadline:
            st = w0.worker_stats()
            if st["pid"] not in (None, pids[0]) and st["served"] > 0:
                served0 = st
                break
            if w0.health()["running"]:
                router.submit(burst[0]).result(timeout=300)
            else:
                time.sleep(0.05)
        respawn_s = time.perf_counter() - kill["t"]
        check(served0 is not None, "router: worker 0 did not serve again "
              "from a fresh pid")
        counters = router.counters()
        m = router.metrics
        pm = router.last_postmortems()[0]
        ok, problems = verify_postmortem(pm)
        check(ok, f"router: postmortem does not verify: {problems}")
        text = reg.prometheus()
        up = [ln for ln in text.splitlines()
              if ln.startswith("fleet_worker_up{")]
        check(any('worker="0"' in ln for ln in up)
              and any('worker="1"' in ln for ln in up),
              f"router: the fleet scrape lacks a worker label: {up}")
        fleet = router.fleet_state()
    finally:
        router.stop(drain_timeout_s=60.0)
    check(m.failed == 0 and counters["failovers"] >= 1,
          f"router: failed {m.failed}, failovers {counters['failovers']}")
    gens = read_worker_generations([f"{sink}.p{i + 1}" for i in range(2)])
    stopped = [g for g in gens if g["stopped"]]
    killed = [g["pid"] for g in gens if not g["stopped"]]
    check(len(stopped) == 2 and killed == [pids[0]],
          f"router: worker generations {gens}: expected two that stopped "
          f"and the killed pid {pids[0]}")
    for g in stopped:
        for k, n in g["launches"].items():
            check(n == g["served"] > 0, f"router: worker pid {g['pid']} "
                  f"launched {k} {n} times after its warmup for "
                  f"{g['served']} requests served")
    launches = {k: sum(g["launches"][k] for g in stopped)
                for k in DECODE_KERNELS}
    fallbacks = sum(any((s.peak_overflow, s.cand_overflow,
                         s.person_overflow))
                    for _, s in got + again if s is not None)
    print(f"[10c router] 2 spawned workers, checkpoint_predictor on cuda "
          f"from a JSON spec: started and warmed in {start_s:.2f} s (pids "
          f"{pids}); {len(images)} val person tables equal bit for bit to "
          f"the in-process pool's at max_batch 1; burst of 32 from 4 "
          f"threads {32 / wall:.2f} imgs/s, e2e p50 {pct(lat, 50):.2f} ms, "
          f"p99 {pct(lat, 99):.2f} ms [{smi}]")
    print(f"[10c router] SIGKILL of worker 0 (pid {pids[0]}) with "
          f"{kill.get('in_flight')} requests in flight during a second "
          f"burst of 32: 0 lost futures, failovers "
          f"{counters['failovers']}, fenced {counters['fenced']}, respawns "
          f"{counters['worker_respawns']}; worker 0 served again from pid "
          f"{served0['pid']} {respawn_s:.2f} s after the kill; postmortem "
          f"verified (in flight {pm['in_flight']}, last hop "
          f"{pm['last_completed_hop']}); fleet conservation "
          f"{fleet['conservation']}; router submitted {m.submitted}, "
          f"completed {m.completed}, failed {m.failed}")
    print(f"[10c router] decode kernel launches after warmup in the 2 "
          f"worker generations that stopped (pids "
          f"{[g['pid'] for g in stopped]}): {launches}, each kernel once a "
          f"request served {[g['served'] for g in stopped]}; the killed "
          f"generation (pid {killed[0]}) is left out, its counts died with "
          f"it; results whose signals overflowed to the host decode: "
          f"{fallbacks} of {len(got) + len(again)} [{smi}]")
    return launches


def serving_beyond_one_batcher(dev, smi, ctx, stub_maps, planted, work):
    """Phase 10: (a)-(c).  Returns the decode launches by path."""
    t0 = time.perf_counter()
    val = val_set(ctx)
    pool_launches, reps = replica_pool(dev, smi, ctx, stub_maps, planted,
                                       val)
    marks = [("a", time.perf_counter())]
    launches = {"pool": pool_launches,
                "cascade": cascade_tiers(dev, smi, ctx, val)}
    marks.append(("b", time.perf_counter()))
    launches["router_stopped_workers"] = process_router(dev, smi, ctx, val,
                                                        reps, work)
    marks.append(("c", time.perf_counter()))
    print(f"[10 serving] phase took {marks[-1][1] - t0:.1f} s "
          f"({laps(t0, marks)} s)")
    return launches


# ---------------------------------------------------------------------- #
# phase 11: live video streams, and the run telemetry                    #
# ---------------------------------------------------------------------- #
# 4 streams of 48 drawn 480x640 frames, 1-2 people each; the fast path's
# ROI crop keeps the frame's height and half its width
STREAMS = dict(frames=48, size=(480, 640), people=(1, 2, 1, 2), seed=1100)
ROI_WIDTH = 320
FIT_STEPS = 16


def stamped(frame, t: int):
    """``frame`` with ``t`` stamped into its pixel (0, 0) as
    ``SyntheticVideo.stamped_frame`` stamps every pixel, so
    ``stream.read_stamp`` reads the frame's index back."""
    out = frame.copy()
    out[0, 0] = (t & 0xFF, 0, 0xA0)
    return out


def stream_videos():
    """The phase's videos and their stamped frames, rendered up front."""
    from improved_body_parts_torch.stream import SyntheticVideo

    vids = [SyntheticVideo(seed=STREAMS["seed"] + i, num_people=p,
                           size=STREAMS["size"],
                           num_frames=STREAMS["frames"])
            for i, p in enumerate(STREAMS["people"])]
    return vids, [[stamped(v.frame(t), t) for t in range(v.num_frames)]
                  for v in vids]


def drive_streams(manager, frames, fastpath=None, on_done=None):
    """Each stream closed loop from its own client thread through its own
    session of ``manager``: every frame submitted as the session admits
    it.  Returns, per stream, each frame's tracked people (or the
    exception its future carried), the frame stamps in the order the
    futures completed, and the closed session's snapshot; and the wall
    seconds."""
    import threading

    from improved_body_parts_torch.stream import read_stamp

    sessions = [manager.open(f"cam{i}", fastpath=fastpath)
                for i in range(len(frames))]
    outs = [dict(results=[None] * len(f), order=[]) for f in frames]
    lock, errors = threading.Lock(), []

    def client(i):
        try:
            futs = []
            for img in frames[i]:
                fut = sessions[i].submit_frame(img)

                def done(_, i=i, t=read_stamp(img)[0]):
                    with lock:
                        outs[i]["order"].append(t)
                    if on_done is not None:
                        on_done()

                fut.add_done_callback(done)
                futs.append(fut)
            for t, fut in enumerate(futs):
                try:
                    outs[i]["results"][t] = fut.result(timeout=300)
                except Exception as e:  # noqa: BLE001 — counted below
                    outs[i]["results"][t] = e
        except Exception as e:  # noqa: BLE001 — surfaced by the check
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(frames))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    check(not errors, f"streams: a client failed: {errors[:1]}")
    for i, s in enumerate(sessions):
        check(s.close(timeout_s=120), f"stream {i}: close did not drain")
        outs[i]["snapshot"] = s.snapshot()
    return outs, wall


def stream_quality(vids, outs):
    """Synthetic AP of every delivered frame against the generator's
    ground truth (``cli.stream_bench.SyntheticAP``), and each stream's
    identity switches."""
    from improved_body_parts_torch.cli.stream_bench import SyntheticAP
    from improved_body_parts_torch.stream import IdentitySwitchCounter

    ap, switches = SyntheticAP(), []
    for vid, out in zip(vids, outs):
        counter = IdentitySwitchCounter()
        for t, tracked in enumerate(out["results"]):
            if isinstance(tracked, list):
                ap.update(vid.gt(t), tracked)
                counter.update(vid.gt(t), tracked)
        switches.append(counter.switches)
    return ap.value(), switches


def check_streams(outs, label: str, lossless: bool = True) -> dict:
    """Each stream's ledger: delivery in frame order, submitted =
    delivered + dropped + failed + in flight (0 after close), and (where
    ``lossless``) every frame delivered.  Returns the arm's summary."""
    n = STREAMS["frames"]
    for i, out in enumerate(outs):
        snap = out["snapshot"]
        check(out["order"] == list(range(n)), f"{label}: stream {i} "
              f"completed frames in the order {out['order']}")
        check(all(r is not None for r in out["results"]),
              f"{label}: stream {i} lost a future")
        check(snap["frames_submitted"] == snap["frames_delivered"]
              + snap["frames_dropped"] + snap["frames_failed"]
              + snap["in_flight"] and snap["in_flight"] == 0,
              f"{label}: stream {i} ledger {snap}")
        if lossless:
            check(snap["frames_delivered"] == n, f"{label}: stream {i} "
                  f"delivered {snap['frames_delivered']} of {n}")
    snaps = [o["snapshot"] for o in outs]
    return dict(
        fps=[s["fps"] for s in snaps],
        p50=[round(s["e2e_latency_ms"]["p50"], 2) for s in snaps],
        p95=[round(s["e2e_latency_ms"]["p95"], 2) for s in snaps],
        delivered=sum(s["frames_delivered"] for s in snaps),
        dropped=sum(s["frames_dropped"] for s in snaps),
        failed=sum(s["frames_failed"] for s in snaps))


def capture_by_shape(pred, store: dict):
    """``pred.decode_maps`` wrapped to keep a clone of the arguments of
    its first call at each map (H, W): one batch of each lane bucket the
    streams ran."""
    import torch

    fn = pred.decode_maps

    def wrapper(*args):
        key = tuple(args[0].shape[1:3])
        if key not in store:
            store[key] = tuple(a.detach().clone()
                               if isinstance(a, torch.Tensor) else a
                               for a in args)
        return fn(*args)

    pred.decode_maps = wrapper


def history_feed(store) -> dict:
    """What a control loop reads of a history store, as one comparable
    document (every series' latest value and raw ring, the signals)."""
    return {"keys": store.keys(), "signals": store.signals(),
            "series": {k: (store.latest(k), store.query(k)["points"],
                           store.rate(k, 5.0))
                       for k in store.keys()}}


def http_json(url):
    """(status, JSON body) of a GET, the error statuses included."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def streams_over_one_batcher(dev, smi, ctx, pred, vids, frames, reg,
                             watch, captured):
    """Phase 11 (a) and (b).  Returns the decode launches by path."""
    import dataclasses

    import torch

    from improved_body_parts_torch.cli.stream_bench import fastpath_block
    from improved_body_parts_torch.serve import DynamicBatcher
    from improved_body_parts_torch.stream import (
        FastPathConfig,
        SessionManager,
    )

    h, w = STREAMS["size"]
    chunks = [0]
    count_decode_chunks(pred, chunks, 0)
    launches = {}
    with DynamicBatcher(pred, max_batch=8, max_wait_ms=25, max_queue=64,
                        emit_signals=True, registry=reg) as server:
        t0 = time.perf_counter()
        info = server.warmup([(h, w), (h, ROI_WIDTH)])
        warm_s = time.perf_counter() - t0
        watch.mark_warm("stream buckets warmed")
        # after the warmup, whose batches are blank images
        capture_by_shape(pred, captured)
        first0 = watch.recompiles.value
        manager = SessionManager(server, registry=reg, max_in_flight=4)
        chunks[0] = 0
        reset_launches()
        outs, wall = drive_streams(manager, frames)
        torch.cuda.synchronize()
        launches["stream"] = read_launches()
        n_chunks = chunks[0]
        arm = check_streams(outs, "11a streams")
        ap, switches = stream_quality(vids, outs)
        first_a = watch.recompiles.value - first0
        check(first_a == 0, f"11a streams: {first_a} lane shapes ran first "
              "after warmup")
        for k, v in launches["stream"].items():
            check(v == n_chunks and v > 0, f"11a streams: {k} launched {v} "
                  f"times for {n_chunks} fused-lane batches")
        check(ap >= 0.5, f"11a streams: synthetic AP {ap:.4f} < 0.5")
        print(f"[11a streams] {len(frames)} streams x {STREAMS['frames']} "
              f"drawn {h}x{w} frames ({STREAMS['people']} people) through "
              f"a SessionManager over one DynamicBatcher (max_batch 8, "
              f"emit_signals) of synth_canonical fp32 at boxsize "
              f"{ctx['net']}; warmup {info['bucket_shapes']} x "
              f"{info['batch_sizes']} in {warm_s:.2f} s, 0 lane shapes "
              f"first after it; every stream in frame order, ledgers "
              f"exact, {arm['delivered']} delivered: synthetic AP "
              f"{ap:.4f}, identity switches {switches}, per-stream FPS "
              f"{arm['fps']}, e2e p50 {arm['p50']} ms, p95 {arm['p95']} "
              f"ms, aggregate {arm['delivered'] / wall:.2f} fps; decode "
              f"launches {launches['stream']} = the {n_chunks} fused-lane "
              f"batches [{smi}]")

        cfg = FastPathConfig(roi_width=ROI_WIDTH)
        fp_manager = SessionManager(server, max_in_flight=4)
        chunks[0] = 0
        reset_launches()
        first0 = watch.recompiles.value
        on, wall_on = drive_streams(fp_manager, frames, fastpath=cfg)
        torch.cuda.synchronize()
        launches["stream_fastpath"] = read_launches()
        n_chunks = chunks[0]
        off, wall_off = drive_streams(fp_manager, frames)
        first_b = watch.recompiles.value - first0
    arm_on = check_streams(on, "11b fast path")
    arm_off = check_streams(off, "11b full-frame arm")
    block = fastpath_block([o["snapshot"] for o in on])
    cons = block["conservation"]
    ap_on, sw_on = stream_quality(vids, on)
    ap_off, sw_off = stream_quality(vids, off)
    check(cons["exact"] and cons["submitted"] == len(frames)
          * STREAMS["frames"], f"11b fast path: conservation {cons}")
    check(cons["answered_roi"] > 0, f"11b fast path: no frame took the "
          f"ROI tier ({cons})")
    check(first_b == 0, f"11b fast path: {first_b} lane shapes ran first "
          "after warmup")
    check(min(ap_on, ap_off) >= 0.5, f"11b fast path: synthetic AP on "
          f"{ap_on:.4f}, off {ap_off:.4f}")
    for k, v in launches["stream_fastpath"].items():
        check(v == n_chunks and v > 0, f"11b fast path: {k} launched {v} "
              f"times for {n_chunks} fused-lane batches")
    fps_on = arm_on["delivered"] / wall_on
    fps_off = arm_off["delivered"] / wall_off
    print(f"[11b fast path] FastPathConfig({dataclasses.asdict(cfg)}): "
          f"tier mix tracker {cons['answered_tracker']}, roi "
          f"{cons['answered_roi']}, full {cons['escalated_full']} of "
          f"{cons['submitted']} (conservation exact), escalations "
          f"{ {k: v for k, v in block['escalations'].items() if v} }; "
          f"synthetic AP on {ap_on:.4f} / off {ap_off:.4f}, identity "
          f"switches on {sw_on} / off {sw_off}; aggregate {fps_on:.2f} "
          f"fps on, {fps_off:.2f} off (ratio {fps_on / fps_off:.3f}, "
          f"reported, not gated); per-stream FPS on {arm_on['fps']}, e2e "
          f"p50 {arm_on['p50']} ms; 0 lane shapes first after warmup; "
          f"decode launches {launches['stream_fastpath']} = the "
          f"{n_chunks} fused-lane batches of the on arm [{smi}]")
    del pred._run_chunk, pred.decode_maps
    return launches


def streams_over_a_pool(dev, smi, pred, frames, watch):
    """Phase 11 (c).  Returns the decode launches of the path."""
    import threading

    import torch

    from improved_body_parts_torch.serve import DynamicBatcher, EnginePool
    from improved_body_parts_torch.stream import SessionManager

    h, w = STREAMS["size"]
    reps = [pred.device_replica("cuda") for _ in range(2)]
    chunks = [0, 0]
    for i, r in enumerate(reps):
        count_decode_chunks(r, chunks, i)
    engines = [DynamicBatcher(r, max_batch=8, max_wait_ms=25,
                              max_queue=64, emit_signals=True)
               for r in reps]
    delivered, stopped = [0], threading.Event()
    pool = EnginePool(engines, wedge_timeout_s=WEDGE_S,
                      drain_timeout_s=10.0)
    with pool:
        pool.warmup([(h, w)])
        first0 = watch.recompiles.value
        chunks[:] = [0, 0]
        reset_launches()

        def on_done():
            delivered[0] += 1
            if delivered[0] == 8:
                stopped.set()

        state = {}

        def stop_replica_0():
            stopped.wait(300)
            state["in_flight"] = engines[0].metrics.depth
            engines[0].stop(drain_timeout_s=0.0)

        stopper = threading.Thread(target=stop_replica_0)
        stopper.start()
        outs, wall = drive_streams(SessionManager(pool, max_in_flight=4),
                                   frames, on_done=on_done)
        stopper.join(timeout=300)
        counters = pool.counters()
        m = pool.metrics
        states = [s["state"] for s in pool.replica_states()]
        first_c = watch.recompiles.value - first0
    join_serve_threads()
    torch.cuda.synchronize()
    launches = read_launches()
    arm = check_streams(outs, "11c pool", lossless=False)
    check(m.submitted == m.completed + m.failed + m.depth and m.depth == 0,
          f"11c pool: submitted {m.submitted} != completed {m.completed} "
          f"+ failed {m.failed} + depth {m.depth}")
    check(counters["failovers"] >= 1, f"11c pool: no failover after "
          f"replica 0 stopped ({counters})")
    n_chunks = sum(chunks)
    for k, v in launches.items():
        check(v == n_chunks and v > 0, f"11c pool: {k} launched {v} times "
              f"for {n_chunks} fused-lane batches")
    print(f"[11c pool] the same streams through a SessionManager over an "
          f"EnginePool of 2 device_replica batchers, replica 0 stopped "
          f"(drain 0 s) after 8 delivered frames with "
          f"{state.get('in_flight')} requests on it: 0 futures lost, "
          f"every stream in frame order, {arm['delivered']} delivered, "
          f"{arm['dropped']} dropped, {arm['failed']} failed; failovers "
          f"{counters['failovers']}, frames migrated (resubmitted) "
          f"{counters['resubmitted']}, fenced {counters['fenced']}, "
          f"replica states {states}; pool submitted {m.submitted} = "
          f"completed {m.completed} + failed {m.failed} + depth "
          f"{m.depth}; per-stream FPS {arm['fps']}, aggregate "
          f"{arm['delivered'] / wall:.2f} fps; {first_c:.0f} lane shapes "
          f"first after the pool's warmup; decode launches {launches} = "
          f"the {n_chunks} fused-lane batches ({chunks}) [{smi}]")
    return launches


def history_of_the_streams(smi, store, reg, path):
    """Phase 11 (e), first half: the store sampled during (a)-(c)."""
    from improved_body_parts_torch.obs import HistoryStore, MetricsServer
    from improved_body_parts_torch.serve import CapacityModel

    live = history_feed(store)
    replayed = HistoryStore.replay(path)
    check(history_feed(replayed) == live, "11e history: the shards do not "
          "replay bit for bit")
    doc = store.doc()
    check(doc["samples"] >= 8 and doc["series"] > 0,
          f"11e history: {doc['samples']} samples of {doc['series']} "
          "series")
    with MetricsServer(reg, port=0, history=store) as srv:
        code_h, body = http_json(srv.url + "/history")
        code_q, q = http_json(srv.url + "/query?series="
                              "serve_completed_total&step=1")
    check(code_h == 200 and body["samples"] == doc["samples"],
          f"11e history: /history answered {code_h}")
    check(code_q == 200 and q["points"], f"11e history: /query answered "
          f"{code_q}")
    model = CapacityModel.fit(store, window_s=1.0, prefix="serve",
                              max_batch=8)
    need = model.replicas_needed(100.0)
    print(f"[11e history] HistoryStore at a 0.25 s cadence over the "
          f"phase's registry during (a)-(c): {doc['samples']} samples of "
          f"{doc['series']} series, {doc['gaps']['count']} gaps, "
          f"{doc['persist']['shards']} shard(s) of "
          f"{doc['persist']['records']} records replayed bit for bit; "
          f"/history and /query answered 200 on an ephemeral port; "
          f"CapacityModel.fit(prefix serve, 1 s windows): "
          f"{len(model.points)} windows, qps "
          f"{[round(p['qps'], 2) for p in model.points]}, mean ms "
          f"{[round(p['mean_ms'], 2) for p in model.points]}, knee "
          f"{model.knee_qps} qps at objective {model.objective_ms} ms; "
          f"replicas for 100 qps: {need['replicas']} [{smi}]")


def fit_under_telemetry(dev, smi, ctx, work):
    """Phase 11 (e), second half: ``fit`` of ``synth_canonical`` under
    ``RunTelemetry``, then a divergent window under halt and under warn.
    Returns the focal launches of the fit."""
    import dataclasses

    import torch

    from improved_body_parts_torch.cli.train import train
    from improved_body_parts_torch.config import get_config
    from improved_body_parts_torch.data import MemoryDataset
    from improved_body_parts_torch.obs import (
        DivergenceError,
        Registry,
        RunTelemetry,
    )
    from improved_body_parts_torch.ops import losses

    base = get_config(SYNTH_AP["config"])
    bs = base.train.batch_size_per_device
    records = ctx["records"][:FIT_STEPS * bs]
    sink = os.path.join(work, "p11_events.jsonl")
    trace = os.path.join(work, "p11_trace.json")
    cfg = base.replace(train=dataclasses.replace(
        base.train, checkpoint_dir=os.path.join(work, "p11_fit"),
        print_freq=4, keep_last_n=1))
    calls, fused = [], losses.focal_l2_fused
    losses.focal_l2_fused = first_calls(fused, 5, calls)
    tele = RunTelemetry(sink, http_port=0, trace_path=trace,
                        registry=Registry(), device=dev,
                        run_meta={"tool": "chip_smoke", "phase": 11})
    reset_focal()
    t0 = time.perf_counter()
    try:
        _, run = train(cfg, MemoryDataset(records, cfg, seed=0), 1,
                       device=dev, log_fn=lambda s: None, telemetry=tele)
        counts = focal_counts()
        code, health = http_json(tele.server.url + "/healthz")
    finally:
        losses.focal_l2_fused = fused
        tele.close()
    wall = time.perf_counter() - t0
    with open(sink) as f:
        events = [json.loads(line, parse_constant=fail) for line in f]
    names = [e["event"] for e in events]
    with open(trace) as f:
        spans = json.load(f)["traceEvents"]
    want = {k: 5 * FIT_STEPS for k in FOCAL_KERNELS}
    check(run["steps"] == FIT_STEPS and counts == want,
          f"11e fit: {run['steps']} steps, focal launches {counts}, "
          f"expected {want}")
    check(code == 200 and health["status"] == "ok",
          f"11e fit: /healthz {code} {health.get('status')}")
    check(names.count("train_step") == FIT_STEPS // 4
          and names.count("health") == FIT_STEPS // 4
          and "epoch" in names and "trace_export" in names,
          f"11e fit: events {sorted(set(names))}")
    check(any(s.get("name") == "step_window" for s in spans),
          "11e fit: no step_window span in the saved trace")
    check(len(calls) == 5, f"11e fit: captured {len(calls)} focal calls")
    hold_focal(calls, torch.tensor(cfg.train.nstack_weight, device=dev)
               * 0.25, "the telemetry fit's first step", tag="[11e fit]")
    gnorms = [e["grad_norm"] for e in events if e["event"] == "health"]
    print(f"[11e fit] cli.train.train of {SYNTH_AP['config']}, one epoch "
          f"of {run['steps']} steps under RunTelemetry(sink, http_port=0, "
          f"trace_path) with the sentinel: /healthz 200, "
          f"{len(events)} events, every line strict JSON "
          f"({sorted(set(names))}), {len(spans)} trace events saved; "
          f"grad norms read at the windows {gnorms}; median step "
          f"{run['step_ms_median']:.2f} ms (CUDA events), "
          f"{run['train_imgs_per_s']:.2f} imgs/s; focal launches {counts} "
          f"(5 a step); {wall:.1f} s with the save [{smi}]")

    for policy in ("halt", "warn"):
        cfg = base.replace(train=dataclasses.replace(
            base.train, print_freq=1, keep_last_n=1, on_divergence=policy,
            health_grad_norm_limit=1e-9,
            checkpoint_dir=os.path.join(work, f"p11_{policy}")))
        tele = RunTelemetry(None, http_port=0, registry=Registry(),
                            device=dev, on_divergence=policy,
                            grad_norm_limit=1e-9)
        raised = None
        try:
            try:
                train(cfg, MemoryDataset(records[:2 * bs], cfg, seed=0), 1,
                      device=dev, log_fn=lambda s: None, telemetry=tele)
            except DivergenceError as e:
                raised = str(e)
            code, body = http_json(tele.server.url + "/healthz")
        finally:
            tele.close()
        if policy == "halt":
            check(raised is not None and "grad_norm_over_limit" in raised
                  and code == 503 and body["checks"] == 1,
                  f"11e halt: raised {raised!r}, /healthz {code} {body}")
        else:
            check(raised is None and code == 503 and body["checks"] == 2
                  and body["divergences"] == 2,
                  f"11e warn: raised {raised!r}, /healthz {code} {body}")
        print(f"[11e {policy}] health_grad_norm_limit 1e-9, one window a "
              f"step: {'DivergenceError at the first window' if raised else 'trained on'}"
              f", /healthz {code}, {body['checks']} windows checked, "
              f"{body['divergences']} divergent, last "
              f"{body['last']['reasons']}")
    return counts


def live_streams(dev, smi, ctx, work):
    """Phase 11: (a)-(e).  Returns the launches by path."""
    import torch

    from improved_body_parts_torch.obs import (
        CompileWatch,
        HistoryStore,
        Registry,
    )
    from improved_body_parts_torch.serve import checkpoint_predictor

    t0 = time.perf_counter()
    vids, frames = stream_videos()
    pred = checkpoint_predictor(SYNTH_AP["config"], ctx["checkpoint"],
                                params_dtype="fp32", boxsize=ctx["net"],
                                device=dev)
    reg = Registry()
    watch = CompileWatch(reg).install()
    hist_path = os.path.join(work, "p11_history.jsonl")
    store = HistoryStore(reg, cadence_s=0.25, persist_path=hist_path,
                         run_id="chip_smoke-11").register_into(reg)
    captured = {}
    store.start()
    try:
        launches = streams_over_one_batcher(dev, smi, ctx, pred, vids,
                                            frames, reg, watch, captured)
        marks = [("a-b", time.perf_counter())]
        launches["stream_pool"] = streams_over_a_pool(dev, smi, pred,
                                                      frames, watch)
        marks.append(("c", time.perf_counter()))
    finally:
        store.close()
        watch.uninstall()
    # (d) the decode kernels at the full-frame and the ROI bucket's maps
    check(len(captured) == 2, f"11d kernels: captured the lane's maps at "
          f"{sorted(captured)}, expected the full-frame and ROI buckets")
    # the wider map is the full frame's bucket, the narrower the ROI's
    for name, shape in zip(("full-frame", "ROI"),
                           sorted(captured, key=lambda s: -s[1])):
        hold_lane_call(pred.skeleton, captured[shape], f"a stream batch "
                       f"of the {name} bucket", smi, tag="[11d kernels]")
    history_of_the_streams(smi, store, reg, hist_path)
    marks.append(("d + history", time.perf_counter()))
    del pred, captured
    torch.cuda.empty_cache()
    launches["telemetry"] = fit_under_telemetry(dev, smi, ctx, work)
    marks.append(("fit", time.perf_counter()))
    print(f"[11 streams] phase took {marks[-1][1] - t0:.1f} s "
          f"({laps(t0, marks)} s)")
    return launches


# ------------------------------------------- 12. multi-card training
P12_WARM, P12_STEPS = 2, 5       # steps of each (a) arm: warm-up, timed
P12_RULES = ("replicated", "imhn_fsdp")
# (b)'s arms, (precision, ruleset); the float64 one's checkpoint is (c)'s
P12_ARMS = (("float64", "replicated"), ("float32", "replicated"),
            ("float32", "imhn_fsdp"), ("bf16", "replicated"))
P12_FLOORS = (1e-5, 1e-3, 1e-5)  # loss rel, grad norm rel, BN stats abs
P12_ROUNDING = 5.0   # (b): the two ranks' distance from float64 / plain's
P12_BN_TOL = 1e-5    # (a): cross-rank BN on one rank vs F.batch_norm


def p12_batch(records, cfg, rows: int, seed: int):
    """``rows`` drawn training rows at ``cfg``'s input (uint8 wire)."""
    (batch,) = host_batches(cfg, records[seed * rows:], 1, rows)
    return batch


def busy_share(step, state, dev_batch, steps: int = 2):
    """(device busy share, kernel ms a step, wall ms a step, the kernel
    groups taking most device time) of ``steps`` back-to-back steps under
    ``utils.profiling.device_window`` (user annotations, such as DDP's
    forward range, are not counted as device time); None for the first
    two when the profiler records no kernel."""
    from improved_body_parts_torch.utils.profiling import device_window

    window = device_window(lambda: step(state, *dev_batch), steps)
    wall = window.wall_s
    groups, other = {}, {}
    for name, (ns, _) in window.activity.items():
        g = kernel_group(name)
        t = ns / 1e3
        groups[g] = groups.get(g, 0.0) + t
        if g == "other":
            other[name[:60]] = other.get(name[:60], 0.0) + t
    us = sum(groups.values())
    top = ", ".join(f"{g} {t / 1e3 / steps:.2f}" for g, t in sorted(
        groups.items(), key=lambda kv: -kv[1])[:4])
    if other:
        top += "; 'other' by kernel: " + ", ".join(
            f"{n} {t / 1e3 / steps:.2f}" for n, t in sorted(
                other.items(), key=lambda kv: -kv[1])[:2])
    if not us:
        return None, None, 1e3 * wall / steps, top
    return us / 1e6 / wall, us / 1e3 / steps, 1e3 * wall / steps, top


def world_one_nccl(dev, smi, cfg, records, sync):
    """12(a): ``make_train_step(mesh=make_mesh(1, 1), rules=...)`` under
    NCCL at world 1 for each of ``P12_RULES``, held to the plain step's
    first update, then timed, and the cross-rank BatchNorm held to the
    one-rank path's (:func:`bn_one_rank`).  Returns the focal launches."""
    import torch

    from improved_body_parts_torch.models import build_model
    from improved_body_parts_torch.ops import losses
    from improved_body_parts_torch.parallel import (
        get_ruleset,
        make_mesh,
        train_state_shardings,
        sharding_summary,
    )
    from improved_body_parts_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
        step_decay_schedule,
    )
    from improved_body_parts_torch.train.step import to_device

    bs = cfg.train.batch_size_per_device
    batches = [to_device(p12_batch(records, cfg, bs, i), dev)
               for i in range(P12_WARM + P12_STEPS)]
    mesh = make_mesh(1, 1, device="cuda")
    check(torch.distributed.get_backend() == "nccl",
          f"12a: the process group runs {torch.distributed.get_backend()}")

    def state_of():
        model = build_model(cfg, device=dev, seed=0, train=True)
        opt = make_optimizer(model, cfg, step_decay_schedule(
            cfg.train, steps_per_epoch=P12_WARM + P12_STEPS))
        return create_train_state(model, cfg, opt)

    ref = state_of()
    plain = make_train_step(ref.model, cfg, ref.optimizer)
    _, ref_loss = plain(ref, *batches[0])
    ref_sd = {k: v.detach().clone() for k, v in
              ref.model.state_dict().items()}
    del ref, plain
    launches = {k: 0 for k in FOCAL_KERNELS}
    calls = []
    for name in P12_RULES:
        state = state_of()
        rules = get_ruleset(name)
        summary = sharding_summary(train_state_shardings(
            state.model, state.optimizer, mesh, rules))
        step = make_train_step(state.model, cfg, state.optimizer,
                               mesh=mesh, rules=rules)
        fused = losses.focal_l2_fused
        if not calls:
            losses.focal_l2_fused = first_calls(fused, 5, calls)
        try:
            state, loss = step(state, *batches[0])
        finally:
            losses.focal_l2_fused = fused
        sd = state.model.state_dict()
        diff = max(float((sd[k].double() - v.double()).abs().max())
                   for k, v in ref_sd.items())
        same = all(torch.equal(sd[k], v) for k, v in ref_sd.items())
        rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        check(torch.equal(loss, ref_loss) and same if name == "replicated"
              else rel <= 1e-6 and diff <= 1e-6,
              f"12a {name}: first step loss rel {rel:.3g}, params max abs "
              f"diff {diff:.3g} against the plain step")
        note = ("" if name == "replicated" else "; at one rank the "
                "refinement splits nothing, so the sharded storage runs "
                "in 12b")
        print(f"[12a world 1] {name} ({summary}{note}): first step loss "
              f"{float(loss):.6f} against the plain step's "
              f"{float(ref_loss):.6f} (rel {rel:.3g}); updated parameters "
              f"and BN stats {'equal bit for bit' if same else 'max abs diff ' + format(diff, '.3g')}")
        for batch in batches[1:P12_WARM]:
            state, loss = step(state, *batch)
        reset_focal()
        state, step_losses, step_ms, wall = timed_steps(
            step, state, batches[P12_WARM:], f"12a {name}")
        counts = focal_counts()
        want = {k: 5 * P12_STEPS for k in FOCAL_KERNELS}
        check(counts == want, f"12a {name}: focal launches {counts} in "
              f"{P12_STEPS} steps, expected {want}")
        for k in FOCAL_KERNELS:
            launches[k] += counts[k]
        share, kernel_ms, wall_ms, top = busy_share(step, state,
                                                    batches[-1])
        busy = ("not measured (the profiler recorded no kernel)"
                if share is None else f"{share:.1%} ({kernel_ms:.2f} ms of "
                f"kernels in {wall_ms:.2f} ms a step; by group, ms a step: "
                f"{top})")
        print(f"[12a world 1] {name}: {P12_STEPS} steps at batch {bs} x "
              f"{cfg.skeleton.height}x{cfg.skeleton.width}, bf16 autocast, "
              f"median step {step_ms:.2f} ms (CUDA events; phase 6's plain "
              f"step {sync['step_ms']:.2f} ms), device busy {busy}; focal "
              f"launches {counts}; one card, so no multi-card speed is "
              f"claimed [{smi}]")
        del state, step
        torch.cuda.empty_cache()
    check(len(calls) == 5, f"12a: captured {len(calls)} focal calls")
    hold_focal(calls, torch.tensor(cfg.train.nstack_weight, device=dev)
               * 0.25, "the world-1 step's calls at the per-rank shape",
               tag="[12a world 1]")
    bn_one_rank(dev, smi, batches[0])
    return launches


def flax_fast_bn(bn, x):
    """Flax's train-mode BatchNorm of ``x`` with ``bn``'s affine: the
    variance in the fast form ``mean(x²) - mean(x)²``.  For comparison
    only (12a)."""
    import torch

    dims, shape = (0, 2, 3), (1, -1, 1, 1)
    mean = x.mean(dims)
    var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
    y = (x - mean.view(shape)) * torch.rsqrt(var + bn.eps).view(shape)
    return y * bn.weight.view(shape) + bn.bias.view(shape)


def rel_err(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max())


def bn_one_rank(dev, smi, batch):
    """12(a): every ``BatchNorm`` of float32 ``canonical`` on its
    train-mode input from one forward of ``batch``: the cross-rank path
    over the one-rank group against ``F.batch_norm`` (the one-rank
    path's), forward and the input's gradient of a seeded upstream
    gradient, each relative to the reference's largest value.  Flax's
    fast form on the same inputs is printed beside it."""
    import torch
    import torch.nn.functional as F

    from improved_body_parts_torch.models.layers import BatchNorm
    from improved_body_parts_torch.train.step import (
        normalize_images,
        to_device,
    )

    state, _ = p12_state("float32", dev)
    model = state.model
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {"cross_rank": [0.0, 0.0], "fast": [0.0, 0.0]}

    def hook(m, args):
        x = args[0].detach().requires_grad_(True)
        g = torch.randn(x.shape, device=dev, generator=gen)
        with torch.enable_grad():
            ref = F.batch_norm(x, None, None, m.weight, m.bias, True, 0.0,
                               m.eps)
            (ref_dx,) = torch.autograd.grad(ref, x, g)
            m.group, m.update_stats = torch.distributed.group.WORLD, False
            try:
                for name, fn in (("cross_rank", m._cross_rank),
                                 ("fast", lambda t: flax_fast_bn(m, t))):
                    y = fn(x)
                    (dx,) = torch.autograd.grad(y, x, g)
                    w = worst[name]
                    w[0] = max(w[0], rel_err(y, ref))
                    w[1] = max(w[1], rel_err(dx, ref_dx))
            finally:
                m.group, m.update_stats = None, True

    layers = [m for m in model.modules() if isinstance(m, BatchNorm)]
    hooks = [m.register_forward_pre_hook(hook) for m in layers]
    model.train()
    try:
        with torch.no_grad():
            model(normalize_images(to_device(batch, dev)[0]))
    finally:
        for h in hooks:
            h.remove()
    (fwd, bwd), (fast_fwd, fast_bwd) = worst["cross_rank"], worst["fast"]
    check(fwd <= P12_BN_TOL and bwd <= P12_BN_TOL,
          f"12a: the cross-rank BatchNorm on one rank differs from "
          f"F.batch_norm by rel {fwd:.3g} forward, {bwd:.3g} backward")
    print(f"[12a world 1] cross-rank BatchNorm on the one-rank group "
          f"against F.batch_norm, float32, each of the {len(layers)} "
          f"layers on its train-mode input from canonical at batch "
          f"{batch[0].shape[0]}: worst rel {fwd:.3g} forward, {bwd:.3g} "
          f"input gradient (gate {P12_BN_TOL:g}); Flax's fast variance "
          f"on the same inputs: {fast_fwd:.3g} / {fast_bwd:.3g} [{smi}]")
    del state, model
    torch.cuda.empty_cache()


def p12_rank(rank: int, coord: str, batch, ckpt_dir: str, out) -> None:
    """12(b): one of two gloo ranks over CUDA tensors on card 0.  Runs
    the first step of each of ``P12_ARMS`` on its 2 rows, and saves the
    float64 arm's state (rank 0 writes).  Puts its numbers on ``out``."""
    sys.path.insert(0, ROOT)
    try:
        import hashlib

        import torch

        from improved_body_parts_torch.ops import losses
        from improved_body_parts_torch.parallel import (
            get_ruleset,
            initialize_distributed,
            make_mesh,
            mesh_topology,
            shard_batch,
            shutdown_distributed,
        )
        from improved_body_parts_torch.train import CheckpointManager

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0)
        initialize_distributed(coord, 2, rank, device=dev, backend="gloo")
        mesh = make_mesh(2, 1, device="cuda")
        res = {}
        for kind, rules in P12_ARMS:
            state, step = p12_state(kind, dev, mesh, get_ruleset(rules))
            full = {n: tuple(p.shape)
                    for n, p in state.model.named_parameters()}
            calls, fused = [], losses.focal_l2_fused
            if not res:
                losses.focal_l2_fused = first_calls(fused, 5, calls)
            reset_focal()
            try:
                state, loss, gnorm = step(state, *shard_batch(batch, mesh))
            finally:
                losses.focal_l2_fused = fused
            rec = dict(loss=float(loss), gnorm=float(gnorm),
                       launches=focal_counts())
            if calls:
                hold_focal(calls, torch.tensor(
                    p12_config(kind).train.nstack_weight, device=dev) * 0.25,
                    f"rank {rank}'s calls at the per-rank shape",
                    tag="[12b two ranks]")
            if state.sharding is not None:
                # every split parameter and its momentum hold their chunk
                names = {id(p): n for n, p in
                         state.model.named_parameters()}
                moms = dict(zip(map(id, state.optimizer.params),
                                state.optimizer.momentum))
                chunks = []
                for sp in state.sharding.splits:
                    want = list(full[names[id(sp.param)]])
                    want[sp.dim] //= sp.shards
                    chunks.append(tuple(sp.param.shape) == tuple(want)
                                  and tuple(moms[id(sp.param)].shape)
                                  == tuple(want))
                rec["split"] = (len(chunks), all(chunks))
            if kind == "float64":
                manager = CheckpointManager(ckpt_dir, async_save=False,
                                            topology=mesh_topology(mesh))
                manager.save(state, 0, float(loss), float(loss))
                manager.close()
                torch.distributed.barrier()
                h = hashlib.sha256()
                for k, v in state.model.state_dict().items():
                    h.update(k.encode())
                    h.update(v.detach().cpu().contiguous().numpy()
                             .tobytes())
                rec["sha256"] = h.hexdigest()
            # numpy, not tensors: a tensor crosses the queue as a handle
            # to this process's shared memory, gone once the rank exits
            if rank == 0:
                rec["bn"] = bn_stats(state)
            res[(kind, rules)] = rec
            del state, step
            torch.cuda.empty_cache()
        out.put((rank, res))
        shutdown_distributed()
    except BaseException as e:
        out.put((rank, dict(error=f"{type(e).__name__}: {e}")))
        raise


def p12_config(kind: str):
    """``canonical`` in ``kind``: ``bf16`` is its own config (bf16
    autocast); ``float32`` and ``float64`` leave autocast off, and
    :func:`p12_state` holds the float64 one in float64 (the loss and its
    kernels stay float32: the model's predictions are)."""
    import dataclasses

    from improved_body_parts_torch.config import get_config

    cfg = get_config("canonical")
    return cfg.replace(train=dataclasses.replace(
        cfg.train, bf16_compute=kind == "bf16"))


def p12_state(kind: str, dev, mesh=None, rules=None):
    import torch

    from improved_body_parts_torch.models import build_model
    from improved_body_parts_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
        step_decay_schedule,
    )

    cfg = p12_config(kind)
    model = build_model(cfg, device=dev, seed=0, train=True)
    if kind == "float64":
        model = model.to(torch.float64)
    opt = make_optimizer(model, cfg, step_decay_schedule(
        cfg.train, steps_per_epoch=P12_WARM + P12_STEPS))
    state = create_train_state(model, cfg, opt)
    return state, make_train_step(model, cfg, opt, health=True, mesh=mesh,
                                  rules=rules)


def bn_stats(state):
    """The BN running stats of ``state`` as float64 numpy."""
    return {k: v.detach().double().cpu().numpy()
            for k, v in state.model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def p12_gaps(rec, ref, exact):
    """(loss rel, grad norm rel, BN stats max abs) of ``rec`` from
    ``ref``, and of ``ref`` from the float64 plain step ``exact``."""
    def gaps(a, b):
        return (abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                abs(a["gnorm"] - b["gnorm"]) / abs(b["gnorm"]),
                max(float(np.abs(a["bn"][k] - v).max())
                    for k, v in b["bn"].items()))
    return gaps(rec, ref), gaps(rec, exact), gaps(ref, exact)


def two_ranks_one_card(dev, smi, records, work):
    """12(b) and (c): two gloo ranks on the one card, each arm of
    ``P12_ARMS`` against the plain step in its precision on the same 4
    rows, then the float64 arm's checkpoint restored in this process
    under ``adjust`` and ``refuse``."""
    import hashlib
    import multiprocessing as mp

    import torch

    from improved_body_parts_torch.parallel import make_mesh
    from improved_body_parts_torch.parallel.mesh import free_port
    from improved_body_parts_torch.train import (
        TopologyChanged,
        restore_checkpoint,
    )
    from improved_body_parts_torch.train.supervisor import (
        reshard_on_topology_change,
    )

    cfg = p12_config("float64")
    batch = p12_batch(records, cfg, 4, P12_WARM + P12_STEPS)
    plain = {}
    for kind in dict(P12_ARMS):
        state, step = p12_state(kind, dev)
        _, loss, gnorm = step(state, *batch)
        plain[kind] = dict(loss=float(loss), gnorm=float(gnorm),
                           bn=bn_stats(state))
        del state, step
        torch.cuda.empty_cache()
    ckpt_dir = os.path.join(work, "p12_ckpt")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    coord = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    procs = [ctx.Process(target=p12_rank, args=(r, coord, batch, ckpt_dir,
                                                out)) for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, rec = out.get(timeout=300)
            got[rank] = rec
    finally:
        for p in procs:
            p.join(120)
            if p.is_alive():
                p.kill()
                p.join()
    ranks_s = time.perf_counter() - t0
    for rank, rec in sorted(got.items()):
        check("error" not in rec, f"12b rank {rank}: {rec.get('error')}")
    check(all(p.exitcode == 0 for p in procs),
          f"12b: rank exit codes {[p.exitcode for p in procs]}")
    exact = plain["float64"]
    failed = []  # every arm prints its numbers before the gates fail

    def gate(cond, msg):
        if not cond:
            failed.append(msg)

    for arm in P12_ARMS:
        kind, rules = arm
        r0, r1 = got[0][arm], got[1][arm]
        name = f"12b {kind} {rules}"
        gate((r0["loss"], r0["gnorm"]) == (r1["loss"], r1["gnorm"]),
              f"{name}: the ranks' loss / grad norm differ")
        for rank in (0, 1):
            gate(got[rank][arm]["launches"]
                  == {k: 5 for k in FOCAL_KERNELS},
                  f"{name} rank {rank}: focal launches "
                  f"{got[rank][arm]['launches']}")
        own, far, ref_far = p12_gaps(r0, plain[kind], exact)
        extra = ""
        if rules != "replicated":
            n, ok = r0["split"]
            rep = got[0][(kind, "replicated")]
            extra = (f"; {n} split leaves and their momentum held as "
                     f"chunks on both ranks ({ok and r1['split'] == (n, True)}"
                     f"), loss / grad norm {r0['loss'] - rep['loss']:.3g} / "
                     f"{r0['gnorm'] - rep['gnorm']:.3g} from the replicated "
                     f"arm's")
        print(f"[12b two ranks] {kind} {rules}: loss {r0['loss']:.6f}, "
              f"grad norm {r0['gnorm']:.6f}; against the plain {kind} "
              f"step on the same 4 rows: loss rel {own[0]:.3g}, grad norm "
              f"rel {own[1]:.3g}, BN stats max abs {own[2]:.3g}; from the "
              f"float64 step: {far[0]:.3g} / {far[1]:.3g} / {far[2]:.3g} "
              f"(the plain {kind} step: {ref_far[0]:.3g} / "
              f"{ref_far[1]:.3g} / {ref_far[2]:.3g}){extra}; focal "
              f"launches 5 + 5 a rank")
        if kind == "float64":
            # the issue's tolerances, in float64
            bad = [f"{what} {v:.3g} > {tol:g}" for what, v, tol in zip(
                ("loss rel", "grad norm rel", "BN stats"), own,
                P12_FLOORS) if v > tol]
            basis = "against the plain float64 step"
        else:
            # no further from the float64 step than P12_ROUNDING times
            # the plain step in this precision is (the floors: the
            # issue's tolerances): the rounding a split batch reorders
            # passes, a wrong gradient or statistic does not
            bad = [f"{what} {v:.3g} > {max(P12_ROUNDING * r, tol):.3g}"
                   for what, v, r, tol in zip(
                       ("loss rel", "grad norm rel", "BN stats"), far,
                       ref_far, P12_FLOORS)
                   if v > max(P12_ROUNDING * r, tol)]
            basis = (f"from the float64 step, against {P12_ROUNDING:g} x "
                     f"the plain {kind} step's distance from it")
        gate(not bad, f"{name}: {', '.join(bad)} ({basis})")
        if rules != "replicated":
            gate(n > 0 and ok and r1["split"] == (n, True),
                  f"{name}: split leaves {r0['split']} / {r1['split']}")
            gate(r0["loss"] == rep["loss"]
                  and abs(r0["gnorm"] - rep["gnorm"])
                  <= 1e-6 * abs(rep["gnorm"]),
                  f"{name}: loss / grad norm against the replicated arm's")
    check(not failed, "; ".join(failed))
    print(f"[12b two ranks] 2 gloo ranks over CUDA tensors on card 0 (NCCL "
          f"refuses two ranks on one device), canonical at 2 rows a rank x "
          f"{cfg.skeleton.height}x{cfg.skeleton.width}, arms "
          f"{', '.join(' '.join(a) for a in P12_ARMS)}: ranks ran in "
          f"{ranks_s:.1f} s (start, steps, save); one card, so no "
          f"multi-card speed is claimed [{smi}]")

    # (c) the two-rank checkpoint in one process
    saved = got[0][("float64", "replicated")]["sha256"]
    path = os.path.join(ckpt_dir, "epoch_0")
    mesh = make_mesh(1, 1, device="cuda")
    state, _ = p12_state("float64", dev)
    state, meta = restore_checkpoint(path, state)
    state, change = reshard_on_topology_change(
        state, meta, mesh, 1, "adjust", path, log_fn=lambda s: None)
    h = hashlib.sha256()
    for k, v in state.model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    check(change is not None and "process_count" in change
          and h.hexdigest() == saved,
          f"12c adjust: change {change}, restored state "
          f"{'equals' if h.hexdigest() == saved else 'differs from'}"
          " the saved one")
    try:
        reshard_on_topology_change(state, meta, mesh, 1, "refuse", path,
                                   log_fn=lambda s: None)
        refused = None
    except TopologyChanged as e:
        refused = str(e)
    check(refused is not None and "process_count" in refused,
          f"12c refuse: {refused!r}")
    print(f"[12c reshard] the two-rank float64 checkpoint (stamped "
          f"{meta['topology']}) restored in one process: adjust gives the "
          f"saved state (SHA-256 {saved[:16]} equal), change "
          f"{change}; refuse raises TopologyChanged naming process_count")


def multi_card_training(dev, smi, sync, work):
    """Phase 12: (a) world 1 under NCCL at full width; (b) two ranks on
    the one card; (c) the reshard across topologies."""
    import torch

    from improved_body_parts_torch.config import get_config
    from improved_body_parts_torch.parallel import (
        initialize_distributed,
        shutdown_distributed,
    )
    from improved_body_parts_torch.parallel.mesh import free_port

    t0 = time.perf_counter()
    records = sync["records"]
    torch.cuda.empty_cache()
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
    try:
        launches = world_one_nccl(dev, smi, get_config("canonical"),
                                  records, sync)
        marks = [("a", time.perf_counter())]
        two_ranks_one_card(dev, smi, records, work)
        marks.append(("b-c", time.perf_counter()))
    finally:
        shutdown_distributed()
    print(f"[12 multi-card] phase took {marks[-1][1] - t0:.1f} s "
          f"({laps(t0, marks)} s)")
    return {"multi_card": launches}


# ---------------------------------------------------------------------------
# Phase 13: height-sharded inference, multi-rank distillation, --devices
P13_TALL = (1536, 768)          # (b) the full-width image, boxsize 1536
P13_UNEVEN = (640, 480)         # (c) a 640-row input over 4 'model' ranks
P13_MAPS_TOL = 1e-3             # max abs gap / the maps' max


def fp32_predictor(config, checkpoint, boxsize, dev):
    """``serve.checkpoint_predictor`` at fp32 storage with the config's
    bf16 autocast off: the phase compares in fp32 (TF32 off), where a
    shard's other cuDNN algorithms move the maps by rounding only."""
    import torch

    from improved_body_parts_torch.serve import checkpoint_predictor

    pred = checkpoint_predictor(config, checkpoint, params_dtype="fp32",
                                boxsize=boxsize, device=dev)
    pred.model.compute_dtype = torch.float32
    return pred


def sharded_twin(pred, mesh):
    """``pred``'s configuration over ``mesh`` (its model, shared)."""
    from improved_body_parts_torch.infer import Predictor

    return Predictor(pred.model, pred.skeleton, pred.params,
                     pred.model_params, bucket=pred.bucket,
                     compact_topk=pred.compact_topk,
                     assembly_pmax=pred.assembly_pmax, device=pred.device,
                     mesh=mesh)


def people_gap(got, want) -> float:
    """The largest keypoint distance in px between two decodes of one
    image (lists of (COCO keypoints, score)), each wanted person matched
    to its nearest got one; inf when the counts differ."""
    if len(got) != len(want):
        return float("inf")
    worst = 0.0
    for kps, _ in want:
        worst = max(worst, min(max(np.hypot(a[0] - b[0], a[1] - b[1])
                                   for a, b in zip(kps, other)
                                   if a is not None and b is not None)
                               for other, _ in got))
    return worst


def lane_people(sk, params, lane, res):
    """The people of one image from a lane's result."""
    from improved_body_parts_torch.infer import (
        decode,
        decode_compact,
        decode_device,
    )

    if lane == "decoded":
        check(res.ok, "13: an overflow flag is set on a val image")
        return decode_device(res, sk)
    if lane == "compact":
        return decode_compact(res, params, sk)
    heat, paf, mask, scale = res
    return decode(heat, paf, params, sk, peak_mask=mask, coord_scale=scale)


def p13_phase7_lanes(pred, images, capture: bool):
    """``predict_decoded`` of every val image (the decode kernels'
    counters set to 0 before, read after; the first image's lane decode
    captured when ``capture``), then ``predict_compact`` and
    ``predict_fast`` of the first."""
    import torch

    calls = []
    if capture:
        pred.decode_maps = first_calls(pred.decode_maps, 1, calls)
    reset_launches()
    decoded = [pred.predict_decoded(im) for im in images]
    torch.cuda.synchronize()
    launches = read_launches()
    if capture:
        del pred.decode_maps
    return dict(decoded=decoded, launches=launches, calls=calls,
                compact=pred.predict_compact(images[0]),
                fast=pred.predict_fast(images[0]))


def p13_config(name: str):
    """``name``'s config with bf16 autocast off."""
    import dataclasses

    from improved_body_parts_torch.config import get_config

    cfg = get_config(name)
    return cfg.replace(train=dataclasses.replace(cfg.train,
                                                 bf16_compute=False))


def p13_distill(dev, mesh=None):
    """(state, teacher, step) of the float64 distillation arm: a seeded
    ``canonical_student`` from a seeded ``canonical`` teacher (eval), the
    step ``cli.train.train`` builds for a teacher
    (``make_distill_train_step``, over ``mesh`` when given)."""
    import torch

    from improved_body_parts_torch.models import build_model
    from improved_body_parts_torch.train import (
        bind_teacher,
        create_train_state,
        make_distill_train_step,
        make_optimizer,
        step_decay_schedule,
    )

    cfg = p13_config("canonical_student")
    student = build_model(cfg, device=dev, seed=0, train=True).to(
        torch.float64)
    teacher = build_model(p13_config("canonical"), device=dev, seed=1).to(
        torch.float64)
    opt = make_optimizer(student, cfg, step_decay_schedule(
        cfg.train, steps_per_epoch=4))
    state = create_train_state(student, cfg, opt)
    step = bind_teacher(make_distill_train_step(
        student, teacher, cfg, opt, health=True, mesh=mesh), teacher)
    return cfg, state, teacher, step


def sha_of(module) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in module.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def p13_rank_two(rank, dev, job):
    """13(b) on one of two ranks: the full-width ``canonical`` forward,
    phase 7's lanes and the float64 distillation, over a (1, 2) mesh."""
    import torch

    from improved_body_parts_torch.ops import losses
    from improved_body_parts_torch.parallel import make_mesh, shard_batch
    from improved_body_parts_torch.parallel.spatial import (
        COLLECTIVES,
        reset_collectives,
    )

    mesh = make_mesh(1, 2, device=dev.type)
    res = {}
    # full width: canonical, seeded, fp32, one tall image at boxsize 1536
    base = fp32_predictor("canonical", None, P13_TALL[0], dev)
    pred = sharded_twin(base, mesh)
    tall = job["tall"]
    # the parent's one-process references run while the ranks start;
    # the card is the ranks' from here on
    check(job["go"].wait(600), "13b: the parent's references timed out")
    pred.predict(tall)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_collectives()
    t0 = time.perf_counter()
    heat, paf = pred.predict(tall)
    torch.cuda.synchronize()
    res["full_ms"] = 1e3 * (time.perf_counter() - t0)
    res["full_mem"] = torch.cuda.max_memory_allocated()
    res["collectives"] = dict(COLLECTIVES)
    np.save(os.path.join(job["work"], f"p13_heat_{rank}.npy"), heat)
    np.save(os.path.join(job["work"], f"p13_paf_{rank}.npy"), paf)
    del base, pred, heat, paf
    torch.cuda.empty_cache()
    # phase 7's checkpoint
    base = fp32_predictor(job["config"], job["checkpoint"], job["net"], dev)
    lanes = p13_phase7_lanes(sharded_twin(base, mesh), job["images"],
                             capture=rank == 0)
    if rank == 0:
        hold_lane_call(base.skeleton, lanes.pop("calls")[0],
                       "rank 0's gathered maps of the first val image",
                       job["smi"], tag="[13b sharded]")
    lanes.pop("calls", None)
    res["lanes"] = lanes
    del base
    torch.cuda.empty_cache()
    # the float64 distillation, 2 rows a rank
    dmesh = make_mesh(2, 1, device=dev.type)
    cfg, state, teacher, step = p13_distill(dev, dmesh)
    before = sha_of(teacher)
    calls, fused = [], losses.focal_l2_fused
    losses.focal_l2_fused = first_calls(fused, 5, calls)
    reset_focal()
    try:
        state, loss, gnorm = step(state, *shard_batch(job["batch"], dmesh))
        torch.cuda.synchronize()
    finally:
        losses.focal_l2_fused = fused
    launches = focal_counts()
    hold_focal(calls, torch.tensor(cfg.train.nstack_weight, device=dev)
               * 0.25, f"rank {rank}'s distillation calls",
               tag="[13b distill]")
    res["distill"] = dict(loss=float(loss), gnorm=float(gnorm),
                          launches=launches, bn=bn_stats(state),
                          sha=sha_of(state.model),
                          teacher_unchanged=sha_of(teacher) == before)
    return res


def p13_rank_four(rank, dev, job):
    """13(c) on one of four ranks: phase 7's lanes over a (2, 2) mesh,
    two refusals, and a 640-row input over a (1, 4) mesh."""
    import torch

    from improved_body_parts_torch.config import (
        InferenceModelParams,
        InferenceParams,
    )
    from improved_body_parts_torch.infer import Predictor
    from improved_body_parts_torch.parallel import make_mesh
    from improved_body_parts_torch.parallel.spatial import HeightShard

    res = {}
    base = fp32_predictor(job["config"], job["checkpoint"], job["net"], dev)
    pred = sharded_twin(base, make_mesh(2, 2, device=dev.type))
    lanes = p13_phase7_lanes(pred, job["images"], capture=False)
    lanes.pop("calls")
    res["lanes"] = lanes
    refused = {}
    grid = InferenceParams(scale_search=(0.8, 1.0))
    for name, call in (
            ("batch", lambda: pred.predict_decoded_batch(job["images"][:2])),
            ("grid", lambda: pred.predict_decoded(job["images"][0],
                                                  params=grid))):
        try:
            call()
            refused[name] = None
        except ValueError as e:
            refused[name] = str(e)
    res["refused"] = refused
    # an uneven split: 640 rows are 10 bottom rows of 64, 3 / 3 / 2 / 2
    mesh = make_mesh(1, 4, device=dev.type)
    base = Predictor(base.model, base.skeleton, model_params=(
        InferenceModelParams(boxsize=P13_UNEVEN[0])), device=dev)
    pred = sharded_twin(base, mesh)
    img = job["uneven"]
    heat, paf = pred.predict(img)
    res["rows"] = HeightShard.over(mesh, P13_UNEVEN[0], pred.shard_stride
                                   ).rows
    if rank == 0:
        want = base.predict(img)
        res["uneven"] = (max(float(np.abs(a - b).max())
                             for a, b in zip((heat, paf), want)),
                         max(float(np.abs(w).max()) for w in want))
    torch.cuda.synchronize()
    return res


def p13_rank(rank: int, n: int, coord: str, job, out) -> None:
    """One of ``n`` gloo ranks over CUDA tensors on card 0 (phase 13)."""
    sys.path.insert(0, ROOT)
    try:
        import torch

        from improved_body_parts_torch.parallel import (
            initialize_distributed,
            shutdown_distributed,
        )

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device(job["device"])
        initialize_distributed(coord, n, rank, device=dev, backend="gloo")
        body = p13_rank_two if n == 2 else p13_rank_four
        out.put((rank, body(rank, dev, job)))
        shutdown_distributed()
    except BaseException as e:
        out.put((rank, dict(error=f"{type(e).__name__}: {e}")))
        raise


def start_ranks(n: int, job):
    """:func:`p13_rank` on ``n`` spawned ranks; (processes, queue)."""
    import multiprocessing as mp

    from improved_body_parts_torch.parallel.mesh import free_port

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    coord = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=p13_rank, args=(r, n, coord, job, out))
             for r in range(n)]
    for p in procs:
        p.start()
    return procs, out


def join_ranks(procs, out, timeout_s: float = 600.0) -> dict:
    """The ranks' results, {rank: result}, once every rank exited."""
    got = {}
    try:
        for _ in procs:
            rank, rec = out.get(timeout=timeout_s)
            got[rank] = rec
    finally:
        for p in procs:
            p.join(120)
            if p.is_alive():
                p.kill()
                p.join()
    n = len(procs)
    for rank, rec in sorted(got.items()):
        check("error" not in rec, f"13: rank {rank} of {n}: "
              f"{rec.get('error')}")
    check(all(p.exitcode == 0 for p in procs),
          f"13: rank exit codes {[p.exitcode for p in procs]}")
    return got


def check_lanes(label, sk, params, got, plain, ids, gts, smi):
    """The (b) / (c) gates on one rank's phase 7 lanes against the plain
    predictor's: each val image's people within 1 px (same count), the
    OKS AP within 0.005 of the plain lane's in the same precision and of
    phase 7's fused lane (in bf16 autocast, so it differs from the
    fp32 lanes by the compute's rounding, not the split's), the compact
    and fast lanes' people as their plain lanes', every decode kernel
    launched once an image."""
    people = [lane_people(sk, params, "decoded", d) for d in got["decoded"]]
    gaps = [people_gap(p, w) for p, w in zip(people, plain["people"])]
    ap = oks_ap(ids, people, gts)
    other = {lane: people_gap(lane_people(sk, params, lane, got[lane]),
                              plain[lane]) for lane in ("compact", "fast")}
    check(max(gaps) <= 1.0, f"{label}: people off the plain fused lane's "
          f"by {max(gaps):.3f} px (inf: another count)")
    for what, want in (("the plain fp32 lane", plain["ap"]),
                       ("phase 7's fused lane", plain["ap_fused"])):
        check(abs(ap - want) <= 0.005, f"{label}: AP {ap:.4f} against "
              f"{what}'s {want:.4f}")
    check(max(other.values()) <= 1.0, f"{label}: compact / fast lanes' "
          f"people off their plain lanes' by {other}")
    check(got["launches"] == {k: len(ids) for k in DECODE_KERNELS},
          f"{label}: decode launches {got['launches']} for {len(ids)} "
          "images")
    print(f"[{label}] {len(ids)} val images through predict_decoded: "
          f"people within {max(gaps):.3g} px of the plain fused lane's, "
          f"OKS AP {ap:.4f} (the plain fp32 lane {plain['ap']:.4f}; phase "
          f"7's fused lane in bf16 autocast {plain['ap_fused']:.4f}); "
          f"predict_compact / predict_fast people within "
          f"{other['compact']:.3g} / {other['fast']:.3g} px of their "
          f"plain lanes'; decode launches {got['launches']} [{smi}]")
    return ap


def height_sharded_inference(dev, smi, ctx, sync, work):
    """Phase 13: (a) a one-rank NCCL mesh, payloads bit for bit; (b) two
    gloo ranks on card 0: ``canonical`` at boxsize 1536, phase 7's
    lanes, the float64 multi-rank distillation; (c) four gloo ranks:
    phase 7's lanes over (2, 2), refusals, an uneven split over (1, 4);
    (d) ``cli.stream_bench --devices 1``.  Returns the launches of the
    sharded lane (rank 0 of (b)) and of the multi-rank distillation."""
    import json as _json

    import torch

    from improved_body_parts_torch.cli import stream_bench
    from improved_body_parts_torch.config import get_config
    from improved_body_parts_torch.parallel import (
        initialize_distributed,
        make_mesh,
        shutdown_distributed,
    )
    from improved_body_parts_torch.parallel.mesh import free_port

    t0 = time.perf_counter()
    sk = get_config(SYNTH_AP["config"]).skeleton
    ids, images, gts = val_set(ctx)
    plain = fp32_predictor(SYNTH_AP["config"], ctx["checkpoint"],
                           ctx["net"], dev)
    params = plain.params
    decoded = [plain.predict_decoded(im) for im in images]
    want = {"people": [lane_people(sk, params, "decoded", d)
                       for d in decoded],
            "ap_fused": ctx["ap_fused"],
            "compact": lane_people(sk, params, "compact",
                                   plain.predict_compact(images[0])),
            "fast": lane_people(sk, params, "fast",
                                plain.predict_fast(images[0]))}
    want["ap"] = oks_ap(ids, want["people"], gts)
    print(f"[13 height-sharded] the plain fused lane of phase 7's "
          f"checkpoint in fp32 (autocast off, TF32 off): OKS AP "
          f"{want['ap']:.4f} on the {len(ids)} val images (phase 7's, in "
          f"bf16 autocast: {ctx['ap_fused']:.4f}) [{smi}]")

    # (a) one rank under NCCL: the sharded lane is the plain one
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
    try:
        one = sharded_twin(plain, make_mesh(1, 1, device=dev.type))
        same = [same_payload(one.predict_decoded(im), d)
                for im, d in zip(images, decoded)]
    finally:
        shutdown_distributed()
    check(all(same), f"13a: {same.count(False)} of {len(same)} payloads "
          "differ from the plain predictor's on a one-rank mesh")
    print(f"[13a one rank] NCCL mesh (1, 1), {SYNTH_AP['config']} fp32: "
          f"{len(images)} predict_decoded payloads equal to the plain "
          "predictor's bit for bit")
    marks = [("a", time.perf_counter())]

    # (b)'s ranks start (imports, the card's context, the group) while
    # this process makes the one-process references: canonical at 1536
    # and the distillation step; their timed work waits on ``go``
    import multiprocessing as mp

    rng = np.random.default_rng(13)
    tall = rng.integers(0, 256, (*P13_TALL, 3), dtype=np.uint8)
    batch = p12_batch(sync["records"], p13_config("canonical_student"), 4,
                      P12_WARM + P12_STEPS + 1)
    go = mp.get_context("spawn").Event()
    job = dict(device=str(dev), work=work, smi=smi, go=go,
               config=SYNTH_AP["config"],
               checkpoint=ctx["checkpoint"], net=ctx["net"], images=images,
               tall=tall, batch=batch,
               uneven=rng.integers(0, 256, (*P13_UNEVEN, 3),
                                   dtype=np.uint8))
    ranks = start_ranks(2, job)
    full = fp32_predictor("canonical", None, P13_TALL[0], dev)
    n_params = sum(p.numel() for p in full.model.parameters())
    check(n_params == 128_998_760, f"13b: canonical has {n_params} "
          "parameters")
    full.predict(tall)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    heat0, paf0 = full.predict(tall)
    torch.cuda.synchronize()
    full_ms = 1e3 * (time.perf_counter() - t1)
    full_mem = torch.cuda.max_memory_allocated()
    del full
    torch.cuda.empty_cache()
    cfg, state, teacher, step = p13_distill(dev)
    _, loss, gnorm = step(state, *batch)
    ref = dict(loss=float(loss), gnorm=float(gnorm), bn=bn_stats(state))
    del state, teacher, step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    go.set()
    two = join_ranks(*ranks)
    # (b) full width
    maps_max = max(float(np.abs(heat0).max()), float(np.abs(paf0).max()))
    for rank in (0, 1):
        heat = np.load(os.path.join(work, f"p13_heat_{rank}.npy"))
        paf = np.load(os.path.join(work, f"p13_paf_{rank}.npy"))
        gap = max(float(np.abs(heat - heat0).max()),
                  float(np.abs(paf - paf0).max()))
        check(gap <= P13_MAPS_TOL * maps_max, f"13b full width rank {rank}:"
              f" maps {gap:.3g} from the plain predictor's (max "
              f"{maps_max:.3g})")
        r = two[rank]
        print(f"[13b full width] canonical fp32, autocast off "
              f"({n_params} parameters, "
              f"seeded), one {P13_TALL[0]}x{P13_TALL[1]} image at boxsize "
              f"{P13_TALL[0]} (24 bottom rows, 12 a rank) over mesh (1, 2),"
              f" rank {rank}: predict maps max abs {gap:.3g} from the "
              f"one-process plain predictor's (maps' max {maps_max:.3g}, "
              f"gate {P13_MAPS_TOL:g} x max); {r['full_ms']:.1f} ms an "
              f"image, peak device memory {r['full_mem'] / 2**30:.2f} GiB "
              f"(the plain predictor: {full_ms:.1f} ms, "
              f"{full_mem / 2**30:.2f} GiB); collectives a forward "
              f"{r['collectives']}; reported, not claimed: two ranks "
              f"share one card [{smi}]")
    # (b) phase 7's lanes, both ranks
    for rank in (0, 1):
        check_lanes(f"13b sharded rank {rank}", sk, params,
                    two[rank]["lanes"], want, ids, gts, smi)
    check(all(same_payload(a, b) for a, b in zip(
        two[0]["lanes"]["decoded"], two[1]["lanes"]["decoded"])),
        "13b: the two ranks' payloads differ")
    # (b) distillation
    gaps = []
    for rank in (0, 1):
        d = two[rank]["distill"]
        own = p12_gaps(d, ref, ref)[0]
        gaps.append(own)
        bad = [f"{what} {v:.3g} > {tol:g}" for what, v, tol in zip(
            ("loss rel", "grad norm rel", "BN stats"), own, P12_FLOORS)
            if v > tol]
        check(not bad, f"13b distill rank {rank}: {', '.join(bad)} "
              "against the plain float64 distill step")
        check(d["launches"] == {k: 10 for k in FOCAL_KERNELS},
              f"13b distill rank {rank}: focal launches {d['launches']}, "
              "want 10 + 10 (two loss terms x 5 scales)")
        check(d["teacher_unchanged"], f"13b distill rank {rank}: the "
              "teacher's state changed")
    d0, d1 = two[0]["distill"], two[1]["distill"]
    check((d0["loss"], d0["gnorm"], d0["sha"])
          == (d1["loss"], d1["gnorm"], d1["sha"]),
          "13b distill: the two ranks' steps differ")
    print(f"[13b distill] canonical_student from a canonical teacher, "
          f"float64, 2 gloo ranks x 2 rows at {cfg.skeleton.height}x"
          f"{cfg.skeleton.width} against the plain float64 distill step on "
          f"the same 4 rows: loss {d0['loss']:.6f} (rel "
          f"{gaps[0][0]:.3g}), grad norm {d0['gnorm']:.6f} (rel "
          f"{gaps[0][1]:.3g}), BN stats max abs {gaps[0][2]:.3g}; the "
          f"ranks' states equal; focal launches {d0['launches']} a rank; "
          f"the teacher unchanged [{smi}]")
    marks.append(("b", time.perf_counter()))

    # (c) four ranks
    four = join_ranks(*start_ranks(4, job))
    for rank in range(4):
        check_lanes(f"13c sharded rank {rank}", sk, params,
                    four[rank]["lanes"], want, ids, gts, smi)
        refused = four[rank]["refused"]
        check(refused["batch"] is not None
              and "decode_batch does not support" in refused["batch"]
              and refused["grid"] is not None
              and "spatial sharding mesh" in refused["grid"],
              f"13c rank {rank}: refusals {refused}")
    rows = [four[r]["rows"] for r in range(4)]
    check([(b - a) // 64 for a, b in rows] == [3, 3, 2, 2],
          f"13c: the 640-row split is {rows}")
    gap, top = four[0]["uneven"]
    check(gap <= P13_MAPS_TOL * top, f"13c uneven: maps {gap:.3g} from "
          f"the plain predictor's (max {top:.3g})")
    print(f"[13c four ranks] mesh (2, 2): the batch lane refused "
          f"({four[0]['refused']['batch']!r}), the grid lane refused "
          f"({four[0]['refused']['grid']!r}); mesh (1, 4): a "
          f"{P13_UNEVEN[0]}x{P13_UNEVEN[1]} input split into rows {rows} "
          f"(3 / 3 / 2 / 2 bottom rows), predict maps max abs {gap:.3g} "
          f"from the plain predictor's (max {top:.3g}) [{smi}]")
    marks.append(("c", time.perf_counter()))

    # (d) cli.stream_bench --devices 1
    out = os.path.join(work, "stream_bench_torch.json")
    stream_bench.main(["--config", SYNTH_AP["config"], "--checkpoint",
                       ctx["checkpoint"], "--params-dtype", "fp32",
                       "--boxsize", str(ctx["net"]), "--streams", "2",
                       "--frames", "8", "--rounds", "1", "--size", "256",
                       "--planted", "0", "--devices", "1", "--device",
                       dev.type, "--telemetry-sink", "none", "--out", out])
    with open(out) as f:
        rep = _json.load(f)
    check(rep["serve_devices"] == 1, f"13d: serve_devices "
          f"{rep['serve_devices']}")
    check(rep["frames_delivered_total"] == 16
          and rep["frames_failed_total"] == 0
          and rep["frames_dropped_total"] == 0,
          f"13d: delivered {rep['frames_delivered_total']} of 16 frames")
    print(f"[13d stream_bench] --devices 1, 2 streams x 8 frames on phase "
          f"7's checkpoint: serve_devices {rep['serve_devices']}, "
          f"{rep['frames_delivered_total']} frames delivered, replica "
          f"completions {rep['serve_replica_completed']}, per-stream fps "
          f"{rep['per_stream_fps']} [{smi}]")
    marks.append(("d", time.perf_counter()))
    print(f"[13 height-sharded] phase took {marks[-1][1] - t0:.1f} s "
          f"({laps(t0, marks)} s)")
    return {"spatial": two[0]["lanes"]["launches"],
            "distill_multi_rank": two[0]["distill"]["launches"]}


# --------------------------------------------------------------------- #
# phase 14: the tools that measure the port                              #
# --------------------------------------------------------------------- #
# each tool's main(argv) at full width: ``canonical``, seeded, 512x512
P14_CONFIG, P14_SIZE = "canonical", 512


def measure_tools(dev, smi, work):
    """Phase 14: the five measuring tools of ``cli`` in this process on
    the card.  (a) ``speed_test`` at batch 8, bf16 and ``--fp32``; (b)
    ``perf_audit`` at batches 1 and 8 (no flag, the FLOP count equal to
    the analytic count, the device ms measured and no more than the
    dispatch's wall ms); (c) ``train_bench`` over batches 2, 4, 8 (5 + 5
    focal launches a step, the device ms a step no more than the step's
    ms; the focal kernels held to their plain versions on the first
    step's 5 calls); (d) ``e2e_bench`` over every mode on 8 images with 3
    planted people (each mode's people within 1 px of what the host
    decode reads off the planted maps alone as that mode's protocol
    resizes them; the decode kernels bit for bit on the device-decode
    batch's maps), then on 2 images with 2 planted people (each mode's
    people within 1 px of the planted joints); (e) ``serve_bench`` at 1
    and 4 clients (``hop_conservation_frac`` >= 0.95), then
    ``--proc-only`` (every chaos future resolved, the killed worker
    respawned).  Returns the launches of (c)-(e) by path."""
    import torch

    from improved_body_parts_torch.cli import (
        e2e_bench,
        perf_audit,
        serve_bench,
        speed_test,
        train_bench,
    )
    from improved_body_parts_torch.config import (
        default_inference_params,
        get_config,
    )
    from improved_body_parts_torch.infer import Predictor, decode
    from improved_body_parts_torch.infer.resize import upsample_cubic
    from improved_body_parts_torch.ops import losses

    t0 = time.perf_counter()
    marks = []
    cfg = get_config(P14_CONFIG)
    sk = cfg.skeleton
    base = ["--config", P14_CONFIG, "--device", dev.type]
    out = os.path.join(work, "p14")
    os.makedirs(out, exist_ok=True)

    # (a) network FPS, bf16 autocast and fp32
    rates = {}
    for label, extra in (("bf16", []), ("fp32", ["--fp32"])):
        rates[label] = speed_test.main(base + [
            "--batch", "8", "--size", str(P14_SIZE), "--iters", "20",
            *extra])
        check(np.isfinite(rates[label]["imgs_per_sec"])
              and rates[label]["imgs_per_sec"] > 0,
              f"14a speed_test {label}: {rates[label]}")
    print(f"[14a speed_test] batch 8 at {P14_SIZE}^2: bf16 "
          f"{rates['bf16']['imgs_per_sec']:.2f} imgs/s "
          f"({rates['bf16']['ms_per_iter']:.2f} ms a batch), fp32 "
          f"{rates['fp32']['imgs_per_sec']:.2f} imgs/s "
          f"({rates['fp32']['ms_per_iter']:.2f} ms; cuDNN TF32 "
          f"{rates['fp32']['precision']['cudnn_allow_tf32']}) [{smi}]")
    marks.append(("a", time.perf_counter()))

    # (b) the audited FPS beside the FLOPs, a bytes floor and device ms
    audit = perf_audit.main(base + [
        "--size", str(P14_SIZE), "--batches", "1", "8", "--iters", "10",
        "--repeats", "3",
        "--out", os.path.join(out, "perf_audit_torch.json")])
    for b, e in audit["batches"].items():
        check(e["flags"] == [], f"14b perf_audit batch {b}: {e['flags']}")
        check(e["flops_per_step"] == e["analytic_flops_per_step"],
              f"14b perf_audit batch {b}: FlopCounterMode "
              f"{e['flops_per_step']} != analytic "
              f"{e['analytic_flops_per_step']}")
        check(e["device_ms"] is not None and e["device_ms"] > 0,
              f"14b perf_audit batch {b}: device ms not measured")
        wall_ms = statistics.median(e["repeat_spread_ms"])
        check(e["device_ms"] <= wall_ms, f"14b perf_audit batch {b}: "
              f"device {e['device_ms']:.3f} ms a forward above its "
              f"{wall_ms} ms a dispatch")
        print(f"[14b perf_audit] batch {b}: {e['throughput_fps_median']} "
              f"imgs/s median ({e['repeat_spread_ms']} ms a dispatch), "
              f"chained {e['chained_fps']} imgs/s "
              f"({e['chained_latency_ms']} ms), device "
              f"{e['device_ms']:.3f} ms a forward "
              f"({e['device_kernels_per_step']:.0f} kernels, "
              f"{e['launch_calls_per_step']:.0f} launch calls), "
              f"{e['flops_per_step']} FLOPs (= analytic), >= "
              f"{e['min_gbytes_per_step']} GB, implied "
              f"{e['implied_tflops']} TFLOP/s against the data sheet's "
              f"{audit['peak_tflops']}" + (
                  f"; vs_baseline {e['vs_baseline']} (chained / 38.5)"
                  if "vs_baseline" in e else "") + f" [{smi}]")
    marks.append(("b", time.perf_counter()))

    # (c) the train step over the batch sweep; the focal kernels held on
    # the first step's calls
    focal_calls = []
    fused = losses.focal_l2_fused
    reset_focal()
    losses.focal_l2_fused = first_calls(fused, 5, focal_calls)
    try:
        bench = train_bench.main(base + [
            "--size", str(P14_SIZE), "--batches", "2", "4", "8",
            "--steps", "5", "--repeats", "2",
            "--out", os.path.join(out, "train_bench_torch.json")])
    finally:
        losses.focal_l2_fused = fused
    train_launches = focal_counts()
    for b, e in bench["batches"].items():
        check(e["device_ms_per_step"] is not None
              and 0 < e["device_ms_per_step"] <= e["step_ms_median"],
              f"14c train_bench batch {b}: device "
              f"{e['device_ms_per_step']} ms a step against a "
              f"{e['step_ms_median']} ms step")
        check(e["focal_fwd_launches_per_step"] == 5
              and e["focal_bwd_launches_per_step"] == 5,
              f"14c train_bench batch {b}: focal launches a step "
              f"{e['focal_fwd_launches_per_step']} + "
              f"{e['focal_bwd_launches_per_step']}, expected 5 + 5")
        busy = ("not measured" if e["device_busy_share"] is None
                else f"{e['device_ms_per_step']:.2f} ms "
                f"({e['device_busy_share']:.1%})")
        launch = e["cuda_launch_kernel_per_step"]
        print(f"[14c train_bench] batch {b}: {e['step_ms_median']} ms a "
              f"step ({e['repeat_spread_ms']}), {e['imgs_per_sec']} imgs/s, "
              f"device busy {busy}, "
              f"{'not measured' if launch is None else f'{launch:.0f}'} "
              f"cudaLaunchKernel a step, {e['gflops_per_step']} GFLOP a "
              f"step -> {e['implied_tflops']} TFLOP/s [{smi}]")
    check(len(focal_calls) == 5, f"14c: captured {len(focal_calls)} focal "
          "calls")
    hold_focal(focal_calls,
               torch.tensor(cfg.train.nstack_weight, device=dev) * 0.25,
               "train_bench's first step at batch 2", tag="[14c train_bench]")
    marks.append(("c", time.perf_counter()))

    # (d) forward + decode to skeletons in every mode, planted people
    lane_calls = []
    decode_maps = Predictor.decode_maps

    def capture(self, maps, *rest):
        if not lane_calls and maps.shape[0] == 8:
            lane_calls.append((maps.detach().clone(), *rest))
        return decode_maps(self, maps, *rest)

    decoded = {}
    reset_launches()
    Predictor.decode_maps = capture
    try:
        e2e = e2e_bench.main(base + [
            "--size", str(P14_SIZE), "--images", "8", "--planted", "3",
            "--batch", "8",
            "--out", os.path.join(out, "e2e_bench_torch.json")],
            decoded=decoded)
    finally:
        Predictor.decode_maps = decode_maps
    e2e_launches = read_launches()
    # what the host decode reads off the planted maps alone, as each
    # protocol resizes them: at the lanes' x4 upsample (scaled back), and
    # resized to the image for the full-map protocol.  The JAX tool lays
    # its people out at random; where they overlap, greedy assembly pairs
    # limbs across people by the reference's rules, so a mode is held to
    # its own protocol's reading of the ground truth
    import cv2

    params, mp = default_inference_params()
    g = mp.boxsize // sk.stride
    up = upsample_cubic(torch.from_numpy(
        decoded["planted_maps"][:g, :g]).to(dev)[None], sk.stride)[0]
    up = up.cpu().numpy()
    scale = P14_SIZE / mp.boxsize
    at_image = cv2.resize(up, (P14_SIZE, P14_SIZE),
                          interpolation=cv2.INTER_CUBIC)
    reads = {"lane": decode(up[..., sk.paf_layers:], up[..., :sk.paf_layers],
                            params, sk, coord_scale=(scale, scale)),
             "image": decode(at_image[..., sk.paf_layers:],
                             at_image[..., :sk.paf_layers], params, sk)}
    planted = {k: e2e_bench.planted_gap(sk, r, decoded["planted_joints"])
               for k, r in reads.items()}
    gaps = {}
    for mode in e2e_bench.MODES:
        check(len(decoded.get(mode, ())) == 8, f"14d e2e_bench: mode "
              f"{mode} decoded {len(decoded.get(mode, ()))} of 8 images")
        read = reads["image" if mode == "full" else "lane"]
        gaps[mode] = max(people_gap(people, read)
                         for people in decoded[mode])
        check(gaps[mode] <= 1.0, f"14d e2e_bench {mode}: the people off "
              f"by {gaps[mode]:.3f} px from the planted maps' reading")
    check(len(lane_calls) == 1, "14d: no device-decode batch of 8 captured")
    hold_lane_call(sk, lane_calls[0], "e2e_bench's device-decode batch",
                   smi, tag="[14d e2e_bench]")
    print(f"[14d e2e_bench] 8 images of {P14_SIZE}^2, 3 planted people: "
          + ", ".join(f"{k} {e2e[k]}" for k in (
              "full_path_fps", "fast_path_fps", "pipelined_fps",
              "compact_fps", "compact_pipelined_fps", "compact_batch_fps",
              "device_decode_fps", "device_decode_batch_fps"))
          + f" imgs/s; device_decode_host_fallback "
          f"{e2e['device_decode_host_fallback']}; each mode's "
          f"{len(reads['lane'])} people within "
          + ", ".join(f"{m} {g:.3f}" for m, g in gaps.items())
          + " px of its protocol's reading of the planted maps alone "
          f"(lanes / full-map protocol {planted['lane']:.3f} / "
          f"{planted['image']:.3f} px from the planted joints); decode "
          f"launches {e2e_launches} [{smi}]")
    # the planted joints themselves at full width: 2 people, as the CPU
    # test plants them, which greedy assembly keeps apart
    truth = {}
    e2e_bench.main(base + [
        "--size", str(P14_SIZE), "--images", "2", "--planted", "2",
        "--batch", "2",
        "--out", os.path.join(out, "e2e_bench_2p_torch.json")],
        decoded=truth)
    truth_gaps = {}
    for mode in e2e_bench.MODES:
        truth_gaps[mode] = max(
            e2e_bench.planted_gap(sk, people, truth["planted_joints"])
            for people in truth[mode])
        check(truth_gaps[mode] <= 1.0, f"14d e2e_bench {mode}, 2 planted "
              f"people: {truth_gaps[mode]:.3f} px from the planted joints")
    print(f"[14d e2e_bench] 2 images of {P14_SIZE}^2, 2 planted people: "
          "each mode's people within "
          + ", ".join(f"{m} {g:.3f}" for m, g in truth_gaps.items())
          + f" px of the planted joints [{smi}]")
    marks.append(("d", time.perf_counter()))

    # (e) the batcher against sequential serving; the proc A/B and chaos
    reset_launches()
    serve = serve_bench.main(base + [
        "--sizes", str(P14_SIZE), "--requests", "4", "--clients", "1,4",
        "--baseline-clients", "4", "--rounds", "1", "--planted", "2",
        "--telemetry-sink", "none",
        "--out", os.path.join(out, "serve_bench_torch.json")])
    serve_launches = read_launches()
    arms = serve["serve"] + [serve["serve_at_peak_load"]]
    fracs = [a["hop_conservation_frac"] for a in arms]
    check(all(f is not None and f >= 0.95 for f in fracs),
          f"14e serve_bench: hop_conservation_frac {fracs}")
    peak = serve["serve_at_peak_load"]
    print(f"[14e serve_bench] {P14_SIZE}^2, 2 planted people: batcher "
          + ", ".join(f"{a['clients']} clients {a['imgs_per_sec']} imgs/s "
                      f"(p50 {a['latency_ms']['p50']} / p99 "
                      f"{a['latency_ms']['p99']} ms, occupancy "
                      f"{a['mean_batch_occupancy']})" for a in serve["serve"])
          + f"; verdict at {peak['clients']} clients: batcher "
          f"{peak['imgs_per_sec']} vs sequential "
          f"{serve['sequential']['imgs_per_sec']} imgs/s (overlapped "
          f"{serve['sequential_overlapped']['imgs_per_sec']}, concurrent "
          f"{serve['sequential_concurrent']['imgs_per_sec']}), "
          f"batched_beats_sequential {serve['batched_beats_sequential']}; "
          f"decode A/B median ratio {serve['decode_ab']['median_round_ratio']}"
          f"; hop_conservation_frac {fracs}; decode launches "
          f"{serve_launches} [{smi}]")
    marks.append(("e serve", time.perf_counter()))
    proc = serve_bench.main(base + [
        "--proc-only", "--proc-rounds", "1", "--telemetry-sink", "none",
        "--out", os.path.join(out, "proc_bench_torch.json")])
    chaos = proc["proc_chaos"]
    check(chaos["all_futures_resolved"] and chaos["respawned"],
          f"14e serve_bench --proc-only: chaos {chaos}")
    print(f"[14e serve_bench] --proc-only: thread "
          f"{proc['proc_ab']['thread_imgs_per_sec']} vs process "
          f"{proc['proc_ab']['process_imgs_per_sec']} imgs/s (median ratio "
          f"{proc['proc_ab']['median_round_ratio']}); chaos: "
          f"{chaos['resolved']} of {chaos['in_flight_at_kill']} futures "
          f"resolved ({chaos['resolved_ok']} ok), worker "
          f"{chaos['killed_pid']} respawned as {chaos['respawned_pid']}")
    marks.append(("e proc-only", time.perf_counter()))
    print(f"[14 tools] phase took {marks[-1][1] - t0:.1f} s "
          f"({laps(t0, marks)} s)")
    return {"train_bench": train_launches, "e2e_bench": e2e_launches,
            "serve_bench": serve_launches}


# ---------------------------- 15. the training tools and model I/O
P15_CONFIG = "canonical"
P15_CKPT = dict(rounds=1, epochs=2, steps=4)
# seed 35 plans a SIGKILL at the second mid_ckpt_write hit (epoch 1's
# write torn before its marker, after epoch 0 committed: epoch 1's save
# waited for epoch 0's write), then a SIGTERM, so two segments resume
# from a commit; 4 epochs keep that hit inside the first half of the run.
# No ring workers: a cli.train child's ring spawns its workers after the
# child imported torch (~10 s a ring on the card's host, two rings a child)
P15_CHAOS = dict(kills=2, seed=35, records=8, val_records=4, epochs=4,
                 workers=0)
P15_FEED = dict(workers="0,2", min_seconds=3, repeats=1)
P15_FORWARD = (8, 512)          # (a) the seeded canonical forward


def upstream_pth(path, model, cfg, epoch: int, train_loss: float) -> str:
    """``model``'s weights written as upstream's trainer saves them:
    upstream's names under DDP's ``module.`` prefix, in ``{'weights',
    'epoch', 'train_loss'}``."""
    import torch

    from improved_body_parts_torch.cli.import_torch_checkpoint import (
        export_upstream_state_dict,
    )

    m = cfg.model
    torch.save({"weights": export_upstream_state_dict(
        model, m.nstack, m.hourglass_depth, prefix="module."),
        "epoch": epoch, "train_loss": train_loss}, path)
    return path


def upstream_import(dev, smi, ctx, work):
    """Phase 15 (a): phase 7's checkpoint written in upstream's names and
    imported by ``cli.import_torch_checkpoint``: its fused-lane people on
    phase 7's val set bit for bit phase 7's and the same AP; a seeded
    ``canonical`` imported the same way gives the source model's 512^2
    batch-8 forward bit for bit.  Returns the decode launches."""
    import torch

    from improved_body_parts_torch.cli import import_torch_checkpoint
    from improved_body_parts_torch.cli.evaluate import load_predictor
    from improved_body_parts_torch.config import get_config
    from improved_body_parts_torch.infer.evaluate import validation_oks
    from improved_body_parts_torch.models import build_model
    from improved_body_parts_torch.train import restore_checkpoint

    out = os.path.join(work, "p15a")
    os.makedirs(out, exist_ok=True)
    cfg = get_config(SYNTH_AP["config"])
    trained = build_model(cfg, device=dev, dtype=torch.float32)
    trained.load_state_dict(restore_checkpoint(ctx["checkpoint"])["model"],
                            strict=True)
    pth = upstream_pth(os.path.join(out, "synth_canonical.pth"), trained,
                       cfg, 52, 0.5)
    path = import_torch_checkpoint.main([
        "--pth", pth, "--out", os.path.join(out, "imported"),
        "--config", SYNTH_AP["config"], "--device", dev.type])
    check(path.endswith("epoch_52"), f"15a: imported to {path}")
    imported = load_predictor(SYNTH_AP["config"], path, device=dev,
                              boxsize=ctx["net"], params_dtype="fp32")
    reset_launches()
    res = validation_oks(imported, ctx["anno"], ctx["val_dir"],
                         device_decode=True, use_native=True,
                         dump_name="upstream_import",
                         results_dir=os.path.dirname(ctx["detections"]))
    launches = read_launches()
    with open(ctx["detections"]) as f:
        want = json.load(f)
    with open(os.path.join(os.path.dirname(ctx["detections"]),
                           "person_keypoints_upstream_import.json")) as f:
        got = json.load(f)
    check(got == want, f"15a: the imported checkpoint's people differ from "
          f"phase 7's ({len(got)} against {len(want)} detections)")
    check(res["AP"] == ctx["ap_fused"], f"15a: imported AP {res['AP']} != "
          f"phase 7's {ctx['ap_fused']}")
    for k, n in launches.items():
        check(n > 0, f"15a: {k} never launched evaluating the import")
    print(f"[15a upstream import] phase 7's checkpoint as an upstream .pth "
          f"(module. prefix, epoch 52) -> {os.path.basename(path)}: "
          f"{len(got)} fused-lane detections on the {SYNTH_AP['val_images']} "
          f"val images equal to phase 7's, AP {res['AP']:.4f} = phase 7's; "
          f"decode launches {launches} [{smi}]")
    del imported, trained

    # the published model's width: a seeded canonical through the same
    # .pth, and its forward against the source model's
    big = get_config(P15_CONFIG)
    src = build_model(big, device=dev, seed=0, dtype=torch.float32).eval()
    pth = upstream_pth(os.path.join(out, "canonical.pth"), src, big, 52,
                       0.5)
    path = import_torch_checkpoint.main([
        "--pth", pth, "--out", os.path.join(out, "imported_canonical"),
        "--config", P15_CONFIG, "--device", dev.type])
    dst = build_model(big, device=dev, seed=1, dtype=torch.float32).eval()
    dst.load_state_dict(restore_checkpoint(path)["model"], strict=True)
    b, size = P15_FORWARD
    x = torch.rand((b, size, size, 3), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(15))
    with torch.no_grad():
        want, got = src(x), dst(x)
    torch.cuda.synchronize()
    outs = [(i, j) for i in range(len(want)) for j in range(len(want[i]))]
    differ = [(i, j) for i, j in outs
              if not torch.equal(got[i][j], want[i][j])]
    check(not differ, f"15a: the imported canonical's forward differs from "
          f"the source model's at (stack, scale) {differ[:4]}")
    n_params = sum(p.numel() for p in dst.parameters())
    print(f"[15a upstream import] {P15_CONFIG} ({n_params} parameters) "
          f"seeded, through an upstream .pth: its batch-{b} forward at "
          f"{size}^2 equals the source model's bit for bit in all "
          f"{len(outs)} (stack, scale) outputs [{smi}]")
    del src, dst, want, got
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def in_background(fn, *args):
    """Start ``fn(*args)`` on a thread of its own; returns ``join``, which
    waits for it and gives its result or raises what it raised (a
    ``SystemExit`` of a ``--strict`` tool included)."""
    import threading

    box = {}

    def run():
        try:
            box["result"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 — raised again in join
            box["error"] = e

    thread = threading.Thread(target=run, name=f"bg-{fn.__module__}",
                              daemon=True)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["result"]
    return join


def training_tools(dev, smi, ctx, work):
    """Phase 15: the training tools and model I/O at full width.  (b)
    ``cli.ckpt_bench --strict`` at ``canonical`` (the stall ratio as
    measured, bit-identical restore, the write overlapping later spans;
    the focal kernels held on the first step's calls) first, on a quiet
    card and disk; then (c) ``cli.chaos_train --strict`` at
    ``canonical`` (a torn checkpoint write after the first commit and a
    SIGTERM, the control run, all four assertions), whose children run
    beside (a) ``cli.import_torch_checkpoint``
    (:func:`upstream_import`) and (e) ``cli.demo --params-dtype`` int8
    and bf16 on a drawn image, which time nothing; last (d)
    ``cli.feed_rate`` at ``canonical`` against phase 14's
    ``train_bench_torch.json``, alone again.  Returns the launches by
    path."""
    import cv2
    import torch

    from improved_body_parts_torch.cli import (
        chaos_train,
        ckpt_bench,
        demo,
        feed_rate,
    )
    from improved_body_parts_torch.config import get_config
    from improved_body_parts_torch.ops import losses

    t0 = time.perf_counter()
    marks = []
    out = os.path.join(work, "p15")
    os.makedirs(out, exist_ok=True)
    base = ["--config", P15_CONFIG, "--device", dev.type]
    launches = {}

    # (b) the checkpoint stall, sync against async
    focal_calls = []
    fused = losses.focal_l2_fused
    reset_focal()
    losses.focal_l2_fused = first_calls(fused, 5, focal_calls)
    try:
        bench = ckpt_bench.main(base + [
            "--rounds", str(P15_CKPT["rounds"]),
            "--epochs", str(P15_CKPT["epochs"]),
            "--steps", str(P15_CKPT["steps"]), "--strict",
            "--out", os.path.join(out, "ckpt_bench_torch.json")])
    finally:
        losses.focal_l2_fused = fused
    launches["ckpt_bench"] = focal_counts()
    check(bench["bit_identical_restore"], "15b ckpt_bench: the sync and "
          "async saves do not restore bit-identical")
    check(bench["saves_per_arm"] == P15_CKPT["epochs"],
          f"15b ckpt_bench: {bench['saves_per_arm']} saves an arm")
    check(bench["write_overlaps_step_or_eval"], "15b ckpt_bench: no write "
          "span overlaps a later step window or eval")
    check(len(focal_calls) == 5, f"15b: captured {len(focal_calls)} focal "
          "calls")
    hold_focal(focal_calls,
               torch.tensor(get_config(P15_CONFIG).train.nstack_weight,
                            device=dev) * 0.25,
               "ckpt_bench's first step", tag="[15b ckpt_bench]")
    print(f"[15b ckpt_bench] {P15_CONFIG}, {bench['payload_bytes']} B a "
          f"save (params, BN stats, momentum, SWA shadow), "
          f"{bench['rounds']} round(s) of {bench['epochs_per_arm']} epochs "
          f"x {bench['steps_per_epoch']} steps: sync stall "
          f"{bench['sync_stall_ms_mean']} ms a save (median "
          f"{bench['sync_stall_ms_median']}), async "
          f"{bench['async_stall_ms_mean']} ms (median "
          f"{bench['async_stall_ms_median']}); reduction "
          f"{bench['stall_reduction']} against the target "
          f"{bench['stall_reduction_target']} (meets "
          f"{bench['meets_target']}); bit-identical restore; "
          f"{bench['write_overlapping_later_spans']} later spans inside "
          f"the writes; focal launches {launches['ckpt_bench']} [{smi}]")
    marks.append(("b", time.perf_counter()))

    # (c) kills and relaunches of supervised training: its children run
    # while (a) and (e) run here
    torch.cuda.empty_cache()
    chaos_done = in_background(chaos_train.main, base + [
        "--kills", str(P15_CHAOS["kills"]), "--seed", str(P15_CHAOS["seed"]),
        "--records", str(P15_CHAOS["records"]),
        "--val-records", str(P15_CHAOS["val_records"]),
        "--epochs", str(P15_CHAOS["epochs"]),
        "--workers", str(P15_CHAOS["workers"]), "--strict",
        "--out", os.path.join(out, "chaos_train_torch.json")])
    try:
        launches["upstream_import"] = upstream_import(dev, smi, ctx, work)
        marks.append(("a", time.perf_counter()))

        # (e) a drawn image through the demo at int8 and bf16 storage
        image = os.path.join(ctx["val_dir"], "000000000001.jpg")
        people = {}
        for dtype in ("int8", "bf16"):
            result = os.path.join(out, f"demo_{dtype}.jpg")
            rep = demo.main(["--config", SYNTH_AP["config"], "--checkpoint",
                             ctx["checkpoint"], "--image", image, "--output",
                             result, "--boxsize", str(ctx["net"]),
                             "--params-dtype", dtype, "--device", dev.type])
            drawn = cv2.imread(result)
            check(drawn is not None
                  and drawn.shape == cv2.imread(image).shape,
                  f"15e demo {dtype}: no result image of the input's shape")
            check(rep["people"] > 0, f"15e demo {dtype}: no people found")
            people[dtype] = rep["people"]
        print(f"[15e demo] {os.path.basename(image)} through cli.demo: "
              + ", ".join(f"{d} {n} people" for d, n in people.items())
              + f", result images written [{smi}]")
        marks.append(("e", time.perf_counter()))
    except BaseException:
        try:
            chaos_done()  # its children end before the failure is told
        except BaseException:  # noqa: BLE001 — the first failure wins
            pass
        raise
    chaos = chaos_done()
    shutil.rmtree(chaos["workdir"], ignore_errors=True)
    check(chaos["injection_kinds"] == ["mid_ckpt_write", "sigterm"]
          and chaos["injections_done"] == P15_CHAOS["kills"],
          f"15c chaos_train: injections {chaos['injection_kinds']}, "
          f"{chaos['injections_done']} done")
    check(chaos["final_matches_control"] is True
          and chaos["control"].get("returncode") == 0,
          f"15c chaos_train: control {chaos['control']}, final matches "
          f"{chaos['final_matches_control']}")
    last = chaos["segments"][-1]
    check(chaos["resumes_from_commit"] >= 1 and last["end_status"]
          == "completed" and last["committed_before"] >= 0
          and last["resumed_from"] == last["committed_before"],
          f"15c chaos_train: {chaos['resumes_from_commit']} resumes from a "
          f"commit; the last segment {last}")
    print(f"[15c chaos_train] {P15_CONFIG}, {P15_CHAOS['records']} records "
          f"({chaos['steps_per_epoch']} steps an epoch), {chaos['epochs']} "
          f"epochs: control {chaos['control'].get('wall_s')} s; segments "
          + "; ".join(
              f"{s['segment']}: "
              + (f"{s['injection']['kind']}:{s['injection']['hit']}"
                 if s["injection"] else "none")
              + f" rc {s['returncode']} {s['wall_s']} s, committed "
              f"{s['committed_before']}->{s['committed_after']}, "
              f"resumed {s['resumed_from']}, end {s['end_status']}"
              for s in chaos["segments"])
          + f"; resumes on the last committed "
          f"{chaos['all_resumes_on_last_committed']} "
          f"({chaos['resumes_from_commit']} from a commit), leaked pids "
          f"{chaos['leaked_pids_total']}, writer thread leaked "
          f"{chaos['writer_thread_leaked']}, final bit-identical "
          f"{chaos['final_bit_identical']}, loss rel diff "
          f"{chaos['final_loss_rel_diff']} (tol {chaos['loss_tol']}) "
          f"[{smi}]")
    marks.append(("c", time.perf_counter()))

    # (d) the ring's feed rate against phase 14's train rate
    feed = feed_rate.main(base + [
        "--workers", P15_FEED["workers"],
        "--min-seconds", str(P15_FEED["min_seconds"]),
        "--repeats", str(P15_FEED["repeats"]),
        "--train-bench", os.path.join(work, "p14", "train_bench_torch.json"),
        "--out", os.path.join(out, "input_pipeline_torch.json")])
    for row in feed["rows"]:
        check(row["samples"] > 0, f"15d feed_rate: no samples in {row}")
    print(f"[15d feed_rate] {P15_CONFIG} {feed['image_size']}^2 batch "
          f"{feed['batch']}, train rate {feed['chip_train_rate_imgs_per_sec']}"
          f" imgs/s (phase 14's train_bench): "
          + ", ".join(f"{r['mode']} {r['pipeline']} x{r['workers']} "
                      f"{r['samples_per_sec']} samples/s"
                      for r in feed["rows"])
          + f"; projection {feed['projection']}; {feed['host_cores']} host "
          f"cores [{smi}]")
    marks.append(("d", time.perf_counter()))
    print(f"[15 training tools, model I/O] phase took "
          f"{marks[-1][1] - t0:.1f} s ({laps(t0, marks)} s; c ran beside "
          f"a and e)")
    return launches


def share_bytecode() -> str:
    """One bytecode cache, in a temporary directory, for this process and
    every Python process it starts.  Where ``PYTHONDONTWRITEBYTECODE`` is
    set and the installed packages hold no ``.pyc`` files, each process
    compiles torch's sources anew, seconds of every child's start (the
    chaos segments, the serve and rank workers).  Nothing is written
    beside the sources, and the cache goes when the script ends."""
    import atexit

    cache = tempfile.mkdtemp(prefix="chip_smoke_pycache_")
    atexit.register(shutil.rmtree, cache, True)
    os.environ["PYTHONPYCACHEPREFIX"] = cache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = cache
    sys.dont_write_bytecode = False
    return cache


def main() -> int:
    share_bytecode()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on "
              "an H100", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from improved_body_parts_torch.config import (
        InferenceModelParams,
        default_inference_params,
        get_config,
    )
    from improved_body_parts_torch.infer import Predictor, decode_device
    from improved_body_parts_torch.infer.resize import upsample_cubic
    from improved_body_parts_torch.models import build_model
    from improved_body_parts_torch.ops import _build, cuda_assembly, cuda_peaks
    from improved_body_parts_torch.ops.peaks import (
        PairStats,
        TopKPeaks,
        limb_topk_from_stats,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config("canonical")
    sk = cfg.skeleton
    params, _ = default_inference_params()
    limbs_from = tuple(a for a, _ in sk.limbs_conn)
    limbs_to = tuple(b for _, b in sk.limbs_conn)

    # ---------------------------------------------------------- 1. card
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"[1 card] {smi}")
    print(f"[1 card] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"device 0: {name}, capability {cap}, "
          f"{torch.cuda.device_count()} device(s)")
    check(cap == (9, 0), f"expected a Hopper card (9, 0), got {cap}")

    # --------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[2 build] {sorted(libs)} built and loaded in {build_s:.2f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for stem, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if any(s in line for s in ("registers", "spill", "entry func")):
                print(f"[2 build] {stem}.cu: {line.strip()}")

    # ------------------------------------------------------- 3. kernels
    rng = np.random.default_rng(0)
    grid = []
    for _ in range(BATCH):
        people = [person_joints(sk, x0, rng.uniform(20, 120),
                                rng.uniform(260, 480))
                  for x0 in rng.uniform(0, WIDTH - 260, 4)]
        grid.append(planted_grid_maps(sk, people, HEIGHT // 4, WIDTH // 4,
                                      dev))
    grid = torch.stack(grid)
    gen = torch.Generator(device=dev).manual_seed(0)
    grid = grid + 0.01 * torch.randn(grid.shape, device=dev, generator=gen)
    maps = upsample_cubic(grid, sk.stride)                # (8, 640, 896, 50)
    kp = maps[..., sk.heat_start:sk.heat_start + sk.num_parts]
    paf = maps[..., :sk.paf_layers]
    valid_h = torch.full((BATCH,), HEIGHT, dtype=torch.int32, device=dev)
    valid_w = torch.tensor([WIDTH, 853] * (BATCH // 2), dtype=torch.int32,
                           device=dev)
    kw_pk = dict(thre=params.thre1, k=TOPK, radius=RADIUS)
    kw_st = dict(limbs_from=limbs_from, limbs_to=limbs_to,
                 num_samples=SAMPLES, thre2=params.thre2)

    results = {}
    pk_plain = cuda_peaks.topk_peaks_plain(kp, valid_h, valid_w, **kw_pk)
    pk_kernel = cuda_peaks.topk_peaks_kernel(kp, valid_h, valid_w, **kw_pk)
    torch.cuda.synchronize()
    err = compare("topk_peaks", pk_kernel, pk_plain, {0, 1, 5, 6}, tol=0.0)
    n_kept = int(torch.clamp(pk_plain[6], max=TOPK).sum())
    check(n_kept > 0, "topk_peaks: the planted maps hold no peaks")
    out_bytes = BATCH * sk.num_parts * (TOPK * 6 * 4 + 4)
    run_pk = lambda: cuda_peaks.topk_peaks_kernel(  # noqa: E731
        kp, valid_h, valid_w, **kw_pk)
    pk_passes = device_ms(run_pk, PEAKS_PASSES)
    results["topk_peaks"] = dict(
        err=err,
        ms=cuda_ms(run_pk, 20),
        device_ms=sum(pk_passes.values()),
        plain_ms=cuda_ms(lambda: cuda_peaks.topk_peaks_plain(
            kp, valid_h, valid_w, **kw_pk), 5),
        bytes=kp.numel() * 4 + out_bytes + 2 * BATCH * 4,
        ops=kp.numel() * 10)  # 9-tap max + threshold per pixel
    floor_ms = read_floor_ms(kp)
    print("[3 kernels] topk_peaks device time by pass (profiler, 20 calls): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in pk_passes.items())
          + f"; reading each pixel's {sk.num_parts}-channel slice once and "
          f"nothing else (peaks_read_probe) takes {floor_ms:.4f} ms [{smi}]")

    x_ref, y_ref = pk_plain[2], pk_plain[3]
    st_plain = cuda_peaks.limb_pair_stats_plain(paf, x_ref, y_ref, **kw_st)
    st_kernel = cuda_peaks.limb_pair_stats_kernel(paf, x_ref, y_ref,
                                                  **kw_st)
    torch.cuda.synchronize()
    err = compare("limb_pair_stats", st_kernel, st_plain, {1, 2}, tol=0.0)
    samples = int(st_plain[2].sum())  # this run's gathered samples
    pairs = st_plain[0].numel()
    run_st = lambda: cuda_peaks.limb_pair_stats_kernel(  # noqa: E731
        paf, x_ref, y_ref, **kw_st)
    results["limb_pair_stats"] = dict(
        err=err,
        ms=cuda_ms(run_st, 20),
        device_ms=sum(device_ms(run_st, LIMBS_PASSES).values()),
        plain_ms=cuda_ms(lambda: cuda_peaks.limb_pair_stats_plain(
            paf, x_ref, y_ref, **kw_st), 5),
        bytes=samples * 4 + 2 * x_ref.numel() * 4 + pairs * 4 * 4,
        ops=samples * 8 + pairs * 12)
    dense_cases(sk, dev, gen, valid_h, valid_w, kw_pk, kw_st)
    bucket_cases(sk, dev, params, kw_pk, kw_st, smi)
    generic_cases(kp, paf, x_ref, y_ref, valid_h, valid_w, kw_pk, kw_st)

    peaks = TopKPeaks(*pk_plain)
    cands = limb_topk_from_stats(PairStats(*st_plain), peaks, valid_h,
                                 limbs_from=limbs_from, limbs_to=limbs_to,
                                 connect_ration=params.connect_ration,
                                 m_cap=2 * TOPK)
    check(bool(cands.valid.any()), "greedy_assemble: the planted maps give "
          "no accepted limb candidates")
    results["greedy_assemble"] = assembly_cases(sk, dev, params, peaks,
                                                cands, rng, smi)
    results.update(focal_kernels(cfg, dev))
    for kname, r in results.items():
        r["bound_ms"] = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S,
                                  r["ops"] / FP32_OPS_PER_S)
        r["bound_by"] = ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                         >= r["ops"] / FP32_OPS_PER_S else "operations")
        print(f"[3 kernels] {kname}: kernel {r['ms']:.4f} ms (wrapper call, "
              f"events), {r['device_ms']:.4f} ms on the device (profiler), "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['bytes']} B), max abs err "
              f"{r['err']:.3g}; library_ms: none (no single PyTorch call "
              f"computes this function) [{smi}]")
    print(f"[3 kernels] {n_kept} kept peaks, {samples} limb samples, "
          f"{int(cands.valid.sum())} accepted candidates at batch {BATCH} "
          f"x {HEIGHT}x{WIDTH}")
    print("[3 kernels] launch counters after the comparisons: "
          f"topk_peaks {cuda_peaks.topk_peaks_kernel.launches}, "
          f"limb_pair_stats {cuda_peaks.limb_pair_stats_kernel.launches}, "
          f"greedy_assemble {cuda_assembly.greedy_assemble_kernel.launches}")
    del maps, kp, paf, grid, st_plain, st_kernel

    # -------------------------------------------------- 4. planted serve
    planted = [person_joints(sk, x0, 120, 360) for x0 in (30, 230, 430)]
    stub_maps = planted_grid_maps(sk, planted, HEIGHT // 4, WIDTH // 4, dev)
    stub_maps += 1e-3 * torch.rand(stub_maps.shape, device=dev,
                                   generator=gen)
    pred = Predictor(MirrorStub(sk, stub_maps), sk,
                     model_params=InferenceModelParams(boxsize=HEIGHT))
    requests = [np.zeros((HEIGHT, w, 3), np.uint8)
                for w in (WIDTH, 640, 768, WIDTH)]
    cuda_assembly.greedy_assemble_kernel.launches = 0
    decoded = pred.predict_decoded_batch(requests)
    asm_launches = cuda_assembly.greedy_assemble_kernel.launches
    check(asm_launches > 0, "planted serve: greedy_assemble never launched")
    worst = 0.0
    for i, dec in enumerate(decoded):
        check(dec.ok, f"planted request {i}: an overflow flag is set")
        worst = max(worst, planted_error(sk, decode_device(dec, sk),
                                         planted, f"planted request {i}"))
    print(f"[4 planted] {len(requests)} requests of widths "
          f"{[r.shape[1] for r in requests]}: {len(planted)} people each, "
          f"ok, max keypoint error {worst:.3f} px; greedy_assemble launched "
          f"{asm_launches} times")

    # --------------------------------------------------- 5. full width
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 128_998_760, f"canonical has {n_params} parameters")
    pred = Predictor(model, sk)
    images = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
              for _ in range(BATCH)]
    pred.predict_decoded_batch(images)                  # warm-up
    torch.cuda.synchronize()
    print(f"[5 full width] canonical imhn, {n_params} parameters, bf16 "
          f"autocast, built and warmed up in "
          f"{time.perf_counter() - t0:.1f} s")

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = pred.predict_decoded_batch(images)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    peak_mem = torch.cuda.max_memory_allocated()
    print(f"[5 full width] kernel launches in one predict_decoded_batch "
          f"of {BATCH}: {launches}")
    for kname, n in launches.items():
        check(n > 0, f"{kname}: no launch on the full-width path")
    check(len(out) == BATCH and all(
        d.subset.shape == (pred.assembly_pmax, sk.num_parts + 2, 2)
        and np.isfinite(d.subset).all() for d in out),
        "full width: malformed decode results")

    t0 = time.perf_counter()  # host preprocessing: cubic resize + pad
    host = np.stack([pred._prepare_input(im, HEIGHT / 480)[0]
                     for im in images])
    prep_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    bucket = torch.from_numpy(host).to(dev)
    torch.cuda.synchronize()
    h2d_ms = 1e3 * (time.perf_counter() - t0)
    vh = torch.full((BATCH,), HEIGHT, dtype=torch.int32, device=dev)
    vw = torch.full((BATCH,), 853, dtype=torch.int32, device=dev)
    spec = pred._decode_spec(params)
    fwd_ms = cuda_ms(lambda: pred.ensemble_maps(bucket), 3)
    lane_maps = pred.ensemble_maps(bucket)
    check(tuple(lane_maps.shape) == (BATCH, HEIGHT, WIDTH, sk.num_layers)
          and bool(torch.isfinite(lane_maps).all()),
          "full width: ensembled maps malformed or not finite")
    dec_ms = cuda_ms(lambda: pred.decode_maps(lane_maps, vh, vw,
                                              params.thre1, spec), 3)
    calls = []
    for _ in range(3):  # host clock: the call ends in its one fetch
        t0 = time.perf_counter()
        pred.predict_decoded_batch(images)
        calls.append(1e3 * (time.perf_counter() - t0))
    total_ms = statistics.median(calls)

    # the lane only enqueues: an event recorded as the async call returns
    # is still pending behind the ~100 ms forward, and resolve() is the
    # one read back to the host
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resolve = pred.predict_decoded_batch_async(images)
    enqueue_ms = 1e3 * (time.perf_counter() - t0)
    returned = torch.cuda.Event()
    returned.record()
    pending = not returned.query()
    again = resolve()
    resolve_ms = 1e3 * (time.perf_counter() - t0)
    check(pending, "full width: the device work was done when "
          "predict_decoded_batch_async returned, so the lane read back to "
          "the host before resolve()")
    check(len(again) == BATCH and all(
        d.subset.shape == (pred.assembly_pmax, sk.num_parts + 2, 2)
        and np.isfinite(d.subset).all() for d in again),
        "full width: malformed results from the async call")
    print(f"[5 full width] predict_decoded_batch_async returned after "
          f"{enqueue_ms:.2f} ms (host clock) with the device work still "
          f"queued; resolve() returned at {resolve_ms:.2f} ms")
    print(f"[5 full width] host preprocessing {prep_ms:.2f} ms, "
          f"host-to-device copy {h2d_ms:.2f} ms, "
          f"forward+merge+upsample {fwd_ms:.2f} ms, "
          f"extraction+assembly {dec_ms:.2f} ms, predict_decoded_batch "
          f"{total_ms:.2f} ms ({BATCH * 1e3 / total_ms:.2f} imgs/s; first "
          f"timed call {wall_s * 1e3:.2f} ms), peak device memory "
          f"{peak_mem / 2**30:.2f} GiB [{smi}]")

    # -------------------------------------------- batcher (5 to 6)
    planted_batcher(sk, stub_maps, planted, smi)
    batcher_launches = full_width_batcher(pred, rng, smi)

    del model, pred, bucket, lane_maps, out, resolve, again
    # the batcher's dispatcher, fetcher and pool threads each left a
    # cuBLAS workspace on the card; release them so phase 6's peak is its
    # own (its thread makes its workspace anew)
    held = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    print(f"[batcher] device memory allocated after the serve phases "
          f"{held / 2**20:.1f} MiB, {torch.cuda.memory_allocated() / 2**20:.1f}"
          f" MiB once the cuBLAS workspaces are released")

    # ---------------------------------------- 6. training at full width
    train_launches, sync_train = train_full_width(cfg, dev, smi)
    launches.update(train_launches)
    print(f"[chip_smoke] phases 1-6 took "
          f"{time.perf_counter() - T_START:.1f} s")

    # ------------------------------ 7. learn -> AP, 8. accuracy tiers
    work = tempfile.mkdtemp(prefix="chip_smoke_synth_ap_")
    try:
        ap_launches, trained = learn_to_ap(dev, smi, work)
        grid_launches, grid_times = accuracy_tiers(dev, smi, trained)
        # --------------------------------- 9. the rest of training
        rest = rest_of_training(dev, smi, sync_train, trained, work)
        # -------------------------- 10. serving beyond one batcher
        serving = serving_beyond_one_batcher(dev, smi, trained, stub_maps,
                                             planted, work)
        # ------------------ 11. live video streams, run telemetry
        streams = live_streams(dev, smi, trained, work)
        # ------------------------------ 12. multi-card training
        streams.update(multi_card_training(dev, smi, sync_train, work))
        # ------------------------- 13. height-sharded inference
        streams.update(height_sharded_inference(dev, smi, trained,
                                                sync_train, work))
        # ------------------------- 14. the measuring tools
        streams.update(measure_tools(dev, smi, work))
        # ------------- 15. the training tools and model I/O
        streams.update(training_tools(dev, smi, trained, work))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ------------------------------------------------------- the result
    src = {"topk_peaks": ("improved_body_parts_torch/csrc/peaks.cu",
                          "improved_body_parts_tpu/ops/pallas_peaks.py:150"),
           "limb_pair_stats": (
               "improved_body_parts_torch/csrc/limbs.cu",
               "improved_body_parts_tpu/ops/pallas_peaks.py:224"),
           "greedy_assemble": (
               "improved_body_parts_torch/csrc/assembly.cu",
               "improved_body_parts_tpu/ops/pallas_assembly.py:75"),
           "focal_fwd": ("improved_body_parts_torch/csrc/focal.cu",
                         "improved_body_parts_tpu/ops/pallas_focal.py:98"),
           "focal_bwd": ("improved_body_parts_torch/csrc/focal.cu",
                         "improved_body_parts_tpu/ops/pallas_focal.py:120")}
    # ``launches`` are phase 7's learn->AP run (training, then the fused
    # lane's evaluation of the trained checkpoint); the other paths'
    # counts stand beside them
    by_path = {k: {"predict_decoded_batch": launches[k],
                   "batcher": batcher_launches[k]} for k in DECODE_KERNELS}
    by_path.update({k: {"train_epoch": launches[k]}
                    for k in ("focal_fwd", "focal_bwd")})
    for k, n in ap_launches.items():
        by_path[k]["learn_to_ap"] = n
    for k, n in grid_launches.items():
        by_path[k]["grid"] = n
    for path, counts in (list(rest["launches"].items())
                         + list(serving.items()) + list(streams.items())):
        for k, n in counts.items():
            by_path[k][path] = n
    launches = ap_launches
    kernels = [dict(name=k, route="cuda", source=src[k][0],
                    replaces=src[k][1], launches=launches[k],
                    launches_by_path=by_path[k],
                    max_abs_err=r["err"], ms=r["ms"],
                    device_ms=r["device_ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=None)
               for k, r in results.items()]
    for row in kernels:
        for shape, times in rest["focal_device_ms"].items():
            if row["name"] in times:
                t = times[row["name"]]
                row[f"{shape}_shape_device_ms"] = t["device_ms"]
                row[f"{shape}_shape_same_inputs_ms"] = t["same_inputs_ms"]
                row[f"{shape}_shape_bound_ms"] = t["bound_ms"]
                row[f"{shape}_shape_bound_by"] = t["bound_by"]
        if row["name"] in grid_times:
            row["grid_shape_ms"], row["grid_shape_device_ms"] = \
                grid_times[row["name"]]
    print(json.dumps({"kernels": kernels}, allow_nan=False))
    print(f"[chip_smoke] every phase passed in "
          f"{time.perf_counter() - T_START:.1f} s")
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
