#!/usr/bin/env python3
"""Drive the PyTorch port (progen_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--details PATH]

Phases, one line each:
  1. build the CUDA kernels from progen_tpu_torch/csrc (one nvcc per
     source, all at once), and read, for each bfloat16/float16 kernel of
     the attention (the forward A1/A4 and the backwards' row and key
     passes) and the SGU tail's bfloat16 mix (L2), ptxas's registers and
     spills and the count of tensor-core instructions in its machine code
     (cuobjdump -sass): it fails if one has none, or spills (the
     attention's at d = 64);
  2. at the base model's shapes (configs/model/base.toml), hold each
     kernel against its plain PyTorch version on the card, and time the
     kernel (by CUDA events around back-to-back calls, ``ms``, and by
     its device time under torch.profiler, ``device_ms``, which the share
     of the bound is taken from), the plain version and, where one exists,
     a single PyTorch call computing the same function: L1's calls rotate
     over inputs that overflow the L2 cache; the forward kernels (A1 on the
     tensor cores, beside scaled_dot_product_attention) at the scoring
     batch of 8, the attention backwards A2 (kv-centric) and A3 (halo) at
     the training micro-batch of 4;
  3. the main path, driven once with the launch counts set to 0 just
     before and read just after: the base model (dim 1024, depth 24,
     heads 16, dim_head 64, window 512, seq_len 1024, ~401M parameters,
     random weights from a seed) scores 8 protein strings through
     score_step, one forward that must launch 24 (attention), 48 (norm +
     shift) and 2 (SGU tail) kernels; then sample_fast_batched answers 4
     generation requests (top_k 25, BOS, length 256) with the KV-cache
     decoder, which launches none;
  4. the checks: scores of the expected shape, finite, over the expected
     tokens, with logits that agree with the same model on the plain
     path (each kernel's plain version swapped in by this script); the
     generated sequences well formed, and the decoder's logits in
     agreement with the full forward over their 256 positions;
  5. the train path, with the launch counts set to 0 just before and read
     just after: init_train_state at base (remat on), then 3 optimizer
     steps of make_train_step on (4, 4, 1025) protein batches (the JAX
     CLI's --batch_size 4 --grad_accum_every 4, lr 2e-4, weight decay
     1e-3, clip 0.5): each step must launch A1 192, A2 96, L1 384 and L2
     16 times (remat runs every forward kernel twice a micro-batch);
  6. the checks of the train path: finite losses and grad norms, no
     skipped step, a lower loss on the repeated batch after the 3 steps;
     then, on a batch of the proteins back to back with no padding (so
     every window's rows get a gradient), one micro-batch's gradients
     through the kernels against the plain path and a float32 plain
     model, and one step twice from the same state: with A2 and, on a
     copy of the state, with the attention backward switched to A3
     ("halo"), counted on its own (A3 96, A2 0), whose gradients must
     agree with the A2 step's; then one plain A2 step, profiled by kernel
     group;
  7. seqpar, the sequence-parallel train path at configs/model/long8k.toml
     (dim 512, depth 12, heads 8, window 512, seq_len 8192, 2 gMLP
     layers, remat on, ~184M parameters; nothing cut): first one process
     runs 3 steps of make_train_step on the whole sequence (A1/A2) on a
     (2, 2, 8193) batch of unpadded random tokens, and a float32 model
     the same 3 steps from the same state; then 2 ranks, spawned here,
     share the card over gloo (grid data 1 x seq 2) and run the same 3
     steps of make_train_step(grid) from the same state, in bfloat16 and
     then in float32, each on its 4096 positions of every row, through
     A4 (the attention with its neighbour's halo), L1 with the halo row
     and L2 for its rows. With each rank's counts set to 0 just before
     and read just after, each bfloat16 step must launch A4 48 (forward,
     remat doubles it) and 24 (kv backward), L1 96 and L2 8 times on
     each rank; one more first step on a copy of the state, with the
     attention backward switched to A4's q-centric ("halo") form, must
     launch it 24 times and agree with the kv step's gradients as A3 does
     with A2's in phase 6. Their losses, the first step's gradients and the
     parameters after the 3 steps are held against the single
     process's, float32 against float32 and bfloat16 against bfloat16
     (the rule by SEQPAR_*).
     Two ranks share one card here (NCCL puts one rank on a card), so
     their step time is a record of the path, not a scaling number;
  8. cli, the entry points a user runs, called in this process through
     their ``run(argv)`` at base.toml's widths with its depth cut to 6
     (CLI_DEPTH) and --mixed_precision, in build/chip_smoke_cli/
     (removed afterwards): generate_data writes
     TFRecord shards from a synthetic FASTA (512 proteins, Uniref50-style
     headers, lengths 64..1000, from a numpy seed); cli.train takes 4
     steps (batch 4 x 4, checkpoint and validate every 2, a sample at step
     0), then resumes for 2 more; cli.eval walks the valid split;
     cli.sample decodes one sequence (each decode cut to 32 new tokens
     since slice 9, CLI_SAMPLE_TOKENS). With the launch counts set to 0
     just before and read just after, every step must launch A1 48, A2
     24, L1 96 and L2 16 times and each eval forward A1 6, L1 12, L2 2.
     Checks: every loss finite; the first run's final checkpoint restores
     bit for bit (parameters, moments, count, step, cursor, model
     config); the resumed run's first batch is the records after the
     cursor (read apart from the iterator); cli.sample's tokens equal
     sample_fast's with the same seed on the restored model; one byte
     flipped in the newest checkpoint's params.pt makes the walk
     quarantine it and take the one before. It prints each step's ms and
     tokens/s beside phase 5's, the checkpoint's bytes and save and
     restore seconds, the padded share of the synthetic batches, the
     eval loss and the phase's seconds;
  9. serve, the slot-pool engine at base.toml's widths with its depth cut
     to 6 (SERVE_DEPTH), in bfloat16: a ServeEngine
     of 8 slots (max_len 256) behind a Scheduler (prefill_chunk 32, a
     512 MiB PrefixCache) answers 13 requests, more than the slots: a
     top_k = 1 occupant that stops at its first draw (its slot is reused
     at once), six parity requests (top_k 25, BOS, primes of 4-32
     tokens, lengths 48-192), two with temperature 0.8 and top_p 0.95,
     an infill freezing a third of its positions, two sharing a 128-token
     scaffold (primes 160 and 144: the second hits the prefix cache) and
     one embedding. With the launch counts set to 0 just before and read
     just after, the run must launch exactly one forward's kernels (the
     embedding's: A1 6, L1 12, L2 2) and none in prefill or decode.
     Checks: every generate stream against sample_fast on the card with
     the same seed, knobs and template, bit for bit, or, where the batch
     of 8 rounds otherwise than batch 1, with a near tie at the first
     differing draw (each decoder's token replayed from its own logits
     and noise, the two logits within the generate check's bound, and
     either the reference's top two perturbed scores within twice their
     distance or the two logits keeping different top_k/top_p sets with
     a token either decoder drew among the ones that moved); all 12
     generate streams through one slot (the occupant, then a request
     with knobs, then the rest) bit for bit; the infill's frozen
     positions verbatim; the prefix hit
     bit-equal to the same request admitted cold, with only the fed
     positions counted; the embedding against the plain path and the
     float32 model by the scoring check's rule; every slot free at the
     end. Then cli.serve in child processes on a checkpoint of the same
     weights saved by checkpoint.py: three requests and an embedding, then
     EOF (exit 0, each answered); the same with --journal_dir, SIGKILLed
     after its first 8 tokens, then a --replay run: every id settled
     exactly once over the two, and each stream over both lives bit-equal
     to the first run's. It prints decode steps/s and tokens/s, TTFT p50
     and p99, prefill ms per fed token, the embedding's ms, the pool's
     device bytes and the phase's seconds, beside the card;
 10. workloads, the protein-design entry points at base.toml's widths
     with its depth cut to 6 (WL_DEPTH), in bfloat16,
     in build/chip_smoke_workloads/ (removed afterwards): A1, L1 and L2
     first held against their plain versions at the phase's new shapes
     (batch 32 at n = 1024; n = w = 512 at batch 8); the model
     written as a reference ckpt_*.pkl (Haiku names, by an inverse of the
     converter's mapping kept in this script) and converted by cli.convert
     in a child process, its parameters bit-equal to the model's;
     run_batch_score on a synthetic FASTA (64 proteins with Uniref50-style
     headers, lengths 64..1000, and 2 too long), batch 8: 8 batches, the 2
     skipped, every record bit-equal to score_step on the same batch;
     cli.batch_score in a child SIGKILLed by PROGEN_CHAOS=score/batch:kill@2
     and a child that resumes: every id once, each record bit-equal to the
     in-process run's; the mutagenesis scan of a 200-residue protein at
     positions 0..31 (641 rows, 21 forwards of 32), 8 mutants and the wild
     type against batch-1 references and the whole matrix against the
     plain path; cli.scan --positions 0:8 on the converted checkpoint; a
     pure-attention model at base widths (depth cut to 6) scoring 8 short
     and 8 long records, so A1 runs at n = w, against the plain path; and
     int8 serving: the calibration report, 4 streams at one slot bit-equal
     to sample_fast on the dequantised weights, and the int8 and bfloat16
     engines' decode rates at 8 slots in alternating runs. With the launch
     counts set to 0 just before and read just after each counted run, the
     scorer must launch A1 48, L1 96, L2 16, the scan A1 126, L1 252, L2
     42, cli.scan 6 forwards' and the n = w scorer 2 forwards' kernels. It
     prints sequences/s and tokens/s, mutants/s, the conversion's bytes
     and seconds, the int8 report, bytes and decode rates beside the
     bfloat16 engine's, and the phase's seconds by part, beside the card;
 11. grid, on 2 ranks spawned here that share the card over gloo, started
     once (the kernels built in this process first; A1, A2 and A3 held
     against their plain versions at large.toml's shapes on a model rank,
     (2, 7, 1024, 128) at window 512, with their times, bound, SDPA's
     time and ptxas's spill bytes at d = 128, and L1 and L2 at large's
     widths). Each rank runs in turn, with its launch counts set to 0
     just before each part and read per step: tensor parallelism at
     configs/model/large.toml's widths (dim 1792, 14 heads of 128) with
     its depth cut to 6 since slice 9 (TP_DEPTH; 298,584,064 parameters,
     bfloat16; grid data 1 x model 2): 3 steps
     of make_train_step(grid) on (2, 2, 1025) random tokens, each rank
     launching A1 24, A2 12, L1 48 and L2 8 times a step; rank 0 then
     takes the same 3 steps alone in bfloat16 and in float32 from the
     same weights and holds the grid's losses, first gradients (gathered
     whole) and parameter changes against them by phase 7's rule
     (SEQPAR_*; the gradient cosine by TP_COS_RULE: tensor parallelism
     rounds its row-parallel sums otherwise than one process, see
     tools/tp_rounding.py); the float32 form of the rule at base widths with depth
     cut to 4; ZeRO-1 on data 2 x model 1 at base.toml's widths with
     its depth cut to 6 (ZERO1_DEPTH), 3 steps on
     (2, 4, 1025), bit-equal to the same ranks without it, each rank's
     moment bytes halved; GPipe and then 1F1B on 2 stages (11 uniform
     layers each, the gMLP layers and the head on the last) with 4
     microbatches of (1, 8, 1025), each held against one process by
     phase 7's rule and 1F1B's first gradients against GPipe's, then 1F1B
     again with 8 microbatches (PIPE_M_LONG), each stage's launches exact;
     stage 0's peak growth (the peak less what the window opened with)
     must be 1F1B's at most GPipe's at M = 4 and not rise from M = 4 to
     M = 8; and cli.train --mesh_model 2 --dist_backend
     gloo --mixed_precision at base.toml's widths with its depth cut to 6
     (GRID_CLI_DEPTH) on the synthetic FASTA of phase 8 (batch 4 x 1, 3
     steps, its cadenced sample cut to 32 tokens):
     the coordinator's checkpoint must hold each rank's parameter shards
     bit for bit (sha256), and the single-process cli.train resumes it
     for 1 step. It prints each path's step ms, tokens/s, the model
     group's all-reduce ms per step, peak bytes per rank (raw, and as
     growth over the state: every timed run keeps its first gradients,
     initial parameters and change in host memory, so the peak counts the
     state and the step alone) and the phase's seconds by part, beside
     the card. Two ranks share one card here, so their step times record
     the path, not scaling;
 12. resilience, the training-side telemetry and fault tolerance: in
     build/chip_smoke_resilience/ (removed afterwards), the synthetic
     FASTA of phase 8 through generate_data, then python -m
     progen_tpu_torch.cli.train in a child process at base.toml's widths
     with the depth cut to 6 since slice 9 (RES_DEPTH; --mixed_precision,
     batch 4 x 4, 9 steps) with --async_checkpoint --checkpoint_every 3 --prom_file
     --profile_dir --stall_timeout 300 --stall_escalate_after 2
     --anomaly_patience 3 --flight_dir --profile_pin and
     PROGEN_CHAOS=train/loss:nan@3 (wandb blocked in the child, so the
     JSON-lines tracker writes events.jsonl): it must exit
     0 after logging "anomaly rollback 1/3" (the state restored from an
     asynchronous checkpoint) and leave a sealed anomaly_rollback flight
     dump that verifies; the pin this process writes once the log shows
     step 2 (a 1 s window, polled once --profile_dir's window has closed)
     must be acked started, then stopped, and its Chrome trace name
     fwd_tc_kernel, rows_tc_kernel or kv_tc_kernel, norm_shift_kernel and
     sgu_mix_tc_kernel; events.jsonl must hold one clock_beacon a step;
     its exposition's goodput buckets must sum
     to its wall clock within 0.5%, carry goodput_pct, mfu,
     hbm_in_use_gb and anomaly_rollbacks_total > 0, and its mfu lie in
     (0, 1] within 1% of tokens_per_sec_per_chip x flops_per_token /
     989e12; its trace must name fwd_tc_kernel and the train/step span;
     its final checkpoint must restore, its cursor and step the
     rollback's plus the steps after it. Then, in this process at that
     depth:
     hbm_gauges() non-empty; a blocking save of a train state, an
     asynchronous save of it, one train step (launches counted), the
     asynchronous save finalized: its files must hash as the blocking
     save's. It prints the CLI's step time, tokens/s and MFU beside
     phase 5's and phase 8's, the goodput split, the seconds each save
     costs the loop, the profile window's seconds and the phase's;
 13. fleet, the serving fleet's data plane at base.toml's widths in
     bfloat16, depth cut to 6 since slice 10 (FLEET_DEPTH), in
     build/chip_smoke_fleet/ (removed afterwards): two
     params-only checkpoints, A (seeded weights) and B (A plus seeded
     noise, saved once the replicas chose A); two cli.serve children at
     one slot, r0 on --socket and r1 on --tcp 127.0.0.1:0 with
     PROGEN_FLEET_TOKEN and PROGEN_CHAOS=serve/decode:kill@136; one
     cli.router over both (--replica sock=... and tcp=..., journal and
     prom each) takes 8 lines on stdin, then EOF: 6 generates of 96 new
     tokens (g0 and its twin g0tcp, which the router's alternation puts
     on the two wires), an infill, an embedding. It must exit 0 with
     each id settled once and nothing rejected, r1 dead by its kill, a
     resumed handoff in its route records, g0 dispatched to r0 alone and
     g0tcp to r1 alone, every stream (both lives of the cut ones)
     contiguous from its first generated position and equal to
     sample_fast on A, g0 equal to g0tcp, and the embedding within 1e-6
     of engine.embed here (a check: its launches are not the path's).
     The path's launches are the replica's that answered the embed, in
     its own process: its exposition's progen_serve_kernel_launches_*
     gauges, read once it exited, must show one forward's (A1 24, L1 48,
     L2 2). Then r0 is SIGHUPed while it streams
     two requests on its socket: "reload: now serving" B, no rejection,
     each id done once, and the two sent after the commit equal
     sample_fast on B from their first generated position. Meanwhile cli.router --spawn 2 --respawn
     --replica_reload_watch 1 boots on B; replica0 is SIGKILLed and must
     come back with "replay: resumed", replica1's reload.pin to A must be
     acked committed, and 2 requests settle. Last, WeightReloader here on
     a 4-slot engine, from B to A by name while it decodes: it prints the
     pool's step interval while the load stages against without, the
     peak bytes the staging adds, the reload's seconds, and fails unless
     every live parameter kept its address and holds A's values;
 14. fleet_observability, the telemetry back end, the flight recorder,
     on-demand profiling and the autoscaler at base.toml whole in
     bfloat16, in build/chip_smoke_observability/ (removed afterwards):
     cli.router --spawn 1 --autoscale (a phase-local policy: 1..2
     replicas, queue_high 3, queue_low 1, sustain 2 ticks of 1 s, down
     cooldown 5 s) --autoscale_tsdb --replica_profile_watch --flight_dir,
     its replicas at one slot; cli.collector --interval 1 over the
     router's and both replicas' expositions with an SLO file (TTFT p95
     0.5 s), replica 0's profile pin, --flight-dir, --alerts-out and
     --remote-write to a loopback HTTP receiver in this process. One
     burst of 10 generates of 64 new tokens (distinct seeds) with 2
     embeds after the third goes through the router: the queue must
     cross 3 and the autoscaler record an up decision, replica 1 boot
     with --replay and take work; the TTFT objective must burn, the
     collector leave a sealed slo_burning dump and write replica 0's pin,
     and replica 0 run the embeds inside the torch.profiler window that
     opens (its Chrome trace must name fwd_tc_kernel, norm_shift_kernel
     and sgu_mix_tc_kernel); every stream must equal sample_fast and each
     id settle once. In the quiet after it a down decision must retire
     replica 1, which exits 0 on SIGTERM. Then the offline tools on the
     phase's files: cli.telemetry stitch of the three events.jsonl (three
     pids), export-trace of the collector's dump, slo-report (exit 2) and
     query over the TSDB; cli.top --once at the peak shows both replicas
     up; the receiver got a batch; read_scale_records reads up, then
     down. The replicas' launches come from their expositions (the two
     embed forwards). It prints the seconds from the queue's crossing to
     the up decision, from the spawn to replica 1's first token and from
     the down decision to its exit, the collector's tick ms and TSDB
     bytes, the window's seconds, trace bytes and export seconds, each
     flight dump's bytes, and, in this process on a 4-slot engine of the
     same weights, the pool's step time with the recorder armed against
     without it and a full ring's dump ms;
 15. deploy, continuous deployment at base.toml whole in bfloat16, in
     build/chip_smoke_deploy/ (removed afterwards): three params-only
     checkpoints, A (random from seed 0), B (A plus a seeded relative
     noise of 1e-3) and C (A with its to-logits weight x4), B and C staged
     and published later by a rename; two cli.serve --reload_pin
     replicas at one slot (unix sockets) behind cli.router (--prom_file);
     cli.deploy (policy: interval 0.5 s, max_ppl_regression_pct 1.0,
     batch 8) with --probe_fasta (16 proteins of phase 8's synthetic
     FASTA at seed + 1) and --alerts, started under
     PROGEN_CHAOS=deploy/promote:kill@1 before any candidate: it adopts A.
     Wave 1 (2 generates of 32 new tokens), then B is published and wave
     2 sent; the controller canaries B on replica0, probes A and B, and
     dies entering its first promote (rc -9). A restart replays the
     ledger, leaves the canary's pin as it is, promotes replica1 and
     converges on B: both replicas' progen_serve_checkpoint_digest and
     the router's replica{i}_checkpoint_digest must equal digest_gauge of
     B's checkpoint_digest. Wave 3, then C is published: canaried,
     probed and rolled back on ppl_regression, with one deploy_rollback
     alert, never retried, every digest gauge back on B. It fails unless
     the ledger holds exactly that sequence of decisions, each request
     settles once, waves 1 and 3 equal sample_fast on A and on B, each
     ledger probe equals probe_stats over its shards and its ppl's log
     lies within 1e-2 nats of the same sequences' token-weighted NLL
     under a float32 model on the plain path, and the restarted
     controller's closing line reports C's probe's launches (two
     forwards: A1 48, L1 96, L2 4). It prints the saves' seconds, each
     replica's boot, each pin's seconds to its committed ack, each
     probe's seconds and sequences/s, observed -> converged and observed
     -> rollback, and the restart's seconds to its replay and its first
     action.

Phase 2 also holds A4 (forward and both backwards, with a halo) against
its plain versions at long8k's shard shapes with 2 shards, and runs the
shard identity: the 8192-token sequence cut in two, each shard with its
halo sliced from the other, through A4 equals A1 and A2/A3 on the whole
sequence (output and dq bit for bit; dk and dv to A2's tolerance once
shard 1's halo gradient is added to shard 0's last window).

Plain-path comparisons run with TF32 off for matrix products and
convolutions (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 are set False). Any failure exits
non-zero. The line before the last holds the card's name and power limit,
the one before it the kernel table as JSON; the last line is the result.
The full results (every kernel row, the main path's checks, profiles of
one forward and one train step by kernel group, the seqpar phase, the
nvcc logs and the tensor-core kernels' ptxas and SASS counts) go to ``--details`` as JSON, by default build/chip_smoke.json.
"""

import argparse
import contextlib
import copy
import dataclasses
import itertools
import json
import os
import re
import select
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
BATCH = 8
GEN_LENGTH = 256
TRAIN_ACCUM, TRAIN_MICRO, TRAIN_STEPS = 4, 4, 3
# per parameter tensor, the cosine between the kernel path's gradient and
# the float32 plain model's
GRAD_COS = 0.99
# per parameter tensor, A3's gradient against A2's on the same weights and
# batch: relative distance and cosine. The two backwards differ only in
# the order of dk's and dv's float32 sums before one bfloat16 rounding,
# but the flipped roundings compound through 24 layers of input gradient
# into the embedding's (0.006 on an H100), a tenth of the plain bfloat16
# path's own distance from float32
HALO_REL, HALO_COS = 2e-2, 0.9999
# largest logit gap allowed between the kernel and plain bfloat16 paths of
# the base model (measured 0.136 on an H100: the two round differently)
LOGIT_ATOL = 0.3
# seqpar: grid data 1 x seq 2 on one card, a (2, 2, 8193) batch, 3 steps
SEQ_SHARDS, SEQPAR_ACCUM, SEQPAR_MICRO, SEQPAR_STEPS = 2, 2, 2, 3
SEQPAR_TIMEOUT = 600  # seconds: gloo's collectives and the ranks' join
# seqpar against the single process, by the rule of HALO_REL: the
# sharding may move a result by no more than a tenth of the distance that
# bfloat16 rounding puts between the single process and a float32 model
# taking the same 3 steps from the same state, measured in the same run.
# Three quantities: every step's loss (relative), the first step's
# gradients and the parameters' change over the 3 steps (largest relative
# distance over the tensors). The rule is held in float32, where the
# sharding is the only difference (ranks in float32 against the float32
# single process); in bfloat16 each rank rounds its partial sums (a
# weight's gradient over its half of the tokens) where one process rounds
# the whole sum once, so there the sharded step may be no further from
# the single process than bfloat16 rounding is from float32 (a share of
# 1), and the first step's gradients keep a cosine of at least
# SEQPAR_COS in every tensor
SEQPAR_SHARE_F32, SEQPAR_SHARE_BF16, SEQPAR_COS = 0.1, 1.0, 0.9999
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
L1_COPIES = 4  # inputs L1's timing rotates over (16 MB each at base)
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}  # dense tensor-core / float32 FMA rates

PROTEINS = [
    "MQIFVKTLTGKTITLEVEPSDTIENVKAKIQDKEGIPPDQQRLIFAGKQLEDGRTLSDYNIQKESTLHLVLRLRGG",
    "MSKGEELFTGVVPILVELDGDVNGHKFSVSGEGEGDATYGKLTLKFICTTGKLPVPWPTLVTTFSYGVQCFSRYPDHMKQHDFFKSAMPEGYVQERTIFFKDDGNYKTRAEVKFEGDTLVNRIELKGIDFKEDGNILGHKLEYNYNSHNVYIMADKQKNGIKVNFKIRHNIEDGSVQLADHYQQNTPIGDGPVLLPDNHYLSTQSALSKDPNEKRDHMVLLEFVTAAGITHGMDELYK",
    "MALWMRLLPLLALLALWGPDPAAAFVNQHLCGSHLVEALYLVCGERGFFYTPKTRREAEDLQVGQVELGGGPGAGSLQPLALEGSLQKRGIVEQCCTSICSLYQLENYCN",
    "MVLSPADKTNVKAAWGKVGAHAGEYGAEALERMFLSFPTTKTYFPHFDLSHGSAQVKGHGKKVADALTNAVAHVDDMPNALSALSDLHAHKLRVDPVNFKLLSHCLLVTLAAHLPAEFTPAVHASLDKFLASVSTVLTSKYR",
    "KVFGRCELAAAMKRHGLDNYRGYSLGNWVCAAKFESNFNTQATNRNTDGSTDYGILQINSRWWCNDGRTPGSRNLCNIPCSALLSSDITASVNCAKKIVSDGNGMNAWVAWRNRCKGTDVQAWIRGCRL",
    "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQAPILSRVGDGTQDNLSGAEKAVQVKVKALPDAQFEVVHSLAKWKRQTLGQHDFSAGEGLYTHMKALRPDEDRLSPLHSVYVDQWDWERVMGDGERQFSTLKSTVEAIWAGIKATEAAVSEEFGLAPFLPDQIHFVHSQELLSRYPDLDAKGRERAIAKDLGAVFLVGIGGKLSDGHRHDVRAPDYDDW",
    "MDSKGSSQKGSRLLLLLVVSNLLLCQGVVSTPVCPNGPGNCQVSLRDLFDRAVMVSHYIHDLSSEMFNEFDKRYAQGKGFITMALNSCHTSSLPTPEDKEQAQQTHHEVLMSLILGLLRSWNDPLYHLVTEVRGMKGAPDAILSRAIEIEEENKRLLEGMEMIFGQVIPGAKETEPYPVWSGLPSLQTKDEDARYSAFYNLLHCLRRDSSKIDTYLKLLNCRIIYNNNC",
    "GIVEQCCTSICSLYQLENYCN",
]
PRIMES = ["MKTA", "MSKG", "MALW", "MVLS"]  # one length: one batch


def line(tag: str, **fields) -> None:
    print(f"{tag}: " + json.dumps(fields, default=float), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
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


def device_ms(fn, iters: int = 20):
    """Mean device time of one ``fn()``: the CUDA time of every kernel
    that ``iters`` calls launch, summed by torch.profiler, over
    ``iters``; None when the profiler saw no device time in three tries
    (now and then one records none). Unlike ``time_ms`` it leaves out the
    host's time between launches, which is all of a short kernel's time
    when the host launches slower than the card runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / iters
    return None


def kernel_times(fn) -> dict:
    """A kernel's time both ways: ``ms`` by CUDA events around 20
    back-to-back calls, ``device_ms`` by the profiler over 20 calls."""
    return dict(ms=time_ms(fn), device_ms=device_ms(fn))


def check_close(name, got, want, atol, rtol) -> dict:
    """Hold ``got`` against ``want``: every element within atol + rtol *
    |want|. ``max_rel_err`` is taken where the relative term dominates
    (|want| >= atol / rtol); ``worst_over_tolerance`` <= 1 passes."""
    want = want.float()
    diff = (got.float() - want).abs()
    bound = atol + rtol * want.abs()
    big = want.abs() >= atol / rtol
    out = {"max_abs_err": diff.max().item(),
           "max_rel_err": (diff[big] / want.abs()[big]).max().item()
           if bool(big.any()) else 0.0,
           "atol": atol, "rtol": rtol,
           "worst_over_tolerance": (diff / bound).max().item()}
    if not bool(torch.isfinite(got).all()) or not bool((diff <= bound).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: {out}")
    return out


def plain_attention(q, k, v, window_size, scale=None, bwd_impl="kv"):
    """The attention forward's plain version; autograd differentiates it,
    so its backward is plain too."""
    from progen_tpu_torch.ops import cuda_attention

    return cuda_attention.local_attention_fwd_reference(q, k, v,
                                                        window_size, scale)


@contextlib.contextmanager
def plain_path():
    """The model with each kernel's plain version in its place, forward
    and backward, on the card: the yardstick the kernel path is held
    against. The package has no such switch (a CUDA tensor always takes
    the kernel); this script swaps the plain versions in where the
    model's blocks call them."""
    from progen_tpu_torch.models import layers
    from progen_tpu_torch.ops import cuda_layers

    with mock.patch.multiple(
        layers,
        local_attention=plain_attention,
        norm_shift=cuda_layers.norm_shift_reference,
        sgu_mix_gate=cuda_layers.sgu_mix_gate_reference,
    ):
        yield


def bound_ms(nbytes: float, ops: float, dtype) -> dict:
    """The least time of a kernel's work (its bytes moved once over the
    memory rate, or its operations over the peak rate of their type,
    whichever is longer), which of the two sets it, and the operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                ops=ops)


def visible_pairs(n: int, w: int, halo: bool = False) -> int:
    """(query, key) pairs of one head's local attention that a query
    sees: its own window up to itself, and the whole previous window.
    Window 0's phantom zero keys are left out: they add nothing to any
    product. With a halo (A4), window 0's previous window is real."""
    return sum((w if r >= w or halo else 0) + (r % w) + 1 for r in range(n))


def window_mask(n: int, w: int, dev) -> torch.Tensor:
    """(n, w + n) boolean mask of the local attention over keys [w
    previous | n own]: query i sees key j (j from -w) when j <= i and j
    lies in i's window or the one before."""
    i = torch.arange(n, device=dev)[:, None]
    j = torch.arange(n + w, device=dev)[None, :]  # j + w
    return (j - w <= i) & (i // w - j // w <= 0)


def phase_build():
    from progen_tpu_torch.ops import _build

    t = time.perf_counter()
    libs = _build.build_all()
    seconds = time.perf_counter() - t
    for name in libs:
        _build.load(name)
    line("build", seconds=seconds, kernels=sorted(libs))
    logs = {name: _build.build_log(name) for name in libs}
    tc = tensor_core_kernels(logs, libs)
    line("tensor-core kernels", **{
        k: v for k, v in tc.items()
        if "bfloat16, 64" in k or "bfloat16, 128" in k or "sgu_" in k})
    bad = [k for k, v in tc.items()
           if v["mma_instructions"] + v["wgmma_instructions"] == 0
           or ((", 64" in k or "sgu_" in k) and v["spill_bytes"] != 0)]
    bad += [f"{kern}<{dt}, 64> not found in the ptxas logs"
            for kern in ("fwd", "rows", "kv", "halo")
            for dt in ("bfloat16", "float16")
            if not any(f"{kern}_tc_kernel<{dt}, 64" in k for k in tc)]
    if not any("sgu_mix_tc_kernel<bfloat16>" in k for k in tc):
        bad.append("sgu_mix_tc_kernel<bfloat16> not found in the ptxas logs")
    if bad:
        raise AssertionError(f"tensor-core kernels missing, without mma "
                             f"or with spills: {bad}")
    return dict(logs=logs, seconds=seconds, tensor_core_kernels=tc)


def tensor_core_kernels(logs: dict, libs: dict) -> dict:
    """For each tensor-core kernel (``*_tc_kernel``: the attention's
    forward and backward passes, keyed "library: kernel<dtype, d,
    halo>", and the SGU tail's mix, "library: sgu_mix_tc_kernel<dtype>"):
    what ptxas reported (registers, spilled bytes, stack frame) and the
    count of tensor-core instructions (HMMA, or HGMMA for wgmma) in its
    machine code, read by cuobjdump -sass from the built library."""
    import re
    import shutil

    def short(entry):
        if "sgu_mix_tc_kernel" in entry:
            dtype = "bfloat16" if "bfloat16" in entry else "float16"
            return f"sgu_mix_tc_kernel<{dtype}>"
        m = re.search(r"((?:fwd|rows|kv|halo)_tc_kernel)I"
                      r"(?:6__half|13__nv_bfloat16)Li(\d+)E(?:Lb([01])E)?",
                      entry)
        dtype = "bfloat16" if "bfloat16" in entry else "float16"
        halo = ", halo" if m.group(3) == "1" else ""
        return f"{m.group(1)}<{dtype}, {m.group(2)}{halo}>"

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name, log in logs.items():
        found, entry = {}, None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                entry = m.group(1) if "_tc_kernel" in m.group(1) else None
                if entry:
                    found[entry] = dict(mma_instructions=0,
                                        wgmma_instructions=0)
            elif entry and "spill stores" in ln:
                st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                    ln)
                found[entry]["spill_bytes"] = int(st) + int(ld)
                found[entry]["stack_frame_bytes"] = int(
                    re.search(r"(\d+) bytes stack frame", ln).group(1))
            elif entry and "registers" in ln:
                found[entry]["registers"] = int(
                    re.search(r"Used (\d+) registers", ln).group(1))
        if not found:
            continue
        sass = subprocess.run([tool, "-sass", str(libs[name])],
                              capture_output=True, text=True,
                              check=True).stdout
        fn = None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                fn = m.group(1) if m.group(1) in found else None
            elif fn and "HGMMA" in ln:
                found[fn]["wgmma_instructions"] += 1
            elif fn and "HMMA" in ln:
                found[fn]["mma_instructions"] += 1
        out.update({f"{name}: {short(e)}": v for e, v in found.items()})
    return out


def phase_kernels(cfg, cfg8k, card: str) -> list:
    """Each kernel against its plain version at the base shapes. Each
    line gives the launches one forward must make (``per_forward``); the
    counts the main path made are in the ``kernels`` table."""
    import torch.nn.functional as F

    from progen_tpu_torch.ops import cuda_attention, cuda_layers

    dev, dt = torch.device("cuda"), cfg.compute_dtype
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=dt):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows = []
    b, h, n, d, w = BATCH, cfg.heads, cfg.seq_len, cfg.dim_head, \
        cfg.window_size
    esize = torch.finfo(dt).bits // 8

    # A1: local attention forward
    q, k, v = randn(b, h, n, d), randn(b, h, n, d), randn(b, h, n, d)
    fn = cuda_attention.local_attention_fwd
    ref = cuda_attention.local_attention_fwd_reference
    got = fn(q, k, v, w)
    want = ref(q, k, v, w)
    plain_ms = time_ms(lambda: ref(q, k, v, w), iters=3)
    err = check_close("A1", got, want, 1e-2, 1e-2)
    # one PyTorch call computing the same function: SDPA over keys padded
    # with w zero keys that only window-0 queries see
    zeros = torch.zeros(b, h, w, d, dtype=dt, device=dev)
    kp, vp = torch.cat([zeros, k], 2), torch.cat([zeros, v], 2)
    i = torch.arange(n, device=dev)[:, None]
    j = torch.arange(n + w, device=dev)[None, :] - w
    mask = torch.where(j < 0, i < w,
                       (j <= i) & (i // w - j.clamp_min(0) // w <= 1))
    lib = F.scaled_dot_product_attention(q, kp, vp, attn_mask=mask)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, kp, vp, attn_mask=mask), iters=5)
    bnd = bound_ms(4 * b * h * n * d * esize,
                   2 * 2 * d * visible_pairs(n, w) * b * h, dt)
    rows.append(dict(
        name="local_attention_fwd", id="A1", route="cuda",
        source="progen_tpu_torch/csrc/local_attention_fwd.cu",
        replaces="progen_tpu/ops/pallas_attention.py:552",
        **kernel_times(lambda: fn(q, k, v, w)), plain_ms=plain_ms,
        library_ms=lib_ms, **bnd,
        library_max_abs_err=(lib.float() - want.float()).abs().max().item(),
        shape=[b, h, n, d], window=w, **err,
    ))
    del q, k, v, kp, vp, lib, got, want

    # L1: norm + shift over the residual stream. Its timed calls rotate
    # over L1_COPIES inputs, so that each call finds its input out of the
    # 50 MB L2 cache (the other copies' calls move 3 x 32 MB between two
    # uses of one), as a layer's input is in the model
    xs = [randn(b, n, cfg.dim) * 2 + 0.5 for _ in range(L1_COPIES)]
    x = xs[0]
    scale = torch.rand(cfg.dim, generator=gen, device=dev) + 0.5
    eps = cfg.layer_norm_epsilon
    fn = cuda_layers.norm_shift
    ref = cuda_layers.norm_shift_reference
    got = fn(x, scale, eps, dt)
    want = ref(x, scale, eps, dt)
    plain_ms = time_ms(lambda: ref(x, scale, eps, dt))
    err = check_close("L1", got, want, 1e-2, 1e-2)
    bnd = bound_ms(2 * x.numel() * esize + 4 * cfg.dim, 7 * x.numel(), dt)
    turn = itertools.count()
    rows.append(dict(
        name="norm_shift", id="L1", route="cuda",
        source="progen_tpu_torch/csrc/norm_shift.cu",
        replaces="progen_tpu/ops/pallas_layers.py:193",
        **kernel_times(lambda: fn(xs[next(turn) % L1_COPIES], scale, eps,
                                  dt)),
        plain_ms=plain_ms, library_ms=None, **bnd, shape=list(x.shape),
        inputs_rotated=L1_COPIES, **err,
    ))
    del x, xs, got, want

    # L2: SGU tail, weights at ~1/sqrt(n) so an error in the mix shows
    half = cfg.dim * cfg.ff_mult // 2
    x, gate = randn(b, n, half), randn(b, n, half)
    wts = randn(n, n, dtype=torch.float32) / n ** 0.5
    bias = randn(n, 1, dtype=torch.float32)
    scale = torch.rand(half, generator=gen, device=dev) + 0.5
    fn = cuda_layers.sgu_mix_gate
    ref = cuda_layers.sgu_mix_gate_reference
    got = fn(x, gate, wts, bias, scale, eps, dt)
    want = ref(x, gate, wts, bias, scale, eps, dt)
    plain_ms = time_ms(lambda: ref(x, gate, wts, bias, scale, eps, dt),
                       iters=3)
    err = check_close("L2", got, want, 2e-2, 2e-2)
    # the bound of the card's route for this dtype: in bfloat16 the mix's
    # products run on the tensor cores (W split in two bfloat16 parts is
    # the kernel's cost, not the function's), in float16 and float32 on the
    # FMA units at the float32 rate
    nbytes = 3 * x.numel() * esize + 4 * (n * n + n + half)
    bnd = bound_ms(nbytes, 2 * b * half * n * (n + 1) // 2,
                   dt if dt == torch.bfloat16 else torch.float32)
    rows.append(dict(
        name="sgu_mix_gate", id="L2", route="cuda",
        source="progen_tpu_torch/csrc/sgu_mix_gate.cu",
        replaces="progen_tpu/ops/pallas_layers.py:258",
        **kernel_times(lambda: fn(x, gate, wts, bias, scale, eps, dt)),
        plain_ms=plain_ms, library_ms=None, **bnd, shape=list(x.shape),
        **err,
    ))
    del x, gate, got, want

    rows += backward_rows(cfg, gen)
    rows += halo_rows(cfg8k, gen)
    fwd, step = per_forward(cfg), per_step(cfg)
    sp = seqpar_per_step(cfg8k)
    for r in rows:
        # the bound's operations over the kernel's device time, and the
        # bound's share of that time (of ms where the profiler saw none)
        t = r["device_ms"] or r["ms"]
        r["tflops"] = r["ops"] / (t * 1e-3) / 1e12
        r["share_of_bound"] = r["bound_ms"] / t
        line(f"kernel {r['id']}", **{k: r[k] for k in (
            "name", "shape", "max_abs_err", "max_rel_err", "atol", "rtol",
            "worst_over_tolerance", "ms", "device_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "tflops",
            "share_of_bound")},
            launches_per_forward=fwd[r["id"]],
            launches_per_step=step[r["id"]],
            seqpar_launches_per_step_and_rank=sp[r["id"]], card=card)
    line("kernels", status={r["id"]: "ok" for r in rows})
    return rows


def backward_rows(cfg, gen) -> list:
    """A2 and A3 (with its combine) against their plain backwards at the
    base training shapes: micro-batch 4, bh = 64, n 1024, w 512, d 64."""
    import torch.nn.functional as F

    from progen_tpu_torch.ops import cuda_attention

    dev, dt = gen.device, cfg.compute_dtype
    b, h, n, d, w = TRAIN_MICRO, cfg.heads, cfg.seq_len, cfg.dim_head, \
        cfg.window_size
    bh, esize = b * h, torch.finfo(dt).bits // 8
    q, k, v, do = (torch.randn((b, h, n, d), generator=gen,
                               device=dev).to(dt) for _ in range(4))
    # one PyTorch call computing the same function: the backward of
    # scaled_dot_product_attention over keys padded with the w phantom
    # zero keys, which only window-0 queries see (as A1's row builds it),
    # taken as autograd.grad of the retained forward graph
    zeros = torch.zeros(b, h, w, d, dtype=dt, device=dev)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    kp = torch.cat([zeros, leaves[1]], 2)
    vp = torch.cat([zeros, leaves[2]], 2)
    i = torch.arange(n, device=dev)[:, None]
    j = torch.arange(n + w, device=dev)[None, :] - w
    mask = torch.where(j < 0, i < w,
                       (j <= i) & (i // w - j.clamp_min(0) // w <= 1))
    out = F.scaled_dot_product_attention(leaves[0], kp, vp, attn_mask=mask)
    lib_ms = time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                 retain_graph=True))
    del out, kp, vp, leaves
    # the function's least work, one bound for A2 and A3 alike: q, k, v
    # and dO read once, dq, dk and dv written once; five products (S, dP,
    # dV, dQ, dK) of 2·d operations over the (query, key) pairs a query
    # sees. A2's recompute of the next window's rows and A3's float32
    # scratch are the kernels' own cost, not the function's.
    bnd = bound_ms(7 * bh * n * d * esize,
                   5 * 2 * d * visible_pairs(n, w) * bh, dt)
    rows = []
    for rid, impl in (("A2", "kv"), ("A3", "halo")):
        fn = getattr(cuda_attention, f"local_attention_bwd_{impl}")
        ref = getattr(cuda_attention, f"local_attention_bwd_{impl}_reference")
        got = fn(q, k, v, do, w)
        want = ref(q, k, v, do, w)
        errs = [check_close(f"{rid} {g}", a, c, 1e-2, 1e-2)
                for g, a, c in zip(("dq", "dk", "dv"), got, want)]
        err = max(errs, key=lambda e: e["worst_over_tolerance"])
        plain_ms = time_ms(lambda: ref(q, k, v, do, w), iters=3)
        rows.append(dict(
            name=f"local_attention_bwd_{impl}", id=rid, route="cuda",
            source=f"progen_tpu_torch/csrc/local_attention_bwd_{impl}.cu",
            replaces="progen_tpu/ops/pallas_attention.py:"
                     + ("652" if impl == "kv" else "683"),
            **kernel_times(lambda: fn(q, k, v, do, w)), plain_ms=plain_ms,
            library_ms=lib_ms, **bnd, shape=[b, h, n, d], window=w,
            errors=dict(zip(("dq", "dk", "dv"), errs)), **err,
        ))
        del got, want
    return rows


def halo_rows(cfg, gen) -> list:
    """A4, the attention with a halo, against its plain versions at
    long8k's shard shapes with 2 shards: q, k, v, dO (2, 8, 4096, 64) and
    halo_k, halo_v (2, 8, 512, 64) in bfloat16, from a seed; then the
    shard identity on the whole 8192-token sequence."""
    import torch.nn.functional as F

    from progen_tpu_torch.ops import cuda_attention as ca

    dev, dt = gen.device, cfg.compute_dtype
    b, h, d, w = SEQPAR_MICRO, cfg.heads, cfg.dim_head, cfg.window_size
    n = cfg.seq_len // SEQ_SHARDS
    bh, esize = b * h, torch.finfo(dt).bits // 8

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    q, k, v, do = (randn(b, h, n, d) for _ in range(4))
    hk, hv = randn(b, h, w, d), randn(b, h, w, d)
    # one PyTorch call computing the same function: SDPA over the keys
    # [halo | shard] with the window mask, forward and (autograd.grad of
    # the retained graph) backward
    mask = window_mask(n, w, dev)
    kp, vp = torch.cat([hk, k], 2), torch.cat([hv, v], 2)
    lib_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, kp, vp, attn_mask=mask), iters=5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = F.scaled_dot_product_attention(
        leaves[0], torch.cat([hk, leaves[1]], 2),
        torch.cat([hv, leaves[2]], 2), attn_mask=mask)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                     retain_graph=True))
    del out, leaves, kp, vp
    # the least work: inputs (and the halo) read once, outputs written
    # once; the forward's two products over every visible pair, the
    # backward's S, dP and dQ over every visible pair and dK, dV over
    # the shard's own keys (the halo's gradient is halo_grads', outside)
    pairs = visible_pairs(n, w, halo=True) * bh
    own = pairs - w * w * bh
    halo_bytes = 2 * bh * w * d * esize
    fwd_bnd = bound_ms(4 * bh * n * d * esize + halo_bytes,
                       2 * 2 * d * pairs, dt)
    bwd_bnd = bound_ms(7 * bh * n * d * esize + halo_bytes,
                       2 * d * (3 * pairs + 2 * own), dt)
    common = dict(route="cuda",
                  replaces="progen_tpu/ops/pallas_attention.py:731",
                  shape=[b, h, n, d], halo=[b, h, w, d], window=w)

    got = ca.local_attention_halo_fwd(q, k, v, hk, hv, w)
    want = ca.local_attention_halo_fwd_reference(q, k, v, hk, hv, w)
    err = check_close("A4 forward", got, want, 1e-2, 1e-2)
    rows = [dict(
        name="local_attention_halo_fwd", id="A4-fwd",
        source="progen_tpu_torch/csrc/local_attention_fwd.cu",
        **kernel_times(
            lambda: ca.local_attention_halo_fwd(q, k, v, hk, hv, w)),
        plain_ms=time_ms(lambda: ca.local_attention_halo_fwd_reference(
            q, k, v, hk, hv, w), iters=3),
        library_ms=lib_fwd_ms, **fwd_bnd,
        **common, **err)]
    del got, want
    for rid, impl in (("A4-kv", "kv"), ("A4-halo", "halo")):
        fn = getattr(ca, f"local_attention_halo_bwd_{impl}")
        ref = getattr(ca, f"local_attention_halo_bwd_{impl}_reference")
        got = fn(q, k, v, hk, hv, do, w)
        want = ref(q, k, v, hk, hv, do, w)
        errs = [check_close(f"{rid} {g}", a, c, 1e-2, 1e-2)
                for g, a, c in zip(("dq", "dk", "dv"), got, want)]
        rows.append(dict(
            name=f"local_attention_halo_bwd_{impl}", id=rid,
            source=f"progen_tpu_torch/csrc/local_attention_bwd_{impl}.cu",
            **kernel_times(lambda: fn(q, k, v, hk, hv, do, w)),
            plain_ms=time_ms(lambda: ref(q, k, v, hk, hv, do, w), iters=3),
            library_ms=lib_bwd_ms, **bwd_bnd,
            errors=dict(zip(("dq", "dk", "dv"), errs)),
            **common, **max(errs, key=lambda e: e["worst_over_tolerance"])))
        del got, want
    ident = shard_identity(cfg, gen)
    rows[0]["shard_identity"] = ident
    line("shard identity", **ident)
    return rows


def shard_identity(cfg, gen) -> dict:
    """The 8192-token sequence (2, 8, 8192, 64) cut in two shards, shard
    0 with a zero halo (the reference's phantom keys) and shard 1 with
    shard 0's last window, through A4, against A1 and A2/A3 on the whole
    sequence: the output and dq must be bit-equal (one kernel over the
    same keys in the same order, and zero keys of score 0 leave the
    online softmax exactly where the phantom start puts it); dk and dv,
    with shard 1's halo gradient (halo_grads) added to shard 0's last
    window, within A2's tolerance (two bfloat16 roundings there, where
    the whole sequence has one)."""
    from progen_tpu_torch.ops import cuda_attention as ca

    dev, dt = gen.device, cfg.compute_dtype
    b, h, n, d, w = SEQPAR_MICRO, cfg.heads, cfg.seq_len, cfg.dim_head, \
        cfg.window_size
    q, k, v, do = (torch.randn((b, h, n, d), generator=gen,
                               device=dev).to(dt) for _ in range(4))
    m = n // 2
    zeros = torch.zeros(b, h, w, d, dtype=dt, device=dev)
    halos = [(zeros, zeros), (k[:, :, m - w:m], v[:, :, m - w:m])]
    shards = [slice(0, m), slice(m, n)]
    whole = ca.local_attention_fwd(q, k, v, w)
    sharded = torch.cat([ca.local_attention_halo_fwd(
        q[:, :, s], k[:, :, s], v[:, :, s], *hl, w)
        for s, hl in zip(shards, halos)], 2)
    out = dict(shape=[b, h, n, d], shards=2,
               forward_max_abs_diff=(sharded.float() - whole.float())
               .abs().max().item(),
               forward_bit_equal=bool(torch.equal(sharded, whole)))
    del sharded, whole
    for impl in ("kv", "halo"):
        gwhole = getattr(ca, f"local_attention_bwd_{impl}")(q, k, v, do, w)
        bwd = getattr(ca, f"local_attention_halo_bwd_{impl}")
        parts = [list(bwd(q[:, :, s], k[:, :, s], v[:, :, s], *hl,
                          do[:, :, s], w))
                 for s, hl in zip(shards, halos)]
        dhk, dhv = ca.halo_grads(q[:, :, m:], k[:, :, m:], v[:, :, m:],
                                 *halos[1], do[:, :, m:], w)
        parts[0][1][:, :, -w:] += dhk
        parts[0][2][:, :, -w:] += dhv
        for g, a, c in zip(("dq", "dk", "dv"), zip(*parts), gwhole):
            a = torch.cat(a, 2)
            out[f"{impl}_{g}_max_abs_diff"] = (a.float() - c.float()).abs() \
                .max().item()
            out[f"{impl}_{g}_bit_equal"] = bool(torch.equal(a, c))
            check_close(f"shard identity {impl} {g}", a, c, 1e-2, 1e-2)
        del gwhole, parts
    if not (out["forward_bit_equal"] and out["kv_dq_bit_equal"]
            and out["halo_dq_bit_equal"]):
        raise AssertionError(f"shard identity: output or dq not bit-equal "
                             f"to the whole sequence's: {out}")
    return out


def collate(strings, seq_len: int) -> torch.Tensor:
    """Byte-tokenise and pad to (batch, seq_len + 1) with a BOS column."""
    from progen_tpu_torch.data.tokenizer import encode_tokens

    out = torch.zeros(len(strings), seq_len + 1, dtype=torch.long)
    for i, s in enumerate(strings):
        toks = torch.from_numpy(encode_tokens(s)[:seq_len]).long()
        out[i, 1:1 + len(toks)] = toks
    return out


def launch_counts() -> dict:
    from progen_tpu_torch.ops import launches

    return launches.launch_counts()


def reset_counts() -> None:
    from progen_tpu_torch.ops import launches

    launches.reset_counts()


def per_forward(cfg) -> dict:
    """Launches of one forward on the whole sequence."""
    return {"A1": cfg.depth, "A2": 0, "A3": 0, "A4-fwd": 0, "A4-kv": 0,
            "A4-halo": 0, "L1": 2 * cfg.depth, "L2": cfg.global_mlp_depth}


def per_step(cfg, impl: str = "kv", accum: int = TRAIN_ACCUM) -> dict:
    """Launches of one train step: with remat each forward kernel runs in
    the forward and again in the recompute, once a micro-batch; the
    attention backward once a layer and micro-batch."""
    fwd = {k: v * accum * (2 if cfg.remat else 1)
           for k, v in per_forward(cfg).items()}
    bwd = cfg.depth * accum
    return {**fwd, "A2": bwd if impl == "kv" else 0,
            "A3": bwd if impl == "halo" else 0}


def seqpar_per_step(cfg) -> dict:
    """Launches of one seqpar step on each rank: every attention is A4
    (the halo kernels; rank 0's halo is zeros), A4's kv backward once a
    layer and micro-batch, the forward kernels twice with remat."""
    fwd = SEQPAR_ACCUM * (2 if cfg.remat else 1)
    return {"A1": 0, "A2": 0, "A3": 0, "A4-fwd": cfg.depth * fwd,
            "A4-kv": cfg.depth * SEQPAR_ACCUM, "A4-halo": 0,
            "L1": 2 * cfg.depth * fwd, "L2": cfg.global_mlp_depth * fwd}


def drive_main_path(cfg, model, batch, primes) -> dict:
    """The main path as a user drives it, with every launch count set to
    0 just before and read just after: score_step on the scoring batch
    (one full forward through the kernels), then sample_fast_batched
    answering the generation requests (the KV-cache decoder, which runs no
    kernel)."""
    from progen_tpu_torch.sampling import sample_fast_batched
    from progen_tpu_torch.workloads.scoring import score_step

    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    scores = score_step(model, batch, device="cuda")
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t
    scored = launch_counts()
    t = time.perf_counter()
    seqs = sample_fast_batched(0, model, primes, GEN_LENGTH, top_k=25,
                               add_bos=True, device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    counts = launch_counts()
    want = per_forward(cfg)
    if scored != want or counts != want:
        raise AssertionError(f"main path launched {scored} while scoring "
                             f"and {counts} in all, not {want}")
    return dict(scores=scores, score_s=score_s, seqs=seqs, gen_s=gen_s,
                launches=counts)


def check_scores(cfg, model, model32, batch, run) -> dict:
    """Phase 3's checks: shapes, finite values, the scored token counts,
    and logits that agree with the same model on the plain path."""
    nll, lp, mask = run["scores"]
    if nll.shape != (BATCH,) or lp.shape != (BATCH, cfg.seq_len):
        raise AssertionError("score_step shapes")
    if not bool(torch.isfinite(nll).all() & torch.isfinite(lp).all()):
        raise AssertionError("non-finite scores")
    ntok = [int(m.sum()) for m in mask]
    expect = [min(len(s) + 1, cfg.seq_len) for s in PROTEINS]
    if ntok != expect:
        raise AssertionError(f"scored token counts {ntok} != {expect}")

    from progen_tpu_torch.training.loss import sequence_scores

    ids, labels = batch[:, :-1].cuda(), batch[:, 1:].cuda()
    with torch.inference_mode():
        got = model(ids)
        with plain_path():
            plain = model(ids)
            ref32 = model32(ids)
    e_k = (got - ref32).abs().max().item()
    e_p = (plain - ref32).abs().max().item()
    d_kp = (got - plain).abs().max().item()
    d_nll = (nll - sequence_scores(plain, labels)[0]).abs().max().item()
    # The kernel path may be no further from the float32 forward than
    # twice the plain bfloat16 path's distance (both round activations to
    # bfloat16 at every layer), no logit further than LOGIT_ATOL from the
    # plain path's, and its per-sequence NLL within 1e-2 nats.
    if (not e_k <= 2 * e_p + 1e-3 or not d_kp <= LOGIT_ATOL
            or not d_nll <= 1e-2):
        raise AssertionError(f"logits: kernel vs f32 {e_k}, plain vs f32 "
                             f"{e_p}, kernel vs plain {d_kp}, nll {d_nll}")
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(ids), iters=5, warmup=1)
        with plain_path():
            plain_fwd_ms = time_ms(lambda: model(ids), iters=3, warmup=1)
    out = dict(score_step_s=run["score_s"], forward_ms=fwd_ms,
               plain_forward_ms=plain_fwd_ms,
               sequences_per_s=BATCH / (fwd_ms / 1e3), tokens=ntok,
               mean_nll=nll.mean().item(), logits_kernel_vs_plain=d_kp,
               logits_kernel_vs_f32=e_k, logits_plain_vs_f32=e_p,
               nll_kernel_vs_plain=d_nll)
    line("score", **out)
    return out


KERNEL_GROUPS = (  # kernel-name substring -> group in the breakdown
    # A1: the float32 FMA kernel, then the bfloat16/float16 tensor-core one
    ("local_attention_fwd", "A1 local_attention_fwd"),
    ("fwd_tc_kernel", "A1 local_attention_fwd"),
    # the row pass and the key pass of A2 (the profiled step runs "kv"):
    # the float32 FMA kernels, then the bfloat16/float16 tensor-core ones,
    # ahead of the matrix-product names
    ("rows_kernel", "A2 local_attention_bwd_kv"),
    ("kv_kernel", "A2 local_attention_bwd_kv"),
    ("halo_kernel", "A3 local_attention_bwd_halo"),
    ("rows_tc_kernel", "A2 local_attention_bwd_kv"),
    ("kv_tc_kernel", "A2 local_attention_bwd_kv"),
    ("halo_tc_kernel", "A3 local_attention_bwd_halo"),
    ("norm_shift", "L1 norm_shift"),
    ("sgu_", "L2 sgu_mix_gate"),
    ("nvjet", "matrix products"), ("gemm", "matrix products"),
    ("xmma", "matrix products"), ("cutlass", "matrix products"),
)


def profile_forward(model, ids) -> dict:
    """One full forward under torch.profiler (see ``profile_groups``)."""
    with torch.inference_mode():
        model(ids)
        torch.cuda.synchronize()
        return profile_groups(lambda: model(ids), "profile")


def profile_groups(fn, tag: str) -> dict:
    """``fn()`` once under torch.profiler: device time by kernel group,
    the wall time, and the share of it the card sat idle. Reports "not
    measured" when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    groups, top = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        group = next((g for key, g in KERNEL_GROUPS if key in e.key.lower()),
                     "other (elementwise, copies, reductions)")
        groups[group] = groups.get(group, 0.0) + ms
        top.append((ms, e.count, e.key[:90]))
    device_ms = sum(groups.values())
    if device_ms == 0:
        out = dict(wall_ms=wall_ms, device_ms="not measured")
    else:
        out = dict(wall_ms=wall_ms, device_ms=device_ms,
                   idle_share=max(0.0, 1 - device_ms / wall_ms),
                   by_group={g: groups[g] for g in sorted(
                       groups, key=groups.get, reverse=True)},
                   top_kernels=[dict(ms=m, count=c, name=n) for m, c, n
                                in sorted(top, reverse=True)[:12]])
    line(tag, **{k: v for k, v in out.items() if k != "top_kernels"})
    return out


def check_generation(cfg, model, model32, primes, run) -> dict:
    """Phase 4's checks: shapes, token range, BOS and prime kept, nothing
    after the second zero, and decode-mode logits that agree with the
    full forward over the generated positions."""
    seqs = run["seqs"]
    if seqs.shape != (len(PRIMES), GEN_LENGTH) or seqs.device.type != "cuda":
        raise AssertionError(f"sample shape {tuple(seqs.shape)}")
    if int(seqs.min()) < 0 or int(seqs.max()) >= cfg.num_tokens:
        raise AssertionError("token out of range")
    if not bool((seqs[:, 0] == 0).all()):
        raise AssertionError("BOS missing")
    if not torch.equal(seqs[:, 1:1 + primes.shape[1]].cpu(),
                       torch.from_numpy(primes).long()):
        raise AssertionError("prime not kept")
    after = torch.cumsum((seqs == 0).long(), dim=-1) > 1
    if bool((seqs[after] != 0).any()):
        raise AssertionError("tokens after the second zero")

    with torch.inference_mode():
        cache = model.init_cache(seqs.shape[0])
        dec = torch.stack([model.decode_step(seqs[:, p], cache)
                           for p in range(GEN_LENGTH)], dim=1)
        padded = torch.zeros(seqs.shape[0], cfg.seq_len, dtype=torch.long,
                             device=seqs.device)
        padded[:, :GEN_LENGTH] = seqs
        full = model(padded)[:, :GEN_LENGTH]
        with plain_path():
            plain = model(padded)[:, :GEN_LENGTH]
            ref32 = model32(padded)[:, :GEN_LENGTH]
    e_dec = (dec - ref32).abs().max().item()
    e_p = (plain - ref32).abs().max().item()
    d_df = (dec - full).abs().max().item()
    # same rule as the scoring check: the decoder, in bfloat16, no further
    # from the float32 full forward than twice the plain bfloat16 forward
    if not e_dec <= 2 * e_p + 1e-3:
        raise AssertionError(f"decode vs f32 {e_dec}, plain vs f32 {e_p}, "
                             f"decode vs full {d_df}")
    lengths = [int((~after[i]).sum()) for i in range(seqs.shape[0])]
    steps = GEN_LENGTH - 1  # decode steps per request, prefill included
    out = dict(requests=seqs.shape[0], length=GEN_LENGTH,
               seconds=run["gen_s"], decode_steps_per_s=steps / run["gen_s"],
               tokens_per_s=seqs.shape[0] * steps / run["gen_s"],
               lengths=lengths, decode_vs_full=d_df, decode_vs_f32=e_dec,
               plain_vs_f32=e_p)
    line("generate", **out)
    return out


def train_batch(cfg) -> torch.Tensor:
    """(grad_accum, micro_batch, seq_len + 1): the script's proteins,
    byte-tokenised and padded, twice over in two orders."""
    strings = PROTEINS + PROTEINS[::-1]
    return collate(strings, cfg.seq_len).reshape(
        TRAIN_ACCUM, TRAIN_MICRO, cfg.seq_len + 1).cuda()


def full_batch(cfg) -> torch.Tensor:
    """(grad_accum, micro_batch, seq_len + 1) with no padding: the
    proteins back to back, cut into rows after a BOS. Every position
    counts in the loss, so every query row of every window gets a
    gradient (in a padded batch, the rows past a sequence's first pad get
    none: they are masked out of the loss and nothing before them reads
    them)."""
    from progen_tpu_torch.data.tokenizer import encode_tokens

    rows, n = TRAIN_ACCUM * TRAIN_MICRO, cfg.seq_len
    stream = np.concatenate([encode_tokens(s) for s in PROTEINS])
    stream = np.tile(stream, rows * n // len(stream) + 1)[:rows * n]
    out = torch.zeros(rows, n + 1, dtype=torch.long)
    out[:, 1:] = torch.from_numpy(stream.reshape(rows, n).astype(np.int64))
    return out.reshape(TRAIN_ACCUM, TRAIN_MICRO, n + 1).cuda()


def drive_train_path(cfg, state, batch) -> dict:
    """Phase 5, the train path as a user drives it: 3 steps of
    make_train_step on one batch, with every launch count set to 0 just
    before and read just after. Times each step with CUDA events and
    takes the peak device memory over the steps."""
    from progen_tpu_torch.training.step import make_eval_step, make_train_step

    step, evaluate = make_train_step(), make_eval_step()
    loss_before = evaluate(state, batch[0]).item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    steps = []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, m = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        steps.append(dict(ms=start.elapsed_time(end),
                          **{k: v.item() for k, v in m.items()}))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * TRAIN_STEPS for k, v in per_step(cfg).items()}
    if counts != want:
        raise AssertionError(f"train path launched {counts}, not {want}")
    loss_after = evaluate(state, batch[0]).item()
    tokens = TRAIN_ACCUM * TRAIN_MICRO * cfg.seq_len
    warm = [s["ms"] for s in steps[1:]]
    out = dict(steps=steps, launches=counts,
               launches_per_step=per_step(cfg),
               step_ms=sum(warm) / len(warm),
               tokens_per_s=tokens / (sum(warm) / len(warm) / 1e3),
               first_step_ms=steps[0]["ms"], tokens_per_step=tokens,
               peak_memory_bytes=peak, loss_before=loss_before,
               loss_after=loss_after)
    line("train", **{k: v for k, v in out.items() if k != "steps"})
    for i, st in enumerate(steps):
        line(f"train step {i + 1}", **st)
    return out


def rel_cos(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(|a - b| / |b|, cosine of a and b), over the whole tensor, computed
    on the card in float64 (either may be kept on the host)."""
    # moved as they are, then widened on the card (a widening copy from
    # the host would convert there and move twice the bytes)
    a, b = (t.to("cuda").to(torch.float64).flatten() for t in (a, b))
    nb = b.norm().item()
    rel = (a - b).norm().item() / nb if nb > 0 else (a - b).norm().item()
    cos = (a @ b).item() / max(a.norm().item() * nb, 1e-300)
    return rel, cos


def grads_of(model, data) -> dict:
    """One micro-batch's gradients of the train loss."""
    from progen_tpu_torch.training.step import batch_loss

    model.zero_grad(set_to_none=True)
    batch_loss(model, data).backward()
    out = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return out


def check_gradients(cfg, state, batch) -> dict:
    """Phase 6a: one micro-batch's gradients through the kernels against
    the same model on the plain path (bfloat16) and a float32 plain
    model. Per parameter tensor, the kernel path's relative distance from
    the float32 gradient may be at most twice the plain bfloat16 path's
    (plus 1e-3), and its cosine with it at least GRAD_COS."""
    from progen_tpu_torch import ProGen

    model = state.model
    model32 = ProGen(dataclasses.replace(cfg, dtype="float32"),
                     device="cuda", seed=None)
    model32.load_state_dict(model.state_dict())
    data = batch[0]
    got = grads_of(model, data)
    with plain_path():
        plain = grads_of(model, data)
        ref32 = grads_of(model32, data)
    del model32
    worst, bad = [], []
    for name in got:
        rel_k, cos_k = rel_cos(got[name], ref32[name])
        rel_p, _ = rel_cos(plain[name], ref32[name])
        worst.append((rel_k - 2 * rel_p, name, rel_k, rel_p, cos_k))
        if not (rel_k <= 2 * rel_p + 1e-3 and cos_k >= GRAD_COS):
            bad.append((name, rel_k, rel_p, cos_k))
    worst.sort(reverse=True)
    out = dict(tensors=len(got), min_cos=min(w[4] for w in worst),
               max_rel_kernel=max(w[2] for w in worst),
               max_rel_plain=max(w[3] for w in worst),
               worst=[dict(name=w[1], rel_kernel=w[2], rel_plain=w[3],
                           cos=w[4]) for w in worst[:5]])
    line("grad check", **{k: v for k, v in out.items() if k != "worst"},
         worst=out["worst"][0])
    if bad:
        raise AssertionError(f"kernel-path gradients off: {bad[:5]}")
    return out


def step_grads(step, state, batch) -> tuple:
    """One ``step(state, batch)``; returns the averaged, unclipped
    gradients it hands the optimizer, copied to the host as it gets them
    (so no copy of them stays on the card to count in a peak), and its
    metrics."""
    sink, update = [], state.optimizer.update

    def record(grads, norm=None):
        sink.append({n: g.detach().to("cpu", copy=True)
                     for n, g in grads.items()})
        return update(grads, norm)

    with mock.patch.object(state.optimizer, "update", record):
        _, m = step(state, batch)
    return sink[0], m


def halo_step(cfg, state, batch) -> dict:
    """Phase 6b: the same step from one state twice, with A2 and, on a
    copy of the state, with the attention backward switched to A3, whose
    launches are counted on their own. The gradients the two hand to the
    optimizer must agree per tensor (HALO_REL, HALO_COS). Then one more A2
    step, with nothing recorded, profiled by kernel group."""
    from progen_tpu_torch.models import layers
    from progen_tpu_torch.training.step import make_train_step

    step, twin = make_train_step(), copy.deepcopy(state)
    kv, _ = step_grads(step, state, batch)
    reset_counts()
    with mock.patch.object(layers, "ATTN_BWD_IMPL", "halo"):
        halo, m = step_grads(step, twin, batch)
        torch.cuda.synchronize()
    counts = launch_counts()
    del twin
    want = per_step(cfg, "halo")
    if counts != want:
        raise AssertionError(f"halo step launched {counts}, not {want}")
    stats = [(*rel_cos(halo[n], kv[n]), n) for n in kv]
    rel = max(stats)
    cos = min(stats, key=lambda x: x[1])
    out = dict(launches=counts, max_rel=rel[0], max_rel_tensor=rel[2],
               min_cos=cos[1], min_cos_tensor=cos[2],
               tensors_differing=sum(not torch.equal(halo[n], kv[n])
                                     for n in kv), tensors=len(kv),
               loss=m["loss"].item(), grad_norm=m["grad_norm"].item(),
               skipped=int(m["skipped"]))
    line("halo step", **out)
    if not (rel[0] <= HALO_REL and cos[1] >= HALO_COS):
        raise AssertionError(f"A3 step's gradients off A2's: {out}")
    del kv, halo
    profile = profile_groups(lambda: step(state, batch), "train profile")
    return dict(out, profile=profile)


def long8k_config():
    from progen_tpu_torch import ProGenConfig, load_toml_config

    return ProGenConfig.from_dict(load_toml_config(
        str(REPO / "configs" / "model" / "long8k.toml")))


def seqpar_batch(cfg) -> torch.Tensor:
    """(2, 2, seq_len + 1) random tokens 1..255 from a numpy seed: no pad,
    so every position counts in the loss and every window's rows get a
    gradient."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(
        1, cfg.num_tokens, (SEQPAR_ACCUM, SEQPAR_MICRO, cfg.seq_len + 1)))


def timed_steps(step, state, batch) -> dict:
    """SEQPAR_STEPS steps of ``step`` with every launch count set to 0
    just before: each step's CUDA-event time, metrics and launches; the
    first step's gradients (as the optimizer gets them, on the host:
    ``step_grads``); the peak device memory, raw and as its growth over
    what was allocated when the window opened (the state itself and
    anything the caller holds)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at_reset = torch.cuda.memory_allocated()
    reset_counts()
    steps, grads = [], None
    for i in range(SEQPAR_STEPS):
        before = launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if i == 0:
            grads, m = step_grads(step, state, batch)
        else:
            _, m = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        after = launch_counts()
        steps.append(dict(ms=start.elapsed_time(end),
                          launches={k: after[k] - before[k] for k in after},
                          **{k: v.item() for k, v in m.items()}))
    warm = [st["ms"] for st in steps[1:]]
    peak = torch.cuda.max_memory_allocated()
    return dict(grads=grads, steps=steps, launches=launch_counts(),
                step_ms=sum(warm) / len(warm), peak_memory_bytes=peak,
                peak_growth_bytes=peak - at_reset)


def time_all_reduce(cfg, grid) -> float:
    """Host time of the train step's one bucketed gradient all_reduce
    (every parameter's shape, float32) over gloo, on the card, mean of 3
    after one warm-up."""
    from progen_tpu_torch import ProGen
    from progen_tpu_torch.parallel.collectives import all_reduce_

    grads = [torch.zeros_like(p) for p in
             ProGen(cfg, device="cuda", seed=None).parameters()]
    all_reduce_(grads, grid.world_group)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        all_reduce_(grads, grid.world_group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / 3 * 1e3


def seqpar_rank(rank: int, port: int, out_dir: str) -> None:
    """One of the SEQ_SHARDS ranks of phase 7, spawned: joins the gloo
    group and runs the 3 steps of make_train_step(grid) on its shard, in
    bfloat16 (the path, counted) and then in float32 from the same
    state; before them, the first bfloat16 step once more on a copy of
    the state with A4's q-centric ("halo") backward, counted on its own
    and held against the kv step's gradients (HALO_REL, HALO_COS). Writes
    its records, and rank 0 also the gradients of the first step and the
    parameters after the third."""
    import hashlib

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(SEQ_SHARDS),
                      GLOO_SOCKET_IFNAME="lo")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from progen_tpu_torch.models import layers
    from progen_tpu_torch.parallel import init_grid
    from progen_tpu_torch.training.step import (
        init_train_state,
        make_train_step,
    )

    grid = init_grid(1, SEQ_SHARDS, "gloo", timeout=SEQPAR_TIMEOUT)
    cfg = long8k_config()
    batch = seqpar_batch(cfg).cuda()
    records = {"gradient_all_reduce_ms": time_all_reduce(cfg, grid)}
    for name, c in (("bf16", cfg),
                    ("f32", dataclasses.replace(cfg, dtype="float32"))):
        state = init_train_state(c, device="cuda", seed=0, grid=grid)
        if name == "bf16":
            # A4's q-centric backward: the first step on a copy of the
            # state with the attention backward switched to "halo",
            # counted on its own
            reset_counts()
            with mock.patch.object(layers, "ATTN_BWD_IMPL", "halo"):
                halo_grads, _ = step_grads(make_train_step(grid),
                                           copy.deepcopy(state), batch)
                torch.cuda.synchronize()
            halo_counts = launch_counts()
        run = timed_steps(make_train_step(grid), state, batch)
        if name == "bf16":
            stats = [(*rel_cos(halo_grads[n], run["grads"][n]), n)
                     for n in halo_grads]
            records["halo_step"] = dict(
                launches=halo_counts, max_rel=max(stats)[0],
                max_rel_tensor=max(stats)[2],
                min_cos=min(stats, key=lambda x: x[1])[1])
            del halo_grads
        params = {n: p.detach()
                  for n, p in state.model.named_parameters()}
        digest = hashlib.sha256()
        for p in params.values():
            digest.update(p.cpu().numpy().tobytes())
        if rank == 0:
            torch.save({"grads": run["grads"], "params": params},
                       Path(out_dir) / f"rank0_{name}.pt")
        records[name] = dict({k: v for k, v in run.items()
                              if k != "grads"},
                             params_sha256=digest.hexdigest())
        del state, run, params
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(dict(
        records, rank=rank, seq_index=grid.seq_index)))
    torch.distributed.destroy_process_group()


def spawn_seqpar(out_dir: Path) -> list:
    """Start the ranks, wait for them within SEQPAR_TIMEOUT, kill any
    left; fail unless every rank exited 0. Their records, in rank
    order."""
    import torch.multiprocessing as mp

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=seqpar_rank, args=(r, port, str(out_dir)))
             for r in range(SEQ_SHARDS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SEQPAR_TIMEOUT
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"seqpar ranks exited {codes}")
    return [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(SEQ_SHARDS)]


def max_rel(got: dict, want: dict) -> tuple:
    """(largest per-tensor relative distance, its tensor, smallest
    cosine, its tensor) of ``got`` against ``want``."""
    stats = [(*rel_cos(got[n], want[n]), n) for n in want]
    rel = max(stats)
    cos = min(stats, key=lambda x: x[1])
    return rel[0], rel[2], cos[1], cos[2]


def phase_seqpar(cfg, card: str) -> dict:
    """Phase 7 (see the module docstring)."""
    from progen_tpu_torch.training.step import (
        init_train_state,
        make_train_step,
    )

    torch.cuda.empty_cache()
    batch = seqpar_batch(cfg).cuda()
    single = {}
    for name, c in (("bf16", cfg),
                    ("f32", dataclasses.replace(cfg, dtype="float32"))):
        state = init_train_state(c, device="cuda", seed=0)
        if name == "bf16":
            p0 = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()}
        single[name] = timed_steps(make_train_step(), state, batch)
        single[name]["params"] = {n: p.detach() for n, p in
                                  state.model.named_parameters()}
        del state

    out_dir = REPO / "build" / "seqpar"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.iterdir():
        f.unlink()
    t = time.perf_counter()
    ranks = spawn_seqpar(out_dir)
    ranks_s = time.perf_counter() - t

    def delta(params):
        return {n: params[n] - p0[n] for n in p0}

    def loss_rel(a, b):
        return max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
                   for x, y in zip(a, b))

    # the bfloat16 single process's own distance from float32
    own = dict(loss=loss_rel(single["bf16"]["steps"],
                             single["f32"]["steps"]),
               grads=max_rel(single["bf16"]["grads"],
                             single["f32"]["grads"])[0],
               update=max_rel(delta(single["bf16"]["params"]),
                              delta(single["f32"]["params"]))[0])
    dist = {}
    for name in ("bf16", "f32"):
        got = torch.load(out_dir / f"rank0_{name}.pt", map_location="cuda")
        dist[name] = dict(
            loss=max(loss_rel(r[name]["steps"], single[name]["steps"])
                     for r in ranks),
            grads=max_rel(got["grads"], single[name]["grads"]),
            update=max_rel(delta(got["params"]),
                           delta(single[name]["params"])))
        del got
    bf = single["bf16"]
    tokens = SEQPAR_ACCUM * SEQPAR_MICRO * cfg.seq_len
    out = dict(
        config="configs/model/long8k.toml", grid=[1, SEQ_SHARDS],
        backend="gloo", batch=list(batch.shape), ranks_s=ranks_s,
        launches_per_step_and_rank=[[st["launches"]
                                     for st in r["bf16"]["steps"]]
                                    for r in ranks],
        step_ms_per_rank=[r["bf16"]["step_ms"] for r in ranks],
        tokens_per_s=tokens / (max(r["bf16"]["step_ms"] for r in ranks)
                               / 1e3),
        peak_memory_bytes_per_rank=[r["bf16"]["peak_memory_bytes"]
                                    for r in ranks],
        peak_growth_bytes_per_rank=[r["bf16"]["peak_growth_bytes"]
                                    for r in ranks],
        gradient_all_reduce_ms_per_rank=[r["gradient_all_reduce_ms"]
                                         for r in ranks],
        halo_step=ranks[0]["halo_step"],
        single_step_ms=bf["step_ms"],
        single_tokens_per_s=tokens / (bf["step_ms"] / 1e3),
        single_peak_memory_bytes=bf["peak_memory_bytes"],
        single_peak_growth_bytes=bf["peak_growth_bytes"],
        single_launches=bf["launches"],
        losses=[st["loss"] for st in ranks[0]["bf16"]["steps"]],
        single_losses=[st["loss"] for st in bf["steps"]],
        f32_losses=[st["loss"] for st in single["f32"]["steps"]],
        grad_norms=[st["grad_norm"] for st in ranks[0]["bf16"]["steps"]],
        single_grad_norms=[st["grad_norm"] for st in bf["steps"]],
        bf16_vs_f32=own, card=card,
        note="2 ranks share 1 card: the step time records the path, "
             "it is not a scaling number")
    for name in ("bf16", "f32"):
        d = dist[name]
        out[f"seqpar_vs_single_{name}"] = dict(
            loss=d["loss"], grads_max_rel=d["grads"][0],
            grads_max_rel_tensor=d["grads"][1],
            grads_min_cos=d["grads"][2], grads_min_cos_tensor=d["grads"][3],
            update_max_rel=d["update"][0],
            update_max_rel_tensor=d["update"][1],
            update_min_cos=d["update"][2],
            replicas_equal=len({r[name]["params_sha256"]
                                for r in ranks}) == 1)
    line("seqpar", **out)
    del p0, single
    bad = []
    want_step = seqpar_per_step(cfg)
    want_halo = {**want_step, "A4-kv": 0, "A4-halo": want_step["A4-kv"]}
    for r in ranks:
        hs = r["halo_step"]
        if hs["launches"] != want_halo:
            bad.append(f"rank {r['rank']} halo step launched "
                       f"{hs['launches']}, not {want_halo}")
        if not (hs["max_rel"] <= HALO_REL and hs["min_cos"] >= HALO_COS):
            bad.append(f"rank {r['rank']} halo step's gradients off the "
                       f"kv step's: {hs}")
        for i, st in enumerate(r["bf16"]["steps"]):
            if st["launches"] != want_step:
                bad.append(f"rank {r['rank']} step {i + 1} launched "
                           f"{st['launches']}, not {want_step}")
        for name in ("bf16", "f32"):
            for i, st in enumerate(r[name]["steps"]):
                if not (np.isfinite(st["loss"]) and st["skipped"] == 0):
                    bad.append(f"rank {r['rank']} {name} step {i + 1}: "
                               f"{st}")
    want_single = {k: v * SEQPAR_STEPS for k, v in
                   per_step(cfg, accum=SEQPAR_ACCUM).items()}
    if bf["launches"] != want_single:
        bad.append(f"single process launched {bf['launches']}, not "
                   f"{want_single}")
    for name, share in (("f32", SEQPAR_SHARE_F32),
                        ("bf16", SEQPAR_SHARE_BF16)):
        if not out[f"seqpar_vs_single_{name}"]["replicas_equal"]:
            bad.append(f"the ranks' {name} parameters differ")
        for key in ("loss", "grads", "update"):
            d = dist[name][key] if key == "loss" else dist[name][key][0]
            if not d <= share * own[key]:
                bad.append(f"{name} {key}: {d} from the single process, "
                           f"over {share} x bfloat16's {own[key]} from "
                           f"float32")
    if not dist["bf16"]["grads"][2] >= SEQPAR_COS:
        bad.append(f"gradient cosine {dist['bf16']['grads'][2]} < "
                   f"{SEQPAR_COS}")
    if bad:
        raise AssertionError("seqpar: " + "; ".join(bad))
    return dict(out, launches={k: sum(r["bf16"]["launches"][k]
                                      + r["halo_step"]["launches"][k]
                                      for r in ranks)
                               for k in ranks[0]["bf16"]["launches"]})


# phase 8: the entry points a user runs, at base.toml in bfloat16
CLI_SEQS, CLI_MIN_LEN, CLI_MAX_LEN = 512, 64, 1000  # the synthetic FASTA
CLI_FRESH_STEPS, CLI_RESUME_STEPS = 4, 2
# the CLIs' model: base.toml's widths with its depth cut from 24 to 6, to
# keep the whole script inside its time limit (its three 1000-token
# decodes and 4.8 GB checkpoints took most of the phase's 307 s at 24)
CLI_DEPTH = 6
# its three decodes (the cadenced sample, cli.sample and the reference)
# cut from 1,000 tokens to CLI_SAMPLE_TOKENS new ones since slice 9: at
# depth 6 they were still most of the phase (148.5 s on a slow host)
CLI_SAMPLE_TOKENS = 32
CLI_PRIME = "[tax=Homo sapiens] #"
CLI_SEED = 0  # the FASTA's, the ETL's, the model's; the sample's + 7
TAXA = [("Homo sapiens", 9606), ("Mus musculus", 10090),
        ("Escherichia coli", 562), ("Saccharomyces cerevisiae", 4932),
        ("Arabidopsis thaliana", 3702)]
DATA_TOML = """read_from = "{fasta}"
write_to = "{out}"
num_samples = {n}
max_seq_len = 1024
prob_invert_seq_annotation = 0.5
fraction_valid_data = 0.1
num_sequences_per_file = 256
sort_annotations = true
"""


def write_fasta(path: Path, seed: int) -> None:
    """CLI_SEQS proteins with Uniref50-style headers, lengths drawn from
    CLI_MIN_LEN..CLI_MAX_LEN, from a numpy seed."""
    rng = np.random.default_rng(seed)
    aas = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    with path.open("w") as f:
        for i in range(CLI_SEQS):
            n = int(rng.integers(CLI_MIN_LEN, CLI_MAX_LEN + 1))
            seq = "".join(rng.choice(aas, n))
            tax, taxid = TAXA[int(rng.integers(len(TAXA)))]
            f.write(f">UniRef50_A0A{i:07d} Uncharacterized protein "
                    f"n={int(rng.integers(1, 40))} Tax={tax} TaxID={taxid} "
                    f"RepID=A0A{i:07d}_9EUKA\n")
            for k in range(0, n, 60):
                f.write(seq[k:k + 60] + "\n")


def train_records(data: Path) -> list:
    """The train split's records in the order of the shard index, read
    shard by shard apart from the iterator under test."""
    from progen_tpu_torch.data.tfrecord import read_tfrecords

    files = sorted(data.glob("*.train.tfrecord.gz"),
                   key=lambda p: int(p.name.split(".")[0]))
    return [r for f in files for r in read_tfrecords(str(f))]


def padded_share(records, seq_len: int) -> float:
    """Share of the (records x seq_len) token positions that are padding."""
    real = sum(min(len(r), seq_len) for r in records)
    return 1 - real / (len(records) * seq_len)


def counted_steps(make_step, counts: list):
    """make_train_step wrapped to record each step's launches in
    ``counts``."""
    def make(*args, **kw):
        step = make_step(*args, **kw)

        def counted(state, batch):
            before = launch_counts()
            out = step(state, batch)
            after = launch_counts()
            counts.append({k: after[k] - before[k] for k in after})
            return out
        return counted
    return make


def check_restore(run: dict, get_last) -> dict:
    """The first run's final checkpoint, restored, against the state it
    saved: parameters, moments, count, step, cursor and model config,
    bit for bit. Returns the restore seconds and the checkpoint's bytes."""
    t = time.perf_counter()
    pkg = get_last(device="cuda")
    restore_s = time.perf_counter() - t
    state, got = run["state"], pkg.state
    bad = [k for k, v in state.model.state_dict().items()
           if v.dtype != got["params"][k].dtype
           or not torch.equal(v, got["params"][k])]
    for name in ("mu", "nu"):
        bad += [f"{name}:{k}" for k, v in getattr(state.optimizer, name)
                .items() if not torch.equal(v, got["optimizer"][name][k])]
    meta = (pkg.path, pkg.next_seq_index, pkg.model_config,
            got["optimizer"]["count"], got["step"])
    want = (run["saves"][-1]["path"], run["next_seq_index"],
            run["config"].to_dict(), state.optimizer.count, state.step)
    if bad or meta != want:
        raise AssertionError(f"restore differs: tensors {bad[:5]}, "
                             f"{meta[:2] + meta[3:]} vs {want[:2] + want[3:]}"
                             f", config equal {meta[2] == want[2]}")
    nbytes = sum(f.stat().st_size for f in Path(pkg.path).iterdir())
    return dict(restore_s=restore_s, checkpoint_bytes=nbytes)


def check_quarantine(ck: Path) -> dict:
    """Flip one byte in the middle of the newest checkpoint's params.pt:
    a fresh walk must quarantine it and take the one before."""
    from progen_tpu_torch.checkpoint import CORRUPT_SUFFIX, get_checkpoint_fns

    names = sorted(p for p in ck.iterdir() if p.name.startswith("ckpt_")
                   and p.name[5:].isdigit())
    newest, before = names[-1], names[-2]
    with (newest / "params.pt").open("r+b") as f:
        f.seek(f.seek(0, os.SEEK_END) // 2)
        byte = f.read(1)[0]
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte ^ 0x10]))
    got = get_checkpoint_fns(str(ck))[1].peek()
    quarantined = newest.with_name(newest.name + CORRUPT_SUFFIX)
    if got is None or got.path != str(before) or not quarantined.is_dir():
        raise AssertionError(f"corrupt {newest.name}: walk chose "
                             f"{got and got.path}, quarantined "
                             f"{quarantined.is_dir()}")
    return dict(quarantined=quarantined.name, fell_back_to=before.name)


def cut_model_toml(path: Path, depth: int) -> None:
    """base.toml with its depth set to ``depth``, written to ``path``."""
    from progen_tpu_torch import load_toml_config

    d = {**load_toml_config(str(REPO / "configs" / "model" / "base.toml")),
         "depth": depth}
    path.write_text("".join(f"{k} = {json.dumps(v)}\n"
                            for k, v in d.items()))


def phase_cli(cfg, train: dict) -> dict:
    """Phase 8: the port's CLIs in this process, at base.toml's widths
    with its depth cut to CLI_DEPTH and --mixed_precision, in a directory
    under build/ that is removed afterwards: generate_data on a synthetic
    FASTA; train 4 steps (batch 4 x 4, checkpoint and validate every 2, a
    sample at step 0); train again, resuming, 2 steps; eval on the valid
    split; sample one sequence. Every decode is cut to CLI_SAMPLE_TOKENS
    new tokens. With the launch counts set to 0 just before and read just
    after; every step must launch per_step(cfg)."""
    import shutil

    from progen_tpu_torch import ProGen, ProGenConfig
    from progen_tpu_torch.checkpoint import get_checkpoint_fns
    from progen_tpu_torch.cli import eval as cli_eval
    from progen_tpu_torch.cli import generate_data
    from progen_tpu_torch.cli import sample as cli_sample
    from progen_tpu_torch.cli import train as cli_train
    from progen_tpu_torch.data.dataset import collate
    from progen_tpu_torch.data.tokenizer import encode_tokens
    from progen_tpu_torch.sampling import sample_fast

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg, depth=CLI_DEPTH)
    work = REPO / "build" / "chip_smoke_cli"
    shutil.rmtree(work, ignore_errors=True)
    (work / "data_cfg").mkdir(parents=True)
    (work / "model_cfg").mkdir()
    cut_model_toml(work / "model_cfg" / "base.toml", CLI_DEPTH)
    try:
        fasta, data, ck = work / "uniref50_synthetic.fasta", work / "data", \
            work / "ckpts"
        write_fasta(fasta, CLI_SEED)
        (work / "data_cfg" / "synthetic.toml").write_text(DATA_TOML.format(
            fasta=fasta, out=data, n=CLI_SEQS))
        t = time.perf_counter()
        shards = generate_data.run(["--data_dir", str(work / "data_cfg"),
                                    "--name", "synthetic",
                                    "--seed", str(CLI_SEED)])
        etl_s = time.perf_counter() - t
        args = ["--device", "cuda", "--wandb_off", "--mixed_precision",
                "--config_path", str(work / "model_cfg"),
                "--model_name", "base", "--data_path", str(data),
                "--checkpoint_path", str(ck), "--batch_size",
                str(TRAIN_MICRO), "--grad_accum_every", str(TRAIN_ACCUM),
                "--checkpoint_every", "2", "--validate_every", "2",
                "--sample_every", "1000", "--checkpoint_keep_n", "2",
                "--seed", str(CLI_SEED)]
        step_counts = []
        reset_counts()
        with mock.patch.object(cli_train, "make_train_step", counted_steps(
                cli_train.make_train_step, step_counts)), \
                short_samples(cli_train, CLI_SAMPLE_TOKENS):
            fresh = cli_train.run(args + ["--num_steps",
                                          str(CLI_FRESH_STEPS)])
            _, get_last, _ = get_checkpoint_fns(str(ck))
            restore = check_restore(fresh, get_last)
            del fresh["state"]  # its 4.8 GB of parameters and moments
            resumed = cli_train.run(args + ["--num_steps",
                                            str(CLI_RESUME_STEPS)])
            del resumed["state"]
        evaluated = cli_eval.run(["--device", "cuda", "--checkpoint_path",
                                  str(ck), "--data_path", str(data),
                                  "--split", "valid"])
        with short_samples(cli_sample, CLI_SAMPLE_TOKENS):
            sampled = cli_sample.run(["--device", "cuda",
                                      "--checkpoint_path", str(ck), "--seed",
                                      str(CLI_SEED + 7), "--prime",
                                      CLI_PRIME])
        counts = launch_counts()

        bad = []
        steps = fresh["steps"] + resumed["steps"]
        for st in steps:
            if not (np.isfinite(st["loss"]) and np.isfinite(st["grad_norm"])
                    and st["skipped"] == 0):
                bad.append(f"step not finite or skipped: {st}")
        if len(steps) != CLI_FRESH_STEPS + CLI_RESUME_STEPS:
            bad.append(f"{len(steps)} steps")
        if any(c != per_step(cfg) for c in step_counts):
            bad.append(f"launches per step {step_counts}")
        n_evals = (len(fresh["valid_losses"]) + len(resumed["valid_losses"])
                   + evaluated["batches"])
        want = {k: len(steps) * v + n_evals * per_forward(cfg)[k]
                for k, v in per_step(cfg).items()}
        if counts != want:
            bad.append(f"the phase launched {counts}, not {want}")
        records = train_records(data)
        cursor = CLI_FRESH_STEPS * TRAIN_ACCUM * TRAIN_MICRO
        if resumed["start_seq_index"] != cursor:
            bad.append(f"resumed at {resumed['start_seq_index']}")
        after = collate(records[cursor:cursor + TRAIN_ACCUM * TRAIN_MICRO],
                        cfg.seq_len).reshape(TRAIN_ACCUM, TRAIN_MICRO, -1)
        if not np.array_equal(resumed["first_batch"].numpy(), after):
            bad.append("the resumed run's first batch is not the records "
                       "after the cursor")
        if not np.isfinite(evaluated["loss"]):
            bad.append(f"eval loss {evaluated['loss']}")

        pkg = get_checkpoint_fns(str(ck))[1].restore_params(device="cuda")
        model = ProGen(ProGenConfig.from_dict(pkg.model_config),
                       device="cuda", seed=None)
        model.load_state_dict(pkg.state)
        del pkg
        prime = encode_tokens(CLI_PRIME)
        want_tokens = sample_fast(CLI_SEED + 7, model.eval(), prime,
                                  len(prime) + 1 + CLI_SAMPLE_TOKENS,
                                  top_k=25, add_bos=True, device="cuda")
        del model
        if not torch.equal(sampled["tokens"], want_tokens):
            diff = int((sampled["tokens"] != want_tokens).sum())
            bad.append(f"cli.sample differs from sample_fast at {diff} "
                       "positions")
        quarantine = check_quarantine(ck)
        if bad:
            raise AssertionError("cli: " + "; ".join(bad))

        trained = records[:cursor + len(resumed["steps"]) * TRAIN_ACCUM
                          * TRAIN_MICRO]
        saves = [s["seconds"] for s in fresh["saves"] + resumed["saves"]]
        out = dict(
            shards=len(shards), etl_s=etl_s, train_records=len(records),
            valid_sequences=evaluated["sequences"],
            steps=[{k: st[k] for k in ("step", "loss", "grad_norm", "ms",
                                       "tokens_per_s")} for st in steps],
            step_ms=float(np.mean([st["ms"] for st in steps[1:]])),
            tokens_per_s=float(np.mean([st["tokens_per_s"]
                                        for st in steps[1:]])),
            depth=CLI_DEPTH,
            train_phase_step_ms_at_depth_24=train.get("step_ms"),
            train_phase_tokens_per_s_at_depth_24=train.get("tokens_per_s"),
            launches=counts, launches_per_step=per_step(cfg),
            evals=n_evals, **restore, save_s=saves,
            valid_losses=[v["loss"] for v in fresh["valid_losses"]
                          + resumed["valid_losses"]],
            padded_share_trained=padded_share(trained, cfg.seq_len),
            padded_share_train_split=padded_share(records, cfg.seq_len),
            eval_loss=evaluated["loss"], eval_perplexity=evaluated["perplexity"],
            sample_tokens_equal=True, sample_text=sampled["texts"][0][:60],
            quarantine=quarantine, seconds=time.perf_counter() - t_phase)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    line("cli", **{k: v for k, v in out.items() if k != "steps"})
    for st in out["steps"]:
        line(f"cli step {st['step']}", **st)
    return out



# phase 9: the serving engine and cli.serve, at base.toml's widths in
# bfloat16, depth cut to SERVE_DEPTH: at 24 layers the phase took 176 s of
# the script's 1,200 s on an H100 80GB HBM3 at 700 W, and the host's
# speed moves it by up to 1.5x
SERVE_DEPTH = 6
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_CHUNK, SERVE_CACHE_MIB = 8, 256, 32, 512
SERVE_PARITY = [(4, 48), (9, 56), (14, 64), (20, 72), (26, 96), (32, 192)]
SERVE_KNOBS = dict(temperature=0.8, top_p=0.95)
SCAFFOLD = 128  # tokens the scaffold pair shares
CLI_KILL_AFTER = 8  # token lines the killed cli.serve run prints first


def serve_requests() -> list:
    """The 13 requests of phase 9, in submission order: a top_k = 1
    occupant that draws EOS at once (its slot is reused), six parity
    requests, two with knobs, an infill freezing every third position, a
    pair sharing a 128-token scaffold (primes 160 and 144: the second is
    a prefix-cache hit) and one embedding."""
    from progen_tpu_torch.data.tokenizer import encode_tokens
    from progen_tpu_torch.serving import Request
    from progen_tpu_torch.workloads.infill import (
        infill_request_arrays,
        parse_template,
    )

    def enc(s):
        return encode_tokens(s).astype(np.int64)

    reqs = [Request(id="occupant", prime=enc(PROTEINS[0][:5]), length=16,
                    top_k=1, add_bos=True, seed=200)]
    reqs += [Request(id=f"parity{i}", prime=enc(PROTEINS[i][:n]),
                     length=length, add_bos=True, seed=100 + i)
             for i, (n, length) in enumerate(SERVE_PARITY)]
    reqs += [Request(id=f"knobs{i}", prime=enc(PROTEINS[6 + i][:6 * i + 6]),
                     length=48 + 16 * i, add_bos=True, seed=110 + i,
                     **SERVE_KNOBS) for i in range(2)]
    # the first 4 residues frozen (the prime), then every third
    template = "".join(c if i < 4 or i % 3 == 0 else "?"
                       for i, c in enumerate(PROTEINS[2][:64]))
    prime, length, tpl, frz = infill_request_arrays(
        *parse_template(template))
    reqs.append(Request(id="infill", prime=prime, length=length,
                        add_bos=True, template=tpl, frozen=frz, seed=120))
    # no other request shares more than its BOS with the scaffold
    scaffold = enc(PROTEINS[1][40:40 + SCAFFOLD])
    reqs += [Request(id=f"scaffold{i}", prime=np.concatenate(
        [scaffold, enc(PROTEINS[5][:tail])]), length=length, add_bos=True,
        seed=130 + i) for i, (tail, length) in enumerate([(32, 168),
                                                          (16, 152)])]
    reqs.append(Request(id="embed", prime=enc(PROTEINS[3]), length=0,
                        add_bos=True, kind="embed"))
    return reqs


@contextlib.contextmanager
def decode_log(model, extra=None):
    """Record every ``model.decode_step`` call while the block runs: the
    positions fed (before the step), the logits, and ``extra()`` if
    given. The comparisons read the logits each decoder drew from."""
    step, log = model.decode_step, []

    def recorded(tokens, cache):
        pos = cache.pos.clone()
        logits = step(tokens, cache)
        log.append((pos, logits, None if extra is None else extra()))
        return logits

    with mock.patch.object(model, "decode_step", recorded):
        yield log


def reference_stream(model, req):
    """sample_fast's tokens for ``req`` and, by position fed, its
    logits."""
    from progen_tpu_torch.sampling import sample_fast

    with decode_log(model) as log:
        out = sample_fast(req.seed, model, req.prime, req.length,
                          top_k=req.top_k, add_bos=req.add_bos,
                          temperature=req.temperature, top_p=req.top_p,
                          template=req.template, frozen=req.frozen,
                          device="cuda").cpu().numpy()
    return out, {int(pos[0]): logits[0].float() for pos, logits, _ in log}


def serve_run(model, reqs, slots: int, prefix_cache=None, log=None):
    """Submit ``reqs`` to a fresh engine and scheduler and run them to
    completion; (completions by id, the scheduler). With ``log`` (a
    list), every pool step's positions, logits, buffers and live slots
    are recorded into it."""
    from progen_tpu_torch.serving import Scheduler, ServeEngine

    sched = Scheduler(ServeEngine(model, max_slots=slots,
                                  max_len=SERVE_MAX_LEN),
                      prefill_chunk=SERVE_CHUNK, prefix_cache=prefix_cache)
    for r in reqs:
        ok, reason = sched.submit(r)
        if not ok:
            raise AssertionError(f"{r.id} rejected: {reason}")
    pool = sched.engine.slots
    with decode_log(model, lambda: (pool.seqs.clone(), pool.live.clone())
                    ) as steps:
        _, comps = sched.run_to_completion(max_steps=5000)
    if log is not None:
        log.extend(steps)
    torch.cuda.synchronize()
    engine = sched.engine
    if engine.num_active or bool(engine.slots.live.any()):
        raise AssertionError("a slot is still held or live at the end")
    return {c.request_id: c for c in comps}, sched


def pool_logits(log, tokens, p: int) -> torch.Tensor:
    """From a pool run's decode log: the logits the pool drew position
    ``p`` of ``tokens`` from, found as the live row that fed position
    p - 1 with ``tokens``' first p tokens in its buffer."""
    want = torch.from_numpy(tokens[:p]).cuda()
    for pos, logits, (seqs, live) in log:
        if pos.shape[0] != SERVE_SLOTS:
            continue  # a batch-1 prefill step
        rows = (live & (pos == p - 1)
                & (seqs[:, :p] == want).all(dim=1)).nonzero()
        if rows.numel():
            return logits[int(rows[0, 0])].float()
    raise AssertionError(f"no pool step fed position {p - 1} of the "
                         "stream")


def kept(logit, req) -> torch.Tensor:
    """The tokens the sampler's filters keep for ``req``'s knobs: top_k
    on the logits (parity) or top_p and top_k on the tempered ones."""
    from progen_tpu_torch.sampling import select_top_k, select_top_p

    if req.temperature == 1.0 and req.top_p is None:
        if req.top_k is None:
            return torch.ones_like(logit, dtype=torch.bool)
        return select_top_k(logit[None], req.top_k)[0][0]
    lt = logit / req.temperature
    keep = select_top_p(lt[None], req.top_p)[0]
    if req.top_k is not None:
        keep &= select_top_k(lt[None], req.top_k)[0][0]
    return keep


def perturbed_scores(logit, noise, req) -> torch.Tensor:
    """The scores whose argmax the sampler takes for ``req``'s knobs:
    the parity branch's (filtered tokens at 0) or the knob branch's."""
    keep = kept(logit, req)
    if req.temperature == 1.0 and req.top_p is None:
        return torch.where(keep, logit + noise, 0.0)
    return torch.where(keep, logit / req.temperature + noise, -torch.inf)


def redraw(logit, noise, req, p: int, pool: bool) -> tuple:
    """(the draw, the token written) of each decoder at position ``p``
    from ``logit`` and the stream's noise: the pool with the per-slot
    sampler, sample_fast with the static one; an infill's draw
    constrained as both do."""
    from progen_tpu_torch.sampling import (
        _TOP_P_OFF,
        _constrain,
        gumbel_step_dynamic,
        gumbel_topk_step,
    )

    parity = req.temperature == 1.0 and req.top_p is None
    top_p = _TOP_P_OFF if req.top_p is None else req.top_p
    if pool:
        def one(v, dtype):
            return torch.tensor([v], dtype=dtype, device=logit.device)
        draw = gumbel_step_dynamic(
            noise[None], logit[None], one(req.top_k or 0, torch.long),
            one(parity, torch.bool), one(req.temperature, torch.float32),
            one(top_p, torch.float32))
    else:
        draw = gumbel_topk_step(logit[None], req.top_k, noise[None], parity,
                                req.temperature, top_p)
    tok = draw
    if req.template is not None:
        infill = (torch.from_numpy(a).to(logit.device)[None]
                  for a in (req.template, req.frozen))
        tok = _constrain(draw, logit[None], torch.full_like(draw, p),
                         *infill)
    return int(draw[0]), int(tok[0])


def near_tie(req, got, want, ref_log, pool_log, p: int,
             bound: float) -> dict:
    """Phase 9's rule for a pool stream that differs from sample_fast's
    first at position ``p``. Each decoder's token there follows from its
    own logits and the stream's noise (so the difference lies in the
    logits); the two logits agree within ``bound`` (the generate
    check's); and the draw is at a near tie: the reference's top two
    perturbed scores within twice the logits' distance, or the filter's
    boundary moved, shown by the two logits keeping different sets under
    the request's top_k/top_p with a token drawn or written by either
    decoder among the ones that moved."""
    from progen_tpu_torch.sampling import seeded_noise

    start = len(req.prime) + req.add_bos
    ref, pool = ref_log[p - 1], pool_logits(pool_log, got, p)
    dist = (pool - ref).abs().max().item()
    noise = seeded_noise([req.seed], [p - start],
                         ref.shape[-1])[0].cuda()
    pool_draw, pool_tok = redraw(pool, noise, req, p, True)
    ref_draw, ref_tok = redraw(ref, noise, req, p, False)
    replays = bool(pool_tok == got[p] and ref_tok == want[p])
    top2 = perturbed_scores(ref, noise, req).topk(2).values
    top2_gap = (top2[0] - top2[1]).item()
    moved = kept(ref, req) ^ kept(pool, req)
    moved_ids = moved.nonzero().flatten().tolist()
    filter_moved = bool(set(moved_ids) & {pool_draw, ref_draw,
                                          int(got[p]), int(want[p])})
    by = ("top2" if top2_gap <= 2 * dist
          else "filter" if filter_moved else None)
    return dict(position=p, logit_distance=dist, bound=bound,
                top2_gap=top2_gap, moved=moved_ids,
                draws=[pool_draw, ref_draw], replays=replays, by=by,
                ok=bool(replays and dist <= bound and by is not None))


def check_embed(model, model32, req, vec) -> dict:
    """The embed vector against the plain path's and the float32 model's
    by the scoring check's rule: no further from the float32 one than
    twice the plain bfloat16 path."""
    from progen_tpu_torch.serving import ServeEngine

    vec = torch.from_numpy(vec)
    with plain_path():
        plain = torch.from_numpy(ServeEngine(model, max_slots=1).embed(
            req.prime, add_bos=True))
        ref32 = torch.from_numpy(ServeEngine(model32, max_slots=1).embed(
            req.prime, add_bos=True))
    e_k = (vec - ref32).abs().max().item()
    e_p = (plain - ref32).abs().max().item()
    if vec.shape != (model.config.dim,) or not e_k <= 2 * e_p + 1e-3:
        raise AssertionError(f"embed: kernel vs f32 {e_k}, plain vs f32 "
                             f"{e_p}, shape {tuple(vec.shape)}")
    return dict(embed_vs_f32=e_k, plain_vs_f32=e_p,
                embed_vs_plain=(vec - plain).abs().max().item())


def serve_cli_lines() -> list:
    return [json.dumps(r) for r in (
        {"id": "c1", "prime": PROTEINS[4][:8], "length": 40, "seed": 1},
        {"id": "c2", "prime": PROTEINS[5][:12], "length": 32, "seed": 2,
         "temperature": 0.8, "top_p": 0.95},
        {"id": "c3", "template": "M?K?A?Y?I?A?K?Q?R", "seed": 3},
        {"id": "c4", "prime": PROTEINS[7], "embed": True})]


def cli_serve(ck: Path, cwd: Path, *flags):
    """cli.serve in a child process on ``ck``, one card slot, lengths up
    to SERVE_MAX_LEN: the kernels it loads were built by this process."""
    return subprocess.Popen(
        [sys.executable, "-m", "progen_tpu_torch.cli.serve",
         "--checkpoint_path", str(ck), "--max-slots", "1", "--max-len",
         str(SERVE_MAX_LEN), *flags],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=cwd,
        env=dict(os.environ, PYTHONPATH=str(REPO)))


def finish(proc, stdin: str = "", timeout: int = 300):
    """Send ``stdin``, close it (EOF drains) and wait; (rc, events,
    stderr)."""
    out, err = proc.communicate(stdin, timeout=timeout)
    return proc.returncode, [json.loads(ln) for ln in out.splitlines()], err


def settled(events) -> list:
    return [ev["id"] for ev in events if ev["event"] in ("done",
                                                          "embedding")]


def token_streams(records, key: str = "id") -> dict:
    """id -> [tokens by index] from token lines or journal records."""
    out: dict = {}
    for ev in records:
        if ev.get("event", ev.get("op")) == "token":
            out.setdefault(ev[key], {})[ev["index"]] = ev["token"]
    return {k: [v[i] for i in sorted(v)] for k, v in out.items()}


def phase_serve_cli(model, engine_embed) -> dict:
    """Phase 9's cli.serve part: a checkpoint of the script's weights
    saved with the port's checkpoint.py; one run of three requests and an
    embedding, then EOF (exit 0, each id answered); one with
    --journal_dir SIGKILLed after its first tokens, then a --replay run:
    each accepted id settled exactly once over the two, and each stream
    in the journal over both lives bit-equal to the first run's (one
    slot, so every position is fed at batch 1 in both)."""
    import shutil
    import signal

    from progen_tpu_torch.checkpoint import Package, get_checkpoint_fns
    from progen_tpu_torch.training.optimizer import (
        MaskedAdamW,
        OptimizerConfig,
    )
    from progen_tpu_torch.training.state import TrainState

    work = REPO / "build" / "chip_smoke_serve"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        ck, jd = work / "ck", work / "journal"
        t = time.perf_counter()
        state = TrainState(0, model, MaskedAdamW(model, OptimizerConfig()))
        get_checkpoint_fns(str(ck))[2](Package(
            next_seq_index=0, state=state,
            model_config=model.config.to_dict(), run_id=None))
        save_s = time.perf_counter() - t
        del state
        lines = "".join(ln + "\n" for ln in serve_cli_lines())
        ids = ["c1", "c2", "c3", "c4"]

        # the uninterrupted run and the journaled one start together
        t = time.perf_counter()
        whole_proc = cli_serve(ck, work)
        whole_proc.stdin.write(lines)
        whole_proc.stdin.flush()
        proc = cli_serve(ck, work, "--journal_dir", str(jd))
        proc.stdin.write(lines)
        proc.stdin.flush()
        first, seen = [], 0
        while seen < CLI_KILL_AFTER:
            ln = proc.stdout.readline()
            if not ln:
                raise AssertionError("the journaled run ended early: "
                                     + proc.stderr.read()[-2000:])
            first.append(json.loads(ln))
            seen += first[-1]["event"] == "token"
        proc.send_signal(signal.SIGKILL)
        rest, _ = proc.communicate(timeout=60)
        first += [json.loads(ln) for ln in rest.splitlines()
                  if ln.endswith("}")]
        killed_rc = proc.returncode
        rc, whole, err = finish(whole_proc, "")
        if rc != 0 or sorted(settled(whole)) != ids:
            raise AssertionError(f"cli.serve: rc {rc}, settled "
                                 f"{settled(whole)}: {err[-2000:]}")
        load = [ln for ln in err.splitlines() if ln.startswith("serving:")]
        (emb,) = [ev for ev in whole if ev["event"] == "embedding"]
        d_emb = float(np.abs(np.array(emb["values"]) - engine_embed(
            PROTEINS[7])).max())
        if not d_emb <= 1e-6:  # the line rounds to 6 decimals
            raise AssertionError(f"cli.serve's embedding differs by {d_emb}")
        rc, second, err = finish(cli_serve(
            ck, work, "--journal_dir", str(jd), "--replay", str(jd)))
        both = settled(first) + settled(second)
        journal = [json.loads(ln) for ln in
                   (jd / "journal.jsonl").read_text().splitlines()
                   if ln.endswith("}")]
        resumed = token_streams(journal, key="req")
        want = token_streams(whole)
        if (killed_rc != -signal.SIGKILL or rc != 0
                or sorted(both) != ids or resumed != want):
            raise AssertionError(
                f"journal/replay: killed rc {killed_rc}, replay rc {rc}, "
                f"settled {both}, streams equal {resumed == want}: "
                f"{err[-2000:]}")
        return dict(checkpoint_save_s=save_s,
                    runs_s=time.perf_counter() - t, serving=load,
                    killed_after_tokens=seen, settled_before_kill=sorted(
                        settled(first)), replay=[ln for ln in err.splitlines()
                                                 if ln.startswith("replay:")],
                    resumed_equal=True, embed_distance=d_emb)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_serve(cfg, gen_bound: float, card: str) -> dict:
    """Phase 9: the serving engine at base.toml's widths in bfloat16 (see the
    module docstring), then cli.serve in child processes."""
    from progen_tpu_torch import ProGen
    from progen_tpu_torch.serving import PrefixCache, ServeEngine

    t_phase = time.perf_counter()
    model = ProGen(cfg, device="cuda", seed=0).eval()
    model32 = ProGen(dataclasses.replace(cfg, dtype="float32"),
                     device="cuda", seed=None).eval()
    model32.load_state_dict(model.state_dict())
    reqs = serve_requests()
    gens = [r for r in reqs if r.kind == "generate"]
    by_id = {r.id: r for r in reqs}

    cache = PrefixCache(SERVE_CACHE_MIB << 20)
    reset_counts()
    t = time.perf_counter()
    pool_log = []
    comps, sched = serve_run(model, reqs, SERVE_SLOTS, cache, pool_log)
    run_s = time.perf_counter() - t
    counts = launch_counts()
    snap = sched.metrics.snapshot()
    pool = sched.engine.slots
    pool_bytes = pool.cache.nbytes + sum(
        t.nbytes for t in (pool.seqs, pool.cur, pool.nz, pool.target,
                           pool.temp, pool.top_p, pool.top_k, pool.parity,
                           pool.live, pool.template, pool.frozen))
    del sched, pool

    bad = []
    if counts != per_forward(cfg):
        bad.append(f"the serve path launched {counts}, not one forward's "
                   f"{per_forward(cfg)}")
    parts = {"pool_run": run_s}  # seconds of each part of the phase
    t = time.perf_counter()
    refs = {r.id: reference_stream(model, r) for r in gens}
    parts["references"] = time.perf_counter() - t
    equal, ties = [], {}
    for r in gens:
        got, (want, ref_log) = comps[r.id].tokens, refs[r.id]
        if np.array_equal(got, want):
            equal.append(r.id)
            continue
        diff = np.flatnonzero(got != want)
        ties[r.id] = near_tie(r, got, want, ref_log, pool_log,
                              int(diff[0]), gen_bound)
        if not ties[r.id]["ok"]:
            bad.append(f"{r.id} differs from sample_fast at "
                       f"{diff.tolist()[:5]}: {ties[r.id]}")
    infill = by_id["infill"]
    if not np.array_equal(comps["infill"].tokens[infill.frozen],
                          infill.template[infill.frozen]):
        bad.append("the infill's frozen positions are not verbatim")
    if comps["occupant"].n_generated != 1:
        bad.append("the top_k = 1 occupant did not stop at its first draw")

    hit = by_id["scaffold1"]
    hit_tokens = snap["prefix_cache_hit_tokens"]
    fed = sum(len(r.prime) + r.add_bos - 1 for r in gens) - hit_tokens
    t = time.perf_counter()
    cold, _ = serve_run(model, [hit], SERVE_SLOTS)
    parts["cold_admission"] = time.perf_counter() - t
    if not np.array_equal(comps[hit.id].tokens, cold[hit.id].tokens):
        bad.append("the prefix-cache hit differs from the cold admission")
    if hit_tokens != SCAFFOLD or snap["prefill_tokens"] != fed:
        bad.append(f"prefix cache: {hit_tokens} positions hit (want "
                   f"{SCAFFOLD}), {snap['prefill_tokens']} fed (want {fed})")

    # one slot: every generate stream at batch 1, the occupant's slot
    # reused first by a request with knobs, then by each of the rest
    t = time.perf_counter()
    order = ["occupant", "knobs0"] + [r.id for r in gens
                                      if r.id not in ("occupant", "knobs0")]
    one, _ = serve_run(model, [by_id[i] for i in order], 1)
    parts["one_slot"] = time.perf_counter() - t
    one_equal = [i for i in order
                 if np.array_equal(one[i].tokens, refs[i][0])]
    if len(one_equal) != len(gens):
        bad.append(f"max_slots=1: only {one_equal} equal sample_fast")
    embed = check_embed(model, model32, by_id["embed"],
                        comps["embed"].embedding)
    if bad:
        raise AssertionError("serve: " + "; ".join(bad))
    del model32

    from progen_tpu_torch.data.tokenizer import encode_tokens

    t = time.perf_counter()
    engine1 = ServeEngine(model, max_slots=1)
    cli = phase_serve_cli(model, lambda s: engine1.embed(encode_tokens(s),
                                                         add_bos=True))
    parts["cli"] = time.perf_counter() - t
    steps = snap["decode_steps"]
    out = dict(
        card=card, requests=len(reqs), slots=SERVE_SLOTS,
        max_len=SERVE_MAX_LEN, run_s=run_s,
        decode_steps_per_s=steps / snap["decode_time_s"],
        decode_tokens_per_s=snap["decode_tokens_per_s"],
        decode_tokens=snap["decode_tokens"], decode_steps=steps,
        ttft_p50_s=snap["ttft_s_p50_s"], ttft_p99_s=snap["ttft_s_p99_s"],
        prefill_ms_per_token=snap["prefill_time_s"] * 1e3
        / snap["prefill_tokens"], prefill_tokens=snap["prefill_tokens"],
        prefix_hit_tokens=hit_tokens, embed_ms=snap["embed_time_s"] * 1e3,
        pool_bytes=pool_bytes, pool_bytes_per_slot=pool_bytes // SERVE_SLOTS,
        launches=counts, bit_equal=len(equal), streams=len(gens),
        near_ties=ties, slots1_bit_equal=len(one_equal), **embed, cli=cli,
        parts_s=parts, seconds=time.perf_counter() - t_phase)
    line("serve", **out)
    return out


# phase 10: the protein-design workloads, the reference converter and int8
# serving, at base.toml in bfloat16
WL_SEQS, WL_BATCH, WL_LONG = 64, 8, (1100, 1500)  # the scorer's FASTA
SCAN_LEN, SCAN_POSITIONS, SCAN_CHUNK = 200, 32, 32
SCAN_FIXED = [(0, "W"), (7, "P"), (19, "C"), (31, "G")]  # (position, aa)
# the scan's rows at batch 32 against the same mutant at batch 1: the two
# batches round the bfloat16 products otherwise (phase 9's one-slot rule)
SCAN_NLL_ATOL = 2e-2
# a workload's NLLs on the kernel path against the plain path: phase 3's
# scoring rule (measured 0.0023 nats at batch 8 on an H100)
NLL_PLAIN_ATOL = 1e-2
NW_DEPTH, NW_SHORT, NW_LONG = 6, (100, 400), (600, 1000)  # the n = w model
INT8_SLOTS, INT8_MAX_LEN, INT8_PARITY = 8, 256, 4
INT8_TIMED = 2  # timed runs of each engine, alternating


def write_candidates(path: Path, seed: int) -> tuple:
    """WL_SEQS proteins with Uniref50-style headers, lengths
    CLI_MIN_LEN..CLI_MAX_LEN, and the WL_LONG records too long for the
    model placed among them; returns (the ids in file order, the
    too-long ones)."""
    rng = np.random.default_rng(seed)
    aas = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    lengths = [int(rng.integers(CLI_MIN_LEN, CLI_MAX_LEN + 1))
               for _ in range(WL_SEQS)]
    at = (10, 40)  # where the too-long records go
    for i, n in zip(at, WL_LONG):
        lengths.insert(i, n)
    ids = []
    with path.open("w") as f:
        for i, n in enumerate(lengths):
            ids.append(f"UniRef50_B{i:07d}")
            seq = "".join(rng.choice(aas, n))
            f.write(f">{ids[-1]} Candidate protein n=1 Tax=Homo sapiens "
                    f"TaxID=9606 RepID=B{i:07d}_HUMAN\n")
            for k in range(0, n, 60):
                f.write(seq[k:k + 60] + "\n")
    return ids, [ids[i] for i in at]


def haiku_reference(sd: dict, cfg) -> dict:
    """The model's state dict as a reference (lucidrains/progen) Haiku
    params dict of numpy arrays: the inverse of the converter's mapping,
    kept here apart from the port. Haiku's ``w`` is (in, out), the
    transpose of the port's weight."""
    p = "pro_gen_base/~"

    def a(key, transpose=False):
        x = sd[key].detach().cpu().numpy()
        return np.ascontiguousarray(x.T) if transpose else x

    out = {f"{p}/embed": {"embeddings": a("embed")},
           f"{p}/layer_norm": {"scale": a("norm.scale")},
           f"{p}/linear": {"w": a("to_logits.weight", True),
                           "b": a("to_logits.bias")}}
    for i in range(cfg.depth):
        at, ff = f"attn.{i}.", f"ff.{i}."
        out[f"{p}/attn{i}/~/layer_norm"] = {"scale": a(at + "norm.scale")}
        out[f"{p}/attn{i}/~/linear"] = {"w": a(at + "to_qkv.weight", True)}
        out[f"{p}/attn{i}/~/linear_1"] = {"w": a(at + "to_out.weight", True),
                                          "b": a(at + "to_out.bias")}
        out[f"{p}/ff{i}/~/layer_norm"] = {"scale": a(ff + "norm.scale")}
        out[f"{p}/ff{i}/~/linear"] = {"w": a(ff + "proj_in.weight", True),
                                      "b": a(ff + "proj_in.bias")}
        out[f"{p}/ff{i}/~/linear_1"] = {"w": a(ff + "proj_out.weight", True),
                                        "b": a(ff + "proj_out.bias")}
        if ff + "sgu.spatial_weights" in sd:
            out[f"{p}/ff{i}/~/sgu"] = {
                "spatial_weights": a(ff + "sgu.spatial_weights"),
                "spatial_biases": a(ff + "sgu.spatial_biases")}
            out[f"{p}/ff{i}/~/sgu/~/layer_norm"] = {
                "scale": a(ff + "sgu.norm.scale")}
            out[f"{p}/ff{i}/~/sgu/~/linear"] = {
                "w": a(ff + "sgu.proj_out.weight", True),
                "b": a(ff + "sgu.proj_out.bias")}
    return out


def slice_shape_checks(cfg) -> dict:
    """A1, L1 and L2 against their plain versions at the shapes this phase
    gives them first: batch 32 at n = 1024 (the scan's chunk), and n = w =
    512 at batch 8 (the n = w bucket, one window whose previous window is
    the phantom zeros; no L2 there, the model has no gMLP layer). Outside
    the counted runs."""
    from progen_tpu_torch.ops import cuda_attention, cuda_layers

    dev, dt = torch.device("cuda"), cfg.compute_dtype
    gen = torch.Generator(device=dev).manual_seed(10)

    def randn(*shape, dtype=dt):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    out = {}
    eps, w, half = cfg.layer_norm_epsilon, cfg.window_size, \
        cfg.dim * cfg.ff_mult // 2
    for b, n in ((SCAN_CHUNK, cfg.seq_len), (WL_BATCH, w)):
        q, k, v = (randn(b, cfg.heads, n, cfg.dim_head) for _ in range(3))
        out[f"A1 b{b} n{n}"] = check_close(
            f"A1 at ({b}, {n})", cuda_attention.local_attention_fwd(
                q, k, v, w), cuda_attention.local_attention_fwd_reference(
                q, k, v, w), 1e-2, 1e-2)
        x = randn(b, n, cfg.dim) * 2 + 0.5
        scale = torch.rand(cfg.dim, generator=gen, device=dev) + 0.5
        out[f"L1 b{b} n{n}"] = check_close(
            f"L1 at ({b}, {n})", cuda_layers.norm_shift(x, scale, eps, dt),
            cuda_layers.norm_shift_reference(x, scale, eps, dt), 1e-2, 1e-2)
        del q, k, v, x
    b, n = SCAN_CHUNK, cfg.seq_len
    x, gate = randn(b, n, half), randn(b, n, half)
    wts = randn(n, n, dtype=torch.float32) / n ** 0.5
    bias = randn(n, 1, dtype=torch.float32)
    scale = torch.rand(half, generator=gen, device=dev) + 0.5
    out[f"L2 b{b} n{n}"] = check_close(
        f"L2 at ({b}, {n})",
        cuda_layers.sgu_mix_gate(x, gate, wts, bias, scale, eps, dt),
        cuda_layers.sgu_mix_gate_reference(x, gate, wts, bias, scale, eps,
                                           dt), 2e-2, 2e-2)
    return {k: {m: v[m] for m in ("max_abs_err", "worst_over_tolerance")}
            for k, v in out.items()}


def forwards(cfg, n: int) -> dict:
    """Launches of ``n`` full forwards of ``cfg``'s model."""
    return {k: n * v for k, v in per_forward(cfg).items()}


def shard_records(out_dir: Path) -> list:
    """Every whole line of the output shards, parsed, in shard order (a
    torn last line is left out)."""
    recs = []
    for shard in sorted(out_dir.glob("scores-*.jsonl")):
        for ln in shard.read_text().splitlines():
            try:
                recs.append(json.loads(ln))
            except ValueError:
                pass
    return recs


def convert_reference(model, work: Path) -> tuple:
    """Item 1: the model as a reference ckpt_*.pkl, converted by
    ``cli.convert`` in a child process; the checkpoint's parameters must
    be the model's, bit for bit."""
    import pickle

    from progen_tpu_torch.checkpoint import get_checkpoint_fns

    cfg = model.config
    src, ck = work / "ckpt_1700000000.pkl", work / "converted"
    t = time.perf_counter()
    with src.open("wb") as f:
        pickle.dump({"next_seq_index": 123456,
                     "params": haiku_reference(model.state_dict(), cfg),
                     "optim_state": None, "model_config": cfg.to_dict(),
                     "run_id": "reference-run"}, f, protocol=5)
    pickle_s = time.perf_counter() - t
    t = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "progen_tpu_torch.cli.convert", "--src",
         str(src), "--dest", str(ck)], capture_output=True, text=True,
        cwd=work, env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=600)
    convert_s = time.perf_counter() - t
    if res.returncode != 0:
        raise AssertionError(f"cli.convert: rc {res.returncode}: "
                             f"{res.stderr[-2000:]}")
    t = time.perf_counter()
    pkg = get_checkpoint_fns(str(ck))[1].restore_params(device="cuda")
    restore_s = time.perf_counter() - t
    bad = [k for k, v in model.state_dict().items()
           if not torch.equal(pkg.state[k], v)]
    if bad or (pkg.next_seq_index, pkg.run_id) != (123456, "reference-run") \
            or pkg.model_config != cfg.to_dict():
        raise AssertionError(f"the converted checkpoint differs: {bad[:5]}, "
                             f"{pkg.next_seq_index}, {pkg.run_id}")
    out = dict(pickle_bytes=src.stat().st_size, pickle_write_s=pickle_s,
               convert_child_s=convert_s, restore_params_s=restore_s,
               checkpoint_bytes=sum(f.stat().st_size
                                    for f in Path(pkg.path).iterdir()),
               printed=res.stdout.strip()[-200:], params_bit_equal=True)
    del pkg
    src.unlink()
    return ck, out


def score_in_process(model, fasta: Path, ids: list, long_ids: list,
                     out_dir: Path) -> tuple:
    """Item 2: run_batch_score in this process, counted; every record
    bit-equal to score_step on the same collated batch."""
    from progen_tpu_torch.data.dataset import collate as collate_raw
    from progen_tpu_torch.workloads.scoring import (
        fasta_records,
        run_batch_score,
        score_step,
    )

    cfg = model.config
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    summary = run_batch_score(model, fasta_records(str(fasta)), str(out_dir),
                              batch_size=WL_BATCH)
    run_s = time.perf_counter() - t
    counts = launch_counts()
    bad = []
    want = forwards(cfg, WL_SEQS // WL_BATCH)
    if counts != want:
        bad.append(f"the scorer launched {counts}, not {want}")
    journal = [json.loads(ln) for ln in
               (out_dir / "score_journal.jsonl").read_text().splitlines()]
    skipped = [r["id"] for r in journal if r["op"] == "skip"]
    if (summary["batches"], summary["n_scored"], skipped) != \
            (WL_SEQS // WL_BATCH, WL_SEQS, long_ids):
        bad.append(f"scored {summary['n_scored']} in {summary['batches']} "
                   f"batches, skipped {skipped}")
    recs = {r["id"]: r for r in shard_records(out_dir)}
    raw = dict(fasta_records(str(fasta)))
    scored = [i for i in ids if i not in long_ids]
    for b in range(0, len(scored), WL_BATCH):
        members = scored[b:b + WL_BATCH]
        nll, lp, mask = score_step(model, collate_raw(
            [raw[i] for i in members], cfg.seq_len), device="cuda")
        nll, lp, mask = nll.cpu().numpy(), lp.cpu().numpy(), \
            mask.cpu().numpy()
        for j, rid in enumerate(members):
            rec = recs.get(rid)
            if rec is None or rec["nll"] != float(nll[j]) or \
                    rec["logprobs"] != [float(x) for x in lp[j][mask[j]]]:
                bad.append(f"{rid} differs from score_step")
    if bad:
        raise AssertionError("batch score: " + "; ".join(bad[:5]))
    return recs, dict(
        summary=summary, run_s=run_s, launches=counts,
        sequences_per_s=WL_SEQS / run_s,
        tokens_per_s=summary["tokens"] / run_s,
        rows_bit_equal_score_step=len(recs))


def score_cli_kill_resume(ck: Path, fasta: Path, work: Path,
                          want: dict) -> dict:
    """Item 3: cli.batch_score in a child SIGKILLed after its second
    durable batch, then a child that resumes: every id once, each record
    bit-equal to the in-process run's."""
    import signal

    out_dir = work / "cli_scores"

    def child(chaos: str):
        t = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "progen_tpu_torch.cli.batch_score",
             "--checkpoint_path", str(ck), "--input", str(fasta),
             "--out_dir", str(out_dir), "--batch_size", str(WL_BATCH)],
            capture_output=True, text=True, cwd=work, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(REPO), PROGEN_CHAOS=chaos))
        return res, time.perf_counter() - t

    killed, killed_s = child("score/batch:kill@2")
    durable = len(shard_records(out_dir))
    done, done_s = child("")
    bad = []
    if killed.returncode != -signal.SIGKILL:
        bad.append(f"the killed child exited {killed.returncode}: "
                   f"{killed.stderr[-1000:]}")
    if done.returncode != 0:
        raise AssertionError(f"the resumed child exited {done.returncode}: "
                             f"{done.stderr[-2000:]}")
    summary = json.loads(done.stdout.strip().splitlines()[-1])
    recs = shard_records(out_dir)
    got_ids = [r["id"] for r in recs]
    if summary["n_resumed"] < 2 * WL_BATCH:
        bad.append(f"n_resumed {summary['n_resumed']}")
    if sorted(got_ids) != sorted(want) or len(got_ids) != len(set(got_ids)):
        bad.append(f"{len(got_ids)} records, {len(set(got_ids))} ids")
    differ = [r["id"] for r in recs if r != want.get(r["id"])]
    if differ:
        gap = max(abs(r["nll"] - want[r["id"]]["nll"]) for r in recs
                  if r["id"] in want)
        bad.append(f"{len(differ)} records differ from the in-process run "
                   f"(largest NLL gap {gap})")
    if bad:
        raise AssertionError("cli.batch_score: " + "; ".join(bad))
    return dict(killed_child_s=killed_s, resumed_child_s=done_s,
                durable_before_kill=durable, resumed_summary=summary,
                shards=sorted(p.name for p in out_dir.glob("scores-*")),
                records_bit_equal=len(recs))


def scan_in_process(model, sequence: str) -> dict:
    """Item 4: the scan at batch 32, counted; 8 mutants and the wild type
    against batch-1 references; the whole matrix against the plain
    path."""
    from progen_tpu_torch.workloads.mutagenesis import (
        AA_ALPHABET,
        mutagenesis_scan,
        reference_point_mutant_nll,
    )

    cfg = model.config
    positions = list(range(SCAN_POSITIONS))
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    report = mutagenesis_scan(model, sequence, positions=positions,
                              chunk=SCAN_CHUNK, top=20)
    scan_s = time.perf_counter() - t
    counts = launch_counts()
    rows = SCAN_POSITIONS * len(AA_ALPHABET) + 1
    n_fwd = -(-rows // SCAN_CHUNK)
    bad = []
    if counts != forwards(cfg, n_fwd):
        bad.append(f"the scan launched {counts}, not {forwards(cfg, n_fwd)}")
    picks = [(e["pos"], e["aa"]) for e in report["top"][:4]]
    picks += [(p, aa) for p, aa in SCAN_FIXED if aa != sequence[p]]
    gaps = {}
    for p, aa in picks:
        ref = reference_point_mutant_nll(model, sequence, position=p, aa=aa)
        gaps[f"{sequence[p]}{p}{aa}"] = abs(
            float(report["nll"][p, AA_ALPHABET.index(aa)]) - ref)
    gaps["wild type"] = abs(report["wt_nll"] - reference_point_mutant_nll(
        model, sequence, position=0, aa=sequence[0]))
    if max(gaps.values()) > SCAN_NLL_ATOL:
        bad.append(f"batch-1 references: {gaps}")
    t = time.perf_counter()
    with plain_path():
        plain = mutagenesis_scan(model, sequence, positions=positions,
                                 chunk=SCAN_CHUNK, top=0)
    plain_s = time.perf_counter() - t
    plain_gap = float(np.abs(report["nll"] - plain["nll"]).max())
    plain_wt_gap = abs(report["wt_nll"] - plain["wt_nll"])
    if max(plain_gap, plain_wt_gap) > NLL_PLAIN_ATOL:
        bad.append(f"plain path: matrix {plain_gap}, wild type "
                   f"{plain_wt_gap}")
    if not np.isfinite(report["nll"]).all():
        bad.append("non-finite NLLs")
    if bad:
        raise AssertionError("scan: " + "; ".join(bad))
    return dict(report=report, launches=counts, forwards=n_fwd, rows=rows,
                scan_s=scan_s, mutants_per_s=(rows - 1) / scan_s,
                reference_gaps=gaps, reference_atol=SCAN_NLL_ATOL,
                plain_gap=plain_gap, plain_wt_gap=plain_wt_gap,
                plain_atol=NLL_PLAIN_ATOL, plain_scan_s=plain_s,
                wt_nll=report["wt_nll"],
                top=[{k: e[k] for k in ("pos", "wt", "aa", "delta_nll")}
                     for e in report["top"][:4]])


def scan_cli(cfg, ck: Path, sequence: str, work: Path,
             want: np.ndarray) -> dict:
    """Item 5: cli.scan on the converted checkpoint, counted; its JSON's
    8 x 20 matrix within the scan's tolerance of item 4's."""
    from progen_tpu_torch.cli import scan as cli_scan

    out = work / "scan.json"
    reset_counts()
    t = time.perf_counter()
    cli_scan.run(["--checkpoint_path", str(ck), "--sequence", sequence,
                  "--positions", "0:8", "--top", "8", "--out", str(out)])
    run_s = time.perf_counter() - t
    counts = launch_counts()
    doc = json.loads(out.read_text())
    nll = np.asarray(doc["nll"])
    n_fwd = -(-(8 * 20 + 1) // SCAN_CHUNK)
    gap = float(np.abs(nll - want[:8]).max()) if nll.shape == (8, 20) \
        else float("inf")
    if nll.shape != (8, 20) or gap > SCAN_NLL_ATOL or len(doc["top"]) != 8 \
            or counts != forwards(cfg, n_fwd):
        raise AssertionError(f"cli.scan: shape {nll.shape}, gap {gap}, "
                             f"{len(doc['top'])} top rows, launched "
                             f"{counts}")
    return dict(launches=counts, forwards=n_fwd, run_s=run_s, gap=gap)


def score_n_equals_w(cfg, work: Path) -> dict:
    """Item 6: a pure-attention model at base widths (depth cut to
    NW_DEPTH) scores 8 short and 8 long records: the 512 bucket runs A1
    at n = w. Each batch's NLLs against the plain path."""
    from progen_tpu_torch import ProGen
    from progen_tpu_torch.data.dataset import collate as collate_raw
    from progen_tpu_torch.workloads.scoring import run_batch_score, score_step

    ncfg = dataclasses.replace(cfg, global_mlp_depth=0, depth=NW_DEPTH)
    model = ProGen(ncfg, device="cuda", seed=3).eval()
    rng = np.random.default_rng(3)
    aas = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    recs = []
    for i in range(WL_BATCH):
        for tag, (lo, hi) in (("s", NW_SHORT), ("l", NW_LONG)):
            seq = "".join(rng.choice(aas, int(rng.integers(lo, hi + 1))))
            recs.append((f"{tag}{i}", ("# " + seq).encode()))
    out_dir = work / "nw_scores"
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    summary = run_batch_score(model, recs, str(out_dir),
                              batch_size=WL_BATCH)
    run_s = time.perf_counter() - t
    counts = launch_counts()
    journal = [json.loads(ln) for ln in
               (out_dir / "score_journal.jsonl").read_text().splitlines()]
    buckets = [r["bucket"] for r in journal if r["op"] == "batch"]
    got = {r["id"]: r["nll"] for r in shard_records(out_dir)}
    gaps = {}
    for tag, bucket in (("s", ncfg.window_size), ("l", ncfg.seq_len)):
        members = [(rid, raw) for rid, raw in recs if rid[0] == tag]
        with plain_path():
            nll = score_step(model, collate_raw([r for _, r in members],
                                                bucket), device="cuda")[0]
        gaps[bucket] = max(abs(got[rid] - float(x)) for (rid, _), x
                           in zip(members, nll.cpu().numpy()))
    want = forwards(ncfg, 2)
    if counts != want or sorted(buckets) != [ncfg.window_size,
                                             ncfg.seq_len] \
            or max(gaps.values()) > NLL_PLAIN_ATOL:
        raise AssertionError(f"n = w: launched {counts} (want {want}), "
                             f"buckets {buckets}, plain gaps {gaps}")
    del model
    return dict(depth=NW_DEPTH, buckets=buckets, launches=counts,
                plain_gaps=gaps, run_s=run_s, summary=summary)


def int8_requests() -> list:
    """8 generate requests: primes of 4-11 tokens (each prime position is
    fed at batch 1, a host-bound step, so long primes would spend the
    phase on admission), lengths 64-92."""
    from progen_tpu_torch.data.tokenizer import encode_tokens
    from progen_tpu_torch.serving import Request

    return [Request(id=f"q{i}", prime=encode_tokens(
        PROTEINS[i][:4 + i]).astype(np.int64), length=64 + 4 * i,
        add_bos=True, seed=300 + i) for i in range(8)]


def int8_serving(model) -> dict:
    """Item 7: the int8 engine's calibration, its one-slot streams against
    sample_fast on the dequantised weights, and the int8 and bfloat16
    engines' decode rates at 8 slots, alternating."""
    from progen_tpu_torch import ProGen
    from progen_tpu_torch.ops.quant import dequantize_tree
    from progen_tpu_torch.sampling import sample_fast
    from progen_tpu_torch.serving import Scheduler, ServeEngine

    cfg = model.config
    t = time.perf_counter()
    engine = ServeEngine(model, max_slots=INT8_SLOTS, max_len=INT8_MAX_LEN,
                         quantize_int8=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    report = {k: v for k, v in engine.quant_report.items() if k != "leaves"}
    line("int8 calibration", **report)
    reqs = int8_requests()

    deq = ProGen(cfg, device="cuda", seed=None)
    deq.load_state_dict(dequantize_tree(engine._q_params, engine._q_scales,
                                        cfg.compute_dtype))
    deq.eval()
    t = time.perf_counter()
    one = Scheduler(ServeEngine(model, max_slots=1, max_len=INT8_MAX_LEN,
                                quantize_int8=True))
    for r in reqs[:INT8_PARITY]:
        one.submit(r)
    comps = {c.request_id: c.tokens
             for c in one.run_to_completion(max_steps=5000)[1]}
    del one
    equal = [r.id for r in reqs[:INT8_PARITY] if np.array_equal(
        comps[r.id], sample_fast(r.seed, deq, r.prime, r.length, top_k=25,
                                 add_bos=True, device="cuda").cpu().numpy())]
    parity_s = time.perf_counter() - t
    del deq
    if len(equal) != INT8_PARITY:
        raise AssertionError(f"int8 at one slot: only {equal} equal "
                             "sample_fast on the dequantised weights")

    bf16 = ServeEngine(model, max_slots=INT8_SLOTS, max_len=INT8_MAX_LEN)
    runs = {"bf16": [], "int8": []}
    t = time.perf_counter()
    for name in ["bf16", "int8", "int8", "bf16"] * (INT8_TIMED // 2):
        sched = Scheduler(engine if name == "int8" else bf16)
        for r in reqs:
            sched.submit(r)
        sched.run_to_completion(max_steps=5000)
        snap = sched.metrics.snapshot()
        runs[name].append(dict(
            decode_steps_per_s=snap["decode_steps"] / snap["decode_time_s"],
            decode_tokens_per_s=snap["decode_tokens_per_s"],
            decode_steps=snap["decode_steps"]))
    timed_s = time.perf_counter() - t
    return dict(calibration=report, build_s=build_s,
                quantized_device_bytes=engine.quantized_nbytes,
                slots1_bit_equal=len(equal), parity_s=parity_s, runs=runs,
                timed_s=timed_s)


# phase 10 runs at base.toml's widths with its depth cut to WL_DEPTH: at
# 24 layers its conversion and int8 serving took 111 of its 153 s (H100
# 80GB HBM3, 700 W)
WL_DEPTH = 6


def phase_workloads(cfg, score: dict, card: str) -> dict:
    """Phase 10: the workloads at base.toml's widths in bfloat16 (see the
    module docstring), in a directory under build/ removed afterwards."""
    import shutil

    from progen_tpu_torch import ProGen

    t_phase = time.perf_counter()
    work = REPO / "build" / "chip_smoke_workloads"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    parts = {}  # seconds of each part of the phase

    def part(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        parts[name] = time.perf_counter() - t
        return out

    try:
        shapes = part("kernel_checks", slice_shape_checks, cfg)
        model = ProGen(cfg, device="cuda", seed=0).eval()
        ck, converted = part("convert", convert_reference, model, work)
        fasta = work / "candidates.fasta"
        ids, long_ids = write_candidates(fasta, CLI_SEED + 1)
        recs, scored = part("score", score_in_process, model, fasta, ids,
                            long_ids, work / "scores")
        cli_score = part("score_cli", score_cli_kill_resume, ck, fasta, work,
                         recs)
        sequence = PROTEINS[6][:SCAN_LEN]
        scanned = part("scan", scan_in_process, model, sequence)
        report = scanned.pop("report")
        cli_scan = part("scan_cli", scan_cli, cfg, ck, sequence, work,
                        report["nll"])
        nw = part("n_equals_w", score_n_equals_w, cfg, work)
        int8 = part("int8", int8_serving, model)
        del model
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = {k: scored["launches"][k] + scanned["launches"][k]
                + cli_scan["launches"][k] + nw["launches"][k]
                for k in scored["launches"]}
    seconds = time.perf_counter() - t_phase
    out = dict(
        card=card, slice_shapes=shapes, convert=converted,
        score={k: v for k, v in scored.items() if k != "summary"},
        score_summary=scored["summary"],
        score_line_sequences_per_s=score["sequences_per_s"],
        score_cli=cli_score, scan=scanned, scan_cli=cli_scan,
        n_equals_w=nw, int8=int8, launches=launches, parts_s=parts,
        seconds=seconds, budget_s=180, over_budget=seconds > 180)
    line("workloads", **{k: v for k, v in out.items()
                         if k not in ("score_summary",)})
    return out


# phase 11: the grid: tensor parallelism at large.toml, the float32 form
# of the rule at base widths, ZeRO-1, GPipe and 1F1B, and cli.train
# --mesh_model 2, on GRID_RANKS ranks that share the card over gloo
GRID_RANKS, GRID_TIMEOUT = 2, 900  # seconds: the collectives, the join
TP_ACCUM, TP_MICRO = 2, 2  # large.toml's (2, 2, 1025) batch
# large.toml's widths and base.toml's for ZeRO-1, with the depth cut from
# 24 to 6 since slice 9: at 24, tensor parallelism took 111.9 s and
# ZeRO-1 26.7 s of the phase on a slow host (the script then ran 1,178 s)
TP_DEPTH, ZERO1_DEPTH = 6, 6
F32_DEPTH = 4  # the float32 rule's model: base widths, depth cut to 4
ZERO1_ACCUM, ZERO1_MICRO = 2, 4
PIPE_MICRO, PIPE_M = 8, 4  # (1, 8, 1025), 4 microbatches of 2 rows
PIPE_M_LONG = 2 * PIPE_M  # 1F1B's memory check: 8 microbatches of 1 row
PIPE_RUNS = ("gpipe", "1f1b", "1f1b_m8")
GRID_CLI_STEPS, GRID_CLI_BATCH = 3, 4  # batch 4 x 1, then 1 resumed step
GRID_CLI_DEPTH = 6  # base.toml's widths; at 24 the part ran 49-90 s
GRID_SAMPLE_TOKENS = 32  # the CLI's cadenced sample, cut from 1024
# the gradient cosine of a grid against one process in bfloat16. The
# pipelines compute every product whole, as one process does, and keep
# SEQPAR_COS. Tensor parallelism sums each row-parallel product's
# float32 halves and rounds once, which the H100's tensor cores round
# otherwise than one process's whole product: tools/tp_rounding.py, one
# process doing only that at large.toml, moves the gradients to a cosine
# of 0.99905 from the plain run (float32 is at 0.99719 from it). So there
# the cosine is held as the share rule holds the distances: 1 - cos no
# more than SEQPAR_SHARE_BF16 x bfloat16's own 1 - cos from float32
TP_COS_RULE = "share"


def large_config():
    from progen_tpu_torch import ProGenConfig, load_toml_config

    return ProGenConfig.from_dict(load_toml_config(
        str(REPO / "configs" / "model" / "large.toml")))


def tp_config():
    """Tensor parallelism's model: large.toml's widths at TP_DEPTH."""
    return dataclasses.replace(large_config(), depth=TP_DEPTH)


def grid_batch(cfg, accum: int, micro: int, seed: int) -> torch.Tensor:
    """(accum, micro, seq_len + 1) random tokens 1..255 from a numpy seed:
    no pad, so every position counts in the loss."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(1, cfg.num_tokens,
                                         (accum, micro, cfg.seq_len + 1)))


def large_rows(cfg, card: str, tc: dict) -> list:
    """A1, A2 and A3 at large.toml's shapes on a rank of the model axis,
    (2, 7, 1024, 128) at window 512 in bfloat16, against their plain
    versions at phase 2's tolerances, with times, the bound, SDPA's time
    and ptxas's spill bytes at d = 128 (reported; the build fails spills
    at d = 64 only); then L1 at (2, 1024, 1792) and L2 on whole rows at
    (2, 1024, 3584), against their plain versions."""
    import torch.nn.functional as F

    from progen_tpu_torch.ops import cuda_attention, cuda_layers

    dev, dt = torch.device("cuda"), cfg.compute_dtype
    gen = torch.Generator(device=dev).manual_seed(11)
    b, h, n, d, w = TP_MICRO, cfg.heads // GRID_RANKS, cfg.seq_len, \
        cfg.dim_head, cfg.window_size
    bh, esize = b * h, torch.finfo(dt).bits // 8

    def randn(*shape, dtype=dt):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def spills(kernel):
        return {k.split(": ")[0]: v["spill_bytes"] for k, v in tc.items()
                if f"{kernel}_tc_kernel<bfloat16, {d}>" in k}

    q, k, v, do = (randn(b, h, n, d) for _ in range(4))
    zeros = torch.zeros(b, h, w, d, dtype=dt, device=dev)
    i = torch.arange(n, device=dev)[:, None]
    j = torch.arange(n + w, device=dev)[None, :] - w
    mask = torch.where(j < 0, i < w,
                       (j <= i) & (i // w - j.clamp_min(0) // w <= 1))
    kp, vp = torch.cat([zeros, k], 2), torch.cat([zeros, v], 2)
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q, kp, vp, attn_mask=mask), iters=5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = F.scaled_dot_product_attention(
        leaves[0], torch.cat([zeros, leaves[1]], 2),
        torch.cat([zeros, leaves[2]], 2), attn_mask=mask)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                   retain_graph=True))
    del out, leaves, kp, vp
    pairs = visible_pairs(n, w) * bh
    rows = []
    got = cuda_attention.local_attention_fwd(q, k, v, w)
    want = cuda_attention.local_attention_fwd_reference(q, k, v, w)
    rows.append(dict(
        id="A1", name="local_attention_fwd", shape=[b, h, n, d], window=w,
        **check_close("A1 at large", got, want, 1e-2, 1e-2),
        **kernel_times(lambda: cuda_attention.local_attention_fwd(q, k, v,
                                                                  w)),
        plain_ms=time_ms(lambda: cuda_attention.local_attention_fwd_reference(
            q, k, v, w), iters=3),
        library_ms=sdpa_fwd,
        **bound_ms(4 * bh * n * d * esize, 2 * 2 * d * pairs, dt),
        spill_bytes=spills("fwd")))
    del got, want
    bnd = bound_ms(7 * bh * n * d * esize, 5 * 2 * d * pairs, dt)
    for rid, impl, kern in (("A2", "kv", ("rows", "kv")),
                            ("A3", "halo", ("rows", "halo"))):
        fn = getattr(cuda_attention, f"local_attention_bwd_{impl}")
        ref = getattr(cuda_attention, f"local_attention_bwd_{impl}_reference")
        errs = [check_close(f"{rid} {g} at large", a, c, 1e-2, 1e-2)
                for g, a, c in zip(("dq", "dk", "dv"), fn(q, k, v, do, w),
                                   ref(q, k, v, do, w))]
        rows.append(dict(
            id=rid, name=f"local_attention_bwd_{impl}", shape=[b, h, n, d],
            window=w, **max(errs, key=lambda e: e["worst_over_tolerance"]),
            **kernel_times(lambda: fn(q, k, v, do, w)),
            plain_ms=time_ms(lambda: ref(q, k, v, do, w), iters=3),
            library_ms=sdpa_bwd, **bnd,
            spill_bytes={kk: spills(kk) for kk in kern}))
    del q, k, v, do
    for r in rows:
        t = r["device_ms"] or r["ms"]
        r["share_of_bound"] = r["bound_ms"] / t
        line(f"kernel {r['id']} at large", **{k: r[k] for k in (
            "name", "shape", "max_abs_err", "worst_over_tolerance", "ms",
            "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "share_of_bound", "spill_bytes")}, card=card)
    eps, half = cfg.layer_norm_epsilon, cfg.dim * cfg.ff_mult // 2
    x = randn(b, n, cfg.dim) * 2 + 0.5
    scale = torch.rand(cfg.dim, generator=gen, device=dev) + 0.5
    checks = {"L1": check_close(
        "L1 at large", cuda_layers.norm_shift(x, scale, eps, dt),
        cuda_layers.norm_shift_reference(x, scale, eps, dt), 1e-2, 1e-2)}
    x, gate = randn(b, n, half), randn(b, n, half)
    wts = randn(n, n, dtype=torch.float32) / n ** 0.5
    bias = randn(n, 1, dtype=torch.float32)
    scale = torch.rand(half, generator=gen, device=dev) + 0.5
    checks["L2"] = check_close(
        "L2 at large",
        cuda_layers.sgu_mix_gate(x, gate, wts, bias, scale, eps, dt),
        cuda_layers.sgu_mix_gate_reference(x, gate, wts, bias, scale, eps,
                                           dt), 2e-2, 2e-2)
    del x, gate
    line("large shapes", **{k: {m: v[m] for m in ("max_abs_err",
                                                  "worst_over_tolerance")}
                            for k, v in checks.items()},
         L1_shape=[b, n, cfg.dim], L2_shape=[b, n, half])
    return rows


def local_tree(model) -> dict:
    return {n: p.detach() for n, p in model.named_parameters()}


def clone_tree(tree: dict) -> dict:
    return {n: t.detach().clone() for n, t in tree.items()}


def host_tree(tree: dict) -> dict:
    return {n: t.detach().to("cpu", copy=True) for n, t in tree.items()}


def steps_loss_rel(a: list, b: list) -> float:
    return max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
               for x, y in zip(a, b))


@contextlib.contextmanager
def timed_all_reduce(group, sink: list):
    """Host time of every all_reduce over ``group`` (the card synchronised
    before and after), appended to ``sink``."""
    real = torch.distributed.all_reduce

    def timed(t, *a, **kw):
        if kw.get("group") is not group:
            return real(t, *a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(t, *a, **kw)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out

    with mock.patch.object(torch.distributed, "all_reduce", timed):
        yield


def grid_run(state, step, batch, group=None) -> tuple:
    """GRID_STEPS (= SEQPAR_STEPS) timed steps on a grid state, each
    rank's launches counted per step; returns (record, the first step's
    gradients and the parameters' change, this rank's parts, and the
    initial parameters, this rank's part, all three on the host, so the
    window's peak counts the state and the step alone). With ``group``,
    the host time of its all_reduces per step."""
    p0 = host_tree(local_tree(state.model))
    sink = []
    with (timed_all_reduce(group, sink) if group is not None
          else contextlib.nullcontext()):
        run = timed_steps(step, state, batch)
    delta = {n: (p.float() - p0[n].to(p.device).float()).cpu()
             for n, p in local_tree(state.model).items()}
    grads = run.pop("grads")
    if group is not None:
        run["model_all_reduce_ms_per_step"] = sum(sink) * 1e3 / SEQPAR_STEPS
        run["model_all_reduces_per_step"] = len(sink) / SEQPAR_STEPS
    return run, grads, delta, p0


def whole_on_rank0(model, tree: dict, rank: int):
    """``tree`` (this rank's part, on the host or the card) gathered whole
    into rank 0's host memory, one tensor at a time (every rank of the
    model group calls this); None elsewhere."""
    tree = {n: t.to(model.device) for n, t in tree.items()}
    out = model.gather_tree(tree, device="cpu", keep=rank == 0)
    del tree
    torch.cuda.empty_cache()
    return out if rank == 0 else None


def single_run(cfg, sd0: dict, batch, rank: int) -> tuple:
    """Rank 0 alone: one process (no grid) takes the same steps from the
    whole initial parameters ``sd0``: (record, first step's gradients,
    the parameters' change)."""
    from progen_tpu_torch.training.step import (
        init_train_state,
        make_train_step,
    )

    assert rank == 0
    state = init_train_state(cfg, device="cuda", seed=None)
    state.model.load_state_dict(sd0)
    run = timed_steps(make_train_step(), state, batch)
    grads = run.pop("grads")
    delta = {n: (p.float() - sd0[n].to(p.device).float()).cpu()
             for n, p in local_tree(state.model).items()}
    del state
    torch.cuda.empty_cache()
    return run, grads, delta


def distances(got: tuple, want: tuple) -> dict:
    """Phase 7's three quantities of one run (steps, first gradients,
    change) against another: every step's loss, and the largest
    per-tensor relative distance (with the smallest cosine) of the
    gradients and of the change."""
    got_g, got_u, want_g, want_u = (
        {n: t.to("cuda") for n, t in tree.items()}
        for tree in (got[1], got[2], want[1], want[2]))  # once, not a pass
    g = max_rel(got_g, want_g)
    u = max_rel(got_u, want_u)
    cos = sorted((rel_cos(got_g[n], want_g[n])[1], n) for n in want_g)
    del got_g, got_u, want_g, want_u
    torch.cuda.empty_cache()
    return dict(loss=steps_loss_rel(got[0]["steps"], want[0]["steps"]),
                grads=g[0], grads_tensor=g[1], grads_min_cos=g[2],
                grads_min_cos_tensor=g[3], grads_lowest_cos=cos[:4],
                update=u[0], update_tensor=u[1], update_min_cos=u[2])


def judge(runs: dict, cfg, sd0, batch, rank: int, dtype: str,
          cos_rule: str = "absolute") -> dict:
    """Rank 0: each grid run of ``runs`` ({name: (record, whole first
    gradients, whole change)}, in ``dtype``) against one process taking
    the same steps in that dtype, by phase 7's rule: bfloat16 no further
    than bfloat16 is from float32 (SEQPAR_SHARE_BF16, and a gradient
    cosine of SEQPAR_COS, or with ``cos_rule`` "share" the floor that
    TP_COS_RULE's comment gives), float32 within SEQPAR_SHARE_F32 of it.
    Both single processes run here, one after the other, freed in
    between."""
    if rank != 0:
        return {}
    other = "f32" if dtype == "bf16" else "bf16"
    dtypes = {"bf16": "bfloat16", "f32": "float32"}
    single = single_run(dataclasses.replace(cfg, dtype=dtypes[dtype]), sd0,
                        batch, rank)
    out = {name: distances(r, single) for name, r in runs.items()}
    runs.clear()
    ref = single_run(dataclasses.replace(cfg, dtype=dtypes[other]), sd0,
                     batch, rank)
    own = distances(single, ref) if dtype == "bf16" else \
        distances(ref, single)
    share = SEQPAR_SHARE_BF16 if dtype == "bf16" else SEQPAR_SHARE_F32
    bad = []
    for name, d in out.items():
        for key in ("loss", "grads", "update"):
            if not d[key] <= share * own[key]:
                bad.append(f"{name} {key}: {d[key]} from the single "
                           f"process, over {share} x bfloat16's "
                           f"{own[key]} from float32")
        floor = SEQPAR_COS if cos_rule == "absolute" else \
            1 - SEQPAR_SHARE_BF16 * (1 - own["grads_min_cos"])
        if dtype == "bf16" and not d["grads_min_cos"] >= floor:
            bad.append(f"{name} gradient cosine {d['grads_min_cos']} < "
                       f"{floor}")
    return dict(vs_single=out, bf16_vs_f32=own, share=share,
                cos_rule=cos_rule,
                single_step_ms=single[0]["step_ms"],
                single_launches=single[0]["launches"],
                single_losses=[s["loss"] for s in single[0]["steps"]],
                bad=bad)


def tp_part(rank, grid, cfg, dtype: str, accum: int, micro: int,
            seed: int) -> dict:
    """Tensor parallelism: init_train_state on the grid (each rank draws
    the seeded model and keeps its shards), GRID_STEPS of
    make_train_step(grid), the whole first gradients, change and initial
    parameters gathered onto rank 0, which then holds them against one
    process by ``judge``."""
    from progen_tpu_torch.training.step import (
        init_train_state,
        make_train_step,
    )

    batch = grid_batch(cfg, accum, micro, seed).cuda()
    state = init_train_state(cfg, device="cuda", seed=0, grid=grid)
    run, grads, delta, p0 = grid_run(state, make_train_step(grid), batch,
                                     grid.model_group)
    model = state.model
    grads, delta, sd0 = (whole_on_rank0(model, t, rank)
                         for t in (grads, delta, p0))
    del state, model, p0
    torch.cuda.empty_cache()
    record = dict(steps=run["steps"], step_ms=run["step_ms"],
                  peak_memory_bytes=run["peak_memory_bytes"],
                  peak_growth_bytes=run["peak_growth_bytes"],
                  model_all_reduce_ms_per_step=run[
                      "model_all_reduce_ms_per_step"],
                  model_all_reduces_per_step=run[
                      "model_all_reduces_per_step"],
                  tokens_per_step=accum * micro * cfg.seq_len)
    record["judge"] = judge({"tp": (run, grads, delta)}, cfg, sd0, batch,
                            rank, dtype, cos_rule=TP_COS_RULE)
    del grads, delta, sd0
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    return record


def zero1_part(rank, grid, cfg) -> dict:
    """ZeRO-1 on data 2 x model 1: GRID_STEPS of make_train_step(grid)
    without and then with the moments cut over the data group, from the
    same parameters; the parameters must come out bit-equal."""
    from progen_tpu_torch.training.step import (
        init_train_state,
        make_train_step,
    )

    batch = grid_batch(cfg, ZERO1_ACCUM, ZERO1_MICRO, 12).cuda()
    runs, params = {}, {}
    p0 = None
    for cut in (False, True):
        state = init_train_state(cfg, device="cuda",
                                 seed=None if cut else 0, grid=grid,
                                 zero1=cut)
        if cut:
            state.model.load_state_dict(p0)
        else:
            p0 = host_tree(local_tree(state.model))
        run = timed_steps(make_train_step(grid), state, batch)
        run.pop("grads")
        opt = state.optimizer
        run["moment_bytes"] = sum(t.nbytes for t in list(opt.mu.values())
                                  + list(opt.nu.values()))
        run["moments_cut"] = sum(d is not None for d in opt.cut.values())
        runs[cut] = run
        params[cut] = host_tree(local_tree(state.model))
        del state, opt
        torch.cuda.empty_cache()
    differing = [n for n in params[False]
                 if not torch.equal(params[False][n], params[True][n])]
    del params, p0
    torch.cuda.empty_cache()
    return dict(steps=runs[True]["steps"], plain_steps=runs[False]["steps"],
                step_ms=runs[True]["step_ms"],
                plain_step_ms=runs[False]["step_ms"],
                moment_bytes=runs[True]["moment_bytes"],
                plain_moment_bytes=runs[False]["moment_bytes"],
                moments_cut=runs[True]["moments_cut"],
                peak_memory_bytes=runs[True]["peak_memory_bytes"],
                peak_growth_bytes=runs[True]["peak_growth_bytes"],
                tensors_differing=differing)


def pipe_per_step(cfg, stage: int, stages: int, schedule: str,
                  m: int = PIPE_M) -> dict:
    """Launches of one pipeline step (one micro-step of m microbatches)
    on ``stage``: its layers' forward kernels twice a microbatch with
    remat (1F1B's non-last stages three times: the forward slot without
    autograd, then the recompute with its remat), the kv backward once."""
    per = (cfg.depth - cfg.global_mlp_depth) // stages
    last = stage == stages - 1
    layers = per + (cfg.global_mlp_depth if last else 0)
    gmlp = cfg.global_mlp_depth if last else 0
    remat = 2 if cfg.remat else 1
    times = remat if (schedule == "gpipe" or last) else 1 + remat
    out = {k: 0 for k in per_forward(cfg)}
    out.update(A1=layers * m * times, A2=layers * m,
               L1=2 * layers * m * times, L2=gmlp * m * times)
    return out


def pipe_part(rank, grid, cfg) -> dict:
    """GPipe, then 1F1B, on 2 stages (11 uniform layers each) with M = 4
    on (1, 8, 1025), from the same initial parameters, each held against
    one process by phase 7's rule, and 1F1B's first gradients against
    GPipe's; then 1F1B again with M = 8 (PIPE_M_LONG), timed and counted
    only, for its memory: the schedule keeps O(stages) activations, so
    its peak growth must not rise with M."""
    from progen_tpu_torch.parallel.pipeline import (
        init_pipeline_state,
        make_pipeline_train_step,
    )
    from progen_tpu_torch.parallel.pipeline_1f1b import make_1f1b_train_step

    batch = grid_batch(cfg, 1, PIPE_MICRO, 13).cuda()
    runs, p0, sd0, record = {}, None, None, {}
    makers = (make_pipeline_train_step, make_1f1b_train_step,
              make_1f1b_train_step)
    for name, make, m in zip(PIPE_RUNS, makers,
                             (PIPE_M, PIPE_M, PIPE_M_LONG)):
        state = init_pipeline_state(cfg, device="cuda",
                                    seed=0 if p0 is None else None,
                                    grid=grid)
        if p0 is not None:
            state.model.load_state_dict(p0)
        run, grads, delta, p_init = grid_run(state, make(grid, m), batch)
        model = state.model
        if p0 is None:
            p0 = p_init
            sd0 = whole_on_rank0(model, p0, rank)
        if m == PIPE_M:
            runs[name] = (run, whole_on_rank0(model, grads, rank),
                          whole_on_rank0(model, delta, rank))
        record[name] = dict(steps=run["steps"], step_ms=run["step_ms"],
                            microbatches=m,
                            peak_memory_bytes=run["peak_memory_bytes"],
                            peak_growth_bytes=run["peak_growth_bytes"],
                            launches_per_step=pipe_per_step(
                                cfg, grid.model_index, grid.model,
                                "gpipe" if name == "gpipe" else "1f1b", m))
        del state, model, grads, delta
        torch.cuda.empty_cache()
    del p0
    if rank == 0:
        g = max_rel(runs["1f1b"][1], runs["gpipe"][1])
        record["1f1b_vs_gpipe_grads"] = dict(
            max_rel=g[0], max_rel_tensor=g[1], min_cos=g[2],
            bit_equal=sum(torch.equal(runs["1f1b"][1][n],
                                      runs["gpipe"][1][n])
                          for n in runs["gpipe"][1]),
            tensors=len(runs["gpipe"][1]))
    record["judge"] = judge(runs, cfg, sd0, batch, rank, "bf16")
    if rank == 0:
        own, g = record["judge"]["bf16_vs_f32"], \
            record["1f1b_vs_gpipe_grads"]
        if not (g["max_rel"] <= own["grads"] and g["min_cos"] >= SEQPAR_COS):
            record["judge"]["bad"].append(
                f"1F1B's first gradients off GPipe's: {g}")
        # the schedule's memory: stage 0's growth over the state, 1F1B's
        # at most GPipe's at M = PIPE_M and no higher at PIPE_M_LONG
        grow = {k: record[k]["peak_growth_bytes"]
                for k in PIPE_RUNS}
        if not (grow["1f1b"] <= grow["gpipe"]
                and grow["1f1b_m8"] <= grow["1f1b"]):
            record["judge"]["bad"].append(
                f"stage 0's peak growth: GPipe {grow['gpipe']} at M = "
                f"{PIPE_M}, 1F1B {grow['1f1b']} at M = {PIPE_M} and "
                f"{grow['1f1b_m8']} at M = {PIPE_M_LONG}")
    del sd0
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    return record


def grid_cli_args(work: Path, steps: int, batch: int) -> list:
    return ["--device", "cuda", "--wandb_off", "--mixed_precision",
            "--config_path", str(work / "model_cfg"),
            "--model_name", "base", "--data_path", str(work / "data"),
            "--checkpoint_path", str(work / "ckpts"), "--batch_size",
            str(batch), "--grad_accum_every", "1", "--checkpoint_every",
            "1000", "--validate_every", "1000", "--sample_every", "1000",
            "--seed", str(CLI_SEED), "--num_steps", str(steps)]


@contextlib.contextmanager
def short_samples(cli, tokens: int = GRID_SAMPLE_TOKENS):
    """A CLI module's sample_fast cut to ``tokens`` new tokens (the model
    decoding as ever; only the length cut, to save a phase ~40 s of a
    1024-token decode)."""
    real = cli.sample_fast

    def short(seed, model, prime, length, **kw):
        return real(seed, model, prime, len(prime) + 1 + tokens, **kw)

    with mock.patch.object(cli, "sample_fast", short):
        yield


def cli_part(rank, work: Path) -> dict:
    """cli.train --mesh_model 2 --dist_backend gloo --mixed_precision on
    this rank, in this process (the rank has joined the group, as under
    torchrun): GRID_CLI_STEPS steps and the final checkpoint; returns the
    steps, the launches of each and the sha256 of each of this rank's
    parameter shards."""
    import hashlib

    from progen_tpu_torch.cli import train as cli_train

    counts = []
    with mock.patch.object(cli_train, "make_train_step", counted_steps(
            cli_train.make_train_step, counts)), short_samples(cli_train):
        res = cli_train.run(grid_cli_args(work, GRID_CLI_STEPS,
                                          GRID_CLI_BATCH)
                            + ["--mesh_model", "2", "--dist_backend",
                               "gloo"])
    digests = {n: hashlib.sha256(t.detach().cpu().contiguous().view(
        torch.uint8).numpy().tobytes()).hexdigest()
        for n, t in res["state"].model.state_dict().items()}
    out = dict(steps=res["steps"], step_launches=counts,
               valid_losses=res["valid_losses"], samples=res["samples"],
               saves=res["saves"], next_seq_index=res["next_seq_index"],
               shard_sha256=digests)
    del res
    torch.cuda.empty_cache()
    return out


def grid_rank(rank: int, port: int, work: str) -> None:
    """One of the GRID_RANKS ranks of phase 11, spawned: joins the gloo
    group and runs every part in turn, writing its records."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(GRID_RANKS),
                      GLOO_SOCKET_IFNAME="lo")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from progen_tpu_torch import ProGenConfig, load_toml_config
    from progen_tpu_torch.parallel import (
        init_grid,
        initialize_distributed,
        tensor,
    )

    work = Path(work)
    initialize_distributed("gloo", timeout=GRID_TIMEOUT)
    base = ProGenConfig.from_dict(load_toml_config(
        str(REPO / "configs" / "model" / "base.toml")))
    tp = init_grid(1, 1, model=2)
    parts, rec = {}, {"rank": rank}

    def part(name, fn, *a):
        t = time.perf_counter()
        rec[name] = fn(*a)
        parts[name] = time.perf_counter() - t

    part("tp_large", tp_part, rank, tp, tp_config(), "bf16", TP_ACCUM,
         TP_MICRO, 14)
    rec["matmul_f32_route"] = {f"{d} {t}": r for (d, t), r in
                               tensor.MATMUL_F32_ROUTE.items()}
    part("tp_f32", tp_part, rank, tp,
         dataclasses.replace(base, depth=F32_DEPTH, dtype="float32"),
         "f32", TP_ACCUM, TP_MICRO, 15)
    part("zero1", zero1_part, rank, init_grid(2, 1, model=1),
         dataclasses.replace(base, depth=ZERO1_DEPTH))
    part("pipe", pipe_part, rank, init_grid(1, 1, model=2), base)
    part("cli", cli_part, rank, work)
    rec["parts_s"] = parts
    (work / f"rank{rank}.json").write_text(json.dumps(rec, default=float))
    torch.distributed.destroy_process_group()


def spawn_grid(work: Path) -> list:
    """Start the ranks, wait for them within GRID_TIMEOUT, kill any left;
    fail unless every rank exited 0. Their records, in rank order."""
    import torch.multiprocessing as mp

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=grid_rank, args=(r, port, str(work)))
             for r in range(GRID_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + GRID_TIMEOUT
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"grid ranks exited {codes}")
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(GRID_RANKS)]


def check_grid_checkpoint(cfg, work: Path, ranks: list) -> dict:
    """The coordinator's checkpoint holds the ranks' gathered parameters
    bit for bit: each rank's shards of it (convert.shard_state_dict) hash
    as the rank's own parameters did."""
    import hashlib

    from progen_tpu_torch.checkpoint import get_checkpoint_fns
    from progen_tpu_torch.convert import shard_state_dict

    pkg = get_checkpoint_fns(str(work / "ckpts"))[1].restore_params()
    differing = []
    for r in ranks:
        where = type("G", (), {"model": GRID_RANKS,
                               "model_index": r["rank"]})
        mine = shard_state_dict(pkg.state, cfg, where)
        for n, t in mine.items():
            digest = hashlib.sha256(t.contiguous().view(torch.uint8)
                                    .numpy().tobytes()).hexdigest()
            if digest != r["cli"]["shard_sha256"][n]:
                differing.append((r["rank"], n))
    return dict(path=pkg.path, tensors=len(pkg.state),
                differing=differing)


def resume_grid_cli(cfg, work: Path) -> dict:
    """The single-process cli.train resumes the grid's checkpoint for one
    step, its launches counted."""
    from progen_tpu_torch.cli import train as cli_train

    counts = []
    reset_counts()
    with mock.patch.object(cli_train, "make_train_step", counted_steps(
            cli_train.make_train_step, counts)), short_samples(cli_train):
        res = cli_train.run(grid_cli_args(work, 1, GRID_CLI_BATCH))
    out = dict(start_seq_index=res["start_seq_index"],
               step=res["state"].step, steps=res["steps"],
               step_launches=counts, launches=launch_counts())
    del res
    torch.cuda.empty_cache()
    return out


def phase_grid(base, card: str, tc: dict) -> dict:
    """Phase 11 (see the module docstring)."""
    import shutil

    from progen_tpu_torch.cli import generate_data

    t_phase = time.perf_counter()
    large = large_config()
    parts = {}
    t = time.perf_counter()
    rows = large_rows(large, card, tc)
    parts["large_kernels"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    work = REPO / "build" / "chip_smoke_grid"
    shutil.rmtree(work, ignore_errors=True)
    (work / "data_cfg").mkdir(parents=True)
    (work / "model_cfg").mkdir()
    cut_model_toml(work / "model_cfg" / "base.toml", GRID_CLI_DEPTH)
    clicfg = dataclasses.replace(base, depth=GRID_CLI_DEPTH)
    try:
        t = time.perf_counter()
        fasta = work / "uniref50_synthetic.fasta"
        write_fasta(fasta, CLI_SEED)
        (work / "data_cfg" / "synthetic.toml").write_text(DATA_TOML.format(
            fasta=fasta, out=work / "data", n=CLI_SEQS))
        generate_data.run(["--data_dir", str(work / "data_cfg"), "--name",
                           "synthetic", "--seed", str(CLI_SEED)])
        parts["etl"] = time.perf_counter() - t
        t = time.perf_counter()
        ranks = spawn_grid(work)
        parts["ranks"] = time.perf_counter() - t
        t = time.perf_counter()
        ckpt = check_grid_checkpoint(clicfg, work, ranks)
        resumed = resume_grid_cli(clicfg, work)
        parts["resume"] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)

    bad = []
    tpcfg = tp_config()
    want_tp = per_step(tpcfg, accum=TP_ACCUM)
    f32cfg = dataclasses.replace(base, depth=F32_DEPTH)
    want = {"tp_large": want_tp,
            "tp_f32": per_step(f32cfg, accum=TP_ACCUM),
            "zero1": per_step(dataclasses.replace(base, depth=ZERO1_DEPTH),
                              accum=ZERO1_ACCUM)}
    for r in ranks:
        for key, w in want.items():
            for i, st in enumerate(r[key]["steps"]):
                if st["launches"] != w:
                    bad.append(f"rank {r['rank']} {key} step {i + 1} "
                               f"launched {st['launches']}, not {w}")
                if not np.isfinite(st["loss"]) or st["skipped"]:
                    bad.append(f"rank {r['rank']} {key} step {i + 1}: {st}")
        for name in PIPE_RUNS:
            w = r["pipe"][name]["launches_per_step"]
            for i, st in enumerate(r["pipe"][name]["steps"]):
                if st["launches"] != w:
                    bad.append(f"rank {r['rank']} {name} step {i + 1} "
                               f"launched {st['launches']}, not {w}")
                if not np.isfinite(st["loss"]):
                    bad.append(f"rank {r['rank']} {name} step {i + 1}: {st}")
        z = r["zero1"]
        if z["tensors_differing"]:
            bad.append(f"rank {r['rank']} ZeRO-1 parameters differ: "
                       f"{z['tensors_differing'][:5]}")
        if not z["moment_bytes"] < 0.55 * z["plain_moment_bytes"]:
            bad.append(f"rank {r['rank']} ZeRO-1 moments {z['moment_bytes']}"
                       f" of {z['plain_moment_bytes']} bytes")
        cli = r["cli"]
        if [c for c in cli["step_launches"]
                if c != per_step(clicfg, accum=1)]:
            bad.append(f"rank {r['rank']} cli launches "
                       f"{cli['step_launches']}")
        if len(cli["steps"]) != GRID_CLI_STEPS or not all(
                np.isfinite(s["loss"]) and s["skipped"] == 0
                for s in cli["steps"]):
            bad.append(f"rank {r['rank']} cli steps {cli['steps']}")
    for key in ("tp_large", "tp_f32"):
        bad += ranks[0][key]["judge"]["bad"]
    bad += ranks[0]["pipe"]["judge"]["bad"]
    if len(ranks[0]["cli"]["samples"]) != 1 or ranks[1]["cli"]["samples"]:
        bad.append("only the coordinator samples, once")
    if ckpt["differing"]:
        bad.append(f"the checkpoint's shards differ from the ranks' "
                   f"parameters: {ckpt['differing'][:5]}")
    cursor = GRID_CLI_STEPS * GRID_CLI_BATCH
    if (resumed["start_seq_index"], resumed["step"]) != \
            (cursor, GRID_CLI_STEPS + 1) or resumed["step_launches"] != \
            [per_step(clicfg, accum=1)] or not all(
            np.isfinite(s["loss"]) for s in resumed["steps"]):
        bad.append(f"the single-process resume: {resumed}")

    tp = [r["tp_large"] for r in ranks]
    tokens = tp[0]["tokens_per_step"]
    out = dict(
        card=card, large_rows=rows, ranks=GRID_RANKS, backend="gloo",
        matmul_f32_route=ranks[0]["matmul_f32_route"],
        tp_large=dict(
            config=f"configs/model/large.toml widths, depth {TP_DEPTH}",
            grid=[1, 1, 2],
            batch=[TP_ACCUM, TP_MICRO, large.seq_len + 1],
            num_params=tpcfg.num_params(),
            launches_per_step_and_rank=want_tp,
            step_ms_per_rank=[r["step_ms"] for r in tp],
            tokens_per_s=tokens / (max(r["step_ms"] for r in tp) / 1e3),
            model_all_reduce_ms_per_step=[
                r["model_all_reduce_ms_per_step"] for r in tp],
            model_all_reduces_per_step=tp[0]["model_all_reduces_per_step"],
            peak_memory_bytes_per_rank=[r["peak_memory_bytes"] for r in tp],
            peak_growth_bytes_per_rank=[r["peak_growth_bytes"] for r in tp],
            losses=[s["loss"] for s in tp[0]["steps"]],
            **{k: v for k, v in ranks[0]["tp_large"]["judge"].items()
               if k != "bad"}),
        tp_f32=dict(config=f"base.toml widths, depth {F32_DEPTH}, float32",
                    step_ms_per_rank=[r["tp_f32"]["step_ms"] for r in ranks],
                    **{k: v for k, v in ranks[0]["tp_f32"]["judge"].items()
                       if k != "bad"}),
        zero1=dict(grid=[2, 1, 1], depth=ZERO1_DEPTH,
                   batch=[ZERO1_ACCUM, ZERO1_MICRO, base.seq_len + 1],
                   **{k: [r["zero1"][k] for r in ranks] for k in (
                       "step_ms", "plain_step_ms", "moment_bytes",
                       "plain_moment_bytes", "moments_cut",
                       "peak_memory_bytes", "peak_growth_bytes")},
                   losses=[s["loss"] for s in ranks[0]["zero1"]["steps"]],
                   parameters_bit_equal=not any(
                       r["zero1"]["tensors_differing"] for r in ranks)),
        pipe=dict(stages=2, microbatches=PIPE_M,
                  batch=[1, PIPE_MICRO, base.seq_len + 1],
                  **{name: dict(
                      step_ms_per_stage=[r["pipe"][name]["step_ms"]
                                         for r in ranks],
                      launches_per_step_and_stage=[
                          r["pipe"][name]["launches_per_step"]
                          for r in ranks],
                      peak_memory_bytes_per_stage=[
                          r["pipe"][name]["peak_memory_bytes"]
                          for r in ranks],
                      peak_growth_bytes_per_stage=[
                          r["pipe"][name]["peak_growth_bytes"]
                          for r in ranks],
                      microbatches=ranks[0]["pipe"][name]["microbatches"],
                      losses=[s["loss"] for s in
                              ranks[0]["pipe"][name]["steps"]])
                     for name in PIPE_RUNS},
                  f1b_vs_gpipe_grads=ranks[0]["pipe"]["1f1b_vs_gpipe_grads"],
                  **{k: v for k, v in ranks[0]["pipe"]["judge"].items()
                     if k != "bad"}),
        cli=dict(depth=GRID_CLI_DEPTH,
                 steps=[{k: s[k] for k in ("step", "loss", "ms",
                                           "tokens_per_s")}
                        for s in ranks[0]["cli"]["steps"]],
                 checkpoint=ckpt, resumed=resumed,
                 save_s=[s["seconds"] for s in ranks[0]["cli"]["saves"]]),
        parts_s=parts, rank_parts_s=[r["parts_s"] for r in ranks],
        seconds=time.perf_counter() - t_phase, budget_s=300)
    line("grid", **{k: v for k, v in out.items() if k != "large_rows"})
    if bad:
        raise AssertionError("grid: " + "; ".join(bad))
    launches = {k: sum(st["launches"][k] for r in ranks
                       for key in ("tp_large", "tp_f32", "zero1")
                       for st in r[key]["steps"])
                + sum(st["launches"][k] for r in ranks
                      for name in PIPE_RUNS
                      for st in r["pipe"][name]["steps"])
                + sum(c[k] for r in ranks for c in r["cli"]["step_launches"])
                + resumed["launches"][k]
                for k in per_forward(base)}
    return dict(out, launches=launches)


# phase 12: cli.train's telemetry and resilience at base.toml, whole
# the rollback (steps 1-3 poisoned), --profile_dir's window (steps 2-6:
# the rollback holds the loop's index) and the profile pin's window, which
# opens once that one has closed (step 7) and covers steps 8-9
RES_STEPS = 9
RES_CHAOS = "train/loss:nan@3"  # the JAX package's rollback test's spec
RES_MFU_RTOL = 0.01
# base.toml's widths, depth cut to RES_DEPTH since slice 9: at 24 layers
# the phase took 160.9-176.6 s and, with phase 13, the script 1,044 s of
# its 1,200 s on an H100 80GB HBM3 at 700 W
RES_DEPTH = 6


# the child runs cli.train's main with wandb blocked (the card's machine
# has wandb installed and no login, and the JSON-lines tracker writes the
# events.jsonl the beacon and profile checks read) and its cadenced sample
# cut to RES_SAMPLE_TOKENS new tokens, as phase 8's (since slice 10: the
# step-0 sample decoded 1,024 tokens in ~14 s of the phase)
RES_SAMPLE_TOKENS = 32
TRAIN_CHILD = (
    "import sys; sys.modules['wandb'] = None\n"
    "from progen_tpu_torch.cli import train\n"
    "real = train.sample_fast\n"
    "def short(seed, model, prime, length, **kw):\n"
    f"    return real(seed, model, prime, len(prime) + 1 + {RES_SAMPLE_TOKENS},"
    " **kw)\n"
    "train.sample_fast = short\n"
    "sys.exit(train.main(sys.argv[1:]))\n")
RES_WINDOW_S = 1.0  # the profile pin's window


def resilience_cli(work: Path, data: Path) -> dict:
    """cli.train in a child process at base.toml's widths (depth
    RES_DEPTH, the TOML in work/model_cfg) with every flag of the slice on
    and PROGEN_CHAOS=RES_CHAOS; once its log shows step 2 this process
    writes its profile pin, asking for a RES_WINDOW_S window. Its output,
    exposition, profile directory, flight dumps, pin and events."""
    from progen_tpu_torch.telemetry import flight

    ck, prof, prom = work / "ckpts", work / "profile", work / "train.prom"
    pin = work / "pin" / "profile.pin"
    args = [sys.executable, "-c", TRAIN_CHILD,
            "--device", "cuda", "--mixed_precision",
            "--config_path", str(work / "model_cfg"),
            "--model_name", "base", "--data_path", str(data),
            "--checkpoint_path", str(ck), "--batch_size", str(TRAIN_MICRO),
            "--grad_accum_every", str(TRAIN_ACCUM), "--checkpoint_every",
            "3", "--validate_every", "1000", "--sample_every", "1000",
            "--checkpoint_keep_n", "2", "--num_steps", str(RES_STEPS),
            "--seed", str(CLI_SEED), "--async_checkpoint",
            "--prom_file", str(prom), "--profile_dir", str(prof),
            "--stall_timeout", "300", "--stall_escalate_after", "2",
            "--anomaly_patience", "3", "--flight_dir", str(work / "flight"),
            "--profile_pin", str(pin)]
    t = time.perf_counter()
    lines, token = [], None
    child = subprocess.Popen(args, cwd=work, stdout=subprocess.PIPE,
                             stderr=open(work / "train.err", "w"), text=True,
                             env=dict(os.environ, PYTHONPATH=str(REPO),
                                      PROGEN_CHAOS=RES_CHAOS))
    reader = start_reader(child.stdout, lines)
    try:
        wait_for(lambda: any(re.match(r"^\[\S+ step 2\]", ln)
                             for _, ln in list(lines)),
                 "cli.train's step 2", [child], timeout=600)
        token = flight.request_profile(pin, duration_s=RES_WINDOW_S)
        rc = child.wait(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    reader.join(60)
    seconds = time.perf_counter() - t
    text = prom.read_text() if prom.exists() else ""
    samples = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^}]*\})?) (\S+)(?: #.*)?$", text,
        re.M)}
    ack = Path(str(pin) + ".ack")
    return dict(rc=rc, stdout="\n".join(ln for _, ln in lines) + "\n",
                stderr=log_text(work / "train.err"), seconds=seconds,
                prom=samples,
                traces=sorted(prof.glob("*.json")) if prof.is_dir() else [],
                ckpt=ck, dumps=flight.find_dumps(work / "flight"),
                token=token, ack=json.loads(ack.read_text())
                if ack.exists() else None,
                windows=sorted((pin.parent / "profiles").glob(
                    "*/*.pt.trace.json")),
                events=[r for p in work.glob(
                    "runs/progen-training/*/events.jsonl") for r in jsonl(p)])


def check_resilience_cli(cfg, run: dict) -> tuple:
    """The child run's checks (Part 2 of the slice); (bad, summary)."""
    from progen_tpu_torch.checkpoint import get_checkpoint_fns
    from progen_tpu_torch.profiling import flops_per_token

    bad, prom, out = [], run["prom"], run["stdout"]
    if run["rc"] != 0:
        bad.append(f"cli.train exited {run['rc']}: {run['stderr'][-2000:]}")
    rollbacks = re.findall(
        r"^\[\S+ step (\d+)\] anomaly rollback (\d+)/3: restored checkpoint "
        r"\(state step (\d+)\), data skipped ahead to sequence (\d+)", out,
        re.M)
    if [r[1] for r in rollbacks] != ["1"]:
        bad.append(f"rollbacks logged: {rollbacks} (want one, "
                   "'anomaly rollback 1/3')")
    goodput = {k[len("progen_train_"):]: v for k, v in prom.items()
               if k.startswith("progen_train_bucket_s_")
               or k in ("progen_train_wall_s", "progen_train_goodput_pct",
                        "progen_train_coverage_pct")}
    share = (100.0 * sum(v for k, v in goodput.items()
                         if k.startswith("bucket_s_"))
             / goodput["wall_s"]) if "wall_s" in goodput else 0.0
    if not abs(share - 100.0) <= 0.5:
        bad.append(f"goodput buckets sum to {share}% of the wall clock")
    for name in ("progen_train_goodput_pct", "progen_train_mfu",
                 "progen_train_hbm_in_use_gb"):
        if name not in prom:
            bad.append(f"the exposition lacks {name}")
    if not prom.get("progen_train_anomaly_rollbacks_total", 0) > 0:
        bad.append("the exposition's anomaly_rollbacks_total is not > 0")
    fpt = flops_per_token(cfg)
    tps = prom.get("progen_train_tokens_per_sec_per_chip", 0.0)
    mfu = prom.get("progen_train_mfu", -1.0)
    want = tps * fpt / PEAK_OPS[torch.bfloat16]
    if not (0 < mfu <= 1 and abs(mfu - want) <= RES_MFU_RTOL * want):
        bad.append(f"mfu {mfu}, recomputed from {tps} tokens/s {want}")
    trace_bytes = 0
    if run["traces"]:
        text = run["traces"][-1].read_text()
        trace_bytes = len(text)
        for name in ("fwd_tc_kernel", '"train/step"'):
            if name not in text:
                bad.append(f"the profile trace does not name {name}")
        del text
    else:
        bad.append("no profile trace")
    # the final checkpoint: restored (its manifest verified), its cursor
    # the rollback's plus one effective batch per step trained after it
    losses = {int(st): float(v) for st, v in re.findall(
        r"^\[\S+ step (\d+)\] loss: (\S+)$", out, re.M)}
    t = time.perf_counter()
    pkg = get_checkpoint_fns(str(run["ckpt"]))[1](device="cpu")
    restore_s = time.perf_counter() - t
    if pkg is None:
        bad.append("no final checkpoint restores")
    elif rollbacks:
        step_at, _, restored, cursor = map(int, rollbacks[0])
        after = sum(st > step_at for st in losses)
        want_ck = (cursor + TRAIN_ACCUM * TRAIN_MICRO * after,
                   restored + after)
        got = (pkg.next_seq_index, pkg.state["step"])
        if got != want_ck:
            bad.append(f"the final checkpoint {pkg.path}: (cursor, step) "
                       f"{got}, not {want_ck}")
    profile_s = [float(x) for x in re.findall(
        r"^profile: .* \(([0-9.]+) s\)$", out, re.M)]
    # the flight recorder, the profile pin, the clock beacons
    from progen_tpu_torch.telemetry import flight

    reasons = []
    for p in run["dumps"]:
        try:
            reasons.append(flight.verify_dump(p)["reason"])
        except ValueError as e:
            bad.append(f"a flight dump does not verify: {e}")
    if "anomaly_rollback" not in reasons:
        bad.append(f"no sealed anomaly_rollback dump: {reasons}")
    evs = run["events"]
    window = [r for r in evs if r.get("ev") == "profile"]
    if [r["op"] for r in window] != ["started", "stopped"] or \
            (run["ack"] or {}).get("status") != "stopped" or \
            run["ack"].get("pin") != run["token"]:
        bad.append(f"the pin's window: {window}, ack {run['ack']}")
    window_kernels = (trace_kernel_counts(run["windows"][-1], TRAIN_KERNELS)
                      if run["windows"] else {})
    if not (window_kernels.get("fwd_tc_kernel")
            and (window_kernels.get("rows_tc_kernel")
                 or window_kernels.get("kv_tc_kernel"))
            and window_kernels.get("norm_shift_kernel")
            and window_kernels.get("sgu_mix_tc_kernel")):
        bad.append(f"the pin's window trace names {window_kernels}")
    beacons = [r["step"] for r in evs if r.get("ev") == "clock_beacon"]
    if beacons != list(range(1, RES_STEPS + 1)):
        bad.append(f"clock beacons at steps {beacons}, not one a step")
    summary = dict(
        seconds=run["seconds"], goodput=goodput, goodput_sum_pct=share,
        tokens_per_sec_per_chip=tps, mfu=mfu,
        step_ms_p50=1e3 * prom.get('progen_train_step_seconds{quantile='
                                   '"0.5"}', float("nan")),
        hbm={k: v for k, v in prom.items() if "_hbm_" in k},
        counters={k: v for k, v in prom.items() if k.endswith("_total")},
        losses=losses, rollback=rollbacks[0] if rollbacks else None,
        profile_s=profile_s[0] if profile_s else None,
        trace_bytes=trace_bytes, final_checkpoint=pkg and pkg.path,
        final_restore_s=restore_s, flops_per_token=fpt,
        flight_dumps=[dict(reason=r, bytes=p.stat().st_size)
                      for r, p in zip(reasons, run["dumps"])],
        pin_window_s=window[-1].get("duration_s") if window else None,
        pin_window_export_s=window[-1].get("export_s") if window else None,
        pin_window_bytes=run["windows"][-1].stat().st_size
        if run["windows"] else None,
        pin_window_kernels=window_kernels, clock_beacons=len(beacons))
    del pkg
    return bad, summary


def async_against_blocking(cfg, work: Path) -> dict:
    """In this process, at ``cfg``: a blocking save of a state, then an
    asynchronous save of it, one train step on it (which updates its
    tensors in place, launches counted), then the asynchronous save
    finalized: its files must hash as the blocking save's. The seconds
    the train loop loses to each."""
    from progen_tpu_torch.checkpoint import Package, get_checkpoint_fns
    from progen_tpu_torch.training.step import (
        init_train_state,
        make_train_step,
    )

    state = init_train_state(cfg, device="cuda", seed=0)
    step = make_train_step()
    batch = train_batch(cfg)
    step(state, batch)  # moments that are not all zero
    torch.cuda.synchronize()
    _, _, blocking = get_checkpoint_fns(str(work / "blocking"))
    _, _, background = get_checkpoint_fns(str(work / "async"),
                                          async_save=True)

    def package():
        return Package(next_seq_index=16, state=state,
                       model_config=cfg.to_dict(), run_id="r",
                       train_config=None)

    t = time.perf_counter()
    b_path = Path(blocking(package()))
    out = {"blocking_s": time.perf_counter() - t}
    t = time.perf_counter()
    a_path = Path(background(package()))
    # the loop's loss: the copy to host buffers (their first allocation
    # included; the child's later saves reuse theirs)
    out["async_s"] = time.perf_counter() - t
    reset_counts()
    t = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    out["step_during_write_ms"] = (time.perf_counter() - t) * 1e3
    out["launches"] = launch_counts()
    t = time.perf_counter()
    background.flush()
    out["finalize_wait_s"] = time.perf_counter() - t
    # each meta.json's manifest holds its files' sizes and sha256, taken
    # from the bytes on disk by the save (the restore walk verifies them)
    b_man, a_man = (json.loads((p / "meta.json").read_text())["integrity"]
                    for p in (b_path, a_path))
    out["files"] = {f: (b_man[f][1], a_man[f][1]) for f in b_man}
    out["bytes"] = sum(size for size, _ in b_man.values())
    out["bit_equal"] = b_man == a_man
    del state, blocking, background
    torch.cuda.empty_cache()
    return out


def phase_resilience(cfg, card: str, result: dict) -> dict:
    """Phase 12 (see the module docstring)."""
    import shutil

    from progen_tpu_torch.cli import generate_data
    from progen_tpu_torch.telemetry import hbm_gauges

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg, depth=RES_DEPTH)
    work = REPO / "build" / "chip_smoke_resilience"
    shutil.rmtree(work, ignore_errors=True)
    (work / "data_cfg").mkdir(parents=True)
    (work / "model_cfg").mkdir()
    cut_model_toml(work / "model_cfg" / "base.toml", RES_DEPTH)
    bad, parts = [], {}
    try:
        t = time.perf_counter()
        fasta, data = work / "uniref50_synthetic.fasta", work / "data"
        write_fasta(fasta, CLI_SEED)
        (work / "data_cfg" / "synthetic.toml").write_text(DATA_TOML.format(
            fasta=fasta, out=data, n=CLI_SEQS))
        generate_data.run(["--data_dir", str(work / "data_cfg"), "--name",
                           "synthetic", "--seed", str(CLI_SEED)])
        parts["etl"] = time.perf_counter() - t
        run = resilience_cli(work, data)
        parts["cli"] = run["seconds"]
        cli_bad, cli = check_resilience_cli(cfg, run)
        bad += cli_bad
        t = time.perf_counter()
        gauges = hbm_gauges()
        if not gauges:
            bad.append("hbm_gauges() is empty on the card")
        saves = async_against_blocking(cfg, work)
        parts["saves"] = time.perf_counter() - t
        if not saves["bit_equal"]:
            bad.append(f"the asynchronous save's files differ from the "
                       f"blocking save's: {saves['files']}")
        if saves["launches"] != per_step(cfg):
            bad.append(f"the step during the write launched "
                       f"{saves['launches']}, not {per_step(cfg)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = dict(
        card=card, config="configs/model/base.toml", depth=RES_DEPTH,
        num_params=cfg.num_params(), chaos=RES_CHAOS, steps=RES_STEPS,
        batch=[TRAIN_ACCUM, TRAIN_MICRO, cfg.seq_len + 1],
        cli_step_ms_p50=cli["step_ms_p50"],
        cli_tokens_per_sec=cli["tokens_per_sec_per_chip"],
        cli_mfu=cli["mfu"], counters=cli["counters"],
        library_step_ms=result["train"]["step_ms"],
        library_tokens_per_s=result["train"]["tokens_per_s"],
        cli_depth6_step_ms=result["cli"]["step_ms"],
        cli_depth6_tokens_per_s=result["cli"]["tokens_per_s"],
        goodput=cli["goodput"], goodput_sum_pct=cli["goodput_sum_pct"],
        rollback=cli["rollback"], losses=cli["losses"], hbm=cli["hbm"],
        hbm_gauges_parent=gauges,
        profile_s=cli["profile_s"], trace_bytes=cli["trace_bytes"],
        **{k: cli[k] for k in ("flight_dumps", "pin_window_s",
                               "pin_window_export_s", "pin_window_bytes",
                               "pin_window_kernels", "clock_beacons")},
        checkpoint_bytes=saves["bytes"],
        blocking_save_s=saves["blocking_s"], async_save_s=saves["async_s"],
        async_finalize_wait_s=saves["finalize_wait_s"],
        step_during_write_ms=saves["step_during_write_ms"],
        async_bit_equal=saves["bit_equal"],
        final_restore_s=cli["final_restore_s"],
        parts_s=parts, seconds=time.perf_counter() - t_phase, budget_s=180)
    line("resilience", **out)
    if bad:
        raise AssertionError("resilience: " + "; ".join(bad))
    return dict(out, launches=saves["launches"])


# phase 13: the serving fleet's data plane at base.toml's widths, in
# bfloat16; depth cut to FLEET_DEPTH since slice 10 (at 24 layers the
# phase took 101-143 s on an H100 80GB HBM3 at 700 W, and with phase 14
# the script passed 850 s there)
FLEET_DEPTH = 6
FLEET_NEW = 96  # new tokens of each generate request
FLEET_MAX_LEN = 256
FLEET_KILL = 136  # r1's decode step of death: 40 steps into its 2nd stream
FLEET_TOKEN = "chip-smoke-fleet"
RELOAD_NEW = 48  # new tokens of the reload part's requests
RESPAWN_NEW = 16
INPROC_STEPS = 24  # pool steps timed without the reload's staging
SERVE_DEFAULTS = {"length": FLEET_MAX_LEN, "top_k": 25, "temperature": 1.0,
                  "top_p": None, "seed": 42}


class ParamsState:
    """What ``checkpoint.py``'s save reads of a train state, for the
    parameters alone (no optimizer moments): the checkpoint a serving
    fleet reads (``restore_params``), 1.6 GB at base in float32."""

    class _NoMoments:
        @staticmethod
        def state_dict():
            return {"count": 0, "mu": {}, "nu": {}}

    optimizer = _NoMoments()

    def __init__(self, model):
        self.model, self.step = model, 0


def save_params(ck: Path, model) -> str:
    """The model's parameters as a checkpoint in ``ck``; its name."""
    from progen_tpu_torch.checkpoint import Package, get_checkpoint_fns

    return Path(get_checkpoint_fns(str(ck))[2](Package(
        next_seq_index=0, state=ParamsState(model),
        model_config=model.config.to_dict(), run_id=None))).name


def fleet_requests() -> list:
    """Phase 13's 8 request lines, in the order the router alternates
    them over r0 (unix) and r1 (TCP): g0 and its twin g0tcp (the same
    request over the two wires), generates of FLEET_NEW new tokens, an
    infill freezing every third position, an embedding."""
    def gen(rid, text, seed):
        return {"id": rid, "prime": text, "length": 1 + len(text)
                + FLEET_NEW, "seed": seed}

    template = "".join(c if i < 4 or i % 3 == 0 else "?"
                       for i, c in enumerate(PROTEINS[6][:72]))
    g0 = gen("g0", PROTEINS[0][:16], 300)
    return [g0, {**g0, "id": "g0tcp"},
            gen("g1", PROTEINS[1][:20], 301),
            gen("g2", PROTEINS[2][:12], 302),
            gen("g3", PROTEINS[4][:24], 303),
            {"id": "infill", "template": template, "seed": 304},
            gen("g4", PROTEINS[5][:14], 305),
            {"id": "embed", "prime": PROTEINS[7], "embed": True}]


def parsed_request(wire: dict):
    """A request line as cli.serve parses it (its defaults)."""
    from progen_tpu_torch.cli import serve

    req, err = serve.parse_request(json.dumps(wire), SERVE_DEFAULTS)
    if err is not None:
        raise AssertionError(f"{wire['id']}: {err}")
    return req


def fleet_reference(model, wire: dict) -> np.ndarray:
    """sample_fast's stream for one generate or infill line, on the
    model's device."""
    from progen_tpu_torch.sampling import sample_fast

    req = parsed_request(wire)
    return sample_fast(req.seed, model, req.prime, req.length,
                       top_k=req.top_k, add_bos=req.add_bos,
                       temperature=req.temperature, top_p=req.top_p,
                       template=req.template, frozen=req.frozen,
                       device=model.device).cpu().numpy()


def first_generated(wire: dict) -> int:
    """The position of a request line's first generated token: its primed
    positions (BOS and the prime, or an infill's leading frozen run)."""
    from progen_tpu_torch.cli import serve

    return serve._start(parsed_request(wire))


def stream_check(got: dict, want: np.ndarray, start: int) -> bool:
    """A stream of {index: token}: contiguous from ``start`` (no lost
    head), equal to ``want`` where it ran, and stopped where ``want``
    stops (only zeros after it)."""
    idx = sorted(got)
    return bool(idx and idx == list(range(start, idx[-1] + 1))
                and np.array_equal([got[i] for i in idx],
                                   want[idx[0]:idx[-1] + 1])
                and (want[idx[-1] + 1:] == 0).all())


def spawn_serve(ck: Path, rdir: Path, device: str, *flags, env=None):
    """cli.serve in a child on ``device`` at one slot, its journal and
    exposition in ``rdir``, stderr to rdir/stderr.log; the kernels it
    loads were built by this process."""
    rdir.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [sys.executable, "-m", "progen_tpu_torch.cli.serve", "--device",
         device, "--checkpoint_path", str(ck), "--max-slots", "1", "--max-len",
         str(FLEET_MAX_LEN), "--journal_dir", str(rdir), "--prom_file",
         str(rdir / "metrics.prom"), "--metrics-every", "8", *flags],
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=open(rdir / "stderr.log", "ab"), cwd=rdir,
        env=dict(os.environ, PYTHONPATH=str(REPO), **(env or {})))


def wait_for(pred, what: str, procs=(), timeout: float = 240.0):
    """Poll ``pred()`` until it is truthy; fail when a process in
    ``procs`` exits first or the deadline passes. Returns its value."""
    deadline = time.monotonic() + timeout
    while True:
        got = pred()
        if got:
            return got
        for p in procs:
            if p.poll() is not None:
                raise AssertionError(f"{what}: a child exited rc "
                                     f"{p.returncode} first")
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.05)


def log_text(path: Path) -> str:
    return path.read_text(errors="replace") if path.exists() else ""


def listening(rdir: Path):
    """A replica's endpoint once its log says it listens, else None."""
    m = re.search(r"listening on (tcp )?(\S+)", log_text(rdir / "stderr.log"))
    return None if m is None else m.group(2)


def start_reader(stream, sink: list):
    """Collect (arrival time, line) from a child's stdout on a thread, so
    the pipe never fills while this process computes."""
    import threading

    def run():
        for ln in stream:
            sink.append((time.monotonic(), ln.rstrip("\n")))

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def events_of(lines) -> list:
    out = []
    for _, ln in lines:
        try:
            out.append(json.loads(ln))
        except ValueError:
            pass
    return out


def route_records(cwd: Path) -> list:
    recs = []
    for path in cwd.glob("runs/progen-router/*/events.jsonl"):
        for ln in path.read_text().splitlines():
            rec = json.loads(ln)
            if rec.get("ev") == "route":
                recs.append(rec)
    return sorted(recs, key=lambda r: r["ts"])


def fleet_run(work: Path, ck: Path, r0_sock: str, r1_tcp: str) -> dict:
    """cli.router over r0 (unix) and r1 (TCP, with the fleet token), the
    8 request lines on its stdin, then EOF; its events by arrival."""
    lines = []
    t = time.perf_counter()
    router = subprocess.Popen(
        [sys.executable, "-m", "progen_tpu_torch.cli.router",
         "--replica", f"sock={r0_sock},journal={work / 'r0'},"
         f"prom={work / 'r0' / 'metrics.prom'}",
         "--replica", f"tcp={r1_tcp},journal={work / 'r1'},"
         f"prom={work / 'r1' / 'metrics.prom'}"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=open(work / "router.log", "ab"), text=True, cwd=work,
        env=dict(os.environ, PYTHONPATH=str(REPO),
                 PROGEN_FLEET_TOKEN=FLEET_TOKEN))
    reader = start_reader(router.stdout, lines)
    router.stdin.write("".join(json.dumps(w) + "\n"
                               for w in fleet_requests()))
    router.stdin.close()
    rc = router.wait(timeout=600)
    reader.join(60)
    return dict(rc=rc, lines=lines, seconds=time.perf_counter() - t,
                routes=route_records(work))


def check_fleet_run(run: dict, refs: dict, embed_vec) -> tuple:
    """Phase 13's fleet checks; (bad, summary)."""
    bad = []
    evs = events_of(run["lines"])
    ids = [w["id"] for w in fleet_requests()]
    settled = [e["id"] for e in evs if e["event"] in ("done", "embedding")]
    rejected = [e for e in evs if e["event"] == "rejected"]
    if run["rc"] != 0 or sorted(settled) != sorted(ids) or rejected:
        bad.append(f"fleet: rc {run['rc']}, settled {settled}, rejected "
                   f"{rejected}")
    streams: dict = {}
    arrivals: dict = {}
    for (t, ln), e in zip(run["lines"], evs):
        if e.get("event") == "token":
            streams.setdefault(e["id"], {})[e["index"]] = e["token"]
            arrivals.setdefault(e["id"], []).append(t)
    wires = {w["id"]: w for w in fleet_requests()}
    unequal = [i for i, want in refs.items()
               if not stream_check(streams.get(i, {}), want,
                                   first_generated(wires[i]))]
    if unequal:
        bad.append(f"fleet streams differ from sample_fast: {unequal}")
    if streams.get("g0") != streams.get("g0tcp"):
        bad.append("g0 over the unix socket differs from g0tcp over TCP")
    routes = run["routes"]
    resumed = [r for r in routes if r["status"] == "handoff"
               and r.get("resumed")]
    down = [r for r in routes if r["status"] == "replica_down"]
    if not resumed or not down:
        bad.append(f"no resumed handoff in the router's records: {routes}")
    embs = [e for e in evs if e["event"] == "embedding"]
    emb = embs[0] if embs else None
    d_emb = None if emb is None else float(
        np.abs(np.array(emb["values"]) - embed_vec).max())
    if d_emb is None or not d_emb <= 1e-6:  # the line rounds to 6 places
        bad.append(f"the fleet's embedding differs by {d_emb}")
    hops = {}
    for r in routes:
        if r["status"] == "dispatched":
            hops.setdefault(r["req"], []).append(r["replica"])
    if hops.get("g0") != [0] or hops.get("g0tcp") != [1]:
        bad.append(f"g0 and g0tcp did not take r0 (unix) and r1 (TCP) "
                   f"alone: {hops}")
    # the client's view of the handoff: the longest gap between two
    # tokens of a stream the dead replica was streaming
    cut = [i for i, h in hops.items() if len(h) > 1 and i in arrivals
           and len(arrivals[i]) > 1]
    gap = max((max(np.diff(arrivals[i])) for i in cut), default=None)
    handoff_s = (resumed[-1]["ts"] - down[0]["ts"]) if resumed and down \
        else None
    return bad, dict(settled=len(settled), hops=hops,
                     handed_off=[r["req"] for r in resumed],
                     handoff_fold_s=handoff_s, stream_gap_s=gap,
                     streams_equal=len(refs) - len(unequal),
                     g0_tcp_hops=hops.get("g0tcp"), embed_distance=d_emb,
                     tokens=sum(len(s) for s in streams.values()))


def replica_launches(prom: Path) -> dict:
    """Kernel id -> launches, from a cli.serve exposition's
    progen_serve_kernel_launches_<id> gauges (None where absent)."""
    from progen_tpu_torch.ops.launches import WRAPPERS, gauge_name

    text = log_text(prom)
    out = {}
    for rid in WRAPPERS:
        m = re.search(rf"^progen_serve_{gauge_name(rid)} (\S+)$", text,
                      re.M)
        out[rid] = None if m is None else int(float(m.group(1)))
    return out


def client_session(sock_path: str, lines, until, timeout=300.0) -> list:
    """Talk to a replica's unix socket as a client: send ``lines`` (a
    list of (condition, line): each is sent once its condition holds on
    the events so far), read events until ``until(events)``."""
    from progen_tpu_torch.fleet.transport import LineConnection

    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.connect(sock_path)
    conn = LineConnection(s)
    events, todo = [], list(lines)
    deadline = time.monotonic() + timeout
    try:
        while not until(events):
            while todo and todo[0][0](events):
                conn.send_line(todo.pop(0)[1])
            if select.select([conn], [], [], 0.05)[0]:
                got, eof = conn.recv_lines()
                events += [json.loads(ln) for ln in got]
                if eof:
                    raise AssertionError(f"replica closed the session: "
                                         f"{events[-3:]}")
            if time.monotonic() > deadline:
                raise AssertionError(f"client session timed out: "
                                     f"{events[-3:]}")
    finally:
        conn.close()
    return events


def reload_under_traffic(r0, work: Path, name_b: str, refs_b) -> tuple:
    """SIGHUP r0 while it serves two requests, send two more once it
    says it serves B; (bad, summary). ``refs_b(wire)`` is sample_fast
    under B."""
    log = work / "r0" / "stderr.log"
    before = [{"id": f"h{i}", "prime": PROTEINS[i][20:36], "length": 17
               + RELOAD_NEW, "seed": 400 + i} for i in range(2)]
    after = [{"id": f"a{i}", "prime": PROTEINS[i + 2][20:36], "length": 17
              + RELOAD_NEW, "seed": 410 + i} for i in range(2)]
    committed = f"reload: now serving {name_b}"
    state = {"hup": None, "commit": None}

    def committed_yet(events):
        """SIGHUP once the first token streamed; True once the commit
        line is in r0's log."""
        if state["hup"] is None and any(e["event"] == "token"
                                        for e in events):
            os.kill(r0.pid, signal.SIGHUP)
            state["hup"] = time.monotonic()
        if state["commit"] is None and committed in log_text(log):
            state["commit"] = time.monotonic()
        return state["commit"] is not None

    t = time.perf_counter()
    events = client_session(
        str(work / "r0" / "serve.sock"),
        [(lambda ev: True, json.dumps(w)) for w in before]
        + [(committed_yet, json.dumps(w)) for w in after],
        until=lambda ev: committed_yet(ev) and len(
            [e for e in ev if e["event"] == "done"]) == 4)
    seconds = time.perf_counter() - t
    bad = []
    done = sorted(e["id"] for e in events if e["event"] == "done")
    text = log_text(log)
    if done != ["a0", "a1", "h0", "h1"] or any(
            e["event"] == "rejected" for e in events) or \
            "reload: rejected" in text or committed not in text:
        bad.append(f"reload: done {done}, log {text[-1500:]}")
    streams: dict = {}
    for e in events:
        if e["event"] == "token":
            streams.setdefault(e["id"], {})[e["index"]] = e["token"]
    unequal = [w["id"] for w in after
               if not stream_check(streams.get(w["id"], {}), refs_b(w),
                                   first_generated(w))]
    if unequal:
        bad.append(f"after the commit, {unequal} differ from sample_fast "
                   "under the new weights")
    m = re.search(r"now serving \S+ \(load \+ commit (\S+) s\)", text)
    return bad, dict(session_s=seconds, load_and_commit_s=float(
        m.group(1)) if m else None, hup_to_commit_s=(
        state["commit"] - state["hup"]) if state["commit"] else None,
        after_commit_equal=len(after) - len(unequal))


def spawn_fleet(work: Path, ck: Path, device: str) -> dict:
    """Start cli.router --spawn 2 --respawn, its replicas watching their
    pins (--replica_reload_watch 1), stdin held open."""
    lines = []
    router = subprocess.Popen(
        [sys.executable, "-m", "progen_tpu_torch.cli.router", "--spawn",
         "2", "--respawn", "--device", device, "--checkpoint_path", str(ck),
         "--fleet_dir", str(work / "fleet"), "--replica-max-slots", "1",
         "--max-len", str(FLEET_MAX_LEN), "--replica_reload_watch", "1"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=open(work / "spawn_router.log", "ab"), text=True, cwd=work,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    return dict(proc=router, lines=lines, t0=time.perf_counter(),
                reader=start_reader(router.stdout, lines))


def respawn_and_pin(work: Path, spawned: dict, name_a: str) -> tuple:
    """The spawned fleet of ``spawn_fleet``: SIGKILL replica0 and wait
    for its replay, pin replica1 to the older checkpoint A and wait for
    the ack, then 2 requests and EOF; (bad, summary)."""
    fleet, lines, router = work / "fleet", spawned["lines"], spawned["proc"]
    t = spawned["t0"]
    rlog = work / "spawn_router.log"
    try:
        for i in range(2):
            wait_for(lambda i=i: "listening on" in log_text(
                fleet / f"replica{i}" / "replica.log"),
                f"spawned replica{i} listens", [router])
        boot_s = time.perf_counter() - t
        pid = int(re.search(r"replica0: pid (\d+)", log_text(rlog))[1])
        t_kill = time.perf_counter()
        os.kill(pid, signal.SIGKILL)
        wait_for(lambda: "replay: resumed" in log_text(
            fleet / "replica0" / "replica.log"), "replica0's replay",
            [router])
        wait_for(lambda: log_text(fleet / "replica0" / "replica.log")
                 .count("listening on") >= 2, "replica0 listens again",
                 [router])
        respawn_s = time.perf_counter() - t_kill
        ack = fleet / "replica1" / "reload.pin.ack"
        t_pin = time.perf_counter()
        (fleet / "replica1" / "reload.pin").write_text(name_a + "\n")
        got = wait_for(lambda: ack.exists() and json.loads(
            ack.read_text()), "the pin's ack", [router])
        pin_s = time.perf_counter() - t_pin
        router.stdin.write("".join(json.dumps({
            "id": f"s{i}", "prime": PROTEINS[i][:10],
            "length": 11 + RESPAWN_NEW, "seed": 500 + i}) + "\n"
            for i in range(2)))
        router.stdin.close()
        rc = router.wait(timeout=300)
        spawned["reader"].join(60)
    finally:
        if router.poll() is None:
            router.terminate()  # a drain: it stops its replicas
            router.wait(60)
    evs = events_of(lines)
    done = sorted(e["id"] for e in evs if e["event"] == "done")
    bad = []
    if rc != 0 or done != ["s0", "s1"]:
        bad.append(f"respawn run: rc {rc}, done {done}: "
                   f"{log_text(rlog)[-1500:]}")
    if got.get("pin") != name_a or got.get("status") != "committed":
        bad.append(f"the pin to {name_a} was acked {got}")
    text = log_text(rlog)
    if "replica0: exited rc=-9" not in text or \
            "replica0: pid" not in text.split("exited rc=-9", 1)[-1]:
        bad.append(f"replica0 was not respawned: {text[-1500:]}")
    return bad, dict(boot_s=boot_s, respawn_s=respawn_s, pin_ack_s=pin_s,
                     ack=got, seconds=time.perf_counter() - t)


def reload_in_process(model, ck: Path, name_a: str, sd_a: dict) -> tuple:
    """WeightReloader on a base engine (4 slots) while it decodes, from
    B to the older A by name: the pool's step interval while the load
    stages against without, the peak bytes the staging adds, the live
    parameters' addresses across the commit; (bad, summary)."""
    from progen_tpu_torch.data.tokenizer import encode_tokens
    from progen_tpu_torch.serving import (
        Request,
        Scheduler,
        ServeEngine,
        WeightReloader,
    )

    engine = ServeEngine(model, max_slots=4, max_len=FLEET_MAX_LEN)
    sched = Scheduler(engine)
    for i in range(4):
        sched.submit(Request(id=f"p{i}", prime=encode_tokens(
            PROTEINS[i][:12]).astype(np.int64), length=FLEET_MAX_LEN,
            top_k=None, add_bos=False, seed=600 + i))

    def timed_step():
        t = time.perf_counter()
        sched.step()  # ends in the host copy of the sampled tokens
        return time.perf_counter() - t

    for _ in range(4):
        timed_step()
    idle = [timed_step() for _ in range(INPROC_STEPS)]
    ptrs = {k: v.data_ptr() for k, v in model.state_dict().items()}
    cuda = model.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    reloader = WeightReloader(engine, str(ck), metrics=sched.metrics)
    reloader.request_reload(path=name_a)
    staging = []
    while reloader.loading and sched.has_work:
        staging.append(timed_step())
    reloader.join(300)
    name = reloader.maybe_commit()
    peak = None
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    after = [timed_step() for _ in range(4)]  # the pool goes on
    bad = []
    if name != name_a:
        bad.append(f"in-process reload committed {name}: "
                   f"{reloader.last_error}")
    moved = [k for k, v in model.state_dict().items()
             if v.data_ptr() != ptrs[k]]
    if moved:
        bad.append(f"the commit moved {moved[:3]}")
    wrong = [k for k, v in model.state_dict().items()
             if not torch.equal(v.cpu(), sd_a[k])]
    if wrong:
        bad.append(f"after the commit {wrong[:3]} differ from A's")
    snap = sched.metrics.snapshot()
    return bad, dict(
        reload_duration_s=reloader.last_duration_s,
        step_ms_p50_idle=float(np.median(idle)) * 1e3,
        step_ms_max_idle=max(idle) * 1e3,
        step_ms_p50_staging=float(np.median(staging)) * 1e3
        if staging else None,
        step_ms_max_staging=max(staging) * 1e3 if staging else None,
        steps_while_staging=len(staging),
        step_ms_p50_after=float(np.median(after)) * 1e3,
        staging_peak_bytes=peak,
        param_bytes=sum(v.nbytes for v in model.state_dict().values()),
        addresses_kept=not moved, reloads=snap.get("reloads"))


def phase_fleet(cfg, card: str, device: str = "cuda") -> dict:
    """Phase 13 (see the module docstring). ``device`` "cpu" rehearses
    it at a small config on the host (its launch check then fails: the
    plain versions count nothing)."""
    import shutil
    import threading

    from progen_tpu_torch import ProGen
    from progen_tpu_torch.serving import ServeEngine

    t_phase = time.perf_counter()
    work = REPO / "build" / "chip_smoke_fleet"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ck, children, parts, bad = work / "ck", [], {}, []
    try:
        t = time.perf_counter()
        model = ProGen(cfg, device=device, seed=0).eval()
        name_a = save_params(ck, model)
        sd_a = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        parts["save_a"] = time.perf_counter() - t
        t_boot = time.perf_counter()
        r0 = spawn_serve(ck, work / "r0", device, "--socket",
                         str(work / "r0" / "serve.sock"))
        r1 = spawn_serve(ck, work / "r1", device, "--tcp", "127.0.0.1:0",
                         env=dict(PROGEN_FLEET_TOKEN=FLEET_TOKEN,
                                  PROGEN_CHAOS="serve/decode:kill@"
                                  f"{FLEET_KILL}"))
        children += [r0, r1]
        wires = {w["id"]: w for w in fleet_requests()}
        refs: dict = {}

        def references():
            for rid, w in wires.items():
                if rid != "embed" and rid != "g0tcp":
                    refs[rid] = fleet_reference(model, w)

        ref_thread = threading.Thread(target=references)
        ref_thread.start()  # the card is shared: the children are host-bound
        ends = [wait_for(lambda: listening(work / r), f"{r} listens",
                         [r0, r1]) for r in ("r0", "r1")]
        parts["boot"] = time.perf_counter() - t_boot
        t = time.perf_counter()
        model_b = copy.deepcopy(model)  # B: A and seeded noise
        gen = torch.Generator(device=device).manual_seed(1)
        with torch.no_grad():
            for prm in model_b.parameters():
                prm.add_(torch.randn(prm.shape, generator=gen,
                                     device=device) * 0.02)
        name_b = save_params(ck, model_b)  # after the replicas chose A
        parts["save_b"] = time.perf_counter() - t
        run = fleet_run(work, ck, ends[0], ends[1])
        parts["fleet_run"] = run["seconds"]
        ref_thread.join()
        refs["g0tcp"] = refs["g0"]
        if r1.wait(timeout=60) != -signal.SIGKILL:
            bad.append(f"r1 exited {r1.returncode}, not by its chaos kill")
        reset_counts()  # the check's embedding, not the fleet's path
        engine = ServeEngine(model, max_slots=1)
        embed_vec = engine.embed(parsed_request(wires["embed"]).prime,
                                 add_bos=True)
        check_launches = launch_counts()
        if check_launches != per_forward(cfg):
            bad.append(f"the check's embed launched {check_launches}, "
                       f"not {per_forward(cfg)}")
        fleet_bad, fleet = check_fleet_run(run, refs, embed_vec)
        bad += fleet_bad

        # the spawned fleet boots (on B, the newest) beside the reload
        spawned = spawn_fleet(work, ck, device)
        children.append(spawned["proc"])
        t = time.perf_counter()
        model.load_state_dict(model_b.state_dict())
        del model_b

        def refs_b(wire):
            return fleet_reference(model, wire)

        reload_bad, reload = reload_under_traffic(r0, work, name_b, refs_b)
        bad += reload_bad
        r0.terminate()
        if r0.wait(timeout=120) != 0:
            bad.append(f"r0 exited {r0.returncode} on SIGTERM")
        # the path's launches: the replica that answered the embed
        # counted them in its own process and wrote them into its
        # exposition (at exit, for r0); it served no other forward
        answered = f"r{fleet['hops'].get('embed', [None])[-1]}"
        launches = replica_launches(work / answered / "metrics.prom")
        if launches != per_forward(cfg):
            bad.append(f"{answered}, which answered the embed, launched "
                       f"{launches}, not {per_forward(cfg)}")
        parts["reload"] = time.perf_counter() - t
        t = time.perf_counter()
        respawn_bad, respawn = respawn_and_pin(work, spawned, name_a)
        bad += respawn_bad
        parts["respawn"] = time.perf_counter() - t
        t = time.perf_counter()
        inproc_bad, inproc = reload_in_process(model, ck, name_a, sd_a)
        bad += inproc_bad
        parts["in_process"] = time.perf_counter() - t
        journals = {r: sum(1 for ln in log_text(work / r / "journal.jsonl")
                           .splitlines() if '"handed_off"' in ln)
                    for r in ("r0", "r1")}
    except BaseException:
        for log in sorted(work.rglob("*.log")):  # the children's side
            print(f"--- {log.relative_to(work)}:\n"
                  f"{log_text(log)[-2000:]}", flush=True)
        raise
    finally:
        for p in children:  # a router's drain stops the replicas it spawned
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        shutil.rmtree(work, ignore_errors=True)
    out = dict(card=card, config="configs/model/base.toml", depth=cfg.depth,
               num_params=cfg.num_params(), requests=len(wires),
               new_tokens=FLEET_NEW, slots=1, kill_at=FLEET_KILL,
               fleet=fleet, handed_off_marks=journals, reload=reload,
               respawn=respawn, in_process=inproc, launches=launches,
               embed_answered_by=answered, check_launches=check_launches,
               parts_s=parts, seconds=time.perf_counter() - t_phase,
               budget_s=150)
    line("fleet", **out)
    if bad:
        raise AssertionError("fleet: " + "; ".join(bad))
    return out


# phase 14: the telemetry back end, the flight recorder, on-demand
# profiling and the autoscaler, driven by a fleet that scales itself at
# base.toml whole, in bfloat16
OBS_BURST = 10  # generates, distinct seeds
OBS_NEW = 64  # new tokens of each
OBS_MAX_LEN = 128
OBS_POLICY = """[autoscaler]
min_replicas = 1
max_replicas = 2
queue_high = 3.0
queue_low = 1.0
up_sustain = 2
down_sustain = 2
up_cooldown_s = 20.0
down_cooldown_s = 5.0
stale_after_s = 15.0
interval_s = 1.0
rebalance_max = 4
"""
# the burst comes in two waves through the router. Replica 0 takes
# requests FIFO at one slot, so the first OBS_FIRST_WAVE generates queue
# behind each other: the second's TTFT (the first's whole run) burns the
# objective (p95 >= hot x OBS_TTFT_THRESHOLD_S), the collector writes
# replica 0's pin and its 10 s profile window (cli.serve's) opens. Once
# its ack says started, the second wave (the embeds first, then the other
# generates) goes out: replica 0 answers the embeds between two decode
# steps, inside the window, and the generates queue past queue_high
OBS_FIRST_WAVE = 2
OBS_TTFT_THRESHOLD_S = 1.0
OBS_SLO = """[windows]
short_s = 30
long_s = 120

[burn]
warn = 1.0
hot = 2.0
stale_after_s = 30

[objective_ttft_p95]
kind = "latency"
metric = "ttft_s"
quantile = "p95"
threshold_s = {threshold}
"""
OBS_STEPS = 12  # pool steps a round, recorder armed and not
OBS_ROUNDS = 3
# the kernels a replica's embed forward launches, by their CUDA symbols
EMBED_KERNELS = ("fwd_tc_kernel", "norm_shift_kernel", "sgu_mix_tc_kernel")
TRAIN_KERNELS = ("fwd_tc_kernel", "rows_tc_kernel", "kv_tc_kernel",
                 "norm_shift_kernel", "sgu_mix_tc_kernel")


def prom_gauge(path: Path, name: str):
    """One unlabelled sample of an exposition, or None."""
    m = re.search(rf"^{name} (\S+)$", log_text(path), re.M)
    return None if m is None else float(m.group(1))


def obs_requests() -> tuple:
    """Phase 14's traffic: OBS_BURST generates of OBS_NEW new tokens and
    2 embeds."""
    gens = []
    for i in range(OBS_BURST):
        prime = PROTEINS[i % 7][i:i + 12 + i % 5]
        gens.append({"id": f"b{i}", "prime": prime,
                     "length": 1 + len(prime) + OBS_NEW, "seed": 700 + i})
    embeds = [{"id": "e0", "prime": PROTEINS[7], "embed": True},
              {"id": "e1", "prime": PROTEINS[3][:48], "embed": True}]
    return gens, embeds


class Receiver:
    """A loopback HTTP receiver for the collector's remote-write pushes:
    counts the POST bodies it accepts."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.bodies = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                outer.bodies.append(self.rfile.read(
                    int(self.headers.get("Content-Length", 0))))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/write"
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def trace_kernel_counts(path: Path, names) -> dict:
    """Kernel symbol -> the CUDA kernel events of a Chrome trace that
    name it, read a line at a time (a serving window's trace is hundreds
    of MB; torch writes an event's name right after its category)."""
    out = dict.fromkeys(names, 0)
    name = re.compile(r'"name": "([^"]*)"')
    kernel = False
    with path.open() as f:
        for ln in f:
            kernel = kernel or '"cat": "kernel"' in ln
            m = name.search(ln) if kernel else None
            if m is None:
                continue
            kernel = False
            for n in names:
                if n in m.group(1):
                    out[n] += 1
    return out


def jsonl(path: Path) -> list:
    from progen_tpu_torch.telemetry.trace import iter_jsonl

    return list(iter_jsonl(path)) if path.exists() else []


def replica_events(rdir: Path, cwd: Path) -> Path:
    """A spawned replica's events.jsonl, named in its log."""
    m = re.search(r"request traces: (\S+)", log_text(rdir / "replica.log"))
    if m is None:
        raise AssertionError(f"{rdir.name} named no events file")
    return cwd / m.group(1)


def run_cli(main, argv) -> tuple:
    """A CLI's ``main(argv)`` in this process: (exit code, stdout)."""
    import io

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = main(argv)
    except SystemExit as e:
        rc = e.code
    return rc, out.getvalue()


def recorder_cost(model, work: Path) -> dict:
    """A 4-slot engine of the same weights: the pool's step time with the
    flight recorder armed against without it, in alternating rounds, and
    one dump of the full ring written from its records."""
    from progen_tpu_torch.data.tokenizer import encode_tokens
    from progen_tpu_torch.serving import Request, Scheduler, ServeEngine
    from progen_tpu_torch.telemetry import flight

    engine = ServeEngine(model, max_slots=4, max_len=FLEET_MAX_LEN)
    sched = Scheduler(engine)
    for i in range(4):
        sched.submit(Request(id=f"o{i}", prime=encode_tokens(
            PROTEINS[i][:12]).astype(np.int64), length=FLEET_MAX_LEN,
            top_k=None, add_bos=False, seed=800 + i))

    def steps(n):
        out = []
        for _ in range(n):
            t = time.perf_counter()
            sched.step()  # ends in the host copy of the sampled tokens
            out.append(time.perf_counter() - t)
        return out

    steps(6)  # the prefills and the first decode steps
    armed, plain, tapped = [], [], 0
    try:
        for _ in range(OBS_ROUNDS):
            plain += steps(OBS_STEPS)
            rec = flight.arm(work / "inproc_flight")
            armed += steps(OBS_STEPS)
            seen = rec.payload("count")
            tapped += len(seen["records"]) + seen["truncated"]
            flight.disarm()
    finally:
        flight.disarm()
    p50_plain = float(np.median(plain)) * 1e3
    p50_armed = float(np.median(armed)) * 1e3
    return dict(step_ms_p50_disarmed=p50_plain, step_ms_p50_armed=p50_armed,
                armed_over_disarmed=p50_armed / p50_plain,
                steps_each=len(plain), records_tapped=tapped)


def full_ring_dump(records, out: Path) -> dict:
    """A flight recorder's default ring filled with ``records`` (the
    phase's own, repeated to fill it) and dumped once: its bytes and ms."""
    from progen_tpu_torch.telemetry import flight

    rec = flight.FlightRecorder(out, host=0)
    for r in itertools.islice(itertools.cycle(records), rec.ring):
        rec.tap(dict(r))
    t = time.perf_counter()
    path = rec.dump("measure")
    ms = (time.perf_counter() - t) * 1e3
    flight.verify_dump(path)
    return dict(records=rec.ring, bytes=path.stat().st_size, ms=ms)


def collector_tick_ms(sources, slo: Path, work: Path) -> dict:
    """The collector's scrape of the phase's sources, in this process, on
    the files the run left: p50 and max of 20 ticks into a scratch
    store."""
    from progen_tpu_torch.telemetry.collector import (
        Collector,
        parse_source_spec,
    )
    from progen_tpu_torch.telemetry.slo import load_objectives
    from progen_tpu_torch.telemetry.tsdb import RingTSDB

    db = RingTSDB(work / "tick_tsdb")
    coll = Collector(db, [parse_source_spec(s) for s in sources],
                     stale_after_s=1e9, slo_cfg=load_objectives(slo))
    ticks = []
    for _ in range(20):
        t = time.perf_counter()
        coll.scrape_once()
        ticks.append((time.perf_counter() - t) * 1e3)
    db.close()
    return dict(p50=float(np.median(ticks)), max=max(ticks))


def phase_observability(cfg, card: str, device: str = "cuda") -> dict:
    """Phase 14 (see the module docstring)."""
    import shutil
    import threading

    from progen_tpu_torch import ProGen
    from progen_tpu_torch.cli import telemetry as telemetry_cli
    from progen_tpu_torch.cli import top as top_cli
    from progen_tpu_torch.fleet.autoscaler import read_scale_records
    from progen_tpu_torch.telemetry import flight
    from progen_tpu_torch.telemetry.collector import fleet_series
    from progen_tpu_torch.telemetry.tsdb import TsdbReader

    t_phase = time.perf_counter()
    work = REPO / "build" / "chip_smoke_observability"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    fleet, tsdb, ck = work / "fleet", work / "tsdb", work / "ck"
    r0dir, r1dir = fleet / "replica0", fleet / "replica1"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs, bad, parts, marks = [], [], {}, {}
    receiver = Receiver()
    gens, embeds = obs_requests()
    waves = (gens[:OBS_FIRST_WAVE], embeds + gens[OBS_FIRST_WAVE:])
    sources = [f"name=router,role=router,prom={fleet / 'router.prom'}",
               f"name=r0,prom={r0dir / 'metrics.prom'}",
               f"name=r1,prom={r1dir / 'metrics.prom'}"]
    try:
        t = time.perf_counter()
        model = ProGen(cfg, device=device, seed=0).eval()
        save_params(ck, model)
        parts["save"] = time.perf_counter() - t
        (work / "policy.toml").write_text(OBS_POLICY)
        t_boot = time.perf_counter()
        lines = []
        router = subprocess.Popen(
            [sys.executable, "-m", "progen_tpu_torch.cli.router", "--spawn",
             "1", "--device", device, "--checkpoint_path", str(ck),
             "--fleet_dir", str(fleet), "--replica-max-slots", "1",
             "--max-len", str(OBS_MAX_LEN), "--autoscale",
             str(work / "policy.toml"), "--autoscale_tsdb", str(tsdb),
             "--replica_profile_watch", "--flight_dir",
             str(fleet / "router"), "--prom_file", str(fleet / "router.prom"),
             "--metrics-every", "5"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=open(work / "router.log", "ab"), text=True, cwd=work,
            env=env)
        procs.append(router)
        reader = start_reader(router.stdout, lines)
        refs, ref_s = {}, []

        def references():
            for w in gens:
                t0 = time.perf_counter()
                refs[w["id"]] = fleet_reference(model, w)
                ref_s.append(time.perf_counter() - t0)

        (work / "slo.toml").write_text(OBS_SLO.format(
            threshold=OBS_TTFT_THRESHOLD_S))
        wait_for(lambda: "listening on" in log_text(r0dir / "replica.log"),
                 "replica0 listens", [router])
        parts["boot"] = time.perf_counter() - t_boot
        # started once replica 0 is up, so its boot has the host to itself;
        # the card is shared, the replicas are host-bound
        ref_thread = threading.Thread(target=references)
        ref_thread.start()
        collector = subprocess.Popen(
            [sys.executable, "-m", "progen_tpu_torch.cli.collector",
             "--tsdb", str(tsdb), "--interval", "1", "--stale-after", "60",
             *itertools.chain.from_iterable(("--source", s)
                                            for s in sources),
             "--slo", str(work / "slo.toml"), "--profile-pin",
             str(r0dir / "profile.pin"), "--flight-dir",
             str(work / "collector_flight"), "--alerts-out",
             str(work / "alerts.jsonl"), "--remote-write", receiver.url],
            stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
            stderr=open(work / "collector.log", "ab"), cwd=work, env=env)
        procs.append(collector)
        wait_for(lambda: tsdb.is_dir() and any(
            True for _ in TsdbReader(tsdb).read()),
            "the collector's first tick", [router, collector])

        # the burst through the router, in two waves
        t_burst = time.perf_counter()
        marks["burst"] = time.time()
        router.stdin.write("".join(json.dumps(w) + "\n" for w in waves[0]))
        router.stdin.flush()
        ack = r0dir / "profile.pin.ack"
        ids = sorted(w["id"] for w in gens + embeds)
        peak = {}

        def progress():
            now = time.time()
            seen = json.loads(ack.read_text()) if ack.exists() else {}
            # the ack, and the window's own record (emitted once the
            # profiler has started) in replica 0's events
            if "wave2" not in marks and seen.get("status") == "started" \
                    and any(r.get("ev") == "profile" and r.get("op") ==
                            "started" for r in jsonl(replica_events(
                                r0dir, work))):
                marks["wave2"], marks["ack"] = now, seen
                router.stdin.write("".join(json.dumps(w) + "\n"
                                           for w in waves[1]))
                router.stdin.flush()
            if not peak and tsdb.is_dir():
                snap = json.loads(run_cli(top_cli.main, [
                    "--tsdb", str(tsdb), "--once", "--json"])[1])
                up = sorted(s["name"] for s in snap["sources"]
                            if s["role"] == "replica" and s["up"])
                if up == ["r0", "r1"]:
                    peak.update(snapshot=snap, frame=run_cli(
                        top_cli.main, ["--tsdb", str(tsdb), "--once",
                                       "--no-color"])[1], ts=now)
            text = log_text(work / "router.log")
            if "exit" not in marks and "replica1: exited" in text:
                marks["exit"] = now
            settled = sorted(e["id"] for e in events_of(lines)
                             if e["event"] in ("done", "embedding"))
            return "exit" in marks and settled == ids

        wait_for(progress, "the burst, the embeds and the scale-down",
                 [router, collector], timeout=240)
        parts["burst_and_quiet"] = time.perf_counter() - t_burst
        router.stdin.close()
        rc_router = router.wait(timeout=120)
        reader.join(60)
        collector.send_signal(signal.SIGTERM)
        rc_collector = collector.wait(timeout=60)
        ref_thread.join()
        parts["fleet"] = time.perf_counter() - t_boot

        # the fleet's own records
        evs = events_of(lines)
        settled = sorted(e["id"] for e in evs
                         if e["event"] in ("done", "embedding"))
        rejected = [e for e in evs if e["event"] == "rejected"]
        if rc_router != 0 or settled != ids or rejected:
            bad.append(f"router: rc {rc_router}, settled {settled}, "
                       f"rejected {rejected}")
        if rc_collector != 0:
            bad.append(f"the collector exited {rc_collector} on SIGTERM")
        streams = {}
        for e in evs:
            if e["event"] == "token":
                streams.setdefault(e["id"], {})[e["index"]] = e["token"]
        unequal = [w["id"] for w in gens if not stream_check(
            streams.get(w["id"], {}), refs[w["id"]], first_generated(w))]
        if unequal:
            bad.append(f"streams differ from sample_fast: {unequal}")
        (router_ev,) = sorted(work.glob("runs/progen-router/*/events.jsonl"))
        scales = [r for r in read_scale_records(router_ev)
                  if r["action"] != "hold"]
        if [r["action"] for r in scales] != ["up", "down"]:
            bad.append(f"scale decisions {scales}, not up then down")
        up = next((r for r in scales if r["action"] == "up"), None)
        down = next((r for r in scales if r["action"] == "down"), None)
        rlog = log_text(work / "router.log")
        for want in ("replica1: pid", "(replaying its journal)",
                     "replica1: retiring (scale-down)",
                     "replica1: exited rc=0"):
            if want not in rlog:
                bad.append(f"the router's log lacks {want!r}")
        if "replay: resumed" not in log_text(r1dir / "replica.log"):
            bad.append("replica1 did not boot from its --replay journal")
        routes = [r for r in jsonl(router_ev) if r.get("ev") == "route"]
        hops = {}
        for r in routes:
            if r.get("status") == "dispatched":
                hops.setdefault(r["req"], []).append(r["replica"])
        took = sorted(i for i, h in hops.items() if h[-1] == 1)
        if not took:
            bad.append("replica1 took no work")
        r0_ev, r1_ev = (replica_events(d, work) for d in (r0dir, r1dir))
        r1_first = min((r["ts"] for r in jsonl(r1_ev)
                        if r.get("ev") == "req"
                        and r.get("name") == "first_token"), default=None)
        series = fleet_series(r for r in TsdbReader(tsdb).read()
                              if r.get("ev") == "sample")
        crossing = next((t for t, v in series if v.get(
            "queue_depth_sum", 0.0) > 3.0), None)

        # the burn, the collector's black box, replica 0's window
        alerts = jsonl(work / "alerts.jsonl")
        burning = [a for a in alerts if a.get("kind") == "slo_burn"
                   and a.get("state") == "burning"]
        if not burning:
            bad.append(f"the TTFT objective never burned: {alerts}")
        dumps = flight.find_dumps(work)
        dump_info = []
        for p in dumps:
            payload = flight.verify_dump(p)  # raises on a torn one
            dump_info.append(dict(path=str(p.relative_to(work)),
                                  reason=payload["reason"],
                                  bytes=p.stat().st_size,
                                  records=len(payload["records"])))
        if not any(d["reason"] == "slo_burning"
                   and d["path"].startswith("collector_flight")
                   for d in dump_info):
            bad.append(f"the collector left no slo_burning dump: "
                       f"{dump_info}")
        final_ack = json.loads(ack.read_text()) if ack.exists() else {}
        prof_recs = [r for r in jsonl(r0_ev) if r.get("ev") == "profile"]
        if [r["op"] for r in prof_recs] != ["started", "stopped"] or \
                final_ack.get("status") != "stopped":
            bad.append(f"replica0's window: {prof_recs}, ack {final_ack}")
        traces = sorted((r0dir / "profiles").glob("*/*.pt.trace.json"))
        trace_bytes = traces[-1].stat().st_size if traces else None
        window = prof_recs[-1] if prof_recs else {}
        window_kernels = (trace_kernel_counts(traces[-1], EMBED_KERNELS)
                          if traces else {})
        if not traces or not all(window_kernels.values()):
            bad.append(f"replica0's window trace names {window_kernels}")
        vecs = [e for e in evs if e["event"] == "embedding"]
        if not all(e["dim"] == cfg.dim and np.isfinite(e["values"]).all()
                   for e in vecs):
            bad.append("an embedding is malformed")
        embeds_on = {w["id"]: hops.get(w["id"]) for w in embeds}
        if any(h != [0] for h in embeds_on.values()):
            bad.append(f"the embeds ran on {embeds_on}, not replica0 alone")
        embed_ts = [r["ts"] for r in jsonl(r0_ev) if r.get("ev") == "req"
                    and r.get("name") == "embed" and r.get("ph") == "b"]
        opened = [r["ts"] for r in prof_recs if r["op"] == "started"]
        if not embed_ts or not opened or not \
                opened[0] <= min(embed_ts) <= max(embed_ts) <= \
                (prof_recs[-1]["ts"] if len(prof_recs) > 1 else 0):
            bad.append(f"replica0 ran the embeds at {embed_ts}, outside "
                       f"its window {[r['ts'] for r in prof_recs]}")
        if len(receiver.bodies) < 1:
            bad.append("the receiver got no remote-write batch")

        # the offline tools, on the phase's own files
        t = time.perf_counter()
        rc_stitch, out_stitch = run_cli(telemetry_cli.main, [
            "stitch", str(router_ev), str(r0_ev), str(r1_ev),
            "--force-hosts", "--out", str(work / "stitched.json")])
        pids = {e.get("pid") for e in json.loads(
            (work / "stitched.json").read_text())["traceEvents"]} \
            if rc_stitch == 0 else set()
        if rc_stitch != 0 or pids != {0, 1, 2}:
            bad.append(f"stitch: rc {rc_stitch}, pids {pids}")
        coll_dumps = [work / d["path"] for d in dump_info
                      if d["path"].startswith("collector_flight")]
        rc_export, _ = run_cli(telemetry_cli.main, [
            "export-trace", str(coll_dumps[0]), "--out",
            str(work / "dump_trace.json")]) if coll_dumps else (None, "")
        if rc_export != 0:
            bad.append(f"export-trace of the collector's dump: {rc_export}")
        rc_slo, out_slo = run_cli(telemetry_cli.main, [
            "slo-report", "--objectives", str(work / "slo.toml"), "--tsdb",
            str(tsdb)])
        if rc_slo != 2 or "ttft_p95" not in out_slo:
            bad.append(f"slo-report over the TSDB: rc {rc_slo}")
        exemplar = next((ex["trace_id"] for a in burning
                         for exs in (a.get("exemplars") or {}).values()
                         for ex in exs if ex.get("trace_id")), None)
        rc_query, out_query = run_cli(telemetry_cli.main, [
            "query", "--trace", str(exemplar), "--tsdb", str(tsdb),
            "--events", str(router_ev)])
        if exemplar is None or rc_query != 0:
            bad.append(f"query of exemplar {exemplar}: rc {rc_query}")
        if not peak:
            bad.append("cli.top never showed both replicas up")
        tsdb_bytes = TsdbReader(tsdb).total_bytes()
        parts["offline"] = time.perf_counter() - t

        # the path's launches: each replica's own, from its exposition
        launches = {k: sum((replica_launches(d / "metrics.prom")[k] or 0)
                           for d in (r0dir, r1dir))
                    for k in per_forward(cfg)}
        want = {k: v * len(embeds) for k, v in per_forward(cfg).items()}
        if launches != want:
            bad.append(f"the replicas launched {launches}, not {want}")
        t = time.perf_counter()
        ticks = collector_tick_ms(sources, work / "slo.toml", work)
        cost = recorder_cost(model, work)
        ring = full_ring_dump(jsonl(router_ev) + jsonl(r0_ev) + jsonl(r1_ev),
                              work / "ring_flight")
        parts["in_process"] = time.perf_counter() - t
    except BaseException:
        for log in sorted(work.rglob("*.log")):  # the children's side
            print(f"--- {log.relative_to(work)}:\n"
                  f"{log_text(log)[-2000:]}", flush=True)
        raise
    finally:
        receiver.close()
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        # a router stopped mid-phase may leave the replicas it spawned
        for pid in re.findall(r"replica\d+: pid (\d+)",
                              log_text(work / "router.log")):
            cmd = log_text(Path(f"/proc/{pid}/cmdline"))
            if "progen_tpu_torch.cli.serve" in cmd and str(work) in cmd:
                with contextlib.suppress(ProcessLookupError):
                    os.kill(int(pid), signal.SIGKILL)
        shutil.rmtree(work, ignore_errors=True)
    out = dict(
        card=card, config="configs/model/base.toml", depth=cfg.depth,
        num_params=cfg.num_params(), generates=len(gens), new_tokens=OBS_NEW,
        embeds=len(embeds), first_wave=OBS_FIRST_WAVE, slots=1,
        ttft_threshold_s=OBS_TTFT_THRESHOLD_S,
        request_s=ref_s[0], references_s=sum(ref_s),
        queue_crossing_to_up_s=(up["ts"] - crossing)
        if up and crossing else None,
        spawn_to_first_token_s=(r1_first - up["ts"])
        if up and r1_first else None,
        down_to_exit_s=(marks["exit"] - down["ts"]) if down else None,
        burn_after_burst_s=burning[0]["ts"] - marks["burst"]
        if burning else None,
        collector_tick_ms=ticks, tsdb_bytes=tsdb_bytes,
        window_s=window.get("duration_s"),
        window_trace_bytes=trace_bytes,
        window_export_s=window.get("export_s"),
        window_kernels=window_kernels, embeds_on=embeds_on,
        window_opened_after_burst_s=opened[0] - marks["burst"]
        if opened else None,
        second_wave_after_burst_s=marks["wave2"] - marks["burst"],
        started_ack_after_burst_s=marks["ack"]["ts"] - marks["burst"],
        embeds_ran_after_burst_s=[t - marks["burst"] for t in embed_ts],
        replica1_took=took, dumps=dump_info, recorder=cost,
        full_ring_dump=ring,
        remote_write_batches=len(receiver.bodies),
        scale=[{k: r[k] for k in ("action", "reason", "current",
                                  "target", "ts")} for r in scales],
        peak_sources=[s["name"] for s in peak.get("snapshot", {}).get(
            "sources", []) if s["up"]], peak_frame=peak.get("frame"),
        streams_equal=len(gens) - len(unequal), launches=launches,
        parts_s=parts, seconds=time.perf_counter() - t_phase, budget_s=100)
    line("fleet_observability", **out)
    if bad:
        raise AssertionError("observability: " + "; ".join(bad))
    return out


# phase 15: continuous deployment at base.toml whole, in bfloat16: the
# deploy controller canaries, probes and promotes B across two one-slot
# replicas behind cli.router (SIGKILLed mid-promote and restarted), then
# canaries, probes and rolls back C
DEPLOY_NEW = 32  # new tokens of each generate request
DEPLOY_PROBES = 16  # held-out proteins of the probe (2 batches of 8)
DEPLOY_NOISE = 1e-3  # B: A plus a seeded relative noise of this size
DEPLOY_LOGITS_SCALE = 4.0  # C: A with its to-logits weight times this
DEPLOY_POLICY = """[deploy]
interval_s = 0.5
max_ppl_regression_pct = 1.0
probe_batch_size = 8
"""
# the probe's ppl against a float32 forward of the same sequences on the
# plain path: the token-weighted mean NLL within phase 3's per-sequence
# NLL tolerance (check_scores: 1e-2 nats)
PROBE_NLL_ATOL = 1e-2


def deploy_wave(wave: int) -> list:
    """The 2 generate lines of a wave: DEPLOY_NEW new tokens each."""
    primes = [PROTEINS[2 * wave + i][8:24] for i in range(2)]
    return [{"id": f"w{wave}-{i}", "prime": p, "length": 1 + len(p)
             + DEPLOY_NEW, "seed": 700 + 10 * wave + i}
            for i, p in enumerate(primes)]


def probe_fasta(path: Path, work: Path) -> list:
    """DEPLOY_PROBES proteins of phase 8's synthetic FASTA (its seed + 1,
    so none was trained on) into ``path``; their scorer records."""
    from progen_tpu_torch.data.fasta import parse_fasta
    from progen_tpu_torch.workloads import fasta_records

    full = work / "all.fasta"
    write_fasta(full, CLI_SEED + 1)
    with path.open("w") as f:
        for desc, seq in list(parse_fasta(str(full)))[:DEPLOY_PROBES]:
            f.write(f">{desc}\n{seq}\n")
    return list(fasta_records(str(path)))


def probe_reference(model32, records) -> float:
    """The token-weighted mean NLL of ``records`` under a float32 model on
    the plain path, batched and padded as the scorer does (base has gMLP
    layers: every batch at seq_len)."""
    from progen_tpu_torch.data.dataset import collate as collate_records
    from progen_tpu_torch.training.loss import sequence_scores

    seq_len = model32.config.seq_len
    total, tokens = 0.0, 0
    with torch.inference_mode(), plain_path():
        for i in range(0, len(records), 8):
            rows = [raw for _, raw in records[i:i + 8]]
            data = torch.from_numpy(collate_records(rows, seq_len)).long()
            data = data.to(model32.device)
            nll, _, mask = sequence_scores(model32(data[:, :-1]),
                                           data[:, 1:])
            n = mask.sum(-1)
            total += float((nll.double() * n.double()).sum())
            tokens += int(n.sum())
    return total / tokens


class PinWatch:
    """A thread that notes, every 50 ms, each replica's pin content and
    its ack: (time, replica, "pin"/"ack", content) on every change."""

    def __init__(self, rdirs):
        import threading

        self.rdirs, self.events, self._stop = rdirs, [], threading.Event()
        self._last = {}
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            now = time.time()
            for i, rdir in enumerate(self.rdirs):
                for kind, name in (("pin", "reload.pin"),
                                   ("ack", "reload.pin.ack")):
                    text = log_text(rdir / name).strip()
                    if text and self._last.get((i, kind)) != text:
                        self._last[(i, kind)] = text
                        self.events.append((now, i, kind, text))
            self._stop.wait(0.05)

    def close(self):
        self._stop.set()
        self._thread.join(5)

    def pin_to_ack(self) -> list:
        """Each pin write and the seconds until its committed ack."""
        out = []
        for t, i, kind, text in self.events:
            if kind != "pin":
                continue
            acked = next((t2 for t2, i2, k2, a in self.events
                          if i2 == i and k2 == "ack" and t2 >= t
                          and json.loads(a).get("pin") == text
                          and json.loads(a).get("status") == "committed"),
                         None)
            out.append(dict(replica=i, pin=text, ack_s=None if acked is None
                            else acked - t))
        return out


def phase_deploy(cfg, card: str, device: str = "cuda") -> dict:
    """Phase 15 (see the module docstring)."""
    import math
    import shutil
    import threading

    from progen_tpu_torch import ProGen
    from progen_tpu_torch.checkpoint import checkpoint_digest, digest_gauge
    from progen_tpu_torch.deploy import probe_stats, read_ledger
    from progen_tpu_torch.telemetry.trace import iter_jsonl

    t_phase = time.perf_counter()
    work = REPO / "build" / "chip_smoke_deploy"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ck, stage, deploy_dir = work / "ck", work / "staging", work / "deploy"
    rdirs = [work / "r0", work / "r1"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs, bad, parts, marks = [], [], {}, {}
    watch = None
    waves = [deploy_wave(w) for w in (1, 2, 3)]
    try:
        # A, published before the fleet starts; B and C staged meanwhile
        t = time.perf_counter()
        model_a = ProGen(cfg, device=device, seed=0).eval()
        names = {"A": save_params(stage, model_a)}
        # hard links: A stays in the staging root, so B's and C's names
        # there come after it
        shutil.copytree(stage / names["A"], ck / names["A"],
                        copy_function=os.link)
        parts["save_a"] = time.perf_counter() - t
        t_boot = time.perf_counter()
        for rdir in rdirs:
            procs.append(spawn_serve(
                ck, rdir, device, "--socket", str(rdir / "serve.sock"),
                "--heartbeat", "0.5", "--reload_watch", "0.5",
                "--reload_pin", str(rdir / "reload.pin")))
        boot_s = [None, None]

        def boots():  # each replica's spawn -> "listening on", while the
            # references below take this thread
            while None in boot_s and all(p.poll() is None for p in procs):
                for i, rdir in enumerate(rdirs):
                    if boot_s[i] is None and listening(rdir):
                        boot_s[i] = time.perf_counter() - t_boot
                time.sleep(0.05)

        boot_thread = threading.Thread(target=boots, daemon=True)
        boot_thread.start()
        t = time.perf_counter()
        gen = torch.Generator(device="cpu").manual_seed(15)
        sd_b = {k: v + DEPLOY_NOISE * v * torch.randn(
            v.shape, generator=gen).to(v) for k, v in
            model_a.state_dict().items()}
        model_b = ProGen(cfg, device=device, seed=None).eval()
        model_b.load_state_dict(sd_b)
        names["B"] = save_params(stage, model_b)
        sd_c = dict(model_a.state_dict())
        sd_c["to_logits.weight"] = sd_c["to_logits.weight"] * \
            DEPLOY_LOGITS_SCALE
        model_c = ProGen(cfg, device=device, seed=None).eval()
        model_c.load_state_dict(sd_c)
        names["C"] = save_params(stage, model_c)
        parts["save_b_c"] = time.perf_counter() - t
        if not names["A"] < names["B"] < names["C"]:
            raise AssertionError(f"checkpoint names out of order: {names}")
        letter = {v: k for k, v in names.items()}
        # the references, while the replicas boot: sample_fast on A (wave
        # 1) and B (wave 3); the probe set's float32 NLL under each
        t = time.perf_counter()
        refs = {w["id"]: fleet_reference(model_a, w) for w in waves[0]}
        refs.update({w["id"]: fleet_reference(model_b, w)
                     for w in waves[2]})
        records = probe_fasta(work / "probe.fasta", work)
        model32 = ProGen(dataclasses.replace(cfg, dtype="float32"),
                         device=device, seed=None).eval()
        nll32 = {}
        for key, model in (("A", model_a), ("B", model_b), ("C", model_c)):
            model32.load_state_dict(model.state_dict())
            nll32[key] = probe_reference(model32, records)
        del model32, model_c
        parts["references"] = time.perf_counter() - t
        wait_for(lambda: None not in boot_s, "the replicas listen", procs)
        boot_thread.join()
        parts["boot_wait"] = time.perf_counter() - t_boot
        watch = PinWatch(rdirs)

        lines = []
        router = subprocess.Popen(
            [sys.executable, "-m", "progen_tpu_torch.cli.router",
             *itertools.chain.from_iterable(
                 ("--replica", f"sock={r / 'serve.sock'},journal={r},"
                  f"prom={r / 'metrics.prom'}") for r in rdirs),
             "--prom_file", str(work / "router.prom"), "--metrics-every",
             "5"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=open(work / "router.log", "ab"), text=True, cwd=work,
            env=env)
        procs.append(router)
        reader = start_reader(router.stdout, lines)
        (work / "policy.toml").write_text(DEPLOY_POLICY)
        deploy_cmd = [
            sys.executable, "-m", "progen_tpu_torch.cli.deploy", "--device",
            device, "--checkpoint_path", str(ck), "--deploy_dir",
            str(deploy_dir), "--probe_fasta", str(work / "probe.fasta"),
            "--policy", str(work / "policy.toml"), "--alerts",
            str(work / "alerts.jsonl"),
            *itertools.chain.from_iterable(
                ("--replica", f"replica{i}={r}")
                for i, r in enumerate(rdirs))]
        ctl_log = work / "controller.log"

        def controller(chaos=""):
            proc = subprocess.Popen(
                deploy_cmd, stdin=subprocess.DEVNULL,
                stdout=subprocess.DEVNULL, stderr=open(ctl_log, "ab"),
                cwd=work, env=dict(env, PROGEN_CHAOS=chaos))
            procs.append(proc)
            return proc

        def ledger():
            return read_ledger(deploy_dir / "deploy.jsonl")

        def has(op, key):
            return any(r["op"] == op and r["ckpt"] == names[key]
                       for r in ledger())

        def settled(ids):
            done = [e["id"] for e in events_of(lines)
                    if e["event"] in ("done", "rejected")]
            return set(ids) <= set(done)

        def send(wave):
            router.stdin.write("".join(json.dumps(w) + "\n" for w in wave))
            router.stdin.flush()

        t_run = time.perf_counter()
        ctl1 = controller("deploy/promote:kill@1")
        wait_for(lambda: has("converged", "A"), "the adoption of A",
                 [ctl1, router])
        send(waves[0])
        wait_for(lambda: settled([w["id"] for w in waves[0]]), "wave 1",
                 [router])
        (stage / names["B"]).rename(ck / names["B"])  # publish B
        send(waves[1])
        rc_kill = ctl1.wait(timeout=600)
        if rc_kill != -9:
            raise AssertionError(f"the controller exited {rc_kill}, not by "
                                 "its SIGKILL at deploy/promote")
        wait_for(lambda: settled([w["id"] for w in waves[1]]), "wave 2",
                 [router])
        canary_pin = (rdirs[0] / "reload.pin").stat().st_mtime_ns
        n_banner = log_text(ctl_log).count("deploy: 2 replica(s)")
        t_restart = time.perf_counter()
        ctl2 = controller()
        wait_for(lambda: log_text(ctl_log).count("deploy: 2 replica(s)")
                 > n_banner, "the restart's replay", [ctl2])
        marks["replayed"] = time.perf_counter() - t_restart
        wait_for(lambda: has("promote", "B"), "the resumed promote",
                 [ctl2, router])
        marks["first_action"] = time.perf_counter() - t_restart
        wait_for(lambda: has("converged", "B"), "the convergence on B",
                 [ctl2, router], timeout=300)
        want_b = digest_gauge(checkpoint_digest(ck / names["B"]))

        def gauges():
            return ([prom_gauge(r / "metrics.prom",
                                "progen_serve_checkpoint_digest")
                     for r in rdirs],
                    [prom_gauge(work / "router.prom",
                                f"progen_router_replica{i}_checkpoint_digest")
                     for i in range(2)])

        wait_for(lambda: gauges() == ([want_b] * 2, [want_b] * 2),
                 "every digest gauge on B", [ctl2, router], timeout=60)
        gauges_b = gauges()
        repinned = (rdirs[0] / "reload.pin").stat().st_mtime_ns != canary_pin
        send(waves[2])
        wait_for(lambda: settled([w["id"] for w in waves[2]]), "wave 3",
                 [router])
        (stage / names["C"]).rename(ck / names["C"])  # publish C
        wait_for(lambda: has("rollback", "C"), "the rollback of C",
                 [ctl2, router], timeout=300)
        # r0 swings C -> B; the router re-exports what it scraped (every
        # 2 s), so only an exposition written 3 s after r0's commit of B
        # shows where the fleet ended
        back = wait_for(lambda: json.loads(log_text(
            rdirs[0] / "reload.pin.ack") or "{}").get("status") ==
            "committed" and json.loads(log_text(
                rdirs[0] / "reload.pin.ack"))["pin"] == names["B"] and
            time.time(), "r0's ack of the rollback to B", [ctl2, router],
            timeout=120)
        wait_for(lambda: gauges() == ([want_b] * 2, [want_b] * 2) and
                 (work / "router.prom").stat().st_mtime > back + 3.0,
                 "every digest gauge back on B", [ctl2, router], timeout=120)
        time.sleep(2.0)  # 4 more ticks: C is never retried
        gauges_end = gauges()
        ctl2.send_signal(signal.SIGTERM)
        rc_ctl = ctl2.wait(timeout=60)
        router.stdin.close()
        rc_router = router.wait(timeout=120)
        reader.join(60)
        parts["deploy"] = time.perf_counter() - t_run
        rcs = []
        for p in procs[:2]:
            p.send_signal(signal.SIGTERM)  # one drain signal each
            rcs.append(p.wait(timeout=120))
        watch.close()

        # the checks
        recs = ledger()
        ops = [(r["op"], letter.get(r["ckpt"]), r.get("replica"))
               for r in recs]
        want_ops = [("observed", "A", None), ("converged", "A", None),
                    ("observed", "B", None), ("canary", "B", "replica0"),
                    ("probe", "A", None), ("probe", "B", None),
                    ("promote", "B", "replica1"), ("converged", "B", None),
                    ("observed", "C", None), ("canary", "C", "replica0"),
                    ("probe", "C", None), ("rollback", "C", None)]
        if ops != want_ops:
            bad.append(f"the ledger's decisions {ops}, not {want_ops}")
        rollback = next((r for r in recs if r["op"] == "rollback"), {})
        if not str(rollback.get("reason", "")).startswith(
                "ppl_regression:") or rollback.get("to") != names["B"]:
            bad.append(f"C's rollback: {rollback}")
        if repinned:
            bad.append("the restarted controller rewrote the canary's pin")
        if rc_ctl != 0 or rc_router != 0 or rcs != [0, 0]:
            bad.append(f"exit codes: controller {rc_ctl}, router "
                       f"{rc_router}, replicas {rcs}")
        if gauges_b != ([want_b] * 2, [want_b] * 2) or \
                gauges_end != gauges_b:
            bad.append(f"digest gauges {gauges_b} then {gauges_end}, not "
                       f"{want_b} everywhere")
        for rdir in rdirs:
            ack = json.loads(log_text(rdir / "reload.pin.ack") or "{}")
            if ack.get("pin") != names["B"] or \
                    ack.get("status") != "committed":
                bad.append(f"{rdir.name}'s last ack {ack}, not B committed")
        alerts = [a for a in jsonl(work / "alerts.jsonl")
                  if a.get("ev") == "alert"]
        if [(a.get("kind"), a.get("objective")) for a in alerts] != \
                [("deploy_rollback", names["C"])]:
            bad.append(f"alerts {alerts}, not one deploy_rollback of C")
        evs = events_of(lines)
        ids = sorted(w["id"] for wave in waves for w in wave)
        done = sorted(e["id"] for e in evs if e["event"] == "done")
        pairs = [(e["id"], e["index"]) for e in evs
                 if e["event"] == "token"]
        if done != ids or any(e["event"] == "rejected" for e in evs) or \
                len(set(pairs)) != len(pairs):
            bad.append(f"settled {done} of {ids}, or a token twice")
        streams = {}
        for e in evs:
            if e["event"] == "token":
                streams.setdefault(e["id"], {})[e["index"]] = e["token"]
        unequal = [w["id"] for w in waves[0] + waves[2] if not stream_check(
            streams.get(w["id"], {}), refs[w["id"]], first_generated(w))]
        if unequal:
            bad.append(f"streams differ from sample_fast: {unequal}")
        probes = {}
        for r in recs:
            if r["op"] != "probe":
                continue
            key = letter[r["ckpt"]]
            shards = probe_stats(deploy_dir / "probes" / r["ckpt"])
            probes[key] = dict(ppl=r["ppl"], n=r["n"], tokens=r["tokens"],
                               nll=math.log(r["ppl"]), nll_f32=nll32[key],
                               d_nll=abs(math.log(r["ppl"]) - nll32[key]))
            if shards != {k: r[k] for k in ("ppl", "n", "tokens")}:
                bad.append(f"probe {key}: ledger {r}, shards {shards}")
            if r["n"] != DEPLOY_PROBES or \
                    not probes[key]["d_nll"] <= PROBE_NLL_ATOL:
                bad.append(f"probe {key}: {probes[key]}")
        spans = {}
        for path in sorted(work.glob("runs/progen-deploy/*/events.jsonl")):
            for r in iter_jsonl(path):
                if r.get("ev") == "E" and r.get("span") == "deploy/probe":
                    spans[letter[r["ckpt"]]] = r["dur_s"]
        for key, p in probes.items():
            steps = [r["step_s"] for r in jsonl(
                deploy_dir / "probes" / names[key] / "score_journal.jsonl")
                if r.get("op") == "batch"]
            p.update(probe_s=spans.get(key), score_s=sum(steps),
                     sequences_per_s=p["n"] / sum(steps) if steps else None)
        m = re.findall(r"^deploy: \d+ ticks, .* launches (\{.*\})$",
                       log_text(ctl_log), re.M)
        launches = json.loads(m[-1]) if m else {}
        batches = -(-DEPLOY_PROBES // 8)
        want = {k: v * batches for k, v in per_forward(cfg).items()}
        if launches != want:
            bad.append(f"the restarted controller's probe launched "
                       f"{launches}, not {want}")
        ts = {(r["op"], letter[r["ckpt"]]): r["ts"] for r in recs}
        reload_lines = {rdir.name: [float(x) for x in re.findall(
            r"\(load \+ commit (\S+) s\)", log_text(rdir / "stderr.log"))]
            for rdir in rdirs}
    except BaseException:
        for log in sorted(work.rglob("*.log")):
            print(f"--- {log.relative_to(work)}:\n"
                  f"{log_text(log)[-2000:]}", flush=True)
        raise
    finally:
        if watch is not None:
            watch.close()
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        shutil.rmtree(work, ignore_errors=True)
    out = dict(
        card=card, config="configs/model/base.toml", depth=cfg.depth,
        num_params=cfg.num_params(), slots=1, probes=DEPLOY_PROBES,
        noise_b=DEPLOY_NOISE, logits_scale_c=DEPLOY_LOGITS_SCALE,
        probe=probes, probe_nll_atol=PROBE_NLL_ATOL, boot_s=boot_s,
        pin_to_ack_s=watch.pin_to_ack(), reload_load_commit_s=reload_lines,
        observed_to_converged_s=ts[("converged", "B")] - ts[("observed",
                                                             "B")],
        observed_to_rollback_s=ts[("rollback", "C")] - ts[("observed", "C")],
        restart_to_replayed_s=marks["replayed"],
        restart_to_first_action_s=marks["first_action"],
        rollback_reason=rollback.get("reason"), ops=[o[:2] for o in ops],
        streams_equal=len(waves[0] + waves[2]) - len(unequal),
        digest_b=want_b, launches=launches, parts_s=parts,
        seconds=time.perf_counter() - t_phase, budget_s=100)
    line("deploy", **out)
    if bad:
        raise AssertionError("deploy: " + "; ".join(bad))
    return out


def check_training(run: dict) -> None:
    """Phase 6c: every loss and grad norm finite, no step refused, and a
    lower loss on the repeated batch after the steps than before."""
    for st in run["steps"]:
        if not (np.isfinite(st["loss"]) and np.isfinite(st["grad_norm"])
                and st["skipped"] == 0):
            raise AssertionError(f"train step not finite or skipped: {st}")
    if not run["loss_after"] < run["loss_before"]:
        raise AssertionError(f"loss did not fall: {run['loss_before']} -> "
                             f"{run['loss_after']}")


def main() -> int:
    parser = argparse.ArgumentParser(
        description="Drive the PyTorch port on one NVIDIA card.")
    parser.add_argument("--details", type=Path,
                        default=REPO / "build" / "chip_smoke.json",
                        help="where to write the full results as JSON")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from progen_tpu_torch import ProGen, ProGenConfig, load_toml_config
    from progen_tpu_torch.data.tokenizer import encode_tokens

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    build = phase_build()
    cfg = ProGenConfig.from_dict(load_toml_config(
        str(REPO / "configs" / "model" / "base.toml")))
    cfg8k = long8k_config()
    rows = phase_kernels(cfg, cfg8k, card)

    t = time.perf_counter()
    model = ProGen(cfg, device="cuda", seed=0).eval()
    model32 = ProGen(dataclasses.replace(cfg, dtype="float32"),
                     device="cuda", seed=None).eval()
    model32.load_state_dict(model.state_dict())
    line("model", params=sum(p.numel() for p in model.parameters()),
         num_params=cfg.num_params(), init_s=time.perf_counter() - t)

    batch = collate(PROTEINS, cfg.seq_len)
    primes = np.stack([encode_tokens(s) for s in PRIMES])
    run = drive_main_path(cfg, model, batch, primes)
    result = {"launches": run["launches"],
              "score": check_scores(cfg, model, model32, batch, run),
              "generate": check_generation(cfg, model, model32, primes, run),
              "profile": profile_forward(model, batch[:, :-1].cuda())}
    del model, model32

    from progen_tpu_torch.training.step import init_train_state

    t = time.perf_counter()
    state = init_train_state(cfg, device="cuda", seed=0)
    line("train state", params=state.num_params(),
         init_s=time.perf_counter() - t, remat=cfg.remat)
    train = drive_train_path(cfg, state, train_batch(cfg))
    check_training(train)
    result["train"] = train
    fbatch = full_batch(cfg)
    result["grad_check"] = check_gradients(cfg, state, fbatch)
    result["halo_step"] = halo_step(cfg, state, fbatch)
    del state, fbatch
    result["seqpar"] = phase_seqpar(cfg8k, card)
    result["cli"] = phase_cli(cfg, train)
    result["serve"] = phase_serve(
        dataclasses.replace(cfg, depth=SERVE_DEPTH),
        2 * result["generate"]["plain_vs_f32"] + 1e-3, card)
    result["workloads"] = phase_workloads(
        dataclasses.replace(cfg, depth=WL_DEPTH), result["score"], card)
    result["grid"] = phase_grid(cfg, card, build["tensor_core_kernels"])
    result["resilience"] = phase_resilience(cfg, card, result)
    result["fleet"] = phase_fleet(dataclasses.replace(cfg, depth=FLEET_DEPTH),
                                  card)
    result["observability"] = phase_observability(cfg, card)
    result["deploy"] = phase_deploy(cfg, card)

    # each kernel's launches, summed over the paths driven with counts:
    # scoring + generation, the 3 train steps, the A3 step, the seqpar
    # ranks' 3 steps and A4 halo-backward step (the single-process
    # comparison there is left out), the CLIs' steps and evals, the
    # serving engine's run, the workloads' scorer, scans and n = w
    # scorer (their child processes count apart and are left out), and
    # the grid ranks' steps (single-process comparisons left out), the
    # resumed cli.train, the fleet replica's embed forward and phase 14's
    # replicas' embed forwards (each counted in its own process, read from
    # its exposition), and phase 15's restarted deploy controller's probe
    # (read from its closing summary line)
    paths = dict(inference=run["launches"], train=train["launches"],
                 halo_step=result["halo_step"]["launches"],
                 seqpar=result["seqpar"]["launches"],
                 cli=result["cli"]["launches"],
                 serve=result["serve"]["launches"],
                 workloads=result["workloads"]["launches"],
                 grid=result["grid"]["launches"],
                 resilience=result["resilience"]["launches"],
                 fleet=result["fleet"]["launches"],
                 observability=result["observability"]["launches"],
                 deploy=result["deploy"]["launches"])
    counts = {k: sum(c[k] for c in paths.values()) for k in run["launches"]}
    line("launches", **paths, total=counts)
    if not all(counts.values()):
        raise AssertionError(f"a kernel was never launched: {counts}")
    table = [{
        "name": r["name"], "route": r["route"], "source": r["source"],
        "replaces": r["replaces"], "launches": counts[r["id"]],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "device_ms": r["device_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    } for r in rows]
    args.details.parent.mkdir(parents=True, exist_ok=True)
    args.details.write_text(json.dumps(
        {"card": card, "kernels": rows, "main_path": result,
         "build": build}, indent=1, default=float))
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
