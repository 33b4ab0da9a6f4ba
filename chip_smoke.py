#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`elasticdl_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions; builds every kernel in `elasticdl_tpu_torch/csrc/` with
   nvcc, one process per source, and prints the build time, each
   kernel's registers, shared memory and spills (ptxas) and the count of
   HGMMA (wgmma) instructions in the SASS of the tensor-core flash
   kernels, forward and backward (each must have some).
2. Holds each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and short ragged ones, and times the kernel,
   the plain version and the library call that computes the same
   function (`library_ms`, a yardstick the port never calls).  Each
   flash row records which variant ran: bf16 must run `sm90_wgmma`, f32
   `cuda_core`.  The scatter-add must equal its plain version (on CPU
   copies) bit for bit, and itself across two launches, at the rows of
   every DeepFM path: the Trainer's timed batch, the first `wire_deepfm`
   batch (whose dedup planes, decoded on the card, must give its hashed
   rows bit for bit) and the Local jobs' first batch, each at D = 16
   and 1; its rows count the long segments and the kernel time per id
   of the longest one.
3. Serves BERT-base (hidden 768, 12 layers, 12 heads, MLP 3072, vocab
   8192, L=512, bf16, random weights from a seed) through ServingEngine
   + DynamicBatcher with buckets (1, 4, 16, 64): seeded requests of 1-64
   rows from several client threads.  Every result must be OK, finite
   and of shape (rows, 2), and the kernel launch counts must show that
   every layer of every executed batch went through the tensor-core
   flash kernel (`flash_attention.launches_by_kernel`).  One
   4-row batch is checked in f32 against the same weights on the CPU
   (the plain path).
4. Trains DeepFM at bench.py's width (vocab 2^20, dim 16, MLP 256/128,
   bf16 MLP with f32 parameters, lr 5e-3, bf16 features) through the
   port's Trainer: the convergence protocol of bench.py's _deepfm_auc
   (32 steps of 4096, AUC on 16384 held-out rows, in [0.79, 0.86]), 20
   timed steps of 16384, a profiled step, and a K=4 stacked run that
   must equal 4 flat steps bit for bit.  Every step must launch the
   scatter-add kernel twice (one per arena).  A few f32 steps at vocab
   2^16 are checked against the same weights on the CPU.
5. Runs the Local runner end to end at the same width (`local_deepfm`):
   131,072 Criteo-format records in 2 TFRecord shards and 16,384
   validation records written with the port's `write_dataset`; a train
   job built from the command line's parser (batch 4096, 8 tasks of
   16,384 records = 32 steps, an eval round every 16 steps, checkpoints
   every 8 steps keeping 3, an event log) must finish with no failed
   task, complete event chains, an exact AUC in [0.79, 0.86], 64
   scatter-add launches and steps 16/24/32 retained and intact; an
   evaluate job from that checkpoint must reproduce the AUC within
   1e-6; a two-worker train job must finish in the band too.  Then, on
   the same dataset, a `--wire_format dedup --steps_per_execution 4`
   job and an `--arena_dtype int8` job with checkpoints, each with no
   failed task, an AUC in the band and 64 scatter-add launches, and an
   `evaluate` job from the int8 checkpoint that must reproduce its AUC.
6. Drives the bare Trainer at bench.py::bench_deepfm_e2e's shape
   (`wire_deepfm`: batch 65536, vocab 2^20, dim 16, bf16 MLP, K = 8
   steps per train_on_batch_stack) on the same records through the
   plain, compact and dedup wire formats, and the int8 arena on the
   plain one: bytes per example on the link, host pack and host-to-device
   ms per batch, step ms (CUDA events), the decode's device ms inside a
   profiled step (the `wire_decode` range) and alone, the int8 lookup
   and fold device ms, and the scatter-add launches (2 per step).  The
   compact and dedup losses must be equal bit for bit.  On the int8
   arena one more step runs with each arena's output gradient captured:
   the carrier gradients (the scatter-add kernel behind `_GradTap`) must
   equal the plain scatter-add of those gradients on the CPU bit for bit.

7. Holds the flash-attention backward kernel against its plain version
   (`_flash_bwd`) on the card, on the plain forward's residuals, and
   against itself across two calls (bitwise): at (64, 512, 12 x 64) bf16
   from fused-QKV views, causal and not (the `sm90_wgmma` variant, as
   every bf16 case at D 64/128), f32 at D = 16, ragged L = 72 and 200,
   H = 6 (lse's per-head stride of 24 B), D = 128, and the tiny Local
   BERT job's (64, 32, 4 x 16) f32 from fused-QKV views
   (`check_flash_bwd`; step 2 holds the forward at that shape too);
   timed beside the plain version, the bound and SDPA's backward, with
   the kernel's device time split by launch (prep, dK/dV, dQ).
8. Trains BERT-base through the bare Trainer at bench.py::bench_bert's
   shape (batch 64, L 512, full width, bf16, the zoo's AdamW), without
   and with remat (`train_bert`): one counted step, then timed steps
   (`Trainer.timed_steps_per_sec`), peak memory and a profiled step's
   device time by group.  Each step must launch the flash backward 12
   times, the forward 12 times (24 with remat) and the scatter-add once
   (the token table, also held bitwise to its plain version at these
   rows in step 2).  A small f32 BERT is checked against the CPU.
9. Runs the Local runner on BERT (`local_bert`): the planted-pairs job
   of tests/test_bert.py (hidden 64, L 32, 384 steps) must reach an
   accuracy above 0.9, and an evaluate job from its checkpoint must
   reproduce its metrics exactly; then one epoch of 2048 records at
   bench_bert's width, checkpointed once at its end, for its wall and
   examples/s.  Both must launch the flash backward once per layer and
   step.
10. Serves the Local DeepFM job's files with `serve` over a socket on
   127.0.0.1 (`serve_cli_deepfm`, `build_serving_server` on parsed serve
   args, `ServingStub` clients): mixed seeded traffic, all OK; the
   16,384 validation records, whose AUC must equal the job's eval AUC
   within 1e-4; a newer step written under traffic, with every response
   from one whole step (its forward within SERVE_STEP_TOL) and one
   reload; a truncated step rejected while serving goes on; the job's
   `--output` export through `serve --export_dir`, bitwise against a
   checkpoint-backed engine at every bucket; the int8 job's checkpoint
   through `--arena_dtype int8` (AUC within 1e-4 of that job's), and the
   fp32 checkpoint converted into the int8 config, bitwise against its
   own forward.  Prints requests/s, p50/p99, decode and respond ms, the
   reload's verify/restore/swap seconds and the peak device memory while
   two generations coexist.
11. Serves the full-width Local BERT job's checkpoint with `serve
   --checkpoint_dir` (`serve_cli_bert`): serve_bert's 40 requests over
   the socket; the flash forward must launch 12 x (buckets + batches)
   times, all on `sm90_wgmma`; its requests/s and latency print beside
   serve_bert's in-process figures.
12. Trains DeepFM over the tiered embedding store through the bare
   Trainer at full width (`tiered_deepfm`).  (a) Parity: flat at vocab
   2^20 against a 2^16-row cache on an all-hot, collision-free working
   set (26 x 2,000 rows; host tier backfilled from the flat init), batch
   4096, 8 steps: losses and trained rows equal bit for bit, predictions
   within 4 ulp; a K = 8 union block against the flat 8-step stack, bit
   for bit; the int8 cache against the int8 arena, gaps reported.  (b)
   Real size: a 2^20-row cache per plane, batch 16384 from a seeded
   zipf(1.2) stream over 2^22 ids per field, the store's threads running
   and planning on a producer thread, until the vocabulary passes 2^21
   rows: per step the hits, misses, admissions, evictions, vocabulary
   rows, host bytes, prepare ms, the seam's read and admit ms (host and
   device; ROADMAP.md's later kernel 7), cold-gather seconds, step ms
   and 2 scatter-add launches; a profiled step's busy share; then the
   stream's first 24 steps on an int8 cache.  The scatter-add is also held bitwise
   against its plain version at the cache slots of (b)'s first batch.
13. Runs `elasticdl train --model_def deepfm.deepfm_tiered.custom_model`
   on local_deepfm's records (`local_tiered`: batch 4096, 32 steps, a
   20,480-row cache below the 25,913 rows the records grow, checkpoints
   every 8 keeping 3): one worker, two workers (deferred planning), K = 4
   union blocks and the int8 cache, each exiting 0 with 64 scatter-add
   launches, its threads ticked and stopped and one sidecar per kept
   step.  The one-worker job's last step is served in process through
   TieredServingEngine: the validation records' AUC in [0.79, 0.86]
   beside the flat job's, resident rows against Trainer.predict_on_batch
   on the restored state, never-seen ids finite, a newer step swapped in
   by the reloader under traffic with no failed request, and a step
   without its sidecar rejected while serving goes on.
14. Runs the rest of the zoo as `elasticdl train` Local jobs at each
   model's default width (`zoo_local`), each exiting 0 with no failed
   task, its steps, its scatter-add launches (2 a step for the two
   embedding arenas of Wide & Deep and xDeepFM, 0 for the others) and its
   metric in its band: Wide & Deep on the census protocol (8,192 CSV
   rows, 4 epochs at 512, AUC on 4,096 held-out rows in [0.68, 0.80]),
   then on the same rows from a SQLite table, with per-step losses and
   metrics equal to the CSV job's bit for bit; xDeepFM (vocab 2^18, dim
   16, CIN (64, 64), MLP (256, 128)) on local_deepfm's records, its AUC
   within 0.01 of its JAX twin's, then a bare Trainer's step ms, a
   profiled step and the CIN alone; both MNIST styles (2,048 records, 4
   epochs at 128, accuracy in [0.99, 1.0]), the functional job's
   checkpoint served with `serve` over 127.0.0.1 at the job's accuracy;
   ResNet-50 at full depth on the cifar10 protocol (16 SGD-momentum
   steps of 64, accuracy on 512 held-out records in [0.60, 1.0]), its
   running statistics moved and restored by an evaluate job that scores
   the same, then a bare Trainer's step ms, peak memory and a profiled
   step's busy share and convolution share; ctr_mlp on seeded click
   dicts through a registered `clicks://` reader, above the majority
   class.  Step 2 holds the scatter-add bitwise at Wide & Deep's and
   xDeepFM's arena rows.
15. Local DeepFM jobs that survive a crash and injected faults
   (`resilient_local`, right after `local_deepfm`, on its records and
   flags).  (a) The train job runs through the port's CLI in a
   subprocess and is SIGKILLed once its event log shows step 16's
   checkpoint committed and 4 training reports (a seeded 2.5 s delay at
   rpc.report's 8th hit, from ELASTICDL_FAULT_SCHEDULE, holds it there,
   before step 24's checkpoint); relaunched in process with the same
   flags, it must restore step 16, train only the 4 shards after the
   cutoff (16 steps, 32 scatter-add launches), count 131,072 training
   records, land its AUC in [0.79, 0.86], and end with a state.pt equal
   bit for bit to the uninterrupted `local_deepfm` job's (as the JAX
   package's resumed job equals its own on the CPU).  (b) The same job
   twice under one seeded schedule of raises, drops and delays at
   rpc.get_task, rpc.report and checkpoint.write, with millisecond
   backoff: full coverage, every fault fired, non-zero retry and fault
   counters, the AUC in the band, byte-identical traces.  (c) A job
   with `--profile_dir` and `--tensorboard_log_dir`: one Chrome trace,
   worker 0's first task, whose scatter-add kernels number 2 per step of
   that task; whether the summary writer was active, and why.  (d) The
   native TFRecord index of every record file, through
   `record_io.build_index` (whose count must show the native path), against
   the Python scanner's, int64 bit for bit, both timed.  Then, once (a)'s
   subprocess has ended, the job's reads through each scanner (native,
   python, python, native): one pass of `read_bulk` over its task ranges
   and the whole job's wall, data_wait and pack (the jobs read in
   Python; the native pass is a comparison).  (b) and (c) run beside (a)'s
   subprocess, so their times are taken under that overlap.
16. Streams and judgment (`stream_judgment`, after `resilient_local`;
   budget 25 s).  (a) 32 windows of a ClickStreamSource (the JAX online
   loop's shape: 128 records a window, 32 a task, 64 a poll, 512 users x
   128 items, a 64-window buffer) through a StreamReader and a journaled
   TaskManager(perpetual=True) into ctr_mlp's Trainer on the card, one
   fake clock throughout: a stalled `stream.poll`, a skipped `task.rearm`
   (the window is offered again and arms once), a burst poll past the
   buffer's cap that drops an armed window, which `restore_window`
   replays from the ledger record for record, and a restart of the task
   manager from its journal mid-window.  32 windows armed and released,
   none lost, no duplicate report; a WindowLineage tapped before the
   first poll decomposes every window's ingest_wait and arm_wait (later
   phases wait for the online loop).  A second run must give the same
   events (bar wall-time fields) and parameters bit for bit, and the
   first window's losses must equal the CPU's from the same weights
   within 1e-5.  (b) local_deepfm's train job with `--history_interval
   0.5 --slo_interval 0.5 --incident_dir`: in the AUC band, 64
   scatter-add launches, its final `state.pt` bit for bit local_deepfm's,
   all four SLOs `no_data`, a manual bundle read back; then a freshness
   drill: (a)'s checkpoints produced one by one through a CheckpointSaver
   and served by a ServingEngine + CheckpointReloader, each predict's
   step into a FreshnessTracker, its registry into a MetricHistory, the
   staleness_p99 SLO `ok` while reloads keep up and `breach` once a
   reload is held past the 30 s objective, and exactly one slo_breach
   bundle from the flight recorder.

Exits non-zero on any failure; nothing is caught.  Without CUDA it exits
1 before printing any result.  The line before the last is the `kernels`
JSON; the last is {"ok": true, "device": {...}}.  The measured numbers,
with each phase's wall seconds, also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from elasticdl_tpu_torch.client import api  # noqa: E402
from elasticdl_tpu_torch.client import main as cli  # noqa: E402
from elasticdl_tpu_torch.common import events  # noqa: E402
from elasticdl_tpu_torch.common import faults, resilience  # noqa: E402
from elasticdl_tpu_torch.common.faults import (  # noqa: E402
    FaultRegistry,
    FaultSpec,
)
from elasticdl_tpu_torch.common.export import feature_meta  # noqa: E402
from elasticdl_tpu_torch.common.flight import (  # noqa: E402
    FlightRecorder,
    list_bundles,
    load_bundle,
)
from elasticdl_tpu_torch.common.history import MetricHistory  # noqa: E402
from elasticdl_tpu_torch.common.lineage import (  # noqa: E402
    WindowLineage,
    decompose,
    from_events,
)
from elasticdl_tpu_torch.common.model_handler import (  # noqa: E402
    ZOO_DIR,
    get_model_spec,
)
from elasticdl_tpu_torch.data.wire import (  # noqa: E402
    DedupPacker,
    plane_tensor,
    unpack_rows_dedup,
)
from elasticdl_tpu_torch.layers.arena import (  # noqa: E402
    arena_rows,
    dequantize_rows,
    fold_quantized_updates,
)
from elasticdl_tpu_torch.layers.embedding import (  # noqa: E402
    hash_ids,
    hash_ids_host,
)
from elasticdl_tpu_torch.layers.linen import init_parameters  # noqa: E402
from elasticdl_tpu_torch.model_zoo.bert.data import (  # noqa: E402
    write_dataset as write_pairs,
)
from elasticdl_tpu_torch.model_zoo.common.metrics import auc  # noqa: E402
from elasticdl_tpu_torch.model_zoo.deepfm import (  # noqa: E402
    deepfm_functional_api as fm_zoo,
)
from elasticdl_tpu_torch.model_zoo.deepfm import (  # noqa: E402
    deepfm_tiered as tiered_zoo,
)
from elasticdl_tpu_torch.model_zoo.deepfm.data import (  # noqa: E402
    synthetic_criteo,
    write_dataset,
)
from elasticdl_tpu_torch.model_zoo.deepfm.deepfm_functional_api import (  # noqa: E402,E501
    NUM_SPARSE,
    RECORD_BYTES,
    hash_field_rows_host,
    sparse_field_rows,
)
from elasticdl_tpu_torch.ops import _build  # noqa: E402
from elasticdl_tpu_torch.ops import flash_attention as fa  # noqa: E402
from elasticdl_tpu_torch.ops import scatter_add as sa  # noqa: E402
from elasticdl_tpu_torch.serving.batcher import (  # noqa: E402
    OK,
    DynamicBatcher,
)
from elasticdl_tpu_torch.common.save_utils import (  # noqa: E402
    ArenaDtypeMismatch,
    CheckpointSaver,
    committed_steps,
    read_produced_meta,
)
from elasticdl_tpu_torch.common.slo import (  # noqa: E402
    SLO_NAMES,
    SloEvaluator,
    shipped_specs,
)
from elasticdl_tpu_torch.data import native_io, record_io  # noqa: E402
from elasticdl_tpu_torch.data.reader import (  # noqa: E402
    ClickStreamSource,
    MemoryDataReader,
    StreamReader,
    TFRecordDataReader,
    register_data_reader,
)
from elasticdl_tpu_torch.master.freshness import FreshnessTracker  # noqa: E402,E501
from elasticdl_tpu_torch.master.task_manager import TaskManager  # noqa: E402,E501
from elasticdl_tpu_torch.model_zoo.census import data as census_data  # noqa: E402,E501
from elasticdl_tpu_torch.model_zoo.census import (  # noqa: E402
    wide_and_deep as census_zoo,
)
from elasticdl_tpu_torch.model_zoo.cifar10 import data as cifar_data  # noqa: E402,E501
from elasticdl_tpu_torch.model_zoo.clickstream import (  # noqa: E402
    ctr_mlp as ctr_zoo,
)
from elasticdl_tpu_torch.model_zoo.mnist import data as mnist_data  # noqa: E402,E501
from elasticdl_tpu_torch.proto import messages as pb  # noqa: E402
from elasticdl_tpu_torch.proto import serving as spb  # noqa: E402
from elasticdl_tpu_torch.proto.service import ServingStub  # noqa: E402
from elasticdl_tpu_torch.serving.engine import (  # noqa: E402
    ServingEngine,
    build_state_template,
)
from elasticdl_tpu_torch.serving.reloader import (  # noqa: E402
    CheckpointReloader,
)
from elasticdl_tpu_torch.store import checkpoint as store_ckpt  # noqa: E402
from elasticdl_tpu_torch.store import device as store_device  # noqa: E402
from elasticdl_tpu_torch.store.serving import (  # noqa: E402
    TieredServingEngine,
)
from elasticdl_tpu_torch.serving.server import (  # noqa: E402
    from_tensor_proto,
    make_predict_request,
)
from elasticdl_tpu_torch.worker.task_data_service import (  # noqa: E402
    prefetch_batches,
)
from elasticdl_tpu_torch.worker.trainer import Trainer  # noqa: E402

SEED = 0
# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# per-type operation rates.  Bounds are stated against these, beside the
# card's power limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

BERT_PARAMS = "hidden=768;num_layers=12;heads=12;mlp_dim=3072;max_len=512"
NUM_LAYERS = 12
SEQ_LEN = 512
VOCAB = 8192
BUCKETS = (1, 4, 16, 64)
CLIENT_THREADS = 4
REQUESTS_PER_CLIENT = 10
# serve defaults of the JAX CLI (--max_batch_latency_ms 10,
# --max_queue_rows 0 -> 4 x max_batch)
MAX_LATENCY_S = 0.010

# Tolerances, kernel vs plain version on the same inputs.  Both
# accumulate in f32 in another order; bf16 outputs are then rounded to
# bf16, where one rounding step is 2^-8 relative, so 2e-2 allows two
# steps at |out| < 2.  lse is f32 in both.
TOL = {
    torch.float32: {"out": 1e-4, "lse": 1e-4},
    torch.bfloat16: {"out": 2e-2, "lse": 1e-3},
}
# f32 logits of BERT-base, card (kernel) vs CPU (plain path), same
# weights: 12 layers of f32 sums in another order.
F32_LOGITS_TOL = 1e-3
# the served bf16 logits vs those f32 logits: bf16 rounding through 12
# layers (measured 0.014 at a logit scale of 1.65 on an H100).
BF16_LOGITS_TOL = 0.1

# DeepFM as bench.py's bench_deepfm and _deepfm_auc configure it
DEEPFM = "deepfm.deepfm_functional_api.custom_model"
DEEPFM_PARAMS = "vocab_capacity=1048576;embed_dim=16;bf16=True;lr=0.005"
DEEPFM_VOCAB = 1 << 20
DEEPFM_DIM = 16
AUC_STEPS = 32
AUC_BATCH = 4096
AUC_BAND = (0.79, 0.86)          # docs/CONVERGENCE.md
AUC_CHUNK = 64                   # rows per request of the served AUC pass
TIMED_BATCH = 16384
TIMED_STEPS = 20
WARMUP_STEPS = 5
STACK_K = 4
# card vs CPU, f32 at vocab 2^16: per-step losses differ by the order of
# the f32 sums (cuBLAS vs the CPU's products; measured 6e-8 at a loss of
# ~0.7 on an NVIDIA H100 80GB HBM3 at 700 W); predictions after the
# steps also carry Adam's amplification of tiny gradient differences (an
# update moves by up to lr where a gradient is near zero), so they get a
# wider bound (measured 5.4e-7 at a prediction scale of 2.0, same card).
CPU_CHECK_PARAMS = "vocab_capacity=65536;embed_dim=16;bf16=False;lr=0.005"
CPU_CHECK_STEPS = 4
CPU_CHECK_BATCH = 1024
CPU_LOSS_TOL = 1e-4
CPU_PRED_TOL = 1e-3

# The Local job: bench.py's _deepfm_auc protocol and the
# docs/CONVERGENCE.md DeepFM row, through the command line's flags
LOCAL_TRAIN = 131072
LOCAL_SHARDS = 2
LOCAL_VAL = 16384
LOCAL_RECORDS_PER_TASK = 16384
LOCAL_TASKS = LOCAL_TRAIN // LOCAL_RECORDS_PER_TASK          # 8
LOCAL_STEPS = LOCAL_TRAIN // AUC_BATCH                       # 32
LOCAL_EVAL_STEPS = 16
LOCAL_CKPT_STEPS = 8
LOCAL_KEEP = 3
# evaluate-from-checkpoint AUC vs the train job's final AUC: the same
# weights and kernels on the same rows
LOCAL_EVAL_AUC_TOL = 1e-6
TASK_CHAIN = [events.TASK_DISPATCHED, events.TASK_CLAIMED,
              events.TASK_TRAINED, events.TASK_REPORTED]

# The bare Trainer at bench.py::bench_deepfm_e2e's shape, per wire format
WIRE_BATCH = 65536
WIRE_K = 8
WIRE_FORMATS = ("plain", "compact", "dedup", "plain-int8")
# the named profiler ranges of the wire decode and the int8 arena
RANGES = ("wire_decode", "int8_lookup", "int8_fold")

# Flash backward, kernel vs plain on the same inputs: both accumulate in
# f32 in another order; bf16 gradients are then rounded to bf16, so the
# bound is two rounding steps (2^-7) of the gradient's largest magnitude;
# f32 keeps 1e-5 of it.
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}

# BERT-base training as bench.py::bench_bert configures it: batch 64,
# L 512, full width, bf16 compute, the zoo's AdamW (lr 2e-5, wd 0.01)
BERT = "bert.bert_finetune.custom_model"
TRAIN_BATCH = 64
TRAIN_TIMED_STEPS = 8
# f32 card vs CPU, a small BERT at D = 64 (the CUDA-core kernels): the
# per-step losses differ by the order of f32 sums (cuBLAS and the flash
# kernels vs the CPU's products), which AdamW's sign-like first steps
# carry into the parameters.
BERT_CPU_PARAMS = ("hidden=256;num_layers=2;heads=4;mlp_dim=512;"
                   "max_len=128;vocab_size=512;lr=0.001")
BERT_CPU_STEPS = 3
BERT_CPU_LOSS_TOL = 1e-4
# The Local runner on BERT: tests/test_bert.py's planted-pairs config
# (must learn to accuracy > 0.9), then bench_bert's width on 2048 records
BERT_TINY_PARAMS = ("hidden=64;num_layers=2;heads=4;mlp_dim=128;"
                    "max_len=32;vocab_size=16;lr=0.003")
BERT_TINY_TRAIN = 4096
BERT_TINY_EPOCHS = 6
BERT_TINY_BATCH = 64
BERT_TINY_STEPS = BERT_TINY_TRAIN * BERT_TINY_EPOCHS // BERT_TINY_BATCH  # 384
BERT_TINY_LAYERS = 2
BERT_TINY_ACCURACY = 0.9
# the tiny job's attention: (batch, max_len, heads, hidden / heads), f32
BERT_TINY_ATTENTION = (BERT_TINY_BATCH, 32, 4, 16)
BERT_FULL_TRAIN = 2048
BERT_FULL_VAL = 512
BERT_FULL_STEPS = BERT_FULL_TRAIN // TRAIN_BATCH                    # 32
BERT_RECORDS_PER_TASK = 512


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _sass(source: str) -> str:
    """The built library's SASS (cuobjdump)."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                             "cuobjdump")
    return subprocess.run(
        [cuobjdump, "-sass", str(_build.library_path(source))],
        check=True, capture_output=True, text=True).stdout


def sass_count(source: str, opcode: str) -> int:
    """Lines of the built library's SASS that hold opcode."""
    return sum(opcode in line for line in _sass(source).splitlines())


def sass_by_kernel(source: str) -> dict:
    """Per kernel of the built library: its HGMMA instructions, the
    `WARPGROUP.DEPBAR` waits ptxas placed among them (one after every
    HGMMA means the wgmmas run serialized), and the highest register
    index it uses."""
    import re

    out = {}
    for body in _sass(source).split("Function : ")[1:]:
        name = body.split(None, 1)[0]
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", body)]
        out[name] = {"HGMMA": body.count("HGMMA"),
                     "WARPGROUP.DEPBAR": body.count("WARPGROUP.DEPBAR"),
                     "max_register": max(regs, default=0)}
    return out


def time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(q, k, v, causal: bool, backward: bool = False):
    """Least time for the kernel's work on this card: each input read
    once and each output written once, over HBM; the products over the
    peak rate of the input type (causal: only the unmasked pairs).  The
    forward reads q, k, v and writes O and lse: QK^T and PV.  The
    backward reads q, k, v, O, dO and lse and writes dQ, dK and dV: QK^T,
    dO V^T, P^T dO, dS K and dS^T Q."""
    batch, q_len, heads, dim = q.shape
    k_len = k.shape[1]
    elem = q.element_size()
    lse_bytes = batch * q_len * heads * 4
    if backward:
        # q, O, dO and dQ; k and dK; v and dV
        nbytes = (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) * elem \
            + lse_bytes
        products = 5
    else:
        nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * elem \
            + lse_bytes
        products = 2
    if causal:
        pairs = sum(min(i + 1, k_len) for i in range(q_len))
    else:
        pairs = q_len * k_len
    flops = 2.0 * products * batch * heads * pairs * dim
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def make_qkv(shape, dtype, gen, fused: bool):
    if fused:
        # the model's layout: q/k/v are column views of one QKV product
        batch, length, heads, dim = shape
        qkv = torch.randn((batch, length, 3 * heads * dim), generator=gen,
                          device="cuda").to(dtype)
        return tuple(t.unflatten(-1, (heads, dim))
                     for t in qkv.split(heads * dim, dim=-1))
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for _ in range(3))


def check_flash_kernel(gen):
    """Kernel vs plain on the card; returns (kernels entry sans launches,
    detail rows)."""
    cases = [
        # (label, shape, dtype, causal, fused qkv views)
        ("serve-bf16", (64, SEQ_LEN, 12, 64), torch.bfloat16, False, True),
        ("bf16", (64, SEQ_LEN, 12, 64), torch.bfloat16, False, False),
        ("bf16-causal", (64, SEQ_LEN, 12, 64), torch.bfloat16, True, False),
        ("f32", (64, SEQ_LEN, 12, 64), torch.float32, False, False),
        ("f32-causal", (64, SEQ_LEN, 12, 64), torch.float32, True, False),
        ("ragged-bf16", (4, 72, 12, 64), torch.bfloat16, False, False),
        ("ragged-bf16-causal", (4, 72, 12, 64), torch.bfloat16, True,
         False),
        ("ragged-f32", (4, 72, 12, 64), torch.float32, False, False),
        ("ragged-f32-causal", (4, 72, 12, 64), torch.float32, True, False),
        ("bf16-d128", (32, SEQ_LEN, 6, 128), torch.bfloat16, False, False),
        ("ragged-bf16-d128-causal", (4, 200, 4, 128), torch.bfloat16, True,
         False),
        ("local-bert-tiny-f32", BERT_TINY_ATTENTION, torch.float32, False,
         True),
    ]
    rows = []
    for label, shape, dtype, causal, fused in cases:
        q, k, v = make_qkv(shape, dtype, gen, fused)
        fa.reset_launch_counts()
        out_k, lse_k = fa.flash_attention_forward(q, k, v, causal=causal)
        variant = [name for name, n in
                   fa.flash_attention.launches_by_kernel.items() if n]
        out_r, lse_r = fa.flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err_out = (out_k.float() - out_r.float()).abs().max().item()
        err_lse = (lse_k - lse_r).abs().max().item()
        tol = TOL[dtype]
        ok = (bool(torch.isfinite(out_k).all())
              and err_out <= tol["out"] and err_lse <= tol["lse"])
        want = fa.SM90_WGMMA if dtype == torch.bfloat16 else fa.CUDA_CORE
        ok = ok and variant == [want]
        row = {"case": label, "shape": list(shape),
               "dtype": str(dtype).replace("torch.", ""), "causal": causal,
               "variant": variant,
               "max_abs_err_out": err_out, "max_abs_err_lse": err_lse,
               "tol_out": tol["out"], "tol_lse": tol["lse"]}
        if shape[0] >= 32:
            iters = 10
            row["ms"] = time_ms(
                lambda: fa.flash_attention_forward(q, k, v, causal=causal),
                iters)
            row["plain_ms"] = time_ms(
                lambda: fa.flash_attention_reference(q, k, v, causal=causal),
                iters)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal),
                iters)
            row["bound_ms"], row["bound_by"] = attention_bound_ms(
                q, k, v, causal)
        print(json.dumps(row), flush=True)
        if not ok:
            raise AssertionError(
                f"flash kernel disagrees with its plain version or ran "
                f"the wrong variant (bf16 goes to {fa.SM90_WGMMA}, f32 to "
                f"{fa.CUDA_CORE}): {row}")
        rows.append(row)
        del q, k, v, out_k, out_r, lse_k, lse_r
    main = rows[0]
    entry = {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "elasticdl_tpu_torch/csrc/flash_attention_fwd_sm90.cu",
        "variant": main["variant"][0],
        "replaces": "elasticdl_tpu/ops/flash_attention.py:48",
        "max_abs_err": main["max_abs_err_out"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
    }
    return entry, rows


def sdpa_backward_fn(q, k, v, g, causal: bool):
    """One backward of torch's scaled_dot_product_attention at the same
    inputs (the library yardstick; the port never calls it): the forward
    is recorded once, each call differentiates it again."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    gt = g.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                       retain_graph=True)


def check_flash_bwd(gen):
    """The backward kernel vs the plain `_flash_bwd` on the card, on the
    plain forward's residuals, and vs itself across two calls (bitwise);
    timed at the training shape.  Returns (kernels entry sans launches,
    detail rows)."""
    cases = [
        # (label, shape, dtype, causal, fused qkv views, timed)
        ("train-bf16", (TRAIN_BATCH, SEQ_LEN, 12, 64), torch.bfloat16,
         False, True, True),
        ("train-bf16-causal", (TRAIN_BATCH, SEQ_LEN, 12, 64),
         torch.bfloat16, True, True, True),
        ("f32-d16", (8, SEQ_LEN, 12, 16), torch.float32, False, False,
         True),
        ("f32-d16-causal", (8, SEQ_LEN, 12, 16), torch.float32, True,
         False, False),
        ("ragged-bf16", (4, 72, 12, 64), torch.bfloat16, False, True,
         False),
        ("ragged-bf16-causal", (4, 72, 12, 64), torch.bfloat16, True,
         False, False),
        ("ragged-f32-d16", (4, 72, 4, 16), torch.float32, False, False,
         False),
        ("ragged-f32-d64-causal", (4, 72, 12, 64), torch.float32, True,
         False, False),
        ("bf16-d128", (16, SEQ_LEN, 6, 128), torch.bfloat16, False, False,
         True),
        ("ragged-bf16-d128-causal", (4, 200, 4, 128), torch.bfloat16, True,
         False, False),
        ("bf16-d32", (4, 128, 4, 32), torch.bfloat16, True, False, False),
        # H = 6: lse's per-head stride is 24 B, which TMA cannot read
        ("h6-ragged-bf16-causal", (4, 200, 6, 64), torch.bfloat16, True,
         True, False),
        ("local-bert-tiny-f32", BERT_TINY_ATTENTION, torch.float32, False,
         True, False),
    ]
    rows = []
    for label, shape, dtype, causal, fused, timed in cases:
        q, k, v = make_qkv(shape, dtype, gen, fused)
        out, lse = fa.flash_attention_reference(q, k, v, causal=causal)
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        scale = shape[-1] ** -0.5
        fa.reset_launch_counts()
        got = fa.flash_attention_backward(q, k, v, out, lse, g, causal)
        variant = [name for name, n in
                   fa.flash_attention.backward_launches_by_kernel.items()
                   if n]
        again = fa.flash_attention_backward(q, k, v, out, lse, g, causal)
        want = fa._flash_bwd(causal, scale, (q, k, v, out, lse), g)
        torch.cuda.synchronize()
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want)]
        scales = [float(b.float().abs().max()) for b in want]
        tol = BWD_TOL[dtype]
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        want_variant = (fa.SM90_WGMMA if dtype == torch.bfloat16
                        and shape[-1] in fa.TENSOR_CORE_HEAD_DIMS
                        else fa.CUDA_CORE)
        ok = (finite and bitwise and variant == [want_variant]
              and all(e <= tol * max(1.0, sc)
                      for e, sc in zip(errs, scales)))
        row = {"case": label, "shape": list(shape),
               "dtype": str(dtype).replace("torch.", ""), "causal": causal,
               "fused_qkv": fused, "variant": variant,
               "max_abs_err_dq_dk_dv": errs, "scale_dq_dk_dv": scales,
               "tol_relative": tol, "bitwise_across_calls": bitwise}
        if timed:
            row["ms"] = time_ms(lambda: fa.flash_attention_backward(
                q, k, v, out, lse, g, causal), 10)
            row["plain_ms"] = time_ms(lambda: fa._flash_bwd(
                causal, scale, (q, k, v, out, lse), g), 3)
            row["library_ms"] = time_ms(
                sdpa_backward_fn(q, k, v, g, causal), 10)
            row["bound_ms"], row["bound_by"] = attention_bound_ms(
                q, k, v, causal, backward=True)
            row["kernel_ms_by_launch"] = kernel_ms_by_name(
                lambda: fa.flash_attention_backward(
                    q, k, v, out, lse, g, causal), 5)
        print(json.dumps({"flash_bwd": row}), flush=True)
        if not ok:
            raise AssertionError(
                f"flash backward kernel disagrees with its plain version, "
                f"with itself, or ran the wrong variant (bf16 at D 64/128 "
                f"goes to {fa.SM90_WGMMA}, the rest to {fa.CUDA_CORE}): "
                f"{row}")
        rows.append(row)
        del q, k, v, out, lse, g, got, again, want
    main = rows[0]
    entry = {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "elasticdl_tpu_torch/csrc/flash_attention_bwd_sm90.cu",
        "variant": main["variant"][0],
        "replaces": "elasticdl_tpu/ops/flash_attention.py:208",
        "max_abs_err": max(main["max_abs_err_dq_dk_dv"]),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
    }
    return entry, rows


def bert_requests(rng) -> list:
    """CLIENT_THREADS lists of REQUESTS_PER_CLIENT seeded BERT requests of
    1-64 rows: the traffic of serve_bert and serve_cli_bert."""
    return [
        [{"input_ids": rng.randint(0, VOCAB, (rows, SEQ_LEN))
          .astype(np.int32)}
         for rows in rng.randint(1, BUCKETS[-1] + 1, REQUESTS_PER_CLIENT)]
        for _ in range(CLIENT_THREADS)
    ]


def serve_bert(gen_seed: int):
    device = torch.device("cuda", 0)
    spec = get_model_spec(ZOO_DIR, "bert.bert_finetune.custom_model",
                          BERT_PARAMS + ";bf16=True")
    model = spec.model.to(device)
    init_parameters(model, torch.Generator(device=device).manual_seed(
        gen_seed))
    variables = {n: p.detach() for n, p in model.named_parameters()}
    feature_spec = feature_meta(
        {"input_ids": np.zeros((1, SEQ_LEN), np.int32)})

    rng = np.random.RandomState(gen_seed)
    requests = bert_requests(rng)
    results = []
    results_lock = threading.Lock()

    def client(reqs):
        for req in reqs:
            t0 = time.perf_counter()
            res = batcher.submit(req).result(timeout=600)
            lat = time.perf_counter() - t0
            with results_lock:
                results.append((req["input_ids"].shape[0], res, lat))

    # ---- the main path: counts start at 0 here ----
    fa.reset_launch_counts()
    engine = ServingEngine(model, variables, step=0,
                           feature_spec=feature_spec, buckets=BUCKETS,
                           device=device)
    batcher = DynamicBatcher(engine, max_latency_s=MAX_LATENCY_S)
    threads = [threading.Thread(target=client, args=(reqs,))
               for reqs in requests]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t_start
    batcher.shutdown()
    launches = {"flash_attention_fwd": fa.flash_attention.launches,
                "flash_attention_fwd_by_variant":
                    dict(fa.flash_attention.launches_by_kernel)}
    # ---- end of the main path ----

    snap = batcher.metrics.snapshot()
    batches = int(snap["batches"])
    n_req = CLIENT_THREADS * REQUESTS_PER_CLIENT
    bad = [(rows, r.code, r.error) for rows, r, _ in results if r.code != OK]
    if len(results) != n_req or bad:
        raise AssertionError(f"{len(bad)} requests not OK: {bad[:3]}")
    for rows, r, _ in results:
        if r.predictions.shape != (rows, 2) or not np.isfinite(
                r.predictions).all():
            raise AssertionError(
                f"bad predictions for {rows} rows: {r.predictions.shape}")
    expected = NUM_LAYERS * (len(BUCKETS) + batches)
    by_variant = launches["flash_attention_fwd_by_variant"]
    if (launches["flash_attention_fwd"] != expected
            or by_variant[fa.SM90_WGMMA] != expected):
        raise AssertionError(
            f"flash kernel launched {launches['flash_attention_fwd']} "
            f"times ({by_variant}); every bf16 layer must run the "
            f"{fa.SM90_WGMMA} kernel: {NUM_LAYERS} layers x "
            f"({len(BUCKETS)} warm-up + {batches} served batches) = "
            f"{expected}")
    if engine.compile_count != len(BUCKETS):
        raise AssertionError(
            f"{engine.compile_count} batch shapes for {len(BUCKETS)} "
            "buckets")
    p50 = {}
    for b in BUCKETS:
        lats = [lat for rows, _, lat in results if engine.bucket_for(rows)
                == b]
        p50[str(b)] = float(np.median(lats)) * 1e3 if lats else None
    total_rows = sum(rows for rows, _, _ in results)
    serve = {
        "requests": n_req, "rows": total_rows, "batches": batches,
        "wall_s": wall_s, "requests_per_s": n_req / wall_s,
        "rows_per_s": total_rows / wall_s,
        "p50_latency_ms_by_bucket": p50,
        "batch_fill_ratio": snap["batch_fill_ratio"],
        "launches": launches,
    }
    print(json.dumps({"serve": serve}), flush=True)

    # f32 check: the same weights, 4 rows, card (kernel) vs CPU (plain)
    f32_model = get_model_spec(ZOO_DIR, "bert.bert_finetune.custom_model",
                               BERT_PARAMS + ";bf16=False").model
    x = {"input_ids": rng.randint(0, VOCAB, (4, SEQ_LEN)).astype(np.int32)}
    gpu = ServingEngine(f32_model, variables, 0, feature_spec, buckets=(4,),
                        precompile=False, device=device)
    cpu = ServingEngine(f32_model, {n: t.cpu() for n, t in
                                    variables.items()},
                        0, feature_spec, buckets=(4,), precompile=False,
                        device="cpu")
    bf16 = ServingEngine(model, variables, 0, feature_spec, buckets=(4,),
                         precompile=False, device=device)
    got, _ = gpu.predict(x, 4)
    want, _ = cpu.predict(x, 4)
    got_bf16, _ = bf16.predict(x, 4)
    err = float(np.abs(got - want).max())
    err_bf16 = float(np.abs(got_bf16 - want).max())
    check = {"f32_card_vs_cpu_max_abs_err": err, "tol": F32_LOGITS_TOL,
             "bf16_card_vs_f32_cpu_max_abs_err": err_bf16,
             "bf16_tol": BF16_LOGITS_TOL,
             "logit_scale": float(np.abs(want).max())}
    print(json.dumps({"bert_f32_check": check}), flush=True)
    if not (err <= F32_LOGITS_TOL and err_bf16 <= BF16_LOGITS_TOL):
        raise AssertionError(f"BERT on the card vs CPU: {check}")
    serve["forward"] = forward_breakdown(engine)
    print(json.dumps({"forward": serve["forward"]}), flush=True)
    return serve, check, launches


def forward_breakdown(engine):
    """Where a forward's time goes: the host time of one synced predict
    per bucket (median of 5), and for the largest bucket the device time
    by kernel from torch.profiler, grouped into the flash kernel, matrix
    products and the rest, with the device's busy share of the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(SEED + 1)
    host_ms = {}
    for b in engine.buckets:
        x = {"input_ids": rng.randint(0, VOCAB, (b, SEQ_LEN))
             .astype(np.int32)}
        engine.predict(x, b)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            engine.predict(x, b)
            times.append(time.perf_counter() - t0)
        host_ms[str(b)] = float(np.median(times)) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict(x, b)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us / 1e3
    groups = {"flash_attention_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms in by_kernel.items():
        low = name.lower()
        if "flash_fwd" in low:
            groups["flash_attention_fwd"] += ms
        elif any(s in low for s in ("gemm", "xmma", "cutlass", "nvjet")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "host_ms_by_bucket": host_ms,
        "profiled_rows": b,
        "profiled_wall_ms": wall_ms,
        "device_ms": device_ms if by_kernel else None,
        "device_busy_share": device_ms / wall_ms if by_kernel else None,
        "device_ms_by_group": groups if by_kernel else None,
        "top_kernels_ms": top,
    }


def bert_train_batch():
    """bench.py::bench_bert's batch: 64 rows of 512 ids in [0, 8192) and
    binary labels, from a seeded generator."""
    rng = np.random.RandomState(SEED)
    return {
        "features": {"input_ids": rng.randint(
            0, VOCAB, (TRAIN_BATCH, SEQ_LEN)).astype(np.int32)},
        "labels": rng.randint(0, 2, TRAIN_BATCH).astype(np.int32),
    }


def make_criteo_batch(batch_size: int):
    """bench.py's _make_criteo_batch: zipf(1.5) ids over a 2^22 raw
    space, so one id takes ~38% of each field and most are rare."""
    rng = np.random.RandomState(0)
    return {
        "features": {
            "dense": rng.rand(batch_size, 13).astype(np.float32),
            "sparse": (rng.zipf(1.5, size=(batch_size, NUM_SPARSE))
                       % (1 << 22)).astype(np.int32),
        },
        "labels": rng.randint(0, 2, batch_size).astype(np.int32),
    }


def scatter_bound_ms(n: int, dim: int, touched: int):
    """Least time for the scatter-add on this card: the ids (N*4) and
    grads (N*D*4) read once, the U touched rows read and written once
    (2*U*D*4), over HBM; one add per grads element, over the f32 rate."""
    nbytes = n * 4 + n * dim * 4 + 2 * touched * dim * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n * dim / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def scatter_launch_breakdown(kernel_only, reps: int = 5):
    """Device µs per call of each of the scatter kernel's three launches
    (torch.profiler over `reps` calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            kernel_only()
        torch.cuda.synchronize()
    by_launch = {"permute": 0.0, "long_segments": 0.0, "short_segments": 0.0}
    names = {"permute_rows": "permute",
             "scatter_add_long": "long_segments",
             "scatter_add_segments": "short_segments"}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        for key, group in names.items():
            if key in evt.key:
                by_launch[group] += evt.self_device_time_total / reps
    return by_launch


def path_rows(wire_buffer: bytes) -> dict:
    """The table rows each training path hands the scatter-add, from the
    data that path trains on: BERT's token rows at train_bert's batch;
    the bare DeepFM Trainer's timed batch, the first
    `wire_deepfm` batch (hashed on the host as the plain and compact
    paths hash on the card; and decoded on the card from its dedup
    planes, which must give the same rows bit for bit), the first
    batch of the Local jobs' first shard (the dedup and int8 jobs), and
    the cache slots of tiered_deepfm's first real-size batch."""
    wire_sparse = fm_zoo.feed_bulk(
        wire_buffer, np.full(WIRE_BATCH, RECORD_BYTES, np.int64)
    )["features"]["sparse"]
    hashed = hash_field_rows_host(wire_sparse, DEEPFM_VOCAB)
    planes = DedupPacker().pack(hashed)
    decoded = unpack_rows_dedup(
        {k: plane_tensor(v, torch.device("cuda")) for k, v in
         planes.items()}).cpu().numpy()
    if not np.array_equal(decoded, hashed):
        raise AssertionError("dedup-decoded rows differ from the hashed "
                             "rows of the same wire_deepfm batch")
    local_sparse = synthetic_criteo(LOCAL_TRAIN // LOCAL_SHARDS,
                                    seed=SEED)[1][:AUC_BATCH]
    # the tiered store's first real-size batch: cache slots of a 2^20-row
    # cache (tiered_deepfm (b) plans the same batch first)
    store = tiered_zoo.TieredStore(TIERED_PLANES, NUM_SPARSE, REAL_CACHE)
    tiered_slots, _ = store.prepare(
        next(zipf_stream(SEED + 7))["features"]["sparse"])
    # Wide & Deep's two arenas at the census job's first batch, and
    # xDeepFM's at the Local jobs' first batch (vocab 2^18)
    census = census_zoo.feed(census_data.synthetic_census(
        CENSUS_BATCH, seed=SEED))["features"]
    wd = census_zoo.custom_model()
    wide = np.concatenate([census["categorical"], census["cross"]], axis=1)
    deep_ids = {name: census["categorical"][:, j]
                for j, (name, _) in enumerate(wd.deep_embedding.features)}
    wide_ids = {name: wide[:, j]
                for j, (name, _) in enumerate(wd.wide_linear.features)}
    return {
        "census_deep": wd.deep_embedding.arena_rows_host(
            deep_ids).reshape(-1),
        "census_wide": wd.wide_linear.arena_rows_host(wide_ids).reshape(-1),
        "xdeepfm": hash_field_rows_host(local_sparse,
                                        XDEEPFM_VOCAB).reshape(-1),
        "tiered": tiered_slots.reshape(-1),
        # the BERT token table takes ids mod its vocab, unmixed
        "bert": hash_ids_host(
            bert_train_batch()["features"]["input_ids"], VOCAB,
            mix=False).reshape(-1),
        "main": hash_field_rows_host(
            make_criteo_batch(TIMED_BATCH)["features"]["sparse"],
            DEEPFM_VOCAB).reshape(-1),
        "wire": decoded.reshape(-1),
        "local": hash_field_rows_host(local_sparse,
                                      DEEPFM_VOCAB).reshape(-1),
    }


def check_scatter_kernel(gen, wire_buffer: bytes):
    """The scatter-add kernel vs its plain version on CPU copies, bit for
    bit, and vs itself across two launches, at the rows of every DeepFM
    path (`path_rows`) and at probe shapes; timed at the main paths'
    shapes.  Returns (kernels entry sans launches, detail rows)."""
    rng = np.random.RandomState(SEED)
    rows_of = path_rows(wire_buffer)
    cases = [
        # (label, ids, table rows, dim, timed)
        ("main-d16", rows_of["main"], DEEPFM_VOCAB, DEEPFM_DIM, True),
        ("main-d1", rows_of["main"], DEEPFM_VOCAB, 1, True),
        ("wire-d16", rows_of["wire"], DEEPFM_VOCAB, DEEPFM_DIM, True),
        ("wire-d1", rows_of["wire"], DEEPFM_VOCAB, 1, True),
        ("local-d16", rows_of["local"], DEEPFM_VOCAB, DEEPFM_DIM, False),
        # the tiered cache's backward at tiered_deepfm (b)'s first batch
        ("tiered-d16", rows_of["tiered"], REAL_CACHE, DEEPFM_DIM, True),
        ("tiered-d1", rows_of["tiered"], REAL_CACHE, 1, False),
        # the BERT token table's backward at train_bert's batch
        ("bert-d768", rows_of["bert"], VOCAB, 768, True),
        ("local-d1", rows_of["local"], DEEPFM_VOCAB, 1, False),
        # Wide & Deep's arenas (zoo_local): 4,096 ids into 4,096 rows at
        # D 8 and 5,120 into 5,120 at D 1, most of them long segments;
        # xDeepFM's at the Local jobs' first batch into 2^18 rows
        ("census-deep-d8", rows_of["census_deep"],
         arena_rows(census_zoo.deep_arena_features(CENSUS_VOCAB)), 8, True),
        ("census-wide-d1", rows_of["census_wide"],
         arena_rows(census_zoo.wide_arena_features(CENSUS_VOCAB)), 1, True),
        ("xdeepfm-d16", rows_of["xdeepfm"], XDEEPFM_VOCAB, DEEPFM_DIM, True),
        ("xdeepfm-d1", rows_of["xdeepfm"], XDEEPFM_VOCAB, 1, True),
        ("probe", (rng.zipf(1.5, 262144) % 8192).astype(np.int32), 8192,
         16, True),
        ("ragged-d16", (rng.zipf(1.5, 1000) % 8192).astype(np.int32), 8192,
         16, False),
        ("ragged-d1", (rng.zipf(1.5, 1000) % 8192).astype(np.int32), 8192,
         1, False),
        ("one-row", np.full(65536, 4321, np.int32), 8192, 16, True),
        # 64 hot rows of 4,096 ids each, shuffled: 64 long segments at once
        ("many-long", np.repeat(np.arange(64, dtype=np.int32) * 97,
                                4096)[rng.permutation(64 * 4096)], 8192, 16,
         True),
        # segments of 63-65 ids around the long-segment threshold, D = 24
        ("threshold-d24", np.repeat(
            np.arange(40, dtype=np.int32),
            [63, 64, 65, 1, 2, 200, 64, 65] * 5), 64, 24, False),
    ]
    lib = sa._library()
    rows = []
    for label, ids_np, n_rows, dim, timed in cases:
        n = ids_np.shape[0]
        ids = torch.from_numpy(ids_np).cuda()
        table = torch.randn((n_rows, dim), generator=gen, device="cuda")
        grads = torch.randn((n, dim), generator=gen, device="cuda")
        out1 = sa.scatter_add_forward(table, ids, grads)
        out2 = sa.scatter_add_forward(table, ids, grads)
        torch.cuda.synchronize()
        ref = sa.scatter_add_reference(table.cpu(), ids.cpu(), grads.cpu())
        got = out1.cpu()
        _, counts = torch.unique(ids, return_counts=True)
        touched = int(counts.numel())
        sorted_ids, order = torch.sort(ids, stable=True)
        heads, ends = sa.segment_plan(sorted_ids)
        row = {"case": label, "n": n, "rows": n_rows, "dim": dim,
               "touched_rows": touched,
               "longest_segment": int(counts.max()),
               "long_segments": int(sa.long_segments(heads, ends).shape[0]),
               "long_segment_threshold": sa.LONG_SEGMENT,
               "bitwise_vs_plain": bool(torch.equal(got, ref)),
               "bitwise_across_launches": bool(torch.equal(out1, out2)),
               "max_abs_err": float((got - ref).abs().max())}
        if timed:
            iters = 20
            scratch = table.clone()
            sorted_grads = torch.empty(n * dim + 4, device="cuda")

            def kernel_only():
                err = lib.scatter_add_segments(
                    scratch.data_ptr(), sorted_ids.data_ptr(),
                    order.data_ptr(), grads.data_ptr(),
                    sorted_grads.data_ptr(), heads.data_ptr(),
                    ends.data_ptr(), n, dim, sa.LONG_SEGMENT,
                    torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"scatter_add_segments: error {err}")

            row["ms"] = time_ms(lambda: sa.scatter_add_forward(
                scratch, ids, grads, inplace=True), iters)
            row["kernel_ms"] = time_ms(kernel_only, iters)
            row["kernel_us_by_launch"] = scatter_launch_breakdown(
                kernel_only)
            # the longest segment's chain bounds the kernel: kernel time
            # per id of that segment
            row["ns_per_id_longest"] = row["kernel_ms"] * 1e6 / int(
                counts.max())
            row["sort_ms"] = time_ms(
                lambda: torch.sort(ids, stable=True), iters)
            row["plan_ms"] = time_ms(lambda: sa.segment_plan(sorted_ids),
                                     iters)
            row["plain_ms"] = time_ms(
                lambda: sa.scatter_add_reference(table, ids, grads), iters)
            row["library_ms"] = time_ms(
                lambda: scratch.index_add_(0, ids, grads), iters)
            row["bound_ms"], row["bound_by"] = scatter_bound_ms(
                n, dim, touched)
            del scratch, sorted_grads
        print(json.dumps(row), flush=True)
        if not (row["bitwise_vs_plain"] and row["bitwise_across_launches"]):
            raise AssertionError(
                f"scatter-add kernel differs from its plain version or "
                f"from itself: {row}")
        rows.append(row)
        del ids, table, grads, out1, out2, sorted_ids, order
    main = rows[0]
    entry = {
        "name": "scatter_add",
        "route": "cuda",
        "source": "elasticdl_tpu_torch/csrc/scatter_add.cu",
        "replaces": "scripts/probe_pallas_scatter.py:68",
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
    }
    return entry, rows


def _criteo_batches(n_steps: int, batch: int, seed: int):
    dense, sparse, labels = synthetic_criteo(n_steps * batch, seed=seed)
    return [
        {"features": {"dense": dense[sl], "sparse": sparse[sl]},
         "labels": labels[sl].astype(np.int32)}
        for sl in (slice(i * batch, (i + 1) * batch)
                   for i in range(n_steps))
    ]


def train_deepfm():
    """The DeepFM training path: AUC protocol, timed steps, a profiled
    step, K-step vs flat bitwise; then card vs CPU in f32.  Returns
    (summary, launches)."""
    device = torch.device("cuda", 0)
    spec = get_model_spec(ZOO_DIR, DEEPFM, DEEPFM_PARAMS)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, use_bf16=True,
                      device=device)
    train = _criteo_batches(AUC_STEPS, AUC_BATCH, seed=0)
    vd, vs, vy = synthetic_criteo(16384, seed=1000)
    timed_batch = make_criteo_batch(TIMED_BATCH)
    stack = _criteo_batches(STACK_K, AUC_BATCH, seed=1)

    # ---- the main path: counts start at 0 here ----
    sa.scatter_add.launches = 0
    fa.flash_attention.launches = 0
    steps = 0
    t0 = time.perf_counter()
    state = trainer.init_state(
        torch.Generator(device=device).manual_seed(SEED),
        train[0]["features"])
    losses = []
    for batch in train:
        state, loss = trainer.train_on_batch(state, batch)
        losses.append(loss)
        steps += 1
    preds = trainer.predict_on_batch(state, {"dense": vd, "sparse": vs})
    auc_s = time.perf_counter() - t0
    val_auc = float(auc(vy, preds))
    del state

    staged = trainer.stage_batch(timed_batch)
    state = trainer.init_state(SEED, staged["features"])
    for _ in range(WARMUP_STEPS):
        state, _ = trainer.train_on_batch(state, staged)
        steps += 1
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_STEPS):
        state, loss = trainer.train_on_batch(state, staged)
        steps += 1
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / TIMED_STEPS
    timed_loss = float(loss)
    breakdown = step_breakdown(trainer, state, staged)
    steps += 1
    del state

    a = trainer.init_state(SEED + 1, stack[0]["features"])
    b = trainer.init_state(SEED + 1, stack[0]["features"])
    a, stacked_losses = trainer.train_on_batch_stack(a, stack)
    flat_losses = []
    for batch in stack:
        b, loss = trainer.train_on_batch(b, batch)
        flat_losses.append(loss)
    steps += 2 * STACK_K
    torch.cuda.synchronize()
    launches = {"scatter_add": sa.scatter_add.launches,
                "flash_attention_fwd": fa.flash_attention.launches}
    # ---- end of the main path ----

    stack_bitwise = bool(
        torch.equal(stacked_losses, torch.stack(flat_losses))
        and all(torch.equal(pa, pb) for pa, pb in
                zip(a.params.values(), b.params.values())))
    del a, b
    loss_values = [float(x) for x in losses]
    summary = {
        "config": DEEPFM_PARAMS + ";use_bf16=True",
        "steps": steps,
        "launches": launches,
        "auc": val_auc, "auc_band": list(AUC_BAND),
        "auc_protocol_s": auc_s,
        "auc_losses_first_last": [loss_values[0], loss_values[-1]],
        "timed_batch": TIMED_BATCH, "timed_steps": TIMED_STEPS,
        "step_ms": step_ms,
        "examples_per_s": TIMED_BATCH / step_ms * 1e3,
        "timed_last_loss": timed_loss,
        "stack_k": STACK_K, "stack_bitwise_equal_flat": stack_bitwise,
        "step_breakdown": breakdown,
    }
    print(json.dumps({"deepfm": summary}), flush=True)
    if launches["scatter_add"] != 2 * steps:
        raise AssertionError(
            f"scatter-add kernel launched {launches['scatter_add']} times "
            f"in {steps} steps; 2 arenas x {steps} = {2 * steps}")
    if launches["flash_attention_fwd"] != 0:
        raise AssertionError("DeepFM training launched the flash kernel")
    if not AUC_BAND[0] <= val_auc <= AUC_BAND[1]:
        raise AssertionError(f"DeepFM AUC {val_auc} outside {AUC_BAND}")
    if not (np.isfinite(preds).all() and preds.shape == (16384,)
            and np.isfinite(loss_values).all()):
        raise AssertionError("DeepFM produced non-finite or misshapen "
                             "outputs")
    if not stack_bitwise:
        raise AssertionError(
            f"train_on_batch_stack(K={STACK_K}) differs from {STACK_K} "
            "flat steps")
    summary["cpu_check"] = deepfm_card_vs_cpu()
    return summary, launches


def deepfm_card_vs_cpu():
    """A few f32 steps at vocab 2^16 on the card (kernel) and on the CPU
    (plain path) from the same weights."""
    spec = get_model_spec(ZOO_DIR, DEEPFM, CPU_CHECK_PARAMS)
    gpu = Trainer(spec.model, spec.optimizer, spec.loss, device="cuda")
    cpu = Trainer(spec.model, spec.optimizer, spec.loss, device="cpu")
    batches = _criteo_batches(CPU_CHECK_STEPS + 1, CPU_CHECK_BATCH, seed=2)
    sample = batches[0]["features"]
    gs = gpu.init_state(SEED, sample)
    cs = cpu.init_state(SEED, sample)
    cs.model.load_state_dict({k: v.cpu() for k, v in
                              gs.model.state_dict().items()})
    loss_err = 0.0
    for batch in batches[:-1]:
        gs, gl = gpu.train_on_batch(gs, batch)
        cs, cl = cpu.train_on_batch(cs, batch)
        loss_err = max(loss_err, abs(float(gl) - float(cl)))
    held = batches[-1]["features"]
    got = gpu.predict_on_batch(gs, held)
    want = cpu.predict_on_batch(cs, held)
    pred_err = float(np.abs(got - want).max())
    param_err = max(float((pg.detach().cpu() - pc.detach()).abs().max())
                    for pg, pc in zip(gs.params.values(),
                                      cs.params.values()))
    check = {"steps": CPU_CHECK_STEPS, "batch": CPU_CHECK_BATCH,
             "loss_max_abs_err": loss_err, "loss_tol": CPU_LOSS_TOL,
             "pred_max_abs_err": pred_err, "pred_tol": CPU_PRED_TOL,
             "param_max_abs_err": param_err,
             "pred_scale": float(np.abs(want).max())}
    print(json.dumps({"deepfm_card_vs_cpu": check}), flush=True)
    if not (loss_err <= CPU_LOSS_TOL and pred_err <= CPU_PRED_TOL):
        raise AssertionError(f"DeepFM on the card vs CPU: {check}")
    return check


def _device_ms_by_kernel(prof) -> dict:
    """Device ms of a profile by kernel name."""
    from torch.autograd import DeviceType

    by_kernel = {}
    for evt in prof.key_averages():
        # user annotations (Optimizer.step#Adam.step) span kernels that
        # are counted on their own
        if evt.device_type != DeviceType.CUDA or getattr(
                evt, "is_user_annotation", False):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us / 1e3
    return by_kernel


def kernel_ms_by_name(fn, iters: int) -> dict:
    """Device ms per call of each kernel fn launches (torch.profiler over
    `iters` calls after a warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {name: ms / iters
            for name, ms in _device_ms_by_kernel(prof).items()}


def _is_flash_bwd(name: str) -> bool:
    """The backward's kernels: the wgmma variant's `flash_bwd_*` and the
    CUDA-core variant's `dkdv_core`, `dq_core` and `delta_kernel`."""
    return any(s in name for s in ("flash_bwd", "dkdv_core", "dq_core",
                                   "delta_kernel"))


def step_breakdown(trainer, state, batch):
    """Device time of one synced training step by group (torch.profiler)
    and the device's busy share of its host wall time.  "other" holds the
    elementwise passes (LayerNorm, GELU, casts, residuals)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_on_batch(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = _device_ms_by_kernel(prof)
    groups = {"scatter_add": 0.0, "sort": 0.0, "gather": 0.0, "adam": 0.0,
              "matmul": 0.0, "flash_attention_fwd": 0.0,
              "flash_attention_bwd": 0.0, "other": 0.0}
    for name, ms in by_kernel.items():
        low = name.lower()
        if "flash_fwd" in low:
            groups["flash_attention_fwd"] += ms
        elif _is_flash_bwd(low):
            groups["flash_attention_bwd"] += ms
        elif any(s in low for s in ("scatter_add_segments",
                                    "scatter_add_long", "permute_rows")):
            groups["scatter_add"] += ms
        elif "sort" in low:
            groups["sort"] += ms
        elif "gather" in low or "indexselect" in low:
            groups["gather"] += ms
        elif "multi_tensor_apply" in low or "adam" in low:
            groups["adam"] += ms
        elif any(s in low for s in ("gemm", "xmma", "cutlass", "nvjet")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {
        "profiled_wall_ms": wall_ms,
        "device_ms": device_ms if by_kernel else None,
        "device_busy_share": device_ms / wall_ms if by_kernel else None,
        "device_ms_by_group": groups if by_kernel else None,
        "device_ms_by_range": range_device_ms(prof, RANGES),
        "flash_bwd_ms_by_kernel": {name: ms for name, ms in by_kernel.items()
                                   if _is_flash_bwd(name.lower())},
        "top_kernels_ms": top,
    }


def range_device_ms(prof, names) -> dict:
    """Device ms of the kernels launched inside each named
    record_function range (its CPU event's device time, children
    included); None where the range did not run."""
    from torch.autograd import DeviceType

    out = {name: None for name in names}
    for evt in prof.key_averages():
        if evt.key in out and evt.device_type == DeviceType.CPU:
            out[evt.key] = (out[evt.key] or 0.0) + \
                evt.device_time_total / 1e3
    return out


def wire_records(n: int, seed: int) -> np.ndarray:
    """bench.py::_ensure_bench_criteo's records as (n, 157) uint8 rows:
    uniform dense, zipf(1.5) ids over a 2^22 raw space, random labels."""
    rng = np.random.RandomState(seed)
    arr = np.empty((n, RECORD_BYTES), np.uint8)
    arr[:, :52] = rng.rand(n, 13).astype(np.float32).view(np.uint8)
    arr[:, 52:156] = ((rng.zipf(1.5, size=(n, 26)) % (1 << 22))
                      .astype(np.int32).view(np.uint8))
    arr[:, 156] = rng.randint(0, 2, n)
    return arr


def _leaf_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaf_bytes(v) for v in tree.values())
    return int(tree.nbytes)


def carrier_grad_check(trainer, state, batch, rows) -> dict:
    """One more training step on the int8 arenas with each arena's output
    gradient captured (a tensor hook on its forward output): each zero
    carrier's gradient, which `_GradTap`'s backward scatter-adds on the
    card, must equal bit for bit the plain scatter-add on the CPU of that
    output gradient at the step's rows."""
    model = state.model
    arenas = {"fm_embedding": model.fm_embedding,
              "fm_linear": model.fm_linear}
    out_grads = {}

    def capture(name):
        def hook(module, inputs, out):
            # the raw-id path returns {feature: vectors}; prehashed rows
            # return the vectors
            vecs = out["sparse"] if isinstance(out, dict) else out
            vecs.register_hook(
                lambda g: out_grads.__setitem__(name, g.detach().clone()))
        return hook

    handles = [m.register_forward_hook(capture(name))
               for name, m in arenas.items()]
    trainer.train_on_batch(state, batch)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    flat_rows = rows.reshape(-1).cpu()
    check = {}
    for name, arena in arenas.items():
        got = arena.embedding.grad.cpu()
        g = out_grads[name].cpu().reshape(flat_rows.shape[0], -1)
        want = sa.scatter_add_reference(torch.zeros_like(got), flat_rows, g)
        check[name] = {"dim": int(g.shape[1]), "n": int(g.shape[0]),
                       "bitwise_vs_plain": bool(torch.equal(got, want)),
                       "max_abs_err": float((got - want).abs().max()),
                       "grad_abs_max": float(want.abs().max())}
    if not all(c["bitwise_vs_plain"] for c in check.values()):
        raise AssertionError(
            f"int8 carrier gradients differ from the plain scatter-add of "
            f"the step's output gradients: {check}")
    return check


def _wire_run(fmt: str, buffers, device) -> tuple:
    """One wire format (or the int8 arena on the plain one) at
    bench_deepfm_e2e's shape.  Returns (summary, losses, launches)."""
    arena = "int8" if fmt.endswith("int8") else ""
    wire = fmt.split("-")[0]
    spec = get_model_spec(ZOO_DIR, DEEPFM, DEEPFM_PARAMS, arena_dtype=arena)
    feed = {"plain": spec.feed_bulk, "compact": spec.feed_bulk_compact,
            "dedup": spec.feed_bulk_dedup}[wire]
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, use_bf16=True,
                      device=device)
    sizes = np.full(WIRE_BATCH, RECORD_BYTES, np.int64)
    fm_zoo._DEDUP_PACKER = DedupPacker()   # caps of this phase's batches
    t0 = time.perf_counter()
    batches = [feed(buf, sizes) for buf in buffers]
    pack_ms = (time.perf_counter() - t0) * 1e3 / len(buffers)
    wire_bytes = sum(_leaf_bytes(b) for b in batches) / len(batches)
    staged, h2d_ms = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged.append(trainer.stage_batch(batch))
        torch.cuda.synchronize()
        h2d_ms.append((time.perf_counter() - t0) * 1e3)
    packer = fm_zoo._DEDUP_PACKER
    caps = ({"unique_cap": packer.unique_cap, "exc_cap": packer.exc_cap,
             "last_unique": packer.last_unique,
             "last_exceptions": packer.last_exceptions}
            if wire == "dedup" else None)
    del batches

    # ---- the main path: counts start at 0 here ----
    sa.scatter_add.launches = 0
    fa.flash_attention.launches = 0
    state = trainer.init_state(
        torch.Generator(device=device).manual_seed(SEED),
        staged[0]["features"])
    state, warm = trainer.train_on_batch_stack(state, staged)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, timed = trainer.train_on_batch_stack(state, staged)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / WIRE_K
    breakdown = step_breakdown(trainer, state, staged[0])
    torch.cuda.synchronize()
    launches = sa.scatter_add.launches
    steps = 2 * WIRE_K + 1
    # ---- end of the main path ----

    feats = trainer._cast(staged[0]["features"])
    with torch.no_grad():
        decode_ms = time_ms(lambda: sparse_field_rows(feats, DEEPFM_VOCAB),
                            20)
        rows, prehashed = sparse_field_rows(feats, DEEPFM_VOCAB)
        if not prehashed:
            # the arena's own hash of the field-offset ids (offset 0)
            rows = hash_ids(rows, DEEPFM_VOCAB)
        lookup_ms = time_ms(
            lambda: state.model.fm_embedding(rows, prehashed=True), 20)
    carrier = (carrier_grad_check(trainer, state, staged[0], rows)
               if arena else None)
    losses = torch.cat([warm, timed]).cpu()
    summary = {
        "card": card_line(), "format": wire, "arena_dtype": arena or
        "float32", "batch": WIRE_BATCH, "k": WIRE_K, "steps": steps,
        "bytes_per_example": wire_bytes / WIRE_BATCH,
        "pack_ms_per_batch": pack_ms,
        "h2d_ms_per_batch": float(np.mean(h2d_ms)),
        "h2d_ms_each": h2d_ms,
        "step_ms": step_ms,
        "examples_per_s": WIRE_BATCH / step_ms * 1e3,
        "decode_device_ms_in_step":
            breakdown["device_ms_by_range"]["wire_decode"],
        "decode_ms": decode_ms,
        "fm_embedding_lookup_ms": lookup_ms,
        "scatter_launches": launches,
        "losses_first_last": [float(losses[0]), float(losses[-1])],
        "dedup_caps": caps,
        "carrier_grad_check": carrier,
        "step_breakdown": breakdown,
    }
    if arena:
        summary["fold_ms"] = time_ms(
            lambda: fold_quantized_updates(state.model, state.step), 10)
    if launches != 2 * steps or not torch.isfinite(losses).all():
        raise AssertionError(
            f"wire_deepfm {fmt}: {launches} scatter-add launches in "
            f"{steps} steps (2 arenas x {steps} = {2 * steps}), losses "
            f"{losses.tolist()}")
    del staged, state, trainer
    torch.cuda.empty_cache()
    return summary, losses, launches


def wire_buffers() -> list:
    """The K record buffers of `wire_deepfm`, one per batch."""
    rows = wire_records(WIRE_K * WIRE_BATCH, SEED)
    return [rows[i * WIRE_BATCH:(i + 1) * WIRE_BATCH].tobytes()
            for i in range(WIRE_K)]


def wire_deepfm(buffers):
    """The bare Trainer at bench_deepfm_e2e's shape on one set of records
    through each wire format; compact and dedup must give the same
    losses bit for bit (their model inputs are the same).  Returns
    (summary, scatter launches over the phase)."""
    device = torch.device("cuda", 0)
    runs, losses, launches = {}, {}, 0
    for fmt in WIRE_FORMATS:
        runs[fmt], losses[fmt], n = _wire_run(fmt, buffers, device)
        launches += n
        print(json.dumps({"wire_deepfm": runs[fmt]}), flush=True)
    same = {
        "compact_equals_dedup": bool(torch.equal(losses["compact"],
                                                 losses["dedup"])),
        "plain_equals_compact": bool(torch.equal(losses["plain"],
                                                 losses["compact"])),
    }
    print(json.dumps({"wire_deepfm_losses": same}), flush=True)
    if not same["compact_equals_dedup"]:
        raise AssertionError(
            f"compact and dedup losses differ: {losses['compact'].tolist()}"
            f" vs {losses['dedup'].tolist()}")
    return {"runs": runs, "losses_equal": same,
            "launches": launches}, launches


def local_argv(job: str, *extra) -> list:
    return [job, "--distribution_strategy", "Local",
            "--model_def", DEEPFM, "--model_params", DEEPFM_PARAMS,
            "--use_bf16", "true", "--minibatch_size", str(AUC_BATCH),
            "--records_per_task", str(LOCAL_RECORDS_PER_TASK), *extra]


def _phase_split(job) -> dict:
    snap = job.phase_timer.snapshot()
    return {p: {"total_s": v["total_s"], "share": v["share"]}
            for p, v in snap.items()}


def _check_job(job, label: str, one_worker: bool = True) -> dict:
    """The assertions a Local train job must pass; returns its summary.
    With one worker the eval rounds fall at known versions; with two,
    where the version reports interleave, only the final one does."""
    tm = job.master.task_manager
    counters = tm.counters.as_dict()
    by_type = counters["by_type"]
    metrics = job.metrics or {}
    auc_value = metrics.get("auc")
    summary = {"exit_code": job.exit_code, "counters": counters,
               "model_step": job.owner.step, "metrics": metrics,
               "eval_versions": sorted(job.master.evaluation_service
                                       .history)}
    if job.exit_code != 0 or not tm.finished:
        raise AssertionError(f"{label}: the job failed: {summary}")
    if counters["failed"] != 0:
        raise AssertionError(f"{label}: {counters['failed']} failed task "
                             f"reports: {summary}")
    if by_type.get(0) != LOCAL_TASKS or job.owner.step != LOCAL_STEPS:
        raise AssertionError(f"{label}: expected {LOCAL_TASKS} training "
                             f"tasks and {LOCAL_STEPS} steps: {summary}")
    want_versions = ({LOCAL_EVAL_STEPS, LOCAL_STEPS} if one_worker
                     else {LOCAL_STEPS})
    if by_type.get(1, 0) < 2 or not want_versions <= set(
            summary["eval_versions"]):
        raise AssertionError(f"{label}: expected eval rounds at versions "
                             f"{sorted(want_versions)}: {summary}")
    if auc_value is None or not AUC_BAND[0] <= auc_value <= AUC_BAND[1]:
        raise AssertionError(f"{label}: final AUC {auc_value} outside "
                             f"{AUC_BAND}")
    return summary


def job_timeline(evs, unix0: float, unix1: float) -> dict:
    """Where a Local job's wall time went, from its event log (host
    clock): start to the first lease, each training and eval task's
    claimed -> reported time in task order, the last report to the job's
    end (the checkpoint writer's tail and the threads' exit), and each
    checkpoint's host copy, write time and landing time."""
    types = {e["task_id"]: e["task_type"] for e in evs
             if e["event"] == events.TASK_DISPATCHED}
    stamps = {}
    for e in evs:
        if "task_id" in e:
            stamps.setdefault(e["task_id"], {})[e["event"]] = e["ts"]
    task_s = {"training": [], "evaluation": []}
    for task_id in sorted(stamps, key=lambda t: stamps[t][
            events.TASK_CLAIMED]):
        ts = stamps[task_id]
        kind = "training" if types[task_id] == 0 else "evaluation"
        task_s[kind].append(ts[events.TASK_REPORTED]
                            - ts[events.TASK_CLAIMED])
    dispatched = [e["ts"] for e in evs
                  if e["event"] == events.TASK_DISPATCHED]
    reported = [e["ts"] for e in evs if e["event"] == events.TASK_REPORTED]
    saved = [e for e in evs if e["event"] == events.CHECKPOINT_SAVED]
    return {
        "start_to_first_lease_s": min(dispatched) - unix0,
        "training_tasks_s": sum(task_s["training"]),
        "training_task_s_each": task_s["training"],
        "eval_tasks_s": sum(task_s["evaluation"]),
        "eval_task_s_each": task_s["evaluation"],
        "last_report_to_end_s": unix1 - max(reported),
        "checkpoints": [{"step": e["step"], "bytes": e["bytes"],
                         "capture_s": e["capture_s"],
                         "write_s": e["write_s"],
                         "landed_at_s": e["ts"] - unix0} for e in saved],
    }


def local_deepfm(card: str, work: str):
    """The Local runner end to end: data, a train job with eval rounds,
    checkpoints and an export (`--output`), an evaluate job from its
    checkpoint, a two-worker train job, the dedup and int8 jobs.
    Returns (summary, launches of the train job, what `serve_cli_deepfm`
    serves: the validation data, the checkpoint and export directories
    and the jobs' AUCs).  Its files stay under `work`."""
    tmp = os.path.join(work, "local_deepfm")
    try:
        t0 = time.perf_counter()
        train_dir, val_dir = write_dataset(
            os.path.join(tmp, "data"), n_train=LOCAL_TRAIN, n_val=LOCAL_VAL,
            seed=SEED, shards=LOCAL_SHARDS)
        write_s = time.perf_counter() - t0
        data_bytes = sum(
            os.path.getsize(os.path.join(d, f))
            for d in (train_dir, val_dir) for f in os.listdir(d))
        print(json.dumps({"local_dataset": {
            "card": card, "records": LOCAL_TRAIN + LOCAL_VAL,
            "bytes": data_bytes, "write_s": write_s}}), flush=True)
        ckpt = os.path.join(tmp, "ckpt")
        export_dir = os.path.join(tmp, "export")
        log = os.path.join(tmp, "events.jsonl")
        args = cli.parse_args(local_argv(
            "train", "--num_epochs", "1",
            "--training_data", train_dir, "--validation_data", val_dir,
            "--evaluation_steps", str(LOCAL_EVAL_STEPS),
            "--checkpoint_dir", ckpt,
            "--checkpoint_steps", str(LOCAL_CKPT_STEPS),
            "--keep_checkpoint_max", str(LOCAL_KEEP),
            "--event_log", log, "--output", export_dir))

        # ---- the main path: counts start at 0 here ----
        fa.reset_launch_counts()
        sa.scatter_add.launches = 0
        torch.cuda.synchronize()
        t0, unix0 = time.perf_counter(), time.time()
        job = api.run_local(args, "train")     # the body of api.train
        torch.cuda.synchronize()
        wall_s, unix1 = time.perf_counter() - t0, time.time()
        launches = {"scatter_add": sa.scatter_add.launches,
                    "flash_attention_fwd": fa.flash_attention.launches}
        # ---- end of the main path ----

        train = _check_job(job, "local train job")
        evs = events.read_events(log)
        events.configure(None)
        reported = {e["task_id"] for e in evs
                    if e["event"] == events.TASK_REPORTED}
        finished = sum(train["counters"]["by_type"].values())
        broken = {t: events.task_chain(evs, t) for t in reported
                  if events.task_chain(evs, t) != TASK_CHAIN}
        if len(reported) != finished or broken:
            raise AssertionError(
                f"event chains: {len(reported)} reported tasks for "
                f"{finished} finished, incomplete {broken}")
        train_ids = {e["task_id"] for e in evs
                     if e["event"] == events.TASK_DISPATCHED
                     and e["task_type"] == 0}
        train_ts = [e["ts"] for e in evs if e.get("task_id") in train_ids]
        # first training lease to last training report
        train_span_s = max(train_ts) - min(train_ts)
        timeline = job_timeline(evs, unix0, unix1)
        saver = job.owner.checkpoint_saver
        steps = saver.all_steps()
        intact = {s: saver.verify_step(s) for s in steps}
        want_steps = list(range(LOCAL_STEPS - (LOCAL_KEEP - 1) *
                                LOCAL_CKPT_STEPS, LOCAL_STEPS + 1,
                                LOCAL_CKPT_STEPS))
        if steps != want_steps or not all(intact.values()):
            raise AssertionError(f"checkpoints {intact}, want {want_steps}")
        if launches["scatter_add"] != 2 * LOCAL_STEPS or \
                launches["flash_attention_fwd"] != 0:
            raise AssertionError(
                f"the Local job launched {launches}; 2 arenas x "
                f"{LOCAL_STEPS} steps = {2 * LOCAL_STEPS} scatter-adds")
        train.update({
            "card": card, "wall_s": wall_s,
            "examples_per_s": LOCAL_TRAIN / wall_s,
            "train_span_s": train_span_s,
            "train_examples_per_s": LOCAL_TRAIN / train_span_s,
            "phases": _phase_split(job), "timeline": timeline,
            "launches": launches,
            "checkpoints": steps,
        })
        print(json.dumps({"local_train": train}), flush=True)
        del job

        t0 = time.perf_counter()
        ev = api.run_local(cli.parse_args(local_argv(
            "evaluate", "--validation_data", val_dir,
            "--checkpoint_dir_for_init", ckpt)), "evaluate")
        eval_s = time.perf_counter() - t0
        eval_auc = (ev.metrics or {}).get("auc")
        evaluate = {"card": card, "exit_code": ev.exit_code,
                    "model_step": ev.owner.step, "auc": eval_auc,
                    "train_auc": train["metrics"]["auc"], "wall_s": eval_s,
                    "tol": LOCAL_EVAL_AUC_TOL}
        print(json.dumps({"local_evaluate": evaluate}), flush=True)
        if ev.exit_code != 0 or ev.owner.step != LOCAL_STEPS or \
                eval_auc is None or abs(eval_auc - train["metrics"]["auc"]) \
                > LOCAL_EVAL_AUC_TOL:
            raise AssertionError(f"evaluate from the checkpoint: {evaluate}")
        del ev

        sa.scatter_add.launches = 0
        t0 = time.perf_counter()
        two = api.run_local(cli.parse_args(local_argv(
            "train", "--num_workers", "2",
            "--training_data", train_dir, "--validation_data", val_dir,
            "--evaluation_steps", str(LOCAL_EVAL_STEPS))), "train")
        two_s = time.perf_counter() - t0
        two_workers = _check_job(two, "two-worker train job",
                                 one_worker=False)
        two_workers.update({"card": card, "wall_s": two_s,
                            "examples_per_s": LOCAL_TRAIN / two_s,
                            "scatter_launches": sa.scatter_add.launches,
                            "phases": _phase_split(two)})
        print(json.dumps({"local_two_workers": two_workers}), flush=True)
        if sa.scatter_add.launches != 2 * LOCAL_STEPS:
            raise AssertionError(f"two-worker job: {two_workers}")
        del two

        def extra_job(label: str, *flags):
            """A one-worker train job on the same data with `flags`; the
            scatter-add launches are counted over it alone."""
            fm_zoo._DEDUP_PACKER = DedupPacker()
            args = cli.parse_args(local_argv(
                "train", "--training_data", train_dir,
                "--validation_data", val_dir,
                "--evaluation_steps", str(LOCAL_EVAL_STEPS), *flags))
            # ---- the main path: counts start at 0 here ----
            fa.reset_launch_counts()
            sa.scatter_add.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            job = api.run_local(args, "train")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = sa.scatter_add.launches
            # ---- end of the main path ----
            summary = _check_job(job, label)
            summary.update({
                "card": card, "flags": list(flags), "wall_s": wall,
                "examples_per_s": LOCAL_TRAIN / wall,
                "wire_format": job.workers[0].wire_format,
                "scatter_launches": launches,
                "phases": _phase_split(job)})
            print(json.dumps({label: summary}), flush=True)
            if launches != 2 * LOCAL_STEPS or \
                    fa.flash_attention.launches != 0:
                raise AssertionError(
                    f"{label}: {launches} scatter-add launches; 2 arenas x "
                    f"{LOCAL_STEPS} steps = {2 * LOCAL_STEPS}")
            return job, summary

        job, dedup = extra_job("local_deepfm_dedup", "--wire_format",
                               "dedup", "--steps_per_execution", "4")
        dedup["auc_equals_plain_job"] = \
            dedup["metrics"]["auc"] == train["metrics"]["auc"]
        if job.workers[0].wire_format != "dedup":
            raise AssertionError(f"the dedup job ran {dedup}")
        del job
        ckpt8 = os.path.join(tmp, "ckpt_int8")
        job, int8 = extra_job(
            "local_deepfm_int8", "--arena_dtype", "int8",
            "--checkpoint_dir", ckpt8,
            "--checkpoint_steps", str(LOCAL_CKPT_STEPS),
            "--keep_checkpoint_max", str(LOCAL_KEEP))
        arena = job.owner.state.model.fm_embedding
        int8["carrier_zero"] = not bool(arena.embedding.detach().any())
        int8["checkpoint_bytes"] = os.path.getsize(os.path.join(
            ckpt8, str(LOCAL_STEPS), "state.pt"))
        if arena.q8.dtype != torch.int8 or not int8["carrier_zero"]:
            raise AssertionError(f"the int8 job's arena: {int8}")
        del job, arena
        t0 = time.perf_counter()
        ev8 = api.run_local(cli.parse_args(local_argv(
            "evaluate", "--validation_data", val_dir,
            "--checkpoint_dir_for_init", ckpt8, "--arena_dtype", "int8")),
            "evaluate")
        eval8 = {"card": card, "exit_code": ev8.exit_code,
                 "model_step": ev8.owner.step,
                 "auc": (ev8.metrics or {}).get("auc"),
                 "train_auc": int8["metrics"]["auc"],
                 "wall_s": time.perf_counter() - t0,
                 "tol": LOCAL_EVAL_AUC_TOL}
        print(json.dumps({"local_evaluate_int8": eval8}), flush=True)
        if ev8.exit_code != 0 or ev8.owner.step != LOCAL_STEPS or \
                eval8["auc"] is None or abs(eval8["auc"] - eval8[
                    "train_auc"]) > LOCAL_EVAL_AUC_TOL:
            raise AssertionError(f"evaluate from the int8 checkpoint: "
                                 f"{eval8}")
        del ev8
        summary = {"dataset_write_s": write_s, "dataset_bytes": data_bytes,
                   "train": train, "evaluate": evaluate,
                   "two_workers": two_workers, "dedup": dedup,
                   "int8": int8, "evaluate_int8": eval8}
        launches.update({
            "local_deepfm_dedup": dedup["scatter_launches"],
            "local_deepfm_int8": int8["scatter_launches"]})
        served = {"train_dir": train_dir, "val_dir": val_dir,
                  "ckpt": ckpt, "ckpt8": ckpt8,
                  "export": export_dir, "auc": train["metrics"]["auc"],
                  "auc_int8": int8["metrics"]["auc"]}
        return summary, launches, served
    finally:
        events.configure(None)


# ---- resilient_local: crash and relaunch, faults, traces, the scanner ----

# The stop of (a): the subprocess is killed once step 16's checkpoint has
# committed and the 4th training task's report is journaled.  A seeded
# delay at rpc.report's 8th hit (index 7: two reports a task, so the 4th
# task's version report, after its result report) holds the job there
# while step 16's write lands, so the kill falls before step 24's.
CRASH_STEP = 2 * LOCAL_CKPT_STEPS                              # 16
CRASH_TASKS = CRASH_STEP * AUC_BATCH // LOCAL_RECORDS_PER_TASK  # 4
CRASH_HOLD_HIT = 2 * CRASH_TASKS - 1                          # 7
CRASH_HOLD_S = 2.5
CRASH_WAIT_S = 180.0
# (b): seeded faults at every point a train job fires, at hit indices the
# job reaches (rpc.get_task ~11 hits, rpc.report ~20, checkpoint.write 4)
FAULT_SEED = 20241017
FAULT_PLAN = ((faults.POINT_RPC_GET_TASK, 8, 3),
              (faults.POINT_RPC_REPORT, 14, 4),
              (faults.POINT_CHECKPOINT_WRITE, 3, 1))
FAULT_DELAY_S = 0.01
FAST_RETRIES = {resilience.ENV_INITIAL_BACKOFF_S: "0.001",
                resilience.ENV_MAX_BACKOFF_S: "0.002"}
SCATTER_KERNEL = "permute_rows_kernel"   # one per scatter-add launch


def chaos_registry() -> FaultRegistry:
    """The seeded schedule of (b): raises, drops and delays at rpc.get_task
    and rpc.report, raises at checkpoint.write (a skipped save)."""
    rng = np.random.default_rng(FAULT_SEED)
    specs = []
    for point, hits, n in FAULT_PLAN:
        for at in sorted(rng.choice(hits, size=n, replace=False)):
            action = ("raise", "drop", "delay")[int(rng.integers(3))]
            if point == faults.POINT_CHECKPOINT_WRITE:
                action = "raise"
            specs.append(FaultSpec(point, int(at), action,
                                   FAULT_DELAY_S if action == "delay"
                                   else 0.0))
    return FaultRegistry(specs, seed=FAULT_SEED)


def resilient_argv(train_dir: str, val_dir: str, *extra) -> list:
    """local_deepfm's train job: its records, batch, tasks, eval rounds."""
    return local_argv("train", "--num_epochs", "1",
                      "--training_data", train_dir,
                      "--validation_data", val_dir,
                      "--evaluation_steps", str(LOCAL_EVAL_STEPS), *extra)


def run_counted(args) -> tuple:
    """One Local train job on the main path, its scatter-add launches
    counted from 0; returns (job, launches, wall seconds)."""
    # ---- the main path: counts start at 0 here ----
    fa.reset_launch_counts()
    sa.scatter_add.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    job = api.run_local(args, "train")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sa.scatter_add.launches
    # ---- end of the main path ----
    if fa.flash_attention.launches:
        raise AssertionError("a DeepFM job launched the flash kernel")
    return job, launches, wall


def job_summary(job, wall: float, launches: int, card: str) -> dict:
    """A train job's numbers; examples/s counts the records it trained
    (a relaunch's restored records are not among them)."""
    tm = job.master.task_manager
    trained = tm.counters.by_type.get(0, 0) * LOCAL_RECORDS_PER_TASK
    return {"card": card, "exit_code": job.exit_code, "wall_s": wall,
            "examples_per_s": trained / wall,
            "model_step": job.owner.step,
            "training_records_done": tm.snapshot()["training_records_done"],
            "training_tasks": tm.counters.by_type.get(0, 0),
            "auc": (job.metrics or {}).get("auc"),
            "scatter_launches": launches, "phases": _phase_split(job)}


def kill_after_commit(argv: list, ckpt: str, log: str, out: str) -> dict:
    """(a)'s first life: the train job through the port's CLI in a
    subprocess, SIGKILLed once its event log shows step CRASH_STEP's
    checkpoint committed and CRASH_TASKS training reports."""
    hold = FaultRegistry([FaultSpec(faults.POINT_RPC_REPORT, CRASH_HOLD_HIT,
                                    "delay", CRASH_HOLD_S)], seed=SEED)
    env = {**os.environ, **hold.env()}
    t0 = time.perf_counter()
    with open(out, "w") as sink:
        proc = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.client.main",
             *argv], cwd=ROOT, env=env, stdout=sink,
            stderr=subprocess.STDOUT)
        try:
            while True:
                if proc.poll() is not None:
                    with open(out) as f:
                        tail = f.read()[-4000:]
                    raise AssertionError(
                        f"the job to kill exited {proc.returncode} first:"
                        f"\n{tail}")
                evs = (events.read_events(log) if os.path.exists(log)
                       else [])
                saved = {e["step"] for e in evs
                         if e["event"] == events.CHECKPOINT_SAVED}
                reports = sum(1 for e in evs
                              if e["event"] == events.TASK_REPORTED)
                if CRASH_STEP in saved and reports >= CRASH_TASKS:
                    break
                if time.perf_counter() - t0 > CRASH_WAIT_S:
                    raise AssertionError(f"no step {CRASH_STEP} commit in "
                                         f"{CRASH_WAIT_S} s")
                time.sleep(0.02)
            proc.kill()   # SIGKILL: no handler, no flush
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    killed_at_s = time.perf_counter() - t0
    with open(os.path.join(ckpt, "task_state.json")) as f:
        journal = json.load(f)
    return {"killed_at_s": killed_at_s, "returncode": proc.returncode,
            "committed": committed_steps(ckpt),
            "journal_versions": sorted(e[3] for e in
                                       journal["done_training_shards"]),
            "journal_records": journal["records_done"]}


class Background(threading.Thread):
    """`fn(*args)` on a thread; `result()` joins it and returns its value
    or re-raises its exception."""

    def __init__(self, fn, *args):
        super().__init__(daemon=True, name=fn.__name__)
        self._fn, self._args = fn, args
        self._out, self._exc = None, None
        self.start()

    def run(self):
        try:
            self._out = self._fn(*self._args)
        except BaseException as exc:   # re-raised by result()
            self._exc = exc

    def result(self, timeout: float):
        self.join(timeout)
        if self.is_alive():
            raise AssertionError(f"{self.name} still running after "
                                 f"{timeout} s")
        if self._exc is not None:
            raise self._exc
        return self._out


def state_gap(path_a: str, path_b: str) -> dict:
    """Two state.pt files (model and Adam state), bit for bit."""
    a = torch.load(path_a, map_location="cpu", weights_only=True)
    b = torch.load(path_b, map_location="cpu", weights_only=True)
    worst = 0.0
    equal = a["step"] == b["step"] and set(a["model"]) == set(b["model"])
    for k, v in a["model"].items():
        equal = equal and torch.equal(v, b["model"][k])
        worst = max(worst, float((v.double() - b["model"][k].double())
                                 .abs().max()))
    for sa_, sb_ in zip(a["optimizer"]["state"].values(),
                        b["optimizer"]["state"].values()):
        for key, v in sa_.items():
            equal = equal and torch.equal(torch.as_tensor(v),
                                          torch.as_tensor(sb_[key]))
    return {"bitwise": bool(equal), "max_abs_param_diff": worst}


def trace_scatter_launches(path: str) -> dict:
    """The scatter-add kernels in a Chrome trace: launches (one
    permute_rows_kernel each) and the kernel names seen."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in evs if e.get("cat") == "kernel"]
    # the hand kernels' names, their argument lists cut off
    names = sorted({n[:n.index("(", n.index("kernel"))]
                    for n in kernels if "scatter_add_" in n
                    or SCATTER_KERNEL in n})
    return {"launches": sum(1 for n in kernels if SCATTER_KERNEL in n),
            "kernel_names": names, "kernels": len(kernels)}


def observe_and_inject(card, root, train_dir, val_dir, out, launches):
    """resilient_local's (b) fault runs and (c) traced job; fills `out`
    and `launches`.  They run beside (a)'s first life, so their times are
    taken under that overlap."""
    # (b) two runs under one seeded schedule
    saved_env = {k: os.environ.get(k) for k in FAST_RETRIES}
    os.environ.update(FAST_RETRIES)
    traces = []
    try:
        for run in (1, 2):
            resilience.reset_stats()
            registry = faults.install(chaos_registry())
            try:
                job, n, wall = run_counted(cli.parse_args(resilient_argv(
                    train_dir, val_dir,
                    "--checkpoint_dir", os.path.join(root, f"chaos{run}"),
                    "--checkpoint_steps", str(LOCAL_CKPT_STEPS))))
                snap = job.master.snapshot()
            finally:
                faults.uninstall()
            summary = job_summary(job, wall, n, card)
            summary.update({"unfired": registry.unfired(),
                            "faults": snap["faults"],
                            "resilience": snap["resilience"],
                            "failed_reports":
                                snap["tasks"]["counters"]["failed"]})
            print(json.dumps({f"resilient_faults_{run}": summary}),
                  flush=True)
            if job.exit_code != 0 or summary["unfired"] or \
                    summary["training_records_done"] != LOCAL_TRAIN or \
                    summary["training_tasks"] != LOCAL_TASKS or \
                    not summary["resilience"]["retries"] or \
                    not summary["faults"].get("injected") or \
                    n != 2 * LOCAL_STEPS or \
                    not AUC_BAND[0] <= (summary["auc"] or 0) <= AUC_BAND[1]:
                raise AssertionError(f"fault run {run}: {summary}")
            traces.append(registry.trace_text())
            launches[f"resilient_faults_{run}"] = n
            out[f"faults_{run}"] = summary
            del job
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["traces_identical"] = traces[0] == traces[1]
    out["trace"] = traces[0]
    if not out["traces_identical"]:
        raise AssertionError(f"fault traces differ:\n{traces[0]}\n--\n"
                             f"{traces[1]}")

    # (c) observability
    profile = os.path.join(root, "profile")
    job, n, wall = run_counted(cli.parse_args(resilient_argv(
        train_dir, val_dir, "--profile_dir", profile,
        "--tensorboard_log_dir", os.path.join(root, "tb"))))
    observed = job_summary(job, wall, n, card)
    trace = job.workers[0].profile_trace
    steps_in_task = LOCAL_RECORDS_PER_TASK // AUC_BATCH
    observed.update({
        "trace": os.path.basename(trace or ""),
        "trace_files": sorted(os.listdir(profile)),
        "trace_bytes": os.path.getsize(trace) if trace else 0,
        "traced": trace_scatter_launches(trace) if trace else {},
        "steps_in_traced_task": steps_in_task,
        "summary_active": job.master.eval_summary.active,
        "summary_reason": job.master.eval_summary.reason})
    print(json.dumps({"resilient_observed": observed}), flush=True)
    if job.exit_code != 0 or observed["trace_files"] != [observed["trace"]] \
            or observed["traced"]["launches"] != 2 * steps_in_task or \
            not any("scatter_add" in k
                    for k in observed["traced"]["kernel_names"]) or \
            n != 2 * LOCAL_STEPS:
        raise AssertionError(f"the observed job: {observed}")
    launches["resilient_observed"] = n
    out["observed"] = observed
    del job


@contextlib.contextmanager
def native_reads():
    """`TFRecordReader.read_bulk` through the native scanner's
    `read_records_np` for the length of the block: the comparison that
    keeps the job's reads on the Python path."""
    python = record_io.TFRecordReader.read_bulk

    def read_bulk(reader, start, end=None):
        end = len(reader) if end is None else min(end, len(reader))
        return native_io.read_records_np(reader._path, reader._offsets,
                                         start, end, reader._check_crc)

    record_io.TFRecordReader.read_bulk = read_bulk
    try:
        yield
    finally:
        record_io.TFRecordReader.read_bulk = python


def read_job_records(files) -> float:
    """Seconds to read every record of `files` as the job's tasks do: one
    `read_bulk` per task range, through the reader's indexes."""
    readers = [record_io.TFRecordReader(path) for path in files]
    t0 = time.perf_counter()
    for reader in readers:
        for start in range(0, len(reader), LOCAL_RECORDS_PER_TASK):
            reader.read_bulk(start, start + LOCAL_RECORDS_PER_TASK)
    seconds = time.perf_counter() - t0
    for reader in readers:
        reader.close()
    return seconds


def scanner_and_reads(card, train_dir, val_dir, launches) -> dict:
    """resilient_local's (d), after (a)'s subprocess has ended: the index
    of every file of the job through `record_io.build_index` (native,
    counted) against the Python scanner's, then the job's reads through
    each scanner, in the order native, python, python, native: one pass
    of `read_bulk` over its task ranges, and the whole train job with its
    data_wait, pack and wall."""
    files = sorted(os.path.join(d, f) for d in (train_dir, val_dir)
                   for f in os.listdir(d) if f.endswith(".tfrecord"))
    scans = []
    for path in files:
        t0 = time.perf_counter()
        native = record_io.build_index(path)
        t1 = time.perf_counter()
        python = record_io.python_index(path)
        t2 = time.perf_counter()
        scans.append({"file": os.path.basename(path),
                      "records": int(len(native)),
                      "bitwise": native.dtype == python.dtype == np.int64
                      and native.tobytes() == python.tobytes(),
                      "native_ms": (t1 - t0) * 1e3,
                      "python_ms": (t2 - t1) * 1e3})
    reads = []
    for i, path_name in enumerate("native python python native".split()):
        with (native_reads() if path_name == "native"
              else contextlib.nullcontext()):
            read_s = read_job_records(files)
            job, n, wall = run_counted(cli.parse_args(resilient_argv(
                train_dir, val_dir)))
        phases = _phase_split(job)
        reads.append({"path": path_name, "read_bulk_s": read_s,
                      "wall_s": wall,
                      "data_wait_s": phases["data_wait"]["total_s"],
                      "pack_s": phases["pack"]["total_s"],
                      "auc": (job.metrics or {}).get("auc")})
        if job.exit_code != 0 or n != 2 * LOCAL_STEPS:
            raise AssertionError(f"the {path_name} read job: {reads[-1]}")
        launches[f"resilient_reads_{i + 1}"] = n
        del job
    return {"card": card, "files": scans, "reads": reads}


def resilient_local(card: str, work: str, served: dict):
    """Local DeepFM jobs that survive a crash and injected faults, traced
    and read through the native scanner: (a) kill after a committed
    checkpoint and relaunch, (b) two runs under one seeded fault schedule,
    (c) --profile_dir and --tensorboard_log_dir, (d) the native TFRecord
    index against the Python one.  Returns (summary, launches by path)."""
    root = os.path.join(work, "resilient_local")
    os.makedirs(root)
    train_dir, val_dir = served["train_dir"], served["val_dir"]
    out = {}
    launches = {}
    record_io.reset_served()

    # (a)'s first life runs in a subprocess, watched from a thread, while
    # (b), (c) and (d) run here: it spends most of its time starting up
    ckpt = os.path.join(root, "ckpt")
    log = os.path.join(root, "events.jsonl")
    argv = resilient_argv(
        train_dir, val_dir, "--checkpoint_dir", ckpt,
        "--checkpoint_steps", str(LOCAL_CKPT_STEPS),
        "--keep_checkpoint_max", str(LOCAL_KEEP), "--event_log", log)
    killer = Background(kill_after_commit, argv, ckpt, log,
                        os.path.join(root, "killed.log"))

    try:
        observe_and_inject(card, root, train_dir, val_dir, out, launches)
    finally:
        # the watcher always ends its subprocess: killed at the commit,
        # or at its deadline
        killer.join(CRASH_WAIT_S + 60)

    # (a) the kill, then the relaunch
    killed = killer.result(0)
    print(json.dumps({"resilient_killed": {"card": card, **killed}}),
          flush=True)
    if killed["committed"][-1] != CRASH_STEP or \
            max(killed["journal_versions"]) < CRASH_STEP:
        raise AssertionError(f"the kill missed its window: {killed}")
    job, n, wall = run_counted(cli.parse_args(argv))
    evs = events.read_events(log)
    events.configure(None)
    restored = [e["step"] for e in evs if e["pid"] == os.getpid()
                and e["event"] == events.CHECKPOINT_RESTORED]
    trained_steps = LOCAL_STEPS - CRASH_STEP
    relaunch = job_summary(job, wall, n, card)
    relaunch.update({
        "restored_steps": restored,
        "versus_uninterrupted": state_gap(
            os.path.join(served["ckpt"], str(LOCAL_STEPS), "state.pt"),
            os.path.join(ckpt, str(LOCAL_STEPS), "state.pt")),
        "uninterrupted_auc": served["auc"]})
    print(json.dumps({"resilient_relaunch": relaunch}), flush=True)
    if job.exit_code != 0 or restored[:1] != [CRASH_STEP] or \
            relaunch["training_tasks"] != trained_steps * AUC_BATCH \
            // LOCAL_RECORDS_PER_TASK or \
            relaunch["training_records_done"] != LOCAL_TRAIN or \
            job.owner.step != LOCAL_STEPS or n != 2 * trained_steps or \
            not AUC_BAND[0] <= (relaunch["auc"] or 0) <= AUC_BAND[1]:
        raise AssertionError(f"the relaunched job: {relaunch}")
    # the JAX package's resumed Local job equals its uninterrupted twin
    # bit for bit (tests/test_torch_resilient_local.py): so must this one
    if not relaunch["versus_uninterrupted"]["bitwise"]:
        raise AssertionError(f"the relaunched job's final state differs "
                             f"from the uninterrupted job's: {relaunch}")
    launches["resilient_relaunch"] = n
    out["killed"], out["relaunch"] = killed, relaunch
    del job

    # every index build of the phase in this process, (d)'s included,
    # went through the native scanner, none through Python
    scanner = scanner_and_reads(card, train_dir, val_dir, launches)
    scanner["served"] = served_by = record_io.served()
    print(json.dumps({"resilient_scanner": scanner}), flush=True)
    if not all(s["bitwise"] for s in scanner["files"]) or \
            (served_by.get("index", {}).get("native") or 0) < \
            len(scanner["files"]) or \
            any(v["python"] for v in served_by.values()):
        raise AssertionError(f"the native scanner: {scanner}")
    out["scanner"] = scanner
    return out, launches


# ---- stream_judgment: the stream reader, perpetual windows, judgment ----

# The online loop's shape (the JAX package's online/pipeline.py
# OnlineConfig defaults): 128 records a window, 32 a task, 64 a poll,
# 512 users x 128 items, a buffer of 64 windows, a checkpoint every 2
# windows; ctr_mlp through the Trainer.
STREAM_WINDOWS = 32
STREAM_WINDOW_RECORDS = 128
STREAM_TASK_RECORDS = 32
STREAM_POLL_RECORDS = 64
STREAM_USERS, STREAM_ITEMS = 512, 128
STREAM_BUFFER = 64
STREAM_CKPT_EVERY = 2
STREAM_TASKS_PER_TICK = 2        # a window every 2 ticks: training keeps up
STREAM_POLL_S = 0.5              # fake seconds between two polls
STREAM_TASK_S = 0.05             # fake seconds a trained task takes
STREAM_T0 = 1_700_000_000.0
# The injected schedule: the 4th poll stalls (raise) and the 3rd arm is
# skipped (its window is offered again the next tick).  Once 9 windows
# have sealed, one poll pulls enough records to fill the 64-window buffer
# past its cap, so it drops its oldest window, armed and not yet trained,
# which the ledger then replays.  After 66 tasks (two of window 16's) the
# task manager restarts from its journal.
STREAM_STALL_HIT = 3
STREAM_REARM_HIT = 2
STREAM_DROP_AFTER = 9
STREAM_TASKS_PER_WINDOW = STREAM_WINDOW_RECORDS // STREAM_TASK_RECORDS
STREAM_RESTART_TASKS = 16 * STREAM_TASKS_PER_WINDOW + 2
STREAM_MAX_TICKS = 400
STREAM_CPU_LOSS_TOL = 1e-5       # f32 MLP, 4 Adam steps, card vs CPU
# span-event fields that are wall time, not the stream's fake clock
WALL_FIELDS = ("ts", "pid", "capture_s", "write_s")
# (b): the Local judgment job's loops and the freshness drill
JUDGE_INTERVAL_S = 0.5
FRESH_TICK_S = 5.0
FRESH_KEEP_UP_TICKS = 6
FRESH_HOLD_TICKS = 12            # 60 fake seconds, twice the objective
FRESH_RESUME_TICKS = 2
FRESH_PREDICTS = 4               # a tick
FRESH_ROWS = 16
FRESH_STALENESS_S = 30.0         # the drill's --slo_staleness_p99_s


class FakeClock:
    """One clock for the source, reader, task manager, lineage and SLO
    loops; only `advance` moves it."""

    def __init__(self, start: float):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


def stream_schedule() -> FaultRegistry:
    return FaultRegistry([
        FaultSpec(faults.POINT_STREAM_POLL, STREAM_STALL_HIT, "raise"),
        FaultSpec(faults.POINT_TASK_REARM, STREAM_REARM_HIT, "raise")],
        seed=SEED)


def _stable_events(records) -> list:
    return [{k: v for k, v in r.items() if k not in WALL_FIELDS}
            for r in records]


def _window_content(records) -> list:
    """(user, item, clicked) of each record: a replay restores the data
    and stamps every record with the window's watermark, not the event
    time each poll stamped."""
    return [(r["user"], r["item"], r["clicked"]) for r in records]


def _window_records(reader, name: str, n: int) -> list:
    task = pb.Task(shard=pb.Shard(name=name, start=0, end=n))
    return list(reader.read_records(task))


class _StreamRun:
    """The bookkeeping of one stream run: the windows sealed, offered,
    armed and left to train, and what happened to them."""

    def __init__(self, windows: int, journal: str):
        self.windows = windows
        self.journal = journal
        self.pending = []      # sealed windows not yet armed, oldest first
        self.names = {}        # window id -> name, once armed
        self.left = {}         # window name -> tasks not yet reported
        self.sealed = {}       # window id -> its records as sealed
        self.losses = []
        self.restored = []
        self.restarts = 0
        self.tasks = self.records = self.released = 0
        self.burst = False


def _stream_tick(run, clock, reader, tm, trainer, spec, state, saver):
    """One tick of the loop: poll (or the burst), arm one window, train
    up to STREAM_TASKS_PER_TICK tasks; returns (state, tm)."""
    clock.advance(STREAM_POLL_S)
    snap = reader.snapshot()
    if not run.burst and snap["windows_sealed"] == STREAM_DROP_AFTER \
            and run.windows > STREAM_DROP_AFTER:
        # exactly enough records to seal one window past the cap
        run.burst = True
        reader.poll((STREAM_BUFFER + 1 - snap["buffered_windows"])
                    * STREAM_WINDOW_RECORDS - snap["pending_records"])
    elif snap["windows_sealed"] < run.windows:
        reader.poll()
    for w in reader.take_new_windows():
        if w.window_id < run.windows:
            run.pending.append(w)
            run.sealed[w.window_id] = list(w.records)
    if run.pending:
        w = run.pending[0]
        n = tm.arm_window(w.name, len(w.records), STREAM_TASK_RECORDS,
                          watermark_unix_s=w.watermark_unix_s,
                          window_id=w.window_id, start_index=w.start_index)
        if n is not None:          # None: task.rearm skipped this offer
            run.pending.pop(0)
            run.names[w.window_id] = w.name
            run.left[w.name] = n
    for _ in range(STREAM_TASKS_PER_TICK):
        task = tm.get(0)
        if task is None:
            break
        name = task.shard.name
        try:
            batch = list(reader.read_records(task))
        except LookupError:
            # the buffer dropped it: replay it from the ledger
            (entry,) = [e for e in tm.open_windows() if e["name"] == name]
            ok = reader.restore_window(
                name, entry["window_id"], entry["start"],
                entry["records"], entry["watermark"])
            run.restored.append({
                "window": entry["window_id"], "ok": ok,
                "exact": _window_content(_window_records(
                    reader, name, entry["records"]))
                == _window_content(run.sealed[entry["window_id"]])})
            batch = list(reader.read_records(task))
        state, loss = trainer.train_on_batch(
            state, spec.feed(batch, reader.metadata))
        run.losses.append(float(loss))
        clock.advance(STREAM_TASK_S)
        tm.report(task.task_id, True, worker_id=0, records=len(batch),
                  model_version=int(state.step))
        run.tasks += 1
        run.records += len(batch)
        run.left[name] -= 1
        if not run.left[name]:
            (wid,) = [k for k, v in run.names.items() if v == name]
            if not (tm.release_window(wid) and reader.release_window(name)):
                raise AssertionError(f"window {wid}: release not acked")
            run.released += 1
            if run.released % STREAM_CKPT_EVERY == 0:
                saver.save(state)
                saver.wait_until_finished()
        if run.tasks == STREAM_RESTART_TASKS:
            # a master restart: a new manager over the journal (and its
            # predecessor's registry) re-arms the open windows' undone
            # shards
            tm = TaskManager(perpetual=True, persist_path=run.journal,
                             clock=clock,
                             metrics_registry=tm.counters.registry)
            run.restarts += 1
            run.left = {e["name"]: len(range(0, e["records"],
                                             e["per_task"])) - len(e["done"])
                        for e in tm.open_windows()}
    return state, tm


def stream_train(device: str, root: str, windows: int = STREAM_WINDOWS,
                 init=None) -> dict:
    """Train `windows` stream windows on `device`: ClickStreamSource ->
    StreamReader -> TaskManager(perpetual=True, journaled) -> leases ->
    read_records -> ctr_mlp's feed -> Trainer.train_on_batch -> report
    -> release, a checkpoint every STREAM_CKPT_EVERY windows, under one
    fake clock and the injected schedule.  `init` is a state dict to
    start from (else the seed's init).  Returns the run's numbers, its
    tapped event stream, losses and final parameters."""
    os.makedirs(root)
    clock = FakeClock(STREAM_T0)
    spec = get_model_spec(ZOO_DIR, CTR)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, device=device)
    source = ClickStreamSource(
        seed=SEED, users=STREAM_USERS, items=STREAM_ITEMS,
        records_per_poll=STREAM_POLL_RECORDS, clock=clock)
    reader = StreamReader(source, window_records=STREAM_WINDOW_RECORDS,
                          max_buffered_windows=STREAM_BUFFER, clock=clock)
    state = trainer.init_state(SEED, spec.feed(source.records(
        0, STREAM_TASK_RECORDS))["features"])
    if init is not None:
        state.model.load_state_dict(init)
    init_weights = {k: v.detach().cpu().clone()
                    for k, v in state.model.state_dict().items()}
    saver = CheckpointSaver(os.path.join(root, "ckpt"), keep_max=0,
                            clock=clock)
    run = _StreamRun(windows, os.path.join(root, "task_state.json"))
    seen = []
    lineage = WindowLineage(clock=clock)
    events.add_observer(seen.append)
    lineage.install()      # before the first poll
    faults.install(stream_schedule())
    try:
        tm = TaskManager(perpetual=True, persist_path=run.journal,
                         clock=clock)
        t0 = time.perf_counter()
        for _ in range(STREAM_MAX_TICKS):
            if run.released == windows:
                break
            state, tm = _stream_tick(run, clock, reader, tm, trainer,
                                     spec, state, saver)
        else:
            raise AssertionError(f"{run.released} of {windows} windows "
                                 f"released in {STREAM_MAX_TICKS} ticks")
        if device == "cuda":
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        fault_stats = faults.stats()
    finally:
        faults.uninstall()
        lineage.close()
        events.remove_observer(seen.append)
        saver.close()
    stable = _stable_events(seen)
    decomps = {wid: decompose(s) for wid, s in
               from_events(stable).items() if wid < windows}
    closed = {p: sorted(d["phases"][p] for d in decomps.values()
                        if p in d["phases"])
              for p in ("ingest_wait", "arm_wait")}
    return {
        "windows": windows, "tasks": run.tasks, "records": run.records,
        "released": run.released, "restarts": run.restarts,
        "restored": run.restored, "wall_s": wall_s, "losses": run.losses,
        "online": tm.online_snapshot(), "reader": reader.snapshot(),
        "stream_lag_gauge_s": tm.counters.registry.value(
            "master_stream_watermark_lag_seconds"),
        "faults": fault_stats,
        "lineage": lineage.snapshot(),
        "lineage_windows": sorted(decomps),
        "decomposed": all({"ingest_wait", "arm_wait"} <= set(d["phases"])
                          for d in decomps.values()),
        "open_at": sorted({d["blocked_phase"] for d in decomps.values()}),
        "phase_quantiles_s": {
            p: {"p50": v[len(v) // 2],
                "p99": v[min(len(v) - 1, int(0.99 * len(v)))]}
            for p, v in closed.items() if v},
        "events": stable,
        "params": {k: v.detach().cpu().clone()
                   for k, v in state.model.state_dict().items()},
        "init": init_weights,
        "ckpt": os.path.join(root, "ckpt"),
        "steps": int(state.step),
    }


def check_stream(run: dict) -> None:
    online, reader, windows = run["online"], run["reader"], run["windows"]
    fired = run["faults"].get("by_action", {})
    problems = [what for what, bad in (
        ("windows armed", online["windows_armed"] != windows),
        ("windows released", online["windows_released"] != windows
         or run["released"] != windows),
        ("windows lost", online["windows_lost"] != 0),
        ("duplicate reports", online["duplicate_reports"] != 0),
        ("tasks", run["tasks"] != windows * STREAM_TASKS_PER_WINDOW),
        ("records", run["records"] != windows * STREAM_WINDOW_RECORDS),
        ("steps", run["steps"] != run["tasks"]),
        ("stall", reader["poll_faults"] != 1 or fired.get("raise") != 2),
        ("rearm fault", online["rearm_faults"] != 1),
        ("drop", reader["dropped_windows"] != 1
         or reader["replayed_windows"] != 1),
        ("replay", [(r["ok"], r["exact"]) for r in run["restored"]]
         != [(True, True)]),
        ("restart", run["restarts"] != 1),
        ("lineage", run["lineage_windows"] != list(range(windows))
         or not run["decomposed"] or run["open_at"] != ["train"]),
    ) if bad]
    if problems:
        summary = {k: v for k, v in run.items()
                   if k not in ("events", "params", "init", "losses")}
        raise AssertionError(f"stream run: {problems}: {summary}")


def freshness_drill(card: str, root: str, stream: dict, args,
                    device: str = "cuda") -> dict:
    """(b) 2: the stream's checkpoints produced one by one into a
    serving directory by a CheckpointSaver on the fake clock (its
    `produced` stamp), served in process by a ServingEngine and a
    CheckpointReloader; each predict's served step feeds a
    FreshnessTracker, whose registry a MetricHistory samples for an
    SloEvaluator over the shipped SLOs, whose breach a FlightRecorder
    captures.  The reloads keep up, then one step's reload is held past
    the objective, then they resume."""
    clock = FakeClock(STREAM_T0 + 10_000.0)
    spec = get_model_spec(ZOO_DIR, CTR)
    source = CheckpointSaver(stream["ckpt"])
    steps = iter(source.all_steps())
    rng = np.random.default_rng(SEED)
    features = {"features": ctr_zoo.encode(
        rng.integers(0, STREAM_USERS, FRESH_ROWS),
        rng.integers(0, STREAM_ITEMS, FRESH_ROWS))}
    template = build_state_template(spec, features["features"], device)
    serve_dir = os.path.join(root, "serving")
    incident_dir = os.path.join(root, "incidents")
    saver = CheckpointSaver(serve_dir, keep_max=3, clock=clock)
    tracker = FreshnessTracker(
        clock=clock,
        produced_time_fn=lambda s: (read_produced_meta(serve_dir, s)
                                    or {}).get("produced_unix_s"))
    history = MetricHistory(registries=[tracker.metrics_registry],
                            capacity=args.history_capacity, clock=clock)
    evaluator = None
    recorder = FlightRecorder(
        incident_dir=incident_dir, ring_capacity=args.incident_ring,
        max_bundles=args.incident_max_bundles, history=history,
        snapshot_fn=lambda: {"freshness": tracker.snapshot(),
                             "slo": evaluator.report()}).install()
    evaluator = SloEvaluator(history, specs=shipped_specs(args),
                             clock=clock, on_breach=recorder.breach)

    def produce():
        step = next(steps)
        state = source.restore_step(step, template)
        if state is None or not saver.save(state):
            raise AssertionError(f"could not produce step {step}")
        saver.wait_until_finished()
        tracker.note_produced(step)

    plan = (["keep_up"] * FRESH_KEEP_UP_TICKS + ["hold"] * FRESH_HOLD_TICKS
            + ["resume"] * FRESH_RESUME_TICKS)
    states, served = [], []
    try:
        produce()
        engine = ServingEngine.from_checkpoint(
            serve_dir, spec, features["features"], device=device)
        reloader = CheckpointReloader(engine, serve_dir)
        for i, mode in enumerate(plan):
            clock.advance(FRESH_TICK_S)
            if mode == "keep_up" or plan[i - 1] == "keep_up":
                produce()      # the first hold tick's step stays unserved
            if mode != "hold":
                reloader.check_once()
            for _ in range(FRESH_PREDICTS):
                _, step = engine.predict(features, FRESH_ROWS)
                tracker.observe_response(step)
                served.append(step)
            history.tick()
            evaluator.tick()
            states.append([mode, evaluator.state("staleness_p99")])
        recorder.flush()
    finally:
        recorder.close()
        saver.close()
        source.close()
    bundles = list_bundles(incident_dir)
    loaded = load_bundle(bundles[0]["path"]) if bundles else {}
    out = {"card": card, "served_steps": sorted(set(served)),
           "reloads": reloader.reload_count, "states": states,
           "decisions": evaluator.decisions,
           "freshness": tracker.snapshot(),
           "bundles": [b["bundle"] for b in bundles],
           "bundle_evidence": loaded.get("manifest", {}).get("evidence"),
           "bundle_sections": sorted(loaded),
           "objective_s": args.slo_staleness_p99_s}
    keep_up = {s for m, s in states if m == "keep_up"}
    hold = [s for m, s in states if m == "hold"]
    if keep_up != {"ok"} or "breach" not in hold or \
            out["bundles"] != ["incident-0001-slo_breach"] or \
            (out["bundle_evidence"] or {}).get("slo") != "staleness_p99":
        raise AssertionError(f"the freshness drill: {out}")
    return out


def judgment_job(card: str, root: str, served: dict) -> tuple:
    """(b) 1: local_deepfm's train job with the judgment flags.  The
    master's history and SLO threads run and its flight recorder taps
    the events; the job must end on local_deepfm's final state, bit for
    bit."""
    ckpt = os.path.join(root, "ckpt")
    incident_dir = os.path.join(root, "incidents")
    argv = resilient_argv(
        served["train_dir"], served["val_dir"], "--checkpoint_dir", ckpt,
        "--checkpoint_steps", str(LOCAL_CKPT_STEPS),
        "--keep_checkpoint_max", str(LOCAL_KEEP),
        "--history_interval", str(JUDGE_INTERVAL_S),
        "--slo_interval", str(JUDGE_INTERVAL_S),
        "--incident_dir", incident_dir)
    job, launches, wall = run_counted(cli.parse_args(argv))
    summary = job_summary(job, wall, launches, card)
    snap = job.master.snapshot()
    bundle = load_bundle(job.master.flight_recorder.capture(
        "manual", {"phase": "stream_judgment"}))
    summary.update({
        "failed_tasks": job.master.task_manager.counters.failed,
        "slo_states": snap["slo"]["states"],
        "slo_ticks": snap["slo"]["ticks"],
        "history": snap["slo"]["history"],
        "flight": snap["flight"],
        "bundles": [b["bundle"] for b in list_bundles(incident_dir)],
        "bundle_sections": sorted(bundle),
        "versus_local_deepfm": state_gap(
            os.path.join(served["ckpt"], str(LOCAL_STEPS), "state.pt"),
            os.path.join(ckpt, str(LOCAL_STEPS), "state.pt"))})
    del job
    if summary["exit_code"] != 0 or summary["failed_tasks"] or \
            launches != 2 * LOCAL_STEPS or \
            not AUC_BAND[0] <= (summary["auc"] or 0) <= AUC_BAND[1] or \
            summary["slo_states"] != {
                name: "no_data" for name in SLO_NAMES} or \
            summary["history"]["samples"] < 1 or summary["slo_ticks"] < 1 \
            or \
            summary["bundles"] != ["incident-0001-manual"] or \
            bundle["manifest"]["trigger"] != "manual" or \
            "master" not in bundle or \
            not summary["versus_local_deepfm"]["bitwise"]:
        raise AssertionError(f"the judgment job: {summary}")
    return summary, launches


def stream_judgment(card: str, work: str, served: dict):
    """(a) 32 stream windows trained on the card, twice (bit for bit),
    the first window against the CPU; (b) the Local DeepFM job with the
    judgment flags, and the freshness drill.  Returns (summary, the
    judgment job's scatter-add launches)."""
    root = os.path.join(work, "stream_judgment")
    t0 = time.perf_counter()
    first = stream_train("cuda", os.path.join(root, "run1"))
    check_stream(first)
    second = stream_train("cuda", os.path.join(root, "run2"))
    rerun = {
        "events_equal": second["events"] == first["events"],
        "params_bitwise": all(torch.equal(first["params"][k],
                                          second["params"][k])
                              for k in first["params"]),
        "losses_equal": second["losses"] == first["losses"],
        "events": len(first["events"])}
    cpu = stream_train("cpu", os.path.join(root, "cpu"), windows=1,
                       init=first["init"])
    head = first["losses"][:STREAM_TASKS_PER_WINDOW]
    cpu_err = max(abs(a - b) for a, b in zip(cpu["losses"], head))
    a_s = time.perf_counter() - t0
    stream = {k: v for k, v in first.items()
              if k not in ("events", "params", "init", "losses")}
    stream.update({"card": card, "rerun": rerun,
                   "second_wall_s": second["wall_s"],
                   "cpu_first_window_losses": cpu["losses"],
                   "first_window_losses": head,
                   "cpu_loss_max_abs_err": cpu_err,
                   "cpu_loss_tol": STREAM_CPU_LOSS_TOL,
                   "last_loss": first["losses"][-1]})
    print(json.dumps({"stream_train": stream}), flush=True)
    if not (rerun["events_equal"] and rerun["params_bitwise"]
            and rerun["losses_equal"]) or \
            len(cpu["losses"]) != STREAM_TASKS_PER_WINDOW or \
            cpu_err > STREAM_CPU_LOSS_TOL:
        raise AssertionError(f"the stream's rerun or CPU check: {stream}")

    t1 = time.perf_counter()
    job, launches = judgment_job(card, os.path.join(root, "judgment"),
                                 served)
    print(json.dumps({"stream_judgment_job": job}), flush=True)
    args = cli.parse_args(["train", "--slo_staleness_p99_s",
                           str(FRESH_STALENESS_S)])
    drill = freshness_drill(card, root, first, args)
    print(json.dumps({"stream_freshness": drill}), flush=True)
    b_s = time.perf_counter() - t1
    walls = {"card": card, "a_s": a_s, "b_s": b_s,
             "windows": first["windows"], "tasks": first["tasks"],
             "records": first["records"],
             "stream_lag_gauge_s": first["stream_lag_gauge_s"],
             "lineage_p50_p99_s": first["phase_quantiles_s"],
             "judgment_slo_states": job["slo_states"],
             "judgment_bundles": len(job["bundles"]),
             "drill_slo_states": [s for _, s in drill["states"]],
             "drill_bundles": len(drill["bundles"])}
    print(json.dumps({"stream_judgment": walls}), flush=True)
    return {"stream": stream, "judgment_job": job, "freshness": drill,
            "walls": walls}, launches


def bert_launches() -> dict:
    return {"flash_attention_fwd": fa.flash_attention.launches,
            "flash_attention_fwd_by_variant":
                dict(fa.flash_attention.launches_by_kernel),
            "flash_attention_bwd": fa.flash_attention.backward_launches,
            "flash_attention_bwd_by_variant":
                dict(fa.flash_attention.backward_launches_by_kernel),
            "scatter_add": sa.scatter_add.launches}


def reset_counts() -> None:
    fa.reset_launch_counts()
    sa.scatter_add.launches = 0


def check_bert_launches(label: str, launches: dict, steps: int,
                        layers: int, remat: bool, fwd_variant: str,
                        bwd_variant: str, other_forwards: bool = False
                        ) -> int:
    """Per step: one flash backward per layer; one flash forward per
    layer (two with remat: the checkpoint reruns it in the backward);
    one scatter-add (the token table).  Every launch on the named
    variants.  With `other_forwards` (a Local job: the init's forward and
    the eval batches) the forwards beyond the steps' must be a positive
    whole number of model forwards; returns that number."""
    train_fwd = steps * layers * (2 if remat else 1)
    fwd = launches["flash_attention_fwd"]
    extra = fwd - train_fwd
    if other_forwards:
        ok_extra = extra > 0 and extra % layers == 0
    else:
        ok_extra = extra == 0
    want = {"flash_attention_fwd_by_variant": {fwd_variant: fwd},
            "flash_attention_bwd": steps * layers,
            "flash_attention_bwd_by_variant": {bwd_variant: steps * layers},
            "scatter_add": steps}
    got = {k: ({n: c for n, c in v.items() if c} if isinstance(v, dict)
               else v) for k, v in launches.items()
           if k != "flash_attention_fwd"}
    if got != want or not ok_extra:
        raise AssertionError(
            f"{label}: launches {launches}; want {want} and "
            f"{train_fwd} training forwards"
            + (" plus whole model forwards" if other_forwards else ""))
    return extra // layers


def train_bert():
    """BERT-base training through the bare Trainer at bench_bert's shape,
    without and with remat: one counted step, timed steps, peak memory
    and a profiled step; then a small f32 BERT on the card vs the CPU.
    Returns (summary, launches by config)."""
    device = torch.device("cuda", 0)
    batch = bert_train_batch()
    summary, launches_by = {}, {}
    first_loss = {}
    for tag, extra in (("plain", ""), ("remat", ";remat=True")):
        remat = tag == "remat"
        spec = get_model_spec(ZOO_DIR, BERT, BERT_PARAMS + ";bf16=True"
                              + extra)
        trainer = Trainer(spec.model, spec.optimizer, spec.loss,
                          use_bf16=True, device=device)
        state = trainer.init_state(SEED, batch["features"])
        staged = trainer.stage_batch(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()

        # ---- the main path: counts start at 0 here ----
        reset_counts()
        state, loss = trainer.train_on_batch(state, staged)
        torch.cuda.synchronize()
        one_step = bert_launches()
        # ---- end of the main path ----
        peak_bytes = torch.cuda.max_memory_allocated()
        first_loss[tag] = float(loss)
        check_bert_launches(f"train_bert {tag}", one_step, 1, NUM_LAYERS,
                            remat, fa.SM90_WGMMA, fa.SM90_WGMMA)

        # ---- the main path: counts start at 0 here ----
        reset_counts()
        steps_per_s = trainer.timed_steps_per_sec(
            state, staged, iters=TRAIN_TIMED_STEPS)
        launches = bert_launches()
        # ---- end of the main path ----
        # the first call warms up with one step of its own
        check_bert_launches(f"train_bert {tag} timed", launches,
                            TRAIN_TIMED_STEPS + 1, NUM_LAYERS, remat,
                            fa.SM90_WGMMA, fa.SM90_WGMMA)
        breakdown = step_breakdown(trainer, state, staged)
        last = trainer.predict_on_batch(state, batch["features"])
        if not (np.isfinite(first_loss[tag]) and np.isfinite(last).all()
                and last.shape == (TRAIN_BATCH, 2)):
            raise AssertionError(f"train_bert {tag}: non-finite or "
                                 f"misshapen outputs")
        summary[tag] = {
            "config": BERT_PARAMS + ";bf16=True" + extra,
            "batch": TRAIN_BATCH, "seq_len": SEQ_LEN,
            "timed_steps": TRAIN_TIMED_STEPS,
            "steps_per_s": steps_per_s,
            "step_ms": 1e3 / steps_per_s,
            "examples_per_s": TRAIN_BATCH * steps_per_s,
            "first_loss": first_loss[tag],
            "peak_memory_bytes": peak_bytes,
            "state_bytes": base_bytes,
            "launches_one_step": one_step,
            "launches_timed": launches,
            "step_breakdown": breakdown,
        }
        launches_by[tag] = launches
        print(json.dumps({f"train_bert_{tag}": summary[tag]}), flush=True)
        del trainer, state, staged
        torch.cuda.empty_cache()
    # the same seed, the same kernels: remat changes memory, not numbers
    summary["remat_first_loss_equal"] = \
        first_loss["plain"] == first_loss["remat"]
    if not summary["remat_first_loss_equal"]:
        raise AssertionError(f"train_bert: remat's first loss "
                             f"{first_loss['remat']} is not the plain "
                             f"step's {first_loss['plain']} bit for bit")
    summary["cpu_check"] = bert_card_vs_cpu()
    return summary, launches_by


def bert_card_vs_cpu():
    """A few f32 AdamW steps of a small BERT (D = 64: the CUDA-core flash
    kernels) on the card and on the CPU (plain path) from the same
    weights."""
    spec = get_model_spec(ZOO_DIR, BERT, BERT_CPU_PARAMS)
    gpu = Trainer(spec.model, spec.optimizer, spec.loss, device="cuda")
    cpu = Trainer(spec.model, spec.optimizer, spec.loss, device="cpu")
    rng = np.random.RandomState(SEED + 3)
    batches = [{"features": {"input_ids": rng.randint(
                    0, 512, (8, 128)).astype(np.int32)},
                "labels": rng.randint(0, 2, 8).astype(np.int32)}
               for _ in range(BERT_CPU_STEPS)]
    gs = gpu.init_state(SEED, batches[0]["features"])
    cs = cpu.init_state(SEED, batches[0]["features"])
    cs.model.load_state_dict({k: v.cpu() for k, v in
                              gs.model.state_dict().items()})
    reset_counts()
    loss_err, losses = 0.0, []
    for batch in batches:
        gs, gl = gpu.train_on_batch(gs, batch)
        cs, cl = cpu.train_on_batch(cs, batch)
        losses.append(float(cl))
        loss_err = max(loss_err, abs(float(gl) - float(cl)))
    launches = bert_launches()
    check = {"config": BERT_CPU_PARAMS, "steps": BERT_CPU_STEPS,
             "losses_cpu": losses, "loss_max_abs_err": loss_err,
             "loss_tol": BERT_CPU_LOSS_TOL, "launches": launches}
    print(json.dumps({"bert_card_vs_cpu": check}), flush=True)
    check_bert_launches("bert_card_vs_cpu", launches, BERT_CPU_STEPS, 2,
                        False, fa.CUDA_CORE, fa.CUDA_CORE)
    if not loss_err <= BERT_CPU_LOSS_TOL:
        raise AssertionError(f"BERT on the card vs CPU: {check}")
    return check


def bert_argv(job: str, params: str, batch: int, *extra) -> list:
    return [job, "--distribution_strategy", "Local", "--model_def", BERT,
            "--model_params", params, "--minibatch_size", str(batch),
            "--records_per_task", str(BERT_RECORDS_PER_TASK), *extra]


def local_bert(card: str, work: str):
    """The Local runner on BERT: the planted-pairs job of tests/
    test_bert.py to accuracy > 0.9 and an evaluate job from its
    checkpoint with exactly its metrics; then one epoch at bench_bert's
    width for its wall and examples/s.  Returns (summary, launches by
    job, the full-width job's checkpoint directory, which
    `serve_cli_bert` serves).  Its files stay under `work`."""
    tmp = os.path.join(work, "local_bert")
    try:
        train_dir, val_dir = write_pairs(
            os.path.join(tmp, "tiny"), n_train=BERT_TINY_TRAIN, n_val=256,
            max_len=32, vocab=16, seed=SEED)
        ckpt = os.path.join(tmp, "ckpt_tiny")
        args = cli.parse_args(bert_argv(
            "train", BERT_TINY_PARAMS, BERT_TINY_BATCH,
            "--training_data", train_dir,
            "--validation_data", val_dir,
            "--num_epochs", str(BERT_TINY_EPOCHS),
            "--checkpoint_dir", ckpt,
            "--checkpoint_steps", str(BERT_TINY_STEPS)))
        # ---- the main path: counts start at 0 here ----
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        job = api.run_local(args, "train")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        tiny_launches = bert_launches()
        # ---- end of the main path ----
        metrics = job.metrics or {}
        tiny = {"card": card, "config": BERT_TINY_PARAMS,
                "exit_code": job.exit_code, "model_step": job.owner.step,
                "metrics": metrics, "wall_s": wall_s,
                "examples_per_s": BERT_TINY_TRAIN * BERT_TINY_EPOCHS
                / wall_s,
                "phases": _phase_split(job), "launches": tiny_launches}
        print(json.dumps({"local_bert_tiny": tiny}), flush=True)
        if job.exit_code != 0 or job.owner.step != BERT_TINY_STEPS or \
                metrics.get("accuracy", 0.0) <= BERT_TINY_ACCURACY:
            raise AssertionError(f"the planted-pairs Local job: {tiny}")
        tiny["other_forwards"] = check_bert_launches(
            "local_bert_tiny", tiny_launches, BERT_TINY_STEPS,
            BERT_TINY_LAYERS, False, fa.CUDA_CORE, fa.CUDA_CORE,
            other_forwards=True)
        del job
        ev = api.run_local(cli.parse_args(bert_argv(
            "evaluate", BERT_TINY_PARAMS, BERT_TINY_BATCH,
            "--validation_data", val_dir,
            "--checkpoint_dir_for_init", ckpt)), "evaluate")
        evaluate = {"exit_code": ev.exit_code, "model_step": ev.owner.step,
                    "metrics": ev.metrics, "train_metrics": metrics}
        print(json.dumps({"local_bert_evaluate": evaluate}), flush=True)
        if ev.exit_code != 0 or ev.owner.step != BERT_TINY_STEPS or \
                ev.metrics != metrics:
            raise AssertionError(f"evaluate from the BERT checkpoint: "
                                 f"{evaluate}")
        del ev
        shutil.rmtree(ckpt)

        t0 = time.perf_counter()
        train_dir, val_dir = write_pairs(
            os.path.join(tmp, "full"), n_train=BERT_FULL_TRAIN,
            n_val=BERT_FULL_VAL, max_len=SEQ_LEN, vocab=VOCAB, seed=SEED)
        write_s = time.perf_counter() - t0
        ckpt = os.path.join(tmp, "ckpt_full")
        args = cli.parse_args(bert_argv(
            "train", BERT_PARAMS + ";bf16=True", TRAIN_BATCH,
            "--use_bf16", "true",
            "--training_data", train_dir, "--validation_data", val_dir,
            "--num_epochs", "1", "--checkpoint_dir", ckpt,
            "--checkpoint_steps", str(BERT_FULL_STEPS),
            "--keep_checkpoint_max", "1"))
        # ---- the main path: counts start at 0 here ----
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        job = api.run_local(args, "train")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        full_launches = bert_launches()
        # ---- end of the main path ----
        saver = job.owner.checkpoint_saver
        steps = saver.all_steps()
        full = {"card": card, "config": BERT_PARAMS + ";bf16=True",
                "records": BERT_FULL_TRAIN, "dataset_write_s": write_s,
                "exit_code": job.exit_code, "model_step": job.owner.step,
                "metrics": job.metrics, "wall_s": wall_s,
                "examples_per_s": BERT_FULL_TRAIN / wall_s,
                "phases": _phase_split(job), "launches": full_launches,
                "checkpoints": steps,
                "checkpoint_bytes": os.path.getsize(os.path.join(
                    ckpt, str(BERT_FULL_STEPS), "state.pt"))
                if steps else None,
                "eval_versions": sorted(
                    job.master.evaluation_service.history)}
        print(json.dumps({"local_bert_full": full}), flush=True)
        counters = job.master.task_manager.counters.as_dict()
        if job.exit_code != 0 or counters["failed"] != 0 or \
                job.owner.step != BERT_FULL_STEPS or \
                steps != [BERT_FULL_STEPS] or \
                not saver.verify_step(BERT_FULL_STEPS):
            raise AssertionError(f"the full-width BERT Local job: {full}")
        full["other_forwards"] = check_bert_launches(
            "local_bert_full", full_launches, BERT_FULL_STEPS, NUM_LAYERS,
            False, fa.SM90_WGMMA, fa.SM90_WGMMA, other_forwards=True)
        del job, saver
        return ({"tiny": tiny, "evaluate": evaluate, "full": full},
                {"local_bert_tiny": tiny_launches,
                 "local_bert_full": full_launches}, ckpt)
    finally:
        events.configure(None)


# ---- serve_cli: the `serve` command over a socket --------------------------

SERVE_CALL_TIMEOUT_S = 300.0
# the DeepFM server's --reload_poll_seconds: the hot swap lands within it
SERVE_POLL_S = 0.1
# served AUC vs the job's own eval AUC on the same 16,384 records
SERVE_AUC_TOL = 1e-4
# The newer step moves the output bias by SWAP_SHIFT, so every logit of
# it sits 1.0 from the older step's.  A response is held against its
# step's forward on the request alone within SERVE_STEP_TOL: the bf16
# MLP runs on the batch the request rode in, whose shape changes
# cuBLAS's tiling and so the bf16 roundings (a few 2^-8 steps of the
# hidden activations).
SWAP_SHIFT = 1.0
SERVE_STEP_TOL = 0.05
SWAP_CLIENT_MIN = 10          # requests each client sends around the swap
SWAP_DEADLINE_S = 120.0


def serve_argv(model_def: str, params: str, *extra) -> list:
    return ["serve", "--model_def", model_def, "--model_params", params,
            "--batch_buckets", ",".join(str(b) for b in BUCKETS),
            "--port", "0", *extra]


def start_server(args):
    """`build_serving_server` on parsed serve args, started on an
    ephemeral port; returns (server, a stub on 127.0.0.1)."""
    server = api.build_serving_server(args)
    port = server.start(args.port)
    return server, ServingStub(f"127.0.0.1:{port}",
                               timeout=SERVE_CALL_TIMEOUT_S)


def socket_traffic(stub, requests_by_client):
    """Each client thread sends its requests in turn through the stub;
    returns ([(client, index, rows, response, latency_s)], wall_s)."""
    results, lock, errors = [], threading.Lock(), []

    def client(c, reqs):
        try:
            for i, feats in enumerate(reqs):
                t0 = time.perf_counter()
                resp = stub.predict(make_predict_request(feats))
                lat = time.perf_counter() - t0
                with lock:
                    results.append((c, i, len(next(iter(feats.values()))),
                                    resp, lat))
        except BaseException as exc:   # re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(c, reqs))
               for c, reqs in enumerate(requests_by_client)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    if errors:
        raise errors[0]
    bad = [(rows, r.code, r.error) for _, _, rows, r, _ in results
           if r.code != spb.SERVING_OK]
    if bad:
        raise AssertionError(f"{len(bad)} responses not OK: {bad[:3]}")
    return results, wall_s


def latency_summary(results, wall_s: float) -> dict:
    lats = np.array([lat for *_, lat in results]) * 1e3
    rows = sum(r[2] for r in results)
    return {"requests": len(results), "rows": rows, "wall_s": wall_s,
            "requests_per_s": len(results) / wall_s,
            "rows_per_s": rows / wall_s,
            "p50_latency_ms": float(np.percentile(lats, 50)),
            "p99_latency_ms": float(np.percentile(lats, 99))}


def phase_ms(server) -> dict:
    """The server-side phases (p50 and mean ms): decode (wire tensors to
    arrays), respond (the response's encoding), and the batcher's."""
    out = {}
    for name in ("decode", "queue_wait", "compute", "unpack", "respond"):
        snap = server.batcher.metrics.phase.labels(phase=name).snapshot()
        out[name] = {"p50_ms": snap["p50_s"] * 1e3,
                     "mean_ms": snap["mean_s"] * 1e3,
                     "count": snap["count"]}
    return out


def served_auc(stub, features, labels, chunk: int = AUC_CHUNK) -> float:
    """AUC of the server's predictions for every record, sent in
    `chunk`-row requests from CLIENT_THREADS clients."""
    n = len(labels)
    chunks = [{k: v[i:i + chunk] for k, v in features.items()}
              for i in range(0, n, chunk)]
    by_client = [chunks[c::CLIENT_THREADS] for c in range(CLIENT_THREADS)]
    results, _ = socket_traffic(stub, by_client)
    preds = [None] * len(chunks)
    for c, i, _, resp, _ in results:
        preds[c + i * CLIENT_THREADS] = from_tensor_proto(resp.predictions)
    return float(auc(labels, np.concatenate(preds)))


def seeded_rows(n_requests: int, seed: int) -> list:
    """Seeded Criteo-format requests of 1-64 rows."""
    rng = np.random.RandomState(seed)
    out = []
    for i, rows in enumerate(rng.randint(1, BUCKETS[-1] + 1, n_requests)):
        dense, sparse, _ = synthetic_criteo(int(rows), seed=seed * 1000 + i)
        out.append({"dense": dense, "sparse": sparse})
    return out


def bf16_rounded(features: dict) -> dict:
    """The floating features as `--use_bf16 true` hands them to the model
    (Trainer._cast), kept in float32 for the wire."""
    return {k: (torch.from_numpy(v).to(torch.bfloat16).float().numpy()
                if v.dtype == np.float32 else v)
            for k, v in features.items()}


def read_validation(val_dir: str) -> dict:
    reader = TFRecordDataReader(val_dir)
    return fm_zoo.feed_bulk(*reader.read_records_bulk(pb.Task(
        shard=pb.Shard(name=os.path.join(val_dir, "criteo-val.tfrecord"),
                       start=0, end=LOCAL_VAL))))


def stage_corrupt_step(ckpt: str, good: int, bad: int) -> int:
    """Step `bad`: a copy of step `good` whose state.pt is cut in half,
    with the manifest of the whole file.  Built beside the directory and
    renamed in, so the reloader sees it whole or not at all.  Returns
    the cut file's bytes."""
    stage = os.path.join(os.path.dirname(ckpt), f"stage_{bad}")
    os.makedirs(stage)
    path = os.path.join(stage, "state.pt")
    shutil.copyfile(os.path.join(ckpt, str(good), "state.pt"), path)
    with open(os.path.join(ckpt, ".manifests", f"{good}.json")) as f:
        manifest = json.load(f)
    manifest["step"] = bad
    with open(os.path.join(ckpt, ".manifests", f"{bad}.json"), "w") as f:
        json.dump(manifest, f)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    os.rename(stage, os.path.join(ckpt, str(bad)))
    return os.path.getsize(os.path.join(ckpt, str(bad), "state.pt"))


def wait_until(predicate, timeout_s: float, what: str) -> float:
    t0 = time.perf_counter()
    while not predicate():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"timed out after {timeout_s} s: {what}")
        time.sleep(0.01)
    return time.perf_counter() - t0


def serve_cli_deepfm(card: str, served: dict) -> dict:
    """`serve` on the Local DeepFM job's files at the north-star width,
    over a socket: mixed traffic, the validation AUC, a hot swap under
    traffic, a corrupt step, the export, the int8 checkpoint and the
    fp32 checkpoint converted into the int8 config."""
    ckpt = served["ckpt"]
    val = read_validation(served["val_dir"])
    labels = val["labels"]
    feature_spec = json.dumps(feature_meta(val["features"]))
    rounded = bf16_rounded(val["features"])
    out = {"card": card}

    args = cli.parse_args(serve_argv(
        DEEPFM, DEEPFM_PARAMS, "--checkpoint_dir", ckpt,
        "--feature_spec", feature_spec,
        "--reload_poll_seconds", str(SERVE_POLL_S)))
    # ---- the main path: counts start at 0 here ----
    reset_counts()
    server, stub = start_server(args)
    engine, reloader = server.engine, server.reloader
    device = engine.device
    try:
        if engine.step != LOCAL_STEPS:
            raise AssertionError(f"serving step {engine.step}, want "
                                 f"{LOCAL_STEPS}")
        mixed, wall = socket_traffic(stub, [
            seeded_rows(REQUESTS_PER_CLIENT, SEED + 10 + c)
            for c in range(CLIENT_THREADS)])
        out["mixed_traffic"] = latency_summary(mixed, wall)
        out["auc"] = served_auc(stub, rounded, labels)
        out["auc_f32_dense"] = served_auc(stub, val["features"], labels)
        out["job_auc"] = served["auc"]
        print(json.dumps({"serve_cli_deepfm_auc": {
            k: out[k] for k in ("auc", "auc_f32_dense", "job_auc")}}),
            flush=True)
        if abs(out["auc"] - served["auc"]) > SERVE_AUC_TOL:
            raise AssertionError(f"served AUC {out['auc']} vs the job's "
                                 f"{served['auc']}")

        # the newer step: the served one with its output bias moved,
        # built on the host so the device holds only what serving holds
        spec = get_model_spec(ZOO_DIR, DEEPFM, DEEPFM_PARAMS)
        saver = CheckpointSaver(ckpt, keep_max=0)
        newer = saver.restore_step(
            LOCAL_STEPS, build_state_template(spec, None, "cpu"))
        with torch.no_grad():
            newer.model.mlp_out.bias += SWAP_SHIFT
        newer.step = LOCAL_STEPS + 1
        old_vars = engine.variables
        new_vars = {k: v.to(device) for k, v in
                    newer.model.state_dict().items()}
        swap_results, lock = [], threading.Lock()
        saw_new = threading.Event()
        errors = []

        def client(c):
            try:
                reqs = seeded_rows(1000, SEED + 100 + c)
                deadline = time.perf_counter() + SWAP_DEADLINE_S
                for i, feats in enumerate(reqs):
                    resp = stub.predict(make_predict_request(feats))
                    with lock:
                        swap_results.append((feats, resp))
                    if resp.model_step == LOCAL_STEPS + 1:
                        saw_new.set()
                    if i + 1 >= SWAP_CLIENT_MIN and (
                            saw_new.is_set()
                            or time.perf_counter() > deadline):
                        return
            except BaseException as exc:   # re-raised below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(CLIENT_THREADS)]
        for t in threads:
            t.start()
        wait_until(lambda: len(swap_results) >= CLIENT_THREADS, 60,
                   "traffic before the swap")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before_bytes = torch.cuda.memory_allocated()
        t_save = time.perf_counter()
        saver.save(newer)
        saver.wait_until_finished()
        write_s = time.perf_counter() - t_save
        wait_until(lambda: engine.step == LOCAL_STEPS + 1, 60,
                   "the hot swap")
        landed_s = time.perf_counter() - t_save
        peak_bytes = torch.cuda.max_memory_allocated()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        steps = sorted({r.model_step for _, r in swap_results})
        codes = {int(r.code) for _, r in swap_results}
        refs = {LOCAL_STEPS: old_vars, LOCAL_STEPS + 1: new_vars}
        ref_engines = {
            step: ServingEngine(spec.model, v, step,
                                feature_meta(val["features"]),
                                buckets=BUCKETS, precompile=False,
                                device=device)
            for step, v in refs.items()}
        worst, nearest_other = 0.0, float("inf")
        for feats, resp in swap_results:
            got = from_tensor_proto(resp.predictions)
            rows = len(got)
            own, _ = ref_engines[resp.model_step].predict(feats, rows)
            other_step = (LOCAL_STEPS if resp.model_step != LOCAL_STEPS
                          else LOCAL_STEPS + 1)
            other, _ = ref_engines[other_step].predict(feats, rows)
            worst = max(worst, float(np.abs(got - own).max()))
            nearest_other = min(nearest_other,
                                float(np.abs(got - other).min()))
        out["hot_swap"] = {
            "requests": len(swap_results), "steps_seen": steps,
            "codes": sorted(codes), "reload_count": reloader.reload_count,
            "reload_rejected": reloader.rejected_count,
            "reload_s": reloader.last_reload_s,
            "checkpoint_write_s": write_s,
            "save_start_to_swap_s": landed_s,
            "device_bytes_before": before_bytes,
            "device_peak_bytes_two_generations": peak_bytes,
            "checkpoint_bytes": os.path.getsize(os.path.join(
                ckpt, str(LOCAL_STEPS + 1), "state.pt")),
            "max_abs_err_vs_own_step": worst, "tol": SERVE_STEP_TOL,
            "min_abs_diff_vs_other_step": nearest_other}
        print(json.dumps({"serve_cli_deepfm_hot_swap": out["hot_swap"]}),
              flush=True)
        if (codes != {int(spb.SERVING_OK)}
                or steps != [LOCAL_STEPS, LOCAL_STEPS + 1]
                or reloader.reload_count != 1 or worst > SERVE_STEP_TOL
                or nearest_other < SWAP_SHIFT / 2):
            raise AssertionError(f"hot swap: {out['hot_swap']}")
        del ref_engines, refs, old_vars, new_vars, newer

        cut_bytes = stage_corrupt_step(ckpt, LOCAL_STEPS + 1,
                                       LOCAL_STEPS + 2)
        wait_until(lambda: reloader.rejected_count == 1, 60,
                   "the corrupt step's rejection")
        resp = stub.predict(make_predict_request(seeded_rows(1, SEED)[0]))
        health = stub.health(spb.HealthRequest())
        hm = {m.name: m.value for m in health.metrics}
        out["corrupt_step"] = {
            "step": LOCAL_STEPS + 2, "cut_bytes": cut_bytes,
            "reload_rejected": reloader.rejected_count,
            "last_error": reloader.last_error,
            "served_step": engine.step, "response_step": resp.model_step,
            "health": {k: hm[k] for k in ("reload_count",
                                          "reload_rejected",
                                          "swap_count")}}
        print(json.dumps({"serve_cli_deepfm_corrupt": out["corrupt_step"]}),
              flush=True)
        if (engine.step != LOCAL_STEPS + 1 or resp.code != spb.SERVING_OK
                or resp.model_step != LOCAL_STEPS + 1
                or hm["reload_count"] != 1 or hm["reload_rejected"] != 1):
            raise AssertionError(f"corrupt step: {out['corrupt_step']}")
        out["server_phases"] = phase_ms(server)
        saver.close()
    finally:
        stub.close()
        server.stop()
    out["launches"] = bert_launches()
    # ---- end of the main path ----
    if out["launches"]["scatter_add"] or \
            out["launches"]["flash_attention_fwd"]:
        raise AssertionError(f"DeepFM serving launched {out['launches']}")

    # the export of the same job, served; its engine against a
    # checkpoint-backed one of the same step, bucket by bucket
    export_server, export_stub = start_server(cli.parse_args(serve_argv(
        DEEPFM, DEEPFM_PARAMS, "--export_dir", served["export"])))
    try:
        resp = export_stub.predict(make_predict_request(
            seeded_rows(1, SEED + 7)[0]))
        by_ckpt = ServingEngine.from_checkpoint(
            ckpt, get_model_spec(ZOO_DIR, DEEPFM, DEEPFM_PARAMS),
            {k: v[:1] for k, v in val["features"].items()},
            buckets=BUCKETS, step=LOCAL_STEPS, device=device)
        equal = {}
        for b in BUCKETS:
            x = {k: v[:b] for k, v in val["features"].items()}
            a, _ = export_server.engine.predict(x, b)
            c, _ = by_ckpt.predict(x, b)
            equal[str(b)] = bool(np.array_equal(a, c))
        out["export"] = {"step": export_server.engine.step,
                         "response_code": int(resp.code),
                         "response_step": resp.model_step,
                         "bitwise_equal_by_bucket": equal}
        print(json.dumps({"serve_cli_deepfm_export": out["export"]}),
              flush=True)
        if (resp.code != spb.SERVING_OK or resp.model_step != LOCAL_STEPS
                or not all(equal.values())):
            raise AssertionError(f"export vs checkpoint: {out['export']}")
        del by_ckpt
    finally:
        export_stub.close()
        export_server.stop()

    # int8: the int8 job's checkpoint through --arena_dtype int8
    int8_server, int8_stub = start_server(cli.parse_args(serve_argv(
        DEEPFM, DEEPFM_PARAMS, "--arena_dtype", "int8",
        "--checkpoint_dir", served["ckpt8"], "--feature_spec",
        feature_spec)))
    try:
        q8 = int8_server.engine.variables["fm_embedding.q8"]
        out["int8"] = {"auc": served_auc(int8_stub, rounded, labels),
                       "job_auc": served["auc_int8"],
                       "q8_dtype": str(q8.dtype)}
    finally:
        int8_stub.close()
        int8_server.stop()
    # the fp32 checkpoint converted into the int8 config on restore
    spec8 = get_model_spec(ZOO_DIR, DEEPFM, DEEPFM_PARAMS,
                           arena_dtype="int8")
    sample = {k: v[:1] for k, v in val["features"].items()}
    try:
        ServingEngine.from_checkpoint(ckpt, spec8, sample, buckets=BUCKETS,
                                      step=LOCAL_STEPS, device=device)
        raise AssertionError("an fp32 checkpoint served into the int8 "
                             "config without arena_convert")
    except ArenaDtypeMismatch as exc:
        out["int8"]["without_arena_convert"] = str(exc)
    converted = ServingEngine.from_checkpoint(
        ckpt, spec8, sample, buckets=BUCKETS, step=LOCAL_STEPS,
        arena_convert=True, device=device)
    saver = CheckpointSaver(ckpt, keep_max=0)
    own = saver.restore_step(LOCAL_STEPS, build_state_template(
        spec8, None, device), arena_convert=True)
    saver.close()
    own.model.eval()
    x = {k: v[:BUCKETS[-1]] for k, v in rounded.items()}
    got, _ = converted.predict(x, BUCKETS[-1])
    with torch.no_grad():
        want = own.model({k: torch.from_numpy(v).to(device)
                          for k, v in x.items()}).float().cpu().numpy()
    preds = np.concatenate([
        converted.predict({k: v[i:i + BUCKETS[-1]]
                           for k, v in rounded.items()},
                          min(BUCKETS[-1], LOCAL_VAL - i))[0]
        for i in range(0, LOCAL_VAL, BUCKETS[-1])])
    out["int8"]["arena_convert"] = {
        "bitwise_equal_to_own_forward": bool(np.array_equal(got, want)),
        "auc": float(auc(labels, preds)), "fp32_job_auc": served["auc"],
        "q8_dtype": str(converted.variables["fm_embedding.q8"].dtype)}
    print(json.dumps({"serve_cli_deepfm_int8": out["int8"]}), flush=True)
    if (abs(out["int8"]["auc"] - served["auc_int8"]) > SERVE_AUC_TOL
            or out["int8"]["q8_dtype"] != "torch.int8"
            or not out["int8"]["arena_convert"][
                "bitwise_equal_to_own_forward"]
            or not AUC_BAND[0] <= out["int8"]["arena_convert"]["auc"]
            <= AUC_BAND[1]):
        raise AssertionError(f"int8 serving: {out['int8']}")
    print(json.dumps({"serve_cli_deepfm": out}), flush=True)
    return out


def serve_cli_bert(card: str, bert_ckpt: str, in_process: dict):
    """`serve --checkpoint_dir` on the full-width BERT Local job's
    checkpoint, over a socket: serve_bert's traffic (the same seeded
    requests), its flash-forward launches and its latency beside
    serve_bert's in-process figures.  Returns (summary, launches)."""
    requests = bert_requests(np.random.RandomState(SEED))
    args = cli.parse_args(serve_argv(
        BERT, BERT_PARAMS + ";bf16=True", "--checkpoint_dir", bert_ckpt,
        "--feature_spec", json.dumps(
            {"input_ids": {"shape": [SEQ_LEN], "dtype": "int32"}})))
    # ---- the main path: counts start at 0 here ----
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server, stub = start_server(args)
    start_s = time.perf_counter() - t0
    try:
        results, wall = socket_traffic(stub, requests)
        snap = server.batcher.metrics.snapshot()
        phases = phase_ms(server)
        step = server.engine.step
        compiles = server.engine.compile_count
    finally:
        stub.close()
        server.stop()
    torch.cuda.synchronize()
    launches = bert_launches()
    # ---- end of the main path ----
    batches = int(snap["batches"])
    for _, _, rows, resp, _ in results:
        preds = from_tensor_proto(resp.predictions)
        if preds.shape != (rows, 2) or not np.isfinite(preds).all():
            raise AssertionError(f"bad BERT predictions for {rows} rows: "
                                 f"{preds.shape}")
    expected = NUM_LAYERS * (len(BUCKETS) + batches)
    by_variant = launches["flash_attention_fwd_by_variant"]
    summary = {"card": card, "checkpoint_step": step,
               "checkpoint_bytes": os.path.getsize(os.path.join(
                   bert_ckpt, str(step), "state.pt")),
               "build_and_start_s": start_s, "batches": batches,
               "batch_fill_ratio": snap["batch_fill_ratio"],
               "socket": latency_summary(results, wall),
               "in_process": {
                   "requests_per_s": in_process["requests_per_s"],
                   "p50_latency_ms_by_bucket":
                       in_process["p50_latency_ms_by_bucket"]},
               "server_phases": phases, "launches": launches,
               "expected_flash_launches": expected}
    print(json.dumps({"serve_cli_bert": summary}), flush=True)
    if (launches["flash_attention_fwd"] != expected
            or by_variant.get(fa.SM90_WGMMA) != expected
            or launches["scatter_add"] != 0 or step != BERT_FULL_STEPS
            or compiles != len(BUCKETS)):
        raise AssertionError(
            f"serve_cli_bert: flash launched {launches}; every bf16 layer "
            f"must run {fa.SM90_WGMMA}: {NUM_LAYERS} layers x "
            f"({len(BUCKETS)} warm-up + {batches} batches) = {expected}")
    return summary, launches


# ---- the tiered embedding store ------------------------------------------

TIERED = "deepfm.deepfm_tiered.custom_model"
TIERED_PLANES = {"fm_embedding": DEEPFM_DIM, "fm_linear": 1}
# (a) parity: flat at vocab 2^20 against a 2^16-row cache on an all-hot,
# collision-free working set (26 x 2,000 rows), batch 4096
PARITY_CACHE = 1 << 16
PARITY_IDS = 2000
PARITY_BATCH = AUC_BATCH
PARITY_STEPS = 8
PARITY_K = 8
# the reference's few-ulp bound on a separately run predict
PRED_ULP_TOL = 4 * float(np.finfo(np.float32).eps)
# (b) real size: a 2^20-row cache per plane, batch 16384 of a zipf(1.2)
# stream over 2^22 ids per field, until the vocabulary passes twice the
# cache
REAL_CACHE = 1 << 20
REAL_BATCH = TIMED_BATCH
REAL_IDS = 1 << 22
REAL_ZIPF = 1.2
REAL_MAX_STEPS = 96
REAL_AFTER = 2           # steps run after the vocabulary passes 2x
# the int8 cache replays the stream's first steps only (the phase's
# time is the host's planning, ~0.6 s a step on the card's machine): the
# first evictions come at about step 22
REAL_INT8_STEPS = 24
# the Local jobs: a cache below the 25,913 rows the synthetic records
# grow and above the 17,446 of the largest K = 4 block's union
LOCAL_CACHE = 20480
TIERED_PARAMS = (f"embed_dim={DEEPFM_DIM};bf16=True;lr=0.005;"
                 f"cache_rows={LOCAL_CACHE}")
SERVE_TOL = 1e-4         # tests/test_torch_serving.py's TOL
TIERED_REQUESTS = 40     # per client, around the swap


def tiered_params(cache_rows: int, cache_dtype: str = "float32") -> str:
    return (f"embed_dim={DEEPFM_DIM};bf16=True;lr=0.005;"
            f"cache_rows={cache_rows};cache_dtype='{cache_dtype}'")


def collision_free_ids(cap: int, per_field: int, seed: int) -> np.ndarray:
    """(26, per_field) raw ids whose flat rows (vocab `cap`) never
    collide, across fields too."""
    rng = np.random.RandomState(seed)
    cand = rng.randint(0, 1 << 22, size=(NUM_SPARSE, per_field * 4))
    rows = tiered_zoo.flat_rows_host(
        np.repeat(np.arange(NUM_SPARSE)[:, None], cand.shape[1], 1), cand,
        cap).reshape(-1)
    _, first = np.unique(rows, return_index=True)
    keep = np.zeros(rows.size, bool)
    keep[first] = True
    keep = keep.reshape(cand.shape)
    sel = np.stack([cand[f][keep[f]][:per_field] for f in range(NUM_SPARSE)])
    if sel.shape != (NUM_SPARSE, per_field):
        raise AssertionError("not enough collision-free candidates")
    return sel.astype(np.int32)


def parity_batch(sel: np.ndarray, step: int, batch: int, seed0: int):
    rng = np.random.RandomState(seed0 + step)
    pick = rng.randint(0, sel.shape[1], (batch, NUM_SPARSE))
    return {"features": {
        "dense": rng.exponential(1.0, (batch, 13)).astype(np.float32),
        "sparse": sel[np.arange(NUM_SPARSE)[None, :], pick]},
        "labels": rng.randint(0, 2, batch).astype(np.int32)}


def flat_and_tiered(sel, cache_dtype="float32", deferred=False):
    """The bare flat and tiered Trainers at full width from one init: the
    tiered dense layers filled from the flat state, the host tier
    backfilled from the flat tables."""
    device = torch.device("cuda", 0)
    flat_spec = get_model_spec(ZOO_DIR, DEEPFM, DEEPFM_PARAMS
                               + f";arena_dtype='{cache_dtype}'")
    tier_spec = get_model_spec(ZOO_DIR, TIERED,
                               tiered_params(PARITY_CACHE, cache_dtype))
    flat_tr = Trainer(flat_spec.model, flat_spec.optimizer, flat_spec.loss,
                      use_bf16=True, device=device)
    tier_tr = Trainer(tier_spec.model, tier_spec.optimizer, tier_spec.loss,
                      use_bf16=True, device=device)
    b0 = parity_batch(sel, 0, PARITY_BATCH, 100)
    flat = flat_tr.init_state(SEED, b0["features"])
    tier = tier_tr.init_state(SEED + 1, {
        "dense": b0["features"]["dense"],
        "slots": np.zeros((PARITY_BATCH, NUM_SPARSE), np.int32)})
    flat_sd = flat.model.state_dict()
    tier.model.load_state_dict(store_ckpt.fill_matching(
        tier.model.state_dict(), flat_sd))
    init = {}
    for name in TIERED_PLANES:
        if cache_dtype == "int8":
            init[name] = dequantize_rows(flat_sd[f"{name}.q8"],
                                         flat_sd[f"{name}.scale"]).cpu()
        else:
            init[name] = flat_sd[f"{name}.embedding"]
        # an owning copy: the flat table trains on in place
        init[name] = init[name].detach().to("cpu", copy=True).numpy()
    store = tiered_zoo.TieredStore(TIERED_PLANES, NUM_SPARSE, PARITY_CACHE,
                                   cache_dtype=cache_dtype)
    store.host.set_backfill(store_ckpt.flat_backfill(
        init, lambda f, i: tiered_zoo.flat_rows_host(f, i, DEEPFM_VOCAB)))
    if deferred:
        store.enable_deferred_prepare()
    tier_tr.tiered_store = store
    return flat_tr, flat, tier_tr, tier, store


def trained_rows_equal(flat, tier, store, sel) -> dict:
    """Each plane's trained rows, flat table at the hashed rows against
    the cache at the store's slots, bit for bit."""
    fields = np.repeat(np.arange(NUM_SPARSE)[:, None], sel.shape[1], 1)
    rows = store.host.lookup(sel.T)       # (per_field, 26) store rows
    slots = np.vectorize(store.cache.slot_of)(rows)
    flat_rows = tiered_zoo.flat_rows_host(fields.T, sel.T, DEEPFM_VOCAB)
    out = {}
    for name in TIERED_PLANES:
        f = flat.params[f"{name}.embedding"].detach()
        t = tier.params[f"{name}.embedding"].detach()
        if (slots < 0).any():
            out[name] = False
            continue
        out[name] = bool(torch.equal(
            f[torch.from_numpy(flat_rows.reshape(-1)).long().cuda()],
            t[torch.from_numpy(slots.reshape(-1)).long().cuda()]))
    return out


def tiered_parity() -> tuple:
    """(a): flat vs tiered at full width, 8 steps, then a K = 8 block
    against the flat 8-step stack, bit for bit; then int8, reported.
    Returns (summary, tiered steps, scatter launches over them)."""
    sel = collision_free_ids(DEEPFM_VOCAB, PARITY_IDS, seed=SEED)
    batches = [parity_batch(sel, s, PARITY_BATCH, 100)
               for s in range(PARITY_STEPS)]

    def attached(store, b):
        return store.attach({"features": dict(b["features"]),
                             "labels": b["labels"]})

    flat_tr, flat, tier_tr, tier, store = flat_and_tiered(sel)
    flat_losses, tier_losses = [], []
    tier_launches = 0
    for b in batches:
        flat, fl = flat_tr.train_on_batch(flat, b)
        before = sa.scatter_add.launches
        tier, tl = tier_tr.train_on_batch(tier, attached(store, b))
        torch.cuda.synchronize()
        tier_launches += sa.scatter_add.launches - before
        flat_losses.append(fl)
        tier_losses.append(tl)
    losses_equal = bool(torch.equal(torch.stack(flat_losses),
                                    torch.stack(tier_losses)))
    rows_equal = trained_rows_equal(flat, tier, store, sel)
    probe = parity_batch(sel, 10_000, PARITY_BATCH, 100)
    slots, _ = store.prepare(probe["features"]["sparse"])
    flat_pred = flat_tr.predict_on_batch(flat, probe["features"])
    tier_pred = tier_tr.predict_on_batch(
        tier, {"dense": probe["features"]["dense"], "slots": slots})
    pred_err = float(np.abs(flat_pred - tier_pred).max())
    stats = store.stats()
    del flat, tier

    flat_tr, flat, tier_tr, tier, store = flat_and_tiered(sel,
                                                          deferred=True)
    flat, flat_stack = flat_tr.train_on_batch_stack(flat, batches)
    before = sa.scatter_add.launches
    tier, tier_stack = tier_tr.train_on_batch_stack(
        tier, [attached(store, b) for b in batches])
    torch.cuda.synchronize()
    tier_launches += sa.scatter_add.launches - before
    block_equal = bool(torch.equal(flat_stack, tier_stack))
    block_rows_equal = trained_rows_equal(flat, tier, store, sel)
    block_plans = store.stats()["block_plans"]
    del flat, tier

    flat_tr, flat, tier_tr, tier, store = flat_and_tiered(sel, "int8")
    gaps = []
    for b in batches:
        flat, fl = flat_tr.train_on_batch(flat, b)
        before = sa.scatter_add.launches
        tier, tl = tier_tr.train_on_batch(tier, attached(store, b))
        torch.cuda.synchronize()
        tier_launches += sa.scatter_add.launches - before
        gaps.append(abs(float(fl) - float(tl)))
    int8_carrier_zero = not bool(
        tier.model.fm_embedding.embedding.detach().any())
    del flat, tier
    tier_steps = 2 * PARITY_STEPS + PARITY_K
    summary = {
        "flat": DEEPFM_PARAMS, "tiered": tiered_params(PARITY_CACHE),
        "batch": PARITY_BATCH, "steps": PARITY_STEPS,
        "working_set_rows": NUM_SPARSE * PARITY_IDS,
        "losses_bitwise_equal": losses_equal,
        "trained_rows_bitwise_equal": rows_equal,
        "pred_max_abs_err": pred_err, "pred_tol": PRED_ULP_TOL,
        "stats": stats,
        "block_k": PARITY_K, "block_losses_bitwise_equal": block_equal,
        "block_trained_rows_bitwise_equal": block_rows_equal,
        "block_plans": block_plans,
        "int8_loss_gaps": gaps, "int8_carrier_zero": int8_carrier_zero,
        "losses_first_last": [float(flat_losses[0]),
                              float(flat_losses[-1])],
    }
    print(json.dumps({"tiered_parity": summary}), flush=True)
    if not (losses_equal and all(rows_equal.values()) and block_equal
            and all(block_rows_equal.values()) and pred_err <= PRED_ULP_TOL
            and stats["misses"] and block_plans == 1
            and stats["cache_occupancy_rows"] == NUM_SPARSE * PARITY_IDS
            and np.isfinite(gaps).all() and int8_carrier_zero):
        raise AssertionError(f"tiered vs flat parity: {summary}")
    return summary, tier_steps, tier_launches


def zipf_stream(seed: int):
    """Endless seeded batches of REAL_BATCH rows: zipf(1.2) ranks capped
    at 2^22, mapped per field by an odd multiplier and a field offset mod
    2^22 (a bijection, so hot ids differ across fields)."""
    batch = REAL_BATCH
    rng = np.random.default_rng(seed)
    mask = REAL_IDS - 1
    offset = np.arange(NUM_SPARSE, dtype=np.int64) * 0x61C88647
    while True:
        ranks = np.minimum(rng.zipf(REAL_ZIPF, size=(batch, NUM_SPARSE)),
                           REAL_IDS) - 1
        yield {"features": {
            "dense": rng.exponential(1.0, (batch, 13)).astype(np.float32),
            "sparse": ((ranks * 0x9E3779B1 + offset) & mask).astype(
                np.int64)},
            "labels": rng.integers(0, 2, batch).astype(np.int32)}


class SeamTimer:
    """Host ms of each store device call of a step (`read_rows`: the
    eviction read with its blocking host copy; `apply_admissions`: the
    admit, synchronized so its device time is inside) and their device
    ms (CUDA events), through wrappers on the store's device module."""

    def __init__(self):
        self._orig = (store_device.read_rows,
                      store_device.apply_admissions)
        self.reset()

    def reset(self):
        self.calls = {"read": [0.0, 0.0, 0], "admit": [0.0, 0.0, 0]}

    def _wrap(self, key, fn):
        def timed(state, paths, slots, *args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = fn(state, paths, slots, *args, **kwargs)
            end.record()
            end.synchronize()
            rec = self.calls[key]
            rec[0] += (time.perf_counter() - t0) * 1e3
            rec[1] += start.elapsed_time(end)
            rec[2] += int(np.asarray(slots).size)
            return out
        return timed

    def __enter__(self):
        store_device.read_rows = self._wrap("read", self._orig[0])
        store_device.apply_admissions = self._wrap("admit", self._orig[1])
        return self

    def __exit__(self, *exc):
        store_device.read_rows, store_device.apply_admissions = self._orig


def attached(store, stream, runner: list):
    """The stream's batches attached to the store (eager planning, in
    order), each with its prepare ms: the host iterator that the port's
    `prefetch_batches` runs on its thread (recorded in `runner`)."""
    runner.append(threading.current_thread())
    for batch in stream:
        t0 = time.perf_counter()
        yield store.attach(batch), (time.perf_counter() - t0) * 1e3


def stop_prefetch(feed, runner: list) -> None:
    """Close a `prefetch_batches` generator and wait for its producer
    thread, so no attach runs on after the store stops."""
    feed.close()
    for thread in runner:
        thread.join(timeout=60)
        if thread.is_alive():
            raise RuntimeError("the prefetch thread did not stop")


def real_size_run(cache_dtype: str, card: str, max_steps: int = 0) -> dict:
    """(b): the bare Trainer over a 2^20-row cache, threads started,
    eager planning on a prefetch thread, until the vocabulary passes
    twice the cache (and REAL_AFTER steps more), or for `max_steps`.
    Per step: the plan's counts, prepare ms (producer), the seam's read
    and admit ms, step ms (CUDA events) and the scatter launches; one
    profiled step."""
    device = torch.device("cuda", 0)
    spec = get_model_spec(ZOO_DIR, TIERED,
                          tiered_params(REAL_CACHE, cache_dtype))
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, use_bf16=True,
                      device=device)
    store = tiered_zoo.build_tiered_store()
    if store.cache_rows != REAL_CACHE or store.cache_dtype != cache_dtype:
        raise AssertionError(f"store {store.stats()}")
    trainer.tiered_store = store
    store.start()
    runner = []
    feed = prefetch_batches(attached(store, zipf_stream(SEED + 7),
                                     runner))
    steps, after, state = [], None, None
    timer = SeamTimer()
    try:
        with timer:
            while True:
                batch, prepare_ms = next(feed)
                plan = batch["__store_plan__"]
                if state is None:
                    state = trainer.init_state(SEED, batch["features"])
                timer.reset()
                launches = sa.scatter_add.launches
                gather_async = store.gather_async_s
                gather_sync = store.gather_sync_s
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                state, loss = trainer.train_on_batch(state, batch)
                end.record()
                end.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                host = store.host.size
                rec = {
                    "step": len(steps) + 1, "hits": plan.hits,
                    "misses": plan.misses,
                    "hit_rate": plan.hits / max(plan.hits + plan.misses, 1),
                    "admissions": int(plan.admit_rows.size),
                    "evictions": int(plan.evict_rows.size),
                    "vocab_rows": host,
                    "host_bytes": store.host.nbytes,
                    "prepare_ms": prepare_ms,
                    "read_ms": timer.calls["read"][0],
                    "read_device_ms": timer.calls["read"][1],
                    "admit_ms": timer.calls["admit"][0],
                    "admit_device_ms": timer.calls["admit"][1],
                    "cold_gather_async_s": store.gather_async_s
                    - gather_async,
                    "cold_gather_sync_s": store.gather_sync_s - gather_sync,
                    "step_ms": start.elapsed_time(end), "wall_ms": wall_ms,
                    "scatter_launches": sa.scatter_add.launches - launches,
                    "loss": float(loss)}
                steps.append(rec)
                print(json.dumps({f"tiered_real_{cache_dtype}_step": {
                    k: round(v, 3) if isinstance(v, float) else v
                    for k, v in rec.items()}}), flush=True)
                if rec["scatter_launches"] != 2:
                    raise AssertionError(f"a tiered step launched "
                                         f"{rec['scatter_launches']} "
                                         "scatter-adds, not 2")
                if after is None and host >= 2 * REAL_CACHE:
                    after = len(steps)
                if len(steps) == max_steps or len(steps) >= REAL_MAX_STEPS \
                        or (not max_steps and after is not None
                            and len(steps) >= after + REAL_AFTER):
                    break
            # one more step, profiled (its batch was planned ahead)
            batch, _ = next(feed)
            breakdown = step_breakdown(trainer, state, batch)
    finally:
        stop_prefetch(feed, runner)
        store.stop()
    stats = store.stats()
    evicting = [s for s in steps if s["evictions"]]
    summary = {
        "card": card, "config": tiered_params(REAL_CACHE, cache_dtype),
        "batch": REAL_BATCH, "lookups_per_step": REAL_BATCH * NUM_SPARSE,
        "zipf": REAL_ZIPF, "ids_per_field": REAL_IDS,
        "steps": len(steps), "stats": stats,
        "device_cache_bytes": stats["device_cache_bytes"],
        "steps_with_evictions": len(evicting),
        "mean": {k: float(np.mean([s[k] for s in steps[1:]]))
                 for k in ("prepare_ms", "read_ms", "read_device_ms",
                           "admit_ms", "admit_device_ms", "step_ms",
                           "wall_ms", "hit_rate", "admissions",
                           "evictions")},
        "mean_evicting": {k: float(np.mean([s[k] for s in evicting]))
                          for k in ("prepare_ms", "read_ms",
                                    "read_device_ms", "admit_ms",
                                    "admit_device_ms", "step_ms",
                                    "hit_rate", "admissions", "evictions")}
        if evicting else None,
        "admitted_rows_per_step": float(np.mean(
            [s["admissions"] for s in steps])),
        "step_breakdown": breakdown,
        "losses": [s["loss"] for s in steps],
    }
    print(json.dumps({f"tiered_real_{cache_dtype}": {
        k: v for k, v in summary.items() if k != "losses"}}), flush=True)
    if not max_steps and (after is None or not evicting) or \
            not np.isfinite(summary["losses"]).all():
        raise AssertionError(
            f"the real-size run ({cache_dtype}) never passed "
            f"{2 * REAL_CACHE} rows with evictions: {stats}")
    return summary


def tiered_deepfm(card: str):
    """The tiered store on the bare Trainer: (a) parity, (b) real size
    (fp32, then int8 on the stream's first REAL_INT8_STEPS steps).
    Returns (summary, scatter-add launches of the tiered steps)."""
    # ---- the main path: counts start at 0 here ----
    # (the flat Trainer's steps that parity holds the tiered ones
    # against launch too; only the tiered steps' launches are counted)
    fa.reset_launch_counts()
    sa.scatter_add.launches = 0
    parity, parity_steps, parity_launches = tiered_parity()
    sa.scatter_add.launches = 0
    real = real_size_run("float32", card)
    real8 = real_size_run("int8", card, REAL_INT8_STEPS)
    torch.cuda.synchronize()
    launches = parity_launches + sa.scatter_add.launches
    # ---- end of the main path ----
    # each real-size run adds its profiled step
    steps = parity_steps + real["steps"] + real8["steps"] + 2
    n = min(real["steps"], real8["steps"])
    gap = [abs(a - b) for a, b in zip(real["losses"][:n],
                                      real8["losses"][:n])]
    summary = {"parity": parity, "real": real, "real_int8": real8,
               "int8_loss_gap_mean": float(np.mean(gap)),
               "int8_loss_gap_max": float(np.max(gap)),
               "int8_step_ms_mean": real8["mean"]["step_ms"],
               "int8_device_cache_bytes": real8["device_cache_bytes"],
               "fp32_device_cache_bytes": real["device_cache_bytes"],
               "scatter_launches": launches, "tiered_steps": steps}
    print(json.dumps({"tiered_deepfm": {
        k: summary[k] for k in summary if k not in (
            "parity", "real", "real_int8")}}), flush=True)
    if launches != 2 * steps or parity_launches != 2 * parity_steps or \
            fa.flash_attention.launches != 0:
        raise AssertionError(
            f"tiered_deepfm launched {launches} scatter-adds in {steps} "
            f"steps (parity {parity_launches} in {parity_steps}); 2 "
            "planes per step")
    return summary, launches


def tiered_argv(ckpt: str, train_dir: str, *extra) -> list:
    return ["train", "--distribution_strategy", "Local",
            "--model_def", TIERED, "--model_params", TIERED_PARAMS,
            "--use_bf16", "true", "--minibatch_size", str(AUC_BATCH),
            "--records_per_task", str(LOCAL_RECORDS_PER_TASK),
            "--num_epochs", "1", "--training_data", train_dir,
            "--checkpoint_dir", ckpt,
            "--checkpoint_steps", str(LOCAL_CKPT_STEPS),
            "--keep_checkpoint_max", str(LOCAL_KEEP), *extra]


def tiered_job(label: str, card: str, ckpt: str, train_dir: str, *extra):
    """One Local tiered train job; its checks; returns (summary, job,
    launches)."""
    args = cli.parse_args(tiered_argv(ckpt, train_dir, *extra))
    # ---- the main path: counts start at 0 here ----
    fa.reset_launch_counts()
    sa.scatter_add.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    job = api.run_local(args, "train")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sa.scatter_add.launches
    # ---- end of the main path ----
    store = tiered_zoo._LAST_STORE
    stats = store.stats()
    steps = job.owner.checkpoint_saver.all_steps()
    sidecars = sorted(int(n) for n in os.listdir(
        os.path.join(ckpt, store_ckpt.SIDECAR_ROOT)))
    counters = job.master.task_manager.counters.as_dict()
    want_steps = list(range(LOCAL_STEPS - (LOCAL_KEEP - 1) *
                            LOCAL_CKPT_STEPS, LOCAL_STEPS + 1,
                            LOCAL_CKPT_STEPS))
    summary = {"card": card, "flags": list(extra), "wall_s": wall,
               "examples_per_s": LOCAL_TRAIN / wall,
               "exit_code": job.exit_code, "model_step": job.owner.step,
               "counters": counters, "stats": stats,
               "deferred": store.deferred_prepare,
               "threads_alive": store.threads_alive,
               "checkpoints": steps, "sidecars": sidecars,
               "scatter_launches": launches,
               "phases": _phase_split(job)}
    print(json.dumps({label: summary}), flush=True)
    ticks = (stats["fold_ticks"] > 0 and (
        stats["prefetch_ticks"] > 0 if not store.deferred_prepare
        else stats["cold_gather_overlap_share"] == 0.0))
    if (job.exit_code != 0 or counters["failed"] != 0
            or job.owner.step != LOCAL_STEPS or not ticks
            or store.threads_alive or store._started
            or steps != want_steps or sidecars != want_steps
            or stats["vocab_rows"] <= LOCAL_CACHE
            or launches != 2 * LOCAL_STEPS
            or fa.flash_attention.launches != 0):
        raise AssertionError(f"{label}: {summary}")
    return summary, job, launches


def local_tiered(card: str, work: str, served: dict):
    """`elasticdl train --model_def deepfm.deepfm_tiered.custom_model` on
    local_deepfm's records: one worker, two workers, K = 4 blocks, the
    int8 cache; then the one-worker job's last step served in process
    through TieredServingEngine.  Returns (summary, launches of the
    one-worker job)."""
    tmp = os.path.join(work, "local_tiered")
    train_dir = os.path.join(os.path.dirname(served["val_dir"]), "train")
    jobs, ckpts = {}, {}
    launches = {}
    for label, extra in (
            ("tiered_one_worker", ()),
            ("tiered_two_workers", ("--num_workers", "2")),
            ("tiered_k4", ("--steps_per_execution", "4")),
            ("tiered_int8", ("--store_cache_dtype", "int8"))):
        ckpts[label] = os.path.join(tmp, label)
        summary, job, n = tiered_job(label, card, ckpts[label], train_dir,
                                     *extra)
        jobs[label] = summary
        launches[label] = n
        del job
    if not jobs["tiered_two_workers"]["deferred"] or \
            not jobs["tiered_k4"]["deferred"] or \
            jobs["tiered_k4"]["stats"]["block_plans"] != LOCAL_STEPS // 4:
        raise AssertionError(f"deferred planning: {jobs}")
    serving = serve_tiered(card, ckpts["tiered_one_worker"], served)
    summary = {"cache_rows": LOCAL_CACHE, "jobs": jobs, "serving": serving}
    return summary, launches


def serve_tiered(card: str, ckpt: str, served: dict) -> dict:
    """The one-worker tiered job's last step served in process: the
    validation records' AUC, resident rows against the Trainer, never
    seen ids, a hot swap through the reloader under traffic and a step
    without its sidecar rejected."""
    device = torch.device("cuda", 0)
    spec = get_model_spec(ZOO_DIR, TIERED, TIERED_PARAMS)
    sample = {
        "dense": np.zeros((1, 13), np.float32),
        "slots": np.zeros((1, NUM_SPARSE), np.int32),
        "cold_fm": np.zeros((1, NUM_SPARSE, DEEPFM_DIM), np.float32),
        "cold_linear": np.zeros((1, NUM_SPARSE, 1), np.float32)}
    t0 = time.perf_counter()
    engine = ServingEngine.from_checkpoint(ckpt, spec, sample,
                                           buckets=BUCKETS, device=device)
    first = engine.step
    tiered = TieredServingEngine(engine, ckpt, first,
                                 tiered_zoo.OVERLAY_FEATURES)
    build_s = time.perf_counter() - t0
    val = read_validation(served["val_dir"])
    feats = bf16_rounded(val["features"])
    labels = val["labels"]
    preds, translate_ms = [], []
    for i in range(0, LOCAL_VAL, AUC_CHUNK):
        chunk = {k: v[i:i + AUC_CHUNK] for k, v in feats.items()}
        t1 = time.perf_counter()
        tiered.translate(chunk["sparse"])
        translate_ms.append((time.perf_counter() - t1) * 1e3)
        p, _ = tiered.predict(chunk, len(chunk["dense"]))
        preds.append(p)
    preds = np.concatenate(preds)
    served_auc = float(auc(labels, preds))

    # rows whose ids are all resident: the engine against the Trainer on
    # the restored state, one 64-row batch (one bucket, one shape)
    slots, _ = tiered.translate(feats["sparse"])
    hot = np.nonzero((slots >= 0).all(1))[0][:AUC_CHUNK]
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, use_bf16=True,
                      device=device)
    template = trainer.init_state(SEED, {"dense": sample["dense"],
                                         "slots": sample["slots"]})
    saver = CheckpointSaver(ckpt)
    restored = saver.restore_step(first, template)
    saver.close()
    want = trainer.predict_on_batch(restored, {
        "dense": feats["dense"][hot], "slots": slots[hot]})
    got, _ = tiered.predict({"dense": feats["dense"][hot],
                             "sparse": feats["sparse"][hot]}, hot.size)
    resident_err = float(np.abs(got - want).max())
    unknown, _ = tiered.predict({
        "dense": feats["dense"][:4],
        "sparse": np.full((4, NUM_SPARSE), 2 ** 30, np.int64)}, 4)

    # a newer step with its sidecar, under traffic, through the reloader
    store = tiered_zoo.TieredStore(TIERED_PLANES, NUM_SPARSE, LOCAL_CACHE)
    saver = CheckpointSaver(ckpt, keep_max=0)
    saver.attach_tiered_store(store)
    state = saver.maybe_restore(trainer.init_state(SEED, {
        "dense": sample["dense"], "slots": sample["slots"]}))
    with torch.no_grad():
        state.model.mlp_out.bias.add_(SWAP_SHIFT)
    state.step = first + 1
    reloader = CheckpointReloader(tiered, ckpt)
    failures, answered = [], []
    stop = threading.Event()
    requests = [{k: v[j:j + 4] for k, v in feats.items()}
                for j in range(0, 4 * TIERED_REQUESTS, 4)]

    def client():
        while not stop.is_set():
            for r in requests:
                try:
                    p, step = tiered.predict(r, 4)
                    if not np.isfinite(p).all():
                        raise AssertionError("non-finite")
                    answered.append(step)
                except Exception as exc:   # counted, then raised below
                    failures.append(repr(exc))

    clients = [threading.Thread(target=client) for _ in range(CLIENT_THREADS)]
    for c in clients:
        c.start()
    try:
        wait_until(lambda: len(answered) >= 20, SWAP_DEADLINE_S,
                   "traffic before the swap")
        saver.save(state)
        saver.wait_until_finished()
        swapped = reloader.check_once()
        n = len(answered)
        wait_until(lambda: len(answered) >= n + 20, SWAP_DEADLINE_S,
                   "traffic after the swap")
        # a step whose sidecar is gone: rejected, the old one serves on
        state.step += 1
        saver.save(state)
        saver.wait_until_finished()
        shutil.rmtree(store_ckpt.sidecar_dir(ckpt, state.step))
        rejected = not reloader.check_once()
        n = len(answered)
        wait_until(lambda: len(answered) >= n + 20, SWAP_DEADLINE_S,
                   "traffic after the rejection")
    finally:
        stop.set()
        for c in clients:
            c.join(timeout=SWAP_DEADLINE_S)
        saver.close()
    steps_seen = sorted(set(answered))
    summary = {
        "card": card, "step": first, "build_s": build_s,
        "served_auc": served_auc, "flat_local_auc": served["auc"],
        "auc_band": list(AUC_BAND),
        "translate_ms_per_request_mean": float(np.mean(translate_ms)),
        "translate_ms_per_request_p50": float(np.median(translate_ms)),
        "rows_per_request": AUC_CHUNK,
        "resident_rows": int(hot.size),
        "resident_max_abs_err_vs_trainer": resident_err,
        "resident_tol": SERVE_TOL,
        "unknown_ids_finite": bool(np.isfinite(unknown).all()),
        "swapped": swapped, "swap_s": reloader.last_reload_s,
        "rejected": rejected, "rejected_count": reloader.rejected_count,
        "last_error": reloader.last_error, "serving_step": tiered.step,
        "requests": len(answered), "failed_requests": len(failures),
        "steps_answered": steps_seen,
    }
    print(json.dumps({"serve_tiered": summary}), flush=True)
    if (failures or not swapped or not rejected
            or tiered.step != first + 1
            or steps_seen != [first, first + 1]
            or not AUC_BAND[0] <= served_auc <= AUC_BAND[1]
            or hot.size != AUC_CHUNK or resident_err > SERVE_TOL
            or not summary["unknown_ids_finite"]):
        raise AssertionError(f"serve_tiered: {summary} {failures[:3]}")
    return summary


# ---- the rest of the zoo through the Local runner (zoo_local) ----------

CENSUS = "census.wide_and_deep.custom_model"
CENSUS_TRAIN = 8192              # scripts/record_convergence.py::census
CENSUS_VAL = 4096
CENSUS_BATCH = 512
CENSUS_EPOCHS = 4
CENSUS_STEPS = CENSUS_TRAIN * CENSUS_EPOCHS // CENSUS_BATCH      # 64
CENSUS_RECORDS_PER_TASK = 2048
CENSUS_BAND = (0.68, 0.80)       # tests/test_convergence.py
CENSUS_VOCAB = 4096              # the zoo's default vocab_capacity
XDEEPFM = "deepfm.xdeepfm.custom_model"
XDEEPFM_VOCAB = 1 << 18
XDEEPFM_PARAMS = (f"vocab_capacity={XDEEPFM_VOCAB};embed_dim={DEEPFM_DIM};"
                  "cin_widths=(64, 64);bf16=True;lr=0.005")
# xDeepFM has no recorded band: the AUC of its JAX twin, the JAX
# package's own Local job at this configuration on the same records, run
# on the CPU (PERF.md)
XDEEPFM_JAX_AUC = 0.8070796364329988
XDEEPFM_AUC_TOL = 0.01
XDEEPFM_TIMED_STEPS = 5
MNIST_MODELS = ("mnist.mnist_functional_api.custom_model",
                "mnist.mnist_subclass.custom_model")
MNIST_TRAIN = 2048
MNIST_VAL = 512
MNIST_BATCH = 128
MNIST_EPOCHS = 4
MNIST_STEPS = MNIST_TRAIN * MNIST_EPOCHS // MNIST_BATCH          # 64
MNIST_BAND = (0.99, 1.0)         # tests/test_convergence.py
MNIST_SPEC = {"features": {"shape": [784], "dtype": "float32"}}
RESNET = "cifar10.resnet.custom_model"
RESNET_TRAIN = 1024              # scripts/record_convergence.py::cifar10
RESNET_VAL = 512
RESNET_VAL_SEED = 9
RESNET_BATCH = 64
RESNET_STEPS = RESNET_TRAIN // RESNET_BATCH                      # 16
RESNET_BAND = (0.60, 1.0)        # tests/test_convergence.py
RESNET_TIMED_STEPS = 5
RESNET_BATCHNORMS = 53           # the stem, 16 blocks x 3, 4 projections
CTR = "clickstream.ctr_mlp.custom_model"
CTR_TRAIN = 32768
CTR_VAL = 16384
CTR_BATCH = 1024
CTR_EPOCHS = 2
CTR_STEPS = CTR_TRAIN * CTR_EPOCHS // CTR_BATCH                  # 64


class ClickReader(MemoryDataReader):
    """`clicks://N:SEED`: N seeded click dicts (user, item, clicked) from
    a planted signal: per-user and per-item propensities on the hashed
    buckets ctr_mlp encodes, and a user x item term (users and items of
    one residue mod 4 click more).  The zoo job keeps this finite,
    planted source for its accuracy band; the stream phase trains on
    ClickStreamSource."""

    def __init__(self, data_dir: str = "", **kwargs):
        n, seed = (int(v) for v in data_dir.split(":"))
        rng = np.random.RandomState(seed)
        planted = np.random.RandomState(4321)
        user_w = planted.randn(ctr_zoo.HASH_USER) * 1.5
        item_w = planted.randn(ctr_zoo.HASH_ITEM) * 1.5
        users = rng.randint(0, 1 << 20, n)
        items = rng.randint(0, 1 << 16, n)
        logits = (user_w[users % ctr_zoo.HASH_USER]
                  + item_w[items % ctr_zoo.HASH_ITEM]
                  + 1.5 * ((users % 4) == (items % 4)) - 0.5)
        clicked = (rng.rand(n) < 1.0 / (1.0 + np.exp(-logits)))
        super().__init__({"user": users, "item": items,
                          "clicked": clicked.astype(np.int64)},
                         name=f"clicks-{seed}", **kwargs)



def zoo_argv(job: str, model_def: str, batch: int, *extra) -> list:
    """A Local job of the zoo at its own width, f32 features (the
    convergence protocols feed f32)."""
    return [job, "--distribution_strategy", "Local", "--model_def",
            model_def, "--minibatch_size", str(batch), "--use_bf16",
            "false", *extra]


def zoo_job(label: str, card: str, argv: list, steps: int, examples: int,
            metric: str, band, scatter_per_step: int, job_type="train"):
    """One Local job, counted from 0 around it; checks its exit, steps,
    failed tasks, scatter-add launches and metric band; returns (job,
    summary)."""
    args = cli.parse_args(argv)
    # ---- the main path: counts start at 0 here ----
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    job = api.run_local(args, job_type)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sa.scatter_add.launches
    # ---- end of the main path ----
    counters = job.master.task_manager.counters.as_dict()
    value = (job.metrics or {}).get(metric)
    summary = {"card": card, "exit_code": job.exit_code,
               "model_step": job.owner.step, "wall_s": wall,
               "examples_per_s": examples / wall, "metrics": job.metrics,
               "counters": counters, "scatter_launches": launches,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "phases": _phase_split(job)}
    print(json.dumps({label: summary}), flush=True)
    if job.exit_code != 0 or counters["failed"] != 0 or \
            job.owner.step != steps:
        raise AssertionError(f"{label}: the job failed or took "
                             f"{job.owner.step} steps, not {steps}: "
                             f"{summary}")
    if launches != scatter_per_step * steps:
        raise AssertionError(f"{label}: {launches} scatter-add launches, "
                             f"want {scatter_per_step} x {steps} steps")
    if value is None or not band[0] <= value <= band[1]:
        raise AssertionError(f"{label}: {metric} {value} outside {band}")
    return job, summary


def job_losses(job) -> list:
    return [float(loss) for w in job.workers for loss in w.losses]


def profiled_step(trainer, state, batch, ranges=()) -> dict:
    """One synced training step under torch.profiler: device ms by
    kernel (top 12), inside each named range, and the busy share of the
    step's host wall."""
    from torch.profiler import ProfilerActivity, profile

    staged = trainer.stage_batch(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_on_batch(state, staged)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = _device_ms_by_kernel(prof)
    device_ms = sum(by_kernel.values())
    return {"profiled_wall_ms": wall_ms,
            "device_ms": device_ms if by_kernel else None,
            "device_busy_share": device_ms / wall_ms if by_kernel else None,
            "by_kernel": by_kernel,
            "top_kernels_ms": sorted(by_kernel.items(),
                                     key=lambda kv: -kv[1])[:12],
            "device_ms_by_range": range_device_ms(prof, ranges)}


def timed_step_ms(trainer, state, batch, iters: int) -> float:
    return 1e3 / trainer.timed_steps_per_sec(state, batch, iters=iters)


def _is_conv(name: str) -> bool:
    low = name.lower()
    return any(s in low for s in ("conv", "cudnn", "xmma", "gemm", "nvjet",
                                  "implicit", "fprop", "dgrad", "wgrad",
                                  "cutlass"))


def census_jobs(card: str, work: str) -> dict:
    """Wide & Deep from CSV files and from a SQLite table of the same
    rows: the census protocol, AUC in the band, 2 scatter-adds a step,
    the same per-step losses and metrics bit for bit."""
    root = os.path.join(work, "census")
    os.makedirs(root, exist_ok=True)
    rows = census_data.synthetic_census(CENSUS_TRAIN + CENSUS_VAL, seed=SEED)
    train_dir = os.path.join(root, "train")
    os.makedirs(train_dir, exist_ok=True)
    census_data.write_csv(os.path.join(train_dir, "census-train.csv"),
                          rows[:CENSUS_TRAIN])
    val = census_data.write_csv(os.path.join(root, "census-val.csv"),
                                rows[CENSUS_TRAIN:])
    table = census_data.write_table(os.path.join(root, "census.db"),
                                    "census", rows[:CENSUS_TRAIN])
    common = ["--model_params", "lr=0.005", "--num_epochs",
              str(CENSUS_EPOCHS), "--records_per_task",
              str(CENSUS_RECORDS_PER_TASK), "--validation_data", val]
    out, losses = {}, {}
    for label, origin in (("zoo_census_csv", train_dir),
                          ("zoo_census_sqlite", table)):
        job, summary = zoo_job(
            label, card, zoo_argv("train", CENSUS, CENSUS_BATCH,
                                  "--training_data", origin, *common),
            CENSUS_STEPS, CENSUS_TRAIN * CENSUS_EPOCHS, "auc", CENSUS_BAND,
            scatter_per_step=2)
        losses[label] = job_losses(job)
        out[label] = summary
        del job
    out["losses_equal"] = losses["zoo_census_csv"] == \
        losses["zoo_census_sqlite"]
    out["metrics_equal"] = out["zoo_census_csv"]["metrics"] == \
        out["zoo_census_sqlite"]["metrics"]
    if not (out["losses_equal"] and out["metrics_equal"]
            and len(losses["zoo_census_csv"]) == CENSUS_STEPS):
        raise AssertionError(f"census CSV and SQLite jobs differ: {out}")
    return out


def xdeepfm_job(card: str, served: dict) -> dict:
    """xDeepFM on the DeepFM Local job's records at its width: AUC
    within XDEEPFM_AUC_TOL of its JAX twin's, 2 scatter-adds a step;
    then on a bare Trainer its step ms and the CIN's share of a profiled
    step, and its contraction timed against torch.einsum's path."""
    val_dir = served["val_dir"]
    train_dir = os.path.join(os.path.dirname(val_dir), "train")
    fm_zoo._DEDUP_PACKER = DedupPacker()
    band = (XDEEPFM_JAX_AUC - XDEEPFM_AUC_TOL,
            XDEEPFM_JAX_AUC + XDEEPFM_AUC_TOL)
    job, out = zoo_job(
        "zoo_xdeepfm", card,
        [*local_argv("train", "--training_data", train_dir,
                     "--validation_data", val_dir, "--num_epochs", "1"),
         "--model_def", XDEEPFM, "--model_params", XDEEPFM_PARAMS],
        LOCAL_STEPS, LOCAL_TRAIN, "auc", band, scatter_per_step=2)
    out["jax_twin_auc"] = XDEEPFM_JAX_AUC
    del job
    spec = get_model_spec(ZOO_DIR, XDEEPFM, model_params=XDEEPFM_PARAMS)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, use_bf16=True)
    batch = make_criteo_batch(AUC_BATCH)
    state = trainer.init_state(SEED, batch["features"])
    out["step_ms"] = timed_step_ms(trainer, state, batch,
                                   XDEEPFM_TIMED_STEPS)
    prof = profiled_step(trainer, state, batch, ("cin_layer",))
    out["profiled_step"] = {k: v for k, v in prof.items()
                            if k != "by_kernel"}
    # the CIN alone, forward and backward, on this batch's embeddings
    cin = state.model.cin
    with torch.no_grad():
        rows = trainer.stage_batch(batch)["features"]
        emb = state.model.fm_embedding(
            {"sparse": fm_zoo.field_offset_ids(rows["sparse"])})["sparse"]
    emb = emb.detach().requires_grad_(True)

    def cin_step():
        cin(emb).sum().backward()

    def einsum_forward():
        xk, x0 = emb, emb
        for li in range(len(cin.layer_widths)):
            xk = torch.relu(torch.einsum("hij,bid,bjd->bhd",
                                         getattr(cin, f"w_{li}"), xk, x0))
        return xk

    with torch.no_grad():
        out["cin"] = {
            "forward_ms": time_ms(lambda: cin(emb), 10),
            "torch_einsum_forward_ms": time_ms(einsum_forward, 10),
            "outer_product_bytes_layer2": int(
                AUC_BATCH * cin.layer_widths[0] * NUM_SPARSE * DEEPFM_DIM
                * 4)}
    out["cin"]["forward_backward_ms"] = time_ms(cin_step, 10)
    out["cin"]["share_of_step"] = \
        out["cin"]["forward_backward_ms"] / out["step_ms"]
    print(json.dumps({"zoo_xdeepfm_step": {
        "card": card, "step_ms": out["step_ms"], "cin": out["cin"],
        "busy": prof["device_busy_share"]}}), flush=True)
    del trainer, state, cin, emb
    return out


def mnist_jobs(card: str, work: str) -> dict:
    """Both MNIST styles at the convergence protocol's batch, accuracy
    in the band; the functional job's checkpoint served with `serve`
    over 127.0.0.1 at the job's accuracy."""
    root = os.path.join(work, "mnist")
    train_dir, val_dir = mnist_data.write_dataset(
        root, n_train=MNIST_TRAIN, n_val=MNIST_VAL, seed=SEED)
    out = {}
    for model_def in MNIST_MODELS:
        label = "zoo_" + model_def.split(".")[1]
        ckpt = os.path.join(root, "ckpt_" + label)
        _, out[label] = zoo_job(
            label, card, zoo_argv(
                "train", model_def, MNIST_BATCH, "--training_data",
                train_dir, "--validation_data", val_dir, "--num_epochs",
                str(MNIST_EPOCHS), "--records_per_task", "512",
                "--checkpoint_dir", ckpt, "--checkpoint_steps",
                str(MNIST_STEPS)),
            MNIST_STEPS, MNIST_TRAIN * MNIST_EPOCHS, "accuracy", MNIST_BAND,
            scatter_per_step=0)
        out[label]["ckpt"] = ckpt
    functional = out["zoo_mnist_functional_api"]
    server, stub = start_server(cli.parse_args(serve_argv(
        MNIST_MODELS[0], "", "--checkpoint_dir", functional["ckpt"],
        "--feature_spec", json.dumps(MNIST_SPEC))))
    try:
        images, labels = mnist_data.synthetic_mnist(MNIST_VAL, seed=SEED + 1)
        features = images.astype(np.float32) / 255.0
        chunks = [{"features": features[i:i + 64]}
                  for i in range(0, MNIST_VAL, 64)]
        by_client = [chunks[c::CLIENT_THREADS]
                     for c in range(CLIENT_THREADS)]
        results, wall_s = socket_traffic(stub, by_client)
        preds = [None] * len(chunks)
        for c, i, _, resp, _ in results:
            preds[c + i * CLIENT_THREADS] = from_tensor_proto(
                resp.predictions)
        served = float(np.mean(np.argmax(np.concatenate(preds), -1)
                               == labels))
        out["served"] = {"card": card, "accuracy": served,
                         "job_accuracy": functional["metrics"]["accuracy"],
                         "model_step": server.engine.step,
                         **latency_summary(results, wall_s)}
    finally:
        stub.close()
        server.stop()
    print(json.dumps({"zoo_mnist_served": out["served"]}), flush=True)
    if out["served"]["accuracy"] != out["served"]["job_accuracy"] or \
            out["served"]["model_step"] != MNIST_STEPS:
        raise AssertionError(f"served MNIST: {out['served']}")
    return out


def resnet_jobs(card: str, work: str) -> dict:
    """ResNet-50 at full depth, the cifar10 protocol: 16 SGD-momentum
    steps of 64, accuracy in the band on 512 held-out records; the
    running statistics moved in training and an evaluate job restores
    them and scores the same.  Then a bare Trainer's step ms, peak
    memory and a profiled step's busy share and conv / other split."""
    root = os.path.join(work, "cifar10")
    train_dir, val_dir = cifar_data.write_dataset(
        root, n_train=RESNET_TRAIN, n_val=RESNET_VAL, seed=SEED,
        val_seed=RESNET_VAL_SEED)
    ckpt = os.path.join(root, "ckpt")
    common = ["--validation_data", val_dir, "--records_per_task", "256"]
    job, out = zoo_job(
        "zoo_resnet50", card, zoo_argv(
            "train", RESNET, RESNET_BATCH, "--training_data", train_dir,
            "--checkpoint_dir", ckpt, "--checkpoint_steps",
            str(RESNET_STEPS), *common),
        RESNET_STEPS, RESNET_TRAIN, "accuracy", RESNET_BAND,
        scatter_per_step=0)
    stats = {k: v.detach().cpu().clone() for k, v in
             job.owner.state.model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    out["batchnorms"] = len(stats) // 2
    out["stats_moved"] = all(
        not torch.all(v == (0.0 if k.endswith("mean") else 1.0))
        for k, v in stats.items())
    del job
    evaluate, ev = zoo_job(
        "zoo_resnet50_evaluate", card, zoo_argv(
            "evaluate", RESNET, RESNET_BATCH, "--checkpoint_dir_for_init",
            ckpt, *common),
        RESNET_STEPS, RESNET_VAL, "accuracy", RESNET_BAND,
        scatter_per_step=0, job_type="evaluate")
    restored = evaluate.owner.state.model.state_dict()
    ev["stats_restored"] = all(torch.equal(restored[k].cpu(), v)
                               for k, v in stats.items())
    ev["metrics_equal_train"] = ev["metrics"] == out["metrics"]
    out["evaluate"] = ev
    del evaluate
    if out["batchnorms"] != RESNET_BATCHNORMS or not out["stats_moved"] or \
            not ev["stats_restored"] or not ev["metrics_equal_train"]:
        raise AssertionError(f"ResNet-50's running statistics: {out}")
    spec = get_model_spec(ZOO_DIR, RESNET)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss)
    xs, ys = cifar_data.synthetic_cifar(RESNET_BATCH, seed=SEED)
    batch = {"features": (xs.astype(np.float32) / 255.0 - 0.5),
             "labels": ys.astype(np.int32)}
    state = trainer.init_state(SEED, batch["features"])
    torch.cuda.reset_peak_memory_stats()
    out["step_ms"] = timed_step_ms(trainer, state, batch,
                                   RESNET_TIMED_STEPS)
    out["step_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    prof = profiled_step(trainer, state, batch)
    conv = sum(ms for name, ms in prof["by_kernel"].items()
               if _is_conv(name))
    out["profiled_step"] = {k: v for k, v in prof.items()
                            if k != "by_kernel"}
    out["profiled_step"]["conv_gemm_ms"] = conv
    out["profiled_step"]["other_ms"] = (prof["device_ms"] or 0.0) - conv
    print(json.dumps({"zoo_resnet50_step": {
        "card": card, "step_ms": out["step_ms"],
        "peak_memory_gb": out["step_peak_memory_gb"],
        "busy": prof["device_busy_share"], "conv_gemm_ms": conv,
        "other_ms": out["profiled_step"]["other_ms"]}}), flush=True)
    del trainer, state
    return out


def ctr_job(card: str) -> dict:
    """ctr_mlp on seeded click dicts through a registered `clicks://`
    reader (a MemoryDataReader): accuracy above the majority class."""
    register_data_reader("clicks", ClickReader)
    val = ClickReader(f"{CTR_VAL}:{SEED + 1}")
    majority = float(max(np.mean(val._arrays["clicked"]),
                         1 - np.mean(val._arrays["clicked"])))
    _, out = zoo_job(
        "zoo_ctr_mlp", card, zoo_argv(
            "train", CTR, CTR_BATCH, "--training_data",
            f"clicks://{CTR_TRAIN}:{SEED}", "--validation_data",
            f"clicks://{CTR_VAL}:{SEED + 1}", "--num_epochs",
            str(CTR_EPOCHS), "--records_per_task", "8192"),
        CTR_STEPS, CTR_TRAIN * CTR_EPOCHS, "accuracy",
        (majority + 0.01, 1.0), scatter_per_step=0)
    out["majority_share"] = majority
    return out


def zoo_local(card: str, work: str, served: dict):
    """The rest of the zoo through `elasticdl train` Local jobs on the
    card (Wide & Deep from CSV and SQLite, xDeepFM, both MNISTs served
    over a socket, ResNet-50, ctr_mlp); returns (summary, the scatter-add
    launches by path)."""
    out = {"census": census_jobs(card, work),
           "xdeepfm": xdeepfm_job(card, served),
           "mnist": mnist_jobs(card, work),
           "resnet50": resnet_jobs(card, work),
           "ctr_mlp": ctr_job(card)}
    launches = {
        "zoo_census_csv": out["census"]["zoo_census_csv"][
            "scatter_launches"],
        "zoo_census_sqlite": out["census"]["zoo_census_sqlite"][
            "scatter_launches"],
        "zoo_xdeepfm": out["xdeepfm"]["scatter_launches"],
        **{label: out["mnist"][label]["scatter_launches"]
           for label in ("zoo_mnist_functional_api", "zoo_mnist_subclass")},
        "zoo_resnet50": out["resnet50"]["scatter_launches"],
        "zoo_ctr_mlp": out["ctr_mlp"]["scatter_launches"]}
    return out, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s for {_build.sources()}",
          flush=True)
    # ptxas's registers, spills and shared memory per kernel, also kept
    # in chip_smoke.json
    build_resources = {}
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if any(s in line for s in ("Compiling entry", "registers",
                                       "spill", "smem", "C75")):
                build_resources.setdefault(name, []).append(line.strip())
                if "Compiling entry" not in line:
                    print(f"  {name}: {line.strip()}")
    hgmma = {}
    for source in (fa.SOURCE_SM90, fa.SOURCE_BWD_SM90):
        hgmma[source] = sass_count(source, "HGMMA")
        print(f"  {source}: {hgmma[source]} HGMMA instructions in the SASS",
              flush=True)
        if hgmma[source] == 0:
            raise AssertionError(f"{source} has no HGMMA (wgmma) "
                                 "instruction in its SASS")
    sass_stats = sass_by_kernel(fa.SOURCE_BWD_SM90)
    for name, stats in sass_stats.items():
        print(f"  {fa.SOURCE_BWD_SM90}: {name}: {stats}", flush=True)

    build = {"build_s": build_s, "build_resources": build_resources,
             "hgmma": hgmma, "bwd_sass_by_kernel": sass_stats}
    # the Local jobs' data, checkpoints and exports, which the serve_cli
    # phases serve
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run_phases(card, build, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_phases(card: str, build: dict, work: str) -> int:
    # wall seconds of each phase, the build's included
    phase_s = {"build": build["build_s"]}

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        phase_s[label] = time.perf_counter() - t0
        return out

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entry, rows = phase("check_flash", check_flash_kernel, gen)
    bwd_entry, bwd_rows = phase("check_flash_bwd", check_flash_bwd, gen)
    buffers = phase("wire_records", wire_buffers)
    scatter_entry, scatter_rows = phase("check_scatter", check_scatter_kernel,
                                        gen, buffers[0])
    serve, check, launches = phase("serve_bert", serve_bert, SEED)
    entry["launches"] = launches["flash_attention_fwd"]
    deepfm, fm_launches = phase("deepfm_trainer", train_deepfm)
    local, local_launches, fm_served = phase("local_deepfm", local_deepfm,
                                             card, work)
    resilient, resilient_launches = phase(
        "resilient_local", resilient_local, card, work, fm_served)
    stream, stream_launches = phase("stream_judgment", stream_judgment,
                                    card, work, fm_served)
    serve_fm = phase("serve_cli_deepfm", serve_cli_deepfm, card, fm_served)
    wire, wire_launches = phase("wire_deepfm", wire_deepfm, buffers)
    del buffers
    tiered, tiered_launches = phase("tiered_deepfm", tiered_deepfm, card)
    local_t, local_t_launches = phase("local_tiered", local_tiered, card,
                                      work, fm_served)
    zoo, zoo_launches = phase("zoo_local", zoo_local, card, work, fm_served)
    bert_train, bert_launches_by = phase("train_bert", train_bert)
    bert_local, bert_local_launches, bert_ckpt = phase(
        "local_bert", local_bert, card, work)
    serve_bert_cli, cli_launches = phase("serve_cli_bert", serve_cli_bert,
                                         card, bert_ckpt, serve)
    print(json.dumps({"phase_s": phase_s}), flush=True)
    # launches: the Local job's (the north star's path); each path's
    # count beside it
    scatter_entry["launches"] = local_launches["scatter_add"]
    scatter_entry["launches_by_path"] = {
        "deepfm_trainer": fm_launches["scatter_add"],
        "local_deepfm": local_launches["scatter_add"],
        "local_deepfm_dedup": local_launches["local_deepfm_dedup"],
        "local_deepfm_int8": local_launches["local_deepfm_int8"],
        **resilient_launches,
        "stream_judgment": stream_launches,
        "wire_deepfm": wire_launches,
        "tiered_deepfm": tiered_launches,
        **local_t_launches,
        **zoo_launches,
        "train_bert": bert_launches_by["plain"]["scatter_add"],
        "train_bert_remat": bert_launches_by["remat"]["scatter_add"],
        "local_bert_tiny":
            bert_local_launches["local_bert_tiny"]["scatter_add"],
        "local_bert_full":
            bert_local_launches["local_bert_full"]["scatter_add"]}
    bert_paths = {"train_bert": bert_launches_by["plain"],
                  "train_bert_remat": bert_launches_by["remat"],
                  **bert_local_launches}
    entry["launches_by_path"] = {
        "serve_bert": launches["flash_attention_fwd"],
        "serve_cli_bert": cli_launches["flash_attention_fwd"],
        **{path: n["flash_attention_fwd"] for path, n in
           bert_paths.items()}}
    # launches: the bare Trainer's timed steps at bench_bert's shape (the
    # BERT training path); each path's count beside it
    bwd_entry["launches"] = bert_launches_by["plain"]["flash_attention_bwd"]
    bwd_entry["launches_by_path"] = {
        path: n["flash_attention_bwd"] for path, n in bert_paths.items()}
    kernels = {"kernels": [entry, scatter_entry, bwd_entry]}

    name = torch.cuda.get_device_name(0)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "cuda": torch.version.cuda, **build,
                   "phase_s": phase_s,
                   "kernel_checks": rows, "scatter_checks": scatter_rows,
                   "flash_bwd_checks": bwd_rows,
                   "train_bert": bert_train, "local_bert": bert_local,
                   "serve": serve, "bert_f32_check": check,
                   "deepfm": deepfm, "local_deepfm": local,
                   "resilient_local": resilient,
                   "stream_judgment": stream,
                   "wire_deepfm": wire, "serve_cli_deepfm": serve_fm,
                   "tiered_deepfm": tiered, "local_tiered": local_t,
                   "zoo_local": zoo,
                   "serve_cli_bert": serve_bert_cli, **kernels}, f,
                  indent=1)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
