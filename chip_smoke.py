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
   first poll decomposes every window's ingest_wait and arm_wait (the
   later phases come from the online loop, item 17).  A second run must give the same
   events (bar wall-time fields) and parameters bit for bit, and the
   first window's losses must equal the CPU's from the same weights
   within 1e-5.  (b) local_deepfm's train job with `--history_interval
   0.5 --slo_interval 0.5 --incident_dir`: in the AUC band, 64
   scatter-add launches, its final `state.pt` bit for bit local_deepfm's,
   the SLOs of a job that serves nothing (JUDGMENT_SLO_STATES), a manual
   bundle read back; then a freshness
   drill: (a)'s checkpoints produced one by one through a CheckpointSaver
   and served by a ServingEngine + CheckpointReloader, each predict's
   step into a FreshnessTracker, its registry into a MetricHistory, the
   staleness_p99 SLO `ok` while reloads keep up and `breach` once a
   reload is held past the 30 s objective, and exactly one slo_breach
   bundle from the flight recorder.
17. The online loop (`online_loop`, after `stream_judgment`; budget 30
   s): stream -> train -> checkpoint -> rolling hot-reload behind the
   FleetRouter, ctr_mlp at its only width (hashed one-hots 128 -> Dense
   32 -> ReLU -> Dense 2, Adam), through OnlinePipeline on the card.
   (a) bench.py::_online_chaos_run's scenario at bench_online's seed
   20260805 under a fake clock (0.125 s a read): 12 ticks of
   OnlineConfig(window_records=64, records_per_poll=64,
   records_per_task=16, checkpoint_every_windows=2, replicas=2,
   workers=3, num_shards=4), faults at stream.poll, task.rearm,
   serving.reload and store.shard_handoff, a replica kill, two trainer
   kills and at tick 7 a master restart with the reader's buffers wiped.
   Two card runs and one CPU run (from the card's initial weights) give
   one canonical text (fault trace, fleet and SLO decisions, normalized
   events, lineage decompositions) byte for byte and equal summaries;
   every fault fired, 0 windows lost, 0 duplicate reports, 0 failed
   requests, lineage phase sums within 5% of the measured end-to-end
   time, the replayed window's ingest stamp from before the restart, and
   the final parameters within ONLINE_PARAM_TOL of the CPU's.  (b)
   bench_online's sustained loop on a real clock: 8 windows under two
   predict-load threads (rows of 1, 2 or 4 through the router): train
   examples/s, served requests/s, client p50/p99, staleness p50/p99 in
   steps and seconds, the maximum staleness burn; at least 2 reload
   cycles behind traffic and 0 failed requests.  (c)
   bench.py::_traffic_spike_run's serving control loop (seed 20260807):
   44 ticks, 12 requests a tick per replica, replicas 1 -> at most 4, a
   5x spike at tick 8 for 4 ticks from the traffic generator, twice with
   one canonical text; the fleet scales up within its hysteresis, the
   flight recorder writes one bundle at the predict_shed_ratio breach,
   backpressure skips polls, and the fleet returns to 1 replica.  The
   phase runs no kernel: ctr_mlp has no embedding, and the sharded
   store's statistics live on the host.
18. The elastic cluster (`cluster`, after `observatory`; budget 75 s).
   (a) DeepFM at bench width (vocab 2^20 per arena, dim 16, MLP
   256/128), global batch 8192, 4 seeded Criteo steps, as two ranks on
   cuda:0 (processes of their own, `chip_smoke.py --cluster-rank`; the
   stated rule picks gloo: two ranks share one device) and as one rank
   in this process, with the bf16 MLP and again with an f32 MLP: the
   ranks' states bit-equal, 2 scatter-add launches a rank a step, the
   f32 state within DP_F32_TOL of the one rank's and the bf16 state
   within DP_BF16_TOL (Adam's bound) with every step's loss within
   DP_LOSS_RTOL; one all-reduce of a gradient over a world-1 NCCL group
   returns its input bit for bit.  In the ranks, BERT-base's timed
   data-parallel steps at the job's shapes and the all-reduce of its
   gradients (its share of the step); then (c) the scatter-add at a
   rank's DeepFM rows (bitwise, on CPU copies) and the flash forward
   and backward at a rank's BERT attention shape (TOL, BWD_TOL, the
   sm90_wgmma variant), after the counts were read.  (b) BASELINE.md
   #5: BERT-base (hidden 768, 12 layers, 12 heads, MLP 3072, vocab
   8192, L 512, bf16, AdamW) fine-tuned through the master's entry point
   (`master.main.main`) with ProcessK8sClient and 2 worker processes on
   the card, 96 synthetic pair records in global batches of 16 (tasks
   of 2 steps), a checkpoint every 2 steps, and two preemptions.  Worker
   1 holds before its second task (CLUSTER_HOLD_S) so step 2's
   checkpoint commits, and is SIGKILLed once it has.  Once that outage
   has closed and the second group has committed step 4 (its rank 0
   holds in its version report), the pod that holds the second group's
   rank 0, read from the rendezvous' current spec, is SIGKILLed: rank 0
   hosts the group's TCPStore.  The job exits 0 with every record trained, the recovery
   clock holds two values, each under 120 s (the JAX test's budget), the
   relaunch chains stay within --relaunch_on_worker_failure, the third
   group's two ranks log one epoch and one state digest, and both
   counted flash forward and backward launches on sm90_wgmma.  Each
   recovery is split into its parts from the master's recovery events,
   the pods' create times and the ranks' log lines (`recovery_split`):
   the master's detection (before the clock opens), then the survivor's
   wait, the relaunch, the process's imports, the model spec and
   rendezvous, the CUDA context, the group join and trainer, the first
   batch with the init and its broadcast, the checkpoint load and the
   first report, which sum to the clock's value.  The phase's seconds
   are printed beside its budget.
19. The model, seq, expert and pipe axes (`parallel_axes`, after
   `kube_cluster`; budget 90 s).  One world of PAR_RANKS = 4 processes on
   cuda:0 (`chip_smoke.py --parallel-rank`; gloo: they share the card)
   runs each part on its own mesh over the one default group (the
   older parts (a)-(c) at BERT-base's widths cut to 6 layers, the ring
   to 2 steps, so that (f)-(h) fit the budget): (a) BERT-base (hidden
   768, L 512, bf16, global batch 16) on model=2 x seq=2 from the init
   this process wrote: 2 steps against this process's one-rank run
   (PAR_LOSS_RTOL), 2 ring blocks a layer of flash forwards and
   backwards a step a rank on `sm90_wgmma`, the token table's shard, a
   predict and a checkpoint; then one ring of 2 blocks at a rank's
   shape (16, 256, 12x64) against the plain ring body (twice TOL /
   BWD_TOL: each block's partial is rounded to bf16); (b) BERT-base with
   4 experts on data=2 x expert=2 (2 experts a rank), 3 steps on one
   batch whose loss falls, and layer_0's MoE on seeded tokens against
   the one-rank layer with its experts gathered (PAR_MOE_TOL); (c)
   BERT-base with 4 microbatches on data=2 x pipe=2 (3 layers a stage):
   the logits and the step-1 gradients against the gathered model run
   sequentially on rank 0 (PAR_LOGITS_TOL, PAR_PIPE_TOL); (d) DeepFM at
   the bench's vocab on data=2 x model=2 (2^19 rows of each table a
   rank), 4 steps against one rank (DP_F32_TOL, DP_LOSS_RTOL), 2
   scatter-adds a step a rank, and the kernel against its plain version
   at the shard's ids (bitwise, on CPU copies); (e) (a)'s step restored
   on one rank in this process, its logits against the ranks'
   (PAR_LOGITS_TOL); (f) DeepFM at the bench's width with int8 arenas
   on data=2 x model=2, 4 steps against one rank (DP_LOSS_RTOL), every
   fold replayed whole on each rank and equal bit for bit, the carrier
   zero after it; then on data=1 x model=4, the gathered state bit for
   bit the one-rank run's; (g) the tiered DeepFM with a 2^20-row cache,
   fp32 and int8, a vocabulary past the cache (planned once by this
   process), 3 steps of REAL_BATCH zipf(1.2) rows on data=2 x model=2
   (against one rank, DP_LOSS_RTOL) and on data=1 x model=4 (the
   gathered state, cache tables and host tier bit for bit one rank's):
   every plan equal on every rank and one rank, each rank admitting its
   sub-plan, evictions every step, hit rate and prepare ms; (h)
   BERT-base (12 layers) with 4 experts on seq=2 x expert=2, 3 steps
   against one rank (PAR_LOSS_RTOL), and layer_0's MoE at a capacity
   that drops tokens against the one-rank layer (PAR_MOE_TOL; bitwise
   reported).  After the ranks exit this process times the scatter-add
   at (f)'s and (g)'s shards, the flash pair at (h)'s ring block and
   the fold of a shard.  Each part's seconds, host-staging ms a step
   (`collectives.STAGING`) and peak memory a rank are printed with the
   card's name and power limit.

20. The real Kubernetes client (`kube_cluster`, after `cluster`; budget
   60 s).  A cluster job that goes through the port's REST client only:
   the stub API server (common/k8s_stub_apiserver.py) on 127.0.0.1 over
   TLS with the test-only PEMs of tests/data/k8s_tls/, accepting the
   client certificate alone; `elasticdl train --distribution_strategy
   AllReduce` runs in this process with KUBECONFIG at a JSON kubeconfig
   (the CA and the client certificate and key inline, so they go
   through temporary files) and submits the master pod and its Service;
   the stub's kubelet runs the master entry point, whose default
   `K8sClient` loads the kubeconfig the stub gives its pods and creates
   2 worker pods: DeepFM at the `cluster` phase's bench width (vocab
   2^20, dim 16, bf16 MLP, global batch 8192), 8 tasks of 2 steps, a
   checkpoint every task, two ranks on cuda:0 over gloo.  Once a step
   has committed, this process deletes worker 1's pod through the API
   (the asynchronous writer lets the group run on a few steps before a
   commit shows, so the 16 steps leave the preemption room before the
   job's end):
   MODIFIED with deletionTimestamp, SIGTERM, the exit code, DELETED.
   The master relaunches it, the survivor restarts for the new
   topology, the new group restores and finishes.  Printed and checked:
   the master pod's Succeeded read from this process's watch, every
   training shard done once (the task journal), one recovery (the
   master's event log) under 120 s, 2 scatter-add launches a step in
   each final rank (the survivor may count one cut step more), the API
   requests by verb and path, every one with the client certificate
   over TLS, and the phase's seconds beside its budget.

21. The master's autoscaling loop, live (`autoscale_cluster`, after
   `kube_cluster`; budget 60 s).  DeepFM at the bench width (vocab 2^20,
   dim 16, bf16 MLP, global batch 8192, 32 tasks of 2 steps, a
   checkpoint every task) through the master's entry point over
   ProcessK8sClient, in a process of its own (`--autoscale-master`),
   with one worker, `--min_workers 1 --max_workers 2 --policy_interval
   0.5 --backlog_per_worker 2 --backlog_ticks 2 --scale_hold_ticks 2
   --data_wait_share 1.0` and `--compilation_cache_dir` at a fresh
   directory.  The loop is held at its `policy.tick` fault point until
   the first world has committed a step; then the engine alone decides.
   Checked: one scale_up for the backlog that launched one pod, exit 0
   on a world of two, every shard once, 2 scatter-adds a step in each
   final rank and the kernel bit for bit its plain version at a final
   rank's rows, worker 0's nvcc build into the fresh cache (its
   `kernel_build_scatter_add` seconds) and no build in the added pod or
   the relaunched one.  Printed: the decision's tick, its latency to the
   world of two's first step and first report, the cold build's
   seconds, the card's name and power limit.

22. The train programs as captured CUDA graphs (`graph_steps`, after
   `wire_deepfm`; budget 90 s).  On CUDA a world-of-one Trainer runs
   `train_on_batch`, `train_on_batch_stack` and its timed steps as one
   graph per state and batch shapes (worker/graphs.py; the first call
   at a shape eager, the next captures and replays).  Each check runs
   the same calls on the eager loop (`graphs.eager_loop()`) and as graphs
   from one seed, and holds losses, parameters and buffers,
   Adam's m, v and step, the step count and each kernel's launch count
   bit for bit: (a) DeepFM at the bench shape (vocab 2^20, dim 16, bf16
   MLP, batch 16384) on fp32 arenas, 6 single steps and 3 K=4 stacks;
   (b) the same on int8 arenas (the fold's counter-based draw on a
   device step); (c) the dedup wire at batch 65536, 3 K=8 stacks; (d)
   BERT-base training (batch 64, L 512, bf16), 4 steps without and with
   remat, with the flash forward, flash backward and scatter-add among
   the launches a graph captured.  (e) `aot_compile` of the train step
   at (a)'s and (d)'s signatures (fake tensors on the card's device) must
   count the flops of the eager trainer's first call, and its bytes but
   for the scatter-add's U term (min(N, R) there).  (f) Eager and graph
   ms a step (CUDA events and host wall) and the device's busy share of
   a profiled step for (a) and (d) are printed with the card's name and
   power limit: smoke figures, no claim.  (g) The world-of-one step on
   the graphs' Adam (capturable, float64 step counts) against plain Adam
   on the data-parallel check's data (DeepFM, f32 MLP, 4 batches of
   8192): one step within ADAM_STEP_UNITS ulps, four within DP_F32_TOL
   and DP_LOSS_RTOL; PyTorch's float32 counts and plain Adam with its
   updates shrunk as those counts shrink them are printed beside it.  In
   `parallel_axes` (h) also prints how many token routings chose another
   expert than one rank's run (its steps again on the eager loop, with
   the routers hooked), beside its loss gap.

23. The registered programs that are not train steps, as captured CUDA
   graphs (`graph_programs`, after `graph_steps`; budget 60 s).  Each is
   held bit for bit against its eager version (`graphs.eager_loop()`):
   (a) BERT-base serving (L 512, bf16, buckets 1, 4, 16, 64): `warmup`
   runs each bucket eagerly and captures it, every graph holds 12 flash
   forward launches, and each bucket's replay of a padded request equals
   the eager forward of the same static weights; (b) four client
   threads send requests of 1-64 rows while a hot swap to a second
   generation lands among them: every response equals the eager forward
   of the generation its step names, and the swap captured nothing and
   kept the static tensors' addresses; (c) DeepFM serving at the bench
   shape (vocab 2^20, dim 16, bf16 MLP), fp32 and int8 arenas, each
   bucket's replay against the eager forward, and 3 rows sent with
   native ids and uint24-packed (`packed_feature_spec`): the packed
   signature captures its own bucket graph, and its predictions equal
   the native ones bit for bit; (d) `worker_eval_step` as
   a graph for DeepFM at batch 16384 and BERT-base at batch 64 (12 flash
   forwards inside its graph), and the AUC of local_deepfm's checkpoint
   evaluated by a Local `evaluate` job through eval graphs and with
   them off: the same value; (e) the tiered seam at 2^20 cache rows,
   batch 16384: 3 plans of distinct ids fill the cache (the third
   evicts), then 4 zipf(1.2) plans; every read and admit on the graphed
   state is mirrored on a second state on the eager loop, and the read
   rows, planes, carriers and Adam moments are equal after each call,
   fp32 and int8; (f) eager and graph ms per BERT-base and DeepFM
   serving bucket and per eval step (CUDA events, median of 10), with
   the device's busy share of one call of the largest bucket and of
   each eval step, beside the card's name and power limit: smoke
   figures, no claim.  The phase's seconds are printed beside its
   budget.

24. The evaluation service's off-lock exact pass (`eval_exact`, after
   `local_deepfm`; budget 30 s).  262,144 validation records in 8
   shards of 32,768 (the port's `write_dataset`), and an `evaluate` job
   from the command line's parser on local_deepfm's step-32 checkpoint
   with two workers, whose reports race at the master.  The master's
   merged set passes `INLINE_EXACT_ROWS` after half the tasks, so the
   later exact passes run off the service lock.  The job must fail no
   task, score every row once, and give an AUC in [0.79, 0.86] that
   equals, within 1e-6, the port's numpy AUC of one pass of the restored
   model's forward over the same rows on the card; its version must be
   marked exact, and at least one pass must have run off the lock.  The
   part prints the off-lock passes, the racing retries, the longest hold
   of the service lock (timed by wrapping the lock: `TimedLock`), the
   passes' ms and its seconds beside its budget, with the card.

25. The JAX package's orbax checkpoints (`orbax_restore`, after
   `serve_cli_bert`; budget 30 s), read with no orbax, tensorstore or
   zstd package from tests/torch_fixtures/orbax/ (written by the JAX
   package on the CPU: tests/torch_fixtures/make_orbax_fixtures.py).
   (a) The C++ zstd decoder, built from hostsrc/zstd_decode.cc, and the
   Python one give the same bytes on every zstd frame of both fixtures;
   each one's MB/s on the host is printed with the card.  (b) Fixture
   (a), Wide & Deep at the zoo's width (vocab 4096, dim 8) at step 8,
   copied to the work directory, restores through
   --checkpoint_dir_for_init: an `evaluate` job's owner predicts the 256
   records of synthetic_census(256, seed=7) within 1e-5 of the JAX
   package's recorded logits, then a `train` job takes 4 steps on the
   recorded batches (synthetic_census(256, seed=9), batch 64) with the
   JAX losses within 5e-5 and the scatter-add kernel launched on each
   step (its count joins the kernels line).  (c) `serve --checkpoint_dir`
   on it answers over the socket within 1e-5 of the in-process
   predictions.  (d) Fixture (b), DeepFM with the int8 arena (vocab 4096,
   dim 16) at step 2, serves 64 rows within 1e-4 of the recorded
   predictions.  The C++ decoder must have decoded every frame of the
   restores.  The phase's seconds are printed beside its budget.

Exits non-zero on any failure; nothing is caught.  Without CUDA it exits
1 before printing any result.  The line before the last is the `kernels`
JSON; the last is {"ok": true, "device": {...}}.  The measured numbers,
with each phase's wall seconds, also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from elasticdl_tpu_torch.client import api  # noqa: E402
from elasticdl_tpu_torch.client import main as cli  # noqa: E402
from elasticdl_tpu_torch.common import events  # noqa: E402
from elasticdl_tpu_torch.common import ocdbt, zstd  # noqa: E402
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
    pack_int_to_uint24,
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
from elasticdl_tpu_torch.ops import launches as ops_launches  # noqa: E402
from elasticdl_tpu_torch.ops import scatter_add as sa  # noqa: E402
from elasticdl_tpu_torch.serving.batcher import (  # noqa: E402
    OK,
    DynamicBatcher,
)
from elasticdl_tpu_torch.common.save_utils import (  # noqa: E402
    ArenaDtypeMismatch,
    CheckpointSaver,
    committed_steps,
    gathered_state,
    read_produced_meta,
)
from elasticdl_tpu_torch.common.weights import (  # noqa: E402
    gather_tensor,
    shard_tree,
)
from elasticdl_tpu_torch.common.slo import (  # noqa: E402
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
from elasticdl_tpu_torch.common.k8s_client import ProcessK8sClient  # noqa: E402,E501
from elasticdl_tpu_torch.common.constants import PodStatus  # noqa: E402
from elasticdl_tpu_torch.common.k8s_client import K8sClient  # noqa: E402
from elasticdl_tpu_torch.common.k8s_stub_apiserver import (  # noqa: E402
    StubApiServer,
    write_kubeconfig,
)
from elasticdl_tpu_torch.master import main as master_main  # noqa: E402
from elasticdl_tpu_torch.master import (  # noqa: E402
    evaluation_service as eval_service_lib,
)
from elasticdl_tpu_torch.master.freshness import FreshnessTracker  # noqa: E402,E501
from elasticdl_tpu_torch.parallel import collectives  # noqa: E402
from elasticdl_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from elasticdl_tpu_torch.worker import spmd as spmd_lib  # noqa: E402
from elasticdl_tpu_torch.worker import graphs as graphs_lib  # noqa: E402
from elasticdl_tpu_torch.common import programs as programs_lib  # noqa: E402,E501
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
from elasticdl_tpu_torch.online import (  # noqa: E402
    OnlineConfig,
    OnlinePipeline,
)
from elasticdl_tpu_torch.proto import messages as pb  # noqa: E402
from elasticdl_tpu_torch.proto import serving as spb  # noqa: E402
from elasticdl_tpu_torch.proto.service import ServingStub  # noqa: E402
from elasticdl_tpu_torch.serving.engine import (  # noqa: E402
    ServingEngine,
    build_state_template,
    packed_feature_spec,
)
from elasticdl_tpu_torch.serving.reloader import (  # noqa: E402
    CheckpointReloader,
)
from elasticdl_tpu_torch.store import checkpoint as store_ckpt  # noqa: E402
from elasticdl_tpu_torch.store import device as store_device  # noqa: E402
from elasticdl_tpu_torch.store.serving import (  # noqa: E402
    TieredServingEngine,
)
from elasticdl_tpu_torch.traffic import (  # noqa: E402
    TrafficConfig,
    TrafficGenerator,
    router_request_fn,
)
from elasticdl_tpu_torch.serving.server import (  # noqa: E402
    from_tensor_proto,
    make_predict_request,
)
from elasticdl_tpu_torch.worker.task_data_service import (  # noqa: E402
    prefetch_batches,
)
from elasticdl_tpu_torch.worker.trainer import Trainer, TrainState  # noqa: E402,E501
from elasticdl_tpu_torch.worker.trainer import _to_device  # noqa: E402

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
    """Least time for the kernel's work on this card: the bytes it must
    move over HBM and its products over the peak rate of the input type,
    from `ops/flash_attention.py::attention_cost`, the count the program
    registry charges the kernel's custom op."""
    flops, nbytes = fa.attention_cost(q.shape, k.shape, q.element_size(),
                                      causal, backward=backward)
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
    """Least time for the scatter-add on this card, from
    `ops/scatter_add.py::scatter_cost` (the count the program registry
    charges the kernel's custom op): its bytes over HBM, its adds over
    the f32 rate."""
    flops, nbytes = sa.scatter_cost(n, dim, touched)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
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
    elementwise passes (LayerNorm, GELU, casts, residuals).  Where the
    step runs as a captured graph whose shape has run before, the graph
    is captured first, so the profiled call is a replay (whose named
    ranges, Python, do not run: they read None)."""
    from torch.profiler import ProfilerActivity, profile

    # where the step is a graph, its capture runs now, not in the trace
    trainer.capture_step(state, batch)
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
        step = torch.tensor(state.step, device=device)
        summary["fold_ms"] = time_ms(
            lambda: fold_quantized_updates(state.model, step), 10)
    if launches != 2 * steps or not torch.isfinite(losses).all():
        raise AssertionError(
            f"wire_deepfm {fmt}: {launches} scatter-add launches in "
            f"{steps} steps (2 arenas x {steps} = {2 * steps}), losses "
            f"{losses.tolist()}")
    del staged, state, trainer
    torch.cuda.empty_cache()
    return summary, losses, launches


# ---- graph_steps: the train programs as captured CUDA graphs ---------------

GRAPH_BUDGET_S = 90.0
# single-step calls of each check: the eager first call, the capture and
# its replay, then replays
GRAPH_CALLS = 6
# K-step calls: eager, capture + replay, replay
GRAPH_STACK_CALLS = 3
GRAPH_STACK_K = 4
GRAPH_DEDUP_K = 8
# BERT-base: eager, capture + replay, 2 replays
GRAPH_BERT_CALLS = 4


def _scatter_cost_recorder():
    """Wrap the scatter-add's cost in the program registry: each charged
    call appends (abstract, touched rows U, D) to the list returned (an
    abstract call counts U = min(N, R)); the second value unwraps."""
    calls = []
    cost = programs_lib._KERNEL_COSTS[sa.OP_SCATTER_ADD]

    def recorded(table, ids, grads):
        abstract = programs_lib.is_abstract(ids)
        touched = (min(ids.numel(), table.shape[0]) if abstract
                   else int(torch.unique(ids).numel()))
        calls.append((abstract, touched, int(table.shape[1])))
        return cost(table, ids, grads)

    programs_lib._KERNEL_COSTS[sa.OP_SCATTER_ADD] = recorded
    return calls, lambda: programs_lib._KERNEL_COSTS.__setitem__(
        sa.OP_SCATTER_ADD, cost)


def _adam_tensors(state) -> list:
    return [v for p in state.model.parameters()
            for v in state.optimizer.state.get(p, {}).values()
            if isinstance(v, torch.Tensor)]


def graph_vs_eager(label: str, make_trainer, sample, calls: list,
                   scatter_calls: list) -> dict:
    """The same calls (("one", batch) -> train_on_batch, ("stack",
    batches) -> train_on_batch_stack) on an eager trainer and on one that
    runs graphs, from one seed: losses, parameters and buffers, Adam's
    m, v and step, and the step count must be equal bit for bit, and
    each kernel's launch count too.  Returns the comparison, the per
    call CUDA-event ms and host wall ms, and (per mode) the trainer and
    state for later use."""
    runs = {}
    for mode in ("eager", "graph"):
        trainer = make_trainer()
        state = trainer.init_state(SEED, sample)
        torch.cuda.synchronize()
        before = ops_launches.snapshot()
        losses, event_ms, wall_ms, first = [], [], [], None
        for i, (kind, batch) in enumerate(calls):
            loop = (graphs_lib.eager_loop() if mode == "eager"
                    else contextlib.nullcontext())
            n0 = len(scatter_calls)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            with loop:
                if kind == "one":
                    losses.append(trainer.train_on_batch(state, batch)[1]
                                  .reshape(1))
                else:
                    losses.append(trainer.train_on_batch_stack(
                        state, batch)[1])
            end.record()
            end.synchronize()
            wall_ms.append((time.perf_counter() - t0) * 1e3)
            event_ms.append(start.elapsed_time(end))
            if i == 0:
                first = scatter_calls[n0:]
        after = ops_launches.snapshot()
        runs[mode] = {
            "trainer": trainer, "state": state,
            "losses": torch.cat(losses),
            "launches": {k: after[k] - before[k] for k in after
                         if after[k] != before[k]},
            "event_ms": event_ms, "wall_ms": wall_ms,
            "first_call_scatter": first}
    e, g = runs["eager"], runs["graph"]
    es, gs = e["state"], g["state"]
    checks = {
        "losses": bool(torch.equal(e["losses"], g["losses"])),
        "model": all(torch.equal(a, b) for a, b in zip(
            es.model.state_dict().values(), gs.model.state_dict().values())),
        "adam": all(torch.equal(a, b) for a, b in zip(
            _adam_tensors(es), _adam_tensors(gs))) and len(
                _adam_tensors(es)) == len(_adam_tensors(gs)) > 0,
        "step": es.step == gs.step,
        "launches": e["launches"] == g["launches"]}
    graphs = {key[0]: dict(entry.captured.launches) for key, entry in
              gs.graphs.items() if entry.captured is not None}
    out = {"calls": [kind for kind, _ in calls], "steps": es.step,
           "bitwise": checks, "launches": e["launches"],
           "graph_launches": g["launches"],
           "captured_launches_by_program": graphs,
           "event_ms_by_call": {"eager": e["event_ms"],
                                "graph": g["event_ms"]},
           "wall_ms_by_call": {"eager": e["wall_ms"],
                               "graph": g["wall_ms"]}}
    if not all(checks.values()):
        raise AssertionError(f"graph_steps {label}: graph steps differ "
                             f"from eager steps: {checks}; {out}")
    return out, runs


def _per_step(out: dict, calls: slice, k: int = 1) -> dict:
    """Median CUDA-event ms and host wall ms per step over the calls
    `calls` of K steps each (eager: warm calls; graph: replays only)."""
    res = {}
    for mode in ("eager", "graph"):
        ev = out["event_ms_by_call"][mode][calls]
        wall = out["wall_ms_by_call"][mode][calls]
        res[mode] = {"event_ms_per_step": float(np.median(ev)) / k,
                     "wall_ms_per_step": float(np.median(wall)) / k,
                     "event_over_wall": float(np.median(ev))
                     / float(np.median(wall))}
    return res


def _busy(trainer, state, staged, mode: str) -> dict:
    """The profiler's view of one more step (on the eager loop in mode
    "eager", a replay in mode "graph"): its device ms and busy share of
    the host wall."""
    with (graphs_lib.eager_loop() if mode == "eager"
          else contextlib.nullcontext()):
        b = step_breakdown(trainer, state, staged)
    return {k: b[k] for k in ("profiled_wall_ms", "device_ms",
                              "device_busy_share")}


def abstract_vs_counted(label: str, make_trainer, staged, counted: dict,
                        eager_scatter: list, scatter_calls: list) -> dict:
    """`aot_compile` of the train step at `staged`'s signature on a
    fresh trainer (a fake state and batch on the card's device) against
    the counted cost of the eager trainer's first call: equal flops, and
    bytes equal apart from the scatter-add's U term (an abstract call
    counts U = min(N, R))."""
    trainer = make_trainer()
    n0 = len(scatter_calls)
    t0 = time.perf_counter()
    got = trainer.train_step.aot_compile(trainer.abstract_state(),
                                         programs_lib.abstract_like(staged))
    seconds = time.perf_counter() - t0
    abstract = scatter_calls[n0:]
    extra = sum(2 * (ua - ue) * dim * 4 for (_, ua, dim), (_, ue, _)
                in zip(abstract, eager_scatter))
    out = {"seconds": seconds, "abstract_flops": got["cost"]["flops"],
           "abstract_bytes": got["cost"]["bytes accessed"],
           "counted_flops": counted["flops"],
           "counted_bytes": counted["bytes"], "scatter_u_term": extra,
           "libraries": got["libraries"],
           "kernel_calls": got["kernel_calls"],
           "flops_equal": got["cost"]["flops"] == counted["flops"],
           "bytes_equal_but_u": got["cost"]["bytes accessed"]
           == counted["bytes"] + extra,
           "scatter_calls": [len(abstract), len(eager_scatter)]}
    if not (out["flops_equal"] and out["bytes_equal_but_u"]
            and len(abstract) == len(eager_scatter)):
        raise AssertionError(f"graph_steps {label} aot_compile: {out}")
    return out


# (g) the graphs' Adam against plain Adam.  One step from one state:
# every element within ADAM_STEP_UNITS units of (its ulp + lr's ulp).
# The two differ in the order of the update's last multiply and divide:
# two roundings of the update and one of the parameter (at most 2.91
# units over 6 steps' first step on the CPU, tests/test_torch_compile.py).
ADAM_STEP_UNITS = 4.0


def _adam_shrink(betas) -> float:
    """The factor by which PyTorch's capturable Adam with float32 step
    counts scales the first update against plain Adam's: its bias
    corrections 1 - beta**t are computed from float32 betas."""
    b1, b2 = betas
    f1, f2 = float(np.float32(b1)), float(np.float32(b2))
    return ((1.0 - f2) / (1.0 - b2)) ** 0.5 * (1.0 - b1) / (1.0 - f1)


def _units(a: torch.Tensor, b: torch.Tensor, lr: float) -> float:
    """max |a - b| in units of (the ulp of |b| + the ulp of lr)."""
    ref = b.abs()
    ulp = torch.nextafter(ref, torch.full_like(ref, float("inf"))) - ref
    unit = ulp + float(np.spacing(np.float32(lr)))
    return float(((a - b).abs() / unit).max())


def adam_vs_plain(card: str, device) -> dict:
    """(g) The world-of-one train step on the graphs' Adam (capturable,
    float64 step counts: `graphs_lib.capturable_adam`) against plain
    Adam on the same data: DeepFM at bench width with an f32 MLP over
    DP_STEPS batches of DP_BATCH (the data-parallel check's), one init.
    After one step every parameter within ADAM_STEP_UNITS; after DP_STEPS
    within DP_F32_TOL, each loss within DP_LOSS_RTOL (the bounds of the
    runs that differ by rounding alone).  Printed beside it, the cause
    of the difference the float64 counts remove: PyTorch's capturable
    Adam as it comes (float32 counts), and plain Adam with every update
    scaled by `_adam_shrink` (the float32 counts' first-step factor)."""
    spec = get_model_spec(ZOO_DIR, DEEPFM, DP_F32_PARAMS)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss,
                      use_bf16=False, device=device)
    batches = [_to_device(b, device) for b in _criteo_batches(
        DP_STEPS, DP_BATCH, seed=DP_SEED)]

    def plain(state):
        return spec.optimizer(list(state.model.parameters()))

    def float32_counts(state):
        opt = plain(state)
        for group in opt.param_groups:
            group["capturable"] = True
        return opt

    def shrunk(state):
        opt = plain(state)
        for group in opt.param_groups:
            group["lr"] *= _adam_shrink(group["betas"])
        return opt

    runs = {}
    for label, make_opt in (("plain", plain), ("graphs", None),
                            ("float32_counts", float32_counts),
                            ("plain_shrunk", shrunk)):
        state = trainer.init_state(SEED, batches[0]["features"])
        if make_opt is not None:
            state.optimizer = make_opt(state)
        losses, first = [], None
        for batch in batches:
            losses.append(float(trainer.train_on_batch(state, batch)[1]))
            if first is None:
                first = {n: p.detach().clone()
                         for n, p in state.model.named_parameters()}
        step_dtype = str(next(iter(state.optimizer.state.values()))[
            "step"].dtype)
        runs[label] = {
            "first": first, "losses": losses, "step_dtype": step_dtype,
            "graphs": sorted(key[0] for key, entry in state.graphs.items()
                             if entry.captured is not None),
            "last": {n: p.detach().clone()
                     for n, p in state.model.named_parameters()}}
        del state
    settings = spec.optimizer([torch.nn.Parameter(torch.zeros(1))]).defaults
    lr = settings["lr"]
    ref = runs["plain"]
    out = {"card": card, "config": DP_F32_PARAMS, "batch": DP_BATCH,
           "steps": DP_STEPS, "lr": lr, "step_units_bound": ADAM_STEP_UNITS,
           "tol": DP_F32_TOL, "loss_rtol": DP_LOSS_RTOL,
           "plain_losses": ref["losses"]}
    for label in ("graphs", "float32_counts", "plain_shrunk"):
        run = runs[label]
        errs = {n: float((run["last"][n] - ref["last"][n]).abs().max())
                for n in ref["last"]}
        out[label] = {
            "step_dtype": run["step_dtype"], "graphs": run["graphs"],
            "one_step_units": max(_units(run["first"][n], ref["first"][n],
                                         lr) for n in ref["first"]),
            "one_step_max_abs": max(float(
                (run["first"][n] - ref["first"][n]).abs().max())
                for n in ref["first"]),
            "max_abs_err": max(errs.values()),
            "max_abs_err_by_tensor": errs,
            # elements a tenth of a full Adam step or more apart
            "elements_off_by_lr_tenth": int(sum(
                int(((run["last"][n] - ref["last"][n]).abs()
                     > lr / 10).sum()) for n in ref["last"])),
            "losses": run["losses"],
            "loss_max_rel_err": max(abs(a - b) / abs(b) for a, b in zip(
                run["losses"], ref["losses"]))}
    out["shrink"] = _adam_shrink(settings["betas"])
    g = out["graphs"]
    print(f"graph_steps adam_vs_plain: graphs' Adam ({g['step_dtype']} "
          f"counts) vs plain after 1 step {g['one_step_units']:.2f} units "
          f"(bound {ADAM_STEP_UNITS}), after {DP_STEPS} "
          f"{g['max_abs_err']:.3g} (tol {DP_F32_TOL}); PyTorch's float32 "
          f"counts {out['float32_counts']['one_step_units']:.2f} units, "
          f"{out['float32_counts']['max_abs_err']:.3g}; plain x "
          f"{out['shrink']:.9f} {out['plain_shrunk']['one_step_units']:.2f}"
          f" units, {out['plain_shrunk']['max_abs_err']:.3g} [{card}]",
          flush=True)
    if not (g["step_dtype"] == "torch.float64" and g["graphs"]
            and g["one_step_units"] <= ADAM_STEP_UNITS
            and g["max_abs_err"] <= DP_F32_TOL
            and g["loss_max_rel_err"] <= DP_LOSS_RTOL):
        raise AssertionError(f"graph_steps adam_vs_plain: {out}")
    return out


def graph_steps(card: str, buffers) -> tuple:
    """The train programs as captured CUDA graphs, each held against the
    eager loop bit for bit: (a) DeepFM at the bench shape (vocab 2^20,
    dim 16, bf16 MLP, batch 16384) on fp32 arenas, single steps and a
    K=4 stack; (b) the same on int8 arenas (the counter-based fold
    draw); (c) the dedup wire at batch 65536, K = 8; (d) BERT-base
    training at batch 64, L 512, bf16, without and with remat, the flash
    forward and backward and the scatter-add counted inside the graphs;
    (e) `aot_compile`'s abstract cost at (a)'s and (d)'s signatures
    against the counted cost of their first eager call; (f) eager and
    graph ms per step and the device's busy share for (a) and (d) (smoke
    figures); (g) `adam_vs_plain`.  Returns (summary, launches by
    path)."""
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    scatter_calls, unwrap = _scatter_cost_recorder()
    out, launches = {}, {}
    try:
        for label, arena in (("deepfm_fp32", ""), ("deepfm_int8", "int8")):
            spec = get_model_spec(ZOO_DIR, DEEPFM, DEEPFM_PARAMS,
                                  arena_dtype=arena)

            def make(spec=spec):
                return Trainer(spec.model, spec.optimizer, spec.loss,
                               use_bf16=True, device=device)

            one = [_to_device(b, device) for b in _criteo_batches(
                GRAPH_CALLS, TIMED_BATCH, seed=11)]
            stack = [[_to_device(b, device) for b in _criteo_batches(
                GRAPH_STACK_K, TIMED_BATCH, seed=12 + i)]
                for i in range(GRAPH_STACK_CALLS)]
            calls = [("one", b) for b in one] + [("stack", b)
                                                  for b in stack]
            row, runs = graph_vs_eager(label, make, one[0]["features"],
                                       calls, scatter_calls)
            row["config"] = DEEPFM_PARAMS + (f";arena_dtype={arena}"
                                             if arena else "")
            row["batch"] = TIMED_BATCH
            # the single steps' calls
            row["per_step"] = _per_step(row, slice(2, GRAPH_CALLS))
            if not arena:
                counted = next(iter(
                    runs["eager"]["trainer"].train_step.counted.values()))
                row["aot"] = abstract_vs_counted(
                    label, make, one[0], counted,
                    runs["eager"]["first_call_scatter"], scatter_calls)
                row["busy"] = {m: _busy(runs[m]["trainer"],
                                        runs[m]["state"], one[0], m)
                               for m in ("eager", "graph")}
            launches[f"graph_steps_{label}"] = row["graph_launches"]
            out[label] = row
            print(json.dumps({f"graph_steps_{label}": {
                k: v for k, v in row.items()
                if not k.endswith("_by_call")}}), flush=True)
            del runs, one, stack, calls
            torch.cuda.empty_cache()

        # (c) the dedup wire, K = 8
        spec = get_model_spec(ZOO_DIR, DEEPFM, DEEPFM_PARAMS)
        fm_zoo._DEDUP_PACKER = DedupPacker()

        def make(spec=spec):
            return Trainer(spec.model, spec.optimizer, spec.loss,
                           use_bf16=True, device=device)

        sizes = np.full(WIRE_BATCH, RECORD_BYTES, np.int64)
        dedup = [_to_device(spec.feed_bulk_dedup(buf, sizes), device)
                 for buf in buffers[:GRAPH_DEDUP_K]]
        row, runs = graph_vs_eager(
            "dedup", make, dedup[0]["features"],
            [("stack", dedup)] * GRAPH_STACK_CALLS, scatter_calls)
        row.update(batch=WIRE_BATCH, k=GRAPH_DEDUP_K, wire="dedup",
                   per_step=_per_step(row, slice(2, None), GRAPH_DEDUP_K))
        launches["graph_steps_dedup"] = row["graph_launches"]
        out["dedup_k8"] = row
        print(json.dumps({"graph_steps_dedup_k8": {
            k: v for k, v in row.items() if not k.endswith("_by_call")}}),
            flush=True)
        del runs, dedup
        torch.cuda.empty_cache()

        # (d) BERT-base, without and with remat
        batch = bert_train_batch()
        for tag, extra in (("plain", ""), ("remat", ";remat=True")):
            params = BERT_PARAMS + ";bf16=True" + extra
            spec = get_model_spec(ZOO_DIR, BERT, params)

            def make(spec=spec):
                return Trainer(spec.model, spec.optimizer, spec.loss,
                               use_bf16=True, device=device)

            staged = _to_device(batch, device)
            row, runs = graph_vs_eager(
                f"bert_{tag}", make, staged["features"],
                [("one", staged)] * GRAPH_BERT_CALLS, scatter_calls)
            captured = row["captured_launches_by_program"].get("step", {})
            row["config"] = params
            row["per_step"] = _per_step(row, slice(2, None))
            counted = next(iter(
                runs["eager"]["trainer"].train_step.counted.values()))
            row["aot"] = abstract_vs_counted(
                f"bert_{tag}", make, staged, counted,
                runs["eager"]["first_call_scatter"], scatter_calls)
            if tag == "plain":
                row["busy"] = {m: _busy(runs[m]["trainer"],
                                        runs[m]["state"], staged, m)
                               for m in ("eager", "graph")}
            need = ("flash_attention_fwd", "flash_attention_bwd",
                    "scatter_add")
            if not all(captured.get(k, 0) > 0 for k in need):
                raise AssertionError(
                    f"graph_steps bert_{tag}: the graph captured "
                    f"launches {captured}; want each of {need}")
            launches[f"graph_steps_bert_{tag}"] = row["graph_launches"]
            out[f"bert_{tag}"] = row
            print(json.dumps({f"graph_steps_bert_{tag}": {
                k: v for k, v in row.items()
                if not k.endswith("_by_call")}}), flush=True)
            del runs, staged
            torch.cuda.empty_cache()

        # (g) the graphs' Adam against plain Adam
        out["adam_vs_plain"] = adam_vs_plain(card, device)
        torch.cuda.empty_cache()
    finally:
        unwrap()
    seconds = time.perf_counter() - t0
    out.update(card=card, seconds=seconds, budget_s=GRAPH_BUDGET_S)
    for label in ("deepfm_fp32", "bert_plain", "bert_remat"):
        per = out[label]["per_step"]
        busy = out[label].get("busy", {})
        print(f"graph_steps {label}: eager "
              f"{per['eager']['event_ms_per_step']:.3f} ms/step (host "
              f"{per['eager']['wall_ms_per_step']:.3f}), graph "
              f"{per['graph']['event_ms_per_step']:.3f} ms/step (host "
              f"{per['graph']['wall_ms_per_step']:.3f}); busy share "
              f"eager {busy.get('eager', {}).get('device_busy_share')} "
              f"graph {busy.get('graph', {}).get('device_busy_share')} "
              f"[{card}]", flush=True)
    print(f"graph_steps phase: {seconds:.1f} s (budget {GRAPH_BUDGET_S} "
          f"s) [{card}]", flush=True)
    return out, launches


# ---- graph_programs: serving, eval and the store seam as graphs ---------

GRAPH_PROGRAMS_BUDGET_S = 60.0
# (f): timed calls per serving bucket and eval step, in each mode
GRAPH_TIMED_REPEATS = 10
# (b): client threads and requests each; the swap lands after the first
# SWAP_CLIENTS responses
SWAP_THREADS = 4
SWAP_REQUESTS = 12
# (d): eager, capture + replay, then replays
EVAL_CALLS = 4
# (e): plans of distinct ids that fill the 2^20-row cache (the third
# evicts), then zipf(1.2) plans that admit and evict
SEAM_FILL_PLANS = 3
SEAM_ZIPF_PLANS = 4


def _in_mode(mode: str):
    return (graphs_lib.eager_loop() if mode == "eager"
            else contextlib.nullcontext())


def _event_call(fn) -> tuple:
    """(fn(), CUDA-event ms, host wall ms) of one call, synced."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def _profiled_call(fn) -> dict:
    """The device's busy share of one synced call (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = _device_ms_by_kernel(prof)
    device_ms = sum(by_kernel.values())
    return {"profiled_wall_ms": wall_ms,
            "device_ms": device_ms if by_kernel else None,
            "device_busy_share": device_ms / wall_ms if by_kernel else None}


def eager_vs_graph_ms(fn, busy: bool = False) -> dict:
    """Median CUDA-event ms and host wall ms of GRAPH_TIMED_REPEATS calls
    of fn on the eager loop and as graphs (the graphs captured already),
    and with `busy` the device's busy share of one more call of each."""
    out = {}
    for mode in ("eager", "graph"):
        with _in_mode(mode):
            fn()
            runs = [_event_call(fn)[1:] for _ in range(GRAPH_TIMED_REPEATS)]
            out[mode] = {"event_ms": float(np.median([r[0] for r in runs])),
                         "wall_ms": float(np.median([r[1] for r in runs]))}
            if busy:
                out[mode].update(_profiled_call(fn))
    return out


def _replays(runner, program: str) -> int:
    return runner.replays.get(program, 0)


def graph_serve_bert(card: str, device) -> tuple:
    """(a) BERT-base serving as one graph per bucket, each bucket's replay
    against its eager forward bit for bit, the flash forward counted
    inside the graphs; (b) a hot swap in the middle of the traffic; (f)
    eager and graph ms per bucket.  Returns (summary, flash launches)."""
    spec = get_model_spec(ZOO_DIR, BERT, BERT_PARAMS + ";bf16=True")
    model = spec.model.to(device)
    init_parameters(model, torch.Generator(device=device).manual_seed(
        SEED + 20))
    gen_a = {n: p.detach() for n, p in model.named_parameters()}
    feature_spec = feature_meta(
        {"input_ids": np.zeros((1, SEQ_LEN), np.int32)})
    rng = np.random.RandomState(SEED + 21)

    def ids(rows, r=rng):
        return {"input_ids": r.randint(0, VOCAB, (rows, SEQ_LEN)).astype(
            np.int32)}

    # ---- the main path: counts start at 0 here ----
    reset_counts()
    engine = ServingEngine(model, gen_a, step=0, feature_spec=feature_spec,
                           buckets=BUCKETS, device=device)
    warm = fa.flash_attention.launches
    captured = {str(e.captured.static["input_ids"].shape[0]):
                e.captured.launches for e in engine.graphs.values()
                if e.captured is not None}
    want_graph = {"flash_attention_fwd": NUM_LAYERS,
                  f"flash_attention_fwd.{fa.SM90_WGMMA}": NUM_LAYERS}
    runner = engine._graphs
    # (a) each bucket, a padded request: a replay against the eager
    # forward of the same static weights
    by_bucket = {}
    for b in BUCKETS:
        rows = max(1, b - 1)
        x = ids(rows)
        r0, n0 = _replays(runner, "serving_forward"), \
            fa.flash_attention.launches
        got, _ = engine.predict(x, rows)
        replay_launches = fa.flash_attention.launches - n0
        with graphs_lib.eager_loop():
            want, _ = engine.predict(x, rows)
        by_bucket[str(b)] = {
            "rows": rows, "bitwise": bool(np.array_equal(got, want)),
            "replayed": _replays(runner, "serving_forward") - r0,
            "replay_launches": replay_launches}
    # (b) a hot swap between two generations in the middle of traffic
    other = get_model_spec(ZOO_DIR, BERT, BERT_PARAMS + ";bf16=True").model
    other = other.to(device)
    init_parameters(other, torch.Generator(device=device).manual_seed(
        SEED + 22))
    gen_b = {n: p.detach() for n, p in other.named_parameters()}
    keep_a = {k: v.clone() for k, v in engine.variables.items()}
    graphs_before = {k: id(e.captured) for k, e in engine.graphs.items()}
    ptrs = [t.data_ptr() for t in engine.variables.values()]
    results, errors, lock = [], [], threading.Lock()

    def client(c):
        r = np.random.RandomState(SEED + 30 + c)
        try:
            for _ in range(SWAP_REQUESTS):
                rows = int(r.randint(1, BUCKETS[-1] + 1))
                x = ids(rows, r)
                preds, step = engine.predict(x, rows)
                with lock:
                    results.append((x, rows, preds, step))
        except BaseException as exc:     # re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SWAP_THREADS)]
    for t in threads:
        t.start()
    wait_until(lambda: len(results) >= SWAP_THREADS or errors, 120,
               "traffic before the swap")
    t_swap = time.perf_counter()
    engine.swap(gen_b, 1)
    swap_s = time.perf_counter() - t_swap
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    # ---- end of the main path ----
    graphs_after = {k: id(e.captured) for k, e in engine.graphs.items()}
    own = {}
    for step, gen in ((0, keep_a), (1, gen_b)):
        engine.swap(gen, step)
        with graphs_lib.eager_loop():
            own[step] = [bool(np.array_equal(
                engine.predict(x, rows)[0], preds))
                for x, rows, preds, s in results if s == step]
    swap = {"requests": len(results),
            "by_step": {str(s): len(v) for s, v in own.items()},
            "all_equal_own_step": all(all(v) for v in own.values()),
            "swap_s": swap_s,
            "recaptured": graphs_before != graphs_after,
            "static_addresses_kept":
                [t.data_ptr() for t in engine.variables.values()] == ptrs}
    # (f) eager and graph ms per bucket
    timing = {str(b): eager_vs_graph_ms(
        lambda x=ids(b), b=b: engine.predict(x, b), busy=b == BUCKETS[-1])
        for b in BUCKETS}
    out = {"warm_launches": warm, "captured_launches_by_bucket": captured,
           "by_bucket": by_bucket, "hot_swap": swap, "ms_by_bucket": timing,
           "launches": launches, "card": card}
    print(json.dumps({"graph_programs_serve_bert": out}), flush=True)
    ok = (warm == NUM_LAYERS * len(BUCKETS)
          and sorted(captured, key=int) == [str(b) for b in BUCKETS]
          and all(v == want_graph for v in captured.values())
          and all(v["bitwise"] and v["replayed"] == 1
                  and v["replay_launches"] == NUM_LAYERS
                  for v in by_bucket.values())
          and swap["all_equal_own_step"] and not swap["recaptured"]
          and swap["static_addresses_kept"]
          and all(swap["by_step"].get(s) for s in ("0", "1"))
          and swap["requests"] == SWAP_THREADS * SWAP_REQUESTS)
    if not ok:
        raise AssertionError(f"graph_programs (a)/(b) BERT serving: {out}")
    del engine, model, other, gen_a, gen_b, keep_a
    return out, launches


PACKED_ROWS = 3          # a request that pads to bucket 4
PACKED_CALLS = 3         # eager, capture and replay, replay


def packed_vs_native(engine, features: dict) -> dict:
    """The same rows with native int32 ids and uint24-packed
    (`packed_feature_spec`): the packed signature's bucket runs as its
    own captured graph, and every packed prediction must equal the
    native one bit for bit (the ids unpack exactly on the card)."""
    x = {k: v[:PACKED_ROWS] for k, v in features.items()}
    packed = {**x, "sparse": pack_int_to_uint24(x["sparse"])}
    spec = packed_feature_spec(engine.feature_spec)
    native, _ = engine.predict(x, PACKED_ROWS)
    r0 = _replays(engine._graphs, "serving_forward")
    got = [engine.predict(packed, PACKED_ROWS)[0]
           for _ in range(PACKED_CALLS)]
    return {"rows": PACKED_ROWS,
            "valid": engine.validate(packed) is None
            and spec["sparse"] == {"shape": [NUM_SPARSE, 3],
                                   "dtype": "uint8"},
            "bitwise": all(np.array_equal(native, p) for p in got),
            "replayed": _replays(engine._graphs, "serving_forward") - r0,
            "captures": dict(engine._graphs.captures)}


def graph_serve_deepfm(device) -> dict:
    """(c) DeepFM serving at the bench shape (vocab 2^20, dim 16, bf16
    MLP), fp32 and int8 arenas: each bucket's replay against the eager
    forward bit for bit; (f) eager and graph ms per bucket (fp32)."""
    out = {}
    for label, arena in (("fp32", ""), ("int8", "int8")):
        spec = get_model_spec(ZOO_DIR, DEEPFM, DEEPFM_PARAMS,
                              arena_dtype=arena)
        batch = _criteo_batches(1, BUCKETS[-1], seed=31)[0]
        state = Trainer(spec.model, spec.optimizer, spec.loss,
                        use_bf16=True, device=device).init_state(
                            SEED, batch["features"])
        fspec = feature_meta({k: v[:1] for k, v in
                              batch["features"].items()})
        engine = ServingEngine(spec.model, state.model.state_dict(), step=0,
                               feature_spec=fspec, buckets=BUCKETS,
                               device=device)
        del state
        runner = engine._graphs
        rows = {}
        for b in BUCKETS:
            x = {k: v[:b] for k, v in batch["features"].items()}
            r0 = _replays(runner, "serving_forward")
            got, _ = engine.predict(x, b)
            with graphs_lib.eager_loop():
                want, _ = engine.predict(x, b)
            rows[str(b)] = {"bitwise": bool(np.array_equal(got, want)),
                            "replayed": _replays(runner, "serving_forward")
                            - r0}
        row = {"by_bucket": rows,
               "captures": dict(runner.captures),
               "int8_planes": sorted(k for k in engine.variables
                                     if k.endswith((".q8", ".scale")))}
        if not arena:
            row["ms_by_bucket"] = {str(b): eager_vs_graph_ms(
                lambda b=b: engine.predict(
                    {k: v[:b] for k, v in batch["features"].items()}, b))
                for b in BUCKETS}
        out[label] = row
        print(json.dumps({f"graph_programs_serve_deepfm_{label}": row}),
              flush=True)
        if not (all(v["bitwise"] and v["replayed"] == 1
                    for v in rows.values())
                and row["captures"] == {"serving_forward": len(BUCKETS)}
                and bool(row["int8_planes"]) == bool(arena)):
            raise AssertionError(f"graph_programs (c) DeepFM {label}: {row}")
        row["packed"] = packed_vs_native(engine, batch["features"])
        print(json.dumps({f"graph_programs_serve_deepfm_{label}_packed":
                          row["packed"]}), flush=True)
        if not (row["packed"]["valid"] and row["packed"]["bitwise"]
                and row["packed"]["replayed"] == PACKED_CALLS - 1):
            raise AssertionError(f"graph_programs (c) DeepFM {label} "
                                 f"packed ids: {row['packed']}")
        del engine
        torch.cuda.empty_cache()
    return out


def graph_eval_steps(device) -> tuple:
    """(d) `worker_eval_step` as a graph: DeepFM at batch 16384 and
    BERT-base at batch 64, L 512, each call's predictions against the
    eager loop's bit for bit, BERT's flash forward counted inside the
    graph; (f) eager and graph ms and the busy share.  Returns (summary,
    the BERT eval's flash launches)."""
    out, launches = {}, 0
    cases = (
        ("deepfm", DEEPFM, DEEPFM_PARAMS, [
            b["features"] for b in _criteo_batches(EVAL_CALLS, TIMED_BATCH,
                                                   seed=41)]),
        ("bert", BERT, BERT_PARAMS + ";bf16=True",
         [{"input_ids": np.random.RandomState(SEED + 42 + i).randint(
             0, VOCAB, (TRAIN_BATCH, SEQ_LEN)).astype(np.int32)}
          for i in range(EVAL_CALLS)]))
    for label, model_def, params, feats in cases:
        spec = get_model_spec(ZOO_DIR, model_def, params)
        trainer = Trainer(spec.model, spec.optimizer, spec.loss,
                          use_bf16=True, device=device)
        state = trainer.init_state(SEED, feats[0])
        reset_counts()
        got = [trainer.predict_on_batch(state, f) for f in feats]
        torch.cuda.synchronize()
        n = fa.flash_attention.launches
        with graphs_lib.eager_loop():
            want = [trainer.predict_on_batch(state, f) for f in feats]
        (key, entry), = [(k, e) for k, e in state.graphs.items()
                         if k[0] == "eval"]
        row = {"batch": len(next(iter(feats[0].values()))),
               "bitwise": all(np.array_equal(a, b)
                              for a, b in zip(got, want)),
               "replays": _replays(trainer._graphs, "eval"),
               "captures": trainer._graphs.captures.get("eval", 0),
               "captured_launches": entry.captured.launches,
               "flash_launches": n,
               "ms": eager_vs_graph_ms(
                   lambda: trainer.predict_on_batch(state, feats[0]),
                   busy=True)}
        out[label] = row
        print(json.dumps({f"graph_programs_eval_{label}": row}), flush=True)
        flash = row["captured_launches"].get("flash_attention_fwd", 0)
        if not (row["bitwise"] and row["captures"] == 1
                and row["replays"] == EVAL_CALLS - 1
                and flash == (NUM_LAYERS if label == "bert" else 0)
                and n == (EVAL_CALLS * NUM_LAYERS if label == "bert"
                          else 0)):
            raise AssertionError(f"graph_programs (d) eval {label}: {row}")
        if label == "bert":
            launches = n
        del trainer, state, entry
        torch.cuda.empty_cache()
    return out, launches


def graph_eval_auc(card: str, served: dict) -> dict:
    """(d) The AUC of an eval round of the Local DeepFM job's checkpoint
    (its `evaluate` job) through eval graphs and on the eager loop (the
    trainer's `eval_graph_ok` off): the same value."""
    out = {}
    # the Trainer class the Local job builds
    real_ok = api.Trainer.eval_graph_ok
    for mode in ("graph", "eager"):
        if mode == "eager":
            api.Trainer.eval_graph_ok = lambda self, state, features: False
        try:
            t0 = time.perf_counter()
            ev = api.run_local(cli.parse_args(local_argv(
                "evaluate", "--validation_data", served["val_dir"],
                "--checkpoint_dir_for_init", served["ckpt"])), "evaluate")
            wall = time.perf_counter() - t0
        finally:
            api.Trainer.eval_graph_ok = real_ok
        runner = ev.owner.trainer._graphs
        out[mode] = {"exit_code": ev.exit_code,
                     "auc": (ev.metrics or {}).get("auc"), "wall_s": wall,
                     "eval_captures": runner.captures.get("eval", 0),
                     "eval_replays": runner.replays.get("eval", 0)}
        del ev
    out["card"] = card
    out["job_auc"] = served["auc"]
    print(json.dumps({"graph_programs_eval_auc": out}), flush=True)
    g, e = out["graph"], out["eager"]
    if not (g["exit_code"] == e["exit_code"] == 0 and g["auc"] is not None
            and g["auc"] == e["auc"] and g["eval_replays"] > 0
            and e["eval_captures"] == e["eval_replays"] == 0):
        raise AssertionError(f"graph_programs (d) eval AUC: {out}")
    return out


def _seam_equal(a, b) -> bool:
    """Cache planes, every model tensor and the moments of two states."""
    if not all(torch.equal(x, y) for x, y in zip(
            a.model.state_dict().values(), b.model.state_dict().values())):
        return False
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        ma, mb = a.optimizer.state.get(p, {}), b.optimizer.state.get(q, {})
        if ma.keys() != mb.keys() or not all(
                torch.equal(ma[k], mb[k]) for k in ma):
            return False
    return True


def graph_seam(device, cache_dtype: str) -> dict:
    """(e) The tiered seam at tiered_deepfm (b)'s shape (2^20 cache rows,
    batch 16384): plans that fill the cache with distinct ids, then
    zipf(1.2) plans.  Each plan is applied through the store on a state
    whose admits and eviction reads run as graphs, and every seam call
    is mirrored on a second state on the eager loop: equal read rows,
    cache planes, carriers and Adam moments after every call."""
    spec = get_model_spec(ZOO_DIR, TIERED,
                          tiered_params(REAL_CACHE, cache_dtype))
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, use_bf16=True,
                      device=device)
    store = tiered_zoo.build_tiered_store()
    stream = zipf_stream(SEED + 43)
    first = next(stream)
    sample = dict(first["features"])
    sample["slots"] = np.zeros_like(sample.pop("sparse"), dtype=np.int32)
    states = {m: trainer.init_state(SEED, sample) for m in ("graph", "eager")}
    # one step on each, eagerly, so the moments an admit zeroes exist
    with graphs_lib.eager_loop():
        for state in states.values():
            trainer.train_on_batch(state, {"features": sample,
                                           "labels": first["labels"]})
    g, e = states["graph"], states["eager"]
    calls = {"read": [], "admit": []}
    orig = (store_device.read_rows, store_device.apply_admissions)

    def read(state, paths, slots, cache_dtype="float32"):
        got = orig[0](state, paths, slots, cache_dtype=cache_dtype)
        with graphs_lib.eager_loop():
            want = orig[0](e, paths, slots, cache_dtype=cache_dtype)
        calls["read"].append((int(np.asarray(slots).size), all(
            np.array_equal(got[k], want[k]) for k in want)))
        return got

    def admit(state, paths, slots, values, cache_dtype="float32"):
        out = orig[1](state, paths, slots, values, cache_dtype=cache_dtype)
        with graphs_lib.eager_loop():
            orig[1](e, paths, slots, values, cache_dtype=cache_dtype)
        calls["admit"].append((int(np.asarray(slots).size),
                               _seam_equal(g, e)))
        return out

    runners = {p: store_device._graphs(device, p)
               for p in ("store_gather", "store_admit")}
    before = {p: (dict(r.captures), dict(r.replays))
              for p, r in runners.items()}
    n_ids = REAL_BATCH * NUM_SPARSE
    store_device.read_rows, store_device.apply_admissions = read, admit
    try:
        t0 = time.perf_counter()
        for i in range(SEAM_FILL_PLANS + SEAM_ZIPF_PLANS):
            if i < SEAM_FILL_PLANS:
                sparse = np.arange(i * n_ids, (i + 1) * n_ids,
                                   dtype=np.int64).reshape(REAL_BATCH,
                                                           NUM_SPARSE)
            else:
                sparse = next(stream)["features"]["sparse"]
            _, plan = store.prepare(sparse)
            store.apply_plan(g, plan)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        store_device.read_rows, store_device.apply_admissions = orig
    graphs = {p: {"captures": r.captures.get(p, 0)
                  - before[p][0].get(p, 0),
                  "replays": r.replays.get(p, 0) - before[p][1].get(p, 0)}
              for p, r in runners.items()}
    row = {"cache_dtype": cache_dtype, "plans": SEAM_FILL_PLANS
           + SEAM_ZIPF_PLANS, "seconds": seconds,
           "reads": [n for n, _ in calls["read"]],
           "admits": [n for n, _ in calls["admit"]],
           "reads_equal": all(ok for _, ok in calls["read"]),
           "admits_equal": all(ok for _, ok in calls["admit"]),
           "graphs": graphs, "final_equal": _seam_equal(g, e)}
    print(json.dumps({f"graph_programs_seam_{cache_dtype}": row}),
          flush=True)
    if not (row["reads_equal"] and row["admits_equal"]
            and row["final_equal"] and len(calls["read"]) >= 2
            and len(calls["admit"]) == row["plans"]
            and all(v["captures"] >= 1 and v["replays"] >= 1
                    for v in graphs.values())):
        raise AssertionError(f"graph_programs (e) seam {cache_dtype}: "
                             f"{row}")
    del states, g, e, store, trainer
    torch.cuda.empty_cache()
    return row


def graph_programs(card: str, served: dict) -> tuple:
    """The registered programs that are not train steps, as captured
    CUDA graphs, each held against its eager version (`eager_loop()`)
    bit for bit: (a) BERT-base serving per bucket, (b) a hot swap in its
    traffic, (c) DeepFM serving fp32 and int8, (d) `worker_eval_step`
    for DeepFM and BERT-base and a Local eval round's AUC, (e) the tiered
    seam's admits and gathers fp32 and int8; (f) eager and graph ms.
    Returns (summary, flash launches by path)."""
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    out, launches = {}, {}
    out["serve_bert"], launches["graph_programs_serve_bert"] = \
        graph_serve_bert(card, device)
    torch.cuda.empty_cache()
    out["serve_deepfm"] = graph_serve_deepfm(device)
    out["eval"], launches["graph_programs_eval_bert"] = \
        graph_eval_steps(device)
    out["eval_auc"] = graph_eval_auc(card, served)
    out["seam"] = {dtype: graph_seam(device, dtype)
                   for dtype in ("float32", "int8")}
    seconds = time.perf_counter() - t0
    out.update(card=card, seconds=seconds, budget_s=GRAPH_PROGRAMS_BUDGET_S)
    for b, ms in out["serve_bert"]["ms_by_bucket"].items():
        print(f"graph_programs serve_bert bucket {b}: eager "
              f"{ms['eager']['event_ms']:.3f} ms (host "
              f"{ms['eager']['wall_ms']:.3f}), graph "
              f"{ms['graph']['event_ms']:.3f} ms (host "
              f"{ms['graph']['wall_ms']:.3f}) [{card}]", flush=True)
    for label in ("deepfm", "bert"):
        ms = out["eval"][label]["ms"]
        print(f"graph_programs eval_{label}: eager "
              f"{ms['eager']['event_ms']:.3f} ms, graph "
              f"{ms['graph']['event_ms']:.3f} ms; busy share eager "
              f"{ms['eager'].get('device_busy_share')} graph "
              f"{ms['graph'].get('device_busy_share')} [{card}]",
              flush=True)
    print(f"graph_programs phase: {seconds:.1f} s (budget "
          f"{GRAPH_PROGRAMS_BUDGET_S} s) [{card}]", flush=True)
    return out, launches


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


# ---- eval_exact: the evaluation service's off-lock exact pass -------

EVAL_EXACT_BUDGET_S = 30.0
EVAL_EXACT_ROWS = 1 << 18                  # validation records
EVAL_EXACT_SHARDS = 8                      # files of 32,768 records
EVAL_EXACT_SEED = SEED + 2000              # no training shard's seed
EVAL_EXACT_WORKERS = 2
EVAL_EXACT_TOL = 1e-6                      # the job's AUC vs one pass


class TimedLock:
    """A lock, taken with `with`, that keeps how long each hold lasted
    and which thread holds it now: the evaluation service's lock, read
    from outside."""

    def __init__(self):
        self._lock = threading.Lock()
        self.holds_s = []
        self.owner = None
        self._since = 0.0

    def __enter__(self):
        self._lock.acquire()
        self.owner = threading.get_ident()
        self._since = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.holds_s.append(time.perf_counter() - self._since)
        self.owner = None
        self._lock.release()


@contextlib.contextmanager
def eval_service_probe():
    """Inside, each EvaluationService built gets a TimedLock, and each
    exact scoring made without that lock (an off-lock pass) is timed and
    counted against the publish attempt that made it: a publish that
    scores more than once retried after a racing ingest.  Yields the
    probe's record."""
    cls = eval_service_lib.EvaluationService
    real_init, real_publish = cls.__init__, cls._publish_exact
    real_exact = eval_service_lib._exact_metrics
    probe = {"locks": [], "pass_ms": [], "publishes": 0, "retries": 0}
    guard = threading.Lock()
    mine = threading.local()

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        self._lock = TimedLock()
        probe["locks"].append(self._lock)

    def exact(*args):
        t0 = time.perf_counter()
        out = real_exact(*args)
        ms = (time.perf_counter() - t0) * 1e3
        if probe["locks"] and \
                probe["locks"][-1].owner != threading.get_ident():
            mine.passes = getattr(mine, "passes", 0) + 1
            with guard:
                probe["pass_ms"].append(ms)
        return out

    def publish(self, *args):
        mine.passes = 0
        real_publish(self, *args)
        with guard:
            probe["publishes"] += 1
            probe["retries"] += max(0, mine.passes - 1)

    cls.__init__, cls._publish_exact = init, publish
    eval_service_lib._exact_metrics = exact
    try:
        yield probe
    finally:
        cls.__init__, cls._publish_exact = real_init, real_publish
        eval_service_lib._exact_metrics = real_exact


def eval_exact(card: str, work: str, served: dict) -> dict:
    """An `evaluate` job from local_deepfm's step-32 checkpoint over
    2^18 validation records in 8 shards, two workers reporting to one
    master, whose exact AUC passes over more than INLINE_EXACT_ROWS
    merged rows run off the service lock.  Its AUC must equal one pass
    of the restored model's forward over the same rows, batch by batch
    as the workers cut them, within EVAL_EXACT_TOL, lie in AUC_BAND and
    be marked exact; at least one pass ran off the lock.  Budget
    EVAL_EXACT_BUDGET_S."""
    t0 = time.perf_counter()
    tmp = os.path.join(work, "eval_exact")
    # the 8 shards are write_dataset's training files; its one-record
    # validation file is not read
    data_dir, _ = write_dataset(
        tmp, n_train=EVAL_EXACT_ROWS, n_val=1, seed=EVAL_EXACT_SEED,
        shards=EVAL_EXACT_SHARDS)
    write_s = time.perf_counter() - t0
    args = cli.parse_args(local_argv(
        "evaluate", "--validation_data", data_dir,
        "--checkpoint_dir_for_init", served["ckpt"],
        "--num_workers", str(EVAL_EXACT_WORKERS)))
    with eval_service_probe() as probe:
        # ---- the path: counts start at 0 here ----
        fa.reset_launch_counts()
        sa.scatter_add.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ev = api.run_local(args, "evaluate")
        torch.cuda.synchronize()
        job_s = time.perf_counter() - t1
        launches = {"scatter_add": sa.scatter_add.launches,
                    "flash_attention_fwd": fa.flash_attention.launches}
        # ---- end of the path ----
    service = ev.master.evaluation_service
    lock, = probe["locks"]
    version = max(service.history)
    job_auc = service.history[version].get("auc")
    counters = ev.master.task_manager.counters.as_dict()
    # one pass of the restored model over the same rows
    t2 = time.perf_counter()
    per_shard = EVAL_EXACT_ROWS // EVAL_EXACT_SHARDS
    labels, preds = [], []
    for i in range(EVAL_EXACT_SHARDS):
        dense, sparse, y = synthetic_criteo(per_shard,
                                            seed=EVAL_EXACT_SEED + i)
        for lo in range(0, per_shard, AUC_BATCH):
            hi = lo + AUC_BATCH
            preds.append(ev.owner.predict_batch({"features": {
                "dense": dense[lo:hi], "sparse": sparse[lo:hi]}}))
        labels.append(y)
    single_auc = auc(np.concatenate(labels), np.concatenate(preds))
    single_s = time.perf_counter() - t2
    shutil.rmtree(tmp)
    seconds = time.perf_counter() - t0
    out = {
        "card": card, "rows": EVAL_EXACT_ROWS, "shards": EVAL_EXACT_SHARDS,
        "workers": EVAL_EXACT_WORKERS, "exit_code": ev.exit_code,
        "counters": counters, "version": version,
        "exact": version in service._history_exact,
        "sample_rows": service._aggs[version].sample_rows,
        "auc": job_auc, "single_pass_auc": single_auc,
        "auc_gap": None if job_auc is None else abs(job_auc - single_auc),
        "tol": EVAL_EXACT_TOL, "band": AUC_BAND,
        "inline_exact_rows": eval_service_lib.INLINE_EXACT_ROWS,
        "off_lock_passes": len(probe["pass_ms"]),
        "publishes": probe["publishes"],
        "racing_retries": probe["retries"],
        "pass_ms_max": max(probe["pass_ms"], default=None),
        "pass_ms_mean": (float(np.mean(probe["pass_ms"]))
                         if probe["pass_ms"] else None),
        "lock_holds": len(lock.holds_s),
        "lock_hold_ms_max": max(lock.holds_s, default=0.0) * 1e3,
        "launches": launches, "write_s": write_s, "job_s": job_s,
        "single_pass_s": single_s, "seconds": seconds,
        "budget_s": EVAL_EXACT_BUDGET_S}
    del ev
    print(json.dumps({"eval_exact": out}), flush=True)
    print(f"eval_exact: {out['off_lock_passes']} off-lock passes "
          f"({out['racing_retries']} racing retries), longest lock hold "
          f"{out['lock_hold_ms_max']:.3f} ms, pass {out['pass_ms_max']} ms "
          f"max; {seconds:.1f} s (budget {EVAL_EXACT_BUDGET_S} s) "
          f"[{card}]", flush=True)
    if out["exit_code"] != 0 or counters["failed"] != 0:
        raise AssertionError(f"eval_exact: the job failed: {out}")
    if counters["by_type"].get(1) != EVAL_EXACT_ROWS // \
            LOCAL_RECORDS_PER_TASK or out["sample_rows"] != EVAL_EXACT_ROWS:
        raise AssertionError(f"eval_exact: expected every row scored once: "
                             f"{out}")
    if job_auc is None or out["auc_gap"] > EVAL_EXACT_TOL or \
            not AUC_BAND[0] <= job_auc <= AUC_BAND[1]:
        raise AssertionError(f"eval_exact: AUC {job_auc} against one pass "
                             f"{single_auc} (tol {EVAL_EXACT_TOL}), band "
                             f"{AUC_BAND}: {out}")
    if not out["exact"] or out["off_lock_passes"] < 1:
        raise AssertionError(f"eval_exact: no exact value published off "
                             f"the lock: {out}")
    if any(launches.values()):
        raise AssertionError(f"eval_exact: a DeepFM forward launches no "
                             f"kernel of the port: {launches}")
    return out


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
    hold = FaultRegistry([FaultSpec(faults.POINT_RPC_GET_TASK, CRASH_HOLD_HIT,
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
# `seconds`: a program_compiled event's compile wall time
WALL_FIELDS = ("ts", "pid", "capture_s", "write_s", "seconds")
# (b): the Local judgment job's loops and the freshness drill
JUDGE_INTERVAL_S = 0.5
# A Local job serves nothing: the ratio SLOs read `ok` over the fleet
# router's request counters, which exist at zero once proto/service.py
# is imported (the JAX package's Local job judges them the same way),
# and the others have no series.
JUDGMENT_SLO_STATES = {"staleness_p99": "no_data", "fleet_skew": "no_data",
                       "predict_availability": "ok",
                       "predict_shed_ratio": "ok"}
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
            summary["slo_states"] != JUDGMENT_SLO_STATES or \
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


# ---- 17. the online loop ---------------------------------------------

ONLINE_CHAOS_SEED = 20260805     # bench.py::bench_online's chaos seed
ONLINE_TRAFFIC_SEED = 20260807   # bench.py::bench_traffic's seed
ONLINE_CLOCK_STEP_S = 0.125      # the fake clock's step per read
ONLINE_CHAOS_TICKS = 12
ONLINE_WINDOWS = 8               # the sustained loop's windows
ONLINE_LOAD_CLIENTS = 2
ONLINE_LOAD_ROWS = (1, 2, 4)
ONLINE_TRAFFIC_TICKS = 44
ONLINE_CAPACITY_PER_TICK = 12    # requests a replica serves a tick
ONLINE_SPIKE_AT_TICK = 8         # the generator's first 5x tick
ONLINE_UP_TICKS = 2              # the serving policy's scale-up streak
ONLINE_BUDGET_S = 30.0
ONLINE_RECONCILE_PCT = 5.0
# Card against CPU, final parameters of the chaos replay from the same
# initial weights: ctr_mlp in f32 (TF32 off), 48 Adam steps at lr 1e-2
# over 16-row batches.  The two devices order their f32 sums differently
# (cuBLAS against MKL), a few ulp a step, and Adam divides each update
# by sqrt(v) + 1e-8, so a gap on a parameter whose gradient is near 0
# can grow by up to lr a step.  A correct run's gap on the H100 is
# ~1e-5; a wrong batch or step moves parameters by ~1e-2.
ONLINE_PARAM_TOL = 1e-3
ONLINE_CHAOS_KEEP = ("window", "tasks", "records", "step",
                     "shard", "from_worker", "to_worker",
                     "window_id", "phase", "reason", "at_unix_s",
                     "ingest_unix_s")
ONLINE_TRAFFIC_KEEP = ("action", "reason", "tick", "requested", "replicas",
                       "slo", "state")


def fake_clock(start: float):
    """A clock that steps ONLINE_CLOCK_STEP_S on every read, as bench.py's
    online drivers do; `clk[0]` is its last reading."""
    clk = [start]

    def clock():
        clk[0] += ONLINE_CLOCK_STEP_S
        return clk[0]

    return clock, clk


def lineage_reconciliation(records) -> dict:
    """bench.py::_lineage_reconciliation: over the completed windows
    that were not dropped, the p99 of the phase sums against the p99 of
    the measured ingest -> first-serve times."""
    done = [r for r in records if r.get("complete") and not r.get("dropped")]
    if not done:
        return {"windows": 0, "phase_sum_p99_s": 0.0, "e2e_p99_s": 0.0,
                "delta_pct": 0.0, "within_5pct": True,
                "max_abs_delta_s": 0.0}
    sums = np.array([sum(r["phases"].values()) for r in done])
    e2e = np.array([r["e2e_s"] for r in done])
    p99_sum = float(np.percentile(sums, 99))
    p99_e2e = float(np.percentile(e2e, 99))
    delta_pct = abs(p99_sum - p99_e2e) / p99_e2e * 100.0 if p99_e2e else 0.0
    return {"windows": len(done),
            "phase_sum_p99_s": round(p99_sum, 6),
            "e2e_p99_s": round(p99_e2e, 6),
            "delta_pct": round(delta_pct, 3),
            "within_5pct": delta_pct <= ONLINE_RECONCILE_PCT,
            "max_abs_delta_s": round(float(np.max(np.abs(sums - e2e))), 6)}


def online_params(pipe) -> dict:
    return {k: v.detach().cpu().clone()
            for k, v in pipe.state.model.state_dict().items()}


@contextlib.contextmanager
def carried_init(init=None):
    """Around an OnlinePipeline's construction: the trainer's initial
    parameters are copied into `init` (a dict, filled on the first
    draw), or, when `init` holds them already, loaded from it.  The card
    and the CPU draw different numbers from one seed, so a run compared
    with another device starts from the first run's weights."""
    init = {} if init is None else init
    original = Trainer.init_state

    def init_state(self, rng, sample_features):
        state = original(self, rng, sample_features)
        if init:
            state.model.load_state_dict(init)
        else:
            init.update({k: v.detach().cpu().clone()
                         for k, v in state.model.state_dict().items()})
        return state

    Trainer.init_state = init_state
    try:
        yield init
    finally:
        Trainer.init_state = original


def online_chaos_run(seed: int, device: str, root=None, init=None):
    """bench.py::_online_chaos_run through the port, on `device`: a fake
    clock, a sequential driver, four scheduled faults (stream.poll,
    task.rearm, serving.reload, store.shard_handoff), a replica kill, two
    trainer kills (the second retries the deferred move) and, at tick 7,
    a master restart with one window mid-flight and the reader's buffers
    wiped.  Returns (canonical text, summary, final parameters): the
    text is the fault trace, the fleet's and the SLO evaluator's
    decisions, the normalized event stream and the completed lineage
    decompositions, bench.py's projection.  `init` carries initial
    parameters in or out (carried_init)."""
    clock, clk = fake_clock(1_000_000.0)
    registry = faults.install(FaultRegistry(schedule=[
        FaultSpec(faults.POINT_STREAM_POLL, 2, "raise"),
        FaultSpec(faults.POINT_TASK_REARM, 3, "raise"),
        FaultSpec(faults.POINT_SERVING_RELOAD, 2, "raise"),
        # the first handoff (trainer 2's shard) defers; the second
        # kill's evacuation retries and completes it
        FaultSpec(faults.POINT_STORE_SHARD_HANDOFF, 1, "raise"),
    ], seed=seed))
    norm_events = []

    def observe(record):
        norm_events.append({
            "event": record.get("event"),
            **{k: record[k] for k in ONLINE_CHAOS_KEEP if k in record}})

    events.add_observer(observe)
    rng = np.random.RandomState(seed)
    failed = 0
    restart_at = None
    try:
        spec = get_model_spec(ZOO_DIR, CTR)
        with tempfile.TemporaryDirectory(dir=root) as tmp, \
                carried_init(init):
            pipe = OnlinePipeline(
                tmp, spec,
                OnlineConfig(seed=seed, window_records=64,
                             records_per_poll=64, records_per_task=16,
                             checkpoint_every_windows=2, replicas=2,
                             workers=3, num_shards=4),
                clock=clock, device=device)
            try:
                for i in range(ONLINE_CHAOS_TICKS):
                    if i == 7:
                        # one of the window's 4 tasks trained, the
                        # buffers wiped, the master restarted: the
                        # replacement re-arms the 3 undone shards and
                        # replays the wiped window from the source
                        pipe.tick(max_train_tasks=1)
                        wiped = pipe.drop_window_buffers()
                        restart_at = clk[0]
                        restored = pipe.restart_master()
                        faults.note(
                            "master.restart",
                            "windows=%d tasks=%d buffers_wiped=%d" % (
                                restored["windows_restored"],
                                restored["tasks_rearmed"], wiped))
                    else:
                        pipe.tick()
                    if i == 3:
                        pipe.kill_replica(1)
                        faults.note("replica.kill", "replica=1")
                    if i == 4:
                        info = pipe.kill_worker(2)
                        faults.note("trainer.kill",
                                    "worker=2 handoffs=%d" % info["handoffs"])
                    if i == 9:
                        info = pipe.kill_worker(1)
                        faults.note("trainer.kill",
                                    "worker=1 handoffs=%d" % info["handoffs"])
                    for _ in range(2):
                        x = ctr_zoo.encode(rng.randint(0, 512, 2),
                                           rng.randint(0, 128, 2))
                        resp = pipe.predict(make_predict_request(x))
                        if resp.code != spb.SERVING_OK:
                            failed += 1
                # drain the restart's re-armed remainder
                pipe.tick()
                snap = pipe.snapshot()
                lineage_records = pipe.lineage.records()
                # open windows too: a replayed window still waiting for
                # its reload must carry its original ingest stamp
                all_lineage = lineage_records + \
                    pipe.lineage.open_decompositions()
                params = online_params(pipe)
            finally:
                pipe.shutdown()
    finally:
        events.remove_observer(observe)
        faults.uninstall()

    canonical = json.dumps({
        "fault_trace": registry.trace_text(),
        "fleet_decisions": snap["serving_fleet"]["decisions"],
        "slo_decisions": snap["slo"]["decisions"],
        "events": norm_events,
        "lineage": lineage_records,
    }, sort_keys=True)
    online = snap["online"]
    replayed = [r for r in all_lineage if r.get("replayed")]
    summary = {
        "all_faults_fired": registry.all_fired(),
        "failed_requests": failed,
        "rearm_faults": online["rearm_faults"],
        "poll_faults": snap["stream"]["poll_faults"],
        "last_reload_step": online["last_reload_step"],
        "windows_trained": snap["windows_trained"],
        "handoffs": online["handoffs"],
        "pending_handoffs": online["pending_handoffs"],
        "handoff_faults": snap["store"]["handoff_faults"],
        "windows_released": online["windows_released"],
        "windows_lost": online["windows_lost"],
        "duplicate_reports": online["duplicate_reports"],
        "master_restarts": online["master_restarts"],
        "alive_trainers": online["alive_trainers"],
        "replayed_windows": snap["stream"]["replayed_windows"],
        "lineage_windows": snap["lineage"]["windows_traced"],
        "lineage_replayed": len(replayed),
        "lineage_dominant_phase": snap["lineage"]["dominant_phase"],
        "lineage_reconcile": lineage_reconciliation(lineage_records),
        # replay re-buffers records; it never re-bases the attribution
        "replayed_original_ingest": (
            restart_at is not None and bool(replayed)
            and all(r.get("ingest_unix_s") is not None
                    and float(r["ingest_unix_s"]) < restart_at
                    for r in replayed)),
    }
    return canonical, summary, params


def check_online_chaos(summary: dict) -> None:
    bad = {k: summary[k] for k in ("windows_lost", "duplicate_reports",
                                   "failed_requests") if summary[k]}
    if bad or not summary["all_faults_fired"] \
            or not summary["lineage_reconcile"]["within_5pct"] \
            or not summary["replayed_original_ingest"] \
            or summary["windows_trained"] != ONLINE_CHAOS_TICKS:
        raise AssertionError(f"the online chaos replay: {summary}")


def online_sustained(device: str, root=None) -> dict:
    """bench.py::bench_online's sustained loop on a real clock:
    ONLINE_WINDOWS stream windows trained, checkpointed and rolled onto the replicas
    while ONLINE_LOAD_CLIENTS threads send rows of 1, 2 or 4 through the
    router.  Each replica answers one request of each bucket before the
    clock starts (its engine warmed its buckets when it was built)."""
    spec = get_model_spec(ZOO_DIR, CTR)
    cfg = OnlineConfig(window_records=64, records_per_poll=64,
                       records_per_task=16, checkpoint_every_windows=2,
                       replicas=2)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        pipe = OnlinePipeline(tmp, spec, cfg, device=device)
        try:
            warm = np.random.RandomState(SEED)
            for rows in (1, 2, 4, 8) * cfg.replicas:
                x = ctr_zoo.encode(warm.randint(0, cfg.source_users, rows),
                                   warm.randint(0, cfg.source_items, rows))
                if pipe.predict(make_predict_request(x)).code \
                        != spb.SERVING_OK:
                    raise AssertionError("warm-up predict failed")
            stop = threading.Event()
            latencies, failures = [], []
            lock = threading.Lock()

            def run_load(seed):
                rng = np.random.RandomState(seed)
                mine = []
                while not stop.is_set():
                    n = ONLINE_LOAD_ROWS[rng.randint(len(ONLINE_LOAD_ROWS))]
                    x = ctr_zoo.encode(rng.randint(0, cfg.source_users, n),
                                       rng.randint(0, cfg.source_items, n))
                    t0 = time.perf_counter()
                    try:
                        resp = pipe.predict(make_predict_request(x))
                        bad = None if resp.code == spb.SERVING_OK \
                            else f"code {int(resp.code)}: {resp.error}"
                    except Exception as exc:   # counted, and fails below
                        bad = repr(exc)
                    dt = time.perf_counter() - t0
                    if bad is None:
                        mine.append(dt)
                    else:
                        with lock:
                            failures.append(bad)
                with lock:
                    latencies.extend(mine)

            threads = [threading.Thread(target=run_load, args=(i,))
                       for i in range(ONLINE_LOAD_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            ticks = 0
            try:
                while pipe._windows_trained < ONLINE_WINDOWS \
                        and ticks < ONLINE_WINDOWS * 4:
                    pipe.tick()
                    ticks += 1
            finally:
                stop.set()
                for t in threads:
                    t.join()
            elapsed = time.perf_counter() - t0
            staleness = pipe.freshness.quantiles()
            snap = pipe.snapshot()
            lineage_records = pipe.lineage.records()
        finally:
            pipe.shutdown()
    lat = np.array(latencies) if latencies else np.array([0.0])
    fleet = snap["serving_fleet"]
    return {
        "device": device,
        "windows_trained": snap["windows_trained"],
        "ticks": ticks,
        "elapsed_s": elapsed,
        "examples_trained": snap["examples_trained"],
        "train_examples_per_s": snap["examples_trained"] / elapsed,
        "served_requests_per_s": len(latencies) / elapsed,
        "requests": len(latencies) + len(failures),
        "p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "failed_requests": len(failures),
        "first_failure": failures[0] if failures else None,
        # distinct checkpoint steps rolled onto replicas behind traffic
        "reload_cycles": len({d["target_step"] for d in fleet["decisions"]
                              if d.get("action") == "reload_step"}),
        "replica_hot_swaps": fleet["reload_steps"],
        "last_reload_step": snap["online"]["last_reload_step"],
        "staleness_p50_steps": staleness["staleness_p50_steps"],
        "staleness_p99_steps": staleness["staleness_p99_steps"],
        "staleness_p50_s": staleness["staleness_p50_s"],
        "staleness_p99_s": staleness["staleness_p99_s"],
        "max_burn_rate": snap["max_burn"],
        "watermark_lag_s": snap["stream"]["watermark_lag_s"],
        "lineage_windows": snap["lineage"]["windows_traced"],
        "lineage_dominant_phase": snap["lineage"]["dominant_phase"],
        "lineage_reconcile": lineage_reconciliation(lineage_records),
    }


class CapacityGate:
    """bench.py's per-tick admission gate in front of a replica: the
    first ONLINE_CAPACITY_PER_TICK requests of a tick pass, the rest
    shed with SERVING_OVERLOADED, as a saturated batcher queue answers."""

    def __init__(self, inner):
        self._inner = inner
        self.used = 0

    def reset(self):
        self.used = 0

    def predict(self, request, timeout=None):
        if self.used >= ONLINE_CAPACITY_PER_TICK:
            return spb.PredictResponse(code=spb.SERVING_OVERLOADED,
                                       error="per-tick capacity exhausted")
        self.used += 1
        return self._inner.predict(request, timeout=timeout)

    def health(self, request, timeout=None):
        return self._inner.health(request, timeout=timeout)


def traffic_spike_run(seed: int, device: str, root=None, keep=None):
    """bench.py::_traffic_spike_run through the port: the seeded traffic
    generator offers a 5x spike to an autoscaling fleet whose replicas
    each serve ONLINE_CAPACITY_PER_TICK requests a tick, under a fake
    clock.
    Returns (canonical text, summary): the offered schedule, the serving
    policy's decisions, the fleet size per tick, the scale and SLO
    events, and the incident bundles.  A `keep` dict receives the
    pipeline's final snapshot and the generator's (the observatory's
    `top` and `slo` render them)."""
    clock, _ = fake_clock(2_000_000.0)
    gates = {}

    def client_wrapper(rid, inner):
        gates[rid] = CapacityGate(inner)
        return gates[rid]

    watched = (events.SERVING_SCALE, events.SLO_BREACH,
               events.SLO_RECOVERED, events.INCIDENT_CAPTURED)
    norm_events = []

    def observe(record):
        if record.get("event") in watched:
            norm_events.append({
                "event": record["event"],
                **{k: record[k] for k in ONLINE_TRAFFIC_KEEP if k in record}})

    events.add_observer(observe)
    try:
        spec = get_model_spec(ZOO_DIR, CTR)
        with tempfile.TemporaryDirectory(dir=root) as tmp:
            incident_dir = os.path.join(tmp, "incidents")
            pipe = OnlinePipeline(
                tmp, spec,
                OnlineConfig(seed=seed, window_records=64,
                             records_per_poll=64, records_per_task=16,
                             checkpoint_every_windows=2, replicas=1,
                             max_serving_replicas=4,
                             serving_up_ticks=ONLINE_UP_TICKS,
                             serving_down_ticks=3,
                             serving_scale_hold_ticks=2,
                             serving_shed_window_s=30.0,
                             backpressure_threshold=0.25,
                             backpressure_stride=4),
                clock=clock, client_wrapper=client_wrapper, device=device)
            recorder = FlightRecorder(incident_dir=incident_dir,
                                      snapshot_fn=pipe.snapshot,
                                      history=pipe.history).install()
            pipe.evaluator.set_on_breach(recorder.breach)

            def encode_fn(rows, payload_seed):
                rng = np.random.RandomState(payload_seed % (2 ** 31))
                return ctr_zoo.encode(rng.randint(0, 512, rows),
                                      rng.randint(0, 128, rows))

            gen = TrafficGenerator(
                router_request_fn(pipe.router, encode_fn),
                TrafficConfig(profile="spike", base_qps=8.0, clients=4,
                              seed=seed, tick_interval_s=1.0,
                              spike_at_tick=ONLINE_SPIKE_AT_TICK,
                              spike_ticks=4,
                              spike_factor=5.0))
            fleet_sizes, pressures = [], []
            try:
                for _ in range(ONLINE_TRAFFIC_TICKS):
                    for gate in gates.values():
                        gate.reset()
                    gen.tick()
                    pipe.tick()
                    fleet_sizes.append(pipe.fleet_manager.live_replicas())
                    pressures.append(pipe._serving_pressure)
                snap = pipe.snapshot()
                traffic = gen.snapshot()
                if keep is not None:
                    keep.update(snapshot=snap, traffic=traffic)
                recorder.flush()
                bundles = (sorted(os.listdir(incident_dir))
                           if os.path.isdir(incident_dir) else [])
                skipped = int(pipe._backpressure_skips.value())
            finally:
                recorder.close()
                pipe.shutdown()
    finally:
        events.remove_observer(observe)

    policy = snap["serving_policy"]
    canonical = json.dumps({
        "schedule": traffic["schedule"],
        "decisions": policy["decisions"],
        "fleet_sizes": fleet_sizes,
        "events": norm_events,
        "bundles": bundles,
    }, sort_keys=True)
    scale_ups = [d["tick"] for d in policy["decisions"]
                 if d["action"] == "scale_up"]
    summary = {
        "offered": traffic["offered"],
        "offered_qps": traffic["offered_qps"],
        "ok": traffic["ok"],
        "shed": traffic["shed"],
        "failed_requests": traffic["failed"],
        "shed_ratio": traffic["shed_ratio"],
        "min_fleet": 1,
        "peak_fleet": max(fleet_sizes),
        "final_fleet": fleet_sizes[-1],
        "scale_ups": snap["serving_fleet"]["scale_ups"],
        "scale_downs": snap["serving_fleet"]["scale_downs"],
        "first_scale_up_tick": scale_ups[0] if scale_ups else None,
        "decisions": len(policy["decisions"]),
        "polls_skipped": snap["backpressure"]["polls_skipped"],
        "backpressure_skipped_polls_total": skipped,
        "peak_pressure": round(max(pressures), 4),
        "incident_bundles": bundles,
        "max_burn_rate": round(snap["max_burn"], 3),
    }
    return canonical, summary


def check_traffic_spike(summary: dict) -> None:
    """Scaled up within the hysteresis after the spike (the policy's
    ticks count from 1, the generator's from 0, so the spike's first
    tick is the policy's ONLINE_SPIKE_AT_TICK + 1 and a streak of
    ONLINE_UP_TICKS acts by their sum), one incident bundle, polls
    skipped under backpressure, and back to the minimum."""
    first = summary["first_scale_up_tick"]
    ok = (summary["peak_fleet"] > summary["min_fleet"]
          and first is not None
          and ONLINE_SPIKE_AT_TICK < first
          <= ONLINE_SPIKE_AT_TICK + ONLINE_UP_TICKS
          and len(summary["incident_bundles"]) == 1
          and summary["backpressure_skipped_polls_total"] > 0
          and summary["final_fleet"] == summary["min_fleet"])
    if not ok:
        raise AssertionError(f"the serving control loop: {summary}")


def online_loop(card: str, work: str) -> dict:
    """(a) the chaos replay on the card twice and on the CPU, texts equal
    byte for byte, final parameters within ONLINE_PARAM_TOL; (b) the
    sustained loop behind live traffic; (c) the serving control loop
    twice.  Budget ONLINE_BUDGET_S."""
    root = os.path.join(work, "online_loop")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    init = {}
    text_a, summary_a, params_a = online_chaos_run(ONLINE_CHAOS_SEED,
                                                   "cuda", root, init)
    text_b, summary_b, _ = online_chaos_run(ONLINE_CHAOS_SEED, "cuda", root)
    # from the card's initial weights
    text_c, summary_c, params_c = online_chaos_run(ONLINE_CHAOS_SEED,
                                                   "cpu", root, init)
    check_online_chaos(summary_a)
    param_err = max(float((params_a[k] - params_c[k]).abs().max())
                    for k in params_a)
    chaos = {"seed": ONLINE_CHAOS_SEED, "card": card,
             "text_bytes": len(text_a),
             "card_rerun_identical": text_a == text_b,
             "card_equals_cpu": text_a == text_c,
             "summaries_equal": summary_a == summary_b == summary_c,
             "param_max_abs_err_vs_cpu": param_err,
             "param_tol": ONLINE_PARAM_TOL, **summary_a}
    a_s = time.perf_counter() - t0
    print(json.dumps({"online_chaos": chaos}), flush=True)
    if not (chaos["card_rerun_identical"] and chaos["card_equals_cpu"]
            and chaos["summaries_equal"]) or param_err > ONLINE_PARAM_TOL:
        raise AssertionError(f"the online chaos replay: {chaos}")

    t1 = time.perf_counter()
    sustained = online_sustained("cuda", root)
    b_s = time.perf_counter() - t1
    sustained["card"] = card
    print(json.dumps({"online_sustained": sustained}), flush=True)
    if sustained["failed_requests"] or sustained["reload_cycles"] < 2 \
            or sustained["windows_trained"] < ONLINE_WINDOWS:
        raise AssertionError(f"the sustained online loop: {sustained}")

    t2 = time.perf_counter()
    # the observatory phase's `top`, `slo` and `lineage` read this run
    surfaces = {"events": []}
    events.add_observer(surfaces["events"].append)
    try:
        spike_a, spike_summary = traffic_spike_run(
            ONLINE_TRAFFIC_SEED, "cuda", root, keep=surfaces)
    finally:
        events.remove_observer(surfaces["events"].append)
    spike_b, _ = traffic_spike_run(ONLINE_TRAFFIC_SEED, "cuda", root)
    spike = {"seed": ONLINE_TRAFFIC_SEED, "card": card,
             "rerun_identical": spike_a == spike_b, **spike_summary}
    c_s = time.perf_counter() - t2
    print(json.dumps({"online_traffic": spike}), flush=True)
    check_traffic_spike(spike_summary)
    if not spike["rerun_identical"]:
        raise AssertionError(f"the serving control loop's rerun: {spike}")
    wall = time.perf_counter() - t0
    line = {"card": card, "wall_s": wall, "budget_s": ONLINE_BUDGET_S,
            "a_s": a_s, "b_s": b_s, "c_s": c_s,
            "chaos": {k: chaos[k] for k in (
                "card_rerun_identical", "card_equals_cpu", "windows_lost",
                "duplicate_reports", "all_faults_fired", "failed_requests",
                "param_max_abs_err_vs_cpu")},
            "chaos_reconcile_delta_pct":
                chaos["lineage_reconcile"]["delta_pct"],
            "train_examples_per_s": sustained["train_examples_per_s"],
            "served_requests_per_s": sustained["served_requests_per_s"],
            "p50_ms": sustained["p50_ms"], "p99_ms": sustained["p99_ms"],
            "staleness_p50_steps": sustained["staleness_p50_steps"],
            "staleness_p99_steps": sustained["staleness_p99_steps"],
            "staleness_p50_s": sustained["staleness_p50_s"],
            "staleness_p99_s": sustained["staleness_p99_s"],
            "max_burn_rate": sustained["max_burn_rate"],
            "reload_cycles": sustained["reload_cycles"],
            "failed_requests": sustained["failed_requests"],
            "first_scale_up_tick": spike["first_scale_up_tick"],
            "peak_fleet": spike["peak_fleet"],
            "final_fleet": spike["final_fleet"],
            "incident_bundles": len(spike["incident_bundles"]),
            "backpressure_skipped_polls_total":
                spike["backpressure_skipped_polls_total"]}
    print(json.dumps({"online_loop": line}), flush=True)
    if wall > ONLINE_BUDGET_S:
        raise AssertionError(f"online_loop took {wall:.1f} s, over its "
                             f"{ONLINE_BUDGET_S} s budget")
    return {"chaos": chaos, "sustained": sustained, "traffic": spike,
            "walls": line, "surfaces": surfaces}


# ---- 18. the program observatory and the operator commands -----------

OBSERVATORY_BUDGET_S = 30.0
# the live ratios against the H100's datasheet peaks must read above 0
# and at most this (a counted cost over the peak is a counting fault)
RATIO_CEILING = 1.05
STORM_BUCKETS = (4, 16)
STORM_ROWS = (1, 3, 5, 7)        # none is a bucket
STORM_CLOCK_STEP_S = 0.001
EXPORT_ROWS = 8
EXPORT_FM_TOL = 1e-4             # tests/test_torch_export.py's DeepFM
EXPORT_BERT_TOL = 2e-3           # and BERT tolerances
EXPORT_RUN_TIMEOUT_S = 300.0
VARZ_POLL_S = 0.1


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def command_output(argv) -> tuple:
    """(exit code, stdout) of one `client.main` command, echoed."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    print(f"$ {' '.join(argv[:1])} ...\n{out}", end="", flush=True)
    return rc, out


def observed_job(card: str, root: str, served: dict) -> dict:
    """(a) local_deepfm's train job with --telemetry_port, --event_log
    and --incident_dir, scraped while it runs: /varz, `programs` and
    `top`; the live mfu and hbm_utilization against the H100's peaks;
    2 scatter-add launches a step; the final state bit for bit
    local_deepfm's; `trace` of its event log."""
    from elasticdl_tpu_torch.client import top as top_cli
    from elasticdl_tpu_torch.client import trace as trace_cli

    ckpt = os.path.join(root, "ckpt")
    log = os.path.join(root, "events.jsonl")
    port = free_port()
    addr = f"127.0.0.1:{port}"
    argv = resilient_argv(
        served["train_dir"], served["val_dir"], "--checkpoint_dir", ckpt,
        "--checkpoint_steps", str(LOCAL_CKPT_STEPS),
        "--keep_checkpoint_max", str(LOCAL_KEEP),
        "--telemetry_port", str(port), "--event_log", log,
        "--incident_dir", os.path.join(root, "incidents"))
    done = {}

    def run():
        try:
            done["job"], done["launches"], done["wall"] = run_counted(
                cli.parse_args(argv))
        except BaseException as exc:   # re-raised below
            done["error"] = exc

    thread = threading.Thread(target=run, name="observed-job")
    thread.start()
    live, scrapes, commands = None, 0, {}
    while thread.is_alive():
        try:
            varz = top_cli.fetch_varz(addr, timeout_s=5.0)
        except OSError:
            time.sleep(VARZ_POLL_S)      # not serving yet, or done
            continue
        scrapes += 1
        programs = varz.get("programs", {})
        if programs.get("mfu", 0) > 0 and \
                "worker_train_step" in programs.get("ledger", {}):
            live = varz
            if not commands:
                # the operator commands against the running job
                commands["programs"] = command_output(["programs", addr])
                commands["top"] = command_output(["top", addr])
        time.sleep(VARZ_POLL_S)
    thread.join()
    events.configure(None)
    if "error" in done:
        raise done["error"]
    job, launches = done["job"], done["launches"]
    summary = job_summary(job, done["wall"], launches, card)
    if live is None:
        raise AssertionError(f"{scrapes} /varz scrapes of the running job, "
                             "none with a live mfu above 0")
    programs = live["programs"]
    step = programs["ledger"]["worker_train_step"]
    counted = list(job.owner.trainer.train_step.counted.values())
    evts = events.read_events(log)
    chrome = os.path.join(root, "trace.json")
    trace_rc, trace_out = command_output(["trace", log, "--chrome", chrome])
    summary_rc, summary_out = command_output(["trace", log, "--summary"])
    with open(chrome) as fh:
        doc = json.load(fh)
    task_slices = sum(1 for e in doc["traceEvents"]
                      if e.get("cat") == "task"
                      and e["name"].startswith("task "))
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e.get("name") == "process_name"}
    summary.update({
        "scrapes": scrapes,
        "mfu": programs["mfu"],
        "hbm_utilization": programs["hbm_utilization"],
        "bytes_per_sec": programs["bytes_per_sec"],
        "worker_train_step": {k: step[k] for k in (
            "signatures", "compiles", "flops_per_execution",
            "bytes_per_execution", "avals")},
        "kernel_builds": sorted(n for n in programs["ledger"]
                                if n.startswith("kernel_build_")),
        "counted_train_calls": counted,
        "commands_rc": {k: rc for k, (rc, _) in commands.items()},
        "task_slices": task_slices,
        "completed_tasks": len(trace_cli.task_durations(evts)),
        "trace_tracks": sorted(tracks),
        "trace_rc": [trace_rc, summary_rc],
        "versus_local_deepfm": state_gap(
            os.path.join(served["ckpt"], str(LOCAL_STEPS), "state.pt"),
            os.path.join(ckpt, str(LOCAL_STEPS), "state.pt"))})
    print(json.dumps({"observatory_programs": {
        "card": card, "worker_train_step": summary["worker_train_step"],
        "mfu": summary["mfu"], "hbm_utilization": summary["hbm_utilization"],
        "bytes_per_sec": summary["bytes_per_sec"],
        "kernel_builds": summary["kernel_builds"]}}), flush=True)
    scatter_counted = [c["kernel_calls"].get(sa.OP_SCATTER_ADD, 0)
                       for c in counted]
    if not 0 < summary["mfu"] <= RATIO_CEILING or \
            not 0 < summary["hbm_utilization"] <= RATIO_CEILING:
        raise AssertionError(f"the live ratios read {summary['mfu']} and "
                             f"{summary['hbm_utilization']}: {summary}")
    if launches != 2 * LOCAL_STEPS or summary["exit_code"] != 0 or \
            not summary["versus_local_deepfm"]["bitwise"]:
        raise AssertionError(f"the observed job: {summary}")
    if step["flops_per_execution"] <= 0 or step["bytes_per_execution"] <= 0 \
            or 2 not in scatter_counted or not summary["kernel_builds"]:
        raise AssertionError(f"the observed job's ledger: {summary}")
    if commands.get("programs", (1,))[0] or commands.get("top", (1,))[0] \
            or "worker_train_step" not in commands["programs"][1] \
            or trace_rc or summary_rc or "programs" not in tracks \
            or task_slices != summary["completed_tasks"] \
            or "program compiles:" not in summary_out:
        raise AssertionError(f"the operator commands on the job: {summary}")
    return {"summary": summary, "job": job}


def bert_base_model(seed: int, device: str = "cuda"):
    spec = get_model_spec(ZOO_DIR, "bert.bert_finetune.custom_model",
                          BERT_PARAMS + ";bf16=True")
    model = spec.model.to(device)
    init_parameters(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval()


def storm_run(model, root: str, device: str = "cuda") -> dict:
    """One run of the storm drill: a BERT-base engine that stopped
    padding to its two buckets, under a fake registry clock, answers
    requests at four sizes that are no bucket; the flight recorder takes
    the registry's storm.  Returns the bundle's files and the flash
    launches."""
    from elasticdl_tpu_torch.common import metrics as metrics_lib
    from elasticdl_tpu_torch.common import programs

    clk = [0.0]

    def clock():
        clk[0] += STORM_CLOCK_STEP_S
        return clk[0]

    registry = programs.ProgramRegistry(
        clock=clock, metrics=metrics_lib.MetricsRegistry())
    recorder = FlightRecorder(incident_dir=root, program_registry=registry)
    variables = {n: p.detach() for n, p in model.named_parameters()}
    feature_spec = feature_meta({"input_ids": np.zeros((1, SEQ_LEN),
                                                       np.int32)})
    rng = np.random.RandomState(SEED)
    ids = rng.randint(0, VOCAB, (max(STORM_ROWS), SEQ_LEN)).astype(np.int32)
    real = programs.default_program_registry
    # ---- the main path: counts start at 0 here ----
    fa.reset_launch_counts()
    programs.default_program_registry = lambda: registry
    try:
        engine = ServingEngine(model, variables, step=0,
                               feature_spec=feature_spec,
                               buckets=STORM_BUCKETS, device=device,
                               pad_to_bucket=False)
    finally:
        programs.default_program_registry = real
    for rows in STORM_ROWS:
        preds, _ = engine.predict({"input_ids": ids[:rows]}, rows)
        if preds.shape != (rows, 2) or not np.isfinite(preds).all():
            raise AssertionError(f"storm drill: bad predictions {preds}")
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    # ---- end of the main path ----
    recorder.close()
    bundles = sorted(os.listdir(root))
    files = {}
    for name in bundles:
        for f in sorted(os.listdir(os.path.join(root, name))):
            with open(os.path.join(root, name, f), "rb") as fh:
                files[f"{name}/{f}"] = fh.read()
    return {"bundles": bundles, "files": files, "launches": launches,
            "forwards": len(STORM_BUCKETS) + len(STORM_ROWS),
            "engine_compiles": engine.compile_count}


def storm_drill(model, root: str, device: str = "cuda") -> dict:
    """(b) the storm drill twice: exactly one recompile_storm bundle
    naming serving_forward, its budget and its signature count, with a
    programs.json, the same bytes both times; `incident` renders it;
    12 flash launches a forward."""
    first = storm_run(model, os.path.join(root, "a"), device)
    second = storm_run(model, os.path.join(root, "b"), device)
    name = "incident-0001-recompile_storm"
    manifest = json.loads(first["files"].get(f"{name}/manifest.json",
                                             b"{}"))
    rc, report = command_output(["incident", os.path.join(root, "a"),
                                 "--bundle", "incident-0001"])
    out = {"bundles": first["bundles"],
           "files": sorted(f.split("/", 1)[1] for f in first["files"]),
           "identical": first["files"] == second["files"],
           "evidence": manifest.get("evidence"),
           "flash_launches": [first["launches"], second["launches"]],
           "forwards": first["forwards"],
           "engine_compiles": first["engine_compiles"],
           "incident_rc": rc}
    print(json.dumps({"observatory_storm": out}), flush=True)
    want = NUM_LAYERS * first["forwards"]
    if out["bundles"] != [name] or not out["identical"] or \
            "programs.json" not in out["files"] or out["evidence"] != {
                "program": "serving_forward", "budget": len(STORM_BUCKETS),
                "signatures": len(STORM_BUCKETS) + 1} or \
            out["flash_launches"] != [want, want] or rc or \
            "recompile_storm" not in report:
        raise AssertionError(f"the storm drill: {out}")
    return out


def start_runner(root: str, work: str, device: str = "cuda") -> dict:
    """(c) the process that runs the exports: started first, it imports
    torch and the kernels' ops (never the zoo) and reaches the card
    while the phase goes on, then runs each export triple it is sent.
    It reads and writes the bytecode cache under `work`."""
    os.makedirs(root, exist_ok=True)
    out = open(os.path.join(root, "runner.out"), "w+")
    err = open(os.path.join(root, "runner.err"), "w+")
    popen_at = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.serving.run_export",
         "--device", device],
        cwd=ROOT, stdin=subprocess.PIPE, stdout=out, stderr=err, text=True,
        env={**os.environ, "PYTHONPATH": ROOT, **bytecode_env(work)})
    return {"proc": proc, "out": out, "err": err, "root": root,
            "device": device, "want": {}, "tols": {}, "export_s": {},
            "popen_at": popen_at, "sent_at": []}


def send_export(runner: dict, name: str, state, feats: dict,
                tol: float) -> None:
    """Export `state`'s model over `feats`, compute its in-process
    forward at EXPORT_ROWS rows and at 3, and send both runs to the
    runner."""
    from elasticdl_tpu_torch.common import export

    root, device = runner["root"], runner["device"]
    t0 = time.perf_counter()
    path = export.export_saved_model(state, os.path.join(root, name), feats)
    runner["export_s"][name] = time.perf_counter() - t0
    runner["tols"][name] = tol
    forward = export.ServingForward(state.model, False)
    state.model.eval()
    for rows in (EXPORT_ROWS, 3):
        part = {k: v[:rows] for k, v in feats.items()}
        stem = os.path.join(root, f"{name}_{rows}")
        np.savez(stem + "_in.npz", **part)
        with torch.no_grad():
            runner["want"][(name, rows)] = forward({
                k: torch.from_numpy(v).to(device) for k, v in part.items()
            }).float().cpu().numpy()
        runner["proc"].stdin.write(
            f"{path} {stem}_in.npz {stem}_out.npz\n")
        runner["proc"].stdin.flush()
        runner["sent_at"].append(time.perf_counter())


def stop_runner(runner: dict, timeout_s: float = 0.0) -> tuple:
    """Close the runner's input, wait up to `timeout_s` for it to end,
    kill it if it has not, and return (its stdout, its stderr)."""
    proc = runner["proc"]
    try:
        proc.stdin.close()
        proc.wait(timeout=timeout_s)
    except (OSError, subprocess.TimeoutExpired):
        pass
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for fh in (runner["out"], runner["err"]):
            fh.seek(0)
        stdout, stderr = runner["out"].read(), runner["err"].read()
        runner["out"].close()
        runner["err"].close()
    return stdout, stderr


def start_bytecode_warmup(work: str) -> dict:
    """The export runner on the CPU with no export to run, started with
    the script: it compiles the modules the observatory's runner imports
    (torch, torch.export and its loader, the kernels' ops) into the
    bytecode cache under `work` (`bytecode_env`) while the kernels build
    and the first phases run.  Without it the runner spends most of the
    observatory compiling torch's sources, which the card's Python ships
    without bytecode; a deployed image carries them compiled."""
    warm = start_runner(os.path.join(work, "bytecode_warmup"), work, "cpu")
    warm["proc"].stdin.close()
    return warm


def finish_bytecode_warmup(warm: dict) -> float:
    """Wait for the warm-up runner to end; its exit code must be 0.
    Returns the seconds waited."""
    t0 = time.perf_counter()
    _, stderr = stop_runner(warm, EXPORT_RUN_TIMEOUT_S)
    if warm["proc"].returncode != 0:
        raise AssertionError("the bytecode warm-up runner failed: "
                             f"{stderr[-4000:]}")
    return time.perf_counter() - t0


def runner_timeline(runner: dict, report: dict, closed_at: float,
                    exited_at: float) -> dict:
    """The runner's life in seconds from its Popen: when its module
    began (`started`: Python up, the package and torch imported), when
    it was ready (`ready`: the card reached, the loader warm), each
    triple's send from this process and its arrival and end there, when
    its input was closed and when it had exited.  Both processes read
    `time.perf_counter`, which on Linux is the one CLOCK_MONOTONIC of
    the machine."""
    t0 = runner["popen_at"]
    return {"started": report["started_at"] - t0,
            "ready": report["ready_at"] - t0,
            "sent": [t - t0 for t in runner["sent_at"]],
            "arrived": [s["arrived_at"] - t0 for s in report["seconds"]],
            "done": [s["done_at"] - t0 for s in report["seconds"]],
            "closed": closed_at - t0, "exited": exited_at - t0}


def finish_runner(runner: dict) -> dict:
    closed_at = time.perf_counter()
    stdout, stderr = stop_runner(runner, EXPORT_RUN_TIMEOUT_S)
    exited_at = time.perf_counter()
    proc = runner["proc"]
    if proc.returncode != 0:
        raise AssertionError(f"the export runner failed: {stderr[-4000:]}")
    report = json.loads(stdout.strip().splitlines()[-1])
    errs = {}
    for (name, rows), want in runner["want"].items():
        got = np.load(os.path.join(runner["root"],
                                   f"{name}_{rows}_out.npz"))["out"]
        if got.shape != want.shape:
            raise AssertionError(f"export {name} at {rows} rows: shape "
                                 f"{got.shape}, in process {want.shape}")
        errs[f"{name}_{rows}"] = float(np.abs(got - want).max())
    out = {"export_s": runner["export_s"], "max_abs_err": errs,
           "tols": runner["tols"],
           "runner_seconds": report["seconds"],
           "runner_timeline_s": runner_timeline(runner, report, closed_at,
                                                exited_at),
           "flash_launches_in_runner": report["flash_launches"],
           "runner_port_modules": len(report["port_modules"]),
           "runner_zoo_modules": [m for m in report["port_modules"]
                                  if ".model_zoo" in m]}
    print(json.dumps({"observatory_export": out}), flush=True)
    want_flash = 2 * NUM_LAYERS        # BERT at EXPORT_ROWS rows and at 3
    if out["runner_zoo_modules"] or \
            out["flash_launches_in_runner"] != want_flash or any(
                err > runner["tols"][key.split("_")[0]]
                for key, err in errs.items()):
        raise AssertionError(f"the torch exports: {out}")
    return out


def loop_surfaces(root: str, surfaces: dict) -> dict:
    """(d) `top`'s online and traffic lines and `slo` over the online
    loop's spike run (its pipeline's snapshot, the live fleet's SLO
    report), `lineage` over its event log."""
    from elasticdl_tpu_torch.client import slo as slo_cli
    from elasticdl_tpu_torch.client import top as top_cli

    snap = surfaces["snapshot"]
    frame = top_cli.render({"snapshot": snap, "metrics": {
        "traffic_offered_per_sec": surfaces["traffic"]["offered_qps"]}})
    report = slo_cli.render_slo(snap["slo"])
    log = os.path.join(root, "online_events.jsonl")
    with open(log, "w") as fh:
        for record in surfaces["events"]:
            fh.write(json.dumps(record, default=str) + "\n")
    rc, lineage_out = command_output(["lineage", log])
    print(frame + "\n" + report, flush=True)
    lines = {line.split(":", 1)[0] for line in frame.splitlines()}
    out = {"top_lines": sorted(lines), "slo_rows": len(snap["slo"]["slos"]),
           "lineage_rc": rc,
           "lineage_head": lineage_out.splitlines()[0] if lineage_out
           else ""}
    if not {"online", "traffic", "fleet"} <= lines or rc or \
            not out["lineage_head"].startswith("windows traced: ") or \
            "stream lag:" not in report:
        raise AssertionError(f"the online loop's surfaces: {out}")
    return out


def observatory(card: str, work: str, served: dict, online: dict,
                warm: dict) -> dict:
    """The program observatory and the operator commands on the card:
    (a) a full-width DeepFM Local job observed while it runs, (b) the
    BERT-base recompile-storm drill, (c) BERT-base and DeepFM torch
    exports run in a process without the zoo, (d) the online loop's
    surfaces.  The runner starts on the bytecode that `warm` compiled
    (waited for first, in the phase's time) and loads the BERT-base
    export, its largest, while this process exports DeepFM.  Budget
    OBSERVATORY_BUDGET_S."""
    root = os.path.join(work, "observatory")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    warm_wait_s = finish_bytecode_warmup(warm)
    runner = start_runner(os.path.join(root, "exports"), work)
    try:
        observed = observed_job(card, os.path.join(root, "job"), served)
        a_s = time.perf_counter() - t0
        job = observed.pop("job")
        t1 = time.perf_counter()
        bert = bert_base_model(SEED)
        ids = np.random.RandomState(SEED + 1).randint(
            0, VOCAB, (EXPORT_ROWS, SEQ_LEN)).astype(np.int32)
        send_export(runner, "bert", TrainState(step=0, model=bert,
                                               optimizer=None),
                    {"input_ids": ids}, EXPORT_BERT_TOL)
        send_export(runner, "deepfm", job.owner.state,
                    {k: np.asarray(v)[:EXPORT_ROWS]
                     for k, v in job.owner.sample_features.items()},
                    EXPORT_FM_TOL)
        c_s = time.perf_counter() - t1
        del job
        t3 = time.perf_counter()
        storm = storm_drill(bert, os.path.join(root, "storm"))
        b_s = time.perf_counter() - t3
        t4 = time.perf_counter()
        surfaces = loop_surfaces(root, online["surfaces"])
        d_s = time.perf_counter() - t4
    except BaseException:
        stop_runner(runner)
        raise
    t5 = time.perf_counter()
    exported = finish_runner(runner)
    runner_wait_s = time.perf_counter() - t5
    del bert
    wall = time.perf_counter() - t0
    summary = observed["summary"]
    line = {"card": card, "wall_s": wall, "budget_s": OBSERVATORY_BUDGET_S,
            "warm_wait_s": warm_wait_s,
            "a_s": a_s, "b_s": b_s, "c_exports_s": c_s, "d_s": d_s,
            "runner_wait_s": runner_wait_s,
            "runner_timeline_s": exported["runner_timeline_s"],
            "mfu": summary["mfu"],
            "hbm_utilization": summary["hbm_utilization"],
            "train_step_flops": summary["worker_train_step"][
                "flops_per_execution"],
            "train_step_bytes": summary["worker_train_step"][
                "bytes_per_execution"],
            "scatter_launches": summary["scatter_launches"],
            "bitwise_vs_local_deepfm":
                summary["versus_local_deepfm"]["bitwise"],
            "storm_identical": storm["identical"],
            "export_max_abs_err": exported["max_abs_err"],
            "export_s": exported["export_s"]}
    print(json.dumps({"observatory": line}), flush=True)
    if wall > OBSERVATORY_BUDGET_S:
        raise AssertionError(f"observatory took {wall:.1f} s, over its "
                             f"{OBSERVATORY_BUDGET_S} s budget")
    return {"job": summary, "storm": storm, "exports": exported,
            "surfaces": surfaces, "walls": line}, \
        summary["scatter_launches"], storm["flash_launches"][0]


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
        # the served generation, copied: a swap overwrites the engine's
        # static tensors in place
        old_vars = {k: v.clone() for k, v in engine.variables.items()}
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



# ---- cluster: the elastic cluster (item 18) ---------------------------------

CLUSTER_BUDGET_S = 75.0
CLUSTER_RANKS = 2
# (a) DeepFM at bench width, data-parallel: global batch, steps
DP_BATCH = 8192
DP_STEPS = 4
DP_SEED = SEED + 11
# the same width with an f32 MLP, for the f32 tolerance below
DP_F32_PARAMS = DEEPFM_PARAMS.replace("bf16=True", "bf16=False")
# World 2 vs world 1 after DP_STEPS Adam steps (f32 parameters).  f32
# MLP: the runs differ only in the order of each gradient's sums (two
# rank partials, then the all-reduce): 1.8e-6 measured on the CPU at
# vocab 2^16, batch 512.  bf16 MLP (the bench configuration): its
# matmuls round to bf16 at 4096 rows instead of 8192, gradients differ
# by ~1e-3 relative, and Adam turns an element near 0 into an update of
# up to lr = 0.005 either way: 2 * lr * DP_STEPS at worst, and each
# step's global loss within DP_LOSS_RTOL.
DP_F32_TOL = 1e-5
DP_BF16_TOL = 2 * 0.005 * DP_STEPS
DP_LOSS_RTOL = 1e-3
# the BERT-base rank timing: global batch of the job below, timed steps
CLUSTER_TIMED_STEPS = 2
# (b) BASELINE.md #5: BERT-base fine-tuning that survives two
# preemptions.  Three groups train in turn: the first and the second each
# commit a checkpoint step and then lose a rank (worker 1, then the pod
# that holds rank 0 of the second group), the third finishes the job.
CLUSTER_BERT_BATCH = 16
CLUSTER_BERT_TASK = 32                      # records a task: 2 steps
CLUSTER_BERT_CKPT_STEPS = 2                 # a commit every task
# 3 tasks, 6 steps: one task for each of the three groups
CLUSTER_BERT_RECORDS = 96
CLUSTER_KILLS = 2
# tasks a group trains between its restore and its next commit
CLUSTER_TASKS_PER_CKPT = (CLUSTER_BERT_CKPT_STEPS * CLUSTER_BERT_BATCH
                          // CLUSTER_BERT_TASK)
# first kill: worker 1's get_spmd_task for the task after the first
# checkpoint step (hits 0-based, one a task) sleeps CLUSTER_HOLD_S, and
# rank 0 waits for it in the next step's all-reduce: that step's
# checkpoint commits while the group holds, so the kill always lands
# mid-job, after a committed step, and no report of the old group can
# close the outage it opens
CLUSTER_HOLD_HIT = CLUSTER_TASKS_PER_CKPT
# second kill: the pods of the second group sleep CLUSTER_HOLD_S in the
# version report of the task that ends at their checkpoint step (two
# report hits a task: the task's, then the version's).  Only rank 0
# reports, so only the victim holds; the task's own report has reached
# the master, and rank 1 waits in the next step's all-reduce
CLUSTER_REPORT_HOLD_HIT = 2 * CLUSTER_TASKS_PER_CKPT - 1
CLUSTER_HOLD_S = 10.0
CLUSTER_RECOVERY_BUDGET_S = 120.0   # tests/test_elastic_cluster.py:401
CLUSTER_WEDGE_GRACE_S = 30.0
CLUSTER_JOB_TIMEOUT_S = 400.0
# the master waits this long at most for its workers to exit after the
# job (the leader flushes its last checkpoint first)
CLUSTER_LINGER_S = 60.0
# the split's parts must account for the recovery clock's value within
# this many seconds (the clock and the events read time.time() apart)
CLUSTER_SPLIT_TOL_S = 0.05


def bytecode_env(work: str) -> dict:
    """The environment that gives a worker process a bytecode cache under
    `work`, shared by the phase's processes: the card's Python writes no
    bytecode (PYTHONDONTWRITEBYTECODE=1) and its site-packages hold
    none, so each new process compiles torch's sources again, where a
    pod's image would carry them compiled."""
    return {"PYTHONPYCACHEPREFIX": os.path.join(work, "pycache"),
            "PYTHONDONTWRITEBYTECODE": ""}


def _rank_rows(batch, start: int, stop: int):
    if isinstance(batch, dict):
        return {k: _rank_rows(v, start, stop) for k, v in batch.items()}
    return batch[start:stop]


def _state_cpu(state) -> dict:
    return {k: v.detach().cpu().clone()
            for k, v in state.model.state_dict().items()}


def cluster_rank(rank: int, work: str, port: int,
                 device: str = "cuda") -> int:
    """One rank of the cluster phase's data-parallel group (a process of
    its own, `chip_smoke.py --cluster-rank R WORK PORT`): (a) DeepFM at
    bench width over DP_STEPS global batches, then BERT-base's timed
    steps and one all-reduce of its gradients; (c) each kernel those
    steps ran, held against its plain version at one step's shapes.
    The counts are read right after each path, before the checks; the
    wall seconds of each part are kept (`seconds`)."""
    seconds, last = {}, [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        seconds[part] = now - last[0]
        last[0] = now

    mesh = mesh_lib.create_mesh(CLUSTER_RANKS, rank, device,
                                f"127.0.0.1:{port}", init_timeout_s=120.0,
                                collective_timeout_s=120.0)
    out = {"rank": rank, "device": str(mesh.device),
           "backend": mesh.backend,
           "device_count": torch.cuda.device_count()
           if device == "cuda" else 0}
    lap("join")
    # (a) DeepFM, the bench configuration (bf16 MLP) and an f32 MLP
    batches = _criteo_batches(DP_STEPS, DP_BATCH, seed=DP_SEED)
    start, stop = mesh_lib.local_batch_range(mesh, DP_BATCH)
    out["deepfm"] = {}
    for label, params, bf16 in (("bf16", DEEPFM_PARAMS, True),
                                ("f32", DP_F32_PARAMS, False)):
        reset_counts()
        state, losses = dp_deepfm(mesh, params, bf16, batches, start, stop)
        out["deepfm"][label] = {"rows": [start, stop], "losses": losses,
                                "launches": spmd_lib.kernel_launches(),
                                "digest": spmd_lib.state_digest(state)}
        if rank == 0:
            torch.save(_state_cpu(state),
                       os.path.join(work, f"dp_{label}_rank0.pt"))
        del state
        torch.cuda.empty_cache()
        lap(f"deepfm_{label}")
    # BERT-base at the cluster job's shapes: step time, all-reduce share
    spec = get_model_spec(ZOO_DIR, BERT, BERT_PARAMS + ";bf16=True")
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, use_bf16=True,
                      device=mesh.device)
    full = bert_train_batch()
    full = _rank_rows(full, 0, CLUSTER_BERT_BATCH)
    bstart, bstop = mesh_lib.local_batch_range(mesh, CLUSTER_BERT_BATCH)
    local = _rank_rows(full, bstart, bstop)
    reset_counts()
    state = trainer.init_state_global(SEED, local["features"], mesh)
    # the init's broadcast of rank 0's state as collectives.broadcast_
    # sends it (one broadcast a tensor), against one flat buffer a dtype
    tensors = list(state.model.state_dict().values())
    broadcast_ms = {"per_tensor": [], "flat_per_dtype": []}
    for _ in range(CLUSTER_TIMED_STEPS):
        for label, fn in (("per_tensor", collectives.broadcast_),
                          ("flat_per_dtype", _flat_broadcast)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(tensors, mesh)
            torch.cuda.synchronize()
            broadcast_ms[label].append((time.perf_counter() - t0) * 1e3)
    shard = mesh_lib.make_global_batch_from_local(
        local, mesh, CLUSTER_BERT_BATCH, bstart, trainer.stage_batch)
    trainer.train_on_global_batch(state, shard, mesh)   # warm-up
    step_ms = []
    for _ in range(CLUSTER_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_on_global_batch(state, shard, mesh)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    bert_launches_rank = spmd_lib.kernel_launches()
    grads = [p.grad.clone() for p in state.model.parameters()
             if p.grad is not None]
    grad_bytes = sum(g.numel() * g.element_size() for g in grads)
    reduce_ms = []
    for _ in range(CLUSTER_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        collectives.all_reduce_sum_(grads, mesh)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    out["bert"] = {"global_batch": CLUSTER_BERT_BATCH, "rows": [bstart,
                                                                bstop],
                   "step_ms": step_ms, "all_reduce_ms": reduce_ms,
                   "grad_bytes": grad_bytes,
                   "all_reduce_share": float(np.median(reduce_ms)
                                             / np.median(step_ms)),
                   "state_tensors": len(tensors),
                   "state_bytes": sum(t.numel() * t.element_size()
                                      for t in tensors),
                   "broadcast_ms": broadcast_ms,
                   "launches": bert_launches_rank}
    del state, trainer, grads, tensors
    torch.cuda.empty_cache()
    lap("bert")
    # (c) the kernels these ranks ran, against their plain versions at
    # one step's shapes (not counted: the counts were read above)
    out["checks"] = rank_kernel_checks(batches[0], start, stop,
                                       bstop - bstart, mesh.device)
    lap("checks")
    out["seconds"] = seconds
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    mesh_lib.destroy_mesh(mesh)
    return 0


def _flat_broadcast(tensors, mesh) -> None:
    """Rank 0's values of `tensors` on every rank, as one flat buffer a
    dtype (the layout collectives.all_reduce_sum_ sends)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=0, group=mesh.group)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def dp_deepfm(mesh, params: str, use_bf16: bool, batches, start: int,
              stop: int) -> tuple:
    """DeepFM over `batches` on this rank's rows [start, stop) of each:
    (state, the global loss of each step)."""
    spec = get_model_spec(ZOO_DIR, DEEPFM, params)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss,
                      use_bf16=use_bf16, device=mesh.device)
    state = trainer.init_state_global(
        SEED, _rank_rows(batches[0], start, stop)["features"], mesh)
    losses = []
    for batch in batches:
        shard = mesh_lib.make_global_batch_from_local(
            _rank_rows(batch, start, stop), mesh, len(batch["labels"]),
            start, trainer.stage_batch)
        state, loss = trainer.train_on_global_batch(state, shard, mesh)
        losses.append(float(loss))
    torch.cuda.synchronize()
    return state, losses


def flash_pair_checks(shape, gen, device) -> list:
    """The flash forward and backward kernels against their plain
    versions at `shape`, bf16 on the model's fused QKV views
    (tolerances TOL / BWD_TOL): one check row each, with "ok"."""
    q, k, v = make_qkv(shape, torch.bfloat16, gen, True)
    fa.reset_launch_counts()
    out_k, lse_k = fa.flash_attention_forward(q, k, v, causal=False)
    variant = [n for n, c in fa.flash_attention.launches_by_kernel.items()
               if c]
    out_r, lse_r = fa.flash_attention_reference(q, k, v, causal=False)
    err = float((out_k.float() - out_r.float()).abs().max())
    rows = [{"kernel": "flash_attention_fwd", "shape": list(shape),
             "variant": variant, "max_abs_err": err,
             "scale": float(out_r.float().abs().max()),
             "ok": variant == [fa.SM90_WGMMA]
             and err <= TOL[torch.bfloat16]["out"]}]
    g = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    got = fa.flash_attention_backward(q, k, v, out_r, lse_r, g, False)
    variant = [n for n, c in
               fa.flash_attention.backward_launches_by_kernel.items() if c]
    want = fa._flash_bwd(False, shape[-1] ** -0.5,
                         (q, k, v, out_r, lse_r), g)
    errs = [float((a.float() - b.float()).abs().max())
            for a, b in zip(got, want)]
    scales = [float(b.float().abs().max()) for b in want]
    tol = BWD_TOL[torch.bfloat16]
    rows.append({"kernel": "flash_attention_bwd", "shape": list(shape),
                 "variant": variant, "max_abs_err": max(errs),
                 "max_abs_err_dq_dk_dv": errs, "scale_dq_dk_dv": scales,
                 "ok": variant == [fa.SM90_WGMMA]
                 and all(e <= tol * max(1.0, s)
                         for e, s in zip(errs, scales))})
    if torch.device(device).type == "cuda":
        # each kernel's CUDA-event ms at this shape (after the checks)
        rows[0]["ms"] = time_ms(lambda: fa.flash_attention_forward(
            q, k, v, causal=False), 10)
        rows[1]["ms"] = time_ms(lambda: fa.flash_attention_backward(
            q, k, v, out_r, lse_r, g, False), 10)
    return rows


def shard_scatter_check(ids_np, first: int, rows: int, dim: int, gen,
                        device) -> dict:
    """The scatter-add kernel against its plain version, bit for bit on
    CPU copies, as a table's lookup hands it a step's ids: `ids_np` are
    rows of the whole table, this rank holds [first, first + rows); ids
    of other shards come as row 0 with zero gradient rows, into a zero
    table (`layers/embedding.py::lookup_rows`, `_Lookup`)."""
    ids = torch.from_numpy(ids_np.reshape(-1).astype(np.int64)) - first
    inside = (ids >= 0) & (ids < rows)
    local = torch.where(inside, ids, 0).to(torch.int32).to(device)
    table = torch.zeros((rows, dim), device=device)
    grads = torch.randn((local.numel(), dim), generator=gen,
                        device=device) * inside.to(device)[:, None]
    got = sa.scatter_add_forward(table, local, grads).cpu()
    ref = sa.scatter_add_reference(table.cpu(), local.cpu(), grads.cpu())
    out = {"kernel": "scatter_add", "rows": rows, "dim": dim,
           "n": int(local.numel()), "inside": int(inside.sum()),
           "max_abs_err": float((got - ref).abs().max()),
           "ok": bool(torch.equal(got, ref))}
    if torch.device(device).type == "cuda":
        # the wrapper (sort, plan, kernel) at these ids, CUDA events
        out["ms"] = time_ms(lambda: sa.scatter_add_forward(
            table, local, grads), 20)
    return out


def rank_kernel_checks(batch, start: int, stop: int, bert_rows: int,
                       device: torch.device):
    """In a rank: the scatter-add at its DeepFM step's rows (D 16 and 1,
    bitwise on CPU copies), the flash forward and backward at its BERT
    step's attention shape (bf16, tolerances TOL / BWD_TOL)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    checks = []
    ids_np = hash_field_rows_host(
        batch["features"]["sparse"][start:stop], DEEPFM_VOCAB).reshape(-1)
    ids = torch.from_numpy(ids_np.astype(np.int32)).to(device)
    for dim in (DEEPFM_DIM, 1):
        table = torch.randn((DEEPFM_VOCAB, dim), generator=gen,
                            device=device)
        grads = torch.randn((ids.numel(), dim), generator=gen,
                            device=device)
        got = sa.scatter_add_forward(table, ids, grads).cpu()
        ref = sa.scatter_add_reference(table.cpu(), ids.cpu(), grads.cpu())
        checks.append({"kernel": "scatter_add", "n": int(ids.numel()),
                       "dim": dim, "bitwise_vs_plain":
                           bool(torch.equal(got, ref)),
                       "max_abs_err": float((got - ref).abs().max())})
    checks.extend(flash_pair_checks((bert_rows, SEQ_LEN, 12, 64), gen,
                                    device))
    fa.reset_launch_counts()
    sa.scatter_add.launches = 0
    return checks


def dp_parity(card: str, work: str, device: str = "cuda") -> dict:
    """(a) two ranks on the card over the backend the rule picks (gloo:
    they share cuda:0), against one rank in this process; then one
    all-reduce of a gradient over a world-1 NCCL group."""
    port = free_port()
    env = dict(os.environ, **bytecode_env(work))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cluster-rank",
         str(rank), work, str(port), device], cwd=ROOT, env=env)
        for rank in range(CLUSTER_RANKS)]
    try:
        # one rank in this process, the same batches and seed, while the
        # ranks start (their DeepFM runs come after their imports and
        # CUDA start-up, so the two overlap little on the card)
        device = mesh_lib.device_for_rank(0, device)
        mesh1 = mesh_lib.DataMesh(1, 0, device, "", None)
        batches = _criteo_batches(DP_STEPS, DP_BATCH, seed=DP_SEED)
        one_rank = {}
        for label, params, bf16 in (("bf16", DEEPFM_PARAMS, True),
                                    ("f32", DP_F32_PARAMS, False)):
            reset_counts()
            state, losses = dp_deepfm(mesh1, params, bf16, batches, 0,
                                      DP_BATCH)
            one_rank[label] = (_state_cpu(state), losses,
                               sa.scatter_add.launches)
            if label == "bf16":
                last_state = state
            del state
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if codes != [0] * CLUSTER_RANKS:
        raise AssertionError(f"cluster ranks exited {codes}")
    ranks = []
    for rank in range(CLUSTER_RANKS):
        with open(os.path.join(work, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    parity = {}
    for label, bf16 in (("bf16", True), ("f32", False)):
        one, losses, one_launches = one_rank.pop(label)
        two = torch.load(os.path.join(work, f"dp_{label}_rank0.pt"))
        errs = {k: float((two[k].float() - one[k].float()).abs().max())
                for k in one if one[k].is_floating_point()}
        err = max(errs.values())
        rank_losses = [r["deepfm"][label]["losses"] for r in ranks]
        parity[label] = {
            "digests_equal": len({r["deepfm"][label]["digest"]
                                  for r in ranks}) == 1,
            "max_abs_err_vs_one_rank": err,
            "max_abs_err_by_tensor": errs,
            "tol": DP_BF16_TOL if bf16 else DP_F32_TOL,
            "losses_by_rank": rank_losses, "losses_one_rank": losses,
            "loss_max_rel_err": max(
                abs(a - b) / abs(b) for a, b in zip(rank_losses[0],
                                                    losses)),
            "scatter_launches_by_rank": [
                r["deepfm"][label]["launches"]["scatter_add"]
                for r in ranks],
            "scatter_launches_one_rank": one_launches}
        del two, one
    # world-1 NCCL: the rule picks nccl for a rank that owns its device;
    # an all-reduce over one rank returns its input bit for bit
    backend = mesh_lib.backend_for(1, device)
    grads = torch.cat([p.grad.reshape(-1) for p in
                       last_state.model.parameters() if p.grad is not None])
    before = grads.clone()
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        dist.all_reduce(grads)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    nccl_equal = bool(torch.equal(grads, before))
    del last_state, grads, before
    out = {"card": card, "ranks": CLUSTER_RANKS, "global_batch": DP_BATCH,
           "steps": DP_STEPS,
           "backend_by_rank": [r["backend"] for r in ranks],
           "device_by_rank": [r["device"] for r in ranks],
           "device_count": ranks[0]["device_count"],
           "deepfm": parity,
           "scatter_launches_by_rank":
               parity["bf16"]["scatter_launches_by_rank"],
           "nccl_world1": {"backend": backend, "bitwise": nccl_equal},
           "bert_step_ms_by_rank": [r["bert"]["step_ms"] for r in ranks],
           "bert_all_reduce_ms_by_rank": [r["bert"]["all_reduce_ms"]
                                          for r in ranks],
           "bert_grad_bytes": ranks[0]["bert"]["grad_bytes"],
           "bert_all_reduce_share_by_rank": [
               r["bert"]["all_reduce_share"] for r in ranks],
           "bert_launches_by_rank": [r["bert"]["launches"] for r in ranks],
           "bert_state_tensors": ranks[0]["bert"]["state_tensors"],
           "bert_state_bytes": ranks[0]["bert"]["state_bytes"],
           "bert_init_broadcast_ms_by_rank": [r["bert"]["broadcast_ms"]
                                              for r in ranks],
           "checks_by_rank": [r["checks"] for r in ranks],
           "rank_seconds_by_rank": [r["seconds"] for r in ranks]}
    print(json.dumps({"cluster_dp": out}), flush=True)
    print(f"cluster DP: backend {out['backend_by_rank']} on "
          f"{out['device_by_rank']} ({out['device_count']} device(s): "
          "ranks share a device -> gloo); world-1 NCCL all-reduce "
          f"bitwise={nccl_equal}; BERT-base step "
          f"{np.median(out['bert_step_ms_by_rank'][0]):.1f} ms, all-reduce "
          f"share {out['bert_all_reduce_share_by_rank'][0]:.3f}; the init's "
          f"broadcast of {out['bert_state_tensors']} tensors "
          f"{ranks[0]['bert']['broadcast_ms']['per_tensor']} ms, one flat "
          f"buffer a dtype "
          f"{ranks[0]['bert']['broadcast_ms']['flat_per_dtype']} ms "
          f"[{card}]",
          flush=True)
    want_scatter = 2 * DP_STEPS
    bad_checks = [c for r in ranks for c in r["checks"]
                  if not c.get("ok", c.get("bitwise_vs_plain"))]
    bad_parity = {label: p for label, p in parity.items()
                  if not p["digests_equal"]
                  or not p["max_abs_err_vs_one_rank"] <= p["tol"]
                  or not p["loss_max_rel_err"] <= DP_LOSS_RTOL
                  or p["scatter_launches_by_rank"] != [want_scatter] * 2
                  or p["scatter_launches_one_rank"] != want_scatter}
    if bad_parity or not nccl_equal or bad_checks or \
            out["backend_by_rank"] != ["gloo", "gloo"]:
        raise AssertionError(f"cluster DP parity: {out}; bad checks "
                             f"{bad_checks}")
    for r in ranks:
        bl = r["bert"]["launches"]
        if not (bl["flash_attention_fwd"][fa.SM90_WGMMA] > 0
                and bl["flash_attention_bwd"][fa.SM90_WGMMA] > 0):
            raise AssertionError(f"BERT rank launches: {bl}")
    return out


class _HoldK8s(ProcessK8sClient):
    """Pods as local processes.  Worker 1's pod also gets `victim_env`;
    every pod created while `hold_env` is set gets that; each pod's
    create time is kept (`created`, time.time())."""

    def __init__(self, env: dict, victim_env: dict):
        super().__init__(extra_env=env)
        self._env = dict(env)
        self._victim_env = dict(victim_env)
        self.hold_env: dict = {}
        self.created: dict = {}

    def create_pod(self, spec) -> None:
        # the pod manager launches one pod at a time
        self._extra_env = dict(self._env, **self.hold_env, **(
            self._victim_env if spec.worker_id == 1 else {}))
        self.created[spec.name] = time.time()
        super().create_pod(spec)


def _rank_lines(logs: dict) -> list:
    """Every pod's kernel-launch lines (worker/spmd.py logs one as a rank
    exits), with the pod's name, from {pod: log}."""
    lines = []
    for name in sorted(logs):
        for line in logs[name].splitlines():
            tag = line.find(spmd_lib.KERNEL_LAUNCHES_TAG)
            if tag >= 0:
                entry = json.loads(
                    line[tag + len(spmd_lib.KERNEL_LAUNCHES_TAG):])
                entry["pod"] = name
                lines.append(entry)
    return lines


# the ranks' own log lines that mark a relaunched rank's way back, in the
# order a rank passes them (worker/main.py, worker/spmd.py,
# parallel/mesh.py), each with the part of the recovery that ends there
RECOVERY_MARKS = (
    ("imports", " telemetry on port "),
    ("model_spec_and_rendezvous", " joined epoch "),
    ("cuda_context", " group at "),
    ("group_join_and_trainer", "SPMD rank "),
    ("first_batch_init_and_broadcast", "elastic prewarm: "),
    ("checkpoint_load", " restored checkpoint step "),
)
SURVIVOR_EXITS = ("topology change; restarting the process",
                  " wedged: epoch moved ")


def _log_time(line: str):
    """The time.time() of a port log line (`[%Y-%m-%d %H:%M:%S,mmm]`,
    local time), or None."""
    if not line.startswith("["):
        return None
    stamp = line[1:line.find("]")]
    try:
        whole, ms = stamp.split(",")
        return time.mktime(time.strptime(whole, "%Y-%m-%d %H:%M:%S")) \
            + int(ms) / 1000.0
    except ValueError:
        return None


def _first_mark(text: str, needle: str):
    for line in text.splitlines():
        if needle in line:
            return _log_time(line)
    return None


def recovery_split(k8s, kill_ts: float, loss_ts: float, done_ts: float,
                   survivor: str, relaunched: list, clock_s: float) -> dict:
    """One recovery's parts, on the host's clock: the master's detection
    (the kill to its loss event, before the clock opens), then a chain
    that ends at the clock's close: the survivor's wait for the epoch to
    move (its exit line), the master's relaunch of it (the last pod
    create), each mark of RECOVERY_MARKS at the later of the two
    relaunched ranks, and the first post-restore report (the master's
    done event).  The chain's parts sum to done - loss, the clock's
    value."""
    out = {"detection": loss_ts - kill_ts}
    chain = [("survivor_wait", min(
        t for t in (_first_mark(k8s.pod_output(survivor), n)
                    for n in SURVIVOR_EXITS) if t is not None))]
    chain.append(("relaunch", max(k8s.created[p] for p in relaunched)))
    for part, needle in RECOVERY_MARKS:
        stamps = [_first_mark(k8s.pod_output(p), needle) for p in relaunched]
        if None in stamps:
            raise AssertionError(f"no {needle!r} line in {relaunched}")
        chain.append((part, max(stamps)))
    chain.append(("first_report", done_ts))
    prev = loss_ts
    for part, at in chain:
        out[part] = at - prev
        prev = at
    out["parts_sum"] = done_ts - loss_ts
    out["clock_s"] = clock_s
    out["survivor"] = survivor
    out["relaunched"] = list(relaunched)
    return out


def preempted_bert_job(card: str, work: str, device: str = "cuda") -> dict:
    """(b) BASELINE.md #5: BERT-base fine-tuning through the master's
    entry point with ProcessK8sClient, 2 worker processes on the card.
    Worker 1 is SIGKILLed once a checkpoint step has committed; once that
    outage has closed and the new group has committed a further step,
    the pod that holds the new group's rank 0 (read from the rendezvous)
    is SIGKILLed too.  Each recovery is split into its parts."""
    root = os.path.join(work, "cluster_bert")
    train_dir, _ = write_pairs(root, n_train=CLUSTER_BERT_RECORDS,
                               n_val=16, max_len=SEQ_LEN, vocab=VOCAB,
                               seed=SEED)
    ckpt = os.path.join(root, "ckpt")
    hold = FaultRegistry([FaultSpec(faults.POINT_RPC_GET_TASK,
                                    CLUSTER_HOLD_HIT, "delay",
                                    CLUSTER_HOLD_S)])
    report_hold = FaultRegistry([FaultSpec(faults.POINT_RPC_REPORT,
                                           CLUSTER_REPORT_HOLD_HIT, "delay",
                                           CLUSTER_HOLD_S)])
    k8s = _HoldK8s({"PYTHONPATH": ROOT, **bytecode_env(work)},
                   {faults.ENV_SCHEDULE: hold.schedule_json()})
    job = "chip-bert"
    argv = ["--distribution_strategy", "AllReduce", "--use_process_k8s",
            "true", "--num_workers", str(CLUSTER_RANKS), "--job_name", job,
            "--model_def", BERT, "--model_params",
            BERT_PARAMS + ";bf16=True", "--use_bf16", "true",
            "--minibatch_size", str(CLUSTER_BERT_BATCH),
            "--records_per_task", str(CLUSTER_BERT_TASK),
            "--num_epochs", "1", "--training_data", train_dir,
            "--checkpoint_dir", ckpt,
            "--checkpoint_steps", str(CLUSTER_BERT_CKPT_STEPS),
            "--keep_checkpoint_max", "2",
            "--port", str(free_port()),
            "--coordinator_port", str(free_port()),
            "--wedge_grace_s", str(CLUSTER_WEDGE_GRACE_S),
            "--task_lease_timeout_s", "300", "--device", device]
    held = {}
    result = {}
    # the master's recovery events, on the host's clock
    marks = {events.RECOVERY_STARTED: [], events.RECOVERY_DONE: []}

    def observe(record):
        if record["event"] in marks:
            marks[record["event"]].append(record["ts"])

    def run():
        result["rc"] = master_main.main(
            argv, k8s_client=k8s, linger_s=CLUSTER_LINGER_S,
            on_started=lambda m: held.setdefault("master", m))

    def wait_for(what, ready):
        while not ready():
            if not thread.is_alive() or \
                    time.perf_counter() - t0 > CLUSTER_JOB_TIMEOUT_S:
                raise AssertionError(f"the job ended or timed out before "
                                     f"{what}")
            time.sleep(0.05)

    kills = []
    events.add_observer(observe)
    t0 = time.perf_counter()
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        wait_for("a checkpoint step committed", lambda: committed_steps(ckpt))
        first_step = max(committed_steps(ckpt))
        group1 = sorted(k8s.pods)
        # the pods created while the first outage is open (the second
        # group) hold in rank 0's version report after their commit
        k8s.hold_env = {faults.ENV_SCHEDULE: report_hold.schedule_json()}
        kills.append({"pod": f"{job}-worker-1", "rank": 1,
                      "after_step": first_step,
                      "after_s": time.perf_counter() - t0,
                      "ts": time.time()})
        k8s.kill_pod(f"{job}-worker-1")
        master = held["master"]
        wait_for("the first recovery closed and the next commit",
                 lambda: len(master.recovery_clock.history) == 1 and max(
                     committed_steps(ckpt), default=0) > first_step)
        k8s.hold_env = {}
        spec = master.rendezvous_server.cluster_spec()
        victim = next(w for w in spec.workers if w.rank == 0)
        group2 = [p for p in sorted(k8s.pods) if p not in group1]
        victim_pod = f"{job}-worker-{victim.worker_id}"
        if victim_pod not in group2:
            raise AssertionError(f"rank 0 {victim_pod} is not of the "
                                 f"second group {group2}")
        kills.append({"pod": victim_pod, "rank": 0,
                      "worker_id": victim.worker_id,
                      "epoch": spec.rendezvous_id,
                      "after_step": max(committed_steps(ckpt)),
                      "after_s": time.perf_counter() - t0,
                      "ts": time.time()})
        k8s.kill_pod(victim_pod)
        thread.join(CLUSTER_JOB_TIMEOUT_S)
        if thread.is_alive():
            raise AssertionError("the preempted BERT job did not end")
    finally:
        k8s.stop()
        events.remove_observer(observe)
    wall_s = time.perf_counter() - t0
    master = held["master"]
    lines = _rank_lines({name: k8s.pod_output(name) for name in k8s.pods})
    final = [e for e in lines if "state_sha256" in e]
    history = list(master.recovery_clock.history)
    group3 = [p for p in sorted(k8s.pods)
              if p not in group1 and p not in group2]
    groups = (group1, group2, group3)
    splits = []
    if len(history) == CLUSTER_KILLS and \
            len(marks[events.RECOVERY_STARTED]) == CLUSTER_KILLS and \
            len(marks[events.RECOVERY_DONE]) == CLUSTER_KILLS:
        for i, kill in enumerate(kills):
            survivor = next(p for p in groups[i] if p != kill["pod"])
            splits.append(recovery_split(
                k8s, kill["ts"], marks[events.RECOVERY_STARTED][i],
                marks[events.RECOVERY_DONE][i], survivor, groups[i + 1],
                history[i]))
    budget = int(master.args.relaunch_on_worker_failure)
    relaunch_counts = dict(master.pod_manager._relaunch_count)
    out = {"card": card, "exit_code": result.get("rc"), "wall_s": wall_s,
           "kills": kills,
           "records_done": master.task_manager.counters.records_done,
           "records": CLUSTER_BERT_RECORDS,
           "recovery_s": history,
           "recovery_split": splits,
           "recovery_budget_s": CLUSTER_RECOVERY_BUDGET_S,
           "groups": [list(g) for g in groups],
           "pods": master.pod_manager.snapshot(),
           "relaunch_counts": relaunch_counts,
           "relaunch_budget": budget,
           "pod_commands": [spec.command[:3] for spec in k8s.create_calls],
           "final_ranks": [{k: e[k] for k in ("pod", "rank", "epoch",
                                               "world", "step",
                                               "state_sha256",
                                               "launches")}
                           for e in final],
           "exits": [{k: e[k] for k in ("pod", "rank", "epoch", "launches")}
                     for e in lines if "state_sha256" not in e]}
    print(json.dumps({"cluster_bert": out}), flush=True)
    for i, split in enumerate(splits):
        parts = ", ".join(f"{k} {split[k]:.3f}" for k in split
                          if k not in ("parts_sum", "clock_s", "survivor",
                                       "relaunched"))
        print(f"cluster BERT-base recovery {i + 1}: clock "
              f"{split['clock_s']:.3f} s, parts sum "
              f"{split['parts_sum']:.3f} s: {parts} [{card}]", flush=True)
    print(f"cluster BERT-base, two preemptions: recovery {history} s "
          f"(budget {CLUSTER_RECOVERY_BUDGET_S} s), job {wall_s:.1f} s "
          f"[{card}]", flush=True)
    ok_final = (len(final) == CLUSTER_RANKS
                and {e["pod"] for e in final} == set(group3)
                and len({e["state_sha256"] for e in final}) == 1
                and len({e["epoch"] for e in final}) == 1
                and all(e["launches"]["flash_attention_fwd"][fa.SM90_WGMMA]
                        > 0 and e["launches"]["flash_attention_bwd"][
                            fa.SM90_WGMMA] > 0 for e in final))
    ok_split = len(splits) == CLUSTER_KILLS and all(
        abs(s["parts_sum"] - s["clock_s"]) <= CLUSTER_SPLIT_TOL_S
        and all(s[k] >= -CLUSTER_SPLIT_TOL_S for k in s
                if isinstance(s[k], float))
        for s in splits)
    if out["exit_code"] != 0 or not ok_final or not ok_split or \
            len(history) != CLUSTER_KILLS or \
            max(history) >= CLUSTER_RECOVERY_BUDGET_S or \
            out["records_done"] < CLUSTER_BERT_RECORDS or \
            max(relaunch_counts.values()) > budget or \
            len(group3) != CLUSTER_RANKS:
        logs = {name: k8s.pod_output(name)[-3000:] for name in k8s.pods}
        raise AssertionError(f"the preempted BERT-base job: {out}; pod "
                             f"logs {logs}")
    return out


def cluster(card: str, work: str) -> tuple:
    """Item 18: (a) + (c) DP parity and the in-rank checks, (b) the
    preempted BERT-base job.  Returns (summary, launches by path)."""
    t0 = time.perf_counter()
    root = os.path.join(work, "cluster")
    os.makedirs(root, exist_ok=True)
    try:
        dp = dp_parity(card, root)
        bert = preempted_bert_job(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    print(f"cluster phase: {seconds:.1f} s (budget {CLUSTER_BUDGET_S} s) "
          f"[{card}]", flush=True)
    launches = {f"cluster_dp_deepfm_rank{r}": n for r, n in
                enumerate(dp["scatter_launches_by_rank"])}
    for r, bl in enumerate(dp["bert_launches_by_rank"]):
        launches[f"cluster_dp_bert_rank{r}"] = bl
    for e in bert["final_ranks"]:
        launches[f"cluster_bert_job_rank{e['rank']}"] = e["launches"]
    return {"dp": dp, "bert_job": bert, "seconds": seconds,
            "budget_s": CLUSTER_BUDGET_S}, launches


# ---- kube_cluster: the real Kubernetes client ----------------------------

KUBE_BUDGET_S = 60.0
KUBE_JOB = "chip-kube"
# DeepFM at the `cluster` phase's bench width and global batch: tasks of
# 2 steps, a checkpoint committed every task, 8 tasks (the first commit
# shows a few steps after it was taken; the delete must land well
# before the last task)
KUBE_TASK = 2 * DP_BATCH
KUBE_RECORDS = 8 * KUBE_TASK
KUBE_CKPT_STEPS = 2
KUBE_SEED = SEED + 19
KUBE_TIMEOUT_S = 300.0
# the stub API server's test-only CA, server and client certificates
KUBE_TLS = os.path.join(ROOT, "tests", "data", "k8s_tls")
# what a deleted pod's container may exit with: the preemption hook's
# 143 on SIGTERM, or 137 when the stub's grace ran out first
KUBE_DELETE_EXITS = (143, 137)


def _restored_step(log: str) -> int:
    """The checkpoint step a rank's log says it restored (0: none)."""
    needle = " restored checkpoint step "
    for line in log.splitlines():
        at = line.find(needle)
        if at >= 0:
            return int(line[at + len(needle):].split()[0])
    return 0


def kube_cluster(card: str, work: str, device: str = "cuda") -> tuple:
    """A DeepFM job on the card through the real Kubernetes client only:
    `elasticdl train --distribution_strategy AllReduce` in this process
    submits the master pod to the stub API server over TLS (a JSON
    kubeconfig with the test CA and an inline client certificate); the
    stub's kubelet runs the master entry point, whose default client
    loads the kubeconfig the stub gives its pods and creates 2 worker
    pods; once a checkpoint step has committed, this process deletes
    worker 1's pod through the API.  Returns (summary, launches)."""
    t0 = time.perf_counter()
    root = os.path.join(work, "kube_cluster")
    os.makedirs(root, exist_ok=True)
    # (the writer needs a few validation records; the job reads none)
    train_dir, _ = write_dataset(os.path.join(root, "data"),
                                 n_train=KUBE_RECORDS, n_val=16,
                                 seed=KUBE_SEED)
    ckpt = os.path.join(root, "ckpt")
    event_log = os.path.join(root, "events.jsonl")
    kubeconfig = os.path.join(root, "kubeconfig.json")
    argv = ["train", "--distribution_strategy", "AllReduce",
            "--num_workers", str(CLUSTER_RANKS), "--job_name", KUBE_JOB,
            "--model_def", DEEPFM, "--model_params", DEEPFM_PARAMS,
            "--use_bf16", "true", "--minibatch_size", str(DP_BATCH),
            "--records_per_task", str(KUBE_TASK), "--num_epochs", "1",
            "--training_data", train_dir, "--checkpoint_dir", ckpt,
            "--checkpoint_steps", str(KUBE_CKPT_STEPS),
            "--keep_checkpoint_max", "2",
            "--port", str(free_port()),
            "--coordinator_port", str(free_port()),
            "--wedge_grace_s", str(CLUSTER_WEDGE_GRACE_S),
            "--task_lease_timeout_s", "300", "--event_log", event_log,
            "--device", device]
    master_pod, victim = f"{KUBE_JOB}-master", f"{KUBE_JOB}-worker-1"
    seen, lock = [], threading.Lock()

    def on_event(*event):
        with lock:
            seen.append((time.perf_counter() - t0, *event))

    def phases(pod):
        with lock:
            return [e[2:] for e in seen if e[1] == pod]

    def wait_for(what, ready):
        while not ready():
            if time.perf_counter() - t0 > KUBE_TIMEOUT_S or any(
                    p[0] in (PodStatus.SUCCEEDED, PodStatus.FAILED)
                    for p in phases(master_pod)):
                raise AssertionError(f"the job ended or timed out before "
                                     f"{what}: {phases(master_pod)}; "
                                     f"{stub.pod_log(master_pod)[-3000:]}")
            time.sleep(0.05)

    # the cluster is the stub's, reached through the kubeconfig: never an
    # in-cluster service this machine may know of
    saved = {k: os.environ.pop(k, None) for k in (
        "KUBECONFIG", "KUBERNETES_SERVICE_HOST", "KUBERNETES_SERVICE_PORT")}
    stub = StubApiServer(KUBE_TLS, pod_kubeconfig=kubeconfig, pod_env={
        "PYTHONPATH": ROOT, **bytecode_env(work)})
    watcher = None
    marks = {}
    try:
        os.environ["KUBECONFIG"] = write_kubeconfig(kubeconfig, stub.url,
                                                    KUBE_TLS)
        watcher = K8sClient(namespace="default", job_name=KUBE_JOB)
        watcher.start_watch(on_event)
        submit_rc = cli.main(argv)
        marks["submitted_s"] = time.perf_counter() - t0
        if submit_rc != 0:
            raise AssertionError(f"elasticdl train exited {submit_rc}")
        wait_for("a committed checkpoint step",
                 lambda: committed_steps(ckpt))
        marks["deleted_after_step"] = max(committed_steps(ckpt))
        marks["deleted_s"] = time.perf_counter() - t0
        watcher.delete_pod(victim)
        while not any(p[0] in (PodStatus.SUCCEEDED, PodStatus.FAILED)
                      for p in phases(master_pod)):
            if time.perf_counter() - t0 > KUBE_TIMEOUT_S:
                raise AssertionError("the kube_cluster job timed out")
            time.sleep(0.05)
        marks["master_done_s"] = time.perf_counter() - t0
    finally:
        if watcher is not None:
            watcher.stop()
        logs = {name: stub.pod_log(name) for name in stub.pod_names()}
        stub.stop()
        for key, value in saved.items():
            os.environ.pop(key, None)
            if value is not None:
                os.environ[key] = value
    with open(os.path.join(ckpt, "task_state.json")) as f:
        journal = json.load(f)
    shards = sorted(tuple(entry[:3])
                    for entry in journal["done_training_shards"])
    with open(event_log) as f:
        recoveries = [e["duration_s"] for e in map(json.loads, f)
                      if e["event"] == events.RECOVERY_DONE]
    shutil.rmtree(root, ignore_errors=True)
    ranks = []
    for line in _rank_lines(logs):
        restored = _restored_step(logs[line["pod"]])
        ranks.append({"pod": line["pod"], "final": "state_sha256" in line,
                      "rank": line["rank"], "epoch": line["epoch"],
                      "world": line["world"], "step": line.get("step"),
                      "restored": restored,
                      "steps": line.get("step", 0) - restored,
                      "scatter_launches": line["launches"]["scatter_add"],
                      "state_sha256": line.get("state_sha256")})
    requests = {}
    for r in stub.requests:
        key = f"{r['verb']} {r['path']}" + (
            "?watch" if r["query"].get("watch") else "")
        requests[key] = requests.get(key, 0) + 1
    credentials = sorted({str(r["credential"]) for r in stub.requests})
    tls = sorted({str(r["tls"]) for r in stub.requests})
    seconds = time.perf_counter() - t0
    out = {"card": card, "records": KUBE_RECORDS, "global_batch": DP_BATCH,
           "tasks": KUBE_RECORDS // KUBE_TASK,
           "steps": KUBE_RECORDS // DP_BATCH,
           "master_phases": phases(master_pod),
           "victim_phases": phases(victim),
           "pods": sorted(logs), "marks_s": marks,
           "journal_records_done": journal["records_done"],
           "journal_shards": len(shards),
           "journal_unique_shards": len(set(shards)),
           "recovery_s": recoveries,
           "recovery_budget_s": CLUSTER_RECOVERY_BUDGET_S,
           "ranks": ranks, "requests": requests,
           "request_count": len(stub.requests),
           "credentials": credentials, "tls": tls,
           "refused_handshakes": len(stub.refused_handshakes),
           "plumbing": stub.plumbing,
           "seconds": seconds, "budget_s": KUBE_BUDGET_S}
    print(json.dumps({"kube_cluster": out}), flush=True)
    master_end = phases(master_pod)[-1]
    restored = [r["restored"] for r in ranks if r["final"]]
    print(f"kube_cluster: master pod {master_end[0]} (exit "
          f"{master_end[2]}) on the watch; tasks "
          f"{len(shards)}/{out['tasks']} done once, "
          f"{journal['records_done']} of {KUBE_RECORDS} records; the "
          f"delete after step {marks['deleted_after_step']}'s commit, the "
          f"final ranks from step {restored} of {out['steps']}; "
          f"recovery {recoveries} s; scatter-add launches by rank "
          f"{[(r['pod'], r['scatter_launches'], r['steps']) for r in ranks]}"
          f" (launches, steps) [{card}]", flush=True)
    print(f"kube_cluster: {len(stub.requests)} API requests, all "
          f"{credentials} over {tls}, {len(stub.refused_handshakes)} "
          f"refused: {requests}", flush=True)
    print(f"kube_cluster phase: {seconds:.1f} s (budget {KUBE_BUDGET_S} s) "
          f"[{card}]", flush=True)
    final = [r for r in ranks if r["final"]]
    survivor = [r for r in ranks if not r["final"]]
    deleted = [p for p in phases(victim) if p[0] == PodStatus.FAILED]
    bad = []
    if master_end != (PodStatus.SUCCEEDED, "127.0.0.1", 0):
        bad.append(f"master pod ended {master_end}")
    if shards != sorted(set(shards)) or len(shards) != out["tasks"] or \
            journal["records_done"] != KUBE_RECORDS:
        bad.append("a training shard not done exactly once")
    if len(recoveries) != 1 or recoveries[0] >= CLUSTER_RECOVERY_BUDGET_S:
        bad.append(f"recoveries {recoveries}")
    if len(deleted) != 1 or deleted[0][2] not in KUBE_DELETE_EXITS or \
            phases(victim)[-1][0] != PodStatus.DELETED:
        bad.append(f"the deleted pod's events {phases(victim)}")
    if out["pods"] != [master_pod] + [f"{KUBE_JOB}-worker-{i}"
                                      for i in range(4)]:
        bad.append(f"pods {out['pods']}")
    if len(final) != CLUSTER_RANKS or \
            {r["pod"] for r in final} != {f"{KUBE_JOB}-worker-2",
                                          f"{KUBE_JOB}-worker-3"} or \
            len({r["state_sha256"] for r in final}) != 1 or \
            any(r["steps"] <= 0 or r["scatter_launches"] != 2 * r["steps"]
                for r in final):
        bad.append("the final ranks' states or launches")
    # the survivor's last step may have launched its backward before
    # the all-reduce with the deleted peer failed: 2 launches more
    if len(survivor) != 1 or survivor[0]["steps"] <= 0 or \
            survivor[0]["scatter_launches"] - 2 * survivor[0]["steps"] \
            not in (0, 2):
        bad.append("the survivor's launches")
    if credentials != ["client-certificate"] or \
            any(not t.startswith("TLS") for t in tls):
        bad.append("a request without the client certificate")
    if bad:
        raise AssertionError(f"kube_cluster: {bad}: {out}; pod logs "
                             f"{ {n: t[-3000:] for n, t in logs.items()} }")
    launches = {f"kube_cluster_rank{r['rank']}": r["scatter_launches"]
                for r in final}
    return out, launches


# ---- autoscale_cluster: the master's autoscaling loop, live ---------------

AUTOSCALE_BUDGET_S = 60.0
AUTOSCALE_JOB = "chip-scale"
# DeepFM at the `cluster` phase's bench width and global batch (8192,
# which splits evenly over one rank and over two): tasks of 2 steps, a
# checkpoint committed every task.  On an H100 80GB HBM3 at 700 W one
# rank alone ran ~14 steps a second, and the commit the hold waits for
# showed some steps after it was taken, so 16 tasks left 6 in the queue
# at the decision (backlog 6.0, the world of two 12 steps); 32 keep the
# backlog far above 2 a worker until the world of two has trained
AUTOSCALE_TASK = 2 * DP_BATCH
AUTOSCALE_RECORDS = 32 * AUTOSCALE_TASK
AUTOSCALE_CKPT_STEPS = 2
AUTOSCALE_SEED = SEED + 20
AUTOSCALE_TIMEOUT_S = 300.0
# the policy engine's bounds and thresholds.  --data_wait_share 1.0: the
# engine scales down on a share strictly above it, so never; the DeepFM
# step is host-bound (busy 0.17, PERF.md section 5) and a data-wait
# scale-down could land in the middle of the phase and turn the check
# of one decision into a race
AUTOSCALE_FLAGS = ["--num_workers", "1", "--min_workers", "1",
                   "--max_workers", "2", "--policy_interval", "0.5",
                   "--backlog_per_worker", "2", "--backlog_ticks", "2",
                   "--scale_hold_ticks", "2", "--data_wait_share", "1.0"]
# ticks the loop's hold can cover: far more than the job lasts
AUTOSCALE_HOLD_TICKS = 100000


def autoscale_cluster(card: str, work: str, device: str = "cuda") -> tuple:
    """The master's autoscaling loop on a live job: DeepFM at bench width
    through the master's entry point over ProcessK8sClient (in a process
    of its own, `chip_smoke.py --autoscale-master`, since the master
    applies --compilation_cache_dir first and this process has loaded
    its kernels from the checkout's cache), one worker to start, the
    AUTOSCALE_FLAGS bounds, and --compilation_cache_dir at a fresh
    directory.  Nothing here calls scale_up: the policy engine alone
    grows the job.  Its ticks are held at the engine's own fault point
    (`policy.tick`: a skipped tick freezes the streaks) until the first
    world has committed a checkpoint step, so the decision lands
    mid-job; unheld, two ticks of a full queue decide within a
    second of the master's start, before the first worker's process
    has imported torch, and the job never runs a world of one.
    Checked: one scale_up for the backlog that launched one pod, the
    job's exit 0 on a world of two, every shard done once, 2
    scatter-adds a step in each final rank and the kernel against its
    plain version at a final rank's rows, the first rank's nvcc build
    into the fresh cache (its kernel_build_* program and seconds), and
    no build in the pod the scale-up added (nor in the relaunched
    first rank).  Returns (summary, launches)."""
    t0 = time.perf_counter()
    root = os.path.join(work, "autoscale_cluster")
    os.makedirs(root, exist_ok=True)
    # (the writer needs a few validation records; the job reads none)
    train_dir, _ = write_dataset(os.path.join(root, "data"),
                                 n_train=AUTOSCALE_RECORDS, n_val=16,
                                 seed=AUTOSCALE_SEED)
    cache = os.path.join(root, "kernel_cache")
    written_s = time.perf_counter() - t0
    env = dict(os.environ, **bytecode_env(work))
    # a session of its own: a master that times out goes with its pods
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--autoscale-master",
         root, work, device], cwd=ROOT, env=env, start_new_session=True)
    try:
        code = proc.wait(timeout=AUTOSCALE_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if code != 0:
        raise AssertionError(f"the autoscale master's process exited "
                             f"{code}")
    with open(os.path.join(root, "master.json")) as f:
        job = json.load(f)
    ckpt = os.path.join(root, "ckpt")
    with open(os.path.join(ckpt, "task_state.json")) as f:
        journal = json.load(f)
    done = [tuple(entry[:3]) for entry in journal["done_training_shards"]]
    with open(os.path.join(root, "events.jsonl")) as f:
        log = [json.loads(line) for line in f]
    decided = [e for e in log if e["event"] == events.POLICY_DECISION]
    logs = job["pod_logs"]
    ranks = []
    for line in _rank_lines(logs):
        restored = _restored_step(logs[line["pod"]])
        ranks.append({"pod": line["pod"], "final": "state_sha256" in line,
                      "rank": line["rank"], "epoch": line["epoch"],
                      "world": line["world"], "step": line.get("step"),
                      "restored": restored,
                      "steps": line.get("step", 0) - restored,
                      "scatter_launches": line["launches"]["scatter_add"],
                      "kernel_builds": line.get("kernel_builds"),
                      "state_sha256": line.get("state_sha256")})
    final = [r for r in ranks if r["final"]]
    first_pod = f"{AUTOSCALE_JOB}-worker-0"
    first = [r for r in ranks if r["pod"] == first_pod]
    decision_ts = decided[0]["ts"] if decided else None
    # the pod the scale-up launched: the first created after the release
    added = [p for p, ts in sorted(job["created"].items(),
                                   key=lambda kv: kv[1])
             if ts >= job["released_ts"]][:1]
    # the world of two's first step: its ranks' restores done (the later
    # of the two log lines), and its first reported task
    restores = [_first_mark(logs[r["pod"]], " restored checkpoint step ")
                for r in final]
    final_ids = {int(r["pod"].rsplit("-", 1)[1]) for r in final}
    reports = [e["ts"] for e in log if e["event"] == events.TASK_REPORTED
               and e.get("worker_id") in final_ids]
    latency = {}
    if decision_ts is not None and final and None not in restores:
        latency = {"to_first_step_s": max(restores) - decision_ts,
                   "to_first_report_s": min(reports) - decision_ts
                   if reports else None,
                   "release_to_decision_s":
                       decision_ts - job["released_ts"]}
    builds = {r["pod"]: r["kernel_builds"] for r in ranks}
    cold = (first[0]["kernel_builds"] or {}).get(
        "kernel_build_scatter_add") if first else None
    libraries = sorted(os.listdir(cache)) if os.path.isdir(cache) else []
    # the scatter-add at a final rank's rows: the first global batch of
    # the last shard the job finished (the world of two's), hashed as
    # the rank's feed hashes it, held against its plain version
    reader = TFRecordDataReader(train_dir)
    name, start, _ = done[-1]
    records = list(reader.read_records(pb.Task(shard=pb.Shard(
        name=name, start=start, end=start + DP_BATCH))))
    sparse = fm_zoo.feed(records, getattr(reader, "metadata", {}))[
        "features"]["sparse"]
    rows = DP_BATCH // 2
    ids_np = hash_field_rows_host(sparse[rows:2 * rows], DEEPFM_VOCAB)
    gen = torch.Generator(device=device).manual_seed(AUTOSCALE_SEED)
    checks = [shard_scatter_check(ids_np, 0, DEEPFM_VOCAB, dim, gen, device)
              for dim in (DEEPFM_DIM, 1)]
    shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    out = {"card": card, "records": AUTOSCALE_RECORDS,
           "global_batch": DP_BATCH,
           "tasks": AUTOSCALE_RECORDS // AUTOSCALE_TASK,
           "steps": AUTOSCALE_RECORDS // DP_BATCH,
           "flags": AUTOSCALE_FLAGS, "exit_code": job["rc"],
           "decisions": job["decisions"], "policy": job["policy"],
           "decision_events": decided, "released": job["released"],
           "pods": sorted(job["created"]), "added": added,
           "journal_records_done": journal["records_done"],
           "journal_shards": len(done),
           "journal_unique_shards": len(set(done)),
           "ranks": ranks, "latency": latency, "cold_build_s": cold,
           "kernel_builds": builds, "cache_libraries": libraries,
           "kernel_checks": checks, "recovery_s": job["recovery_s"],
           "data_s": written_s, "seconds": seconds,
           "budget_s": AUTOSCALE_BUDGET_S}
    print(json.dumps({"autoscale_cluster": out}), flush=True)
    decisions = [(d["tick"], d["action"], d["reason"],
                  d.get("backlog_per_worker"), d.get("launched"))
                 for d in job["decisions"]]
    nan = float("nan")
    print(f"autoscale_cluster: decisions (tick, action, reason, backlog a "
          f"worker, launched) {decisions}, "
          f"{latency.get('release_to_decision_s', nan):.2f} s after the "
          f"loop's release at step {job['released'].get('step')}; the "
          f"world of two's first step "
          f"{latency.get('to_first_step_s', nan):.2f} s after the decision "
          f"(its first report {latency.get('to_first_report_s') or nan:.2f}"
          f" s); the cold nvcc build of scatter_add.cu {cold} s in "
          f"{first_pod} into the fresh cache {libraries}; builds by pod "
          f"{builds}; {len(set(done))}/{out['tasks']} shards done "
          f"[{card}]", flush=True)
    print(f"autoscale_cluster phase: {seconds:.1f} s (budget "
          f"{AUTOSCALE_BUDGET_S} s) [{card}]", flush=True)
    bad = []
    if job["rc"] != 0:
        bad.append(f"the job exited {job['rc']}")
    if [(d["action"], d["reason"], d["requested"], d["launched"])
            for d in job["decisions"]] != [("scale_up", "backlog", 1, 1)]:
        bad.append(f"decisions {job['decisions']}")
    if len(set(done)) != len(done) or len(done) != out["tasks"] or \
            journal["records_done"] != AUTOSCALE_RECORDS:
        bad.append("a training shard not done exactly once")
    if not first or first[0]["world"] != 1 or not first[0]["step"]:
        bad.append(f"the first rank did not train alone: {first}")
    if len(final) != 2 or {r["world"] for r in final} != {2} or \
            len({r["state_sha256"] for r in final}) != 1 or \
            any(r["steps"] <= 0 or r["scatter_launches"] != 2 * r["steps"]
                for r in final):
        bad.append("the final ranks' world, states or launches")
    if not cold or cold <= 0 or not any(
            lib.startswith("scatter_add-") for lib in libraries):
        bad.append(f"no cold build into the fresh cache: {builds}, "
                   f"{libraries}")
    if added != [f"{AUTOSCALE_JOB}-worker-1"] or \
            added[0] not in {r["pod"] for r in final} or any(
                b for pod, b in builds.items() if pod != first_pod):
        bad.append(f"the added pod {added} built or is not final: "
                   f"{builds}")
    if not all(c["ok"] for c in checks):
        bad.append(f"the scatter-add at a final rank's rows: {checks}")
    if bad:
        raise AssertionError(f"autoscale_cluster: {bad}: {out}; pod logs "
                             f"{ {n: t[-3000:] for n, t in logs.items()} }")
    launches = {f"autoscale_cluster_rank{r['rank']}": r["scatter_launches"]
                for r in final}
    return out, launches


def autoscale_master(root: str, work: str, device: str = "cuda") -> int:
    """The autoscale_cluster job's master (a process of its own): the
    master's entry point over ProcessK8sClient with the policy loop held
    at `policy.tick` until a checkpoint step has committed; writes what
    the phase checks to ROOT/master.json."""
    ckpt = os.path.join(root, "ckpt")
    argv = ["--distribution_strategy", "AllReduce", "--use_process_k8s",
            "true", "--job_name", AUTOSCALE_JOB,
            "--model_def", DEEPFM, "--model_params", DEEPFM_PARAMS,
            "--use_bf16", "true", "--minibatch_size", str(DP_BATCH),
            "--records_per_task", str(AUTOSCALE_TASK), "--num_epochs", "1",
            "--training_data", os.path.join(root, "data", "train"),
            "--checkpoint_dir", ckpt,
            "--checkpoint_steps", str(AUTOSCALE_CKPT_STEPS),
            "--keep_checkpoint_max", "2",
            "--port", str(free_port()),
            "--coordinator_port", str(free_port()),
            "--wedge_grace_s", str(CLUSTER_WEDGE_GRACE_S),
            "--task_lease_timeout_s", "300",
            "--event_log", os.path.join(root, "events.jsonl"),
            "--compilation_cache_dir", os.path.join(root, "kernel_cache"),
            "--device", device, *AUTOSCALE_FLAGS]
    k8s = _HoldK8s({"PYTHONPATH": ROOT, **bytecode_env(work)}, {})
    held, released = {}, {}

    def release():
        while not committed_steps(ckpt):
            time.sleep(0.05)
        released.update(step=max(committed_steps(ckpt)), ts=time.time())
        faults.uninstall()

    def started(master):
        held["master"] = master
        threading.Thread(target=release, daemon=True).start()

    faults.install(FaultRegistry([
        FaultSpec(faults.POINT_POLICY_TICK, hit, "raise")
        for hit in range(AUTOSCALE_HOLD_TICKS)]))
    try:
        rc = master_main.main(argv, k8s_client=k8s,
                              linger_s=CLUSTER_LINGER_S, on_started=started)
    finally:
        faults.uninstall()
        k8s.stop()
    master = held["master"]
    with open(os.path.join(root, "master.json"), "w") as f:
        json.dump({"rc": rc, "decisions": master.policy_engine.decisions,
                   "policy": master.policy_engine.snapshot(),
                   "released": released,
                   "released_ts": released.get("ts"),
                   "created": k8s.created,
                   "recovery_s": list(master.recovery_clock.history),
                   "pod_logs": {name: k8s.pod_output(name)
                                for name in k8s.pods}}, f, default=str)
    return 0


# ---- parallel_axes: the model, seq, expert and pipe axes ---------------

PAR_BUDGET_S = 90.0
PAR_RANKS = 4
PAR_BERT_BATCH = 16         # (a) and (c): global rows of 512 ids
PAR_MOE_BATCH = 8           # (b)
PAR_STEPS = 3
# (a)-(c), the older parts, cut so that (f)-(h) fit the budget: the
# ring to 2 steps (PR 17: 3), all three to 6 of BERT-base's 12 layers
# (the widths whole)
PAR_RING_STEPS = 2
PAR_CUT_LAYERS = 6
PAR_HIDDEN, PAR_HEADS = 768, 12       # BERT_PARAMS' widths
PAR_CUT_PARAMS = BERT_PARAMS.replace(f"num_layers={NUM_LAYERS}",
                                     f"num_layers={PAR_CUT_LAYERS}")
PAR_RING_PARAMS = PAR_CUT_PARAMS + ";bf16=True"
# (b) at a rate that moves the loss within 3 steps of one batch; (h)
# the same at BERT-base's depth
PAR_MOE_PARAMS = PAR_CUT_PARAMS + ";bf16=True;moe_experts=4;lr=1e-4"
PAR_MOE_SEQ_PARAMS = BERT_PARAMS + ";bf16=True;moe_experts=4;lr=1e-4"
PAR_SEQ_CHUNKS = 2      # (h)'s seq axis
# (a) bf16 BERT-base, 4 ranks (ring of 2 blocks, a row-sharded token
# table) against one rank from the same init: the ring merges
# bf16-rounded partial outputs, each rank sums its gradients in another
# order, and Adam's first steps move elements by about lr whatever their
# gradient's size; a step's loss within this times max(1, the loss)
# (measured 0.016 at a loss of 3.35 on an H100), and (e)'s restored
# logits within PAR_LOGITS_TOL
PAR_LOSS_RTOL = 2.0 ** -6
PAR_LOGITS_TOL = 2.0 ** -4
# (a) one ring of 2 blocks through the flash kernels against the plain
# ring body, bf16: O within this of its largest magnitude (each block's
# partial is rounded to bf16 before the f32 merge, the merged O once
# more, and the plain body rounds its own products: four rounding steps
# of 2^-8; measured 2^-8 at a largest |O| of 0.65 to 0.96 on an NVIDIA
# H100 80GB HBM3 at 700 W), the gradients within twice BWD_TOL of
# max(1, their largest magnitude)
PAR_RING_OUT_RTOL = 2.0 ** -6
# (b) the MoE layer's f32 output, sharded against one rank: the same
# einsums over other slices
PAR_MOE_TOL = 1e-4
# (c) bf16 GPipe logits and step-1 gradients against the one-rank
# sequential stack: the same arithmetic per row, microbatched; an
# element within this times max(1, the parameter's largest gradient)
PAR_PIPE_TOL = 2.0 ** -7
PAR_PIPE_MICRO = 4
# the parts whose steps run the flash kernels
PAR_FLASH_PATHS = ("parallel_ring", "parallel_moe", "parallel_gpipe",
                   "parallel_moe_seq")
PAR_PIPE_PARAMS = (PAR_CUT_PARAMS + ";bf16=True;pipeline_microbatches="
                   f"{PAR_PIPE_MICRO}")


def _timeline(t0: float, marks: dict) -> dict:
    """{label: seconds since the previous mark} of ordered marks."""
    out, last = {}, t0
    for label, t in marks.items():
        out[label], last = t - last, t
    return out


def _par_state_full(state) -> dict:
    """Rank 0's copy of a (possibly sharded) state's model, whole."""
    return {k: v.detach().cpu() for k, v in
            gathered_state(state).model.state_dict().items()}


def _par_counts(steps: int) -> dict:
    torch.cuda.synchronize()
    totals = collectives.staging_totals()
    return {"launches": bert_launches(),
            "host_staging_ms_per_step": totals["ms"] / steps,
            "host_staging_bytes_per_step": totals["bytes"] / steps,
            "host_staging_by_op": {k: dict(v) for k, v in
                                   collectives.STAGING.items()},
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def _par_start() -> float:
    reset_counts()
    collectives.reset_staging()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return time.perf_counter()


def _wait_for(path: str, timeout_s: float = 120.0) -> None:
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"{path} did not appear")
        time.sleep(0.1)


def _par_kernel_checks(mesh, batch, attention_rows: int | None) -> list:
    """The kernels at the shapes this rank's BERT part gives them: the
    scatter-add into its token table (its row shard over `model`) at its
    rows and sequence chunk, and, unless the ring check holds them, the
    flash pair at one attention call's shape (`attention_rows` rows of
    the chunk)."""
    gen = torch.Generator(device=mesh.device).manual_seed(SEED + 29)
    start, stop = mesh_lib.local_batch_range(mesh, len(batch["labels"]))
    chunk = SEQ_LEN // mesh.shape["seq"]
    first = mesh.coords["seq"] * chunk
    ids = hash_ids_host(batch["features"]["input_ids"][
        start:stop, first:first + chunk], VOCAB, mix=False)
    rows = VOCAB // mesh.shape["model"]
    checks = [shard_scatter_check(ids, mesh.coords["model"] * rows, rows,
                                  PAR_HIDDEN, gen, mesh.device)]
    if attention_rows is not None:
        checks += flash_pair_checks(
            (attention_rows, chunk, PAR_HEADS, PAR_HIDDEN // PAR_HEADS),
            gen, mesh.device)
    return checks


def par_ring(mesh, work: str) -> dict:
    """(a) BERT-base on model=2 x seq=2 from the carried init: 2 steps,
    a predict, the step saved; then one ring (2 blocks) of the flash
    kernels against the plain body at a rank's attention shape."""
    from elasticdl_tpu_torch.ops import ring_attention as ra

    t0 = time.perf_counter()
    spec = get_model_spec(ZOO_DIR, BERT, PAR_RING_PARAMS)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, use_bf16=True,
                      device=mesh.device,
                      param_sharding_fn=spec.param_sharding)
    batch = _rank_rows(bert_train_batch(), 0, PAR_BERT_BATCH)
    evals = _rank_rows(bert_train_batch(), PAR_BERT_BATCH,
                       2 * PAR_BERT_BATCH)["features"]
    state = trainer.init_state_global(SEED, batch["features"], mesh)
    marks = {"init": time.perf_counter()}
    init = os.path.join(work, "bert_init.pt")
    _wait_for(init)
    marks["wait_init"] = time.perf_counter()
    full = torch.load(init, map_location=mesh.device, weights_only=True)
    state.model.load_state_dict(
        shard_tree(full, state.shardings, mesh), strict=True)
    del full
    marks["load"] = time.perf_counter()
    shard = mesh_lib.make_global_batch(batch, mesh, trainer.stage_batch)
    t_steps = _par_start()
    losses = [float(trainer.train_on_global_batch(state, shard, mesh)[1])
              for _ in range(PAR_RING_STEPS)]
    out = _par_counts(PAR_RING_STEPS)
    out["steps_s"] = time.perf_counter() - t_steps
    out["losses"] = losses
    out["shards"] = {n: list(state.model.get_parameter(n).shape)
                     for n in state.shardings}
    marks["steps"] = time.perf_counter()
    out["predict"] = trainer.predict_on_global_batch(
        state, mesh_lib.make_global_batch({"features": evals}, mesh,
                                          trainer.stage_batch),
        mesh).tolist()
    marks["predict"] = time.perf_counter()
    saver = CheckpointSaver(os.path.join(work, "ckpt_ring"))
    saver.save(state)
    saver.close()
    dist.barrier()
    marks["save"] = time.perf_counter()
    del state, trainer, shard
    torch.cuda.empty_cache()
    # one ring of the kernels against the plain body (not counted)
    gen = torch.Generator(device=mesh.device).manual_seed(SEED + mesh.rank)
    shape = (PAR_BERT_BATCH, SEQ_LEN // 2, PAR_HEADS,
             PAR_HIDDEN // PAR_HEADS)
    q, k, v = (t.detach().requires_grad_() for t in
               make_qkv(shape, torch.bfloat16, gen, False))
    g = torch.randn(shape, generator=gen, device=mesh.device).to(
        torch.bfloat16)
    got, want = [], []
    for fn, into in ((lambda: ra._RingFlash.apply(
            q, k, v, mesh, "seq", False, shape[-1] ** -0.5), got),
            (lambda: ra._ring_attention_local(
                q, k, v, causal=False, scale=shape[-1] ** -0.5, mesh=mesh,
                axis="seq"), want)):
        q.grad = k.grad = v.grad = None
        y = fn()
        y.backward(g)
        into.extend([y.detach(), q.grad, k.grad, v.grad])
    errs = [float((a.float() - b.float()).abs().max())
            for a, b in zip(got, want)]
    scales = [float(b.float().abs().max()) for b in want]
    out["ring_check"] = {
        "shape": list(shape), "max_abs_err_out_dq_dk_dv": errs,
        "scales": scales,
        "ok": errs[0] <= PAR_RING_OUT_RTOL * scales[0] and all(
            e <= 2 * BWD_TOL[torch.bfloat16] * max(1.0, s)
            for e, s in zip(errs[1:], scales[1:]))}
    out["kernel_checks"] = _par_kernel_checks(mesh, batch, None)
    marks["checks"] = time.perf_counter()
    out["timeline_s"] = _timeline(t0, marks)
    out["seconds"] = time.perf_counter() - t0
    return out


def par_moe(mesh) -> dict:
    """(b) BERT-base with 4 experts on data=2 x expert=2: 3 steps on one
    batch; then layer_0's MoE on seeded tokens against the one-rank
    layer (its experts gathered) on the global tokens."""
    t0 = time.perf_counter()
    spec = get_model_spec(ZOO_DIR, BERT, PAR_MOE_PARAMS)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, use_bf16=True,
                      device=mesh.device,
                      param_sharding_fn=spec.param_sharding)
    batch = _rank_rows(bert_train_batch(), 0, PAR_MOE_BATCH)
    state = trainer.init_state_global(SEED, batch["features"], mesh)
    shard = mesh_lib.make_global_batch(batch, mesh, trainer.stage_batch)
    t_steps = _par_start()
    losses = [float(trainer.train_on_global_batch(state, shard, mesh)[1])
              for _ in range(PAR_STEPS)]
    out = _par_counts(PAR_STEPS)
    out["steps_s"] = time.perf_counter() - t_steps
    out["losses"] = losses
    out["shards"] = {n: list(state.model.get_parameter(n).shape)
                     for n in state.shardings}
    layer = state.model.layer_0.moe_mlp
    gen = torch.Generator(device=mesh.device).manual_seed(SEED + 17)
    x = torch.randn((PAR_MOE_BATCH, SEQ_LEN, PAR_HIDDEN), generator=gen,
                    device=mesh.device)
    start, stop = mesh_lib.local_batch_range(mesh, PAR_MOE_BATCH)
    with torch.no_grad():
        mesh_lib.set_current_mesh(mesh)
        mine = layer(x[start:stop])
        whole = copy.deepcopy(layer)
        for name, p in whole.named_parameters():
            spec_p = state.shardings.get(f"layer_0.moe_mlp.{name}")
            if spec_p is not None:
                p.data = gather_tensor(p.data, spec_p, mesh)
        with mesh_lib.using_mesh(mesh_lib.ProcessMesh()):
            ref = whole(x)[start:stop]
    err = float((mine - ref).abs().max())
    out["layer_check"] = {"experts_here": int(layer.expert_w_in.shape[0]),
                          "max_abs_err": err,
                          "scale": float(ref.abs().max()),
                          "ok": err <= PAR_MOE_TOL * max(
                              1.0, float(ref.abs().max()))}
    del state, trainer, shard, whole
    torch.cuda.empty_cache()
    out["kernel_checks"] = _par_kernel_checks(mesh, batch, stop - start)
    out["seconds"] = time.perf_counter() - t0
    return out


def par_pipe(mesh) -> dict:
    """(c) BERT-base with 4 microbatches on data=2 x pipe=2 (3 layers a
    stage): the logits and the step-1 gradients against the one-rank
    sequential run of the gathered model (on rank 0)."""
    t0 = time.perf_counter()
    spec = get_model_spec(ZOO_DIR, BERT, PAR_PIPE_PARAMS)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, use_bf16=True,
                      device=mesh.device,
                      param_sharding_fn=spec.param_sharding)
    batch = _rank_rows(bert_train_batch(), 0, PAR_BERT_BATCH)
    state = trainer.init_state_global(SEED, batch["features"], mesh)
    whole = gathered_state(state).model
    if mesh.rank != 0:
        del whole
    shard = mesh_lib.make_global_batch(batch, mesh, trainer.stage_batch)
    logits = trainer.predict_on_global_batch(state, shard, mesh)
    t_steps = _par_start()
    loss = float(trainer.train_on_global_batch(state, shard, mesh)[1])
    out = _par_counts(1)
    out["steps_s"] = time.perf_counter() - t_steps
    out["loss"] = loss
    out["shards"] = {n: list(state.model.get_parameter(n).shape)
                     for n in list(state.shardings)[:2]}
    grads = {n: gather_tensor(p.grad, state.shardings.get(n), mesh)
             for n, p in state.model.named_parameters()}
    if mesh.rank == 0:
        feats = _to_device(batch["features"], mesh.device)
        labels = _to_device(batch["labels"], mesh.device)
        with mesh_lib.using_mesh(mesh_lib.ProcessMesh()):
            whole.eval()
            with torch.no_grad():
                ref_logits = whole(feats).float().cpu().numpy()
            whole.train()
            spec.loss(labels, whole(feats).float()).backward()
        logit_err = float(np.abs(logits - ref_logits).max())
        errs = {}
        for name, p in whole.named_parameters():
            scale = max(1.0, float(p.grad.float().abs().max()))
            errs[name] = float((grads[name].float() - p.grad.float())
                               .abs().max()) / scale
        worst = max(errs, key=errs.get)
        out["check"] = {"logits_max_abs_err": logit_err,
                        "grad_worst": worst,
                        "grad_worst_scaled_err": errs[worst],
                        "ok": logit_err <= PAR_LOGITS_TOL
                        and errs[worst] <= PAR_PIPE_TOL}
        del whole
    del state, trainer, shard, grads
    torch.cuda.empty_cache()
    # the reference above runs the same kernel: hold it against its
    # plain version at a stage's microbatch
    start, stop = mesh_lib.local_batch_range(mesh, PAR_BERT_BATCH)
    out["kernel_checks"] = _par_kernel_checks(
        mesh, batch, (stop - start) // PAR_PIPE_MICRO)
    out["seconds"] = time.perf_counter() - t0
    return out


def par_deepfm(mesh, work: str) -> dict:
    """(d) DeepFM at the bench's vocab on data=2 x model=2: 4 steps, its
    shards, its scatter-add launches; then the kernel against its plain
    version at this shard's ids (bitwise, on CPU copies)."""
    t0 = time.perf_counter()
    batches = _criteo_batches(DP_STEPS, DP_BATCH, seed=DP_SEED)
    start, stop = mesh_lib.local_batch_range(mesh, DP_BATCH)
    spec = get_model_spec(ZOO_DIR, DEEPFM, DP_F32_PARAMS)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss,
                      device=mesh.device,
                      param_sharding_fn=spec.param_sharding)
    state = trainer.init_state_global(
        SEED, _rank_rows(batches[0], start, stop)["features"], mesh)
    t_steps = _par_start()
    losses = []
    for batch in batches:
        shard = mesh_lib.make_global_batch_from_local(
            _rank_rows(batch, start, stop), mesh, DP_BATCH, start,
            trainer.stage_batch)
        losses.append(float(trainer.train_on_global_batch(
            state, shard, mesh)[1]))
    out = _par_counts(DP_STEPS)
    out["steps_s"] = time.perf_counter() - t_steps
    out["losses"] = losses
    out["shards"] = {n: list(state.model.get_parameter(n).shape)
                     for n in state.shardings}
    full = _par_state_full(state)
    if mesh.rank == 0:
        torch.save(full, os.path.join(work, "pa_deepfm_rank0.pt"))
    del full, state, trainer
    # the kernel at this shard's ids
    rows = DEEPFM_VOCAB // mesh.shape["model"]
    ids = hash_field_rows_host(batches[0]["features"]["sparse"][start:stop],
                               DEEPFM_VOCAB)
    gen = torch.Generator(device=mesh.device).manual_seed(SEED + 23)
    out["kernel_checks"] = [
        shard_scatter_check(ids, mesh.coords["model"] * rows, rows, dim,
                            gen, mesh.device) for dim in (DEEPFM_DIM, 1)]
    out["seconds"] = time.perf_counter() - t0
    return out


# (f) the int8 arena over `model`: DeepFM at the bench's width (f32 MLP,
# as (d)) with int8 arenas, data=2 x model=2 against the one-rank run
# (losses within DP_LOSS_RTOL, each fold replayed whole, bit for bit),
# then data=1 x model=4, where no layout splits the batch, bit for bit
PAR_INT8_PARAMS = DP_F32_PARAMS + ";arena_dtype='int8'"
# (g) the tiered cache over `model`: a 2^20-row cache, batches of
# REAL_BATCH from the zipf(1.2) stream, f32 MLP.  The store is warmed
# to a vocabulary past the cache (PAR_TIERED_WARM batches planned in two
# blocks, as a resumed job's sidecar holds it: the ranks load it and
# write its resident rows), then PAR_TIERED_STEPS steps admit and evict
# (the stream's first evictions come in its 22nd batch)
PAR_TIERED_WARM = 22
PAR_TIERED_STEPS = 3
PAR_TIERED_SEED = SEED + 7


def par_tiered_params(cache_dtype: str) -> str:
    return (f"embed_dim={DEEPFM_DIM};bf16=False;lr=0.005;"
            f"cache_rows={REAL_CACHE};cache_dtype='{cache_dtype}'")


# (h) Switch MoE on tokens split over `seq`: BERT-base with 4 experts on
# seq=2 x expert=2, then layer_0's MoE at a capacity that drops tokens
PAR_MOE_SEQ_FACTOR = 0.5
PAR_MOE_SEQ_STEPS = 3


def _digests(tree: dict) -> dict:
    """sha256 of each tensor or array's bytes: two runs with equal
    digests hold the same bits."""
    import hashlib

    out = {}
    for name, value in sorted(tree.items()):
        arr = value.detach().cpu().contiguous().numpy() if isinstance(
            value, torch.Tensor) else np.ascontiguousarray(value)
        out[name] = hashlib.sha256(
            f"{arr.dtype}{arr.shape}".encode() + arr.tobytes()).hexdigest()
    return out


def _par_fold_replay(state, checks: list):
    """Wrap the trainer's fold: before each fold the rank gathers every
    int8 plane and carrier (a collective), folds the whole plane itself,
    and after the fold holds the gathered shards against that, bit for
    bit; the carrier must be zero after it.  Returns the unwrap."""
    from elasticdl_tpu_torch.layers import arena as arena_lib
    from elasticdl_tpu_torch.worker import trainer as trainer_lib

    fold = trainer_lib.fold_quantized_updates
    prefixes = ("fm_embedding", "fm_linear")

    def whole(name):
        return gather_tensor(state.model.state_dict()[name],
                             ("model", None), state.mesh)

    def replayed(model, step):
        want = {}
        for p in prefixes:
            key = arena_lib.fold_key(step, (p, "embedding"))
            want[p] = arena_lib._requantize_plane(
                whole(f"{p}.q8"), whole(f"{p}.scale"),
                whole(f"{p}.embedding"), key)
        n = fold(model, step)
        for p in prefixes:
            q8, scale = whole(f"{p}.q8"), whole(f"{p}.scale")
            checks.append({
                "step": int(step), "plane": p,
                "q8_equal": bool(torch.equal(q8, want[p][0])),
                "scale_equal": bool(torch.equal(scale, want[p][1])),
                "carrier_zero": not bool(model.get_parameter(
                    f"{p}.embedding").detach().any())})
        return n

    trainer_lib.fold_quantized_updates = replayed
    return lambda: setattr(trainer_lib, "fold_quantized_updates", fold)


def par_int8_layout(mesh, batches, replay: bool) -> dict:
    """int8 DeepFM over `batches` on `mesh` from SEED's init: losses,
    launches, the gathered state's digests (rank 0) and, with `replay`,
    every fold replayed whole."""
    spec = get_model_spec(ZOO_DIR, DEEPFM, PAR_INT8_PARAMS)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss,
                      device=mesh.device,
                      param_sharding_fn=spec.param_sharding)
    start, stop = mesh_lib.local_batch_range(mesh, DP_BATCH)
    state = trainer.init_state_global(
        SEED, _rank_rows(batches[0], start, stop)["features"], mesh)
    checks = []
    unwrap = _par_fold_replay(state, checks) if replay else None
    t_steps = _par_start()
    losses = []
    for batch in batches:
        shard = mesh_lib.make_global_batch_from_local(
            _rank_rows(batch, start, stop), mesh, DP_BATCH, start,
            trainer.stage_batch)
        losses.append(float(trainer.train_on_global_batch(
            state, shard, mesh)[1]))
    out = _par_counts(len(batches))
    out["steps_s"] = time.perf_counter() - t_steps
    if unwrap is not None:
        unwrap()
        out["fold_checks"] = checks
    out["losses"] = losses
    out["shards"] = {n: list(state.model.state_dict()[n].shape)
                     for n in state.shardings}
    whole = _par_state_full(state)
    out["digests"] = _digests(whole) if mesh.rank == 0 else None
    del state, trainer, whole
    torch.cuda.empty_cache()
    return out


def par_int8(mesh, rank: int, device: str) -> dict:
    """(f) on data=2 x model=2 (`mesh`), then on data=1 x model=4; the
    kernel against its plain version at this rank's shard ids."""
    t0 = time.perf_counter()
    batches = _criteo_batches(DP_STEPS, DP_BATCH, seed=DP_SEED)
    out = par_int8_layout(mesh, batches, replay=True)
    m4 = mesh_lib.create_mesh(PAR_RANKS, rank, device, data=1, model=4)
    out["model4"] = par_int8_layout(m4, batches, replay=False)
    start, stop = mesh_lib.local_batch_range(mesh, DP_BATCH)
    rows = DEEPFM_VOCAB // mesh.shape["model"]
    ids = hash_field_rows_host(batches[0]["features"]["sparse"][start:stop],
                               DEEPFM_VOCAB)
    gen = torch.Generator(device=mesh.device).manual_seed(SEED + 31)
    out["kernel_checks"] = [
        shard_scatter_check(ids, mesh.coords["model"] * rows, rows, dim,
                            gen, mesh.device) for dim in (DEEPFM_DIM, 1)]
    out["seconds"] = time.perf_counter() - t0
    return out, m4


def par_alone_times(device, tiered_slots) -> dict:
    """After the ranks exit, the card to itself: the kernels against
    their plain versions, with their CUDA-event ms, at the new parts'
    shapes (the scatter-add at (f)'s ids of data coordinate 0 into each
    2^19-row shard, at (g)'s slots of those rows into each cache block;
    the flash pair at (h)'s ring block), and the fold of a 2^19-row
    shard (its rows' draw alone) and of the whole plane."""
    if torch.device(device).type == "cuda":
        # the card idled while this process waited for the ranks: busy
        # it first, so the timings start at its working clocks
        a = torch.randn((4096, 4096), device=device)
        for _ in range(150):      # ~2 ms each in f32
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()
    gen = torch.Generator(device=device).manual_seed(SEED + 41)
    sparse = _criteo_batches(1, DP_BATCH, seed=DP_SEED)[0]["features"][
        "sparse"][:DP_BATCH // 2]
    ids = hash_field_rows_host(sparse, DEEPFM_VOCAB)
    rows, block = DEEPFM_VOCAB // 2, REAL_CACHE // 2
    return {
        "int8_shard": [shard_scatter_check(ids, m * rows, rows, dim, gen,
                                           device)
                       for m in (0, 1) for dim in (DEEPFM_DIM, 1)],
        "tiered_block": [shard_scatter_check(tiered_slots, m * block, block,
                                             dim, gen, device)
                         for m in (0, 1) for dim in (DEEPFM_DIM, 1)],
        "flash_ring_block": flash_pair_checks(
            (PAR_MOE_BATCH, SEQ_LEN // 2, PAR_HEADS,
             PAR_HIDDEN // PAR_HEADS), gen, device),
        "fold_ms": par_fold_draw_ms(rows, rows, gen, device)}


def par_fold_draw_ms(rows: int, first: int, gen, device) -> dict:
    """The fold of one (rows, 16) shard at global row `first` of a
    2^20-row plane (every row touched), which draws only the shard's
    uniforms (keyed on their global rows), against the fold of the whole
    plane: CUDA event ms per fold."""
    from elasticdl_tpu_torch.layers import arena as arena_lib

    q8, scale = arena_lib.quantize_rows(torch.randn(
        (DEEPFM_VOCAB, DEEPFM_DIM), generator=gen, device=device) * 0.05)
    delta = torch.randn((DEEPFM_VOCAB, DEEPFM_DIM), generator=gen,
                        device=device) * 1e-3
    key = arena_lib.fold_key(torch.tensor(SEED, device=device),
                             ("fm_embedding", "embedding"))
    part = slice(first, first + rows)
    shard = lambda: arena_lib._requantize_plane(  # noqa: E731
        q8[part], scale[part], delta[part], key, first)
    whole = lambda: arena_lib._requantize_plane(  # noqa: E731
        q8, scale, delta, key)
    if torch.device(device).type != "cuda":
        return {}
    return {"shard_fold": time_ms(shard, 20),
            "whole_plane_fold": time_ms(whole, 20),
            "shard_fold_again": time_ms(shard, 20)}


_PAR_TIERED_BATCHES = []


def par_tiered_batches() -> tuple:
    """The zipf stream's warm-up batches' sparse ids and the steps'
    batches (made once a process)."""
    if not _PAR_TIERED_BATCHES:
        stream = zipf_stream(PAR_TIERED_SEED)
        warm = [next(stream)["features"]["sparse"]
                for _ in range(PAR_TIERED_WARM)]
        _PAR_TIERED_BATCHES.extend(
            (warm, [next(stream) for _ in range(PAR_TIERED_STEPS)]))
    return tuple(_PAR_TIERED_BATCHES)


def par_tiered_warm(path: str) -> None:
    """Plan the warm-up batches in two blocks on a store and save its
    host tier and cache map (what a sidecar holds) at `path`."""
    warm, _ = par_tiered_batches()
    store = tiered_zoo.TieredStore(TIERED_PLANES, NUM_SPARSE, REAL_CACHE)
    half = PAR_TIERED_WARM // 2
    store.prepare_block(warm[:half])
    store.prepare_block(warm[half:])
    row_of, score, _ = store.cache.state_arrays()
    np.savez(path + ".tmp.npz", row_of=row_of, score=score,
             **{f"host__{k}": v for k, v in store.host.state_dict().items()})
    os.replace(path + ".tmp.npz", path)


_PAR_WARM = {}


def _par_warm_arrays(path: str) -> dict:
    """The warm store's arrays, read once a process."""
    if path not in _PAR_WARM:
        with np.load(path) as warm:
            _PAR_WARM[path] = {k: warm[k] for k in warm.files}
    return _PAR_WARM[path]


def par_tiered_run(mesh, cache_dtype: str, warm_path: str,
                   digests: bool) -> dict:
    """The tiered DeepFM on `mesh` (a world of one for the reference):
    the warm store loaded and its resident rows written to the cache,
    then the steps; per step the plan's digest and counts, prepare ms,
    and whether this rank admitted exactly its sub-plan; the hit rate
    and the launches; with `digests`, those of the gathered state,
    cache tables and host tier at the end (rank 0)."""
    spec = get_model_spec(ZOO_DIR, TIERED, par_tiered_params(cache_dtype))
    trainer = Trainer(spec.model, spec.optimizer, spec.loss,
                      device=mesh.device,
                      param_sharding_fn=spec.param_sharding)
    store = tiered_zoo.build_tiered_store()
    trainer.tiered_store = store
    _, steps = par_tiered_batches()
    sample = {"dense": steps[0]["features"]["dense"],
              "slots": np.zeros((REAL_BATCH, NUM_SPARSE), np.int32)}
    setup = {"t0": time.perf_counter()}
    state = trainer.init_state_global(SEED, sample, mesh)
    setup["init"] = time.perf_counter()
    warm = _par_warm_arrays(warm_path)
    store.load_sidecar_state(
        {k[6:]: v for k, v in warm.items() if k.startswith("host__")},
        warm["row_of"], warm["score"])
    setup["load"] = time.perf_counter()
    # the resident rows of this rank's block, written as a restore
    # writes the checkpoint's cache values
    slots = np.nonzero(store.cache.row_of >= 0)[0]
    block = REAL_CACHE // mesh.shape["model"]
    slots = slots[slots // block == mesh.coords["model"]]
    store_device.apply_admissions(
        state, store.param_paths, slots,
        store.host.gather(store.cache.row_of[slots]),
        cache_dtype=cache_dtype)
    setup["admit"] = time.perf_counter()
    admitted = []
    admit = store_device.apply_admissions

    def recorded(state_, paths, slots_, *args, **kwargs):
        admitted.append(np.asarray(slots_).copy())
        return admit(state_, paths, slots_, *args, **kwargs)

    store_device.apply_admissions = recorded
    model = mesh.coords["model"]
    t_steps = _par_start()
    per_step = []
    try:
        for batch in steps:
            t0 = time.perf_counter()
            batch = store.attach(batch)
            prepare_ms = (time.perf_counter() - t0) * 1e3
            plan = batch["__store_plan__"]
            del admitted[:]
            shard = mesh_lib.make_global_batch(batch, mesh,
                                               trainer.stage_batch)
            if not per_step:
                start, stop = mesh_lib.local_batch_range(mesh, REAL_BATCH)
                first_slots = plan.slots[start:stop]
            loss = float(trainer.train_on_global_batch(state, shard,
                                                       mesh)[1])
            mine = np.concatenate(admitted) if admitted else np.zeros(0)
            want = plan.admit_slots if plan.sub_plans is None else \
                plan.sub_plans[model]["admit_slots"]
            per_step.append({
                "loss": loss, "digest": plan.digest(),
                "admits": int(plan.admit_rows.size),
                "evicts": int(plan.evict_rows.size),
                "prepare_ms": prepare_ms,
                "admits_sub_plan": bool(np.array_equal(mine, want))})
    finally:
        store_device.apply_admissions = admit
    out = _par_counts(len(steps))
    out["steps_s"] = time.perf_counter() - t_steps
    out["setup_s"] = {k: setup[k] - setup[p] for p, k in (
        ("t0", "init"), ("init", "load"), ("load", "admit"))}
    out["steps"] = per_step
    out["losses"] = [s["loss"] for s in per_step]
    stats = store.stats()
    out["hit_rate"] = stats["hit_rate"]
    out["vocab_rows"] = stats["vocab_rows"]
    out["mesh_shards"] = store.mesh_shards
    out["first_slots"] = first_slots
    if digests:
        tables = store_device.read_full_tables(state, store.param_paths,
                                               cache_dtype=cache_dtype)
        whole = _par_state_full(state)
        if mesh.rank == 0:
            out["digests"] = {"state": _digests(whole),
                              "cache": _digests(tables),
                              "host": _digests(store.host.state_dict())}
        del whole, tables
    del state, trainer
    torch.cuda.empty_cache()
    return out


def par_tiered(meshes: dict, work: str) -> dict:
    """(g) each cache dtype on data=2 x model=2 and data=1 x model=4;
    the kernel against its plain version at a cache block's slots."""
    t0 = time.perf_counter()
    warm = os.path.join(work, "tiered_warm.npz")
    _wait_for(warm, timeout_s=300.0)
    out = {"wait_warm_s": time.perf_counter() - t0}
    for cache_dtype in ("float32", "int8"):
        for layout, mesh in meshes.items():
            # model=4 splits no batch: its state is held bit for bit
            t_run = time.perf_counter()
            out[f"{cache_dtype}_{layout}"] = par_tiered_run(
                mesh, cache_dtype, warm, digests=layout == "m4")
            out[f"{cache_dtype}_{layout}"]["run_s"] = \
                time.perf_counter() - t_run
    first = out["float32_dm"]
    for key in ("launches", "steps_s", "host_staging_ms_per_step",
                "host_staging_by_op", "peak_memory_bytes"):
        out[key] = first[key]
    # the kernel at the slots of this rank's rows of the first step
    mesh = meshes["dm"]
    rows = REAL_CACHE // mesh.shape["model"]
    slots = first.pop("first_slots")
    for run in out.values():
        if isinstance(run, dict):
            run.pop("first_slots", None)
    gen = torch.Generator(device=mesh.device).manual_seed(SEED + 37)
    out["kernel_checks"] = [
        shard_scatter_check(slots, mesh.coords["model"] * rows, rows, dim,
                            gen, mesh.device) for dim in (DEEPFM_DIM, 1)]
    out["seconds"] = time.perf_counter() - t0
    return out


def record_routes(model) -> tuple:
    """Hooks on every MoE router of `model`: each forward appends its
    tokens' chosen experts (the router's argmax, uint8 on the host) to
    the list returned; the second value removes the hooks."""
    routes = []
    handles = [m.router.register_forward_hook(
        lambda mod, inp, out: routes.append(
            out.argmax(-1).to(torch.uint8).cpu()))
        for name, m in model.named_modules() if name.endswith("moe_mlp")]
    return routes, lambda: [h.remove() for h in handles]


def rerouted_tokens(rank_routes: list, one_routes: list, seq: int,
                    chunks: int) -> list:
    """Per router call, how many of a seq chunk's tokens chose another
    expert than the one-rank run chose for them (its routes cut to the
    chunk's columns)."""
    out = []
    for mine, one in zip(rank_routes, one_routes):
        cols = one.reshape(PAR_MOE_BATCH, -1)
        width = cols.shape[1] // chunks
        want = cols[:, seq * width:(seq + 1) * width].reshape(-1)
        out.append(int((mine.reshape(-1) != want).sum()))
    return out


def par_moe_seq(mesh, work: str) -> dict:
    """(h) BERT-base with 4 experts on seq=2 x expert=2:
    PAR_MOE_SEQ_STEPS steps on one batch, every router's choice of each
    token recorded (`moe_routes_rank<R>.pt` in `work`); then layer_0's
    MoE at PAR_MOE_SEQ_FACTOR on seeded f32 tokens against the one-rank
    layer (its experts gathered) on the global tokens."""
    t0 = time.perf_counter()
    spec = get_model_spec(ZOO_DIR, BERT, PAR_MOE_SEQ_PARAMS)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, use_bf16=True,
                      device=mesh.device,
                      param_sharding_fn=spec.param_sharding)
    batch = _rank_rows(bert_train_batch(), 0, PAR_MOE_BATCH)
    state = trainer.init_state_global(SEED, batch["features"], mesh)
    shard = mesh_lib.make_global_batch(batch, mesh, trainer.stage_batch)
    routes, unhook = record_routes(state.model)
    t_steps = _par_start()
    losses = [float(trainer.train_on_global_batch(state, shard, mesh)[1])
              for _ in range(PAR_MOE_SEQ_STEPS)]
    unhook()
    torch.save(routes, os.path.join(work, f"moe_routes_rank{mesh.rank}.pt"))
    out = _par_counts(PAR_MOE_SEQ_STEPS)
    out["steps_s"] = time.perf_counter() - t_steps
    out["losses"] = losses
    out["coords"] = dict(mesh.coords)
    out["shards"] = {n: list(state.model.get_parameter(n).shape)
                     for n in state.shardings}
    layer = state.model.layer_0.moe_mlp
    layer.capacity_factor = PAR_MOE_SEQ_FACTOR
    gen = torch.Generator(device=mesh.device).manual_seed(SEED + 19)
    x = torch.randn((PAR_MOE_BATCH, SEQ_LEN, PAR_HIDDEN), generator=gen,
                    device=mesh.device)
    chunk = SEQ_LEN // mesh.shape["seq"]
    first = mesh.coords["seq"] * chunk
    with torch.no_grad():
        mesh_lib.set_current_mesh(mesh)
        mine = layer(x[:, first:first + chunk])
        whole = copy.deepcopy(layer)
        for name, p in whole.named_parameters():
            spec_p = state.shardings.get(f"layer_0.moe_mlp.{name}")
            if spec_p is not None:
                p.data = gather_tensor(p.data, spec_p, mesh)
        with mesh_lib.using_mesh(mesh_lib.ProcessMesh()):
            ref = whole(x)
    dropped = int((ref.abs().sum(-1) == 0).sum())
    ref = ref[:, first:first + chunk]
    err = float((mine - ref).abs().max())
    out["layer_check"] = {
        "experts_here": int(layer.expert_w_in.shape[0]),
        "capacity_factor": PAR_MOE_SEQ_FACTOR,
        "dropped_tokens": dropped, "max_abs_err": err,
        "bitwise": bool(torch.equal(mine, ref)),
        "scale": float(ref.abs().max()),
        "ok": dropped > 0 and err <= PAR_MOE_TOL * max(
            1.0, float(ref.abs().max()))}
    del state, trainer, shard, whole
    torch.cuda.empty_cache()
    out["kernel_checks"] = _par_kernel_checks(mesh, batch, PAR_MOE_BATCH)
    out["seconds"] = time.perf_counter() - t0
    return out


def parallel_rank(rank: int, work: str, port: int,
                  device: str = "cuda") -> int:
    """One rank of the parallel_axes world (a process of its own,
    `chip_smoke.py --parallel-rank R WORK PORT DEVICE`): (a) to (d) and
    (f) to (h), each on its own mesh over the one default group."""
    t0 = time.perf_counter()
    mesh = mesh_lib.create_mesh(PAR_RANKS, rank, device,
                                f"127.0.0.1:{port}", init_timeout_s=120.0,
                                collective_timeout_s=300.0, model=2, seq=2)
    out = {"rank": rank, "backend": mesh.backend,
           "join_s": time.perf_counter() - t0}
    out["ring"] = par_ring(mesh, work)
    torch.cuda.empty_cache()
    mesh = mesh_lib.create_mesh(PAR_RANKS, rank, device, data=2, expert=2)
    out["moe"] = par_moe(mesh)
    torch.cuda.empty_cache()
    mesh = mesh_lib.create_mesh(PAR_RANKS, rank, device, data=2, pipe=2)
    out["gpipe"] = par_pipe(mesh)
    torch.cuda.empty_cache()
    mesh = mesh_lib.create_mesh(PAR_RANKS, rank, device, data=2, model=2)
    out["deepfm"] = par_deepfm(mesh, work)
    out["coords"] = {"deepfm": dict(mesh.coords)}
    torch.cuda.empty_cache()
    out["int8"], model4 = par_int8(mesh, rank, device)
    out["tiered"] = par_tiered({"dm": mesh, "m4": model4}, work)
    mesh = mesh_lib.create_mesh(PAR_RANKS, rank, device, seq=PAR_SEQ_CHUNKS,
                                expert=2)
    out["moe_seq"] = par_moe_seq(mesh, work)
    with open(os.path.join(work, f"par_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    mesh_lib.destroy_mesh(mesh)
    return 0


def parallel_axes(card: str, work: str, device: str = "cuda") -> tuple:
    """Item 19: one world of 4 processes sharing the card (gloo) runs
    (a) to (d) in turn, each on its own mesh; this process writes the
    carried BERT init, runs the one-rank references of (a) and (d) while
    the ranks work, then (e) restores (a)'s step on one rank.  Returns
    (summary, launches by path)."""
    t0 = time.perf_counter()
    root = os.path.join(work, "parallel_axes")
    os.makedirs(root, exist_ok=True)
    port = free_port()
    env = dict(os.environ, **bytecode_env(work))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank",
         str(rank), root, str(port), device], cwd=ROOT, env=env)
        for rank in range(PAR_RANKS)]
    try:
        dev = mesh_lib.device_for_rank(0, device)
        # (a)'s one-rank run, from the init the ranks carry
        spec = get_model_spec(ZOO_DIR, BERT, PAR_RING_PARAMS)
        trainer = Trainer(spec.model, spec.optimizer, spec.loss,
                          use_bf16=True, device=dev)
        batch = _rank_rows(bert_train_batch(), 0, PAR_BERT_BATCH)
        evals = _rank_rows(bert_train_batch(), PAR_BERT_BATCH,
                           2 * PAR_BERT_BATCH)["features"]
        state = trainer.init_state(SEED, batch["features"])
        init = os.path.join(root, "bert_init.pt")
        torch.save(state.model.state_dict(), init + ".tmp")
        os.replace(init + ".tmp", init)
        one_rank_losses = [float(trainer.train_on_batch(state, batch)[1])
                           for _ in range(PAR_RING_STEPS)]
        del state
        # (d)'s one-rank run
        mesh1 = mesh_lib.DataMesh(1, 0, dev, "", None)
        batches = _criteo_batches(DP_STEPS, DP_BATCH, seed=DP_SEED)
        fm_state, fm_losses = dp_deepfm(mesh1, DP_F32_PARAMS, False,
                                        batches, 0, DP_BATCH)
        fm_one = _state_cpu(fm_state)
        del fm_state
        torch.cuda.empty_cache()
        # (g)'s warm store, which the ranks wait for; then the one-rank
        # runs of (f), (g) and (h)
        warm = os.path.join(root, "tiered_warm.npz")
        t_warm = time.perf_counter()
        par_tiered_warm(warm)
        warm_s = time.perf_counter() - t_warm
        int8_one = par_int8_layout(mesh1, batches, replay=False)
        tiered_one = {d: par_tiered_run(mesh1, d, warm, digests=True)
                      for d in ("float32", "int8")}
        # (h)'s one-rank run (its steps as graphs), then the same steps
        # on the eager loop for the routes (a replay runs no hook)
        spec = get_model_spec(ZOO_DIR, BERT, PAR_MOE_SEQ_PARAMS)
        trainer = Trainer(spec.model, spec.optimizer, spec.loss,
                          use_bf16=True, device=dev)
        batch = _rank_rows(bert_train_batch(), 0, PAR_MOE_BATCH)
        state = trainer.init_state(SEED, batch["features"])
        moe_one_losses = [float(trainer.train_on_batch(state, batch)[1])
                          for _ in range(PAR_MOE_SEQ_STEPS)]
        state = trainer.init_state(SEED, batch["features"])
        one_routes, unhook = record_routes(state.model)
        with graphs_lib.eager_loop():
            moe_eager_losses = [
                float(trainer.train_on_batch(state, batch)[1])
                for _ in range(PAR_MOE_SEQ_STEPS)]
        unhook()
        del state, trainer
        torch.cuda.empty_cache()
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    t_ranks = time.perf_counter()
    if codes != [0] * PAR_RANKS:
        raise AssertionError(f"parallel_axes ranks exited {codes}")
    ranks = []
    for rank in range(PAR_RANKS):
        with open(os.path.join(root, f"par_rank{rank}.json")) as f:
            ranks.append(json.load(f))
    # (h): the tokens each seq chunk routed to another expert than the
    # one-rank run did, per router call (the ranks of one expert
    # coordinate cover the tokens once)
    reroutes = {}
    for r in ranks:
        coords = r["moe_seq"]["coords"]
        if coords["expert"] == 0:
            reroutes[coords["seq"]] = rerouted_tokens(
                torch.load(os.path.join(root,
                                        f"moe_routes_rank{r['rank']}.pt")),
                one_routes, coords["seq"], PAR_SEQ_CHUNKS)
    # (e) (a)'s step, saved on 4 ranks, restored on one
    t_e = time.perf_counter()
    spec = get_model_spec(ZOO_DIR, BERT, PAR_RING_PARAMS)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss,
                      use_bf16=True, device=dev)
    state = trainer.init_state(SEED + 1, evals)
    restored = CheckpointSaver(os.path.join(root, "ckpt_ring")
                               ).maybe_restore(state)
    logits = trainer.predict_on_batch(restored, evals)
    ring_logits = np.asarray(ranks[0]["ring"]["predict"])
    restore = {"step": int(restored.step),
               "logits_max_abs_err_vs_ranks": float(
                   np.abs(logits - ring_logits).max()),
               "seconds": time.perf_counter() - t_e}
    del state, restored
    alone = par_alone_times(dev, tiered_one["float32"]["first_slots"][
        :REAL_BATCH // 2])
    two = torch.load(os.path.join(root, "pa_deepfm_rank0.pt"))
    fm_err = max(float((two[k].float() - fm_one[k].float()).abs().max())
                 for k in fm_one if fm_one[k].is_floating_point())
    shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    layers, cut = NUM_LAYERS, PAR_CUT_LAYERS
    want = {
        # 2 ring blocks a layer a step; the token table's shard
        "ring": {"fwd": 2 * cut * PAR_RING_STEPS,
                 "bwd": 2 * cut * PAR_RING_STEPS,
                 "scatter": PAR_RING_STEPS},
        "moe": {"fwd": cut * PAR_STEPS, "bwd": cut * PAR_STEPS,
                "scatter": PAR_STEPS},
        # 4 microbatches x 3 layers a stage, one step; every stage runs
        # the token table (stage 1's backward scatters zero rows: its
        # input took no gradient)
        "gpipe": {"fwd": 4 * cut // 2, "bwd": 4 * cut // 2,
                  "scatter": 1},
        "deepfm": {"scatter": 2 * DP_STEPS},
        # two arenas a step, on data=2 x model=2
        "int8": {"scatter": 2 * DP_STEPS},
        # two cache planes a step, the fp32 cache on data=2 x model=2
        "tiered": {"scatter": 2 * PAR_TIERED_STEPS},
        # 2 ring blocks a layer, 3 steps; the whole token table
        "moe_seq": {"fwd": 2 * layers * PAR_MOE_SEQ_STEPS,
                    "bwd": 2 * layers * PAR_MOE_SEQ_STEPS,
                    "scatter": PAR_MOE_SEQ_STEPS}}
    bad = []
    for r in ranks:
        for part, counts in want.items():
            got = r[part]["launches"]
            if "fwd" in counts and (
                    got["flash_attention_fwd_by_variant"]
                    != {fa.SM90_WGMMA: counts["fwd"], fa.CUDA_CORE: 0}
                    or got["flash_attention_bwd_by_variant"]
                    != {fa.SM90_WGMMA: counts["bwd"], fa.CUDA_CORE: 0}):
                bad.append((r["rank"], part, got))
            if got["scatter_add"] != counts["scatter"]:
                bad.append((r["rank"], part, "scatter", got["scatter_add"]))
        # the other runs of (f) and (g): one scatter-add per table a step
        runs = [("int8_model4", r["int8"]["model4"], DP_STEPS)] + [
            (f"tiered_{k}", v, PAR_TIERED_STEPS) for k, v in
            r["tiered"].items() if k.startswith(("float32_", "int8_"))]
        for label, run, steps in runs:
            if run["launches"]["scatter_add"] != 2 * steps:
                bad.append((r["rank"], label, "scatter",
                            run["launches"]["scatter_add"]))
    int8 = {"losses_by_rank": [r["int8"]["losses"] for r in ranks],
            "one_rank_losses": int8_one["losses"],
            "loss_max_rel_err": max(
                abs(a - b) / abs(b) for r in ranks for a, b in
                zip(r["int8"]["losses"], int8_one["losses"])),
            "folds_replayed": sum(len(r["int8"]["fold_checks"])
                                  for r in ranks),
            "folds_bitwise": all(
                c["q8_equal"] and c["scale_equal"] and c["carrier_zero"]
                for r in ranks for c in r["int8"]["fold_checks"]),
            "model4_losses_equal": all(
                r["int8"]["model4"]["losses"] == int8_one["losses"]
                for r in ranks),
            "model4_state_bitwise":
                ranks[0]["int8"]["model4"]["digests"]
                == int8_one["digests"],
            "shards": ranks[0]["int8"]["shards"],
            "model4_shards": ranks[0]["int8"]["model4"]["shards"]}
    tiered = {"warm_s": warm_s,
              "wait_warm_s_by_rank": [r["tiered"]["wait_warm_s"]
                                      for r in ranks]}
    for d, one in tiered_one.items():
        runs = {layout: [r["tiered"][f"{d}_{layout}"] for r in ranks]
                for layout in ("dm", "m4")}
        plan_digests = [s["digest"] for s in one["steps"]]
        tiered[d] = {
            "one_rank_losses": one["losses"],
            "losses_by_layout_rank0": {k: v[0]["losses"]
                                       for k, v in runs.items()},
            "dm_loss_max_rel_err": max(
                abs(a - b) / abs(b) for run in runs["dm"] for a, b in
                zip(run["losses"], one["losses"])),
            "plans_equal": all([s["digest"] for s in run["steps"]]
                               == plan_digests for v in runs.values()
                               for run in v),
            "admits_sub_plans": all(s["admits_sub_plan"]
                                    for v in runs.values() for run in v
                                    for s in run["steps"]),
            "evicts_by_step": [s["evicts"] for s in one["steps"]],
            "admits_by_step": [s["admits"] for s in one["steps"]],
            "mesh_shards": {k: v[0]["mesh_shards"] for k, v in runs.items()},
            "m4_bitwise": runs["m4"][0]["digests"] == one["digests"],
            "m4_losses_equal": all(run["losses"] == one["losses"]
                                   for run in runs["m4"]),
            "hit_rate": {"one": one["hit_rate"],
                         **{k: v[0]["hit_rate"] for k, v in runs.items()}},
            "vocab_rows": one["vocab_rows"],
            "prepare_ms_by_step_rank0": {
                k: [s["prepare_ms"] for s in v[0]["steps"]]
                for k, v in runs.items()},
            "setup_s_rank0": {k: v[0]["setup_s"] for k, v in runs.items()},
            "run_s_rank0": {k: v[0]["run_s"] for k, v in runs.items()},
            "steps_s_rank0": {k: v[0]["steps_s"] for k, v in runs.items()}}
    moe_seq = {"losses_by_rank": [r["moe_seq"]["losses"] for r in ranks],
               "one_rank_losses": moe_one_losses,
               # the routes' run: the same steps on the eager loop
               "one_rank_eager_losses": moe_eager_losses,
               "loss_max_scaled_err": max(
                   abs(a - b) / max(1.0, abs(b)) for r in ranks
                   for a, b in zip(r["moe_seq"]["losses"],
                                   moe_one_losses)),
               "shards": ranks[0]["moe_seq"]["shards"],
               "layer_check_by_rank": [r["moe_seq"]["layer_check"]
                                       for r in ranks]}
    by_call = [sum(calls) for calls in zip(*reroutes.values())]
    moe_seq["rerouted_tokens"] = {
        "total": sum(by_call), "router_calls": len(by_call),
        "tokens_per_call": int(one_routes[0].numel()) if one_routes else 0,
        "by_call": by_call,
        # the calls run step by step, every router once a forward
        "by_step": [int(part.sum()) for part in np.array_split(
            np.asarray(by_call, np.int64), PAR_MOE_SEQ_STEPS)]}
    print(f"parallel_axes moe_seq: {moe_seq['rerouted_tokens']['total']} "
          f"token routings of {len(by_call)} x "
          f"{moe_seq['rerouted_tokens']['tokens_per_call']} chose another "
          f"expert than one rank's, beside a loss gap of "
          f"{moe_seq['loss_max_scaled_err']:.5f} (bound {PAR_LOSS_RTOL}) "
          f"[{card}]", flush=True)
    summary = {
        "card": card, "ranks": PAR_RANKS, "backend_by_rank": [
            r["backend"] for r in ranks],
        "seconds": seconds, "budget_s": PAR_BUDGET_S,
        # the ranks' start and group join, and this process's work after
        # they exit ((e), the kernels alone, the checks)
        "join_s_by_rank": [r["join_s"] for r in ranks],
        "after_ranks_s": seconds - (t_ranks - t0),
        "ring": {"losses_by_rank": [r["ring"]["losses"] for r in ranks],
                 "one_rank_losses": one_rank_losses,
                 "loss_max_scaled_err": max(
                     abs(a - b) / max(1.0, abs(b)) for r in ranks
                     for a, b in zip(r["ring"]["losses"],
                                     one_rank_losses)),
                 "shards": ranks[0]["ring"]["shards"],
                 "ring_check_by_rank": [r["ring"]["ring_check"]
                                        for r in ranks],
                 "timeline_s_rank0": ranks[0]["ring"]["timeline_s"]},
        "moe": {"losses_by_rank": [r["moe"]["losses"] for r in ranks],
                "shards": ranks[0]["moe"]["shards"],
                "layer_check_by_rank": [r["moe"]["layer_check"]
                                        for r in ranks]},
        "gpipe": {"loss_by_rank": [r["gpipe"]["loss"] for r in ranks],
                  "shards": ranks[0]["gpipe"]["shards"],
                  "check": ranks[0]["gpipe"]["check"]},
        "deepfm": {"losses_by_rank": [r["deepfm"]["losses"]
                                      for r in ranks],
                   "one_rank_losses": fm_losses,
                   "loss_max_rel_err": max(
                       abs(a - b) / abs(b) for r in ranks for a, b in
                       zip(r["deepfm"]["losses"], fm_losses)),
                   "max_abs_err_vs_one_rank": fm_err,
                   "shards": ranks[0]["deepfm"]["shards"]},
        "int8": int8, "tiered": tiered, "moe_seq": moe_seq,
        "kernels_alone": alone, "restore": restore,
        # each kernel against its plain version at the shapes each part
        # gives it on each rank
        "kernel_checks_by_part": {part: [r[part]["kernel_checks"]
                                         for r in ranks] for part in want},
        "by_part": {part: {
            "seconds_by_rank": [r[part]["seconds"] for r in ranks],
            "steps_s_by_rank": [r[part]["steps_s"] for r in ranks],
            "host_staging_ms_per_step_by_rank": [
                r[part]["host_staging_ms_per_step"] for r in ranks],
            "host_staging_by_op_rank0": r0[part]["host_staging_by_op"],
            "peak_memory_bytes_by_rank": [r[part]["peak_memory_bytes"]
                                          for r in ranks]}
            for r0 in ranks[:1] for part in want},
        "launches_by_rank": {part: [r[part]["launches"] for r in ranks]
                             for part in want}}
    print(json.dumps({"parallel_axes": summary}), flush=True)
    for part, row in summary["by_part"].items():
        print(f"parallel_axes {part}: {np.max(row['seconds_by_rank']):.1f} "
              f"s, host staging "
              f"{np.max(row['host_staging_ms_per_step_by_rank']):.1f} "
              f"ms/step, peak "
              f"{np.max(row['peak_memory_bytes_by_rank']) / 2**30:.2f} "
              f"GiB/rank [{card}]", flush=True)
    print(f"parallel_axes phase: {seconds:.1f} s (budget {PAR_BUDGET_S} s) "
          f"[{card}]", flush=True)
    ring, moe, pipe, fm = (summary[k] for k in ("ring", "moe", "gpipe",
                                                "deepfm"))
    failures = {
        "launches": bad,
        "backend": summary["backend_by_rank"] != ["gloo"] * PAR_RANKS,
        "ring_losses": not ring["loss_max_scaled_err"] <= PAR_LOSS_RTOL,
        "ring_check": not all(c["ok"] for c in ring["ring_check_by_rank"]),
        "ring_shards": ring["shards"] != {
            "token_embedding.embedding": [VOCAB // 2, PAR_HIDDEN]},
        "moe_layer": not all(c["ok"] and c["experts_here"] == 2
                             for c in moe["layer_check_by_rank"]),
        "moe_loss_falls": not all(l[-1] < l[0]
                                  for l in moe["losses_by_rank"]),
        "gpipe": not pipe["check"]["ok"],
        "deepfm": not (fm["loss_max_rel_err"] <= DP_LOSS_RTOL
                       and fm["max_abs_err_vs_one_rank"] <= DP_F32_TOL
                       and fm["shards"]["fm_embedding.embedding"]
                       == [DEEPFM_VOCAB // 2, DEEPFM_DIM]),
        "kernel_checks": [(part, r, c) for part, by_rank in
                          summary["kernel_checks_by_part"].items()
                          for r, cs in enumerate(by_rank) for c in cs
                          if not c["ok"]],
        "restore": not (restore["step"] == PAR_RING_STEPS
                        and restore["logits_max_abs_err_vs_ranks"]
                        <= PAR_LOGITS_TOL),
        "int8": not (int8["loss_max_rel_err"] <= DP_LOSS_RTOL
                     and int8["folds_replayed"] == PAR_RANKS * 2 * DP_STEPS
                     and int8["folds_bitwise"]
                     and int8["model4_losses_equal"]
                     and int8["model4_state_bitwise"]
                     and int8["shards"]["fm_embedding.q8"]
                     == [DEEPFM_VOCAB // 2, DEEPFM_DIM]
                     and int8["model4_shards"]["fm_embedding.scale"]
                     == [DEEPFM_VOCAB // 4, 1]),
        "tiered": [d for d in ("float32", "int8") if not (
            tiered[d]["dm_loss_max_rel_err"] <= DP_LOSS_RTOL
            and tiered[d]["plans_equal"] and tiered[d]["admits_sub_plans"]
            and all(e > 0 for e in tiered[d]["evicts_by_step"])
            and tiered[d]["mesh_shards"] == {"dm": 2, "m4": 4}
            and tiered[d]["m4_bitwise"] and tiered[d]["m4_losses_equal"])],
        "kernels_alone": [c for part in ("int8_shard", "tiered_block",
                                         "flash_ring_block")
                          for c in alone[part] if not c["ok"]],
        "moe_seq": not (moe_seq["loss_max_scaled_err"] <= PAR_LOSS_RTOL
                        and all(c["ok"] and c["experts_here"] == 2
                                for c in moe_seq["layer_check_by_rank"]))}
    failed = {k: v for k, v in failures.items() if v}
    if failed:
        raise AssertionError(f"parallel_axes: {failed}; {summary}")
    launches = {}
    for r in ranks:
        for part in want:
            launches[f"parallel_{part}_rank{r['rank']}"] = \
                r[part]["launches"]
    return summary, launches


# ---- orbax_restore: the JAX package's checkpoints on the card -----------

ORBAX_FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "orbax")
ORBAX_BUDGET_S = 30.0
ORBAX_CENSUS_PARAMS = "vocab_capacity=4096;embed_dim=8"   # the zoo's width
ORBAX_CENSUS_STEP = 8
ORBAX_PREDICT_SEED, ORBAX_PREDICT_ROWS = 7, 256
ORBAX_CONTINUE_SEED, ORBAX_CONTINUE_STEPS, ORBAX_BATCH = 9, 4, 64
ORBAX_INT8_PARAMS = "vocab_capacity=4096;embed_dim=16;arena_dtype='int8'"
ORBAX_INT8_STEP, ORBAX_INT8_SEED, ORBAX_INT8_ROWS = 2, 5, 64
# Wide & Deep's forward and losses against the JAX package's
# (tests/test_torch_census.py's FWD_TOL and LOSS_TOL); serving against
# the same step's in-process forward (tests/test_torch_serving_e2e.py's
# STEP_TOL); int8 serving (tests/test_torch_serving_int8.py's INT8_TOL)
ORBAX_FWD_TOL = 1e-5
ORBAX_LOSS_TOL = 5e-5
ORBAX_SERVE_TOL = 1e-5
ORBAX_INT8_TOL = 1e-4


def orbax_frames(step_path: str) -> list:
    """Every zstd frame of an orbax step: the two databases' manifests
    and B+tree roots (leaves here: the phase checks it) and each zarr
    chunk."""
    frames = []
    default = os.path.join(step_path, "default")
    for db in (default, os.path.join(default, "ocdbt.process_0")):
        with open(os.path.join(db, ocdbt.MANIFEST_FILE), "rb") as f:
            raw = f.read()
        store = ocdbt.OcdbtStore(db)
        latest = store.manifest.latest
        if latest["root_height"] != 0:
            raise AssertionError(f"{db}: a B+tree of height "
                                 f"{latest['root_height']}; the phase "
                                 "reads leaf roots only")
        rel, offset, length = latest["root"]
        with open(os.path.join(db, rel), "rb") as f:
            f.seek(offset)
            node = f.read(length)
        frames += [blob[14:-4] for blob in (raw, node) if blob[13] == 1]
    store = ocdbt.OcdbtStore(default)
    for key in store.list():
        value = store.read(key)
        if int.from_bytes(value[:4], "little") == zstd.MAGIC:
            frames.append(value)
    return frames


def decoders_agree(card: str) -> dict:
    """The C++ and the Python zstd decoders on every frame of both
    fixtures: the same bytes, and each one's MB/s of output on the
    host."""
    if not zstd.native_available():
        raise AssertionError(f"the C++ zstd decoder did not build: "
                             f"{zstd.unavailable_reason}")
    frames = (orbax_frames(os.path.join(ORBAX_FIXTURES, "census",
                                        str(ORBAX_CENSUS_STEP)))
              + orbax_frames(os.path.join(ORBAX_FIXTURES, "deepfm_int8",
                                          str(ORBAX_INT8_STEP))))
    zstd.reset_served()
    t0 = time.perf_counter()
    native = [zstd.decompress_native(f) for f in frames]
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = [zstd.decompress_py(f) for f in frames]
    python_s = time.perf_counter() - t0
    out_bytes = sum(len(b) for b in native)
    out = {"card": card, "frames": len(frames),
           "compressed_bytes": sum(len(f) for f in frames),
           "decoded_bytes": out_bytes, "native_s": native_s,
           "python_s": python_s,
           "native_mb_per_s": out_bytes / native_s / 1e6,
           "python_mb_per_s": out_bytes / python_s / 1e6,
           "equal": native == python, "served": zstd.served()}
    if not out["equal"]:
        raise AssertionError("the C++ and Python zstd decoders differ on "
                             "a fixture frame")
    return out


def orbax_census_argv(job: str, data: str, ckpt: str) -> list:
    flag = "--validation_data" if job == "evaluate" else "--training_data"
    return zoo_argv(job, CENSUS, ORBAX_BATCH, "--model_params",
                    ORBAX_CENSUS_PARAMS, flag, data,
                    "--records_per_task", str(ORBAX_PREDICT_ROWS),
                    "--num_epochs", "1", "--checkpoint_dir_for_init", ckpt)


def serve_one(model_def: str, params: str, ckpt: str, features: dict,
              rows: int):
    """`serve --checkpoint_dir` over the socket: (its predictions of
    `features` in one request, the step it serves)."""
    args = cli.parse_args([
        "serve", "--model_def", model_def, "--model_params", params,
        "--batch_buckets", str(rows), "--port", "0",
        "--checkpoint_dir", ckpt,
        "--feature_spec", json.dumps(feature_meta(features))])
    server, stub = start_server(args)
    try:
        resp = stub.predict(make_predict_request(features))
        if resp.code != spb.SERVING_OK:
            raise AssertionError(f"serve {ckpt}: {resp.error}")
        return from_tensor_proto(resp.predictions), resp.model_step
    finally:
        stub.close()
        server.stop()


def orbax_restore(card: str, work: str) -> tuple:
    """The JAX package's orbax checkpoints (tests/torch_fixtures/orbax/,
    written by the JAX package on the CPU) read on the card with no
    orbax, tensorstore or zstd package: the decoders agree; fixture (a),
    Wide & Deep at the zoo's width, restores through
    --checkpoint_dir_for_init, predicts as the JAX package recorded,
    trains 4 steps through the scatter-add kernel with the recorded
    losses, and serves over the socket what it predicts in process;
    fixture (b)'s int8 planes serve the recorded predictions.  Budget
    ORBAX_BUDGET_S."""
    t0 = time.perf_counter()
    out = {"card": card, "decoders": decoders_agree(card)}
    dec = out["decoders"]
    print(f"orbax_restore decoders: {dec['frames']} frames, "
          f"{dec['decoded_bytes']} bytes, C++ {dec['native_mb_per_s']:.1f} "
          f"MB/s, Python {dec['python_mb_per_s']:.2f} MB/s on the host "
          f"[{card}]", flush=True)
    root = os.path.join(work, "orbax")
    census_ckpt = os.path.join(root, "census")
    int8_ckpt = os.path.join(root, "deepfm_int8")
    shutil.copytree(os.path.join(ORBAX_FIXTURES, "census"), census_ckpt)
    shutil.copytree(os.path.join(ORBAX_FIXTURES, "deepfm_int8"), int8_ckpt)
    predict_rows = census_data.synthetic_census(ORBAX_PREDICT_ROWS,
                                                seed=ORBAX_PREDICT_SEED)
    predict_csv = census_data.write_csv(os.path.join(root, "predict.csv"),
                                        predict_rows)
    features = census_zoo.feed(predict_rows)["features"]
    train_dir = os.path.join(root, "train")
    os.makedirs(train_dir)
    census_data.write_csv(
        os.path.join(train_dir, "census-train.csv"),
        census_data.synthetic_census(ORBAX_CONTINUE_STEPS * ORBAX_BATCH,
                                     seed=ORBAX_CONTINUE_SEED))
    zstd.reset_served()

    # (a) the restored step's predictions: an evaluate job's owner
    ev = api.run_local(cli.parse_args(orbax_census_argv(
        "evaluate", predict_csv, census_ckpt)), "evaluate")
    if ev.exit_code != 0 or ev.owner.step != ORBAX_CENSUS_STEP:
        raise AssertionError(f"orbax_restore: the evaluate job failed or "
                             f"restored step {ev.owner.step}")
    preds = np.asarray(ev.owner.predict_batch({"features": features}),
                       np.float32).reshape(-1)
    want = np.load(os.path.join(ORBAX_FIXTURES, "census_predictions.npy"))
    out["predict_max_abs_err"] = float(np.abs(preds - want).max())
    out["eval_metrics"] = ev.metrics
    del ev

    # (a) 4 steps on the recorded batches: the main path, counted
    args = cli.parse_args(orbax_census_argv("train", train_dir,
                                            census_ckpt))
    # ---- the main path: counts start at 0 here ----
    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    job = api.run_local(args, "train")
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t1
    launches = sa.scatter_add.launches
    # ---- end of the main path ----
    losses = job_losses(job)
    want_losses = np.load(os.path.join(ORBAX_FIXTURES,
                                       "census_losses.npy"))
    out.update(train_exit=job.exit_code, train_step=job.owner.step,
               losses=losses, jax_losses=want_losses.tolist(),
               scatter_launches=launches)
    del job
    if out["train_exit"] != 0 or out["train_step"] != \
            ORBAX_CENSUS_STEP + ORBAX_CONTINUE_STEPS or \
            len(losses) != ORBAX_CONTINUE_STEPS:
        raise AssertionError(f"orbax_restore: the train job: {out}")
    out["loss_max_abs_err"] = float(np.abs(np.asarray(losses)
                                           - want_losses).max())

    # (a) serve --checkpoint_dir over the socket: the in-process forward
    served, step = serve_one(CENSUS, ORBAX_CENSUS_PARAMS, census_ckpt,
                             features, ORBAX_PREDICT_ROWS)
    out["serve_step"] = step
    out["serve_max_abs_err"] = float(np.abs(
        np.asarray(served, np.float32).reshape(-1) - preds).max())

    # (b) the int8 planes
    dense, sparse, _ = synthetic_criteo(ORBAX_INT8_ROWS,
                                        seed=ORBAX_INT8_SEED)
    int8_preds, int8_step = serve_one(DEEPFM, ORBAX_INT8_PARAMS, int8_ckpt,
                                      {"dense": dense, "sparse": sparse},
                                      ORBAX_INT8_ROWS)
    want8 = np.load(os.path.join(ORBAX_FIXTURES,
                                 "deepfm_int8_predictions.npy"))
    got8 = np.asarray(int8_preds, np.float32).reshape(-1)
    out["int8_step"] = int8_step
    out["int8_max_abs_err"] = float(np.abs(got8 - want8).max())
    out["int8_within_tol"] = bool(np.allclose(got8, want8,
                                              atol=ORBAX_INT8_TOL,
                                              rtol=ORBAX_INT8_TOL))
    out["restore_served"] = zstd.served()
    shutil.rmtree(root)
    seconds = time.perf_counter() - t0
    out.update(seconds=seconds, budget_s=ORBAX_BUDGET_S,
               tolerances={"predict": ORBAX_FWD_TOL, "loss": ORBAX_LOSS_TOL,
                           "serve": ORBAX_SERVE_TOL,
                           "int8": ORBAX_INT8_TOL})
    print(json.dumps({"orbax_restore": out}), flush=True)
    print(f"orbax_restore: predictions {out['predict_max_abs_err']:.3g}, "
          f"losses {out['loss_max_abs_err']:.3g}, serve "
          f"{out['serve_max_abs_err']:.3g}, int8 "
          f"{out['int8_max_abs_err']:.3g} from the JAX records; "
          f"{launches} scatter-adds; {seconds:.1f} s (budget "
          f"{ORBAX_BUDGET_S} s) [{card}]", flush=True)
    served_by = out["restore_served"]
    if served_by["python"] != 0 or served_by["native"] == 0:
        raise AssertionError(f"orbax_restore: the C++ decoder did not "
                             f"serve every frame: {served_by}")
    if out["predict_max_abs_err"] > ORBAX_FWD_TOL:
        raise AssertionError(f"orbax_restore: predictions "
                             f"{out['predict_max_abs_err']} from the JAX "
                             f"ones (tol {ORBAX_FWD_TOL})")
    if out["loss_max_abs_err"] > ORBAX_LOSS_TOL:
        raise AssertionError(f"orbax_restore: losses {losses} vs the JAX "
                             f"{want_losses.tolist()}")
    if launches <= 0:
        raise AssertionError("orbax_restore: the steps launched no "
                             "scatter-add")
    if step != ORBAX_CENSUS_STEP or \
            out["serve_max_abs_err"] > ORBAX_SERVE_TOL:
        raise AssertionError(f"orbax_restore: serve at step {step}, "
                             f"{out['serve_max_abs_err']} from the "
                             "in-process predictions")
    if int8_step != ORBAX_INT8_STEP or not out["int8_within_tol"]:
        raise AssertionError(f"orbax_restore: int8 serving at step "
                             f"{int8_step}, {out['int8_max_abs_err']} from "
                             "the JAX predictions")
    return out, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--cluster-rank"]:
        # one rank of the cluster phase's data-parallel group
        rank, work, port, device = sys.argv[2:6]
        return cluster_rank(int(rank), work, int(port), device)
    if sys.argv[1:2] == ["--autoscale-master"]:
        # the autoscale_cluster phase's master
        root, work, device = sys.argv[2:5]
        return autoscale_master(root, work, device)
    if sys.argv[1:2] == ["--parallel-rank"]:
        # one rank of the parallel_axes phase's world
        rank, work, port, device = sys.argv[2:6]
        return parallel_rank(int(rank), work, int(port), device)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    # the Local jobs' data, checkpoints and exports, which the serve_cli
    # phases serve, and the processes' bytecode cache
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    warm = start_bytecode_warmup(work)
    try:
        return build_and_run(card, work, warm)
    finally:
        if not warm["out"].closed:       # a phase before observatory failed
            stop_runner(warm)
        shutil.rmtree(work, ignore_errors=True)


def build_and_run(card: str, work: str, warm: dict) -> int:
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
    return run_phases(card, build, work, warm)


def run_phases(card: str, build: dict, work: str, warm: dict) -> int:
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
    exact_eval = phase("eval_exact", eval_exact, card, work, fm_served)
    resilient, resilient_launches = phase(
        "resilient_local", resilient_local, card, work, fm_served)
    stream, stream_launches = phase("stream_judgment", stream_judgment,
                                    card, work, fm_served)
    online = phase("online_loop", online_loop, card, work)
    obs, obs_scatter, obs_flash = phase("observatory", observatory, card,
                                        work, fm_served, online, warm)
    del online["surfaces"]
    clus, clus_launches = phase("cluster", cluster, card, work)
    kube, kube_launches = phase("kube_cluster", kube_cluster, card, work)
    scale, scale_launches = phase("autoscale_cluster", autoscale_cluster,
                                  card, work)
    par, par_launches = phase("parallel_axes", parallel_axes, card, work)
    serve_fm = phase("serve_cli_deepfm", serve_cli_deepfm, card, fm_served)
    wire, wire_launches = phase("wire_deepfm", wire_deepfm, buffers)
    graph, graph_launches = phase("graph_steps", graph_steps, card, buffers)
    gprog, gprog_launches = phase("graph_programs", graph_programs, card,
                                  fm_served)
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
    orbax, orbax_launches = phase("orbax_restore", orbax_restore, card,
                                  work)
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
        "observatory": obs_scatter,
        "wire_deepfm": wire_launches,
        **{path: n.get("scatter_add", 0)
           for path, n in graph_launches.items()},
        "tiered_deepfm": tiered_launches,
        **local_t_launches,
        **zoo_launches,
        "train_bert": bert_launches_by["plain"]["scatter_add"],
        "train_bert_remat": bert_launches_by["remat"]["scatter_add"],
        "local_bert_tiny":
            bert_local_launches["local_bert_tiny"]["scatter_add"],
        "local_bert_full":
            bert_local_launches["local_bert_full"]["scatter_add"],
        **{path: (n if isinstance(n, int) else n["scatter_add"])
           for path, n in clus_launches.items()},
        **kube_launches,
        **scale_launches,
        **{path: n["scatter_add"] for path, n in par_launches.items()},
        "orbax_restore": orbax_launches}
    bert_paths = {"train_bert": bert_launches_by["plain"],
                  "train_bert_remat": bert_launches_by["remat"],
                  **bert_local_launches}
    cluster_bert = {path: n for path, n in clus_launches.items()
                    if isinstance(n, dict)}
    entry["launches_by_path"] = {
        "serve_bert": launches["flash_attention_fwd"],
        "observatory_storm": obs_flash,
        "serve_cli_bert": cli_launches["flash_attention_fwd"],
        **{path: n["flash_attention_fwd"] for path, n in
           bert_paths.items()},
        **{path: n["flash_attention_fwd"][fa.SM90_WGMMA]
           for path, n in cluster_bert.items()},
        **{path: n["flash_attention_fwd"] for path, n in
           par_launches.items()
           if path.rsplit("_rank", 1)[0] in PAR_FLASH_PATHS},
        **{path: n.get("flash_attention_fwd", 0) for path, n in
           graph_launches.items() if "bert" in path},
        **gprog_launches}
    # launches: the bare Trainer's timed steps at bench_bert's shape (the
    # BERT training path); each path's count beside it
    bwd_entry["launches"] = bert_launches_by["plain"]["flash_attention_bwd"]
    bwd_entry["launches_by_path"] = {
        **{path: n["flash_attention_bwd"] for path, n in bert_paths.items()},
        **{path: n["flash_attention_bwd"][fa.SM90_WGMMA]
           for path, n in cluster_bert.items()},
        **{path: n["flash_attention_bwd"] for path, n in
           par_launches.items()
           if path.rsplit("_rank", 1)[0] in PAR_FLASH_PATHS},
        **{path: n.get("flash_attention_bwd", 0) for path, n in
           graph_launches.items() if "bert" in path}}
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
                   "eval_exact": exact_eval,
                   "resilient_local": resilient,
                   "stream_judgment": stream, "online_loop": online,
                   "observatory": obs, "cluster": clus,
                   "kube_cluster": kube, "autoscale_cluster": scale,
                   "parallel_axes": par,
                   "wire_deepfm": wire, "graph_steps": graph,
                   "graph_programs": gprog,
                   "serve_cli_deepfm": serve_fm,
                   "tiered_deepfm": tiered, "local_tiered": local_t,
                   "zoo_local": zoo,
                   "serve_cli_bert": serve_bert_cli,
                   "orbax_restore": orbax, **kernels}, f,
                  indent=1)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
