"""The command-line flags of a Local job, of a cluster job's master and
workers, and of `serve`: the port's copy of the JAX package's
common/args.py, every flag under its JAX name, type, default, `nargs`
and `const` (tests/test_torch_args_parity.py holds the two parsers
equal).  The port adds one flag, `--device`; the default of
`--model_zoo` is the port's own zoo.

`elasticdl train` with a cluster strategy submits the master's pod
(client/api.py `_submit_master_pod`, its argv rebuilt by
`build_arguments_from_parsed_result`); the master's own entry point
(`python -m elasticdl_tpu_torch.master.main`) runs the cluster job and
re-serializes the same flags into each worker pod's argv
(master/main.py `_worker_command`).  `add_cluster_params` holds the
cluster's flags: the pods, the rendezvous and elastic recovery, the
policy engine's bounds and thresholds (`--min_workers`, `--max_workers`,
`--straggler_dwell_s`, `--eviction_budget`, `--eviction_cooldown_s`,
`--backlog_per_worker`, `--backlog_ticks`, `--data_wait_share`,
`--data_wait_ticks`, `--scale_step`, `--scale_hold_ticks`, read by
master/policy.py `PolicyConfig.from_args`), `--compilation_cache_dir`,
and the serving fleet's flags with its autoscaler's thresholds and the
backpressure flags (`ServingPolicyConfig.from_args`,
`ServingFleetConfig.from_args`).

`--compilation_cache_dir` is the directory of the hand kernels'
libraries and the host scanner's (ops/_build.py `set_cache_dir`, which
the master, the worker and the Local runner call first): with
`--volume` it is a mount shared across pod relaunches, so a relaunched
or added pod loads the libraries instead of building them.  Empty
keeps the default, `build/elasticdl_tpu_torch/` in the checkout.

`--trace_sample_rate` parses, and, as in the JAX package, the master
hands it to nothing: a `FleetRouter` (proto/service.py) takes its rate
from whoever builds it.  Nine flags exist so that a command line of
upstream ElasticDL parses, and neither package reads them:
`--num_minibatches_per_task`, `--log_level`, `--worker_resource_limit`,
`--restart_policy` (the pod's policy is always "Never"),
`--image_pull_policy`, `--need_tf_config`, `--grads_to_wait`,
`--task_fault_tolerance` and a training job's `--data_reader_params`.

`--device` is the port's own: `cuda` (the default) or `cpu`, the
counterpart of the JAX package's JAX_PLATFORMS, resolved through
`device.py::resolve_device` (which raises when CUDA is wanted and
absent).  The master and worker parsers call `parse_args`, where the
JAX ones call `parse_known_args`: with the same flags in both, they
differ only on a flag neither package knows, which the port refuses.
"""

from __future__ import annotations

import argparse

from elasticdl_tpu_torch.common.constants import (
    DEFAULT_TASK_LEASE_TIMEOUT_S, DistributionStrategy)
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR


def pos_int(value):
    ivalue = int(value)
    if ivalue <= 0:
        raise argparse.ArgumentTypeError(f"{value} is not a positive integer")
    return ivalue


def non_neg_int(value):
    ivalue = int(value)
    if ivalue < 0:
        raise argparse.ArgumentTypeError(f"{value} is negative")
    return ivalue


def str2bool(value):
    if isinstance(value, bool):
        return value
    if value.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if value.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"Boolean value expected, got {value}")


def add_common_params(parser: argparse.ArgumentParser):
    parser.add_argument(
        "--distribution_strategy", default=DistributionStrategy.ALLREDUCE,
        choices=[DistributionStrategy.LOCAL, DistributionStrategy.ALLREDUCE,
                 DistributionStrategy.PARAMETER_SERVER],
        help="Local: master and workers in this process.  AllReduce (and "
        "ParameterServer, which maps onto it): one data-parallel model "
        "over worker processes that the master launches "
        "(master/main.py).")
    parser.add_argument("--num_workers", type=pos_int, default=1,
                        help="worker threads sharing one model")
    parser.add_argument("--num_minibatches_per_task", type=pos_int,
                        default=8, help="Parsed for upstream command "
                        "lines; read nowhere.")
    parser.add_argument("--log_level", default="INFO",
                        help="Parsed for upstream command lines; read "
                        "nowhere.")
    parser.add_argument(
        "--event_log", default="",
        help="Append-only JSONL span-event log (task dispatch/claim/"
        "train/report, checkpoint save/restore).")
    parser.add_argument(
        "--telemetry_port", type=non_neg_int, default=0,
        help="HTTP port of the master's /metrics, /healthz and /varz "
        "(0 = ephemeral); `top`, `slo` and `programs` scrape it.")
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="Where the model runs: the GPU (default; raises without "
        "CUDA) or the CPU when asked by name.")
    parser.add_argument(
        "--straggler_multiple", type=float, default=3.0,
        help="Flag a worker as a straggler when its mean task duration "
        "exceeds this multiple of the fleet-wide median (rolling window "
        "of recent tasks).  Flags surface in Master.snapshot(), the "
        "master_straggler_workers_count gauge and straggler_detected "
        "span events.  0 disables detection.")
    parser.add_argument(
        "--straggler_min_tasks", type=pos_int, default=3,
        help="Minimum completed tasks per worker (and workers in the "
        "fleet) before straggler detection may flag anyone.")
    # ---- metric history + SLOs (common/history.py, common/slo.py,
    #      docs/OBSERVABILITY.md "Metric history & SLOs") ----
    parser.add_argument(
        "--history_interval", type=float, default=0.0,
        help="Seconds between metric-history samples (ring-buffer "
        "recorder over every /metrics registry; the evidence the SLO "
        "evaluator and `elasticdl slo` read).  0 disables the sampling "
        "thread; tests tick by hand.",
    )
    parser.add_argument(
        "--history_capacity", type=pos_int, default=512,
        help="Samples retained per metric series in the history ring "
        "buffer (oldest evicted first).  Must cover the slowest SLO "
        "window: capacity * --history_interval >= slow_window_s.",
    )
    parser.add_argument(
        "--slo_interval", type=float, default=0.0,
        help="Seconds between SLO evaluator ticks (burn-rate math over "
        "the metric history; emits slo_breach/slo_recovered span "
        "events).  0 disables the thread; tests tick by hand.",
    )
    parser.add_argument(
        "--slo_staleness_p99_s", type=float, default=60.0,
        help="Objective of the staleness_p99 SLO: 99%% of predict "
        "responses must be served from a checkpoint no older than this "
        "many seconds behind the latest produced one.",
    )
    # ---- request tracing + incident flight recorder (common/flight.py,
    #      docs/OBSERVABILITY.md "Request tracing & incident bundles") --
    parser.add_argument(
        "--trace_sample_rate", type=float, default=1.0,
        help="Fraction of routed Predict requests whose predict_span "
        "is recorded end to end (deterministic every-k'th sampling, "
        "k = round(1/rate); 0 disables).  Error, shed, and failover "
        "outcomes always capture regardless of the rate.",
    )
    parser.add_argument(
        "--incident_dir", default="",
        help="Directory the incident flight recorder writes bundles "
        "into on an slo_breach, policy eviction, or terminal reload "
        "refusal (one JSON dir per incident: recent request spans, "
        "decisions, metric-history windows, Master.snapshot(), fault "
        "stats).  Empty disables capture; the forensic rings still "
        "fill.  Render with `elasticdl incident`.",
    )
    parser.add_argument(
        "--incident_ring", type=pos_int, default=256,
        help="Recent predict_span and decision events retained in the "
        "flight recorder's in-memory rings (each; oldest evicted "
        "first).",
    )
    parser.add_argument(
        "--incident_max_bundles", type=pos_int, default=8,
        help="Bundles kept under --incident_dir before the oldest is "
        "rotated out — soak runs cannot fill the disk.",
    )
    add_cluster_params(parser)


def add_cluster_params(parser: argparse.ArgumentParser):
    """A cluster job's flags: the master's pods, rendezvous and elastic
    recovery (the JAX parser's names and defaults)."""
    parser.add_argument(
        "--job_name", default="elasticdl-job", help="Job / pod-name prefix")
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--master_addr", default="",
                        help="host:port of master")
    parser.add_argument("--port", type=pos_int, default=50001,
                        help="the master's RPC port")
    parser.add_argument("--image_name", default="")
    parser.add_argument("--worker_resource_request",
                        default="cpu=1,memory=4096Mi")
    parser.add_argument("--worker_resource_limit", default="",
                        help="Parsed for upstream command lines; read "
                        "nowhere.")
    parser.add_argument("--worker_pod_priority", default="")
    parser.add_argument("--restart_policy", default="Never",
                        help="Parsed for upstream command lines; read "
                        "nowhere (a pod's policy is always Never).")
    parser.add_argument(
        "--volume", default="",
        help="Pod volume mounts: 'host_path=/a,mount_path=/b' or "
        "'claim_name=pvc,mount_path=/b'; several separated by ';'.  "
        "Mounted into the master pod and every worker pod (e.g. the "
        "--compilation_cache_dir volume).")
    parser.add_argument("--image_pull_policy", default="IfNotPresent",
                        help="Parsed for upstream command lines; read "
                        "nowhere.")
    parser.add_argument(
        "--need_tf_config", type=str2bool, default=False, nargs="?",
        const=True,
        help="Parsed for upstream command lines; read nowhere.")
    parser.add_argument(
        "--use_fake_k8s", type=str2bool, default=False,
        help="Use the in-memory fake cluster instead of the Kubernetes "
        "API (the control plane with no worker processes)")
    parser.add_argument(
        "--use_process_k8s", type=str2bool, default=False,
        help="Run worker pods as local OS subprocesses (the master and "
        "worker entry points, rendezvous and torch.distributed with no "
        "Kubernetes)")
    parser.add_argument(
        "--workers_per_group", type=pos_int, default=1,
        help="Workers are partitioned into groups of this size; when one "
        "member truly fails, the surviving members are restarted "
        "(budget-free) instead of each waiting out its wedge-watchdog "
        "grace.  1 = per-worker granularity.")
    parser.add_argument(
        "--preemption_notice_file", default="",
        help="Path polled for an upcoming-disruption notice; when the "
        "file holds one, the worker drains at the next task boundary.  "
        "'gce-metadata' polls the GCE instance metadata server instead.")
    parser.add_argument(
        "--policy_interval", type=float, default=0.0,
        help="Seconds between policy-engine ticks (straggler eviction + "
        "autoscaling).  0 (the default) disables the control loop.")
    parser.add_argument(
        "--min_workers", type=pos_int, default=1,
        help="Autoscaling floor: the policy engine never scales the "
        "fleet below this many workers.")
    parser.add_argument(
        "--max_workers", type=int, default=0,
        help="Autoscaling ceiling.  0 means --num_workers (a fixed "
        "fleet unless raised).")
    parser.add_argument(
        "--straggler_dwell_s", type=float, default=30.0,
        help="A straggler flag must persist this long before the policy "
        "engine evicts the worker.")
    parser.add_argument(
        "--eviction_budget", type=pos_int, default=2,
        help="Lifetime cap on policy-engine evictions.")
    parser.add_argument(
        "--eviction_cooldown_s", type=float, default=60.0,
        help="Minimum seconds between two policy-engine evictions.")
    parser.add_argument(
        "--backlog_per_worker", type=float, default=4.0,
        help="Scale up when queued tasks per alive worker exceed this "
        "for --backlog_ticks consecutive policy ticks.")
    parser.add_argument(
        "--backlog_ticks", type=pos_int, default=3,
        help="Consecutive over-threshold ticks before a backlog "
        "scale-up (hysteresis).")
    parser.add_argument(
        "--data_wait_share", type=float, default=0.6,
        help="Scale down when the fleet-wide data_wait share of step "
        "time exceeds this for --data_wait_ticks consecutive ticks.")
    parser.add_argument(
        "--data_wait_ticks", type=pos_int, default=3,
        help="Consecutive over-threshold ticks before a data_wait "
        "scale-down (hysteresis).")
    parser.add_argument(
        "--scale_step", type=pos_int, default=1,
        help="Workers added/removed per policy action, rounded to whole "
        "--workers_per_group groups.")
    parser.add_argument(
        "--scale_hold_ticks", type=pos_int, default=2,
        help="Quiet ticks after any scale action before the next one.")
    parser.add_argument(
        "--wedge_grace_s", type=float, default=20.0,
        help="Seconds a rank may lag a membership-epoch change before its "
        "watchdog assumes it is wedged in a collective with a dead peer "
        "and restarts the process; also the bound of every collective")
    parser.add_argument(
        "--coordinator_port", type=pos_int, default=51001,
        help="Port of the torch.distributed TCPStore that rank 0 hosts; "
        "the rendezvous serves rank 0's address + this port as the "
        "coordinator address")
    parser.add_argument(
        "--rpc_retry_budget_s", type=float, default=0.0,
        help="Max elapsed seconds of backed-off retries any single "
        "control-plane RPC may consume before the worker gives up and "
        "exits with code 45 (charged relaunch).  0 defers to the "
        "ELASTICDL_RPC_MAX_ELAPSED_S env var, default 120.")
    parser.add_argument(
        "--compilation_cache_dir", default="",
        help="Directory of the hand kernels' and the host scanner's "
        "libraries (ops/_build.py), applied first by the master, the "
        "worker and the Local runner.  A relaunched or added worker then "
        "loads them instead of building them.  Empty keeps "
        "build/elasticdl_tpu_torch/ in the checkout.  On a real cluster "
        "pair it with --volume so the directory is a mount shared across "
        "pod relaunches (e.g. --volume 'claim_name=cache,mount_path="
        "/cache' --compilation_cache_dir /cache).")
    parser.add_argument(
        "--relaunch_on_worker_failure", type=non_neg_int, default=3,
        help="max relaunches per failed worker pod")
    # ---- the serving fleet (master/serving_fleet.py) -------------------
    parser.add_argument(
        "--serving_replicas", type=non_neg_int, default=0,
        help="Serving replicas the master places and supervises behind "
        "the job.  0 (the default) disables the serving fleet.")
    parser.add_argument(
        "--serving_probe_interval", type=float, default=0.0,
        help="Seconds between fleet health-probe ticks (probe every "
        "replica's Health RPC, relaunch the dead, sequence rolling "
        "reloads).  0 disables the background loop; tests tick by hand.")
    parser.add_argument(
        "--serving_probe_failures", type=pos_int, default=3,
        help="Consecutive failed health probes before a serving replica "
        "is relaunched (pod-phase death relaunches immediately).")
    parser.add_argument(
        "--serving_step_skew_slo", type=non_neg_int, default=0,
        help="Max allowed cross-replica model_step spread.  A rolling "
        "reload that would exceed it is refused.  0 disables the bound.")
    parser.add_argument(
        "--serving_port", type=pos_int, default=50061,
        help="Port each serving replica listens on (the fleet manager "
        "probes {replica-service}:{this port}).")
    # ---- the serving autoscaler (master/policy.py ServingPolicyEngine)
    parser.add_argument(
        "--max_serving_replicas", type=non_neg_int, default=0,
        help="Upper bound the serving policy engine may scale the fleet "
        "to.  0 (the default) disables serving autoscaling; the fleet "
        "stays at --serving_replicas.")
    parser.add_argument(
        "--min_serving_replicas", type=non_neg_int, default=0,
        help="Lower bound the serving policy engine may scale the fleet "
        "down to.  0 defaults to --serving_replicas (the placed size).")
    parser.add_argument(
        "--serving_policy_interval", type=float, default=0.0,
        help="Seconds between serving policy engine ticks.  0 disables "
        "the background loop; tests tick by hand.")
    parser.add_argument(
        "--serving_burn_threshold", type=float, default=1.0,
        help="Fast-window SLO burn rate at or above which a serving "
        "scale-up streak accrues (1.0 = spending exactly the error "
        "budget).")
    parser.add_argument(
        "--serving_shed_threshold", type=float, default=0.02,
        help="Windowed whole-fleet shed ratio at or above which a "
        "serving scale-up streak accrues.")
    parser.add_argument(
        "--serving_fill_low", type=float, default=0.2,
        help="Mean healthy-replica batch fill at or below which a calm "
        "fleet accrues a scale-down streak.")
    parser.add_argument(
        "--serving_up_ticks", type=pos_int, default=2,
        help="Consecutive overloaded ticks before the serving policy "
        "engine scales up.")
    parser.add_argument(
        "--serving_down_ticks", type=pos_int, default=3,
        help="Consecutive calm, underfilled ticks before the serving "
        "policy engine scales down.")
    parser.add_argument(
        "--serving_scale_step", type=pos_int, default=1,
        help="Replicas added or retired per serving scale action.")
    parser.add_argument(
        "--serving_scale_hold_ticks", type=non_neg_int, default=2,
        help="Quiet ticks after any serving scale action before the "
        "next one.")
    parser.add_argument(
        "--serving_shed_window_s", type=float, default=30.0,
        help="Metric-history window the serving policy engine computes "
        "its shed ratio over.")
    parser.add_argument(
        "--backpressure_threshold", type=float, default=0.25,
        help="serving_pressure (SLO burn rate x fleet shed ratio) above "
        "which the online pipeline slows its stream poll/arm cadence.")
    parser.add_argument(
        "--backpressure_stride", type=pos_int, default=4,
        help="While backpressured, the online pipeline polls/arms only "
        "every this-many-th tick.")


def add_model_params(parser: argparse.ArgumentParser):
    parser.add_argument(
        "--model_zoo", default=ZOO_DIR,
        help="Directory containing model definitions (default: the "
        "port's own zoo)")
    parser.add_argument(
        "--model_def", default="",
        help="module.function returning the model, e.g. "
        "deepfm.deepfm_functional_api.custom_model")
    parser.add_argument("--model_params", default="",
                        help="'k=v;k2=v2' kwargs for the zoo functions")
    parser.add_argument(
        "--arena_dtype", default="", choices=["", "float32", "int8"],
        help="Embedding arena storage dtype: int8 stores rows as "
        "quantized codes with per-row fp32 scales; empty defers to the "
        "model's default (float32).  Forwarded into model_params for "
        "zoos whose custom_model accepts arena_dtype.")
    parser.add_argument(
        "--store_cache_dtype", default="", choices=["", "float32", "int8"],
        help="Tiered-store device hot-row cache storage dtype: int8 "
        "stores cache rows as quantized codes with per-row fp32 scales; "
        "empty defers to the model's default (float32).  Forwarded into "
        "model_params as cache_dtype for zoos whose custom_model accepts "
        "it.")
    parser.add_argument("--dataset_fn", default="feed")
    parser.add_argument("--loss", default="loss")
    parser.add_argument("--optimizer", default="optimizer")
    parser.add_argument("--eval_metrics_fn", default="eval_metrics_fn")
    parser.add_argument("--custom_data_reader",
                        default="custom_data_reader")
    parser.add_argument("--prediction_outputs_processor", default="")
    parser.add_argument("--callbacks", default="callbacks")


def add_train_params(parser: argparse.ArgumentParser):
    parser.add_argument("--minibatch_size", type=pos_int, default=64)
    parser.add_argument(
        "--steps_per_execution", type=pos_int, default=1,
        help="Run this many train steps per Trainer call "
        "(train_on_batch_stack); bitwise equal to single steps.")
    parser.add_argument("--num_epochs", type=pos_int, default=1)
    parser.add_argument(
        "--grads_to_wait", type=pos_int, default=1,
        help="Parsed for upstream command lines (the sync-PS "
        "accumulation knob); read nowhere: every step is synchronous "
        "over the group.")
    parser.add_argument("--training_data", default="")
    parser.add_argument("--validation_data", default="")
    parser.add_argument("--prediction_data", default="")
    parser.add_argument("--evaluation_steps", type=non_neg_int, default=0)
    parser.add_argument("--evaluation_start_delay_secs", type=non_neg_int,
                        default=0)
    parser.add_argument("--evaluation_throttle_secs", type=non_neg_int,
                        default=0)
    parser.add_argument("--checkpoint_steps", type=non_neg_int, default=0)
    parser.add_argument("--checkpoint_dir", default="")
    parser.add_argument("--keep_checkpoint_max", type=non_neg_int,
                        default=3)
    parser.add_argument(
        "--output", default="",
        help="predict: where predictions.npy goes (a .npy path or a "
        "directory).  train: the directory of the final model export "
        "(params.pt + export_meta.json).")
    parser.add_argument(
        "--export_saved_model", type=str2bool, default=False, nargs="?",
        const=True,
        help="train with --output: also ask for a TF SavedModel, which "
        "the port records in export_meta.json as unavailable (the "
        "params.pt export stands).")
    parser.add_argument("--checkpoint_dir_for_init", default="",
                        help="checkpoint to start from")
    parser.add_argument(
        "--profile_dir", default="",
        help="capture a torch.profiler trace (a Chrome trace, CUDA "
        "activity on the card) of worker 0's first training task into "
        "this directory")
    parser.add_argument(
        "--tensorboard_log_dir", default="",
        help="write train-loss/steps-per-sec/eval scalars (workers) and "
        "aggregated eval metrics (master) as TensorBoard event files "
        "under this directory (inert, with one warning, without the "
        "tensorboard package)")
    parser.add_argument("--task_fault_tolerance", type=str2bool,
                        default=True, help="Parsed for upstream command "
                        "lines; read nowhere.")
    parser.add_argument("--use_bf16", type=str2bool, default=True,
                        help="cast floating features to bf16")
    parser.add_argument(
        "--compact_wire", type=str2bool, default=False,
        help="Legacy spelling of --wire_format compact (read when "
        "--wire_format is empty).")
    parser.add_argument(
        "--wire_format", default="",
        choices=["", "plain", "compact", "dedup"],
        help="Host->device batch format: plain (the zoo's feed_bulk), "
        "compact (feed_bulk_compact: bf16 dense, b22 ids) or dedup "
        "(feed_bulk_dedup: host-hashed rows dedup'd per field).  A "
        "format the zoo lacks falls back dedup -> compact -> plain "
        "with a warning.  Empty defers to --compact_wire.")
    parser.add_argument("--data_reader_params", default="",
                        help="Parsed for upstream command lines; read "
                        "nowhere.")
    parser.add_argument("--records_per_task", type=pos_int, default=4096)
    parser.add_argument(
        "--task_lease_timeout_s", type=pos_int,
        default=DEFAULT_TASK_LEASE_TIMEOUT_S,
        help="re-queue a leased task if not reported within this window")


def add_serve_params(parser: argparse.ArgumentParser):
    """`serve`: online inference from an export or a live checkpoint
    directory."""
    parser.add_argument(
        "--export_dir", default="",
        help="directory with params.pt + export_meta.json "
        "(from --output of a training job)",
    )
    parser.add_argument(
        "--checkpoint_dir", default="",
        help="serve the newest verified checkpoint and hot-reload as "
        "the trainer writes new steps (alternative to --export_dir)",
    )
    parser.add_argument("--port", type=non_neg_int, default=50061)
    parser.add_argument(
        "--batch_buckets", default="1,4,16,64",
        help="comma-separated batch sizes to precompile; requests are "
        "padded to the nearest bucket",
    )
    parser.add_argument(
        "--max_batch_latency_ms", type=float, default=10.0,
        help="max time a queued request waits for batch-mates",
    )
    parser.add_argument(
        "--max_queue_rows", type=non_neg_int, default=0,
        help="admission-control bound on queued rows "
        "(0 = 4x the largest bucket)",
    )
    parser.add_argument(
        "--reject_oversized", type=str2bool, default=False,
        help="reject requests larger than the largest bucket instead "
        "of splitting them",
    )
    parser.add_argument(
        "--reload_poll_seconds", type=float, default=10.0,
        help="checkpoint-directory poll interval for hot reload",
    )
    parser.add_argument(
        "--telemetry_port", type=non_neg_int, default=0,
        help="HTTP port for /metrics, /healthz and /varz on the serving "
        "replica (0 = ephemeral)",
    )
    parser.add_argument(
        "--event_log", default="",
        help="append-only JSONL span-event log (hot-reload events join "
        "the cluster's trace stream)",
    )
    parser.add_argument(
        "--feature_spec", default="",
        help="serving signature for --checkpoint_dir mode when no "
        "export_meta.json is available: inline JSON "
        '{"name": {"shape": [..], "dtype": ".."}} or a path to an '
        "export_meta.json",
    )
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="Where the model serves: the GPU (default; raises without "
        "CUDA) or the CPU when asked by name.")


def add_trace_params(parser: argparse.ArgumentParser):
    """`trace`: offline event-log analysis (client/trace.py)."""
    parser.add_argument(
        "event_log",
        help="span-event JSONL written by --event_log (a rolled "
        "<path>.1 generation, if present, is read automatically)",
    )
    parser.add_argument(
        "--chrome", default="",
        help="write Chrome trace-event JSON here; open in "
        "https://ui.perfetto.dev or chrome://tracing",
    )
    parser.add_argument(
        "--summary", action="store_true",
        help="print per-worker task-latency quantiles, slowest tasks "
        "and the aggregate step-phase breakdown (default when --chrome "
        "is not given)",
    )
    parser.add_argument(
        "--slowest", type=non_neg_int, default=5,
        help="how many slowest tasks the summary lists",
    )


def add_lineage_params(parser: argparse.ArgumentParser):
    """`lineage`: per-window freshness waterfalls from an event log
    (client/lineage.py)."""
    parser.add_argument(
        "event_log",
        help="span-event JSONL written by --event_log (a rolled "
        "<path>.1 generation, if present, is read automatically)",
    )
    parser.add_argument(
        "--slowest", type=non_neg_int, default=3,
        help="how many slowest windows get a full waterfall",
    )
    parser.add_argument(
        "--window", type=int, default=None,
        help="render the waterfall for this one window id only",
    )


def add_incident_params(parser: argparse.ArgumentParser):
    """`incident`: postmortem reports from flight-recorder bundles
    (client/incident.py)."""
    parser.add_argument(
        "incident_dir",
        help="directory the master's --incident_dir flight recorder "
        "wrote bundles into",
    )
    parser.add_argument(
        "--bundle", default="",
        help="bundle name (or unambiguous prefix) to render a full "
        "postmortem report for; omitted = list all bundles",
    )
    parser.add_argument(
        "--spans", type=non_neg_int, default=10,
        help="how many of the slowest request spans the report lists",
    )


def add_evaluate_params(parser: argparse.ArgumentParser):
    """An evaluation job's data flags (the JAX parser's)."""
    parser.add_argument("--minibatch_size", type=pos_int, default=64)
    parser.add_argument("--validation_data", default="")
    parser.add_argument("--checkpoint_dir_for_init", default="")
    parser.add_argument("--records_per_task", type=pos_int, default=4096)
    parser.add_argument("--data_reader_params", default="")


def add_predict_params(parser: argparse.ArgumentParser):
    """A prediction job's data flags (the JAX parser's)."""
    parser.add_argument("--minibatch_size", type=pos_int, default=64)
    parser.add_argument("--prediction_data", default="")
    parser.add_argument("--checkpoint_dir_for_init", default="")
    parser.add_argument("--records_per_task", type=pos_int, default=4096)
    parser.add_argument("--data_reader_params", default="")


def parse_master_args(argv=None) -> argparse.Namespace:
    """The master entry point's flags (master/main.py)."""
    parser = argparse.ArgumentParser(description="elasticdl-tpu master")
    add_common_params(parser)
    add_model_params(parser)
    add_train_params(parser)
    parser.add_argument("--job_type", default="train",
                        choices=["train", "evaluate", "predict"])
    return parser.parse_args(argv)


def parse_worker_args(argv=None) -> argparse.Namespace:
    """A worker process's flags (worker/main.py): the master's, plus
    the worker's id."""
    parser = argparse.ArgumentParser(description="elasticdl-tpu worker")
    add_common_params(parser)
    add_model_params(parser)
    add_train_params(parser)
    parser.add_argument("--worker_id", type=int, default=0)
    parser.add_argument("--job_type", default="train")
    return parser.parse_args(argv)


def build_arguments_from_parsed_result(args, filter_args=None) -> list:
    """Re-serialize a parsed namespace back into argv (the config wire
    format from the master to its worker pods)."""
    arguments = []
    for key, value in vars(args).items():
        if filter_args and key in filter_args:
            continue
        if value is None or value == "":
            continue
        arguments += ["--" + key, str(value)]
    return arguments


def wrap_python_args_with_string(args: list) -> list:
    """`args` with every value quoted, so an argv survives a shell
    boundary in a pod command."""
    return [a if a.startswith("--") else f"'{a}'" for a in args]
