"""The command-line flags of a Local job and of `serve` (the port's copy
of the subset of the JAX package's common/args.py that `_train_local`
and `serve` read).

Flags outside the subset are absent, so argparse rejects them.  A flag
whose feature waits for a later slice of the port (a non-Local strategy)
parses and then raises NotImplementedError where the job would use it;
`--trace_sample_rate`, whose reader is the serving fleet (ROADMAP.md
queue 1, item 10(b)), is the one flag that parses and is not read yet,
as in the JAX package's Local jobs.  The wire formats (`--wire_format
plain|compact|dedup`, the legacy `--compact_wire`), the int8 arena
(`--arena_dtype int8`), the tiered store's int8 cache
(`--store_cache_dtype int8`), `--output` (a train job's model export,
common/export.py), the straggler flags, `--task_lease_timeout_s`,
`--profile_dir` (a torch.profiler trace of worker 0's first training
task), `--tensorboard_log_dir` (scalars through
torch.utils.tensorboard, inert without the tensorboard package) and the
judgment flags (`--history_interval`, `--history_capacity`,
`--slo_interval`, `--slo_staleness_p99_s`, `--incident_dir`,
`--incident_ring`, `--incident_max_bundles`: the master's metric
history, SLO evaluator and incident flight recorder, master/main.py)
run.

`--device` is the port's own: `cuda` (the default) or `cpu`, the
counterpart of the JAX package's JAX_PLATFORMS, resolved through
`device.py::resolve_device` (which raises when CUDA is wanted and
absent).
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
        help="Only Local (master and workers in this process) is ported; "
        "the cluster strategies raise NotImplementedError.")
    parser.add_argument("--num_workers", type=pos_int, default=1,
                        help="worker threads sharing one model")
    parser.add_argument(
        "--event_log", default="",
        help="Append-only JSONL span-event log (task dispatch/claim/"
        "train/report, checkpoint save/restore).")
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
