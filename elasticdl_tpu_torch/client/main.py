"""The command line of the port (the train, evaluate, predict and serve
subcommands of the JAX package's client/main.py):

    python -m elasticdl_tpu_torch.client.main train \\
        --distribution_strategy Local \\
        --model_def deepfm.deepfm_functional_api.custom_model \\
        --training_data DIR --validation_data DIR [--device cpu] ...
    python -m elasticdl_tpu_torch.client.main evaluate ... \\
        --checkpoint_dir_for_init DIR
    python -m elasticdl_tpu_torch.client.main predict ... \\
        --checkpoint_dir_for_init DIR --output DIR
    python -m elasticdl_tpu_torch.client.main serve \\
        --model_def deepfm.deepfm_functional_api.custom_model \\
        (--export_dir DIR | --checkpoint_dir DIR --feature_spec JSON) \\
        [--port 50061] [--device cpu] ...

and the operator commands, with the JAX package's arguments:

    python -m elasticdl_tpu_torch.client.main top HOST:PORT [--watch]
    python -m elasticdl_tpu_torch.client.main slo HOST:PORT [--json]
    python -m elasticdl_tpu_torch.client.main programs HOST:PORT [--json]
    python -m elasticdl_tpu_torch.client.main trace EVENT_LOG \\
        [--chrome OUT.json] [--summary]
    python -m elasticdl_tpu_torch.client.main lineage EVENT_LOG [--window N]
    python -m elasticdl_tpu_torch.client.main incident DIR [--bundle NAME]

and the job-image commands (client/image_builder.py):

    python -m elasticdl_tpu_torch.client.main zoo init [--model_zoo DIR] \
        [--base_image IMAGE]
    python -m elasticdl_tpu_torch.client.main zoo build --image IMAGE \
        [--model_zoo DIR]
    python -m elasticdl_tpu_torch.client.main zoo push IMAGE

(`top`, `slo` and `programs` scrape a master's `--telemetry_port`).
`train`, `evaluate` and `predict` with a cluster strategy submit the
job's master pod through the Kubernetes client (client/api.py) to the
cluster of the in-cluster configuration or of the kubeconfig
(`KUBECONFIG`, else ~/.kube/config); with neither they print why and
return 1.  On one machine a cluster job starts from the master's entry
point, `python -m elasticdl_tpu_torch.master.main
--distribution_strategy AllReduce --use_process_k8s true ...`.  Parsing is strict: an unknown flag is an
error.  The exit code is 0 when the job or command succeeded.
"""

from __future__ import annotations

import argparse
import sys

from elasticdl_tpu_torch.common import args as args_lib


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="elasticdl_tpu_torch",
        description="elastic training of the PyTorch/CUDA port")
    subparsers = parser.add_subparsers(dest="command")
    for name, help_text in (("train", "run a training job"),
                            ("evaluate", "evaluate a checkpoint"),
                            ("predict", "predict with a checkpoint")):
        sub = subparsers.add_parser(name, help=help_text)
        args_lib.add_common_params(sub)
        args_lib.add_model_params(sub)
        args_lib.add_train_params(sub)
        sub.set_defaults(func=name)
    serve = subparsers.add_parser(
        "serve", help="serve an exported model or live checkpoint dir")
    args_lib.add_model_params(serve)
    args_lib.add_serve_params(serve)
    serve.set_defaults(func="serve")

    top_parser = subparsers.add_parser(
        "top", help="live job table from a master's /varz endpoint")
    top_parser.add_argument(
        "master_varz",
        help="master telemetry address: host:port or http URL "
        "(--telemetry_port of the master)")
    top_parser.add_argument(
        "--serving_addr", default="",
        help="optionally also scrape a serving replica's telemetry "
        "address for a serving summary row")
    top_parser.add_argument(
        "--watch", action="store_true",
        help="refresh continuously instead of printing one frame")
    top_parser.add_argument(
        "--interval_s", type=float, default=2.0,
        help="refresh interval with --watch")
    top_parser.set_defaults(func="top")

    slo_parser = subparsers.add_parser(
        "slo", help="SLO report (state, burn rates, window evidence) "
        "from a master's /varz endpoint")
    slo_parser.add_argument(
        "master_varz",
        help="master telemetry address: host:port or http URL "
        "(--telemetry_port of the master)")
    slo_parser.add_argument(
        "--json", action="store_true",
        help="dump the raw SLO snapshot as JSON instead of the table")
    slo_parser.set_defaults(func="slo")

    programs_parser = subparsers.add_parser(
        "programs",
        help="program observatory (compiles, signatures, cost ledger, "
        "live MFU) from a /varz endpoint")
    programs_parser.add_argument(
        "varz_addr",
        help="telemetry address: host:port or http URL "
        "(--telemetry_port of a master or a serving replica)")
    programs_parser.add_argument(
        "--json", action="store_true",
        help="dump the raw program ledger as JSON instead of the table")
    programs_parser.set_defaults(func="programs")

    trace_parser = subparsers.add_parser(
        "trace",
        help="convert an --event_log JSONL to Chrome trace JSON "
        "(Perfetto / chrome://tracing) or print a latency summary")
    args_lib.add_trace_params(trace_parser)
    trace_parser.set_defaults(func="trace")

    lineage_parser = subparsers.add_parser(
        "lineage",
        help="per-window ingest->first-serve freshness waterfalls from "
        "an --event_log JSONL (the train-path twin of `trace`)")
    args_lib.add_lineage_params(lineage_parser)
    lineage_parser.set_defaults(func="lineage")

    incident_parser = subparsers.add_parser(
        "incident",
        help="list incident flight-recorder bundles (--incident_dir of "
        "the master) or render one into a postmortem report")
    args_lib.add_incident_params(incident_parser)
    incident_parser.set_defaults(func="incident")

    zoo_parser = subparsers.add_parser("zoo", help="model zoo image tools")
    zoo_sub = zoo_parser.add_subparsers(dest="zoo_command")
    zoo_init = zoo_sub.add_parser("init", help="scaffold a model zoo dir")
    zoo_init.add_argument("--model_zoo", default="model_zoo")
    zoo_init.add_argument("--base_image", default="python:3.12")
    zoo_init.set_defaults(func="zoo_init")
    zoo_build = zoo_sub.add_parser("build", help="build the job image")
    zoo_build.add_argument("--model_zoo", default="model_zoo")
    zoo_build.add_argument("--image", required=True)
    zoo_build.set_defaults(func="zoo_build")
    zoo_push = zoo_sub.add_parser("push", help="push the job image")
    zoo_push.add_argument("image")
    zoo_push.set_defaults(func="zoo_push")
    return parser


# each is the function of its own name in elasticdl_tpu_torch.client.<name>
_OPERATOR_COMMANDS = ("top", "slo", "programs", "trace", "lineage",
                      "incident")


def parse_args(argv=None) -> argparse.Namespace:
    return _build_parser().parse_args(argv)


def main(argv=None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "func", None):
        parser.print_help()
        return 2

    if args.func in _OPERATOR_COMMANDS:
        import importlib

        module = importlib.import_module(
            f"elasticdl_tpu_torch.client.{args.func}")
        return getattr(module, args.func)(args)

    from elasticdl_tpu_torch.client import api, image_builder
    from elasticdl_tpu_torch.common.k8s_config import K8sConfigError

    if args.func == "zoo_init":
        return image_builder.init_zoo(args.model_zoo, args.base_image)
    if args.func == "zoo_build":
        return image_builder.build_image(args.model_zoo, args.image)
    if args.func == "zoo_push":
        return image_builder.push_image(args.image)

    try:
        return getattr(api, args.func)(args)
    except K8sConfigError as exc:
        print(f"{parser.prog} {args.func}: no Kubernetes cluster to "
              f"submit to: {exc}", file=sys.stderr)
        return 1
    except ImportError as exc:
        print(f"{parser.prog} {args.func}: cannot load --model_def "
              f"{args.model_def!r} from --model_zoo {args.model_zoo!r}: "
              f"{exc}", file=sys.stderr)
        return 1
    except ValueError as exc:
        print(f"{parser.prog} {args.func}: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
