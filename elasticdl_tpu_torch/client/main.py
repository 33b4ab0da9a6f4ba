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

Parsing is strict: an unknown flag is an error.  The exit code is 0 when
the job succeeded.
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
    return parser


def parse_args(argv=None) -> argparse.Namespace:
    return _build_parser().parse_args(argv)


def main(argv=None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "func", None):
        parser.print_help()
        return 2

    from elasticdl_tpu_torch.client import api

    try:
        return getattr(api, args.func)(args)
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
