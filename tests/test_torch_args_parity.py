"""The port's command lines against the JAX package's: the master
parser, the worker parser and each `elasticdl` subcommand take the JAX
flags plus the port's `--device`, each flag with the JAX default, type,
`choices`, `nargs` and `const`, and parse a value that is not the
default to the same namespace value.  The worker argv the port's master
builds parses in the port's worker parser, and the policy engines' and
the serving fleet's configurations read the same fields from one argv.

The one default kept apart: `--model_zoo`, which names the port's own
zoo (the JAX default, "model_zoo", is the flax zoo's directory).
"""

import argparse
import dataclasses

import pytest

from elasticdl_tpu.client import main as jax_cli
from elasticdl_tpu.common import args as jax_args
from elasticdl_tpu.master import policy as jax_policy
from elasticdl_tpu.master import serving_fleet as jax_fleet
from elasticdl_tpu_torch.client import main as cli
from elasticdl_tpu_torch.common import args as port_args
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR
from elasticdl_tpu_torch.master import policy as port_policy
from elasticdl_tpu_torch.master import serving_fleet as port_fleet
from elasticdl_tpu_torch.master.main import Master

PORT_ONLY = {"device"}
# dest -> the port's default where it is the port's own
PORT_DEFAULTS = {"model_zoo": ZOO_DIR}


def _parser_of(parse_fn) -> argparse.ArgumentParser:
    """The parser `parse_fn` (a parse_master_args / parse_worker_args)
    builds, caught as it parses an empty argv."""
    caught = []
    real_args = argparse.ArgumentParser.parse_args
    real_known = argparse.ArgumentParser.parse_known_args

    def catch_args(self, args=None, namespace=None):
        caught.append(self)
        return real_args(self, [], namespace)

    def catch_known(self, args=None, namespace=None):
        caught.append(self)
        return real_known(self, [], namespace)

    argparse.ArgumentParser.parse_args = catch_args
    argparse.ArgumentParser.parse_known_args = catch_known
    try:
        parse_fn([])
    finally:
        argparse.ArgumentParser.parse_args = real_args
        argparse.ArgumentParser.parse_known_args = real_known
    return caught[0]


def _subparsers(main_module) -> dict:
    parser = main_module._build_parser()
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return dict(action.choices)
    raise AssertionError("no subcommands")


def _options(parser) -> dict:
    """dest -> action, for the parser's optional flags."""
    return {a.dest: a for a in parser._actions
            if a.option_strings and a.dest != "help"}


def _flag_parser(add_fns) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    for add in add_fns:
        add(parser)
    return parser


JAX_MASTER = _flag_parser([jax_args.add_common_params,
                           jax_args.add_model_params,
                           jax_args.add_train_params])
JAX_SERVE = _flag_parser([jax_args.add_model_params,
                          jax_args.add_serve_params])
CASES = ([("master", dest) for dest in sorted(_options(JAX_MASTER))]
         + [("serve", dest) for dest in sorted(
             set(_options(JAX_SERVE)) - set(_options(JAX_MASTER)))])


def _type_name(action):
    return getattr(action.type, "__name__", action.type)


def _other_value(action) -> str:
    """A command-line value of `action` that does not parse to its
    default."""
    if action.choices:
        return next(c for c in action.choices if c != action.default)
    name = _type_name(action)
    if name == "str2bool":
        return "false" if action.default else "true"
    if name in ("int", "pos_int", "non_neg_int"):
        return str((action.default or 0) + 3)
    if name == "float":
        return str(action.default + 0.25)
    return f"{action.dest}-value"


@pytest.mark.parametrize("which", ["master", "worker"])
def test_the_master_and_worker_parsers_take_the_jax_flags(which):
    fn = {"master": "parse_master_args", "worker": "parse_worker_args"}
    jax = _options(_parser_of(getattr(jax_args, fn[which])))
    port = _options(_parser_of(getattr(port_args, fn[which])))
    assert set(port) == set(jax) | PORT_ONLY
    for dest, action in jax.items():
        assert _type_name(port[dest]) == _type_name(action), dest
        assert port[dest].choices == action.choices, dest
        assert port[dest].nargs == action.nargs, dest
        assert port[dest].const == action.const, dest
        assert port[dest].default == PORT_DEFAULTS.get(
            dest, action.default), dest


@pytest.mark.parametrize("command", sorted(_subparsers(jax_cli)))
def test_each_subcommand_takes_the_jax_flags(command):
    port_subs = _subparsers(cli)
    assert set(port_subs) == set(_subparsers(jax_cli))
    jax = _options(_subparsers(jax_cli)[command])
    port = _options(port_subs[command])
    extra = PORT_ONLY if command in (
        "train", "evaluate", "predict", "serve") else set()
    assert set(port) == set(jax) | extra
    for dest, action in jax.items():
        assert _type_name(port[dest]) == _type_name(action), dest
        assert (port[dest].choices, port[dest].nargs, port[dest].const) \
            == (action.choices, action.nargs, action.const), dest
        assert port[dest].default == PORT_DEFAULTS.get(
            dest, action.default), dest


@pytest.mark.parametrize("parser,dest", CASES)
def test_a_flag_parses_to_the_jax_value(parser, dest):
    """`--<dest> <a value that is not the default>` through both
    packages' parsers (the master's; `serve` for its own flags)."""
    if parser == "master":
        jax_parser = _parser_of(jax_args.parse_master_args)
        port_parser = _parser_of(port_args.parse_master_args)
    else:
        jax_parser = _subparsers(jax_cli)["serve"]
        port_parser = _subparsers(cli)["serve"]
    action = _options(jax_parser)[dest]
    argv = [action.option_strings[0], _other_value(action)]
    jax_value = getattr(jax_parser.parse_args(argv), dest)
    port_value = getattr(port_parser.parse_args(argv), dest)
    assert jax_value != action.default
    assert port_value == jax_value


POLICY_ARGV = [
    "--num_workers", "2", "--min_workers", "2", "--max_workers", "5",
    "--policy_interval", "0.5", "--workers_per_group", "1",
    "--straggler_dwell_s", "12.5", "--eviction_budget", "4",
    "--eviction_cooldown_s", "33", "--backlog_per_worker", "2",
    "--backlog_ticks", "2", "--data_wait_share", "1.0",
    "--data_wait_ticks", "5", "--scale_step", "2",
    "--scale_hold_ticks", "3", "--serving_replicas", "2",
    "--min_serving_replicas", "1", "--max_serving_replicas", "4",
    "--serving_policy_interval", "0.25", "--serving_burn_threshold", "2.5",
    "--serving_shed_threshold", "0.05", "--serving_fill_low", "0.3",
    "--serving_up_ticks", "3", "--serving_down_ticks", "4",
    "--serving_scale_step", "2", "--serving_scale_hold_ticks", "1",
    "--serving_shed_window_s", "12", "--serving_probe_interval", "1.5",
    "--serving_probe_failures", "2", "--serving_step_skew_slo", "3",
    "--serving_port", "50071", "--backpressure_threshold", "0.5",
    "--backpressure_stride", "3",
    "--compilation_cache_dir", "/cache"]


@pytest.mark.parametrize("pair", [
    (jax_policy.PolicyConfig, port_policy.PolicyConfig),
    (jax_policy.ServingPolicyConfig, port_policy.ServingPolicyConfig),
    (jax_fleet.ServingFleetConfig, port_fleet.ServingFleetConfig),
], ids=["policy", "serving_policy", "serving_fleet"])
def test_the_configs_read_the_same_fields(pair):
    jax_cls, port_cls = pair
    jax_cfg = jax_cls.from_args(jax_args.parse_master_args(POLICY_ARGV))
    port_cfg = port_cls.from_args(port_args.parse_master_args(POLICY_ARGV))
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
    # the flags reach the config: not the defaults
    assert dataclasses.asdict(port_cfg) != dataclasses.asdict(port_cls())


def test_the_policy_bounds_reach_the_engine():
    """Before the flags existed the port's engine read max_workers =
    num_workers, and could never scale up."""
    cfg = port_policy.PolicyConfig.from_args(
        port_args.parse_master_args(POLICY_ARGV))
    assert (cfg.min_workers, cfg.max_workers) == (2, 5)
    assert cfg.data_wait_share == 1.0 and cfg.backlog_per_worker == 2.0


class _Host:
    @staticmethod
    def master_host(job_name):
        return "127.0.0.1"


def test_the_master_builds_worker_argv_the_worker_parses():
    """`_worker_command` re-serializes every flag of the master; the
    worker's parser reads each back to the master's value."""
    argv = ["--distribution_strategy", "AllReduce",
            "--model_def", "mnist.mnist_functional_api.custom_model",
            "--training_data", "/data/train", "--need_tf_config",
            "--device", "cpu", *POLICY_ARGV]
    args = port_args.parse_master_args(argv)
    master = Master.__new__(Master)
    master.args, master.job_type, master._k8s = args, "train", _Host()
    master.bound_port = 50123
    command = master._worker_command(3)
    assert command[1:3] == ["-m", "elasticdl_tpu_torch.worker.main"]
    worker = port_args.parse_worker_args(command[3:])
    assert (worker.worker_id, worker.master_addr, worker.job_type) == \
        (3, "127.0.0.1:50123", "train")
    for key, value in vars(args).items():
        if key not in ("master_addr", "job_type"):
            assert getattr(worker, key) == value, key
    assert worker.need_tf_config is True
    assert worker.compilation_cache_dir == "/cache"
    assert worker.max_workers == 5 and worker.data_wait_share == 1.0


def test_a_flag_neither_package_knows_is_refused(capsys):
    """The JAX master and worker parsers ignore an unknown flag
    (parse_known_args); the port's refuse it (ROADMAP.md queue 3)."""
    argv = ["--max_wrokers", "3"]
    assert not hasattr(jax_args.parse_master_args(argv), "max_wrokers")
    for parse in (port_args.parse_master_args, port_args.parse_worker_args):
        with pytest.raises(SystemExit):
            parse(argv)
        assert "unrecognized arguments: --max_wrokers" in \
            capsys.readouterr().err
