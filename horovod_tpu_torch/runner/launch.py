"""``horovodrun`` — the horovod_tpu_torch launcher CLI.

Counterpart of :mod:`horovod_tpu.runner.launch` and of the reference
launcher (reference: runner/launch.py:248-536 ``parse_args``,
:537-627 ``_run_static``, :630-677 ``_run_elastic``, :686-718
``run_controller``): the same flags and the same static launch.  There
is no mpirun/jsrun path — every run uses the TCP/HTTP control plane
(the reference's Gloo path).  Differences from the JAX package:

* ``--network-interface`` also binds the data plane: it exports
  ``GLOO_SOCKET_IFNAME`` and ``NCCL_SOCKET_IFNAME`` beside
  ``HOROVOD_GLOO_IFACE`` (``gpu_run.nic_env``);
* ``--tpu-pod`` raises: a GPU host has no TPU pod metadata;
* ``--network-interface`` binds the data plane of elastic runs too;
* ``--check-build`` reports PyTorch, CUDA cards, NCCL, gloo and ``nvcc``.

Examples:

    python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2 \
        python train.py
    python -m horovod_tpu_torch.runner.launch -np 16 -H host1:8,host2:8 \
        python train.py
    python -m horovod_tpu_torch.runner.launch -np 2 --min-np 2 --max-np 3 \
        --host-discovery-script ./discover.sh python train.py
"""

import argparse
import logging
import os
import sys

from . import config_parser
from .hosts import parse_host_files

logger = logging.getLogger("horovod_tpu_torch.launch")


def make_override_action(override_args):
    class StoreOverrideAction(argparse.Action):
        def __init__(self, option_strings, dest, default=None,
                     type=None, choices=None, required=False, help=None,
                     const=None, nargs=None):
            super().__init__(option_strings=option_strings, dest=dest,
                             default=default, type=type, choices=choices,
                             required=required, help=help, nargs=nargs)

        def __call__(self, parser, args, values, option_string=None):
            override_args.add(self.dest)
            setattr(args, self.dest, values)
    return StoreOverrideAction


def make_override_bool_action(override_args, value):
    class StoreOverrideBoolAction(argparse.Action):
        def __init__(self, option_strings, dest, default=None,
                     required=False, help=None):
            super().__init__(option_strings=option_strings, dest=dest,
                             nargs=0, default=default, required=required,
                             help=help)

        def __call__(self, parser, args, values, option_string=None):
            override_args.add(self.dest)
            setattr(args, self.dest, value)
    return StoreOverrideBoolAction


def parse_args(argv=None):
    from ..version import __version__

    override_args = set()
    parser = argparse.ArgumentParser(
        prog="horovodrun",
        description="horovod_tpu_torch distributed training launcher.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-v", "--version", action="version",
                        version=__version__)
    parser.add_argument("-cb", "--check-build", action="store_true",
                        dest="check_build",
                        help="Print available frameworks, controllers "
                             "and tensor operations, then exit "
                             "(reference: horovodrun --check-build).")
    parser.add_argument("-np", "--num-proc", dest="np", type=int,
                        help="Total number of worker processes.")
    parser.add_argument("--disable-cache", action="store_true",
                        dest="disable_cache",
                        help="Accepted for horovodrun compatibility "
                             "(launch checks are not cached here).")
    parser.add_argument("--start-timeout", dest="start_timeout",
                        type=int, default=600,
                        help="Seconds workers wait for the rank-0 "
                             "control plane at init.")
    parser.add_argument("--network-interface", dest="nics",
                        help="Comma-separated NICs for the control "
                             "plane (HOROVOD_GLOO_IFACE) and the data "
                             "plane (GLOO_SOCKET_IFNAME, the first; "
                             "NCCL_SOCKET_IFNAME, all).")
    parser.add_argument("--output-filename", dest="output_filename",
                        help="Redirect worker output to "
                             "<dir>/rank.N/stdout|stderr.")
    parser.add_argument("--verbose", action="store_true",
                        help="Verbose launcher logging.")
    parser.add_argument("--config-file", dest="config_file",
                        help="YAML config with tunable parameters.")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="Command to execute on every slot.")

    group_ssh = parser.add_argument_group("SSH arguments")
    group_ssh.add_argument("-p", "--ssh-port", dest="ssh_port", type=int,
                           help="SSH port on all hosts.")
    group_ssh.add_argument("-i", "--ssh-identity-file",
                           dest="ssh_identity_file",
                           help="SSH identity (private key) file.")

    group_params = parser.add_argument_group("tuneable parameter "
                                             "arguments")
    group_params.add_argument(
        "--fusion-threshold-mb", type=int,
        action=make_override_action(override_args),
        help="Fusion buffer threshold in MB.")
    group_params.add_argument(
        "--cycle-time-ms", type=float,
        action=make_override_action(override_args),
        help="Background cycle time in ms.")
    group_params.add_argument(
        "--cache-capacity", type=int,
        action=make_override_action(override_args),
        help="Response cache capacity (entries).")
    hier_ar = group_params.add_mutually_exclusive_group()
    hier_ar.add_argument("--hierarchical-allreduce",
                         dest="hierarchical_allreduce",
                         action=make_override_bool_action(override_args,
                                                          True),
                         help="Intra-host reduce-scatter + cross-host "
                              "allreduce + intra-host allgather.")
    hier_ar.add_argument("--no-hierarchical-allreduce",
                         dest="hierarchical_allreduce",
                         action=make_override_bool_action(override_args,
                                                          False))
    hier_ag = group_params.add_mutually_exclusive_group()
    hier_ag.add_argument("--hierarchical-allgather",
                         dest="hierarchical_allgather",
                         action=make_override_bool_action(override_args,
                                                          True))
    hier_ag.add_argument("--no-hierarchical-allgather",
                         dest="hierarchical_allgather",
                         action=make_override_bool_action(override_args,
                                                          False))

    group_at = parser.add_argument_group("autotune arguments")
    at_en = group_at.add_mutually_exclusive_group()
    at_en.add_argument("--autotune", dest="autotune",
                       action=make_override_bool_action(override_args,
                                                        True),
                       help="Enable Bayesian autotuning of fusion/cycle "
                            "knobs.")
    at_en.add_argument("--no-autotune", dest="autotune",
                       action=make_override_bool_action(override_args,
                                                        False))
    group_at.add_argument("--autotune-log-file",
                          action=make_override_action(override_args))
    group_at.add_argument("--autotune-warmup-samples", type=int,
                          action=make_override_action(override_args))
    group_at.add_argument("--autotune-steps-per-sample", type=int,
                          action=make_override_action(override_args))
    group_at.add_argument("--autotune-bayes-opt-max-samples", type=int,
                          action=make_override_action(override_args))
    group_at.add_argument("--autotune-gaussian-process-noise", type=float,
                          action=make_override_action(override_args))

    group_tn = parser.add_argument_group("autotune-then-freeze arguments")
    tn_en = group_tn.add_mutually_exclusive_group()
    tn_en.add_argument("--tune", dest="tune",
                       action=make_override_bool_action(override_args,
                                                        True),
                       help="Online knob search (per-cycle-class fusion "
                            "+ worker knobs) that freezes into a tuned "
                            "profile, then hands the schedule to "
                            "steady-state replay (docs/autotune.md).")
    tn_en.add_argument("--no-tune", dest="tune",
                       action=make_override_bool_action(override_args,
                                                        False))
    group_tn.add_argument("--tune-profile", dest="tune_profile",
                          action=make_override_action(override_args),
                          help="Tuned-profile artifact path: written at "
                               "freeze; an existing valid profile skips "
                               "the re-search on restart.")
    group_tn.add_argument("--tune-strategy", dest="tune_strategy",
                          choices=["gp", "grid"],
                          action=make_override_action(override_args),
                          help="gp = Gaussian-process EI (default); "
                               "grid = deterministic coordinate "
                               "descent.")
    group_tn.add_argument("--tune-cycles-per-sample", type=int,
                          action=make_override_action(override_args))
    group_tn.add_argument("--tune-max-samples", type=int,
                          action=make_override_action(override_args))
    group_tn.add_argument("--tune-warmup-windows", type=int,
                          action=make_override_action(override_args))

    group_el = parser.add_argument_group("elastic arguments")
    group_el.add_argument("--min-np", dest="min_np", type=int,
                          help="Minimum processes for elastic runs.")
    group_el.add_argument("--max-np", dest="max_np", type=int,
                          help="Maximum processes for elastic runs.")
    group_el.add_argument("--slots-per-host", dest="slots", type=int,
                          help="Slots per discovered host (elastic).")
    group_el.add_argument("--elastic-timeout", dest="elastic_timeout",
                          type=int, default=600,
                          help="Seconds to wait for min-np availability.")
    group_el.add_argument("--reset-limit", dest="reset_limit", type=int,
                          help="Max elastic resets before aborting.")

    group_tl = parser.add_argument_group("timeline arguments")
    group_tl.add_argument("--timeline-filename",
                          action=make_override_action(override_args),
                          help="Chrome-tracing timeline output file.")
    tl_mc = group_tl.add_mutually_exclusive_group()
    tl_mc.add_argument("--timeline-mark-cycles",
                       dest="timeline_mark_cycles",
                       action=make_override_bool_action(override_args,
                                                        True))
    tl_mc.add_argument("--no-timeline-mark-cycles",
                       dest="timeline_mark_cycles",
                       action=make_override_bool_action(override_args,
                                                        False))

    group_sc = parser.add_argument_group("stall check arguments")
    sc_en = group_sc.add_mutually_exclusive_group()
    sc_en.add_argument("--no-stall-check", dest="no_stall_check",
                       action=make_override_bool_action(override_args,
                                                        True))
    sc_en.add_argument("--stall-check", dest="no_stall_check",
                       action=make_override_bool_action(override_args,
                                                        False))
    group_sc.add_argument("--stall-check-warning-time-seconds", type=int,
                          action=make_override_action(override_args))
    group_sc.add_argument("--stall-check-shutdown-time-seconds", type=int,
                          action=make_override_action(override_args))

    group_log = parser.add_argument_group("logging arguments")
    group_log.add_argument("--log-level",
                           action=make_override_action(override_args),
                           choices=["TRACE", "DEBUG", "INFO", "WARNING",
                                    "ERROR", "FATAL"])
    log_ts = group_log.add_mutually_exclusive_group()
    log_ts.add_argument("--log-hide-timestamp", dest="log_hide_timestamp",
                        action=make_override_bool_action(override_args,
                                                         True))
    log_ts.add_argument("--no-log-hide-timestamp",
                        dest="log_hide_timestamp",
                        action=make_override_bool_action(override_args,
                                                         False))

    group_hosts = parser.add_argument_group("host arguments")
    hosts_ex = group_hosts.add_mutually_exclusive_group()
    hosts_ex.add_argument("-H", "--hosts", dest="hosts",
                          help="host:slots list, e.g. "
                               "'worker-0:8,worker-1:8'.")
    hosts_ex.add_argument("-hostfile", "--hostfile", dest="hostfile",
                          help="MPI-style hostfile ('host slots=N').")
    hosts_ex.add_argument("--host-discovery-script",
                          dest="host_discovery_script",
                          action=make_override_action(override_args),
                          help="Executable printing 'host:slots' lines; "
                               "enables elastic mode.")
    hosts_ex.add_argument("--tpu-pod", action="store_true",
                          dest="tpu_pod",
                          help="Accepted for compatibility with the JAX "
                               "package's launcher; raises on a GPU host.")

    # Compatibility no-ops: the launcher always uses the TCP/HTTP
    # controller (the reference's --gloo path); --mpi/--jsrun are
    # accepted and ignored with a warning for drop-in compatibility.
    group_ctl = parser.add_argument_group("controller arguments")
    ctl_ex = group_ctl.add_mutually_exclusive_group()
    ctl_ex.add_argument("--gloo", action="store_true", dest="use_gloo")
    ctl_ex.add_argument("--mpi", action="store_true", dest="use_mpi")
    ctl_ex.add_argument("--jsrun", action="store_true", dest="use_jsrun")

    args = parser.parse_args(argv)

    if args.config_file:
        import yaml
        with open(args.config_file) as f:
            config = yaml.safe_load(f) or {}
        config_parser.set_args_from_config(args, config, override_args)

    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    return args


def _resolve_hosts(args) -> str:
    if args.hosts:
        return args.hosts
    if args.hostfile:
        return parse_host_files(args.hostfile)
    if getattr(args, "tpu_pod", False):
        raise ValueError("--tpu-pod: no TPU pod metadata on a GPU host; "
                         "list the hosts with -H or --hostfile")
    np = args.np or 1
    return f"localhost:{np}"


def _run_static(args):
    from .gpu_run import launch_static, nic_env
    if args.np is None:
        raise ValueError("-np is required for static (non-elastic) runs")
    hosts = _resolve_hosts(args)
    env = dict(os.environ)
    worker_env = config_parser.env_from_args(args)
    if args.nics:
        worker_env.update(nic_env(args.nics))
    return launch_static(
        args.command, hosts, args.np,
        env=env,
        ssh_port=args.ssh_port,
        ssh_identity_file=args.ssh_identity_file,
        output_filename=args.output_filename,
        verbose=1 if args.verbose else 0,
        extra_worker_env=worker_env,
        start_timeout=args.start_timeout)


def _run_elastic(args):
    from .elastic.discovery import HostDiscoveryScript
    from .elastic_run import launch_elastic
    from .gpu_run import nic_env
    discovery = HostDiscoveryScript(args.host_discovery_script,
                                    args.slots or 1)
    worker_env = config_parser.env_from_args(args)
    if args.nics:
        worker_env.update(nic_env(args.nics))
    return launch_elastic(
        args.command,
        discovery=discovery,
        np=args.np,
        min_np=args.min_np or args.np,
        max_np=args.max_np,
        reset_limit=args.reset_limit,
        elastic_timeout=args.elastic_timeout,
        ssh_port=args.ssh_port,
        ssh_identity_file=args.ssh_identity_file,
        output_filename=args.output_filename,
        verbose=1 if args.verbose else 0,
        extra_worker_env=worker_env)


def _run(args):
    if args.np is None and args.min_np is None:
        raise ValueError("-np (or --min-np) is required")
    if args.use_mpi or args.use_jsrun:
        logger.warning("--mpi/--jsrun are not supported; using the TCP "
                       "controller (equivalent of --gloo).")
    if args.host_discovery_script:
        return _run_elastic(args)
    return _run_static(args)


def check_build():
    """Build/availability report (reference: launch.py:116-153
    check_build — frameworks, controllers, tensor operations), for
    the port: PyTorch, its CUDA cards, NCCL, gloo and the ``nvcc``
    that builds the port's kernels."""
    import torch
    import torch.distributed as dist

    from ..kernels import nvcc_path
    from ..version import __version__

    def x(v):
        return "X" if v else " "

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    try:
        nvcc = nvcc_path()
    except RuntimeError:
        nvcc = None
    print(f"""\
horovod_tpu_torch v{__version__}:

Available Frameworks:
    [X] PyTorch {torch.__version__}

Available Controllers:
    [X] TCP (Python coordinator)
    [ ] TCP (native C++ coordinator, not ported)

Available Tensor Operations:
    [{x(dist.is_nccl_available() and cards)}] NCCL (CUDA tensors, one card per local rank)
    [{x(dist.is_gloo_available())}] Gloo (CPU tensors; CUDA tensors when local ranks share a card)

Devices and kernels:
    [{x(cards)}] CUDA cards: {cards}
    [{x(nvcc)}] nvcc for horovod_tpu_torch/kernels: {nvcc or "not found"}""")


def run_commandline():
    args = parse_args()
    if args.check_build:
        check_build()
        return
    if not args.command:
        print("horovodrun: no command given; see horovodrun -h",
              file=sys.stderr)
        sys.exit(2)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    try:
        _run(args)
    except (RuntimeError, ValueError, NotImplementedError) as e:
        print(f"horovodrun: {e}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    run_commandline()
