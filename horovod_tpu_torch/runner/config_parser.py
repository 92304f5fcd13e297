"""YAML config file → CLI args → worker env translation.

Mirrors the reference's config plumbing (reference:
runner/common/util/config_parser.py — ``set_args_from_config`` /
``set_env_from_args``): a YAML file can pre-set any tunable flag, the
CLI overrides it, and at launch every tunable becomes a ``HOROVOD_*``
environment variable forwarded to the workers — the single source of
truth the in-process runtime reads (``horovod_tpu_torch.common.env``).

Counterpart of :mod:`horovod_tpu.runner.config_parser`, copied.
"""

from typing import Dict

# flag attr -> (env var, transform)
_ENV_MAP = {
    "fusion_threshold_mb": ("HOROVOD_FUSION_THRESHOLD",
                            lambda v: str(int(v) * 1024 * 1024)),
    "cycle_time_ms": ("HOROVOD_CYCLE_TIME", str),
    "cache_capacity": ("HOROVOD_CACHE_CAPACITY", str),
    "hierarchical_allreduce": ("HOROVOD_HIERARCHICAL_ALLREDUCE",
                               lambda v: "1" if v else "0"),
    "hierarchical_allgather": ("HOROVOD_HIERARCHICAL_ALLGATHER",
                               lambda v: "1" if v else "0"),
    "autotune": ("HOROVOD_AUTOTUNE", lambda v: "1" if v else "0"),
    "autotune_log_file": ("HOROVOD_AUTOTUNE_LOG", str),
    "autotune_warmup_samples": ("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", str),
    "autotune_steps_per_sample": ("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE",
                                  str),
    "autotune_bayes_opt_max_samples":
        ("HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", str),
    "autotune_gaussian_process_noise":
        ("HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE", str),
    "tune": ("HOROVOD_TUNE", lambda v: "1" if v else "0"),
    "tune_profile": ("HOROVOD_TUNE_PROFILE", str),
    "tune_strategy": ("HOROVOD_TUNE_STRATEGY", str),
    "tune_cycles_per_sample": ("HOROVOD_TUNE_CYCLES_PER_SAMPLE", str),
    "tune_max_samples": ("HOROVOD_TUNE_MAX_SAMPLES", str),
    "tune_warmup_windows": ("HOROVOD_TUNE_WARMUP_WINDOWS", str),
    "timeline_filename": ("HOROVOD_TIMELINE", str),
    "timeline_mark_cycles": ("HOROVOD_TIMELINE_MARK_CYCLES",
                             lambda v: "1" if v else "0"),
    "no_stall_check": ("HOROVOD_STALL_CHECK_DISABLE",
                       lambda v: "1" if v else "0"),
    "stall_check_warning_time_seconds":
        ("HOROVOD_STALL_CHECK_TIME_SECONDS", str),
    "stall_check_shutdown_time_seconds":
        ("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", str),
    "log_level": ("HOROVOD_LOG_LEVEL", str),
    "log_hide_timestamp": ("HOROVOD_LOG_HIDE_TIME",
                           lambda v: "1" if v else "0"),
}

# YAML section -> {yaml key -> args attr}
_CONFIG_SECTIONS = {
    "params": {
        "fusion_threshold_mb": "fusion_threshold_mb",
        "cycle_time_ms": "cycle_time_ms",
        "cache_capacity": "cache_capacity",
        "hierarchical_allreduce": "hierarchical_allreduce",
        "hierarchical_allgather": "hierarchical_allgather",
    },
    "autotune": {
        "enabled": "autotune",
        "log_file": "autotune_log_file",
        "warmup_samples": "autotune_warmup_samples",
        "steps_per_sample": "autotune_steps_per_sample",
        "bayes_opt_max_samples": "autotune_bayes_opt_max_samples",
        "gaussian_process_noise": "autotune_gaussian_process_noise",
    },
    "tune": {
        "enabled": "tune",
        "profile": "tune_profile",
        "strategy": "tune_strategy",
        "cycles_per_sample": "tune_cycles_per_sample",
        "max_samples": "tune_max_samples",
        "warmup_windows": "tune_warmup_windows",
    },
    "timeline": {
        "filename": "timeline_filename",
        "mark_cycles": "timeline_mark_cycles",
    },
    "stall_check": {
        "disabled": "no_stall_check",
        "warning_time_seconds": "stall_check_warning_time_seconds",
        "shutdown_time_seconds": "stall_check_shutdown_time_seconds",
    },
    "logging": {
        "level": "log_level",
        "hide_timestamp": "log_hide_timestamp",
    },
}


def set_args_from_config(args, config, override_args):
    """Apply a parsed YAML dict onto the argparse namespace; attrs in
    ``override_args`` (set on the CLI) win over the file."""
    for section, mapping in _CONFIG_SECTIONS.items():
        sect = config.get(section) or {}
        for yaml_key, attr in mapping.items():
            if yaml_key in sect and attr not in override_args:
                setattr(args, attr, sect[yaml_key])


def env_from_args(args) -> Dict[str, str]:
    """Translate tunable flags into the worker HOROVOD_* env vars."""
    env = {}
    for attr, (var, conv) in _ENV_MAP.items():
        v = getattr(args, attr, None)
        if v is not None:
            env[var] = conv(v)
    return env
