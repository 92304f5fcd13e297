"""Environment-variable knob and rank contract parsing.

The single source of truth for configuration is environment variables, the
same contract the reference core uses (reference: common/common.h:64-92,
parsed in operations.cc:441-534 and utils/env_parser.cc; rank identity
contract in runner/gloo_run.py:65-76).  The launcher translates CLI flags /
YAML config into these variables and forwards them to every slot; the
in-process runtime reads them once at ``init()``.
"""

import dataclasses
import os
from typing import Optional

# --- rank identity contract (set by the launcher for every slot) ---------
HOROVOD_RANK = "HOROVOD_RANK"
HOROVOD_SIZE = "HOROVOD_SIZE"
HOROVOD_LOCAL_RANK = "HOROVOD_LOCAL_RANK"
HOROVOD_LOCAL_SIZE = "HOROVOD_LOCAL_SIZE"
HOROVOD_CROSS_RANK = "HOROVOD_CROSS_RANK"
HOROVOD_CROSS_SIZE = "HOROVOD_CROSS_SIZE"
HOROVOD_HOSTNAME = "HOROVOD_HOSTNAME"

# --- rendezvous / control plane ------------------------------------------
HOROVOD_RENDEZVOUS_ADDR = "HOROVOD_GLOO_RENDEZVOUS_ADDR"
HOROVOD_RENDEZVOUS_PORT = "HOROVOD_GLOO_RENDEZVOUS_PORT"
HOROVOD_CONTROLLER = "HOROVOD_CONTROLLER"
HOROVOD_IFACE = "HOROVOD_GLOO_IFACE"
# Elastic workers ask the rendezvous server for a fresh rank assignment
# using this scope key (reference: gloo/gloo_context.cc:154-200).
GET_RANK_AND_SIZE = "rank_and_size"

# --- performance knobs ----------------------------------------------------
HOROVOD_FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"
HOROVOD_CYCLE_TIME = "HOROVOD_CYCLE_TIME"
HOROVOD_CACHE_CAPACITY = "HOROVOD_CACHE_CAPACITY"
HOROVOD_HIERARCHICAL_ALLREDUCE = "HOROVOD_HIERARCHICAL_ALLREDUCE"
HOROVOD_HIERARCHICAL_ALLGATHER = "HOROVOD_HIERARCHICAL_ALLGATHER"
HOROVOD_AUTOTUNE = "HOROVOD_AUTOTUNE"
# Steady-state replay: after N converged cache-hit cycles a rank
# freezes the fused response schedule and executes it locally with no
# coordinator round-trips (common/replay.py).  On by default; 0/false
# disables.
HOROVOD_STEADY_STATE_REPLAY = "HOROVOD_STEADY_STATE_REPLAY"
HOROVOD_REPLAY_WARMUP_CYCLES = "HOROVOD_REPLAY_WARMUP_CYCLES"
HOROVOD_AUTOTUNE_LOG = "HOROVOD_AUTOTUNE_LOG"
# Autotune-then-freeze (horovod_tpu/tune, docs/autotune.md): run an
# online knob search as replay's warmup phase — per-cycle-class fusion
# thresholds plus the worker knobs (cycle time, request coalescing,
# replay warmup) — then FREEZE the winner and let steady-state replay
# engage on the tuned schedule.  Python-coordinator-only (in-line round
# scoring + PA knob frames), the same gating as HOROVOD_AUTOTUNE.
HOROVOD_TUNE = "HOROVOD_TUNE"
# Tuned-profile artifact path: while tuning, the freeze persists the
# winning configuration here; at init, an EXISTING valid profile is
# loaded instead of re-searching (restarts and elastic resizes skip
# straight to the frozen knobs + replay).
HOROVOD_TUNE_PROFILE = "HOROVOD_TUNE_PROFILE"
# Search strategy: "gp" (Gaussian-process Expected Improvement over
# the continuous knobs, fixed seed) or "grid" (deterministic
# coordinate descent — what tests and chaos drills pin).
HOROVOD_TUNE_STRATEGY = "HOROVOD_TUNE_STRATEGY"
HOROVOD_TUNE_CYCLES_PER_SAMPLE = "HOROVOD_TUNE_CYCLES_PER_SAMPLE"
HOROVOD_TUNE_MAX_SAMPLES = "HOROVOD_TUNE_MAX_SAMPLES"
HOROVOD_TUNE_WARMUP_WINDOWS = "HOROVOD_TUNE_WARMUP_WINDOWS"
# Request coalescing (PR 4): the inline fast path is taken only from
# an IDLE tensor table, so async bursts drain as one CH/RQ frame per
# kind.  On by default; the tuner explores both settings (0 = every
# submission goes inline immediately, one frame per op).
HOROVOD_REQUEST_COALESCING = "HOROVOD_REQUEST_COALESCING"
HOROVOD_AUTOTUNE_WARMUP_SAMPLES = "HOROVOD_AUTOTUNE_WARMUP_SAMPLES"
HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE = "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE"
HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES = "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES"
HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE = "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE"

# --- robustness / self-healing control plane -----------------------------
# Bounds how long workers wait for each other at init: the controller
# connect loop, the rendezvous addr lookup, the elastic re-rendezvous
# and the coordinator drain all derive their deadline from this one
# knob (launcher --start-timeout; reference launch.py start_timeout
# contract).  Historically each site re-read the variable with its own
# default; `start_timeout()` is now the single parse point.
HOROVOD_START_TIMEOUT = "HOROVOD_START_TIMEOUT"
START_TIMEOUT_DEFAULT = 120.0
# Control-plane liveness: when the interval is > 0, every worker sends
# lightweight HB heartbeat frames on its coordinator link (suppressed
# while real traffic flows) and the coordinator runs a liveness sweep,
# so a wedged-but-connected rank (SIGSTOP, GIL deadlock, half-open
# socket) is detected within ~2x the interval even with no collective
# pending.  0 (default) = disabled; liveness pins the Python
# coordinator (the native one has no HB handling — same gating as
# autotune/metrics aggregation/failpoints).
HOROVOD_LIVENESS_INTERVAL = "HOROVOD_LIVENESS_INTERVAL"
# Silence threshold before a peer is presumed dead.  Default (unset or
# 0): 2x the liveness interval.
HOROVOD_LIVENESS_TIMEOUT = "HOROVOD_LIVENESS_TIMEOUT"
# Reconnecting control channel: a worker whose coordinator socket dies
# retries with jittered exponential backoff inside this grace window,
# while the coordinator holds the rank in limbo and replays missed
# frames on resume — a transient TCP drop no longer breaks the world.
# Default (unset or 0 with liveness enabled): the liveness timeout;
# explicit 0 with liveness disabled = reconnects off (legacy fail-fast
# behavior).
HOROVOD_RECONNECT_GRACE = "HOROVOD_RECONNECT_GRACE"
# Bound on the registration-phase first frame: a client that connects
# and never identifies its rank is cut after this many seconds
# (previously a hardcoded 30 s).
HOROVOD_REGISTRATION_TIMEOUT = "HOROVOD_REGISTRATION_TIMEOUT"
# Relay-tree control plane (docs/architecture.md): interior relay
# nodes — one per simulated "host", arity bounded by this knob —
# aggregate their children's CH/RQ/MQ uplinks and fan CB/RS/HB
# broadcasts down, so rank 0 touches O(fanout) links instead of
# O(world).  0 (default) = the flat star (every rank links directly
# to rank 0, byte-identical to the pre-tree wire behavior); > 0 pins
# the Python coordinator (the native one has no relay frames — same
# gating as liveness/autotune/metrics aggregation).  Worlds of
# size <= fanout + 1 stay flat even when set (a relay would not
# reduce the root's link count).
HOROVOD_COORD_FANOUT = "HOROVOD_COORD_FANOUT"
# Relay address map for launchers/harnesses that pre-assign relay
# ports: a JSON object {"<relay_id>": "host:port", ...}.  When set,
# workers resolve relay addresses from it and NO rank self-hosts a
# relay (the harness owns them); when unset, designated host ranks
# start relays in-process and publish their addresses through the
# rendezvous KV (key ``relay.<id>`` in the controller scope).
HOROVOD_RELAY_ADDRS = "HOROVOD_RELAY_ADDRS"
# Depth-aware liveness deadlines: every relay hop adds forwarding
# latency (and, during a re-home, up to one grace window) between a
# peer's heartbeat and its observer, so a depth-blind timeout would
# false-promote healthy subtrees behind a busy relay.  The effective
# deadline a node applies to a link grows linearly with the number of
# relay hops the watched traffic crosses:
#
#     effective_timeout(base, hops) = base * (1 + HOP_SLACK * hops)
#
# hops = 0 is a direct link (flat star and the root's leaf links —
# exactly the pre-tree behavior); a leaf at depth d watches the
# coordinator through d relay hops; the root watches a relay link
# with the subtree's depth below it.  The detection-bound table by
# depth lives in docs/failure_recovery.md.
LIVENESS_HOP_SLACK = 0.5


def depth_aware_liveness_timeout(base_timeout_s: float,
                                 hops: int) -> float:
    """Effective liveness deadline for a link whose watched traffic
    crosses ``hops`` relay hops (see LIVENESS_HOP_SLACK above for the
    formula; hops=0 reproduces the flat-star deadline exactly)."""
    return base_timeout_s * (1.0 + LIVENESS_HOP_SLACK * max(0, int(hops)))
# Differential checkpoints: the longest base→tip delta chain before
# the manager forces the next save to be a full base (bounds restore
# replay cost and the blast radius of a corrupt base).  0 = deltas
# disabled (every save is a full base).
HOROVOD_CKPT_DELTA_CHAIN_MAX = "HOROVOD_CKPT_DELTA_CHAIN_MAX"
CKPT_DELTA_CHAIN_MAX_DEFAULT = 8


def ckpt_delta_chain_max() -> int:
    """The delta-chain length bound, parsed freshly on every call
    (bench lanes and drills sweep it per phase)."""
    return max(0, env_int(HOROVOD_CKPT_DELTA_CHAIN_MAX,
                          CKPT_DELTA_CHAIN_MAX_DEFAULT))


# --- sparse lookup plane --------------------------------------------------
# Dedupe repeated ids within a batch before the ids alltoall in
# ShardedEmbedding.lookup (each unique id crosses the wire once; rows
# scatter back through the inverse index).  On Zipf-shaped traffic this
# cuts alltoall bytes hard; 0 disables for A/B measurement.
HOROVOD_SPARSE_DEDUPE = "HOROVOD_SPARSE_DEDUPE"


def sparse_dedupe_enabled() -> bool:
    """Whether lookup dedupes ids before the exchange, parsed freshly
    per lookup (the bytes-comparison test flips it between passes)."""
    return env_bool(HOROVOD_SPARSE_DEDUPE, True)


# --- online serving plane (horovod_tpu/serve/) ----------------------------
# Staleness bound for serving reads: reject a lookup when the freshest
# committed training step is more than this many steps ahead of the
# snapshot the replica is serving.  0 = unbounded (never reject).
HOROVOD_SERVE_MAX_STALENESS_STEPS = "HOROVOD_SERVE_MAX_STALENESS_STEPS"
SERVE_MAX_STALENESS_STEPS_DEFAULT = 0
# How often the replica's tail thread polls the checkpoint directory
# for newly committed manifests (seconds).
HOROVOD_SERVE_POLL_SECONDS = "HOROVOD_SERVE_POLL_SECONDS"
SERVE_POLL_SECONDS_DEFAULT = 0.5
# Port for the HTTP lookup endpoint (0 = ephemeral).
HOROVOD_SERVE_PORT = "HOROVOD_SERVE_PORT"


def serve_max_staleness_steps() -> int:
    """The staleness-rejection bound in steps (0 = unbounded), parsed
    freshly per lookup so tests and operators can tighten it live."""
    return max(0, env_int(HOROVOD_SERVE_MAX_STALENESS_STEPS,
                          SERVE_MAX_STALENESS_STEPS_DEFAULT))


def serve_poll_seconds() -> float:
    """The manifest-tail poll interval in seconds."""
    return max(0.01, env_float(HOROVOD_SERVE_POLL_SECONDS,
                               SERVE_POLL_SECONDS_DEFAULT))


def start_timeout(default: float = None) -> float:
    """The HOROVOD_START_TIMEOUT deadline (seconds), parsed freshly on
    every call so tests and elastic re-inits that mutate the env see
    the current value."""
    return env_float(HOROVOD_START_TIMEOUT,
                     START_TIMEOUT_DEFAULT if default is None else default)


# --- observability --------------------------------------------------------
# Black-box flight recorder (common/flight_recorder.py): a bounded
# in-memory ring of typed control-plane events, dumped as per-rank
# JSON on failure triggers (lost-rank promotion, stall shutdown, fatal
# unwind, SIGUSR2) and merged into one causal chrome-trace +
# machine-readable verdict by tools/blackbox_merge.py.
# HOROVOD_BLACKBOX=1 arms the ring (extract via SIGUSR2 or the
# /blackbox HTTP handler); HOROVOD_BLACKBOX_DIR=/path also enables the
# automatic failure-trigger dumps; HOROVOD_BLACKBOX_EVENTS bounds the
# ring (default 8192 events).  Disabled cost on the submit/frame hot
# paths is ONE attribute check (the failpoints precedent, pinned by
# tests/test_flight_recorder.py).
HOROVOD_BLACKBOX = "HOROVOD_BLACKBOX"
HOROVOD_BLACKBOX_DIR = "HOROVOD_BLACKBOX_DIR"
HOROVOD_BLACKBOX_EVENTS = "HOROVOD_BLACKBOX_EVENTS"
# Live straggler observatory (common/straggler.py): per-cycle
# critical-path attribution on the coordinator (which rank's readiness
# arrived last, folded into per-rank lag EWMAs), per-rank phase
# summaries riding the MR metrics frames so attribution keeps working
# during steady-state replay, hvd_straggler_score{rank} gauges, and
# the /status plane + tools/hvdtop.py dashboard.  HOROVOD_STRAGGLER=1
# arms it; disabled cost on the submit/recv hot paths is ONE attribute
# check (the failpoints/flight-recorder precedent, pinned by
# tests/test_straggler.py).
HOROVOD_STRAGGLER = "HOROVOD_STRAGGLER"
# A rank whose normalized lag score crosses this threshold is flagged
# slow: one flight-recorder event + an elastic/slow/<rank> rendezvous
# KV notice (the pre-emptive-migration hook, ROADMAP item 5c).
HOROVOD_STRAGGLER_THRESHOLD = "HOROVOD_STRAGGLER_THRESHOLD"
STRAGGLER_THRESHOLD_DEFAULT = 4.0
# Noise floor (seconds): arrival-lag / peer-wait gaps below this never
# score — a tight world full of microsecond jitter must read all-zero.
HOROVOD_STRAGGLER_MIN_LAG = "HOROVOD_STRAGGLER_MIN_LAG"
STRAGGLER_MIN_LAG_DEFAULT = 0.005


def straggler_threshold() -> float:
    """Score threshold for flagging a rank slow, parsed freshly (the
    drills sweep it per phase)."""
    return env_float(HOROVOD_STRAGGLER_THRESHOLD,
                     STRAGGLER_THRESHOLD_DEFAULT)


def straggler_min_lag() -> float:
    """The attribution noise floor in seconds (see above)."""
    return max(1e-4, env_float(HOROVOD_STRAGGLER_MIN_LAG,
                               STRAGGLER_MIN_LAG_DEFAULT))


# Continuous sampling profiler (common/profiler.py): a low-Hz
# sys._current_frames walker per rank that attributes wall time to
# subsystem lanes (submit/controller/ring/replay/checkpoint), ships a
# top-K hot-frame digest on the MR metrics frames, serves the full
# collapsed-stack profile at job-secret GET /profile, and snapshots
# the last window when a straggler flag / stall warning / SLO burn
# fires.  HOROVOD_PROFILE=1 arms it; disabled cost on hot paths is ONE
# attribute check (the failpoints precedent, pinned by
# tests/test_profiler.py).
HOROVOD_PROFILE = "HOROVOD_PROFILE"
# Sampling frequency in Hz.  10 Hz resolves anything that dominates a
# multi-second window while staying ~0.1% overhead; drills bump it to
# sharpen time-to-root-cause.
HOROVOD_PROFILE_HZ = "HOROVOD_PROFILE_HZ"
PROFILE_HZ_DEFAULT = 10.0
# Digest width: how many hot frames each rank folds into its MR reply.
HOROVOD_PROFILE_TOPK = "HOROVOD_PROFILE_TOPK"
PROFILE_TOPK_DEFAULT = 5


def profile_hz() -> float:
    """Profiler sampling frequency, parsed freshly (drills sweep it
    per phase); clamped to [0.1, 250] Hz."""
    return min(250.0, max(0.1, env_float(HOROVOD_PROFILE_HZ,
                                         PROFILE_HZ_DEFAULT)))


def profile_topk() -> int:
    """Hot-frame digest width (entries per rank per MR reply)."""
    return max(1, env_int(HOROVOD_PROFILE_TOPK, PROFILE_TOPK_DEFAULT))


# SLO plane (common/slo.py): steps/s and cycle-time SLIs over short /
# long sliding windows with multi-window burn-rate alerting (the SRE
# fast+slow window pattern: an alert fires only when BOTH windows burn
# error budget faster than the threshold, killing both flap and
# blindness).  HOROVOD_SLO=1 arms it; targets of 0 disable their SLI.
HOROVOD_SLO = "HOROVOD_SLO"
# Throughput target: completed collective ops per second (the
# hvd_worker_op_rate vocabulary).  0 (default) = SLI off.
HOROVOD_SLO_STEPS_PER_S = "HOROVOD_SLO_STEPS_PER_S"
SLO_STEPS_PER_S_DEFAULT = 0.0
# Latency target: controller cycle seconds (matches
# hvd_controller_cycle_seconds).  0 (default) = SLI off.
HOROVOD_SLO_CYCLE_SECONDS = "HOROVOD_SLO_CYCLE_SECONDS"
SLO_CYCLE_SECONDS_DEFAULT = 0.0
# Sliding-window lengths (seconds): short catches fast regressions,
# long confirms they are sustained.
HOROVOD_SLO_WINDOW_SHORT = "HOROVOD_SLO_WINDOW_SHORT"
SLO_WINDOW_SHORT_DEFAULT = 30.0
HOROVOD_SLO_WINDOW_LONG = "HOROVOD_SLO_WINDOW_LONG"
SLO_WINDOW_LONG_DEFAULT = 300.0
# Burn-rate alert threshold: alert when shortfall/budget >= this in
# BOTH windows (2.0 = burning monthly budget at 2x sustainable rate).
HOROVOD_SLO_BURN_THRESHOLD = "HOROVOD_SLO_BURN_THRESHOLD"
SLO_BURN_THRESHOLD_DEFAULT = 2.0
# Error budget: tolerated fractional shortfall against the target
# (0.1 = achieving 90% of target consumes budget at exactly 1x).
HOROVOD_SLO_BUDGET = "HOROVOD_SLO_BUDGET"
SLO_BUDGET_DEFAULT = 0.1


def slo_targets() -> dict:
    """SLO targets + window/burn config, parsed freshly per
    evaluation tick (drills sweep targets to force burns)."""
    return {
        "steps_per_s": max(0.0, env_float(HOROVOD_SLO_STEPS_PER_S,
                                          SLO_STEPS_PER_S_DEFAULT)),
        "cycle_seconds": max(0.0, env_float(
            HOROVOD_SLO_CYCLE_SECONDS, SLO_CYCLE_SECONDS_DEFAULT)),
        "window_short": max(1.0, env_float(HOROVOD_SLO_WINDOW_SHORT,
                                           SLO_WINDOW_SHORT_DEFAULT)),
        "window_long": max(1.0, env_float(HOROVOD_SLO_WINDOW_LONG,
                                          SLO_WINDOW_LONG_DEFAULT)),
        "burn_threshold": max(0.1, env_float(
            HOROVOD_SLO_BURN_THRESHOLD, SLO_BURN_THRESHOLD_DEFAULT)),
        "budget": min(1.0, max(1e-4, env_float(HOROVOD_SLO_BUDGET,
                                               SLO_BUDGET_DEFAULT))),
    }


HOROVOD_TIMELINE = "HOROVOD_TIMELINE"
# Opt-in Prometheus-text /metrics endpoint: set to a port (0 = pick an
# ephemeral one); unset = no endpoint.  Each rank binds
# port + local_rank so one knob serves multi-rank hosts.
HOROVOD_METRICS_PORT = "HOROVOD_METRICS_PORT"
# Cross-rank metrics aggregation cadence (seconds): the rank-0
# coordinator polls per-rank snapshots over the control plane at this
# interval.  0 (default) = disabled; setting it opts into the Python
# coordinator (the native one has no metrics frames).
HOROVOD_METRICS_AGG_SECONDS = "HOROVOD_METRICS_AGG_SECONDS"
HOROVOD_TIMELINE_MARK_CYCLES = "HOROVOD_TIMELINE_MARK_CYCLES"
HOROVOD_LOG_LEVEL = "HOROVOD_LOG_LEVEL"
HOROVOD_LOG_HIDE_TIME = "HOROVOD_LOG_HIDE_TIME"
HOROVOD_STALL_CHECK_DISABLE = "HOROVOD_STALL_CHECK_DISABLE"
HOROVOD_STALL_CHECK_TIME_SECONDS = "HOROVOD_STALL_CHECK_TIME_SECONDS"
HOROVOD_STALL_SHUTDOWN_TIME_SECONDS = "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"

# --- elastic --------------------------------------------------------------
HOROVOD_ELASTIC = "HOROVOD_ELASTIC"
HOROVOD_HOSTNAME_KEY = HOROVOD_HOSTNAME
# Closed-loop elasticity (runner/elastic, docs/failure_recovery.md
# "Autoscaling").  Scale-up admission: when enabled (default), hosts
# discovered AFTER the initial formation are admitted mid-job — the
# driver holds them pending until the policy engine approves, then
# bumps the discovery generation so workers re-rendezvous into the
# grown world.  Disabled: discovered hosts still serve as replacements
# at the next failure-driven replan, but never trigger a resize on
# their own.
HOROVOD_ELASTIC_SCALE_UP = "HOROVOD_ELASTIC_SCALE_UP"
# Blacklist cooldown (seconds): a host evicted for a failure is
# re-admitted after base * 2^(strikes-1) seconds (decaying
# re-admission — each repeat offense doubles the sit-out, capped at
# 2^6 ≈ 64x).  0 (default) = permanent blacklist (legacy behavior).
HOROVOD_ELASTIC_BLACKLIST_COOLDOWN = "HOROVOD_ELASTIC_BLACKLIST_COOLDOWN"
BLACKLIST_COOLDOWN_DEFAULT = 0.0
BLACKLIST_MAX_STRIKE_DOUBLINGS = 6
# Bound on one --host-discovery-script execution: a hung script times
# out after this many seconds, the driver logs ONCE and keeps the
# last-good host set (the start_timeout()-style fresh-parse contract).
HOROVOD_ELASTIC_DISCOVERY_TIMEOUT = "HOROVOD_ELASTIC_DISCOVERY_TIMEOUT"
DISCOVERY_TIMEOUT_DEFAULT = 10.0
# Policy engine (runner/elastic/policy.py): resize decisions from the
# aggregated signals (pending hosts, straggler scores, cycle time /
# queue depth / steps-per-s) instead of only from deaths.  WINDOW is
# the hysteresis — a condition must hold for this many CONSECUTIVE
# observation ticks before a decision fires; COOLDOWN is the refractory
# period after any decision during which no new one fires (together
# they make flapping structurally impossible).
HOROVOD_ELASTIC_POLICY = "HOROVOD_ELASTIC_POLICY"
HOROVOD_ELASTIC_POLICY_WINDOW = "HOROVOD_ELASTIC_POLICY_WINDOW"
POLICY_WINDOW_DEFAULT = 3
HOROVOD_ELASTIC_POLICY_COOLDOWN = "HOROVOD_ELASTIC_POLICY_COOLDOWN"
POLICY_COOLDOWN_DEFAULT = 30.0
# Verdict-driven pre-emptive migration: act on the straggler
# observatory's elastic/slow-<rank> publications (slow-vs-dead: a rank
# with a ``lost`` notice is dead and owned by the eviction path; a
# ``slow`` notice means alive-but-lagging).  A rank persistently
# flagged for MIGRATE_AFTER seconds is checkpoint-then-evicted: the
# driver waits (bounded by MIGRATE_CKPT_WAIT) for ckpt/latest to
# advance past the decision point, then evicts the host BEFORE the
# stall clock would have fired.
HOROVOD_STRAGGLER_MIGRATE = "HOROVOD_STRAGGLER_MIGRATE"
HOROVOD_STRAGGLER_MIGRATE_AFTER = "HOROVOD_STRAGGLER_MIGRATE_AFTER"
STRAGGLER_MIGRATE_AFTER_DEFAULT = 10.0
HOROVOD_STRAGGLER_MIGRATE_CKPT_WAIT = "HOROVOD_STRAGGLER_MIGRATE_CKPT_WAIT"
STRAGGLER_MIGRATE_CKPT_WAIT_DEFAULT = 30.0


def elastic_scale_up_enabled() -> bool:
    """Mid-job scale-up admission gate, parsed freshly (drills and
    tests flip it per phase)."""
    return env_bool(HOROVOD_ELASTIC_SCALE_UP, True)


def blacklist_cooldown() -> float:
    """Base blacklist cooldown in seconds (0 = permanent), parsed
    freshly on every eviction."""
    return max(0.0, env_float(HOROVOD_ELASTIC_BLACKLIST_COOLDOWN,
                              BLACKLIST_COOLDOWN_DEFAULT))


def discovery_timeout() -> float:
    """Deadline for one host-discovery-script execution, seconds."""
    return max(0.1, env_float(HOROVOD_ELASTIC_DISCOVERY_TIMEOUT,
                              DISCOVERY_TIMEOUT_DEFAULT))


def policy_enabled() -> bool:
    """Policy-engine gate (default on: with it off, the driver falls
    back to the legacy react-only behavior — deaths shrink, discovery
    growth is admitted immediately with no hysteresis)."""
    return env_bool(HOROVOD_ELASTIC_POLICY, True)


def policy_window() -> int:
    """Hysteresis window: consecutive agreeing observation ticks
    required before the policy engine fires a decision."""
    return max(1, env_int(HOROVOD_ELASTIC_POLICY_WINDOW,
                          POLICY_WINDOW_DEFAULT))


def policy_cooldown() -> float:
    """Refractory period (seconds) after any resize decision."""
    return max(0.0, env_float(HOROVOD_ELASTIC_POLICY_COOLDOWN,
                              POLICY_COOLDOWN_DEFAULT))


def straggler_migrate_enabled() -> bool:
    """Pre-emptive straggler migration gate (default off: acting on
    scores is a policy choice, observing them is not)."""
    return env_bool(HOROVOD_STRAGGLER_MIGRATE, False)


def straggler_migrate_after() -> float:
    """Seconds a rank must stay flagged slow before the migration
    decision fires (persistence, not a single spike)."""
    return max(0.0, env_float(HOROVOD_STRAGGLER_MIGRATE_AFTER,
                              STRAGGLER_MIGRATE_AFTER_DEFAULT))


def straggler_migrate_ckpt_wait() -> float:
    """Bound on the checkpoint-then-evict wait for ckpt/latest to
    advance past the migration decision (seconds); expiry evicts
    anyway — step loss is then bounded by the checkpoint cadence."""
    return max(0.0, env_float(HOROVOD_STRAGGLER_MIGRATE_CKPT_WAIT,
                              STRAGGLER_MIGRATE_CKPT_WAIT_DEFAULT))

# --- TPU-specific ---------------------------------------------------------
HOROVOD_TPU_OPERATIONS = "HOROVOD_TPU_OPERATIONS"   # "XLA" (default) | "TCP"
HOROVOD_TPU_MESH_AXES = "HOROVOD_TPU_MESH_AXES"     # e.g. "dp:4,tp:2"
HOROVOD_TPU_COORDINATOR = "HOROVOD_TPU_COORDINATOR"  # jax.distributed addr

_TRUE = ("1", "true", "yes", "on")


def env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in _TRUE


def env_bool_opt(name: str):
    """Tri-state env bool: None when unset (lets the runtime pick a
    topology-dependent default)."""
    v = os.environ.get(name)
    if v is None:
        return None
    return v.strip().lower() in _TRUE


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    try:
        return int(v) if v not in (None, "") else default
    except ValueError:
        return default


def env_int_opt(name: str):
    """Optional int knob: None when unset/empty/unparseable."""
    v = os.environ.get(name)
    try:
        return int(v) if v not in (None, "") else None
    except ValueError:
        return None


def env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    try:
        return float(v) if v not in (None, "") else default
    except ValueError:
        return default


def env_str(name: str, default: str = "") -> str:
    v = os.environ.get(name)
    return v if v is not None else default


def env_str_opt(name: str) -> Optional[str]:
    """Optional string knob: None when unset (callers branch on
    presence — the tri-state analog of env_bool_opt)."""
    return os.environ.get(name)


def env_require(name: str) -> str:
    """A contract variable the launcher MUST have provided; a missing
    one raises KeyError(name) — the same failure mode as the direct
    ``os.environ[name]`` reads this accessor replaces."""
    return os.environ[name]


def env_set(name: str) -> bool:
    """Presence test (``name in os.environ``), without exposing the
    mapping to call sites."""
    return name in os.environ


@dataclasses.dataclass
class RankInfo:
    """The launcher → worker rank contract, or single-process defaults."""
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1
    cross_rank: int = 0
    cross_size: int = 1

    @classmethod
    def from_env(cls) -> "RankInfo":
        return cls(
            rank=env_int(HOROVOD_RANK, 0),
            size=env_int(HOROVOD_SIZE, 1),
            local_rank=env_int(HOROVOD_LOCAL_RANK, 0),
            local_size=env_int(HOROVOD_LOCAL_SIZE, 1),
            cross_rank=env_int(HOROVOD_CROSS_RANK, 0),
            cross_size=env_int(HOROVOD_CROSS_SIZE, 1),
        )

    @property
    def launched(self) -> bool:
        """True when a launcher provided the contract (vs. bare script)."""
        return HOROVOD_RANK in os.environ


@dataclasses.dataclass
class Knobs:
    """Runtime tunables, parsed once at init.

    Defaults mirror the reference core's (operations.cc:441-534): 64 MB
    fusion threshold, 1 ms cycle time, 1024-entry response cache.  The
    autotuner may override fusion_threshold_bytes / cycle_time_ms at
    runtime (parameter manager).
    """
    fusion_threshold_bytes: int = 64 * 1024 * 1024
    cycle_time_ms: float = 1.0
    cache_capacity: int = 1024
    # None = auto: hierarchical allreduce defaults ON when each
    # process drives several chips (the all-local-chips layout; a flat
    # world-mesh eager op would idle all but one chip per host), OFF
    # for one-chip-per-process rigs. Explicit env/autotune settings
    # override (reference gates it behind HOROVOD_HIERARCHICAL_ALLREDUCE
    # unconditionally, operations.cc:441-534).
    hierarchical_allreduce: Optional[bool] = None
    hierarchical_allgather: bool = False
    autotune: bool = False
    replay_enabled: bool = True
    replay_warmup_cycles: int = 3
    # --- autotune-then-freeze (horovod_tpu/tune, docs/autotune.md) ---
    # tune_profile_loaded is derived, not an env knob: True when a
    # valid profile at tune_profile was applied onto these knobs, so
    # the runtime knows tuning is already frozen (replay engages
    # immediately; the coordinator runs no search).
    tune: bool = False
    tune_profile: Optional[str] = None
    tune_profile_loaded: bool = False
    # The parsed TunedProfile object when tune_profile_loaded: the
    # single read of the artifact (knob adoption AND the controller's
    # pre-frozen session both use it — re-reading the file later could
    # race a concurrent freeze replacing it).
    tune_profile_obj: Optional[object] = None
    tune_strategy: str = "gp"
    tune_cycles_per_sample: int = 8
    tune_max_samples: int = 24
    tune_warmup_windows: int = 2
    request_coalescing: bool = True
    autotune_log: Optional[str] = None
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 10
    autotune_bayes_opt_max_samples: int = 20
    autotune_gaussian_process_noise: float = 0.8
    timeline: Optional[str] = None
    timeline_mark_cycles: bool = False
    metrics_port: Optional[int] = None
    metrics_agg_interval_s: float = 0.0
    stall_check_disable: bool = False
    stall_warning_time_s: float = 60.0
    stall_shutdown_time_s: float = 0.0
    elastic: bool = False
    tpu_operations: str = "XLA"
    # Self-healing control plane (docs/failure_recovery.md).
    # liveness_timeout_s / reconnect_grace_s may be given as 0 =
    # "derive the default"; __post_init__ resolves them ONCE for every
    # construction path (env, tests, chaos harness), so consumers read
    # final values.
    start_timeout_s: float = START_TIMEOUT_DEFAULT
    liveness_interval_s: float = 0.0   # 0 = liveness disabled
    liveness_timeout_s: float = 0.0    # 0 -> 2x interval
    reconnect_grace_s: float = 0.0     # 0 -> liveness timeout
    registration_timeout_s: float = 30.0
    coord_fanout: int = 0              # 0 = flat star (no relay tree)

    def __post_init__(self):
        if not self.liveness_timeout_s:
            self.liveness_timeout_s = 2.0 * self.liveness_interval_s
        if not self.reconnect_grace_s:
            self.reconnect_grace_s = self.liveness_timeout_s

    def apply_tuned_profile(self, profile) -> None:
        """Adopt a frozen tuned profile (horovod_tpu/tune) onto these
        knobs: the dense-class fusion threshold plus the worker knobs.
        Explicit env values are the profile's own starting point (the
        search anchored there), so profile-wins is the right order.
        Per-class thresholds for the coordinator come from the profile
        directly (controller_net builds a frozen session from it)."""
        dense = profile.fusion_bytes_for("dense")
        if dense:
            self.fusion_threshold_bytes = dense
        w = profile.worker or {}
        if "cycle_time_ms" in w:
            self.cycle_time_ms = float(w["cycle_time_ms"])
        if "coalesce" in w:
            self.request_coalescing = bool(w["coalesce"])
        if "replay_warmup" in w:
            self.replay_warmup_cycles = int(w["replay_warmup"])
        self.tune_profile_loaded = True

    @classmethod
    def from_env(cls) -> "Knobs":
        liveness_interval = env_float(HOROVOD_LIVENESS_INTERVAL, 0.0)
        liveness_timeout = env_float(HOROVOD_LIVENESS_TIMEOUT, 0.0)
        reconnect_grace = env_float(HOROVOD_RECONNECT_GRACE, 0.0)
        knobs = cls(
            fusion_threshold_bytes=env_int(
                HOROVOD_FUSION_THRESHOLD, 64 * 1024 * 1024),
            cycle_time_ms=env_float(HOROVOD_CYCLE_TIME, 1.0),
            cache_capacity=env_int(HOROVOD_CACHE_CAPACITY, 1024),
            hierarchical_allreduce=env_bool_opt(HOROVOD_HIERARCHICAL_ALLREDUCE),
            hierarchical_allgather=env_bool(HOROVOD_HIERARCHICAL_ALLGATHER),
            autotune=env_bool(HOROVOD_AUTOTUNE),
            replay_enabled=env_bool(HOROVOD_STEADY_STATE_REPLAY, True),
            replay_warmup_cycles=env_int(HOROVOD_REPLAY_WARMUP_CYCLES,
                                         3),
            tune=env_bool(HOROVOD_TUNE),
            tune_profile=os.environ.get(HOROVOD_TUNE_PROFILE),
            tune_strategy=os.environ.get(
                HOROVOD_TUNE_STRATEGY, "gp").strip().lower(),
            tune_cycles_per_sample=env_int(
                HOROVOD_TUNE_CYCLES_PER_SAMPLE, 8),
            tune_max_samples=env_int(HOROVOD_TUNE_MAX_SAMPLES, 24),
            tune_warmup_windows=env_int(
                HOROVOD_TUNE_WARMUP_WINDOWS, 2),
            request_coalescing=env_bool(
                HOROVOD_REQUEST_COALESCING, True),
            autotune_log=os.environ.get(HOROVOD_AUTOTUNE_LOG),
            autotune_warmup_samples=env_int(HOROVOD_AUTOTUNE_WARMUP_SAMPLES, 3),
            autotune_steps_per_sample=env_int(
                HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE, 10),
            autotune_bayes_opt_max_samples=env_int(
                HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES, 20),
            autotune_gaussian_process_noise=env_float(
                HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE, 0.8),
            timeline=os.environ.get(HOROVOD_TIMELINE),
            timeline_mark_cycles=env_bool(HOROVOD_TIMELINE_MARK_CYCLES),
            metrics_port=env_int_opt(HOROVOD_METRICS_PORT),
            metrics_agg_interval_s=env_float(
                HOROVOD_METRICS_AGG_SECONDS, 0.0),
            stall_check_disable=env_bool(HOROVOD_STALL_CHECK_DISABLE),
            stall_warning_time_s=env_float(
                HOROVOD_STALL_CHECK_TIME_SECONDS, 60.0),
            stall_shutdown_time_s=env_float(
                HOROVOD_STALL_SHUTDOWN_TIME_SECONDS, 0.0),
            elastic=env_bool(HOROVOD_ELASTIC),
            tpu_operations=os.environ.get(HOROVOD_TPU_OPERATIONS, "XLA"),
            start_timeout_s=start_timeout(),
            liveness_interval_s=liveness_interval,
            liveness_timeout_s=liveness_timeout,
            reconnect_grace_s=reconnect_grace,
            registration_timeout_s=env_float(
                HOROVOD_REGISTRATION_TIMEOUT, 30.0),
            coord_fanout=max(0, env_int(HOROVOD_COORD_FANOUT, 0)),
        )
        if knobs.tune_profile:
            # A valid frozen profile at the path means the search is
            # already done: adopt its knobs and skip straight to
            # replay.  A missing/corrupt file means "tune and write it
            # here" (try_load_profile is deliberately forgiving).
            from ..tune.profile import try_load_profile
            prof = try_load_profile(knobs.tune_profile)
            if prof is not None:
                knobs.apply_tuned_profile(prof)
                knobs.tune_profile_obj = prof
        return knobs
