"""Failpoints: process-wide deterministic fault injection.

An etcd/TiKV-style failpoint registry: production code declares named
injection *sites* at the places that can fail for real (ring transport
dispatch, coordinator frame I/O, the runtime cycle, rendezvous KV
requests, elastic worker lifecycle, the liveness/reconnect plane:
``net.heartbeat_drop``/``net.conn_drop``/``net.half_open``/
``worker.wedge``); an operator or test configures
*rules* against those sites through ``HOROVOD_FAILPOINTS``::

    HOROVOD_FAILPOINTS='ring.send=delay(50ms,p=0.1);coord.frame_recv=drop(1);
                        elastic.worker=crash(rank=3,epoch=2)'

Grammar (``;``-separated rules, several rules may target one site)::

    rule    := site "=" action "(" args? ")"
    action  := delay | drop | error | crash | partition
    args    := arg ("," arg)*          # positional first, then k=v

Actions (positional argument in brackets):

* ``delay([duration])`` — sleep for the duration (default 50ms) at the
  site, then continue.
* ``drop([times])`` — ask the site to discard the unit of work (a
  frame, an HTTP request).  A bare count is shorthand for ``times=N``.
* ``error([message])`` — raise :class:`FailpointError` at the site.
* ``crash()`` — invoke the process crash handler (default
  ``os._exit(43)``; tests and the chaos harness override it with
  :func:`set_crash_handler`).  Sites that model *another* process's
  death (the elastic driver spawning workers) pass ``crash_ok=True``
  and interpret the returned ``"crash"`` themselves.
* ``partition([duration])`` — once triggered, EVERY evaluation of the
  site returns ``"drop"`` until the window (default 1s) elapses: a
  network partition rather than a single lost frame.

Shared predicates (all optional, all AND-ed):

* ``p=0.1`` — trigger with that probability, drawn from the rule's own
  seeded PRNG (see below);
* ``times=N`` — trigger at most N times, then go inert;
* ``after=N`` — skip the first N otherwise-matching evaluations;
* ``rank=R`` — only on that rank (the caller's ``rank=`` context wins,
  else the rank installed by ``hvd.init``, else ``HOROVOD_RANK``);
* ``epoch=E`` — only in that elastic epoch (caller context, else the
  worker's rendezvoused epoch).

Determinism: every rule owns a ``random.Random`` seeded from
``(HOROVOD_FAILPOINTS_SEED, site, action, rule index)``, so a schedule
replays identically for a fixed seed regardless of which other sites
fire — the property the chaos soak harness builds its reproducible
fault schedules on.

Zero overhead when disabled: sites are written as

    if failpoints.ENABLED and failpoints.maybe_fail("site") == "drop":

so with ``HOROVOD_FAILPOINTS`` unset every site costs exactly one
module-attribute check (asserted by tests/test_failpoints.py).

Observability: triggers are counted per (site, action) into the PR-1
metrics registry (``hvd_failpoint_triggers_total``) and locally per
rule; :func:`snapshot` returns the per-site evaluation/trigger counts
the chaos soak embeds in its JSON artifact.
"""

import logging
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from . import env as _env
from . import flight_recorder as _fr
from . import metrics

logger = logging.getLogger("horovod_tpu_torch.failpoints")

ENV_SPEC = "HOROVOD_FAILPOINTS"
ENV_SEED = "HOROVOD_FAILPOINTS_SEED"

ACTIONS = ("delay", "drop", "error", "crash", "partition")

# THE disabled-path gate: every site checks this one module attribute
# before anything else.  configure()/reset() are the only writers.
ENABLED = False

# Bumped on every configure()/reset(): consumers that derive cached
# state from the rule set (steady-state replay's replay-safe-site
# check) re-derive when it changes instead of taking the registry lock
# on every hot-path evaluation.
CONFIG_GEN = 0

_TRIGGERS = metrics.counter(
    "hvd_failpoint_triggers_total",
    "Failpoint rules fired, by site and action")

_lock = threading.Lock()
_rules: Dict[str, List["_Rule"]] = {}
_seed: int = 0
_rank: Optional[int] = None          # installed by hvd.init / tests
_epoch_provider: Optional[Callable[[], int]] = None


class FailpointError(RuntimeError):
    """Raised at a site by an ``error(...)`` rule."""


def _default_crash(site: str):
    logger.error("failpoint %s: injected crash (os._exit)", site)
    os._exit(43)


_crash_handler: Callable[[str], None] = _default_crash


def set_crash_handler(fn: Optional[Callable[[str], None]]):
    """Override what ``crash()`` does (None restores ``os._exit``).
    The chaos harness and the unit tests install raising handlers so a
    crash can be simulated inside one process."""
    global _crash_handler
    _crash_handler = fn if fn is not None else _default_crash


def set_rank(rank: Optional[int]):
    """Install the current rank for ``rank=`` predicates (wired from
    ``hvd.init``; call-site ``rank=`` context still wins)."""
    global _rank
    _rank = rank


def _current_rank() -> Optional[int]:
    if _rank is not None:
        return _rank
    return _env.env_int_opt(_env.HOROVOD_RANK)


def _current_epoch() -> int:
    if _epoch_provider is not None:
        try:
            return int(_epoch_provider())
        except Exception:
            return 0
    try:
        from ..runner.elastic.worker import current_epoch
        return current_epoch()
    except Exception:
        return 0


def set_epoch_provider(fn: Optional[Callable[[], int]]):
    global _epoch_provider
    _epoch_provider = fn


def _parse_duration(text: str) -> float:
    """``50ms`` / ``2s`` / ``100us`` / bare seconds float."""
    t = text.strip().lower()
    for suffix, mult in (("us", 1e-6), ("ms", 1e-3), ("s", 1.0)):
        if t.endswith(suffix):
            return float(t[:-len(suffix)]) * mult
    return float(t)


# Per-action meaning of the single allowed positional argument.
_POSITIONAL = {
    "delay": ("duration", _parse_duration),
    "partition": ("duration", _parse_duration),
    "drop": ("times", int),
    "error": ("message", str),
    "crash": ("times", int),
}

_PREDICATE_KEYS = {
    "p": float, "times": int, "after": int, "rank": int, "epoch": int,
    "duration": _parse_duration, "message": str,
}


class _Rule:
    __slots__ = ("site", "action", "p", "times", "after", "rank",
                 "epoch", "duration", "message", "_rng", "_evals",
                 "_triggers", "_partition_until")

    def __init__(self, site: str, action: str, args: Dict[str, object],
                 seed: int, index: int):
        self.site = site
        self.action = action
        self.p = float(args.get("p", 1.0))
        self.times = args.get("times")
        self.after = int(args.get("after", 0))
        self.rank = args.get("rank")
        self.epoch = args.get("epoch")
        self.duration = args.get(
            "duration", 0.05 if action == "delay" else 1.0)
        self.message = args.get("message") or \
            "failpoint %s: injected error" % site
        # Independent per-rule stream: which OTHER rules fire (and how
        # often this site is hit) never perturbs this rule's draws
        # beyond the draw count at the site itself.
        self._rng = random.Random("%d|%s|%s|%d"
                                  % (seed, site, action, index))
        self._evals = 0
        self._triggers = 0
        self._partition_until = 0.0

    def evaluate(self, rank: Optional[int], epoch: Optional[int]):
        """One evaluation under the registry lock; returns
        ``(outcome, fresh)`` when this rule fires (behavior is applied
        by the caller, outside the lock) — ``fresh`` is False for
        units swallowed by an already-open partition window — or None.
        """
        if self.rank is not None:
            r = rank if rank is not None else _current_rank()
            if r != self.rank:
                return None
        if self.epoch is not None:
            e = epoch if epoch is not None else _current_epoch()
            if e != self.epoch:
                return None
        if self.action == "partition" and \
                time.monotonic() < self._partition_until:
            # Open window swallows everything; NOT a fresh trigger —
            # metrics/logging count rule firings, not swallowed units.
            return ("drop", False)
        self._evals += 1
        if self._evals <= self.after:
            return None
        if self.times is not None and self._triggers >= int(self.times):
            return None
        if self.p < 1.0 and self._rng.random() >= self.p:
            return None
        self._triggers += 1
        if self.action == "partition":
            self._partition_until = time.monotonic() + self.duration
            return ("drop", True)
        return (self.action, True)


def _parse_rule(text: str, seed: int, index: int) -> _Rule:
    site, sep, rest = text.partition("=")
    site, rest = site.strip(), rest.strip()
    if not sep or not site:
        raise ValueError("failpoint rule %r: expected site=action(...)"
                         % text)
    name, paren, argtext = rest.partition("(")
    name = name.strip()
    if name not in ACTIONS:
        raise ValueError("failpoint rule %r: unknown action %r "
                         "(expected one of %s)"
                         % (text, name, "/".join(ACTIONS)))
    if paren:
        argtext = argtext.rstrip()
        if not argtext.endswith(")"):
            raise ValueError("failpoint rule %r: unbalanced parens"
                             % text)
        argtext = argtext[:-1]
    args: Dict[str, object] = {}
    for part in argtext.split(","):
        part = part.strip()
        if not part:
            continue
        key, eq, value = part.partition("=")
        if eq:
            key, value = key.strip(), value.strip()
            if key not in _PREDICATE_KEYS:
                raise ValueError(
                    "failpoint rule %r: unknown argument %r" % (text, key))
            args[key] = _PREDICATE_KEYS[key](value)
        else:
            pos_key, conv = _POSITIONAL[name]
            if pos_key in args:
                raise ValueError("failpoint rule %r: duplicate "
                                 "positional argument" % text)
            args[pos_key] = conv(part)
    return _Rule(site, name, args, seed, index)


def configure(spec: str, seed: Optional[int] = None) -> int:
    """(Re)build the registry from a spec string.  Returns the number
    of rules installed; an empty spec disables the subsystem.  Raises
    ValueError on malformed rules (a typo'd schedule silently injecting
    nothing would defeat the whole point)."""
    global ENABLED, _seed, _rules
    if seed is None:
        seed = _env.env_int(ENV_SEED, 0)
    rules: Dict[str, List[_Rule]] = {}
    count = 0
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        rule = _parse_rule(part, seed, count)
        rules.setdefault(rule.site, []).append(rule)
        count += 1
    global CONFIG_GEN
    with _lock:
        _seed = seed
        _rules = rules
        ENABLED = bool(rules)
        CONFIG_GEN += 1
    if rules:
        logger.info("failpoints enabled (seed=%d): %s", seed,
                    "; ".join("%s=%s" % (r.site, r.action)
                              for rs in rules.values() for r in rs))
    return count


def reset():
    """Disable the subsystem and drop all rules/counters."""
    global ENABLED, _rules, CONFIG_GEN
    with _lock:
        _rules = {}
        ENABLED = False
        CONFIG_GEN += 1


def maybe_fail(site: str, rank: Optional[int] = None,
               epoch: Optional[int] = None,
               crash_ok: bool = False) -> Optional[str]:
    """Evaluate the rules for ``site``; the first firing rule wins.

    Side effects by action: ``delay`` sleeps here; ``error`` raises
    :class:`FailpointError`; ``crash`` invokes the crash handler
    (unless ``crash_ok``, where the caller models the death itself).
    Returns the fired action name (``partition`` surfaces as
    ``"drop"``) or None.  Callers ignore outcomes that make no sense
    for their site — only ``"drop"`` requires cooperation.
    """
    with _lock:
        rules = _rules.get(site)
        if not rules:
            return None
        fired = None
        for rule in rules:
            result = rule.evaluate(rank, epoch)
            if result is not None:
                fired = (rule,) + result
                break
    if fired is None:
        return None
    rule, outcome, fresh = fired
    if fresh:
        _TRIGGERS.inc(1, site=site, action=rule.action)
        if _fr.ENABLED:
            # The chaos schedule in causal position: a postmortem can
            # show the injected fault BETWEEN the frames it perturbed.
            _fr.record(_fr.FAILPOINT, rank=rank, site=site,
                       action=rule.action)
        logger.debug("failpoint %s: %s fired (trigger #%d)", site,
                     rule.action, rule._triggers)
    if outcome == "delay":
        time.sleep(rule.duration)
    elif outcome == "error":
        raise FailpointError(rule.message)
    elif outcome == "crash" and not crash_ok:
        _crash_handler(site)
    return outcome


def sites() -> List[str]:
    with _lock:
        return sorted(_rules)


def snapshot() -> dict:
    """Per-site rule state: evaluations and triggers, for artifacts."""
    with _lock:
        return {
            site: [{"action": r.action, "evals": r._evals,
                    "triggers": r._triggers,
                    "p": r.p, "times": r.times, "after": r.after,
                    "rank": r.rank, "epoch": r.epoch}
                   for r in rules]
            for site, rules in _rules.items()
        }


# Arm from the environment at import: the spec rides the launcher env
# contract to every worker, so a single HOROVOD_FAILPOINTS on the
# driver arms the whole job.
_env_spec = _env.env_str_opt(ENV_SPEC)
if _env_spec:
    configure(_env_spec)
