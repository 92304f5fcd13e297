"""Chaos soak: the real negotiation protocol at 8-16 ranks under
seeded fault schedules, with the data plane on the card.

Counterpart of the JAX package's chaos soak tool, with the same
flags, schedules, drills, ``CHAOSJSON`` line, artifact keys and exit
codes.  What runs is REAL: one rank-0 :class:`CoordinatorServer` plus a
full :class:`NetworkController` + :class:`BackgroundRuntime` per rank —
the TCP frame protocol, the response-cache fast path (CH/CB), the inline
submit path, fusion, stall attribution, and the elastic
broken-membership machinery all execute exactly as in a real job.  Only
two things are simulated, where multiprocessing would be too heavy to
soak at 8-16 ranks in seconds:

* the *processes* — each rank is a thread with its own state/runtime
  (their metrics merge into the one process registry; the artifact
  records the merged view);
* the *data plane* — :class:`SimBackend` routes each fused batch
  through an in-process exchanger keyed by the LOGICAL identity of
  every member tensor (name + op index), so a rank that falls out of
  lockstep produces a detected timeout, never a silently mismatched
  reduction.  The tensors live on ``device`` (default: the card); each
  rank's runtime runs its responses on a CUDA stream of its own, with
  the ready/done events of the port's runtime.

Fault schedules are generated from a master seed and injected through
``horovod_tpu_torch.common.failpoints`` (sites: runtime.submit/cycle,
worker.frame_send/frame_recv, coord.frame_recv/broadcast), so every
run is replayable from its artifact.  Per schedule the harness asserts

* zero hangs — every collective either completes or FAILS within the
  hang budget (stall shutdown + broken-membership paths must fire);
* bit-correct results — a collective that reports success must carry
  exactly the expected reduction, on its input's device and in its
  input's dtype;
* bounded recovery — after a failure, a rebuilt world completes a
  verification collective within the recovery budget,

and emits a JSON artifact (per-schedule outcome + failpoint trigger
counts, recovery-latency histogram, metrics snapshot) so robustness
gets a measured trajectory the way perf does.  The metrics snapshot
counts every collective result by device and placement
(``hvd_chaos_results_total``).

Usage::

    python -m horovod_tpu_torch.tools.chaos_soak --ranks 8 --schedules 5 \
        --seed 0 --out chaos_soak.json [--device cpu]

With ``--device cuda`` (the default) and no card the tool exits with an
error; it never carries on on the host.
"""

import argparse
import json
import logging
import os
import random
import shutil
import socket
import sys
import threading
import time

import numpy as np
import torch

from horovod_tpu_torch.common import failpoints, metrics
from horovod_tpu_torch.common import flight_recorder
from horovod_tpu_torch.common import env as env_mod
from horovod_tpu_torch.common.env import Knobs
from horovod_tpu_torch.common.message import (Request, RequestType,
                                              dtype_of)
from horovod_tpu_torch.common.tensor_queue import TensorTableEntry

logger = logging.getLogger("horovod_tpu_torch.chaos")

# Every result a world's collective hands back, by the device it sits on
# and whether device and dtype are its input's ("placed").
_RESULTS = metrics.REGISTRY.counter(
    "hvd_chaos_results_total",
    "chaos harness collective results by device and placement")


class HangError(RuntimeError):
    """An operation outlived the hang budget — the one outcome the
    robustness machinery exists to prevent."""


class SimCrash(RuntimeError):
    """Raised by the harness crash handler on the victim rank's own
    submitting thread; the harness then severs that rank's control
    socket, which is what a real process death looks like to the
    coordinator."""


class SimTransportError(RuntimeError):
    pass


def resolve_device(device="cuda") -> torch.device:
    """The torch device a drill runs its tensors on.  ``cuda`` means the
    current card and raises without one: the harness never falls back to
    the host on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "chaos_soak: no CUDA device is available "
                "(device='cpu' runs the drills on the host)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def tagged(value: torch.Tensor, tag) -> torch.Tensor:
    """A new tensor object over ``value``'s data carrying the logical
    identity (name, op index) of the tensor as ``.tag``, so the
    exchanger can pair contributions by MEANING instead of arrival
    order.  The runtime hands this very object to the backend."""
    out = value.detach().contiguous()
    out.tag = tag
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of a tensor (closed forms and checkpoints are
    numpy)."""
    return t.detach().cpu().numpy().copy()


def _settled(tensors):
    """Wait for the current stream's work on ``tensors``: results cross
    rank threads, and each rank's runtime reads them on a stream of its
    own."""
    for t in tensors:
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
            break
    return tensors


def _sum_in_order(tensors):
    """Sum in list order, as numpy's sum over a stacked axis 0 does."""
    acc = tensors[0].clone()
    for t in tensors[1:]:
        acc += t
    return acc


class SimExchanger:
    """In-process eager data plane: rank r's fused batch joins its
    peers' batch with the same logical key; the reduction runs once
    (float64, in arrival order, on the tensors' device).  A slot that
    never fills (a rank missed its response frame, or died) times out
    for every waiter — faults become detected errors, never wrong
    numbers."""

    def __init__(self, size: int, timeout_s: float):
        self.size = size
        self.timeout_s = timeout_s
        self._cond = threading.Condition()
        self._slots = {}

    def exchange(self, key, rank, payload, combine):
        deadline = time.monotonic() + self.timeout_s
        with self._cond:
            slot = self._slots.get(key)
            if slot is None:
                slot = {"vals": {}, "result": None, "error": None,
                        "taken": 0}
                self._slots[key] = slot
            slot["vals"][rank] = payload
            if len(slot["vals"]) == self.size:
                try:
                    slot["result"] = combine(slot["vals"])
                except Exception as e:  # surface as a transport error
                    slot["error"] = "combine failed: %r" % e
                self._cond.notify_all()
            while slot["result"] is None and slot["error"] is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    missing = sorted(set(range(self.size)) -
                                     set(slot["vals"]))
                    slot["error"] = ("exchange %r timed out waiting "
                                     "for ranks %s" % (key, missing))
                    self._cond.notify_all()
                    break
                self._cond.wait(remaining)
            err, result = slot["error"], slot["result"]
            slot["taken"] += 1
            if slot["taken"] >= self.size:
                self._slots.pop(key, None)
        if err is not None:
            raise SimTransportError(err)
        return result


class SimBackend:
    """Data-plane stand-in speaking the Backend collective interface
    the runtime dispatches fused responses into.  It computes what the
    JAX package's numpy stand-in computes — float64 sums in arrival
    order, results in the input's dtype — on the tensors' own device.
    Every payload and result is settled before it crosses to another
    rank's thread."""

    name = "sim"

    def __init__(self, rank: int, size: int, exchanger: SimExchanger):
        self.rank = rank
        self.size = size
        self.exchanger = exchanger
        self.stats = {}

    @staticmethod
    def _key(kind, tensors):
        return (kind, tuple(getattr(t, "tag", None) for t in tensors))

    def allreduce(self, tensors, reduce_op, prescale, postscale,
                  ps_ranks=()):
        assert not ps_ranks, "soak drives world collectives only"
        payload = _settled([t.to(torch.float64) * prescale
                            for t in tensors])

        def combine(vals):
            return _settled([_sum_in_order([vals[r][i] for r in vals])
                             for i in range(len(payload))])

        res = self.exchanger.exchange(self._key("AR", tensors),
                                      self.rank, payload, combine)
        post = postscale / (self.size if reduce_op == "Average" else 1.0)
        return _settled([(x * post).to(t.dtype)
                         for t, x in zip(tensors, res)])

    def broadcast(self, tensors, root_rank, ps_ranks=()):
        assert not ps_ranks

        def combine(vals):
            return _settled([x.clone() for x in vals[root_rank]])

        res = self.exchanger.exchange(self._key("BC", tensors),
                                      self.rank, _settled(list(tensors)),
                                      combine)
        return _settled([x.clone() for x in res])


class _RankInfoStub:
    def __init__(self, rank: int, size: int):
        self.rank = rank
        self.size = size
        self.local_rank = rank
        self.local_size = size
        self.cross_rank = 0
        self.cross_size = 1
        self.launched = True


class _StateStub:
    def __init__(self, rank: int, size: int, knobs: Knobs):
        self.rank_info = _RankInfoStub(rank, size)
        self.knobs = knobs
        self.timeline = None
        self.backend = None
        self.init_generation = 0
        self.parameter_manager = None


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def soak_knobs(stall_shutdown_s: float,
               liveness_interval_s: float = 0.0,
               liveness_timeout_s: float = 0.0,
               reconnect_grace_s: float = 0.0,
               coord_fanout: int = 0,
               tune: bool = False,
               metrics_agg_s: float = 0.0,
               replay: bool = True) -> Knobs:
    """Robustness machinery tightened to soak time scales: a dropped
    frame must surface through stall shutdown in seconds, not the
    production 60s.  MTTR/liveness drills additionally arm HB
    heartbeats + the reconnect grace window at sub-second cadence;
    relay drills arm the fan-out tree; the tune drill arms the
    autotune-then-freeze session at drill-scale window sizes with the
    deterministic grid strategy."""
    return Knobs(
        cache_capacity=1024,
        cycle_time_ms=1.0,
        elastic=True,
        stall_warning_time_s=max(stall_shutdown_s / 4.0, 0.25),
        stall_shutdown_time_s=stall_shutdown_s,
        hierarchical_allreduce=False,
        liveness_interval_s=liveness_interval_s,
        liveness_timeout_s=liveness_timeout_s,
        reconnect_grace_s=reconnect_grace_s,
        coord_fanout=coord_fanout,
        tune=tune,
        metrics_agg_interval_s=metrics_agg_s,
        replay_enabled=replay,
        tune_strategy="grid",
        tune_cycles_per_sample=2,
        tune_warmup_windows=1,
        tune_max_samples=30,
    )


class ChaosWorld:
    """One incarnation: N in-process ranks over the real control plane
    (rank 0 hosting the coordinator) and the simulated data plane, whose
    tensors live on ``device``."""

    def __init__(self, size: int, stall_shutdown_s: float = 4.0,
                 exchange_timeout_s: float = 8.0,
                 liveness_interval_s: float = 0.0,
                 reconnect_grace_s: float = 0.0,
                 fanout: int = 0,
                 tune: bool = False,
                 metrics_agg_s: float = 0.0,
                 replay: bool = True,
                 device="cuda"):
        from horovod_tpu_torch.common import relay as relay_mod
        from horovod_tpu_torch.common.runtime import BackgroundRuntime

        self.size = size
        self.device = resolve_device(device)
        self.exchanger = SimExchanger(size, exchange_timeout_s)
        self._saved_env = {}
        port = _free_port()
        self._set_env("HOROVOD_CONTROLLER_ADDR", "127.0.0.1:%d" % port)
        self._set_env("HOROVOD_START_TIMEOUT", "30")
        self._set_env("HOROVOD_GLOO_RENDEZVOUS_ADDR", None)
        self._set_env("HOROVOD_GLOO_RENDEZVOUS_PORT", None)
        # Relay tree: the harness owns the relays (standalone objects
        # it can kill/wedge independently of any worker rank — a real
        # deployment's per-host relay process); the shared env addr
        # map is how every thread-rank finds its assigned parent.
        self.plan = relay_mod.plan_tree(size, fanout) if fanout else None
        self.relays = {}
        relay_ports = {}
        if self.plan is not None:
            relay_ports = {rid: _free_port() for rid in self.plan.relays}
            self._set_env("HOROVOD_RELAY_ADDRS", json.dumps(
                {str(rid): "127.0.0.1:%d" % p
                 for rid, p in relay_ports.items()}))
        else:
            self._set_env("HOROVOD_RELAY_ADDRS", None)
            fanout = 0
        knobs = soak_knobs(stall_shutdown_s,
                           liveness_interval_s=liveness_interval_s,
                           reconnect_grace_s=reconnect_grace_s,
                           coord_fanout=fanout,
                           tune=tune,
                           metrics_agg_s=metrics_agg_s,
                           replay=replay)
        self.runtimes = []
        try:
            # rank 0 first: it hosts the coordinator ...
            st = _StateStub(0, size, knobs)
            st.backend = SimBackend(0, size, self.exchanger)
            rt = BackgroundRuntime(st)
            rt.start()
            self.runtimes.append(rt)
            # ... then the relays (top level first, parents before
            # children), then the remaining leaf ranks.
            if self.plan is not None:
                root_addr = "127.0.0.1:%d" % port
                for rid in sorted(
                        self.plan.relays,
                        key=lambda r: -self.plan.relays[r].level):
                    info = self.plan.relays[rid]
                    chain = ["127.0.0.1:%d" % relay_ports[a]
                             for a in self.plan.relay_ancestors(rid)]
                    chain.append(root_addr)
                    self.relays[rid] = relay_mod.RelayServer(
                        rid, chain, port=relay_ports[rid],
                        liveness_interval_s=liveness_interval_s,
                        liveness_timeout_s=knobs.liveness_timeout_s,
                        registration_timeout_s=(
                            knobs.registration_timeout_s),
                        depth_below=info.depth_below)
            for rank in range(1, size):
                st = _StateStub(rank, size, knobs)
                st.backend = SimBackend(rank, size, self.exchanger)
                rt = BackgroundRuntime(st)
                rt.start()
                self.runtimes.append(rt)
        except Exception:
            self.close()
            raise

    def _set_env(self, key, value):
        # hvdlint: env-ok(saves whatever value the drill overrides, to
        # restore it on close: a passthrough of any key, not a knob parse)
        self._saved_env.setdefault(key, os.environ.get(key))
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value

    def kill_rank(self, rank: int):
        """Model a process death: stop the runtime, sever its control
        socket so the coordinator's rank-lost path fires, and end the
        collectives the rank still had queued — a dead process leaves no
        thread waiting on them (without this a rank killed between its
        submit and its response held its caller until the hang
        budget)."""
        rt = self.runtimes[rank]
        rt._shutdown.set()
        rt._wake.set()
        ctrl = rt.controller
        ctrl._closing = True
        try:
            # shutdown() actually sends the FIN even while the rank's
            # recv thread is blocked inside the syscall (a bare close
            # keeps the kernel file reference alive until that thread
            # wakes — which, with no recv timeout, is never); a real
            # process death closes everything at kernel exit.
            ctrl._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            ctrl._sock.close()
        except OSError:
            pass
        rt.tensor_queue.shutdown_flush(
            SimCrash("rank %d was killed" % rank))

    def wedge_rank(self, rank: int):
        """SIGSTOP analog: the rank's control plane freezes (no
        heartbeats, no downlink processing) but every socket stays
        open — only coordinator liveness can detect it."""
        self.runtimes[rank].controller.debug_wedge(True)

    def sever_rank(self, rank: int):
        """Transient TCP drop: abruptly close the rank's control
        socket while the rank itself stays healthy — the reconnecting
        channel must resume the session inside the grace window."""
        self.runtimes[rank].controller.debug_sever()

    # --- relay drill hooks (fanout worlds only) ----------------------
    def kill_relay(self, rid: int):
        """Relay process death: every one of its sockets dies at once;
        its children must re-home through their ancestor chain."""
        self.relays[rid].debug_kill()

    def wedge_relay(self, rid: int, on: bool = True):
        """SIGSTOP analog on a relay: forwarding freezes, sockets stay
        open — only the per-hop liveness deadlines can expose it."""
        self.relays[rid].debug_wedge(on)

    def sever_relay_uplink(self, rid: int):
        """Pull the relay's uplink cable: it fail-stops, severing its
        children (who re-home) — the cheapest interior network cut."""
        self.relays[rid].debug_sever_parent()

    def subtree_ranks(self, rid: int):
        info = self.plan.relays[rid]
        return list(range(info.leaf_lo, info.leaf_hi))

    def watch_fatal(self):
        """Register a fatal listener on every runtime; returns
        {rank: monotonic-time-of-first-fatal} (filled in as survivors
        learn the world broke — the drill's detection clock)."""
        times = {}
        lock = threading.Lock()
        for r, rt in enumerate(self.runtimes):
            def listener(err, _r=r):
                with lock:
                    times.setdefault(_r, time.monotonic())
            rt.add_fatal_listener(listener)
        return times

    def submit(self, rank: int, request: Request,
               entry: TensorTableEntry):
        self.runtimes[rank].submit(request, entry)

    def tensor(self, value) -> torch.Tensor:
        """``value`` (a numpy array or a tensor) on the world's device."""
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        return torch.from_numpy(np.array(value)).to(self.device)

    def correct(self, out, expected, rtol: float = 1e-05,
                atol: float = 1e-08) -> bool:
        """``np.allclose`` of a result against its closed form, for a
        result that sits on the world's device in the closed form's
        dtype; a result anywhere else is not a correct result."""
        expected = np.asarray(expected)
        return (isinstance(out, torch.Tensor)
                and out.device == self.device
                and out.dtype == torch.from_numpy(expected).dtype
                and bool(np.allclose(_host(out), expected, rtol=rtol,
                                     atol=atol)))

    def collective(self, rank: int, kind: str, name: str, value,
                   op_index: int, timeout_s: float,
                   root_rank: int = 0):
        """Submit one collective on ``rank`` with ``value`` on the
        world's device and wait (bounded) for its completion callback;
        returns the result tensor (None for a barrier)."""
        value = self.tensor(value)
        box = {}
        done = threading.Event()

        def cb(ok, result):
            box["ok"] = ok
            box["result"] = result
            done.set()

        rtype = {"allreduce": RequestType.ALLREDUCE,
                 "broadcast": RequestType.BROADCAST,
                 "barrier": RequestType.BARRIER}[kind]
        req = Request(request_rank=rank, request_type=rtype,
                      tensor_name=name,
                      tensor_shape=tuple(value.shape),
                      tensor_type=dtype_of(value),
                      reduce_op="Sum", root_rank=root_rank)
        entry = TensorTableEntry(
            tensor_name=name, tensor=tagged(value, (name, op_index)),
            callback=cb, root_rank=root_rank)
        self.submit(rank, req, entry)
        if not done.wait(timeout_s):
            raise HangError("%s %r on rank %d exceeded the %ss hang "
                            "budget" % (kind, name, rank, timeout_s))
        if not box["ok"]:
            err = box["result"]
            raise err if isinstance(err, Exception) else \
                RuntimeError(str(err))
        out = box["result"]
        if out is None:
            return None
        placed = out.device == value.device and out.dtype == value.dtype
        _RESULTS.inc(device=str(out.device),
                     placed="yes" if placed else "no")
        return out

    def close(self):
        # Non-leader ranks sever abruptly (their departure is what the
        # coordinator drain counts), leader shuts down last.
        for rank in range(1, len(self.runtimes)):
            try:
                self.kill_rank(rank)
            except Exception:
                pass
        if self.runtimes:
            rt0 = self.runtimes[0]
            rt0.stop_background()
            try:
                rt0.controller.shutdown()
            except Exception:
                pass
        self.runtimes = []
        for rs in self.relays.values():
            try:
                rs.shutdown()
            except Exception:
                pass
        self.relays = {}
        for key, value in self._saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        self._saved_env = {}


def result_placement(counts=None) -> dict:
    """The collective results counted so far in this process, or in
    ``counts`` (``hvd_chaos_results_total`` of a metrics snapshot), by
    device and placement (``{"cuda:0": {"yes": n}}``)."""
    out = {}
    if counts is None:
        counts = _RESULTS.snapshot()
    for key, n in (counts or {}).items():
        labels = dict(kv.split("=", 1) for kv in key.split(","))
        out.setdefault(labels["device"], {})[labels["placed"]] = int(n)
    return out


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

# Inert rule: arms the subsystem (pinning the Python coordinator, the
# one with injection sites) without ever firing — the control lane
# every soak starts from.
BASELINE_SPEC = "chaos.baseline=delay(0s,times=0)"


def generate_schedule(master_seed: int, index: int, ranks: int) -> dict:
    """Schedule ``index`` for a master seed: 1-3 bounded rules over the
    control-plane and runtime sites.  Every rule carries ``times=`` so
    injected faults are finite and recovery is always reachable."""
    if index == 0:
        return {"index": 0, "spec": BASELINE_SPEC,
                "seed": master_seed, "kind": "baseline"}
    rng = random.Random("%d|schedule|%d" % (master_seed, index))
    menu = [
        lambda: "runtime.cycle=delay(%dms,p=%.2f,times=%d)"
                % (rng.randint(2, 25), rng.uniform(0.05, 0.4),
                   rng.randint(2, 8)),
        lambda: "runtime.submit=delay(%dms,p=%.2f,times=%d)"
                % (rng.randint(2, 25), rng.uniform(0.1, 0.5),
                   rng.randint(2, 8)),
        lambda: "worker.frame_send=drop(1,after=%d,rank=%d)"
                % (rng.randint(2, 10), rng.randrange(ranks)),
        lambda: "worker.frame_recv=drop(1,after=%d,rank=%d)"
                % (rng.randint(2, 10), rng.randrange(ranks)),
        lambda: "coord.frame_recv=drop(1,after=%d)"
                % rng.randint(4, 20),
        lambda: "coord.broadcast=delay(%dms,p=%.2f,times=%d)"
                % (rng.randint(2, 15), rng.uniform(0.1, 0.4),
                   rng.randint(2, 6)),
        lambda: "runtime.submit=error(injected rank fault,"
                "after=%d,times=1,rank=%d)"
                % (rng.randint(2, 10), rng.randrange(ranks)),
        lambda: "runtime.submit=crash(after=%d,times=1,rank=%d)"
                % (rng.randint(2, 10), rng.randrange(1, ranks)),
    ]
    rules = [rng.choice(menu)() for _ in range(rng.randint(1, 3))]
    return {"index": index, "spec": ";".join(rules),
            "seed": master_seed + index, "kind": "fault"}


def _expected_allreduce(shape, op_index: int, ranks: int) -> np.ndarray:
    return np.full(shape,
                   sum(_rank_value(r, op_index) for r in range(ranks)),
                   np.float32)


def _rank_value(rank: int, op_index: int) -> float:
    return (rank + 1) * 0.5 + op_index


# (name, kind, shape) op templates; names repeat so the response-cache
# fast path engages from round two onward.
def _op_list(n_ops: int):
    names = ["soak.w%d" % i for i in range(5)]
    ops = []
    for i in range(n_ops):
        if i and i % 7 == 0:
            ops.append(("soak.bcast", "broadcast", (33,)))
        elif i and i % 11 == 0:
            ops.append(("soak.barrier", "barrier", ()))
        else:
            ops.append((names[i % len(names)], "allreduce", (257,)))
    return ops


def run_schedule(schedule: dict, ranks: int, n_ops: int,
                 hang_timeout_s: float = 30.0,
                 stall_shutdown_s: float = 4.0,
                 recovery_budget_s: float = 60.0,
                 device="cuda") -> dict:
    """Run one seeded fault schedule; returns its artifact record."""
    t_start = time.monotonic()
    device = resolve_device(device)
    failpoints.configure(schedule["spec"], seed=schedule["seed"])

    def crash_handler(site):
        raise SimCrash("injected crash at %s" % site)

    failpoints.set_crash_handler(crash_handler)
    ops = _op_list(n_ops)
    failures = []
    hangs = []
    incorrect = []
    ok_counts = [0] * ranks
    stop = threading.Event()
    record_lock = threading.Lock()
    world = ChaosWorld(ranks, stall_shutdown_s=stall_shutdown_s,
                       exchange_timeout_s=2 * stall_shutdown_s,
                       device=device)

    def rank_loop(rank: int):
        for i, (name, kind, shape) in enumerate(ops):
            if stop.is_set():
                return
            try:
                if kind == "allreduce":
                    value = np.full(shape, _rank_value(rank, i),
                                    np.float32)
                    out = world.collective(rank, kind, name, value, i,
                                           hang_timeout_s)
                    expected = _expected_allreduce(shape, i, ranks)
                    if not world.correct(out, expected, rtol=1e-5):
                        with record_lock:
                            incorrect.append(
                                {"rank": rank, "op": i, "name": name,
                                 "got": float(np.ravel(_host(out))[0]),
                                 "expected":
                                     float(np.ravel(expected)[0])})
                        stop.set()
                        return
                elif kind == "broadcast":
                    value = np.full(shape, _rank_value(rank, i),
                                    np.float32)
                    out = world.collective(rank, kind, name, value, i,
                                           hang_timeout_s, root_rank=0)
                    expected = np.full(shape, _rank_value(0, i),
                                       np.float32)
                    if not world.correct(out, expected):
                        with record_lock:
                            incorrect.append(
                                {"rank": rank, "op": i, "name": name})
                        stop.set()
                        return
                else:
                    world.collective(rank, "barrier", name,
                                     np.zeros((), np.float32), i,
                                     hang_timeout_s)
                ok_counts[rank] += 1
            except HangError as e:
                with record_lock:
                    hangs.append({"rank": rank, "op": i,
                                  "error": str(e)})
                stop.set()
                return
            except SimCrash as e:
                world.kill_rank(rank)
                with record_lock:
                    failures.append({"t": time.monotonic(),
                                     "rank": rank, "op": i,
                                     "error": repr(e),
                                     "crashed": True})
                stop.set()
                return
            except Exception as e:
                with record_lock:
                    failures.append({"t": time.monotonic(),
                                     "rank": rank, "op": i,
                                     "error": repr(e)[:300]})
                stop.set()
                return

    threads = [threading.Thread(target=rank_loop, args=(r,),
                                name="chaos-rank%d" % r, daemon=True)
               for r in range(ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=n_ops * 2.0 + 2 * hang_timeout_s)
        if t.is_alive():
            with record_lock:
                hangs.append({"rank": t.name, "op": None,
                              "error": "rank thread never exited"})
            stop.set()
    world.close()

    recovery_latency = None
    recovery_error = None
    recovery_attempts = 0
    if failures and not hangs:
        # Recovery drill: after a failure the job replans.  The fault
        # schedule stays ARMED — an incarnation may still absorb a
        # not-yet-spent rule (a real retry loop rides out residual
        # faults the same way), so up to 3 incarnations may be needed;
        # every rule is times=-bounded, so the drill converges.  The
        # recovery latency is failure -> first verified collective,
        # retries included.
        t_fail = min(f["t"] for f in failures)
        for attempt in range(3):
            recovery_attempts = attempt + 1
            recovery_error = None
            try:
                world2 = ChaosWorld(
                    ranks, stall_shutdown_s=stall_shutdown_s,
                    exchange_timeout_s=2 * stall_shutdown_s,
                    device=device)
                try:
                    verify_threads = []
                    verify_errs = []
                    op_index = 10 ** 6 + attempt  # unique logical tag

                    def verify(rank):
                        try:
                            out = world2.collective(
                                rank, "allreduce", "soak.recovery",
                                np.full((64,), _rank_value(rank, 0),
                                        np.float32),
                                op_index, recovery_budget_s)
                            expected = _expected_allreduce((64,), 0,
                                                           ranks)
                            if not world2.correct(out, expected,
                                                  rtol=1e-5):
                                verify_errs.append(
                                    "rank %d incorrect" % rank)
                        except Exception as e:
                            verify_errs.append(repr(e)[:300])

                    for r in range(ranks):
                        t = threading.Thread(target=verify, args=(r,),
                                             daemon=True)
                        t.start()
                        verify_threads.append(t)
                    for t in verify_threads:
                        t.join(timeout=recovery_budget_s + 10)
                        if t.is_alive():
                            verify_errs.append("verification hang")
                    if verify_errs:
                        recovery_error = verify_errs[0]
                    else:
                        recovery_latency = time.monotonic() - t_fail
                finally:
                    world2.close()
            except Exception as e:
                recovery_error = repr(e)[:300]
            if recovery_latency is not None:
                break

    triggers = failpoints.snapshot()
    failpoints.reset()
    failpoints.set_crash_handler(None)

    if hangs:
        outcome = "hang"
    elif incorrect:
        outcome = "incorrect"
    elif failures and recovery_error:
        outcome = "recovery_failed"
    elif failures:
        outcome = "recovered"
    else:
        outcome = "ok"
    return {
        "index": schedule["index"],
        "kind": schedule["kind"],
        "spec": schedule["spec"],
        "seed": schedule["seed"],
        "outcome": outcome,
        "ops_per_rank": n_ops,
        "ops_ok": ok_counts,
        "failures": [{k: (round(v, 3) if k == "t" else v)
                      for k, v in f.items() if k != "t"}
                     for f in failures],
        "hangs": hangs,
        "incorrect": incorrect,
        "recovery_latency_s": (round(recovery_latency, 3)
                               if recovery_latency is not None else None),
        "recovery_attempts": recovery_attempts,
        "recovery_error": recovery_error,
        "failpoint_triggers": triggers,
        "elapsed_s": round(time.monotonic() - t_start, 3),
    }


# ---------------------------------------------------------------------------
# steady-state-replay kill drill
# ---------------------------------------------------------------------------

def run_replay_kill_drill(ranks: int = 8, seed: int = 0,
                          warm_ops: int = 18, post_ops: int = 6,
                          hang_timeout_s: float = 20.0,
                          stall_shutdown_s: float = 2.0,
                          recovery_budget_s: float = 60.0,
                          device="cuda") -> dict:
    """Kill a rank MID-REPLAY and assert bounded recovery with zero
    hangs.  No failpoints are armed (an armed failpoint exits replay
    by design — see common/replay.py), so the kill is driven directly
    by the harness: every rank loops two fixed allreduces until the
    steady-state schedule freezes on all of them, then the victim
    stops submitting and its control socket is severed.  Survivors are
    blocked inside replayed data-plane collectives the victim will
    never join; the drill asserts every one of them surfaces a bounded
    error (SimExchanger timeout / coordinator AB fan-out), never a
    hang, and that a rebuilt world verifies a correct allreduce."""
    from horovod_tpu_torch.common import metrics as _hm

    t_start = time.monotonic()
    device = resolve_device(device)
    failpoints.reset()
    rng = random.Random("%d|replay-kill" % seed)
    victim = rng.randrange(1, ranks)
    entries_c = _hm.REGISTRY.counter("hvd_steady_state_entries")
    cycles_c = _hm.REGISTRY.counter("hvd_steady_state_cycles_replayed")
    entries0, cycles0 = entries_c.value(), cycles_c.value()
    names = ["replay.a", "replay.b"]
    failures, hangs, incorrect = [], [], []
    ok_counts = [0] * ranks
    stop = threading.Event()
    record_lock = threading.Lock()
    world = ChaosWorld(ranks, stall_shutdown_s=stall_shutdown_s,
                       exchange_timeout_s=2 * stall_shutdown_s,
                       device=device)
    engaged_per_rank = [False] * ranks
    probed = [False] * ranks

    def rank_loop(rank: int):
        for i in range(warm_ops + post_ops):
            if rank == victim and i == warm_ops:
                # Deterministic mid-replay death: the victim has
                # replayed at least one full cycle by now.  Wait
                # (python-side only — no protocol traffic) until every
                # rank has recorded its engagement probe: the kill's
                # AB notice lands instantly and would otherwise fail a
                # slow rank's LAST warm step before it could probe.
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline and \
                        not all(probed):
                    time.sleep(0.01)
                with record_lock:
                    failures.append({"t": time.monotonic(),
                                     "rank": rank, "op": i,
                                     "error": "harness kill",
                                     "crashed": True})
                world.kill_rank(rank)
                return
            try:
                value = np.full((129,), _rank_value(rank, i),
                                np.float32)
                out = world.collective(rank, "allreduce",
                                       names[i % len(names)], value, i,
                                       hang_timeout_s)
                expected = _expected_allreduce((129,), i, ranks)
                if not world.correct(out, expected, rtol=1e-5):
                    with record_lock:
                        incorrect.append({"rank": rank, "op": i})
                    stop.set()
                    return
                ok_counts[rank] += 1
                if i == warm_ops - 1:
                    engaged_per_rank[rank] = bool(
                        world.runtimes[rank].replay is not None and
                        world.runtimes[rank].replay.stats()["active"])
                    probed[rank] = True
            except HangError as e:
                with record_lock:
                    hangs.append({"rank": rank, "op": i,
                                  "error": str(e)})
                stop.set()
                return
            except Exception as e:
                # Expected once the victim dies: SimExchanger timeout
                # or the coordinator's broken-membership ERROR/AB.
                with record_lock:
                    failures.append({"t": time.monotonic(),
                                     "rank": rank, "op": i,
                                     "error": repr(e)[:300]})
                return

    threads = [threading.Thread(target=rank_loop, args=(r,),
                                name="replay-drill-r%d" % r,
                                daemon=True)
               for r in range(ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=(warm_ops + post_ops) * 2.0 +
               2 * hang_timeout_s)
        if t.is_alive():
            hangs.append({"rank": t.name, "op": None,
                          "error": "rank thread never exited"})
    world.close()
    entries = entries_c.value() - entries0
    cycles = cycles_c.value() - cycles0

    # Recovery drill: a rebuilt world must verify (same contract as
    # run_schedule) — recovery latency is death -> verified collective.
    recovery_latency = None
    recovery_error = None
    if failures and not hangs and not incorrect:
        t_fail = min(f["t"] for f in failures)
        try:
            world2 = ChaosWorld(ranks,
                                stall_shutdown_s=stall_shutdown_s,
                                exchange_timeout_s=2 * stall_shutdown_s,
                                device=device)
            try:
                verify_errs = []

                def verify(rank):
                    try:
                        out = world2.collective(
                            rank, "allreduce", "replay.recovery",
                            np.full((64,), _rank_value(rank, 0),
                                    np.float32), 0, recovery_budget_s)
                        if not world2.correct(
                                out, _expected_allreduce((64,), 0,
                                                         ranks),
                                rtol=1e-5):
                            verify_errs.append("rank %d incorrect"
                                               % rank)
                    except Exception as e:
                        verify_errs.append(repr(e)[:300])

                vthreads = [threading.Thread(target=verify, args=(r,),
                                             daemon=True)
                            for r in range(ranks)]
                for t in vthreads:
                    t.start()
                for t in vthreads:
                    t.join(timeout=recovery_budget_s + 10)
                    if t.is_alive():
                        verify_errs.append("verification hang")
                if verify_errs:
                    recovery_error = verify_errs[0]
                else:
                    recovery_latency = time.monotonic() - t_fail
            finally:
                world2.close()
        except Exception as e:
            recovery_error = repr(e)[:300]

    survivors_engaged = [engaged_per_rank[r] for r in range(ranks)
                         if r != victim]
    ok = (not hangs and not incorrect and not recovery_error
          and recovery_latency is not None
          and entries >= ranks      # every rank froze a schedule
          and cycles >= 1
          and all(survivors_engaged))
    return {
        "kind": "replay_kill_drill", "ranks": ranks, "seed": seed,
        "victim": victim, "warm_ops": warm_ops,
        "replay_entries": entries, "cycles_replayed": cycles,
        "survivors_engaged": all(survivors_engaged),
        "ops_ok": ok_counts,
        "failures": [{k: v for k, v in f.items() if k != "t"}
                     for f in failures],
        "hangs": hangs, "incorrect": incorrect,
        "recovery_latency_s": (round(recovery_latency, 3)
                               if recovery_latency is not None
                               else None),
        "recovery_error": recovery_error,
        "ok": ok,
        "elapsed_s": round(time.monotonic() - t_start, 3),
    }


# ---------------------------------------------------------------------------
# straggler-attribution drill (common/straggler.py)
# ---------------------------------------------------------------------------

def run_straggler_drill(mode: str = "negotiation", ranks: int = 8,
                        victim: int = 3, delay_ms: float = 25.0,
                        seed: int = 0,
                        attribution_timeout_s: float = 15.0,
                        fanout: int = 0,
                        hang_timeout_s: float = 20.0,
                        threshold: float = 4.0,
                        min_lag_s: float = 0.004,
                        serve_status: bool = False,
                        device="cuda") -> dict:
    """One rank is made slow via the failpoint grammar
    (``runtime.submit=delay(...)`` — a replay-safe site, so the frozen
    schedule stays engaged while the rank stays slow) and the live
    straggler observatory must NAME it within a bounded
    time-to-attribution.

    ``mode="negotiation"`` disables replay: attribution comes from the
    coordinator's CH/RQ arrival-order lag EWMAs.  ``mode="replay"``
    waits for the frozen schedule to engage on EVERY rank, then wipes
    the scorer's negotiation-era state so the re-naming can only come
    from the MR-carried per-rank phase summaries (the wait-inversion
    source) — proving attribution survives the wire going dark, while
    ``hvd_steady_state_cycles_replayed`` keeps growing and the slow
    rank never forces a replay exit.

    ``serve_status=True`` additionally serves a /status endpoint from
    the live world and renders it through ``hvdtop --once --profile``
    (the e2e acceptance path).

    The sampling profiler (common/profiler.py) is armed for the whole
    drill: after the observatory NAMES the victim, the verdict also
    asks the coordinator's profile digests WHY — the dominant frame
    must be the injected delay site (``failpoints:maybe_fail``, where
    the delay rule sleeps), and ``ttrc_s`` records the fault→root-
    cause latency the bench lane tracks as a p50."""
    from horovod_tpu_torch.common import metrics as _hm
    from horovod_tpu_torch.common import profiler as _prof
    from horovod_tpu_torch.common import straggler as _sg

    t_start = time.monotonic()
    device = resolve_device(device)
    mode = mode.lower()
    replay_mode = mode == "replay"
    failpoints.reset()
    _sg.reset()
    _prof.reset()
    saved_env = {}
    for key, value in (("HOROVOD_STRAGGLER_THRESHOLD",
                        repr(threshold)),
                       ("HOROVOD_STRAGGLER_MIN_LAG", repr(min_lag_s))):
        # hvdlint: env-ok(saves the overridden value to restore it after
        # the drill, not a knob parse)
        saved_env[key] = os.environ.get(key)
        os.environ[key] = value
    _sg.configure(enabled=True)
    # High-Hz for the drill: the victim sleeps delay_ms per submit, so
    # at 50 Hz a handful of steps already dominate the digest (the
    # production default 10 Hz is tuned for always-on overhead, not
    # drill time-to-root-cause).
    _prof.configure(enabled=True, hz=50.0, topk=5)
    failpoints.configure("runtime.submit=delay(%gms,rank=%d)"
                         % (delay_ms, victim), seed=seed)
    cycles_c = _hm.REGISTRY.counter("hvd_steady_state_cycles_replayed")
    cycles0 = cycles_c.value()
    hangs, errors = [], []
    world = None
    status_srv = None
    named_at = None
    replay_engaged_at = None
    neg_state_wiped = False
    cycles_at_named = None
    hvdtop_rc = None
    hvdtop_out = ""
    status_json = None
    steps = 0
    try:
        world = ChaosWorld(ranks, stall_shutdown_s=30.0,
                           exchange_timeout_s=hang_timeout_s,
                           fanout=fanout,
                           metrics_agg_s=0.25,
                           replay=replay_mode, device=device)
        coord = world.runtimes[0].controller.server
        scorer = coord._straggler
        assert scorer is not None, "scorer not armed on the coordinator"
        deadline = t_start + attribution_timeout_s + 10.0
        t_armed = time.monotonic()

        def step_all(i: int):
            step_errs = []

            def one(rank):
                try:
                    world.collective(
                        rank, "allreduce", "sgl/w",
                        np.full((129,), _rank_value(rank, i),
                                np.float32), i, hang_timeout_s)
                except HangError as e:
                    hangs.append({"rank": rank, "op": i,
                                  "error": str(e)})
                except Exception as e:
                    step_errs.append({"rank": rank, "op": i,
                                      "error": repr(e)[:300]})

            ts = [threading.Thread(target=one, args=(r,), daemon=True,
                                   name="straggler-r%d" % r)
                  for r in range(ranks)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=2 * hang_timeout_s)
                if t.is_alive():
                    hangs.append({"rank": t.name, "op": i,
                                  "error": "step thread never exited"})
            errors.extend(step_errs)

        while time.monotonic() < deadline and not hangs and not errors:
            step_all(steps)
            steps += 1
            if replay_mode:
                engaged = all(
                    rt.replay is not None and
                    rt.replay.stats()["active"]
                    for rt in world.runtimes)
                if engaged and replay_engaged_at is None:
                    replay_engaged_at = time.monotonic()
                if replay_engaged_at is not None and \
                        not neg_state_wiped:
                    # Attribution must now come from the MR phase
                    # frames alone: wipe every negotiation-era trace
                    # (and the clock restarts — this measures the
                    # replay-mode time-to-attribution).
                    with scorer._lock:
                        scorer._lag.clear()
                        scorer._wait.clear()
                        scorer._scores.clear()
                        scorer._flagged.clear()
                    neg_state_wiped = True
                    # The replay-mode TTA clock starts HERE — so must
                    # its budget: replay engagement time on a loaded
                    # core must not eat the attribution window.
                    t_armed = time.monotonic()
                    deadline = max(deadline,
                                   t_armed + attribution_timeout_s)
                if not neg_state_wiped:
                    continue
            top = scorer.top()
            if top is not None and top[0] == victim and \
                    victim in scorer.flagged():
                named_at = time.monotonic()
                cycles_at_named = cycles_c.value() - cycles0
                break
        # WHO is slow is named; now ask the profile digests WHY.  The
        # digests ride the MR replies the coordinator already polls —
        # nudge a poll and wait for the victim's digest to land (the
        # drill world is one process, so the dominant active frame IS
        # the victim's injected sleep: only it spends wall time in
        # failpoints.maybe_fail).
        root_cause = None
        ttrc_s = None
        if named_at is not None:
            rc_deadline = time.monotonic() + 6.0
            while time.monotonic() < rc_deadline:
                cause = coord.profile_root_cause(victim)
                if cause:
                    root_cause = cause
                    ttrc_s = time.monotonic() - t_armed
                    break
                coord.request_metrics()
                time.sleep(0.15)
        # Let replay keep running a moment to prove the slow rank
        # never forces an exit while scores stay current.
        post_cycles = None
        if replay_mode and named_at is not None:
            for i in range(steps, steps + 4):
                step_all(i)
            steps += 4
            post_cycles = cycles_c.value() - cycles0
        replay_active_end = [
            bool(rt.replay is not None and
                 rt.replay.stats()["active"])
            for rt in world.runtimes]
        # Capture the verdict data BEFORE world.close(): teardown
        # kills ranks, whose lost-promotions call scorer.drop_rank —
        # a post-close read would see cleared scores/flags/gauges.
        final_scores = scorer.scores()
        victim_score = final_scores.get(victim, 0.0)
        # Negotiation mode must be named by the ARRIVAL-LAG source
        # alone: the wait-inversion source (MR phase frames) is also
        # live — as in production — and could mask a broken
        # note_arrival path, making the per-mode distinction vacuous.
        # Recompute the lag-only score from the scorer's own EWMAs
        # and require it to cross too.
        lag_named = None
        if not replay_mode and named_at is not None:
            lags = {int(r): v for r, v in
                    scorer.snapshot()["lag_ewma_s"].items()}
            if lags:
                vals = sorted(lags.values())
                base = max(vals[len(vals) // 2], min_lag_s)
                lag_named = lags.get(victim, 0.0) / base >= threshold
        if serve_status and named_at is not None:
            from horovod_tpu_torch.common import metrics as _hm2

            def status_provider(_coord=coord, _rt=world.runtimes[0]):
                return {
                    "rank": 0, "size": ranks, "initialized": True,
                    "straggler_armed": True,
                    "replay": {
                        "enabled": replay_mode,
                        "active": bool(
                            _rt.replay is not None and
                            _rt.replay.stats()["active"]),
                        "cycles_replayed":
                            cycles_c.value() - cycles0,
                    },
                    "queue_depth": _rt.tensor_queue.outstanding(),
                    "cluster": _coord.status(),
                }

            status_srv = _hm2.serve(port=0, secret="",
                                    status_provider=status_provider)
            status_json = status_provider()
            import contextlib
            import io

            from horovod_tpu_torch.tools import hvdtop
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                hvdtop_rc = hvdtop.main(
                    ["--once", "--profile",
                     "--url", "http://127.0.0.1:%d" % status_srv.port])
            hvdtop_out = buf.getvalue()
    finally:
        if status_srv is not None:
            try:
                status_srv.stop()
            except Exception:
                pass
        if world is not None:
            world.close()
        failpoints.reset()
        _sg.reset()
        _prof.reset()
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    tta = (named_at - t_armed) if named_at is not None else None
    ok = (named_at is not None and not hangs and not errors
          and victim_score >= threshold)
    if not replay_mode:
        ok = ok and bool(lag_named)
    if replay_mode:
        ok = ok and replay_engaged_at is not None \
            and (cycles_at_named or 0) > 0 \
            and (post_cycles or 0) > (cycles_at_named or 0) \
            and all(replay_active_end)
    if serve_status and named_at is not None:
        ok = ok and hvdtop_rc == 0 and ("SLOW" in hvdtop_out)
    out = {
        "kind": "straggler_drill", "mode": mode, "ranks": ranks,
        "fanout": fanout, "victim": victim, "delay_ms": delay_ms,
        "seed": seed, "steps": steps,
        "named": named_at is not None,
        "named_by_lag_source": lag_named,
        "tta_s": round(tta, 3) if tta is not None else None,
        "victim_score": round(victim_score, 3),
        "threshold": threshold,
        "scores": {str(r): round(s, 3)
                   for r, s in sorted(final_scores.items())},
        "hangs": hangs, "errors": errors,
        # Root cause stays advisory (not folded into ok): the digest
        # rides the next metrics frame, so on a loaded CI machine it
        # can land after the naming verdict without the drill lying.
        "root_cause": root_cause,
        "root_cause_named": bool(root_cause
                                 and "maybe_fail" in root_cause),
        "ttrc_s": round(ttrc_s, 3) if ttrc_s is not None else None,
        "ok": ok,
        "elapsed_s": round(time.monotonic() - t_start, 3),
    }
    if replay_mode:
        out["replay"] = {
            "engaged": replay_engaged_at is not None,
            "cycles_replayed_at_named": cycles_at_named,
            "cycles_replayed_after": post_cycles,
            "active_at_end": replay_active_end,
        }
    if serve_status:
        out["hvdtop_rc"] = hvdtop_rc
        out["hvdtop_lines"] = hvdtop_out.splitlines()[:40]
        out["status"] = status_json
    return out


# ---------------------------------------------------------------------------
# tune-abort drill (autotune-then-freeze, horovod_tpu_torch/tune)
# ---------------------------------------------------------------------------

def run_tune_kill_drill(mode: str = "kill", ranks: int = 4,
                        seed: int = 0, max_ops: int = 400,
                        hang_timeout_s: float = 20.0,
                        stall_shutdown_s: float = 2.0,
                        device="cuda") -> dict:
    """Interrupt an autotune-then-freeze search mid-flight and assert
    it fails SAFE: the session must abort cleanly back to default
    knobs — one atomic PA announcement, so no knob proposal is ever
    half-applied across ranks — and the armed flight recorder's
    postmortem must carry the tune-phase events (search/propose/abort)
    so a human can see which phase the search was in when the fault
    hit.

    ``mode="kill"``: a seeded victim rank dies mid-search (after the
    session has scored at least one proposal); the coordinator's
    rank-lost path aborts the session (abort_reason="rank_lost") and
    the verdict must name the victim.
    ``mode="failpoint"``: the ``tune.propose`` failpoint fires an
    injected error at the proposal seam; the session must abort with
    abort_reason="failpoint" with every rank alive and the world
    still computing correct results."""
    t_start = time.monotonic()
    device = resolve_device(device)
    failpoints.reset()
    rng = random.Random("%d|tune-%s" % (seed, mode))
    victim = rng.randrange(1, ranks) if mode == "kill" else None
    bb_dir = _arm_blackbox()
    if mode == "failpoint":
        failpoints.configure("tune.propose=error(tune-drill,times=1)",
                             seed=seed)
    failures, hangs, incorrect = [], [], []
    record_lock = threading.Lock()
    mid_search = threading.Event()   # >=1 proposal scored
    stop = threading.Event()
    # Liveness armed (MTTR-drill cadence): bounded kill detection AND
    # the HB round-trips blackbox_merge aligns per-rank clocks from.
    world = ChaosWorld(ranks, stall_shutdown_s=stall_shutdown_s,
                       exchange_timeout_s=2 * stall_shutdown_s,
                       liveness_interval_s=0.4, tune=True,
                       device=device)
    session = world.runtimes[0].controller.server.tune_session

    def rank_loop(rank: int):
        for i in range(max_ops):
            if stop.is_set() and mode == "kill":
                return
            if rank == victim and mid_search.is_set():
                with record_lock:
                    failures.append({"t": time.monotonic(),
                                     "rank": rank, "op": i,
                                     "error": "harness kill",
                                     "crashed": True})
                flight_recorder.note("drill.fault", rank=rank)
                world.kill_rank(rank)
                return
            try:
                out = world.collective(
                    rank, "allreduce", "tune.%d" % (i % 2),
                    np.full((65,), _rank_value(rank, i), np.float32),
                    i, hang_timeout_s)
                expected = _expected_allreduce((65,), i, ranks)
                if not world.correct(out, expected, rtol=1e-5):
                    with record_lock:
                        incorrect.append({"rank": rank, "op": i})
                    stop.set()
                    return
            except HangError as e:
                with record_lock:
                    hangs.append({"rank": rank, "op": i,
                                  "error": str(e)})
                stop.set()
                return
            except Exception as e:
                # Expected on survivors after a kill: SimExchanger
                # timeout or the coordinator's membership-broken ERROR.
                with record_lock:
                    failures.append({"t": time.monotonic(),
                                     "rank": rank, "op": i,
                                     "error": repr(e)[:300]})
                return
            st = session.status()
            if not mid_search.is_set() and \
                    st["classes"]["dense"]["samples"] >= 1 and \
                    st["phase"] == "search":
                mid_search.set()
            if session.finished and mode == "failpoint" and i >= 8:
                stop.set()
                return
        stop.set()

    try:
        threads = [threading.Thread(target=rank_loop, args=(r,),
                                    name="tune-drill-r%d" % r,
                                    daemon=True)
                   for r in range(ranks)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=max_ops * 1.0 + 2 * hang_timeout_s)
            if t.is_alive():
                hangs.append({"rank": t.name, "op": None,
                              "error": "rank thread never exited"})
        status = session.status()
        # "No half-applied knob split": every surviving runtime must
        # hold the IDENTICAL worker-knob tuple after the abort PA —
        # drained here with a bounded wait (the abort frame is in
        # flight when the survivors' loops unwind).
        expect_reason = "rank_lost" if mode == "kill" else "failpoint"
        survivors = [r for r in range(ranks) if r != victim]
        deadline = time.monotonic() + 5.0
        knob_tuples = []
        while time.monotonic() < deadline:
            knob_tuples = [
                (world.runtimes[r]._cycle_time_s,
                 world.runtimes[r]._coalesce,
                 world.runtimes[r].replay.warmup
                 if world.runtimes[r].replay is not None else None)
                for r in survivors]
            if len(set(knob_tuples)) == 1 and \
                    status["phase"] == "aborted":
                break
            time.sleep(0.05)
            status = session.status()
        knobs_consistent = len(set(knob_tuples)) == 1
        postmortem = collect_postmortem(
            bb_dir, expect_rank=victim if mode == "kill" else None)
        tune_events = [e for e in flight_recorder.events()
                       if e[2] == flight_recorder.TUNE]
        tune_phases = [e[4].get("phase") for e in tune_events]
    finally:
        world.close()
        failpoints.reset()
        flight_recorder.reset()
    ok = (not hangs and not incorrect
          and status["phase"] == "aborted"
          and status["abort_reason"] == expect_reason
          and knobs_consistent
          and "search" in tune_phases
          and "aborted" in tune_phases
          and bool(postmortem.get("ok"))
          and (mode != "kill" or bool(failures)))
    return {
        "kind": "tune_kill_drill", "mode": mode, "ranks": ranks,
        "seed": seed, "victim": victim,
        "phase": status["phase"],
        "abort_reason": status["abort_reason"],
        "dense_samples": status["classes"]["dense"]["samples"],
        "knobs_consistent": knobs_consistent,
        "tune_phases_recorded": sorted(set(p for p in tune_phases
                                           if p)),
        "postmortem": postmortem,
        "failures": [{k: v for k, v in f.items() if k != "t"}
                     for f in failures],
        "hangs": hangs, "incorrect": incorrect,
        "ok": ok,
        "elapsed_s": round(time.monotonic() - t_start, 3),
    }


# ---------------------------------------------------------------------------
# checkpoint kill-and-resume drill
# ---------------------------------------------------------------------------

def _drill_grad(rank_unused: int, step: int, shape) -> np.ndarray:
    """Deterministic, world-size-independent 'gradient' so the
    reference trajectory is computable in closed form: every rank
    applies the same post-allreduce update (data parallelism)."""
    return np.full(shape, 0.25 * ((step % 7) + 1), np.float32)


def _drill_params_at(step: int, shape) -> np.ndarray:
    """Closed-form reference: params after ``step`` completed steps."""
    p = np.zeros(shape, np.float32)
    for s in range(step):
        p += _drill_grad(0, s, shape)
    return p


# --- delta-chain drill: the sparse table trained alongside params ---
_DELTA_ROWS = 48
_DELTA_DIM = 2
_DELTA_PREFIX = "sparse/tbl/rows"


def _delta_touched_rows(step: int):
    """Global rows the whole world touches at ``step`` (each rank
    applies the subset it owns)."""
    return [r for r in range(_DELTA_ROWS) if (r * 7 + step) % 3 == 0]


def _delta_update(step: int, row: int) -> np.float32:
    return np.float32(0.25 * ((step % 5) + 1) + 0.01 * row)


def _delta_table_at(step: int) -> np.ndarray:
    """Closed-form reference: the full table after ``step`` steps."""
    t = np.zeros((_DELTA_ROWS, _DELTA_DIM), np.float32)
    for s in range(step):
        for r in _delta_touched_rows(s):
            t[r] += _delta_update(s, r)
    return t


def run_checkpoint_drill(mode: str, ranks: int = 4, seed: int = 0,
                         steps: int = 12, commit_every: int = 3,
                         victim: int = None, kill_step: int = None,
                         ckpt_dir: str = None,
                         commit_timeout_s: float = 3.0,
                         chain_max: int = 2,
                         device="cuda") -> dict:
    """Kill-and-resume: ``ranks`` thread-ranks train a deterministic
    param vector on ``device``, durably checkpointing every
    ``commit_every`` steps through the real two-phase pipeline
    (horovod_tpu_torch.checkpoint, which takes numpy copies); a
    seeded schedule kills one rank either ``mid_epoch`` (between
    checkpoints) or ``mid_write`` (inside its shard write, via the
    ``ckpt.shard_write`` failpoint); ``mid_delta`` dispatches to
    :func:`run_delta_chain_drill` (kill inside a DIFFERENTIAL save via
    ``ckpt.delta_write``).  The 'job restart' then restores
    from the last coordinator-committed checkpoint and the drill
    asserts

    * the restored step is the last one the arbiter committed,
    * restored params are BIT-identical to the closed-form reference
      at that step,
    * step loss is bounded by the checkpoint cadence (+1 for an
      in-flight async save), and
    * NO step directory on disk carries a manifest that fails full
      checksum validation — a torn or silently-corrupt checkpoint is
      an immediate drill failure.
    """
    import shutil
    import tempfile

    from horovod_tpu_torch.checkpoint import (CheckpointManager,
                                        LocalCommitCoordinator)
    from horovod_tpu_torch.checkpoint import manifest as _mf

    if mode == "mid_delta":
        return run_delta_chain_drill(
            ranks=ranks, seed=seed, steps=steps,
            commit_every=commit_every, chain_max=chain_max,
            victim=victim, ckpt_dir=ckpt_dir,
            commit_timeout_s=commit_timeout_s, device=device)
    assert mode in ("mid_epoch", "mid_write"), mode
    t0 = time.monotonic()
    device = resolve_device(device)
    rng = random.Random("%d|ckpt-drill|%s" % (seed, mode))
    if victim is None:
        victim = rng.randrange(1, ranks)
    if kill_step is None:
        # Late enough that at least one commit is guaranteed durable
        # first: the wait-before-next-save at the SECOND boundary is
        # what drains the first boundary's async save, so the victim
        # must survive past 2*commit_every steps (a kill inside
        # [commit_every, 2*commit_every) may legitimately lose the
        # only snapshot while it is still queued — correct behavior,
        # but nothing for the drill to assert restore against).
        assert steps - 1 >= 2 * commit_every, (steps, commit_every)
        kill_step = rng.randint(2 * commit_every, steps - 1)
    owned_dir = ckpt_dir is None
    if owned_dir:
        ckpt_dir = tempfile.mkdtemp(prefix="hvd-ckpt-drill-")
    shape = (257,)

    def crash_handler(site):
        raise SimCrash("injected crash at %s" % site)

    # First commit boundary at/after the kill step: the save whose
    # shard write the mid_write schedule kills.
    kill_commit = ((kill_step + commit_every - 1)
                   // commit_every) * commit_every
    if mode == "mid_write":
        # The victim dies INSIDE its shard write for checkpoint
        # ``kill_commit`` (the failpoint fires on the victim's
        # checkpoint writer thread; rank= context is threaded through
        # the pipeline explicitly; after= skips the victim's earlier,
        # healthy shard writes).
        failpoints.configure(
            "ckpt.shard_write=crash(times=1,rank=%d,after=%d)"
            % (victim, kill_commit // commit_every - 1), seed=seed)
    else:
        failpoints.reset()
    failpoints.set_crash_handler(crash_handler)

    coord = LocalCommitCoordinator()
    mgrs = [CheckpointManager(ckpt_dir, rank=r, world_size=ranks,
                              coordinator=coord, keep=3,
                              commit_timeout_s=commit_timeout_s)
            for r in range(ranks)]
    errors = []

    def rank_loop(rank: int):
        params = torch.zeros(shape, dtype=torch.float32, device=device)
        try:
            for step in range(steps):
                if mode == "mid_epoch" and rank == victim and \
                        step == kill_step:
                    raise SimCrash("mid-epoch kill at step %d" % step)
                params = params + torch.from_numpy(
                    _drill_grad(rank, step, shape)).to(device)
                if (step + 1) % commit_every == 0:
                    # CheckFreq-style bounded staleness: the previous
                    # async save must be durable before the next one
                    # starts (also what makes the drill deterministic
                    # — no commit is ever superseded in-queue).
                    mgrs[rank].wait(2 * commit_timeout_s + 10)
                    items = {"obj/step": step + 1,
                             "tree/params": _host(params)}
                    mgrs[rank].save_async(step + 1, items)
                    if mode == "mid_write" and rank == victim and \
                            step + 1 == kill_commit:
                        # The injected crash fires inside THIS save's
                        # shard write; the process is dead the moment
                        # it does.  Draining makes the death ordering
                        # deterministic.
                        mgrs[rank].wait(2 * commit_timeout_s + 10)
                        raise SimCrash(
                            "mid-write kill at commit %d" % (step + 1))
        except SimCrash:
            # Process death: the queue dies with it — nothing this
            # rank had not yet written can ever land.
            mgrs[rank].abort()
            return
        except Exception as e:  # pragma: no cover - drill plumbing
            errors.append("rank %d: %r" % (rank, e))

    threads = [threading.Thread(target=rank_loop, args=(r,),
                                name="ckpt-drill-r%d" % r, daemon=True)
               for r in range(ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        if t.is_alive():
            errors.append("%s never exited" % t.name)
    for m in mgrs:
        m.wait(timeout=2 * commit_timeout_s + 5)
        m.close(timeout=1.0)
    triggers = failpoints.snapshot()
    failpoints.reset()
    failpoints.set_crash_handler(None)

    committed_before = coord.committed_step()

    # --- 'restart': fresh managers (any world size reads any layout)
    restore_mgr = CheckpointManager(ckpt_dir, rank=0, world_size=1)
    record = {
        "kind": "checkpoint_drill", "mode": mode, "ranks": ranks,
        "seed": seed, "victim": victim, "kill_step": kill_step,
        "steps": steps, "commit_every": commit_every,
        "errors": errors, "failpoint_triggers": triggers,
    }
    try:
        restored_step, items = restore_mgr.restore_latest()
        restored = items["tree/params"]
        expected = _drill_params_at(restored_step, shape)
        bit_identical = bool(np.array_equal(restored, expected)) and \
            restored.dtype == expected.dtype
        # Torn/corrupt scan: EVERY manifest on disk must fully verify.
        torn = []
        for s in _mf.committed_steps(ckpt_dir):
            try:
                restore_mgr.restore(s)
            except Exception as e:
                torn.append({"step": s, "error": repr(e)[:200]})
        died_at = kill_step if mode == "mid_epoch" else kill_commit
        step_loss = died_at - restored_step
        record.update({
            "committed_before_kill": committed_before,
            "died_at_step": died_at,
            "restored_step": restored_step,
            "bit_identical": bit_identical,
            "step_loss": step_loss,
            # One cadence window, +commit_every for a kill that
            # aborted the in-flight commit of the preceding window.
            "step_loss_bound": 2 * commit_every,
            "torn_checkpoints": torn,
            "ok": (bit_identical and not torn and not errors
                   and step_loss <= 2 * commit_every
                   and (committed_before is None
                        or restored_step >= committed_before)),
        })
    except Exception as e:
        record.update({"ok": False, "error": repr(e)[:300]})
    finally:
        restore_mgr.close(timeout=1.0)
        if owned_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    record["elapsed_s"] = round(time.monotonic() - t0, 3)
    return record


def run_delta_chain_drill(ranks: int = 4, seed: int = 0,
                          steps: int = 12, commit_every: int = 3,
                          chain_max: int = 2,
                          victim: int = None,
                          ckpt_dir: str = None,
                          commit_timeout_s: float = 3.0,
                          device="cuda") -> dict:
    """The differential-checkpoint cell of the kill-and-resume drill
    (``run_checkpoint_drill(mode="mid_delta")``): thread-ranks train a
    dense param vector PLUS a row-sharded sparse table, checkpointing
    through the real two-phase pipeline with a periodic full base and
    touched-rows-only :class:`RowDelta` links in between
    (``HOROVOD_CKPT_DELTA_CHAIN_MAX``); a seeded schedule crashes one
    rank INSIDE a delta save via the ``ckpt.delta_write`` failpoint.
    The 'restart' then asserts

    * the restored step is the last coordinator-committed one (the
      killed delta never became visible),
    * the assembled table is BIT-identical to the closed-form
      reference at that step — i.e. base + the committed deltas
      replay to exactly the full-checkpoint state, never a torn or
      partially-applied chain,
    * every committed step on disk (base or delta) still fully
      verifies, and
    * the committed tip really was a delta (the cell exercises the
      chain, not a degenerate all-base run).
    """
    import shutil
    import tempfile

    from horovod_tpu_torch.checkpoint import (CheckpointManager,
                                        LocalCommitCoordinator,
                                        RowDelta, assemble_table)
    from horovod_tpu_torch.checkpoint import manifest as _mf

    t0 = time.monotonic()
    device = resolve_device(device)
    rng = random.Random("%d|delta-drill" % seed)
    if victim is None:
        victim = rng.randrange(1, ranks)
    assert steps - 1 >= 2 * commit_every, (steps, commit_every)
    # Commit boundaries are steps commit_every, 2*commit_every, ...;
    # commit index i is a BASE when i % (chain_max + 1) == 0, a delta
    # otherwise — a deterministic cadence every rank derives from its
    # own commit count, so no rank ever disagrees on delta_of.
    boundaries = list(range(commit_every, steps + 1, commit_every))
    is_base = [i % (chain_max + 1) == 0
               for i in range(len(boundaries))]
    delta_idxes = [i for i, b in enumerate(is_base)
                   if not b and boundaries[i] > 2 * commit_every]
    if not delta_idxes:
        # Always at least one eligible delta commit by construction
        # (guard for exotic parameter choices).
        delta_idxes = [i for i, b in enumerate(is_base) if not b][-1:]
    kill_idx = rng.choice(delta_idxes)
    kill_commit = boundaries[kill_idx]
    # after= skips the victim's earlier healthy delta saves.
    prior_deltas = sum(1 for i in range(kill_idx) if not is_base[i])
    failpoints.configure(
        "ckpt.delta_write=crash(times=1,rank=%d,after=%d)"
        % (victim, prior_deltas), seed=seed)

    def crash_handler(site):
        raise SimCrash("injected crash at %s" % site)

    failpoints.set_crash_handler(crash_handler)
    owned_dir = ckpt_dir is None
    if owned_dir:
        ckpt_dir = tempfile.mkdtemp(prefix="hvd-delta-drill-")
    old_env = env_mod.env_str_opt(env_mod.HOROVOD_CKPT_DELTA_CHAIN_MAX)
    os.environ["HOROVOD_CKPT_DELTA_CHAIN_MAX"] = str(chain_max)
    shape = (257,)

    coord = LocalCommitCoordinator()
    mgrs = [CheckpointManager(ckpt_dir, rank=r, world_size=ranks,
                              coordinator=coord, keep=3,
                              commit_timeout_s=commit_timeout_s)
            for r in range(ranks)]
    errors = []

    def rank_loop(rank: int):
        params = torch.zeros(shape, dtype=torch.float32, device=device)
        table = np.zeros((_DELTA_ROWS, _DELTA_DIM), np.float32)
        own = [r for r in range(_DELTA_ROWS) if r % ranks == rank]
        touched = {}        # global row -> last-touched step
        commit_idx = 0
        last_saved = None   # (step_id, last step the capture covered)
        try:
            for step in range(steps):
                params = params + torch.from_numpy(
                    _drill_grad(rank, step, shape)).to(device)
                for r in _delta_touched_rows(step):
                    if r % ranks == rank:
                        table[r] += _delta_update(step, r)
                        touched[r] = step
                if (step + 1) % commit_every == 0:
                    # Bounded staleness + determinism: previous save
                    # must be durable before the next one starts, and
                    # — pre-kill — COMMITTED before this rank decides
                    # its delta parent (all ranks then agree).
                    mgrs[rank].wait(2 * commit_timeout_s + 10)
                    if last_saved is not None:
                        prev_step, prev_cover = last_saved
                        deadline = time.monotonic() \
                            + commit_timeout_s
                        while coord.committed_step() != prev_step \
                                and time.monotonic() < deadline:
                            time.sleep(0.005)
                        if coord.committed_step() == prev_step:
                            # The committed delta covered touches up
                            # to prev_cover; a row RE-touched since
                            # then must stay marked or the next delta
                            # silently drops it (the mask-vs-
                            # generation hazard the engine also
                            # guards against).
                            for r in [r for r, s in touched.items()
                                      if s <= prev_cover]:
                                del touched[r]
                    full = is_base[commit_idx]
                    delta_of = None if full else coord.committed_step()
                    if not full and delta_of is None:
                        full = True  # no committed parent: force base
                    rows = sorted(own if full else touched)
                    items = {"obj/step": step + 1,
                             "tree/params": _host(params)}
                    local = {"%s.r%05d" % (_DELTA_PREFIX, rank):
                             RowDelta(np.array(rows, np.int64),
                                      table[rows].copy(),
                                      _DELTA_ROWS)}
                    is_kill = (rank == victim
                               and step + 1 == kill_commit)
                    mgrs[rank].save_async(step + 1, items,
                                          local_items=local,
                                          delta_of=delta_of)
                    last_saved = (step + 1, step)
                    commit_idx += 1
                    if is_kill:
                        # The injected crash fires inside THIS delta
                        # save; drain to make the death ordering
                        # deterministic, then die.
                        mgrs[rank].wait(2 * commit_timeout_s + 10)
                        raise SimCrash("mid-delta kill at commit %d"
                                       % (step + 1))
        except SimCrash:
            mgrs[rank].abort()
            return
        except Exception as e:  # pragma: no cover - drill plumbing
            errors.append("rank %d: %r" % (rank, e))

    threads = [threading.Thread(target=rank_loop, args=(r,),
                                name="delta-drill-r%d" % r,
                                daemon=True)
               for r in range(ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        if t.is_alive():
            errors.append("%s never exited" % t.name)
    for m in mgrs:
        m.wait(timeout=2 * commit_timeout_s + 5)
        m.close(timeout=1.0)
    triggers = failpoints.snapshot()
    failpoints.reset()
    failpoints.set_crash_handler(None)

    committed_before = coord.committed_step()
    restore_mgr = CheckpointManager(ckpt_dir, rank=0, world_size=1)
    record = {
        "kind": "checkpoint_drill", "mode": "mid_delta",
        "ranks": ranks, "seed": seed, "victim": victim,
        "kill_commit": kill_commit, "steps": steps,
        "commit_every": commit_every, "chain_max": chain_max,
        "errors": errors, "failpoint_triggers": triggers,
    }
    try:
        restored_step, items = restore_mgr.restore_latest()
        chain = restore_mgr.chain_of(restored_step)
        restored_params = items["tree/params"]
        restored_table = assemble_table(items, _DELTA_PREFIX)
        exp_params = _drill_params_at(restored_step, shape)
        exp_table = _delta_table_at(restored_step)
        bit_identical = (
            bool(np.array_equal(restored_params, exp_params))
            and bool(np.array_equal(restored_table, exp_table))
            and restored_table.dtype == exp_table.dtype)
        torn = []
        deltas_on_disk = 0
        for s in _mf.committed_steps(ckpt_dir):
            try:
                restore_mgr.restore(s)
                if (_mf.read_manifest(_mf.step_dir(ckpt_dir, s))
                        .meta or {}).get("delta_of") is not None:
                    deltas_on_disk += 1
            except Exception as e:
                torn.append({"step": s, "error": repr(e)[:200]})
        step_loss = kill_commit - restored_step
        # The restore tip is a delta iff the commit before the killed
        # one was one — when the kill lands on the first delta after
        # a base, restoring that base IS correct, so the expectation
        # is schedule-derived, not unconditional.
        expect_tip_delta = kill_idx >= 1 and not is_base[kill_idx - 1]
        record.update({
            "committed_before_kill": committed_before,
            "died_at_step": kill_commit,
            "restored_step": restored_step,
            "restored_chain": chain,
            "tip_is_delta": len(chain) > 1,
            "expect_tip_delta": expect_tip_delta,
            "committed_deltas_on_disk": deltas_on_disk,
            "bit_identical": bit_identical,
            "step_loss": step_loss,
            "step_loss_bound": 2 * commit_every,
            "torn_checkpoints": torn,
            "ok": (bit_identical and not torn and not errors
                   and (len(chain) > 1) == expect_tip_delta
                   and deltas_on_disk > 0
                   and step_loss <= 2 * commit_every
                   and (committed_before is None
                        or restored_step >= committed_before)),
        })
    except Exception as e:
        record.update({"ok": False, "error": repr(e)[:300]})
    finally:
        restore_mgr.close(timeout=1.0)
        if owned_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        if old_env is None:
            os.environ.pop("HOROVOD_CKPT_DELTA_CHAIN_MAX", None)
        else:
            os.environ["HOROVOD_CKPT_DELTA_CHAIN_MAX"] = old_env
    record["elapsed_s"] = round(time.monotonic() - t0, 3)
    return record


# ---------------------------------------------------------------------------
# serve drill: trainer killed mid-commit, replica keeps answering
# ---------------------------------------------------------------------------

def run_serve_drill(ranks: int = 4, seed: int = 0, steps: int = 18,
                    commit_every: int = 3, victim: int = None,
                    commit_timeout_s: float = 3.0,
                    device="cuda") -> dict:
    """Trainer-kill serving drill (docs/serving.md): ``ranks``
    thread-ranks train the closed-form sparse table and commit a
    differential checkpoint every ``commit_every`` steps while a
    :class:`horovod_tpu_torch.serve.ServingReplica` in the MAIN thread
    tails the same directory, holds its snapshot on ``device`` and
    answers full-table reads throughout.  The
    victim dies INSIDE its delta shard write (``ckpt.delta_write``
    crash failpoint), the in-flight commit never publishes, and the
    whole world stops — the replica must keep answering from the last
    committed step.  A restarted world resumes from ``restore_latest``
    and commits to the end; the replica must resume tailing without a
    restart of its own.  Every read in every phase is compared against
    the closed-form table at its OWN served-step stamp — a single
    torn, stale-stamped, or backwards read fails the drill."""
    import shutil
    import tempfile

    from horovod_tpu_torch.checkpoint import (CheckpointManager,
                                        LocalCommitCoordinator,
                                        RowDelta)
    from horovod_tpu_torch.checkpoint import manifest as _mf
    from horovod_tpu_torch.serve import ServingReplica

    t0 = time.monotonic()
    device = resolve_device(device)
    rng = random.Random("%d|serve-drill" % seed)
    if victim is None:
        victim = rng.randrange(1, ranks)
    assert steps % commit_every == 0 and steps // commit_every >= 4
    boundaries = list(range(commit_every, steps + 1, commit_every))
    # Kill at the FOURTH boundary: the first is the full base, so the
    # victim's crashing write is its third delta (after=2 skips the
    # two healthy ones).  Default chain_max (8) keeps all of these on
    # one chain.
    kill_commit = boundaries[3]
    failpoints.configure(
        "ckpt.delta_write=crash(times=1,rank=%d,after=2)" % victim,
        seed=seed)

    def crash_handler(site):
        raise SimCrash("injected crash at %s" % site)

    failpoints.set_crash_handler(crash_handler)
    ckpt_dir = tempfile.mkdtemp(prefix="hvd-serve-drill-")
    old_poll = env_mod.env_str_opt(env_mod.HOROVOD_SERVE_POLL_SECONDS)
    os.environ["HOROVOD_SERVE_POLL_SECONDS"] = "0.02"
    errors = []

    def world_phase(start: int, end: int, kill: int = None):
        """One trainer incarnation: commit every boundary in
        (start, end].  All state is closed-form, so a restarted world
        resumes from the restored step with zero handoff."""
        coord = LocalCommitCoordinator()
        mgrs = [CheckpointManager(ckpt_dir, rank=r, world_size=ranks,
                                  coordinator=coord, keep=None,
                                  commit_timeout_s=commit_timeout_s)
                for r in range(ranks)]

        def rank_loop(rank: int):
            own = [r for r in range(_DELTA_ROWS)
                   if r % ranks == rank]
            try:
                for b in [b for b in boundaries if start < b <= end]:
                    plan = mgrs[rank].delta_plan()
                    if plan is None:
                        rows = own
                    else:
                        win = set()
                        for s in range(plan, b):
                            win.update(_delta_touched_rows(s))
                        rows = sorted(r for r in win
                                      if r % ranks == rank)
                    table = _delta_table_at(b)
                    local = {"%s.r%05d" % (_DELTA_PREFIX, rank):
                             RowDelta(np.array(rows, np.int64),
                                      table[rows].copy(),
                                      _DELTA_ROWS)}
                    mgrs[rank].save_async(b, {"obj/step": b},
                                          local_items=local,
                                          delta_of=plan)
                    mgrs[rank].wait(2 * commit_timeout_s + 10)
                    if kill is not None and b == kill \
                            and rank == victim:
                        raise SimCrash("died mid-commit %d" % b)
                    # Healthy publish is milliseconds; a commit that
                    # has not published within the commit timeout is
                    # starved by the victim's missing mark ("prepared"
                    # IS terminal on non-arbiter ranks, so their own
                    # outcome never flips) — the world dies with it.
                    deadline = time.monotonic() \
                        + commit_timeout_s + 1.0
                    while coord.committed_step() != b \
                            and time.monotonic() < deadline:
                        if mgrs[rank].outcome(b) == "failed":
                            raise SimCrash("commit %d starved" % b)
                        time.sleep(0.004)
                    if coord.committed_step() != b:
                        raise SimCrash("commit %d never published"
                                       % b)
            except SimCrash:
                mgrs[rank].abort()
            except Exception as e:  # pragma: no cover - plumbing
                errors.append("rank %d: %r" % (rank, e))

        threads = [threading.Thread(target=rank_loop, args=(r,),
                                    name="serve-drill-r%d" % r,
                                    daemon=True)
                   for r in range(ranks)]
        for t in threads:
            t.start()
        return threads, mgrs

    def drain_phase(threads, mgrs):
        for t in threads:
            t.join(timeout=60)
            if t.is_alive():
                errors.append("%s never exited" % t.name)
        for m in mgrs:
            m.wait(timeout=2 * commit_timeout_s + 5)
            m.close(timeout=1.0)

    reads = 0
    violations = []
    expected = {}
    last_step = [None]

    def read_and_check(rep):
        """One full-table read, checked against the closed form at its
        own step stamp; a backwards stamp is a violation too, and so is
        a read off the replica's device."""
        nonlocal reads
        rows, step = rep.lookup("tbl", np.arange(_DELTA_ROWS))
        if step not in expected:
            expected[step] = _delta_table_at(step)
        if rows.device != device:
            violations.append({"step": step, "kind": "off_device",
                               "device": str(rows.device)})
        if not np.array_equal(_host(rows), expected[step]) or \
                rows.dtype != torch.float32:
            violations.append({"step": step, "kind": "torn"})
        if last_step[0] is not None and step < last_step[0]:
            violations.append({"step": step, "kind": "regressed",
                               "from": last_step[0]})
        last_step[0] = step
        reads += 1
        return step

    record = {"kind": "serve_drill", "ranks": ranks, "seed": seed,
              "victim": victim, "kill_commit": kill_commit,
              "steps": steps, "commit_every": commit_every}
    rep = None
    try:
        threads, mgrs = world_phase(0, steps, kill=kill_commit)
        deadline = time.monotonic() + 30.0
        while not _mf.committed_steps(ckpt_dir) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        rep = ServingReplica(ckpt_dir, device=device)
        rep.bootstrap()
        rep.start()
        while any(t.is_alive() for t in threads):
            read_and_check(rep)
            time.sleep(0.003)
        drain_phase(threads, mgrs)
        committed_before = max(_mf.committed_steps(ckpt_dir))
        record["committed_before_kill"] = committed_before
        # The dead-trainer gap: the replica must settle on the last
        # committed step and keep answering from it.
        deadline = time.monotonic() + 10.0
        while rep.freshness()[0] < committed_before \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        gap_step = read_and_check(rep)
        record["served_during_gap"] = gap_step
        gap_ok = gap_step == committed_before
        # Restart: a new world resumes from the restored step and the
        # replica tails straight through — no replica restart.
        failpoints.reset()
        threads, mgrs = world_phase(committed_before, steps)
        while any(t.is_alive() for t in threads):
            read_and_check(rep)
            time.sleep(0.003)
        drain_phase(threads, mgrs)
        deadline = time.monotonic() + 10.0
        while rep.freshness()[0] < steps \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        final_step = read_and_check(rep)
        record.update({
            "resumed_to": final_step,
            "reads": reads,
            "torn_reads": len(violations),
            "violations": violations[:5],
            "errors": errors,
            "ok": (not errors and not violations and gap_ok
                   and committed_before == kill_commit - commit_every
                   and final_step == steps),
        })
    except Exception as e:
        record.update({"ok": False, "error": repr(e)[:300],
                       "errors": errors, "reads": reads,
                       "torn_reads": len(violations)})
    finally:
        if rep is not None:
            rep.stop()
        failpoints.reset()
        failpoints.set_crash_handler(None)
        if old_poll is None:
            os.environ.pop("HOROVOD_SERVE_POLL_SECONDS", None)
        else:
            os.environ["HOROVOD_SERVE_POLL_SECONDS"] = old_poll
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    record["elapsed_s"] = round(time.monotonic() - t0, 3)
    return record


# ---------------------------------------------------------------------------
# MTTR drill: detect -> restore -> resume, with a number on it
# ---------------------------------------------------------------------------

def _arm_blackbox() -> str:
    """Arm the flight recorder for a drill with its own dump dir (the
    drill-end dump + failure-trigger dumps both land there)."""
    import tempfile
    bb_dir = tempfile.mkdtemp(prefix="hvd-blackbox-")
    flight_recorder.reset()
    flight_recorder.configure(directory=bb_dir, capacity=1 << 16,
                              enabled=True)
    return bb_dir


def collect_postmortem(dump_dir: str, expect_rank=None,
                       expect_relay=None,
                       measured_mttr_s=None,
                       expect_resize_triggers=None) -> dict:
    """Drill-end postmortem: dump the armed recorder, run
    ``blackbox_merge`` over the per-rank dumps, validate the
    merged chrome trace, and check the verdict against what the drill
    actually did — the verdict must name the killed rank/relay from
    the EVENTS, and its span breakdown must sum to the measured MTTR
    (±10%).  Closes the loop on drills that previously only asserted
    recovery happened."""
    from horovod_tpu_torch.tools import blackbox_merge, validate_trace

    rec = {"dump_dir_events": len(flight_recorder.events())}
    paths = flight_recorder.dump("drill_end", directory=dump_dir)
    rec["dumps"] = len(paths)
    try:
        trace, verdict = blackbox_merge.merge(dump_dir)
    except blackbox_merge.MergeError as e:
        rec.update({"ok": False, "error": str(e)})
        return rec
    trace_errors = validate_trace.validate_events(trace, merged=True)
    fd = verdict.get("first_divergent_event") or {}
    rec.update({
        "failed_rank": verdict.get("failed_rank"),
        "failed_relay": verdict.get("failed_relay"),
        "first_divergent_event": {k: fd.get(k) for k in
                                  ("kind", "reason", "peer", "relay")},
        "spans": verdict.get("spans"),
        "mttr_s": verdict.get("mttr_s"),
        "resize_triggers": verdict.get("resize_triggers"),
        "resize_trigger": verdict.get("resize_trigger"),
        "trace_events": len(trace),
        "trace_errors": trace_errors[:5],
    })
    ok = not trace_errors and rec["dumps"] >= 2
    if expect_rank is not None:
        rec["named_victim"] = verdict.get("failed_rank") == expect_rank
        ok = ok and rec["named_victim"]
    if expect_relay is not None:
        rec["named_relay"] = \
            verdict.get("failed_relay") == expect_relay
        ok = ok and rec["named_relay"]
    if measured_mttr_s:
        total = (verdict.get("spans") or {}).get("total")
        rec["spans_sum_matches_mttr"] = (
            total is not None and
            abs(total - measured_mttr_s) <= 0.10 * measured_mttr_s)
        ok = ok and rec["spans_sum_matches_mttr"]
    if expect_resize_triggers is not None:
        # The verdict must name every resize and its trigger, in
        # order, from the typed elasticity events alone.
        rec["named_resize_triggers"] = (
            verdict.get("resize_triggers") ==
            list(expect_resize_triggers))
        ok = ok and rec["named_resize_triggers"]
    rec["ok"] = ok
    return rec


def _percentile(values, q):
    """Nearest-rank percentile of a list (None when empty)."""
    if not values:
        return None
    vals = sorted(values)
    idx = min(len(vals) - 1, max(0, int(round(q / 100.0 *
                                              (len(vals) - 1)))))
    return vals[idx]


def _mttr_grad(rank: int, step: int, shape) -> np.ndarray:
    return np.full(shape, 0.25 * ((step % 5) + 1) + 0.01 * (rank + 1),
                   np.float32)


def _mttr_step_total(step: int, ranks: int) -> float:
    """Closed-form allreduce(Sum) of every rank's _mttr_grad."""
    return ranks * 0.25 * ((step % 5) + 1) + \
        0.01 * (ranks * (ranks + 1) / 2.0)


def _mttr_params_at(step: int, ranks: int, shape) -> np.ndarray:
    p = np.zeros(shape, np.float32)
    for s in range(step):
        p += np.float32(_mttr_step_total(s, ranks))
    return p


def run_mttr_drill(fault: str = "kill", when: str = "idle",
                   ranks: int = 8, seed: int = 0,
                   liveness_interval_s: float = 0.4,
                   steps_before: int = 10, post_steps: int = 12,
                   commit_every: int = 2,
                   hang_timeout_s: float = 20.0,
                   stall_shutdown_s: float = 4.0,
                   detect_budget_s: float = 10.0,
                   commit_timeout_s: float = 3.0,
                   fanout: int = 0,
                   device="cuda") -> dict:
    """The self-healing control plane end to end, with wall-clock
    numbers: ``ranks`` thread-ranks train a deterministic param vector
    over the REAL control plane with liveness + reconnect armed,
    checkpointing durably every ``commit_every`` steps; then one rank
    suffers ``fault`` (kill = process death / wedge = SIGSTOP analog /
    conn_drop = transient TCP drop) while the world is ``when``
    (idle = nothing in flight — only heartbeats can expose the fault;
    during_replay = steady-state schedules frozen; during_negotiation
    = every cycle on the wire).  For kill/wedge the drill measures

    * ``detect_s``   — fault to the LAST survivor's fatal unwind (the
      liveness/grace bound, with no stall clock and no traffic),
    * ``restore_s``  — ``restore_latest`` from the last committed
      checkpoint,
    * ``resume_s``   — teardown + re-formation + first post-restore
      step (the in-process analog of elastic re-rendezvous),
    * ``mttr_s``     — fault to first post-restore training step,

    asserts the restored params are bit-identical to the closed-form
    reference, the resumed world computes correct steps, and the
    steady-state replay fast path re-engages.  For conn_drop the
    assertion flips: the SAME world must resume transparently —
    bit-identical results, zero HorovodInternalErrors, at least one
    resumed reconnect."""
    import tempfile

    from horovod_tpu_torch.checkpoint import (CheckpointManager,
                                        LocalCommitCoordinator)
    from horovod_tpu_torch.common import metrics as _hm
    from horovod_tpu_torch.common.elastic import RECOVERY_SECONDS

    assert fault in ("kill", "wedge", "conn_drop"), fault
    assert when in ("idle", "during_replay", "during_negotiation"), when
    t0 = time.monotonic()
    device = resolve_device(device)
    failpoints.reset()
    # Black-box flight recorder armed for the whole drill: the per-rank
    # dumps merge into the postmortem verdict asserted below.
    bb_dir = _arm_blackbox()
    rng = random.Random("%d|mttr|%s|%s" % (seed, fault, when))
    victim = rng.randrange(1, ranks)
    shape = (193,)
    grace = 2.0 * liveness_interval_s
    ckpt_dir = tempfile.mkdtemp(prefix="hvd-mttr-")
    reconnects_c = _hm.REGISTRY.counter("hvd_reconnects_total")
    resumed0 = reconnects_c.value(outcome="resumed")

    name_phase = ["1"]

    def names_for(step):
        if when == "during_negotiation":
            return "mttr.s%d" % step   # never converges: always wire
        # The phase tag switches after a transient drop so the
        # post-drop steps start as UNSEEN tensors: replay exits and
        # the negotiation round trips prove the healed channel really
        # carries traffic (a frozen schedule would pass wire-free).
        return "mttr.%s.%s" % (name_phase[0], "ab"[step % 2])

    record = {"kind": "mttr_drill", "fault": fault, "when": when,
              "ranks": ranks, "seed": seed, "victim": victim,
              "fanout": fanout,
              "liveness_interval_s": liveness_interval_s,
              "steps_before": steps_before, "commit_every": commit_every}
    errors, results_bad, fatal_after_drop = [], [], []
    world = world2 = None
    try:
        world = ChaosWorld(ranks, stall_shutdown_s=stall_shutdown_s,
                           exchange_timeout_s=2 * stall_shutdown_s,
                           liveness_interval_s=liveness_interval_s,
                           reconnect_grace_s=grace, fanout=fanout,
                           device=device)
        fatal_times = world.watch_fatal()
        coord = LocalCommitCoordinator()
        mgrs = [CheckpointManager(ckpt_dir, rank=r, world_size=ranks,
                                  coordinator=coord, keep=3,
                                  commit_timeout_s=commit_timeout_s)
                for r in range(ranks)]

        fault_fired = threading.Event()
        t_fault_box = {}

        def fire_fault():
            t_fault_box["t"] = time.monotonic()
            flight_recorder.note("drill.fault", fault=fault,
                                 when=when, victim=victim)
            if fault == "kill":
                world.kill_rank(victim)
            elif fault == "wedge":
                world.wedge_rank(victim)
            else:
                world.sever_rank(victim)
            fault_fired.set()

        def train_loop(rank, start, stop_step, w, out_params,
                       tolerate_failure):
            params = out_params[rank]
            try:
                for step in range(start, stop_step):
                    if fault != "conn_drop" and fault_fired.is_set() \
                            and rank == victim:
                        return  # a dead/wedged rank stops stepping
                    g = _mttr_grad(rank, step, shape)
                    out = w.collective(rank, "allreduce",
                                       names_for(step), g, step,
                                       hang_timeout_s)
                    expected = np.full(shape,
                                       np.float32(_mttr_step_total(
                                           step, ranks)), np.float32)
                    if not w.correct(out, expected, rtol=1e-5):
                        results_bad.append({"rank": rank, "step": step})
                        return
                    params = params + out
                    out_params[rank] = params
                    if (step + 1) % commit_every == 0 and \
                            rank < len(mgrs):
                        # CheckFreq-style bounded staleness (see
                        # run_checkpoint_drill): the previous save is
                        # durable before the next starts.
                        mgrs[rank].wait(2 * commit_timeout_s + 10)
                        mgrs[rank].save_async(
                            step + 1, {"obj/step": step + 1,
                                       "tree/params": _host(params)})
            except HangError as e:
                errors.append({"rank": rank, "error": str(e)})
            except Exception as e:
                if not tolerate_failure:
                    errors.append({"rank": rank,
                                   "error": repr(e)[:300]})

        # --- phase A: warm training (replay engages on fixed names) --
        params_by_rank = {r: torch.zeros(shape, dtype=torch.float32,
                                         device=device)
                          for r in range(ranks)}
        threads = [threading.Thread(
            target=train_loop, args=(r, 0, steps_before, world,
                                     params_by_rank, False),
            daemon=True) for r in range(ranks)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=steps_before * 2.0 + hang_timeout_s)
            if t.is_alive():
                errors.append({"rank": t.name, "error": "warm hang"})
        for m in mgrs:
            m.wait(timeout=2 * commit_timeout_s + 10)
        committed = coord.committed_step()
        record["committed_step"] = committed
        if when == "during_replay":
            record["replay_engaged_before"] = all(
                rt.replay is not None and rt.replay.stats()["active"]
                for rt in world.runtimes)

        # --- fault + (for kill/wedge) detection ----------------------
        if when == "idle":
            fire_fault()
        else:
            # Fault lands while phase-B traffic is in flight.
            threads = [threading.Thread(
                target=train_loop,
                args=(r, steps_before, steps_before + post_steps,
                      world, params_by_rank, fault != "conn_drop"),
                daemon=True) for r in range(ranks)]
            for t in threads:
                t.start()
            time.sleep(0.1)
            fire_fault()
            for t in threads:
                t.join(timeout=post_steps * 2.0 + 2 * hang_timeout_s)
                if t.is_alive():
                    errors.append({"rank": t.name,
                                   "error": "phase-B hang"})
        t_fault = t_fault_box["t"]

        if fault == "conn_drop":
            # The drop may be invisible to training (replay needs no
            # wire) — wait for the background resume itself, bounded
            # by a couple of grace windows.
            resume_deadline = time.monotonic() + 2 * grace + 2.0
            while time.monotonic() < resume_deadline and \
                    reconnects_c.value(outcome="resumed") <= resumed0:
                time.sleep(0.02)
            if when == "idle":
                # Now force real negotiation traffic THROUGH the
                # healed channel: fresh tensor names exit any frozen
                # schedule, so every rank round-trips the coordinator.
                name_phase[0] = "2"
                threads = [threading.Thread(
                    target=train_loop,
                    args=(r, steps_before, steps_before + post_steps,
                          world, params_by_rank, False), daemon=True)
                    for r in range(ranks)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=post_steps * 2.0 + hang_timeout_s)
                    if t.is_alive():
                        errors.append({"rank": t.name,
                                       "error": "post-drop hang"})
            # Transparent resume: same world, bit-identical results,
            # zero HorovodInternalErrors, session actually resumed.
            fatal_after_drop = sorted(fatal_times)
            resumed = reconnects_c.value(outcome="resumed") - resumed0
            expected_final = _mttr_params_at(
                steps_before + post_steps, ranks, shape)
            survivors_exact = all(
                np.array_equal(_host(params_by_rank[r]), expected_final)
                for r in range(ranks))
            record.update({
                "reconnects_resumed": resumed,
                "fatal_events": fatal_after_drop,
                "params_bit_identical": bool(survivors_exact),
                "errors": errors, "results_bad": results_bad,
                "ok": (not errors and not results_bad and
                       not fatal_after_drop and resumed >= 1 and
                       survivors_exact),
            })
            return record

        # kill/wedge: every survivor must unwind via the fast dead-rank
        # notice (AB), with no stall clock involved.
        survivors = [r for r in range(ranks) if r != victim]
        deadline = t_fault + detect_budget_s
        while time.monotonic() < deadline and \
                not all(r in fatal_times for r in survivors):
            time.sleep(0.02)
        missing = [r for r in survivors if r not in fatal_times]
        detect_s = (max(fatal_times[r] for r in survivors) - t_fault) \
            if not missing else None
        record["detect_s"] = round(detect_s, 3) \
            if detect_s is not None else None
        record["detect_missing"] = missing
        if detect_s is not None:
            RECOVERY_SECONDS.observe(detect_s, phase="detect")

        # --- recovery: teardown, re-form, restore, resume ------------
        t_teardown = time.monotonic()
        for m in mgrs:
            m.close(timeout=1.0)
        world.close()
        world = None
        world2 = ChaosWorld(ranks, stall_shutdown_s=stall_shutdown_s,
                            exchange_timeout_s=2 * stall_shutdown_s,
                            liveness_interval_s=liveness_interval_s,
                            reconnect_grace_s=grace, fanout=fanout,
                            device=device)
        t_restore = time.monotonic()
        restore_mgr = CheckpointManager(ckpt_dir, rank=0, world_size=1)
        try:
            restored_step, items = restore_mgr.restore_latest()
        finally:
            restore_mgr.close(timeout=1.0)
        restore_s = time.monotonic() - t_restore
        RECOVERY_SECONDS.observe(restore_s, phase="restore")
        restored = items["tree/params"]
        expected = _mttr_params_at(restored_step, ranks, shape)
        bit_identical = bool(np.array_equal(restored, expected)) and \
            restored.dtype == expected.dtype

        first_step_done = {}
        done_lock = threading.Lock()
        post_params = {r: world2.tensor(np.array(restored, np.float32))
                       for r in range(ranks)}

        def resume_loop(rank):
            params = post_params[rank]
            try:
                for step in range(restored_step,
                                  restored_step + post_steps):
                    g = _mttr_grad(rank, step, shape)
                    out = world2.collective(
                        rank, "allreduce", "mttr.%s" % ("ab"[step % 2]),
                        g, 10 ** 6 + step, hang_timeout_s)
                    if step == restored_step:
                        with done_lock:
                            first_step_done[rank] = time.monotonic()
                    expected_t = np.full(
                        shape, np.float32(_mttr_step_total(step,
                                                           ranks)),
                        np.float32)
                    if not world2.correct(out, expected_t, rtol=1e-5):
                        results_bad.append({"rank": rank,
                                            "step": step,
                                            "phase": "resume"})
                        return
                    params = params + out
                post_params[rank] = params
            except Exception as e:
                errors.append({"rank": rank, "phase": "resume",
                               "error": repr(e)[:300]})

        threads = [threading.Thread(target=resume_loop, args=(r,),
                                    daemon=True) for r in range(ranks)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=post_steps * 2.0 + 2 * hang_timeout_s)
            if t.is_alive():
                errors.append({"rank": t.name, "error": "resume hang"})
        replay_reengaged = all(
            rt.replay is not None and rt.replay.stats()["active"]
            for rt in world2.runtimes)
        mttr_s = (max(first_step_done.values()) - t_fault) \
            if len(first_step_done) == ranks else None
        resume_s = (max(first_step_done.values()) - t_teardown) \
            if len(first_step_done) == ranks else None
        if resume_s is not None:
            RECOVERY_SECONDS.observe(resume_s, phase="resume")
        if first_step_done:
            # Stamp the resumption marker at its TRUE time (the first
            # post-restore step completed a moment ago on a worker
            # thread) so the postmortem span breakdown partitions
            # exactly the measured fault->resume window.
            flight_recorder.note("drill.resumed",
                                 mono=max(first_step_done.values()),
                                 ranks=len(first_step_done))
        postmortem = collect_postmortem(
            bb_dir, expect_rank=victim, measured_mttr_s=mttr_s)
        record["postmortem"] = postmortem
        record.update({
            "restored_step": restored_step,
            "bit_identical": bit_identical,
            "restore_s": round(restore_s, 4),
            "resume_s": round(resume_s, 3)
            if resume_s is not None else None,
            "mttr_s": round(mttr_s, 3) if mttr_s is not None else None,
            "replay_reengaged": replay_reengaged,
            "errors": errors, "results_bad": results_bad,
            "ok": (detect_s is not None and bit_identical and
                   mttr_s is not None and replay_reengaged and
                   postmortem.get("ok", False) and
                   not errors and not results_bad),
        })
        return record
    finally:
        for w in (world, world2):
            if w is not None:
                try:
                    w.close()
                except Exception:
                    pass
        flight_recorder.reset()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        shutil.rmtree(bb_dir, ignore_errors=True)
        record["elapsed_s"] = round(time.monotonic() - t0, 3)


def run_mttr_matrix(ranks: int = 8, seed: int = 0,
                    faults=("kill", "wedge", "conn_drop"),
                    whens=("idle", "during_replay",
                           "during_negotiation"),
                    device="cuda") -> dict:
    """The full fault x phase MTTR matrix; returns per-cell records
    plus detect/MTTR percentiles for the artifact."""
    t0 = time.monotonic()
    cells = []
    for fault in faults:
        for when in whens:
            logger.info("mttr drill: %s x %s", fault, when)
            cells.append(run_mttr_drill(fault=fault, when=when,
                                        ranks=ranks, seed=seed,
                                        device=device))
    mttrs = [c["mttr_s"] for c in cells if c.get("mttr_s") is not None]
    detects = [c["detect_s"] for c in cells
               if c.get("detect_s") is not None]
    return {
        "kind": "mttr_matrix", "ranks": ranks, "seed": seed,
        "cells": cells,
        "mttr_s": {"p50": _percentile(mttrs, 50),
                   "p90": _percentile(mttrs, 90),
                   "max": max(mttrs) if mttrs else None},
        "detect_s": {"p50": _percentile(detects, 50),
                     "p90": _percentile(detects, 90),
                     "max": max(detects) if detects else None},
        "ok": all(c.get("ok") for c in cells),
        "elapsed_s": round(time.monotonic() - t0, 3),
    }


# ---------------------------------------------------------------------------
# autoscale drill: grow -> migrate -> shrink, with latency numbers
# ---------------------------------------------------------------------------

_ASZ_DIM = 4


def _asz_row_at(step: int, row: int, rows: int) -> np.ndarray:
    """Closed-form float32 value of sparse-table row ``row`` after
    ``step`` steps: the row's owner adds 0.5*(s+1) whenever
    ``s % rows == row``, in step order — exactly one add per touch,
    so the accumulation is bit-deterministic no matter which rank
    owned the row at the time (ownership is ``j % world_size`` and
    changes at every resize)."""
    v = np.zeros((_ASZ_DIM,), np.float32)
    for s in range(row, step, rows):
        v += np.float32(0.5 * (s + 1))
    return v


def _asz_params_at(step: int, boundary: int, ranks_a: int,
                   ranks_b: int, shape) -> np.ndarray:
    """Dense-params closed form across a resize at ``boundary``:
    steps below it ran at ``ranks_a``, the rest at ``ranks_b``."""
    p = np.zeros(shape, np.float32)
    for s in range(step):
        p += np.float32(_mttr_step_total(
            s, ranks_a if s < boundary else ranks_b))
    return p


def run_autoscale_drill(ranks: int = 8, grow_to: int = 16,
                        seed: int = 0,
                        steps_per_phase: int = 8,
                        commit_every: int = 2,
                        policy_window: int = 3,
                        policy_cooldown_s: float = 2.0,
                        migrate_after_s: float = 0.2,
                        real_scorer: bool = False,
                        delay_ms: float = 25.0,
                        threshold: float = 4.0,
                        min_lag_s: float = 0.004,
                        post_steps: int = 6,
                        hang_timeout_s: float = 20.0,
                        commit_timeout_s: float = 3.0,
                        budget_s: float = 60.0,
                        device="cuda") -> dict:
    """The closed elasticity loop end to end: grow, migrate, shrink —
    driven by the REAL :class:`ElasticPolicy` under continuous traffic
    with durable checkpoints (replicated dense params + rank-local
    sparse row-shards whose ownership is redistributed at every
    resize).

    * **grow** (``ranks`` -> ``grow_to``): pending capacity is fed to
      the policy every step; the hysteresis window must elapse before
      the scale-up decision fires, then the world is rebuilt at
      ``grow_to`` from the last durable checkpoint (bounded step loss,
      bit-identical restore) and the replay fast path must re-engage;
    * **migrate**: one rank is flagged slow — synthetically, or (with
      ``real_scorer=True``) by the live straggler scorer under a
      seeded ``runtime.submit=delay(...)`` failpoint — and after
      ``migrate_after_s`` of continuous flagging the policy decides a
      checkpoint-first eviction: the evict waits for a checkpoint
      commit NEWER than the decision, and the post-decision tick must
      land in the cooldown (refractory) window;
    * **shrink** (``grow_to`` -> ``ranks``): the world is rebuilt at
      the original size attributed to the migration, restored
      bit-identical against the two-segment closed form, and replay
      must re-engage again.

    The drill-end postmortem must name BOTH resize triggers, in
    order, from the typed flight-recorder events alone."""
    import tempfile

    from horovod_tpu_torch.checkpoint import (CheckpointManager,
                                        LocalCommitCoordinator)
    from horovod_tpu_torch.common import metrics as _hm
    from horovod_tpu_torch.common import straggler as _sg
    from horovod_tpu_torch.runner.elastic.policy import (
        ElasticPolicy, KIND_MIGRATE, KIND_SCALE_UP, Signals,
        TRIGGER_MIGRATION, TRIGGER_SCALE_UP, note_resize,
        observe_autoscale)

    assert grow_to > ranks, (ranks, grow_to)
    t0 = time.monotonic()
    device = resolve_device(device)
    failpoints.reset()
    bb_dir = _arm_blackbox()
    ckpt_dir = tempfile.mkdtemp(prefix="hvd-autoscale-")
    rng = random.Random("%d|autoscale" % seed)
    victim = rng.randrange(1, grow_to)
    shape = (193,)
    rows = 3 * grow_to

    saved_env = {}
    env_overrides = {"HOROVOD_STRAGGLER_MIGRATE": "1"}
    if real_scorer:
        env_overrides["HOROVOD_STRAGGLER_THRESHOLD"] = repr(threshold)
        env_overrides["HOROVOD_STRAGGLER_MIN_LAG"] = repr(min_lag_s)
    for key, value in env_overrides.items():
        # hvdlint: env-ok(saves the overridden value to restore it after
        # the drill, not a knob parse)
        saved_env[key] = os.environ.get(key)
        os.environ[key] = value
    if real_scorer:
        _sg.reset()
        _sg.configure(enabled=True)

    resizes_c = _hm.REGISTRY.counter("hvd_elastic_resizes_total")
    up0 = resizes_c.value(direction="up", trigger=TRIGGER_SCALE_UP)
    down0 = resizes_c.value(direction="down",
                            trigger=TRIGGER_MIGRATION)

    policy = ElasticPolicy(min_np=ranks, max_np=grow_to,
                           window=policy_window,
                           cooldown_s=policy_cooldown_s,
                           migrate_after_s=migrate_after_s)

    record = {"kind": "autoscale_drill", "ranks": ranks,
              "grow_to": grow_to, "seed": seed, "victim": victim,
              "real_scorer": real_scorer,
              "commit_every": commit_every,
              "policy_window": policy_window,
              "policy_cooldown_s": policy_cooldown_s,
              "migrate_after_s": migrate_after_s}
    hangs, errors, results_bad = [], [], []
    state = {"params": torch.zeros(shape, dtype=torch.float32,
                                   device=device)}
    table = {j: np.zeros((_ASZ_DIM,), np.float32)
             for j in range(rows)}
    world = world2 = world3 = None
    all_mgrs = []

    def step_world(w, nranks, step, name, op_index):
        outs = {}

        def one(rank):
            try:
                g = _mttr_grad(rank, step, shape)
                outs[rank] = w.collective(rank, "allreduce", name, g,
                                          op_index, hang_timeout_s)
            except HangError as e:
                hangs.append({"rank": rank, "step": step,
                              "error": str(e)})
            except Exception as e:
                errors.append({"rank": rank, "step": step,
                               "error": repr(e)[:300]})

        ts = [threading.Thread(target=one, args=(r,), daemon=True,
                               name="asz-r%d" % r)
              for r in range(nranks)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=2 * hang_timeout_s)
            if t.is_alive():
                hangs.append({"rank": t.name, "step": step,
                              "error": "step thread never exited"})
        if len(outs) != nranks:
            return None
        expected = np.full(shape,
                           np.float32(_mttr_step_total(step, nranks)),
                           np.float32)
        for r, out in outs.items():
            if not w.correct(out, expected, rtol=1e-5):
                results_bad.append({"rank": r, "step": step})
                return None
        return outs[0]

    def apply_step(out, step):
        state["params"] = state["params"] + out
        j = step % rows
        table[j] = table[j] + np.float32(0.5 * (step + 1))

    def save_all(mgrs, nranks, step):
        # step = completed-step count; every rank saves the replicated
        # dense state plus ITS slice of the sparse row-shard table
        # (ownership j % nranks — the thing a resize redistributes).
        for r in range(nranks):
            mgrs[r].wait(2 * commit_timeout_s + 10)
            local = {"emb/row/%03d" % j: table[j].copy()
                     for j in range(rows) if j % nranks == r}
            mgrs[r].save_async(step,
                               {"obj/step": step,
                                "tree/params": _host(state["params"])},
                               local_items=local)

    def restore_all():
        mgr = CheckpointManager(ckpt_dir, rank=0, world_size=1)
        try:
            restored_step, items = mgr.restore_latest()
        finally:
            mgr.close(timeout=1.0)
        return restored_step, items

    def rows_match(items, restored_step):
        return all(
            np.array_equal(items.get("emb/row/%03d" % j),
                           _asz_row_at(restored_step, j, rows))
            for j in range(rows))

    def reload_from(items):
        state["params"] = torch.from_numpy(np.array(
            items["tree/params"], np.float32)).to(device)
        for j in range(rows):
            table[j] = np.array(items["emb/row/%03d" % j], np.float32)

    try:
        agg = 0.25 if real_scorer else 0.0
        # --- phase A: traffic at `ranks`, pending capacity feeds the
        # policy until the hysteresis window elapses -----------------
        world = ChaosWorld(ranks, stall_shutdown_s=30.0,
                           exchange_timeout_s=hang_timeout_s,
                           metrics_agg_s=agg, device=device)
        coordc = LocalCommitCoordinator()
        mgrs = [CheckpointManager(ckpt_dir, rank=r, world_size=ranks,
                                  coordinator=coordc, keep=3,
                                  commit_timeout_s=commit_timeout_s)
                for r in range(ranks)]
        all_mgrs.extend(mgrs)
        step = 0
        t_pending0 = time.monotonic()
        dec1 = t_dec1 = None
        deadline = time.monotonic() + budget_s
        while time.monotonic() < deadline and not hangs and \
                not errors and not results_bad:
            t_s = time.monotonic()
            out = step_world(world, ranks, step,
                             "asz.a.%s" % "ab"[step % 2], step)
            if out is None:
                break
            apply_step(out, step)
            step += 1
            cycle = time.monotonic() - t_s
            if dec1 is None:
                d = policy.observe(Signals(
                    ranks, pending_hosts=grow_to - ranks,
                    cycle_time_s=cycle))
                if d is not None and d.kind == KIND_SCALE_UP:
                    dec1, t_dec1 = d, time.monotonic()
                    observe_autoscale("decision",
                                      t_dec1 - t_pending0)
                    if flight_recorder.ENABLED:
                        flight_recorder.record(
                            flight_recorder.ELASTIC_SCALE_UP,
                            rank="driver",
                            hosts="pending-%d" % (grow_to - ranks),
                            slots=grow_to - ranks, epoch=1,
                            trigger=d.trigger)
            if step % commit_every == 0:
                save_all(mgrs, ranks, step)
                if dec1 is not None and step >= steps_per_phase:
                    break
        for m in mgrs:
            m.wait(timeout=2 * commit_timeout_s + 10)
        steps_a = step
        committed_a = coordc.committed_step()
        record.update({
            "scale_up_decided": dec1 is not None,
            "scale_up_reason": dec1.reason if dec1 else None,
            "steps_a": steps_a, "committed_a": committed_a,
        })
        for m in mgrs:
            m.close(timeout=1.0)
        world.close()
        world = None
        if dec1 is None or hangs or errors or results_bad:
            record.update({"ok": False, "hangs": hangs,
                           "errors": errors,
                           "results_bad": results_bad})
            return record

        # --- resize 1: grow to `grow_to` from the durable checkpoint
        world2 = ChaosWorld(grow_to, stall_shutdown_s=30.0,
                            exchange_timeout_s=hang_timeout_s,
                            metrics_agg_s=agg, device=device)
        restored_a, items = restore_all()
        bit_a = bool(np.array_equal(
            items["tree/params"],
            _mttr_params_at(restored_a, ranks, shape)))
        rows_a = rows_match(items, restored_a)
        reload_from(items)
        step = restored_a
        t_admit1 = time.monotonic()
        observe_autoscale("admission", t_admit1 - t_dec1)
        note_resize("up", TRIGGER_SCALE_UP)
        record.update({
            "restored_a": restored_a,
            "step_loss_a": steps_a - restored_a,
            "bit_identical_a": bit_a, "rows_identical_a": rows_a,
        })

        # --- phase B: traffic at `grow_to`; a straggler ripens into a
        # checkpoint-first migration -------------------------------
        coordc2 = LocalCommitCoordinator()
        mgrs2 = [CheckpointManager(ckpt_dir, rank=r,
                                   world_size=grow_to,
                                   coordinator=coordc2, keep=3,
                                   commit_timeout_s=commit_timeout_s)
                 for r in range(grow_to)]
        all_mgrs.extend(mgrs2)
        scorer = None
        if real_scorer:
            failpoints.configure(
                "runtime.submit=delay(%gms,rank=%d)"
                % (delay_ms, victim), seed=seed)
            scorer = world2.runtimes[0].controller.server._straggler
            assert scorer is not None, "scorer not armed"
        first_step1_s = None
        dec2 = t_dec2 = t_first_flag = None
        ckpt_at_dec = None
        t_evict = None
        cooldown_checked = cooldown_ok = False
        deadline = time.monotonic() + budget_s
        while time.monotonic() < deadline and not hangs and \
                not errors and not results_bad:
            t_s = time.monotonic()
            out = step_world(world2, grow_to, step,
                             "asz.b.%s" % "ab"[step % 2],
                             10 ** 6 + step)
            if out is None:
                break
            if first_step1_s is None:
                first_step1_s = time.monotonic() - t_dec1
                observe_autoscale("first_step", first_step1_s)
            apply_step(out, step)
            step += 1
            cycle = time.monotonic() - t_s
            if step % commit_every == 0:
                save_all(mgrs2, grow_to, step)
            if real_scorer:
                scores = scorer.scores()
                sig_scores = {r: scores.get(r, 0.0)
                              for r in scorer.flagged()}
            else:
                sig_scores = {victim: 9.9}
            if sig_scores and t_first_flag is None:
                t_first_flag = time.monotonic()
            if dec2 is None:
                d = policy.observe(Signals(
                    grow_to, straggler_scores=sig_scores,
                    cycle_time_s=cycle))
                if d is not None and d.kind == KIND_MIGRATE:
                    dec2, t_dec2 = d, time.monotonic()
                    ckpt_at_dec = coordc2.committed_step()
                    observe_autoscale(
                        "decision",
                        t_dec2 - (t_first_flag or t_dec2))
                    if flight_recorder.ENABLED:
                        flight_recorder.record(
                            flight_recorder.ELASTIC_MIGRATE,
                            rank="driver", peer=d.rank,
                            host="host-%d" % d.rank,
                            phase="decided",
                            score=round(sig_scores.get(d.rank, 0.0),
                                        3))
            elif not cooldown_checked:
                # The tick right after a decision MUST land in the
                # refractory window — the anti-flap contract.
                cooldown_checked = True
                cooldown_ok = policy.observe(Signals(
                    grow_to, straggler_scores=sig_scores,
                    cycle_time_s=cycle)) is None
            if dec2 is not None and t_evict is None:
                committed_now = coordc2.committed_step()
                if committed_now is not None and \
                        committed_now > (ckpt_at_dec or 0):
                    # Checkpoint-then-evict: a commit NEWER than the
                    # decision is durable — the straggler can go.
                    t_evict = time.monotonic()
                    observe_autoscale("admission", t_evict - t_dec2)
                    note_resize("down", TRIGGER_MIGRATION)
                    if flight_recorder.ENABLED:
                        flight_recorder.record(
                            flight_recorder.ELASTIC_MIGRATE,
                            rank="driver", peer=dec2.rank,
                            host="host-%d" % dec2.rank,
                            phase="evict",
                            ckpt_step=committed_now,
                            ckpt_fresh=True)
            if t_evict is not None and cooldown_checked and \
                    step % commit_every == 0:
                break
        for m in mgrs2:
            m.wait(timeout=2 * commit_timeout_s + 10)
        steps_b = step
        committed_b = coordc2.committed_step()
        replay_grow = all(
            rt.replay is not None and rt.replay.stats()["active"]
            for rt in world2.runtimes)
        if real_scorer:
            record["victim_score"] = (scorer.scores() or {}).get(
                victim, 0.0)
        for m in mgrs2:
            m.close(timeout=1.0)
        world2.close()
        world2 = None
        failpoints.reset()
        record.update({
            "migrate_decided": dec2 is not None,
            "migrate_rank": dec2.rank if dec2 else None,
            "migrate_reason": dec2.reason if dec2 else None,
            "evicted": t_evict is not None,
            "cooldown_respected": cooldown_ok,
            "steps_b": steps_b, "committed_b": committed_b,
            "replay_reengaged_grow": replay_grow,
        })
        if dec2 is None or t_evict is None or hangs or errors or \
                results_bad:
            record.update({"ok": False, "hangs": hangs,
                           "errors": errors,
                           "results_bad": results_bad})
            return record

        # --- resize 2: shrink back to `ranks`, attributed to the
        # migration ------------------------------------------------
        world3 = ChaosWorld(ranks, stall_shutdown_s=30.0,
                            exchange_timeout_s=hang_timeout_s,
                            metrics_agg_s=agg, device=device)
        restored_b, items2 = restore_all()
        bit_b = bool(np.array_equal(
            items2["tree/params"],
            _asz_params_at(restored_b, restored_a, ranks, grow_to,
                           shape)))
        rows_b = rows_match(items2, restored_b)
        reload_from(items2)
        step = restored_b
        first_step2_s = None
        n_post = 0

        def replay_active(w):
            return all(
                rt.replay is not None and rt.replay.stats()["active"]
                for rt in w.runtimes)

        # Step until the frozen schedule re-engages (at least
        # ``post_steps`` steps, bounded — re-engagement after a resize
        # is an acceptance criterion, not best-effort).
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline and not hangs and \
                not errors and not results_bad:
            out = step_world(world3, ranks, step,
                             "asz.c.%s" % "ab"[step % 2],
                             2 * 10 ** 6 + step)
            if out is None:
                break
            if first_step2_s is None:
                first_step2_s = time.monotonic() - t_evict
                observe_autoscale("first_step", first_step2_s)
            apply_step(out, step)
            step += 1
            n_post += 1
            if n_post >= post_steps and replay_active(world3):
                break
        replay_shrink = replay_active(world3)

        postmortem = collect_postmortem(
            bb_dir, expect_resize_triggers=(TRIGGER_SCALE_UP,
                                            TRIGGER_MIGRATION))
        resizes_up = resizes_c.value(
            direction="up", trigger=TRIGGER_SCALE_UP) - up0
        resizes_down = resizes_c.value(
            direction="down", trigger=TRIGGER_MIGRATION) - down0
        record.update({
            "restored_b": restored_b,
            "step_loss_b": steps_b - restored_b,
            "bit_identical_b": bit_b, "rows_identical_b": rows_b,
            "replay_reengaged_shrink": replay_shrink,
            "scale_up_s": {
                "decision": round(t_dec1 - t_pending0, 3),
                "admission": round(t_admit1 - t_dec1, 3),
                "first_step": round(first_step1_s, 3)
                if first_step1_s is not None else None,
            },
            "migrate_s": {
                "decision": round(t_dec2 - (t_first_flag or t_dec2),
                                  3),
                "ckpt_wait": round(t_evict - t_dec2, 3),
                "first_step": round(first_step2_s, 3)
                if first_step2_s is not None else None,
            },
            "resizes_total": {"up": resizes_up, "down": resizes_down},
            "postmortem": postmortem,
            "hangs": hangs, "errors": errors,
            "results_bad": results_bad,
            "ok": (not hangs and not errors and not results_bad and
                   bit_a and rows_a and bit_b and rows_b and
                   (steps_a - restored_a) <= commit_every and
                   (steps_b - restored_b) <= commit_every and
                   (dec2.rank == victim) and cooldown_ok and
                   first_step1_s is not None and
                   first_step2_s is not None and
                   replay_grow and replay_shrink and
                   resizes_up >= 1 and resizes_down >= 1 and
                   postmortem.get("ok", False)),
        })
        return record
    finally:
        for m in all_mgrs:
            try:
                m.close(timeout=1.0)
            except Exception:
                pass
        for w in (world, world2, world3):
            if w is not None:
                try:
                    w.close()
                except Exception:
                    pass
        failpoints.reset()
        if real_scorer:
            _sg.reset()
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        flight_recorder.reset()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        shutil.rmtree(bb_dir, ignore_errors=True)
        record["elapsed_s"] = round(time.monotonic() - t0, 3)


def run_autoscale_matrix(ranks: int = 8, grow_to: int = 16,
                         seed: int = 0, device="cuda") -> dict:
    """Both migration signal sources over the full 8->16->8 resize
    path: the synthetic flagged-score feed (deterministic timing) and
    the live straggler scorer under a seeded delay failpoint."""
    t0 = time.monotonic()
    cells = {
        "synthetic": run_autoscale_drill(ranks=ranks, grow_to=grow_to,
                                         seed=seed, device=device),
        "real_scorer": run_autoscale_drill(
            ranks=ranks, grow_to=grow_to, seed=seed, real_scorer=True,
            migrate_after_s=0.8, budget_s=90.0, device=device),
    }
    lats = [c["scale_up_s"]["first_step"] for c in cells.values()
            if (c.get("scale_up_s") or {}).get("first_step")
            is not None]
    return {
        "kind": "autoscale_matrix", "ranks": ranks,
        "grow_to": grow_to, "seed": seed, "cells": cells,
        "autoscale_s": {"p50": _percentile(lats, 50),
                        "max": max(lats) if lats else None},
        "ok": all(c.get("ok") for c in cells.values()),
        "elapsed_s": round(time.monotonic() - t0, 3),
    }


# ---------------------------------------------------------------------------
# relay-tree drills: survive interior fan-out loss
# ---------------------------------------------------------------------------

def run_relay_drill(fault: str = "kill", when: str = "negotiation",
                    ranks: int = 8, fanout: int = 2, seed: int = 0,
                    liveness_interval_s: float = 0.3,
                    warm_steps: int = 3, post_steps: int = 5,
                    hang_timeout_s: float = 25.0,
                    stall_shutdown_s: float = 6.0,
                    device="cuda") -> dict:
    """Kill/wedge/cut an INTERIOR relay while the world is idle /
    mid-negotiation / mid-replay.  Unlike a dead rank, a dead relay
    must be *transparent*: every leaf it served re-homes through its
    ancestor chain (resume rings replay whatever the relay swallowed),
    so the drill asserts

    * zero hangs and zero fatal unwinds on ANY rank — the world never
      breaks,
    * every collective, including those in flight through the dying
      relay, completes bit-correct,
    * the whole subtree re-homes (resumed re-home count >= subtree
      size) within the depth-aware detection bound + grace window.
    """
    from horovod_tpu_torch.common import env as _env
    from horovod_tpu_torch.common import metrics as _hm

    assert fault in ("kill", "wedge", "drop"), fault
    assert when in ("idle", "negotiation", "replay"), when
    t0 = time.monotonic()
    device = resolve_device(device)
    failpoints.reset()
    # Black-box recorder: the postmortem must name the killed relay
    # from the per-rank dumps alone.
    bb_dir = _arm_blackbox()
    grace = 4.0 * liveness_interval_s
    base_timeout = 2.0 * liveness_interval_s
    rehomes = _hm.REGISTRY.counter("hvd_relay_rehomes_total")

    def resumed():
        return rehomes.value(outcome="resumed_parent") + \
            rehomes.value(outcome="resumed_ancestor")

    world = ChaosWorld(ranks, stall_shutdown_s=stall_shutdown_s,
                       exchange_timeout_s=3 * stall_shutdown_s,
                       liveness_interval_s=liveness_interval_s,
                       reconnect_grace_s=grace, fanout=fanout,
                       device=device)
    assert world.plan is not None, \
        "ranks=%d fanout=%d degenerates to a flat star" % (ranks,
                                                           fanout)
    victim = 0   # a level-0 relay serving real leaves
    subtree = world.subtree_ranks(victim)
    levels = world.plan.levels
    # Detection: the subtree's leaves notice coordinator silence at
    # the depth-aware deadline (kill/drop are faster: dead sockets);
    # re-homing then rides the grace window.
    rehome_bound_s = _env.depth_aware_liveness_timeout(
        base_timeout, levels) + grace + 3.0
    fatal_times = world.watch_fatal()
    errors, results_bad, hangs = [], [], []
    record = {"kind": "relay_drill", "fault": fault, "when": when,
              "ranks": ranks, "fanout": fanout, "seed": seed,
              "victim_relay": victim, "subtree": subtree,
              "topology": world.plan.to_meta(),
              "liveness_interval_s": liveness_interval_s,
              "rehome_bound_s": round(rehome_bound_s, 2)}

    def step_all(phase: str, steps: int, names_fn, base: int):
        """Every rank runs `steps` allreduces; returns per-rank sums
        checked against the closed form."""
        def loop(rank):
            for i in range(steps):
                op = base + i
                try:
                    out = world.collective(
                        rank, "allreduce", names_fn(i),
                        np.full((65,), _rank_value(rank, op),
                                np.float32), op, hang_timeout_s)
                except HangError as e:
                    hangs.append({"rank": rank, "phase": phase,
                                  "error": str(e)})
                    return
                except Exception as e:
                    errors.append({"rank": rank, "phase": phase,
                                   "error": repr(e)[:300]})
                    return
                expected = _expected_allreduce((65,), op, ranks)
                if not world.correct(out, expected, rtol=1e-5):
                    results_bad.append({"rank": rank, "phase": phase,
                                        "op": op})
                    return
        ts = [threading.Thread(target=loop, args=(r,), daemon=True)
              for r in range(ranks)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=steps * 2.0 + 2 * hang_timeout_s)
            if t.is_alive():
                hangs.append({"rank": t.name, "phase": phase,
                              "error": "thread never exited"})

    try:
        resumed0 = resumed()
        # Phase A: warm the tree (fixed names; replay may engage).
        step_all("warm", warm_steps, lambda i: "relay.w%d" % (i % 2),
                 base=0)
        # Phase B: the fault lands per `when`.
        fired = {}

        def fire():
            fired["t"] = time.monotonic()
            flight_recorder.note("drill.fault", fault=fault,
                                 when=when, relay=victim)
            if fault == "kill":
                world.kill_relay(victim)
            elif fault == "wedge":
                world.wedge_relay(victim)
            else:
                world.sever_relay_uplink(victim)

        if when == "idle":
            fire()
        else:
            names = (lambda i: "relay.b%d" % i) if \
                when == "negotiation" else \
                (lambda i: "relay.w%d" % (i % 2))
            bt = threading.Thread(
                target=step_all,
                args=("fault", post_steps, names, 100), daemon=True)
            bt.start()
            time.sleep(0.08)
            fire()
            bt.join(timeout=post_steps * 2.0 + 3 * hang_timeout_s)
        # Re-home: the whole subtree resumes somewhere else.
        deadline = fired["t"] + rehome_bound_s
        while time.monotonic() < deadline and \
                resumed() - resumed0 < len(subtree):
            time.sleep(0.02)
        rehome_s = time.monotonic() - fired["t"]
        rehomed = resumed() - resumed0
        if rehomed >= len(subtree):
            # Resumption marker at the observed re-home completion so
            # the postmortem's span breakdown covers fault->re-home.
            flight_recorder.note("drill.resumed", rehomed=int(rehomed))
        # Phase C: verification traffic with FRESH names — forces full
        # negotiation rounds through every re-homed path.
        step_all("verify", post_steps,
                 lambda i: "relay.%s.v%d" % (fault, i), base=1000)
        # Postmortem: the merged dumps alone must name the dead relay,
        # and (when the subtree fully re-homed) the span breakdown
        # must sum to the measured fault->re-home window.
        postmortem = collect_postmortem(
            bb_dir, expect_relay=victim,
            measured_mttr_s=rehome_s if rehomed >= len(subtree)
            else None)
        record["postmortem"] = postmortem
        record.update({
            "rehomed": int(rehomed),
            "rehome_s": round(rehome_s, 3),
            "fatal_events": sorted(fatal_times),
            "hangs": hangs, "errors": errors,
            "results_bad": results_bad,
            "ok": (not hangs and not errors and not results_bad and
                   not fatal_times and rehomed >= len(subtree) and
                   rehome_s <= rehome_bound_s and
                   postmortem.get("ok", False)),
        })
        return record
    finally:
        try:
            world.close()
        except Exception:
            pass
        flight_recorder.reset()
        shutil.rmtree(bb_dir, ignore_errors=True)
        record["elapsed_s"] = round(time.monotonic() - t0, 3)


def run_relay_matrix(ranks: int = 8, fanout: int = 2, seed: int = 0,
                     faults=("kill", "wedge", "drop"),
                     whens=("idle", "negotiation", "replay"),
                     device="cuda") -> dict:
    """The fault x {relay, leaf} x phase matrix: relay victims ride
    run_relay_drill (the world must NOT break), leaf victims ride the
    MTTR drill in a fanout world (the world breaks and recovers, PR 6
    semantics, now with the fault signal crossing a relay hop)."""
    t0 = time.monotonic()
    cells = []
    for fault in faults:
        for when in whens:
            logger.info("relay drill: relay x %s x %s", fault, when)
            cells.append(run_relay_drill(fault=fault, when=when,
                                         ranks=ranks, fanout=fanout,
                                         seed=seed, device=device))
    leaf_faults = {"kill": "kill", "wedge": "wedge",
                   "drop": "conn_drop"}
    leaf_whens = {"idle": "idle", "negotiation": "during_negotiation",
                  "replay": "during_replay"}
    for fault in faults:
        for when in whens:
            logger.info("relay drill: leaf x %s x %s", fault, when)
            cell = run_mttr_drill(fault=leaf_faults[fault],
                                  when=leaf_whens[when], ranks=ranks,
                                  seed=seed, fanout=fanout,
                                  device=device)
            cell["victim_kind"] = "leaf"
            cells.append(cell)
    return {
        "kind": "relay_matrix", "ranks": ranks, "fanout": fanout,
        "seed": seed, "cells": cells,
        "ok": all(c.get("ok") for c in cells),
        "elapsed_s": round(time.monotonic() - t0, 3),
    }


# ---------------------------------------------------------------------------
# negotiation scale probe: protocol-only latency at 8-256 ranks
# ---------------------------------------------------------------------------

def run_negotiation_scale_probe(ranks: int, fanout: int,
                                rounds: int = 6,
                                payload_elems: int = 65) -> dict:
    """Full-negotiation round latency with N *lightweight* protocol
    clients (one socket each — no runtimes, no data plane, no threads
    per rank), through real relays when fanout > 0.  Two numbers per
    round:

    * ``wall_ms`` — last uplink sent -> every rank holds its RS frame
      (end-to-end; in this single-process simulation all relays share
      one core, so total work is O(ranks) regardless of topology);
    * ``root_broadcast_ms`` / ``root_sends`` / ``root_frames`` — the
      rank-0 coordinator's own serialized fan-out cost, the quantity
      the tree bounds to O(fanout) and the honest sub-linearity
      witness on a 1-core rig (on a cluster, relays run on their own
      hosts and the root's serialized path IS the latency)."""
    import struct as _struct

    from horovod_tpu_torch.common import relay as relay_mod
    from horovod_tpu_torch.common.controller_net import (CoordinatorServer,
                                                   _recv_frame,
                                                   _send_frame)
    from horovod_tpu_torch.common.message import (pack_request_list,
                                            RequestType)

    t0 = time.monotonic()
    server = CoordinatorServer(size=ranks, port=0, cache_capacity=0,
                               stall_warning_time_s=0.0,
                               fanout=fanout)
    plan = server._plan
    relays = {}
    socks = {}
    try:
        root_addr = "127.0.0.1:%d" % server.port
        if plan is not None:
            for rid in sorted(plan.relays,
                              key=lambda r: -plan.relays[r].level):
                chain = ["127.0.0.1:%d" % relays[a].port
                         for a in plan.relay_ancestors(rid)]
                chain.append(root_addr)
                relays[rid] = relay_mod.RelayServer(
                    rid, chain, depth_below=plan.relays[rid]
                    .depth_below)
        for rank in range(ranks):
            rid = plan.leaf_parent(rank) if plan is not None else None
            if rid is None:
                addr = ("127.0.0.1", server.port)
            else:
                addr = ("127.0.0.1", relays[rid].port)
            s = socket.create_connection(addr, timeout=10.0)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(30.0)
            _send_frame(s, b"RQ", _struct.pack("<i", rank))
            socks[rank] = s

        walls, bcasts, sends, frames = [], [], [], []
        for rnd in range(rounds):
            name = "scale.r%d" % rnd
            payloads = {}
            for rank in range(ranks):
                req = Request(
                    request_rank=rank,
                    request_type=RequestType.ALLREDUCE,
                    tensor_name=name,
                    tensor_shape=(payload_elems,),
                    tensor_type=dtype_of(np.zeros(1, np.float32)),
                    reduce_op="Sum")
                payloads[rank] = pack_request_list([req])
            b0, s0, f0 = server.bcast_ns, server.bcast_sends, \
                server.uplink_frames
            t_start = time.monotonic()
            for rank in range(ranks):
                _send_frame(socks[rank], b"RQ", payloads[rank])
            for rank in range(ranks):
                while True:
                    frame = _recv_frame(socks[rank])
                    if frame is None:
                        raise RuntimeError(
                            "rank %d link died mid-round" % rank)
                    if frame[0] == b"RS":
                        break
            walls.append(time.monotonic() - t_start)
            # Settle: the last client recv can race the coordinator's
            # own post-broadcast counter update by a few microseconds.
            time.sleep(0.003)
            bcasts.append((server.bcast_ns - b0) / 1e6)
            sends.append(server.bcast_sends - s0)
            frames.append(server.uplink_frames - f0)
        walls_ms = sorted(1e3 * w for w in walls)
        sends.sort()
        frames.sort()
        return {
            "ranks": ranks, "fanout": fanout, "rounds": rounds,
            "topology": plan.to_meta() if plan is not None
            else {"flat": True, "root_links": ranks},
            "wall_ms": {"median": round(walls_ms[len(walls_ms) // 2],
                                        3),
                        "max": round(walls_ms[-1], 3)},
            "root_broadcast_ms": round(
                sorted(bcasts)[len(bcasts) // 2], 4),
            "root_sends_per_round": sends[len(sends) // 2],
            "root_frames_per_round": frames[len(frames) // 2],
            "elapsed_s": round(time.monotonic() - t0, 2),
        }
    finally:
        for s in socks.values():
            try:
                _send_frame(s, b"RQ",
                            pack_request_list([], shutdown=True))
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        for rs in relays.values():
            try:
                rs.shutdown()
            except Exception:
                pass
        server.stop()


def run_scale_lane(sizes=(8, 64, 256), fanout: int = 8,
                   rounds: int = 6) -> dict:
    """The 8 -> 64 -> 256 negotiation-latency lane (bench.py records
    it in the BENCH artifact): tree vs flat star at every size, plus
    the growth ratios the regression gate watches.  Sub-linearity is
    asserted on the root's serialized fan-out cost (see
    run_negotiation_scale_probe for why that is the honest metric on
    a shared-core rig)."""
    t0 = time.monotonic()
    out = {"fanout": fanout, "sizes": {}}
    for n in sizes:
        eff_fanout = fanout if n - 1 > fanout else 0
        tree = run_negotiation_scale_probe(n, eff_fanout,
                                           rounds=rounds)
        flat = run_negotiation_scale_probe(n, 0, rounds=rounds)
        out["sizes"][str(n)] = {"tree": tree, "flat": flat}
    lo, hi = str(min(sizes)), str(max(sizes))
    rank_growth = max(sizes) / float(min(sizes))

    def growth(metric):
        a = out["sizes"][lo]["tree"][metric]
        b = out["sizes"][hi]["tree"][metric]
        if isinstance(a, dict):
            a, b = a["median"], b["median"]
        return round(b / a, 3) if a else None

    root_g = growth("root_broadcast_ms")
    wall_g = growth("wall_ms")
    out.update({
        "rank_growth": rank_growth,
        "root_broadcast_growth": root_g,
        "wall_growth": wall_g,
        # < 1.0 = latency grew slower than the world did.
        "root_growth_vs_ranks": round(root_g / rank_growth, 3)
        if root_g else None,
        "sublinear": bool(root_g is not None and
                          root_g < rank_growth),
        "root_sends_tree_vs_flat_at_max": [
            out["sizes"][hi]["tree"]["root_sends_per_round"],
            out["sizes"][hi]["flat"]["root_sends_per_round"]],
        "elapsed_s": round(time.monotonic() - t0, 2),
    })
    return out


def run_soak(ranks: int = 8, schedules: int = 5, seed: int = 0,
             n_ops: int = 30, hang_timeout_s: float = 30.0,
             stall_shutdown_s: float = 4.0,
             checkpoint_drill: bool = True,
             device="cuda") -> dict:
    """Run ``schedules`` seeded schedules; returns the full artifact
    dict.  ``ok`` is True iff no schedule hung, mis-reduced, or failed
    to recover — and, with ``checkpoint_drill``, iff every
    kill-and-resume drill (mid-epoch, mid-shard-write, mid-delta-write)
    restored bit-identical state from the last committed checkpoint."""
    t0 = time.monotonic()
    device = resolve_device(device)
    records = []
    for i in range(schedules):
        schedule = generate_schedule(seed, i, ranks)
        logger.info("chaos schedule %d/%d: %s", i + 1, schedules,
                    schedule["spec"])
        records.append(run_schedule(
            schedule, ranks, n_ops, hang_timeout_s=hang_timeout_s,
            stall_shutdown_s=stall_shutdown_s, device=device))
    latencies = [r["recovery_latency_s"] for r in records
                 if r["recovery_latency_s"] is not None]
    hist = metrics.Histogram("recovery_latency",
                             bounds=metrics.log_bounds(0.25, 2.0, 12))
    for lat in latencies:
        hist.observe(lat)
    bad = [r for r in records
           if r["outcome"] in ("hang", "incorrect", "recovery_failed")]
    drills = []
    if checkpoint_drill:
        for mode in ("mid_epoch", "mid_write", "mid_delta"):
            logger.info("checkpoint drill: %s", mode)
            drills.append(run_checkpoint_drill(mode, ranks=min(ranks, 4),
                                               seed=seed, device=device))
        bad.extend(d for d in drills if not d.get("ok"))
    return {
        "ranks": ranks,
        "seed": seed,
        "schedules": records,
        "checkpoint_drill": drills or None,
        "recovery_latency": {
            "count": len(latencies),
            "p50_s": _percentile(latencies, 50),
            "p90_s": _percentile(latencies, 90),
            "max_s": max(latencies) if latencies else None,
            "histogram": hist.snapshot() or None,
        },
        "outcomes": {o: sum(1 for r in records if r["outcome"] == o)
                     for o in sorted({r["outcome"] for r in records})},
        "metrics": metrics.snapshot(),
        "ok": not bad,
        "elapsed_s": round(time.monotonic() - t0, 3),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ranks", type=int, default=8)
    parser.add_argument("--schedules", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ops", type=int, default=30)
    parser.add_argument("--hang-timeout", type=float, default=30.0)
    parser.add_argument("--stall-shutdown", type=float, default=4.0)
    parser.add_argument("--no-ckpt-drill", action="store_true",
                        help="skip the checkpoint kill-and-resume "
                             "drills")
    parser.add_argument("--mttr", action="store_true",
                        help="run the MTTR drill matrix (kill/wedge/"
                             "transient-drop x idle/during-replay/"
                             "during-negotiation) instead of the "
                             "fault-schedule soak")
    parser.add_argument("--relay", action="store_true",
                        help="run the relay-tree failover matrix "
                             "(kill/wedge/drop x relay/leaf x "
                             "idle/negotiation/replay) instead of "
                             "the fault-schedule soak")
    parser.add_argument("--relay-scale", action="store_true",
                        help="run the single 64-rank (256 via "
                             "HOROVOD_CHAOS_SCALE_RANKS) relay "
                             "kill-mid-negotiation drill")
    parser.add_argument("--fanout", type=int, default=None,
                        help="relay arity (default: 2 for --relay, "
                             "8 for --relay-scale)")
    parser.add_argument("--autoscale", action="store_true",
                        help="run the closed-loop elasticity drill "
                             "matrix (grow 8->16 via policy scale-up, "
                             "checkpoint-first straggler migration, "
                             "shrink 16->8; synthetic + real-scorer "
                             "signal sources) instead of the "
                             "fault-schedule soak")
    parser.add_argument("--grow-to", type=int, default=None,
                        help="autoscale drill target size "
                             "(default: 2 * --ranks)")
    parser.add_argument("--serve-drill", action="store_true",
                        help="run the trainer-kill serving drill "
                             "(replica keeps answering from the last "
                             "committed step, resumes tailing after "
                             "the restart) instead of the "
                             "fault-schedule soak")
    parser.add_argument("--tune-drill", action="store_true",
                        help="run the autotune-then-freeze abort "
                             "drills (rank killed mid-search + "
                             "tune.propose failpoint) instead of the "
                             "fault-schedule soak")
    parser.add_argument("--out", default=None,
                        help="write the JSON artifact here")
    parser.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda",
                        help="where the data plane's tensors live "
                             "(default: the card)")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING)
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device is available (--device cpu runs "
                     "the soak on the host)")
    device = args.device
    if args.autoscale:
        report = run_autoscale_matrix(ranks=args.ranks,
                                      grow_to=args.grow_to or
                                      2 * args.ranks,
                                      seed=args.seed, device=device)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
        summary = {k: report.get(k) for k in
                   ("ranks", "grow_to", "autoscale_s", "ok",
                    "elapsed_s")}
        print("CHAOSJSON " + json.dumps(summary))
        return 0 if report["ok"] else 1
    if args.serve_drill:
        report = run_serve_drill(ranks=args.ranks, seed=args.seed,
                                 device=device)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
        summary = {k: report.get(k) for k in
                   ("ranks", "victim", "kill_commit",
                    "committed_before_kill", "served_during_gap",
                    "resumed_to", "reads", "torn_reads", "ok",
                    "elapsed_s")}
        print("CHAOSJSON " + json.dumps(summary))
        return 0 if report["ok"] else 1
    if args.tune_drill:
        report = {
            "kill": run_tune_kill_drill(mode="kill",
                                        ranks=args.ranks,
                                        seed=args.seed, device=device),
            "failpoint": run_tune_kill_drill(mode="failpoint",
                                             ranks=args.ranks,
                                             seed=args.seed,
                                             device=device),
        }
        report["ok"] = all(r["ok"] for r in report.values())
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
        summary = {m: {k: r.get(k) for k in
                       ("phase", "abort_reason", "knobs_consistent",
                        "ok")}
                   for m, r in report.items() if isinstance(r, dict)}
        summary["ok"] = report["ok"]
        print("CHAOSJSON " + json.dumps(summary))
        return 0 if report["ok"] else 1
    if args.relay:
        report = run_relay_matrix(ranks=args.ranks,
                                  fanout=args.fanout or 2,
                                  seed=args.seed, device=device)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
        summary = {k: report[k] for k in ("ranks", "fanout", "ok",
                                          "elapsed_s")}
        print("CHAOSJSON " + json.dumps(summary))
        return 0 if report["ok"] else 1
    if args.relay_scale:
        ranks = int(env_mod.env_str("HOROVOD_CHAOS_SCALE_RANKS", "64"))
        fanout = args.fanout or 8
        report = run_relay_drill(fault="kill", when="negotiation",
                                 ranks=ranks, fanout=fanout,
                                 seed=args.seed, device=device)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
        summary = {k: report.get(k) for k in
                   ("ranks", "fanout", "rehomed", "rehome_s",
                    "rehome_bound_s", "ok", "elapsed_s")}
        print("CHAOSJSON " + json.dumps(summary))
        return 0 if report["ok"] else 1
    if args.mttr:
        report = run_mttr_matrix(ranks=args.ranks, seed=args.seed,
                                 device=device)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
        summary = {k: report[k] for k in ("ranks", "seed", "mttr_s",
                                          "detect_s", "ok",
                                          "elapsed_s")}
        print("CHAOSJSON " + json.dumps(summary))
        return 0 if report["ok"] else 1
    report = run_soak(ranks=args.ranks, schedules=args.schedules,
                      seed=args.seed, n_ops=args.ops,
                      hang_timeout_s=args.hang_timeout,
                      stall_shutdown_s=args.stall_shutdown,
                      checkpoint_drill=not args.no_ckpt_drill,
                      device=device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    summary = {k: report[k] for k in ("ranks", "seed", "outcomes",
                                      "recovery_latency", "ok",
                                      "elapsed_s")}
    print("CHAOSJSON " + json.dumps(summary))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
