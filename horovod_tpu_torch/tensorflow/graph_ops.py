"""In-graph TF collectives: the compiled path for ``tf.function``.

The reference's TF binding is a native AsyncOpKernel that keeps
collectives inside the executed graph (reference:
tensorflow/mpi_ops.cc:374-428 HorovodAllreduceOp).  The equivalent
here lowers ``hvd.allreduce``/``allgather``/``broadcast``/
``reducescatter`` inside a traced ``tf.function`` to TensorFlow's own
collective ops (``CollectiveReduceV2`` et al.) over a gRPC worker
cluster wired from the launcher env contract — no per-step
``tf.py_function`` host hop, so the whole train step stays one
compiled graph.  Counterpart of :mod:`horovod_tpu.tensorflow.graph_ops`,
copied whole: only the control-plane object gather is the port's
(:func:`horovod_tpu_torch.torch.allgather_object`).

Constraints inherited from TF:

- The collective context must be enabled BEFORE any TF op runs
  (enabling re-initializes the eager context and invalidates existing
  tensors/variables).  ``horovod_tpu_torch.tensorflow.init()`` does it
  automatically when the TF context is still fresh; otherwise call
  :func:`enable_graph_collectives` right after ``hvd.init()`` and
  before building the model, or traced ops fall back to
  ``tf.py_function``.
- Instance keys are assigned in trace order, which must match across
  ranks — the same SPMD program-order contract TF's own
  MultiWorkerMirroredStrategy relies on.  The eager path (negotiated,
  order-independent) is unaffected.
"""

import hashlib
import logging
import os
import socket
import threading

import tensorflow as tf

from ..common import basics
from ..common import env as env_mod
from ..common.basics import (Adasum, Average, Max, Min, Product, Sum,
                             global_process_set)

logger = logging.getLogger("horovod_tpu_torch.tensorflow")

_MERGE_FINAL = {
    Sum: ("Add", "Id"),
    Average: ("Add", "Div"),
    Min: ("Min", "Id"),
    Max: ("Max", "Id"),
    Product: ("Mul", "Id"),
}

# Dtypes TF's CPU collective kernels accept.
_SUPPORTED_DTYPES = (tf.float16, tf.bfloat16, tf.float32, tf.float64,
                     tf.int32, tf.int64)


class _GraphCollectives:
    def __init__(self):
        self._lock = threading.Lock()
        self._enabled = False
        self._failed = False
        self._instance_key = 1000
        self._group_keys = {}          # tuple(ranks) -> group key
        self._next_group_key = 2
        self.timeout = env_mod.env_float(
            "HOROVOD_TF_COLLECTIVE_TIMEOUT", 0.0)
        # Read once: the kill switch participates in the enable vote,
        # so a rank-asymmetric setting degrades every rank to
        # py_function instead of deadlocking graph ranks against
        # py_function ranks.
        self.env_enabled = env_mod.env_str(
            "HOROVOD_TF_GRAPH_COLLECTIVES", "1").strip().lower() \
            not in ("0", "false", "off")
        # Debug: trace-time key-agreement verification (see key_check).
        self.key_check_enabled = env_mod.env_bool(
            "HOROVOD_TF_COLLECTIVE_KEY_CHECK")
        self._check_seq = 0
        self._key_hash = ""

    def effective_timeout(self) -> float:
        # A peer dying right before a collective can leave the
        # survivors waiting forever (no connection reset to unblock
        # them); elastic needs a bounded wait so the retry loop gets
        # control.  Evaluated per trace (not snapshotted) for the same
        # reason as elastic_graph below.
        if self.timeout:
            return self.timeout
        return 30.0 if self.elastic_graph else 0.0

    @property
    def elastic_graph(self) -> bool:
        """Opt-in elastic mode: graph collectives survive a resize by
        a FULL TF context reset + cluster re-formation on every
        elastic reset (see reset_graph_collectives).  Opt-in because
        the context reset invalidates all live TF objects — user code
        must rebuild model/functions in on_reset (State.rebuild
        re-points the snapshots).  Read per call, not snapshotted at
        import: programs commonly set the env var from their own CLI
        flags after this module is already imported."""
        return env_mod.env_bool("HOROVOD_TF_ELASTIC_GRAPH")

    # -- lifecycle -------------------------------------------------------
    def enable(self) -> bool:
        """Collective call: every rank of the global process set must
        enter (the feasibility vote and address exchange ride the eager
        control plane)."""
        with self._lock:
            if self._enabled:
                return True
            if self._failed:
                return False
            try:
                self._do_enable()
                self._enabled = True
            except Exception as e:
                self._failed = True
                logger.warning(
                    "TF graph collectives unavailable (%s); traced "
                    "collectives fall back to tf.py_function", e)
            return self._enabled

    def _do_enable(self):
        from tensorflow.python.eager import context
        from tensorflow.core.protobuf import (cluster_pb2, config_pb2,
                                              tensorflow_server_pb2)
        from ..runner.http_server import find_ports
        from ..torch import allgather_object

        size, rank = basics.size(), basics.rank()
        if size == 1:
            raise RuntimeError("single process")
        if basics._state().knobs.elastic and not self.elastic_graph:
            raise RuntimeError(
                "graph collectives are incompatible with elastic runs "
                "(group sizes are baked into traced graphs); set "
                "HOROVOD_TF_ELASTIC_GRAPH=1 to opt into context-reset "
                "re-formation on resize (model must be rebuilt in "
                "on_reset)")
        # The enable decision must be unanimous: a rank whose TF
        # context is already live cannot join the cluster (enabling
        # would invalidate its existing tensors), a rank with the kill
        # switch set must not be left behind on py_function, and a
        # split decision would deadlock graph-collective ranks against
        # py_function ranks. One control-plane round settles it.
        local_ok = (self.env_enabled
                    and context.context()._context_handle is None)
        votes = allgather_object(bool(local_ok),
                                 name="tf_graph_collectives.vote")
        if not all(votes):
            raise RuntimeError(
                f"graph collectives vetoed by rank(s) "
                f"{[i for i, v in enumerate(votes) if not v]} (TF "
                "context already initialized there, or "
                "HOROVOD_TF_GRAPH_COLLECTIVES=0); call "
                "enable_graph_collectives() before any TF op")
        (port,) = find_ports(1)
        # The cluster spec is exchanged over the eager control plane
        # (negotiated allgather), so it works under any launcher.
        addrs = allgather_object(f"{self._my_ip()}:{port}",
                                 name="tf_graph_collectives.addrs")
        cluster = cluster_pb2.ClusterDef()
        job = cluster.job.add()
        job.name = "worker"
        for i, addr in enumerate(addrs):
            job.tasks[i] = addr
        cfg = config_pb2.ConfigProto()
        cfg.experimental.collective_group_leader = \
            "/job:worker/replica:0/task:0"
        server_def = tensorflow_server_pb2.ServerDef(
            cluster=cluster, job_name="worker", task_index=rank,
            protocol="grpc", port=port, default_session_config=cfg)
        # The local bring-up can still fail after a passing vote (e.g.
        # the gRPC port was snatched between find_ports and bind), so
        # the OUTCOME is agreed too: unless every rank succeeded, all
        # ranks use the py_function path.
        try:
            context.context().enable_collective_ops(server_def)
            ok = True
        except Exception as e:
            logger.warning("collective-ops bring-up failed locally: %s",
                           e)
            ok = False
        outcomes = allgather_object(ok,
                                    name="tf_graph_collectives.outcome")
        if not all(outcomes):
            raise RuntimeError(
                f"collective-ops bring-up failed on rank(s) "
                f"{[i for i, v in enumerate(outcomes) if not v]}; all "
                "ranks fall back to the py_function path")
        self.device = f"/job:worker/replica:0/task:{rank}/device:CPU:0"
        # Fail-fast wiring: when the control plane dies mid-run (a
        # peer hard-died in an elastic resize), abort in-flight TF
        # collectives so the user thread unwinds NOW instead of
        # riding out timeout_seconds while the rest of the world
        # tears down.
        runtime = getattr(basics._state(), "runtime", None)
        if runtime is not None and hasattr(runtime,
                                           "add_fatal_listener"):
            def abort_tf_collectives(err):
                try:
                    context.context().abort_collective_ops(
                        14,  # UNAVAILABLE
                        f"horovod control plane failed: {err}")
                except Exception:
                    pass
            runtime.add_fatal_listener(abort_tf_collectives)

    @staticmethod
    def _my_ip() -> str:
        ctrl = env_mod.env_str_opt("HOROVOD_CONTROLLER_ADDR")
        if ctrl:
            host, _, port = ctrl.rpartition(":")
            try:
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                s.connect((host, int(port)))
                ip = s.getsockname()[0]
                s.close()
                return ip
            except OSError:
                pass
        return "127.0.0.1"

    # -- key management --------------------------------------------------
    def usable(self, process_set, dtype=None) -> bool:
        if not self.env_enabled:
            return False
        # Elastic runs resize the world; traced graphs bake group_size
        # and the gRPC cluster at trace time, so reused graphs would
        # execute stale collectives after a resize. Elastic stays on
        # the execution-time (py_function) path — unless the user
        # opted into context-reset re-formation
        # (HOROVOD_TF_ELASTIC_GRAPH=1, see reset_graph_collectives).
        if basics.is_initialized() and basics._state().knobs.elastic \
                and not self.elastic_graph:
            return False
        if dtype is not None and tf.as_dtype(dtype) not in _SUPPORTED_DTYPES:
            return False
        if basics.size() == 1:
            return True     # identity lowering, no cluster needed
        if not process_set.included(basics.rank()):
            return False
        # No lazy enabling here: usable() is called at trace time, when
        # ranks may disagree (non-members of a process set, contexts in
        # different states) — a blocking collective enable from here
        # could deadlock. The cluster comes up in init() /
        # enable_graph_collectives(), which are documented collective
        # calls.
        return self._enabled

    def group(self, process_set):
        """(group_key, group_size) for a process set."""
        if process_set is global_process_set or \
                process_set.ranks is None:
            return 1, basics.size()
        key = tuple(sorted(process_set.ranks))
        with self._lock:
            if key not in self._group_keys:
                self._group_keys[key] = self._next_group_key
                self._next_group_key += 1
            return self._group_keys[key], len(key)

    def next_instance_key(self) -> int:
        # Trace-order assignment; identical across ranks tracing the
        # same program (see module docstring).
        with self._lock:
            self._instance_key += 1
            return self._instance_key

    def key_check(self, kind: str, instance_key: int, group_key: int,
                  dtype, shape, name):
        """Trace-time divergence detector (debug knob
        ``HOROVOD_TF_COLLECTIVE_KEY_CHECK=1``).

        Instance keys are assigned in trace order; rank-divergent
        conditional tracing silently pairs DIFFERENT collectives under
        the SAME key and deadlocks (or corrupts) at execution time.
        With the knob set, every emitted collective allgathers a
        record of (kind, instance key, group key, dtype, shape) plus
        a rolling hash of the whole emission history over the eager
        control plane, and raises at the FIRST divergent op — naming
        it — instead of hanging in TF's collective executor.  The
        reference does the analogous validation on the coordinator
        (controller.cc:471-748 shape/dtype mismatch -> ERROR
        response).

        The exchange is sequence-numbered (not keyed by instance key)
        so ranks that disagree on keys still meet in the same
        negotiation round.  If a rank stops emitting entirely, the
        other ranks' next exchange parks in the negotiated allgather,
        where the stall inspector attributes the missing rank — still
        strictly better than a bare TF deadlock.  Trace-time only:
        zero cost at step time.
        """
        if not self.key_check_enabled or basics.size() == 1:
            return
        from ..torch import allgather_object

        with self._lock:
            seq = self._check_seq
            self._check_seq += 1
            rec = (kind, instance_key, group_key, str(dtype),
                   str(tuple(shape) if shape is not None else None),
                   str(name or ""))
            self._key_hash = hashlib.sha256(
                (self._key_hash + repr(rec)).encode()).hexdigest()
            payload = (self._key_hash, rec)
        views = allgather_object(
            payload, name=f"tf_graph_collectives.keycheck.{seq}")
        # Equality is judged on the RECORDS (each emission is checked
        # in sequence, so the first divergent op trips here); the
        # rolling hash is carried as context only — judging on it too
        # would poison every later, agreeing trace after a detected
        # divergence.
        if all(v[1] == views[0][1] for v in views):
            return
        lines = [
            f"  rank {i}: {'DIVERGED ' if v[1] != views[0][1] else ''}"
            f"{v[1][0]} instance_key={v[1][1]} group_key={v[1][2]} "
            f"dtype={v[1][3]} shape={v[1][4]} name={v[1][5]} "
            f"history={v[0][:12]}" for i, v in enumerate(views)]
        raise RuntimeError(
            "rank-divergent tf.function tracing detected at traced "
            f"collective #{seq} (this rank: {kind} of {name or rec}) "
            "— ranks are emitting different collective sequences, "
            "which would deadlock at execution time. Make traced "
            "control flow identical across ranks (no rank-dependent "
            "conditionals around hvd ops).\n" + "\n".join(lines))


_ctx = _GraphCollectives()


def enable_graph_collectives() -> bool:
    """Set up TF's collective-ops cluster so hvd ops inside
    ``tf.function`` compile to in-graph collectives.  Collective call:
    every rank must enter, before the first TF op of the process.
    Returns False (with a warning) when unavailable."""
    if basics.size() == 1:
        return True
    return _ctx.enable()


def reset_graph_collectives() -> bool:
    """Re-form the collective cluster at the CURRENT world size after
    an elastic resize.  Collective call: every post-resize rank must
    enter (the elastic reset path does this automatically under
    ``HOROVOD_TF_ELASTIC_GRAPH=1``).

    TF refuses to shrink a live cluster (``update_server_def``
    rejects removed tasks), so survival goes through a FULL eager
    context reset: every live TF tensor/variable/function dies, a
    fresh context enables collective ops against the new cluster, and
    user code rebuilds its model/functions in ``on_reset`` (elastic
    State snapshots are numpy and survive; ``State.rebuild`` re-points
    them at the fresh objects).  The reference never solved this —
    its elastic TF path re-creates graphs per reset too (exec-time
    size ops, tensorflow/mpi_ops.py:327-391); the context reset is
    the TF2-collective-ops equivalent."""
    global _ctx
    from tensorflow.python.eager import context
    if context.context()._context_handle is not None:
        context._reset_context()
    _ctx = _GraphCollectives()
    if basics.size() == 1:
        return True
    return _ctx.enable()


def reset_graph_collectives_for_testing():
    global _ctx
    _ctx = _GraphCollectives()


# ---------------------------------------------------------------------------
# graph-mode emitters (callers guarantee usable() returned True)
# ---------------------------------------------------------------------------

def _scaled(tensor, factor):
    if factor == 1.0:
        return tensor
    return tensor * tf.cast(factor, tensor.dtype)


def allreduce_graph(tensor, op, prescale_factor, postscale_factor,
                    process_set):
    if op not in _MERGE_FINAL:
        raise NotImplementedError(
            f"op {op} has no in-graph lowering (Adasum stays on the "
            "negotiated eager path)")
    group_key, group_size = _ctx.group(process_set)
    tensor = _scaled(tensor, prescale_factor)
    if group_size == 1:
        return _scaled(tensor, postscale_factor)
    merge_op, final_op = _MERGE_FINAL[op]
    ikey = _ctx.next_instance_key()
    _ctx.key_check("allreduce", ikey, group_key, tensor.dtype,
                   tensor.shape, getattr(tensor, "name", None))
    out = tf.raw_ops.CollectiveReduceV2(
        input=tensor, group_size=group_size, group_key=group_key,
        instance_key=ikey, ordering_token=[],
        merge_op=merge_op, final_op=final_op,
        communication_hint="ring", timeout_seconds=_ctx.effective_timeout())
    return _scaled(out, postscale_factor)


def grouped_allreduce_graph(tensors, op, prescale_factor,
                            postscale_factor, process_set):
    return [allreduce_graph(t, op, prescale_factor, postscale_factor,
                            process_set) for t in tensors]


def allgather_graph(tensor, process_set):
    group_key, group_size = _ctx.group(process_set)
    if group_size == 1:
        return tf.identity(tensor)
    ikey = _ctx.next_instance_key()
    _ctx.key_check("allgather", ikey, group_key, tensor.dtype,
                   tensor.shape, getattr(tensor, "name", None))
    return tf.raw_ops.CollectiveGatherV2(
        input=tensor, group_size=group_size, group_key=group_key,
        instance_key=ikey, ordering_token=[],
        communication_hint="ring", timeout_seconds=_ctx.effective_timeout())


def broadcast_graph(tensor, root_rank, process_set):
    group_key, group_size = _ctx.group(process_set)
    if group_size == 1:
        return tf.identity(tensor)
    ikey = _ctx.next_instance_key()
    _ctx.key_check("broadcast", ikey, group_key, tensor.dtype,
                   tensor.shape, getattr(tensor, "name", None))
    kwargs = dict(group_size=group_size, group_key=group_key,
                  instance_key=ikey,
                  communication_hint="ring",
                  timeout_seconds=_ctx.effective_timeout())
    if basics.rank() == root_rank:
        return tf.raw_ops.CollectiveBcastSendV2(input=tensor, **kwargs)
    return tf.raw_ops.CollectiveBcastRecvV2(
        T=tensor.dtype, shape=tf.shape(tensor), **kwargs)


def reducescatter_graph(tensor, op, process_set):
    if op not in (Sum, Average):
        raise NotImplementedError("reducescatter supports Sum/Average")
    group_key, group_size = _ctx.group(process_set)
    if group_size == 1:
        return tf.identity(tensor)
    merge_op, final_op = _MERGE_FINAL[op]
    ikey = _ctx.next_instance_key()
    _ctx.key_check("reducescatter", ikey, group_key, tensor.dtype,
                   tensor.shape, getattr(tensor, "name", None))
    return tf.raw_ops.CollectiveReduceScatterV2(
        input=tensor, group_size=group_size, group_key=group_key,
        instance_key=ikey, ordering_token=[],
        merge_op=merge_op, final_op=final_op,
        communication_hint="ring", timeout_seconds=_ctx.effective_timeout())
