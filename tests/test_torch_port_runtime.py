"""The background runtime's cycle of the port against the JAX package's:
the stall inspector's record of the requests a cycle sends.

The recv thread completes a tensor, and removes it from the stall
inspector, the moment the coordinator's response arrives, which may be
while the background thread is still inside ``compute_response_list``.
The port records a cycle's requests before they go out (as both
packages' inline cache-hit path does), so a completed tensor leaves no
record; the JAX package records them afterwards and keeps one, which a
later ``check()`` reports as a stall.
"""

import types

import pytest

from horovod_tpu.common import runtime as ref_runtime
from horovod_tpu.common import stall_inspector as ref_stall
from horovod_tpu_torch.common import runtime
from horovod_tpu_torch.common import stall_inspector

PKGS = {"port": (runtime, stall_inspector),
        "jax": (ref_runtime, ref_stall)}


class _Queue:
    """The tensor queue of one cycle: ``requests`` are pending."""

    def __init__(self, requests):
        self._pending = list(requests)

    def pop_pending(self):
        pending, self._pending = self._pending, []
        return pending

    def outstanding(self):
        return len(self._pending)

    def push_back(self, leftovers):
        self._pending.extend(leftovers)


class _Controller:
    """Answers a cycle; with ``complete`` the recv thread has already
    run the response of every request (and removed it from the stall
    inspector) by the time ``compute_response_list`` returns."""

    def __init__(self, rt, complete: bool):
        self.rt, self.complete = rt, complete

    def compute_response_list(self, pending, sizes, threshold):
        if self.complete:
            for req in pending:
                self.rt.stall_inspector.remove(req.tensor_name)
        return [], []


def _cycle(pkg: str, complete: bool) -> dict:
    """One background cycle of ``pkg``'s runtime at rank 0 of two, with
    one pending request; returns the stall inspector's records."""
    mod, stall = PKGS[pkg]
    rt = object.__new__(mod.BackgroundRuntime)
    rt.state = types.SimpleNamespace(
        rank_info=types.SimpleNamespace(rank=0, size=2),
        knobs=types.SimpleNamespace(fusion_threshold_bytes=1 << 20))
    rt.timeline = None
    rt._entry_sizes = {}
    rt.stall_inspector = stall.StallInspector(
        warning_time_s=60.0, shutdown_time_s=0.0, world_size=2)
    req = types.SimpleNamespace(tensor_name="grad.w", request_rank=0)
    rt.tensor_queue = _Queue([req])
    rt.controller = _Controller(rt, complete)
    rt._run_once()
    return {name: sorted(ranks) for name, (_, ranks)
            in rt.stall_inspector._uncompleted.items()}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_a_pending_request_is_recorded(pkg):
    assert _cycle(pkg, complete=False) == {"grad.w": [0]}


def test_a_tensor_completed_during_the_cycle_is_not_kept():
    assert _cycle("port", complete=True) == {}
    # The JAX package records it after the recv thread removed it.
    assert _cycle("jax", complete=True) == {"grad.w": [0]}
