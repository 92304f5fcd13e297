"""Distributed optimizers for PyTorch.

Reference: torch/optimizer.py — ``_DistributedOptimizer`` registers a
per-parameter hook that fires an async allreduce the moment a gradient
is accumulated (:110-207), ``synchronize()`` drains the handles before
``step()`` (:209-236), ``backward_passes_per_step`` delays communication
(:71-73), and ``_DistributedAdasumOptimizer`` (:279) reduces parameter
*deltas* with the Adasum rule instead of gradients.

Counterpart of :mod:`horovod_tpu.torch.optimizer`: hooks use
``register_post_accumulate_grad_hook`` (torch ≥ 2.1) instead of the
grad-accumulator expand trick; the async handle is a
:class:`horovod_tpu_torch.ops.Handle` future resolved by the background
runtime; gradients and deltas stay on their device throughout.

Under elastic training (``HOROVOD_ELASTIC=1``) the hooks are registered
at any world size, as upstream Horovod does, since the world can grow
past one; a world of one reduces nothing and ``synchronize`` re-arms the
hooks.  ``reset_optimizers`` (called by ``torch.elastic.run``'s reset)
drops the handles a failed step left behind.  Outside elastic runs the
optimizer behaves as the JAX package's does.
"""

import logging
import weakref
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

from ..common import basics
from ..common import env as env_mod
from ..common.basics import (Adasum, Average, Sum, ProcessSet,
                             global_process_set)
from .. import ops as _ops
from .compression import Compression

logger = logging.getLogger("horovod_tpu_torch.torch")

# Every live _DistributedOptimizer, for reset_optimizers.
_live_optimizers = weakref.WeakSet()


def reset_optimizers():
    """Drop the in-flight handles of every live ``DistributedOptimizer``
    and re-arm its hooks.  An elastic reset calls it between shutdown and
    init: the handles of a step that died with the old world would
    otherwise make the next backward's hooks raise."""
    for opt in list(_live_optimizers):
        opt._reset_handles()


class _DistributedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step=1, op=Average,
                 gradient_predivide_factor=1.0, groups=None,
                 sparse_as_dense=False,
                 process_set=global_process_set):
        super(self.__class__, self).__init__(params)

        if named_parameters is not None:
            named_parameters = list(named_parameters)
        else:
            named_parameters = [(f"allreduce.noname.{i}.{j}", v)
                                for i, group in enumerate(self.param_groups)
                                for j, v in enumerate(group["params"])]
        self._parameter_names = {v: k for k, v in named_parameters}
        self._compression = compression
        self._op = op
        self._gradient_predivide_factor = gradient_predivide_factor
        self._process_set = process_set
        self.backward_passes_per_step = backward_passes_per_step
        self._handles: Dict[torch.Tensor, tuple] = {}
        self._grad_accs = []
        self._requires_update = set()
        self._synchronized = False
        self._should_synchronize = True
        self._allreduce_delay: Dict[torch.Tensor, int] = {}
        if self._process_set.size() > 1 or \
                env_mod.env_bool(env_mod.HOROVOD_ELASTIC):
            self._register_hooks()
        _live_optimizers.add(self)

    def _register_hooks(self):
        for param_group in self.param_groups:
            for p in param_group["params"]:
                if p.requires_grad:
                    self._requires_update.add(p)
                    self._allreduce_delay[p] = self.backward_passes_per_step
                    acc = p.register_post_accumulate_grad_hook(
                        self._make_hook(p))
                    self._grad_accs.append(acc)

    def _make_hook(self, p):
        def hook(*ignore):
            if p in self._handles and self._handles[p][0] is not None:
                if self._allreduce_delay[p] <= 0:
                    raise AssertionError(
                        "Gradients were computed more than "
                        "backward_passes_per_step times before call to "
                        "step(). Increase backward_passes_per_step to "
                        "accumulate gradients locally.")
            assert not p.grad.requires_grad
            self._allreduce_delay[p] -= 1
            handle, ctx = None, None
            if self._allreduce_delay[p] == 0 and \
                    self._process_set.size() > 1:
                handle, ctx = self._allreduce_grad_async(p)
            self._handles[p] = (handle, ctx)
        return hook

    def _allreduce_grad_async(self, p):
        name = self._parameter_names.get(p)
        if self._op == Average:
            prescale = 1.0 / self._gradient_predivide_factor
            postscale = self._gradient_predivide_factor / \
                self._process_set.size()
            reduce_op = Sum
        else:
            prescale, postscale, reduce_op = 1.0, 1.0, self._op
        compressed, ctx = self._compression.compress(p.grad.detach())
        handle = _ops.allreduce_async(
            compressed, name=f"grad/{name}", op=reduce_op,
            prescale_factor=prescale, postscale_factor=postscale,
            process_set=self._process_set)
        return handle, ctx

    def synchronize(self):
        """Drain all in-flight gradient reductions (reference:
        torch/optimizer.py:209-236)."""
        if self._process_set.size() <= 1:
            # Nothing to reduce; hooks registered for an elastic world
            # that shrank to one rank are re-armed for the next step.
            self._reset_handles()
            self._synchronized = True
            return
        # Fire any parameters whose hooks never ran (unused in this
        # step) so negotiation completes for all ranks.
        missing = [p for p in self._requires_update
                   if p not in self._handles]
        for p in missing:
            if p.grad is None:
                p.grad = p.data.new_zeros(p.shape)
            handle, ctx = self._allreduce_grad_async(p)
            self._handles[p] = (handle, ctx)
        for p, (handle, ctx) in list(self._handles.items()):
            if handle is None:
                handle, ctx = self._allreduce_grad_async(p)
                self._handles[p] = (handle, ctx)
        for p, (handle, ctx) in self._handles.items():
            result = handle.wait()
            self._allreduce_delay[p] = self.backward_passes_per_step
            out = self._compression.decompress(result, ctx)
            p.grad.copy_(out.reshape(p.grad.shape))
        self._handles.clear()
        self._synchronized = True

    def _reset_handles(self):
        self._handles.clear()
        for p in self._allreduce_delay:
            self._allreduce_delay[p] = self.backward_passes_per_step
        self._synchronized = False

    @contextmanager
    def skip_synchronize(self):
        """User already called synchronize(); don't re-sync in step()."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            if self._synchronized:
                logger.warning(
                    "optimizer.step() called without a new backward "
                    "pass after synchronize(); use skip_synchronize() "
                    "to suppress the duplicate reduction.")
            self.synchronize()
        self._synchronized = False
        return super(self.__class__, self).step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() "
                "but before optimizer.step() or optimizer.synchronize(). "
                "This is prohibited as it can cause a race condition.")
        return super(self.__class__, self).zero_grad(*args, **kwargs)


class _DistributedAdasumOptimizer(torch.optim.Optimizer):
    """Adasum delta-reduction optimizer (reference:
    torch/optimizer.py:279 — apply the local step first, then Adasum-
    combine the parameter *deltas* across ranks)."""

    def __init__(self, params, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step=1):
        super(self.__class__, self).__init__(params)
        if named_parameters is not None:
            named_parameters = list(named_parameters)
        else:
            named_parameters = [(f"adasum.noname.{i}.{j}", v)
                                for i, group in enumerate(self.param_groups)
                                for j, v in enumerate(group["params"])]
        self._parameter_names = {v: k for k, v in named_parameters}
        self._compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self._step_count = 0
        self._grad_accum: Dict[torch.Tensor, torch.Tensor] = {}

    def step(self, closure=None):
        self._step_count += 1
        if self.backward_passes_per_step > 1:
            # Fold this pass's gradients into a local buffer and zero
            # p.grad, so every batch contributes exactly once to the
            # eventual Adasum step regardless of whether the caller
            # zero_grad()s between passes (reference: torch/optimizer.py
            # backward_passes_per_step local accumulation).
            with torch.no_grad():
                for group in self.param_groups:
                    for p in group["params"]:
                        if p.grad is None:
                            continue
                        buf = self._grad_accum.get(p)
                        if buf is None:
                            self._grad_accum[p] = p.grad.detach().clone()
                        else:
                            buf.add_(p.grad)
                        p.grad.zero_()
            if self._step_count % self.backward_passes_per_step != 0:
                return None
            with torch.no_grad():
                for p, buf in self._grad_accum.items():
                    if p.grad is None:
                        p.grad = buf.clone()
                    else:
                        p.grad.copy_(buf)
            self._grad_accum.clear()
        # Save pre-step parameters, apply the local update, then
        # Adasum-reduce the deltas and re-apply.
        starts = {}
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    starts[p] = p.detach().clone()
        loss = super(self.__class__, self).step(closure)
        handles = []
        tensors = []
        for group in self.param_groups:
            for p in group["params"]:
                if p in starts:
                    delta = p.detach() - starts[p]
                    name = self._parameter_names.get(p)
                    handles.append(_ops.allreduce_async(
                        delta, name=f"adasum_delta/{name}", op=Adasum))
                    tensors.append(p)
        for p, h in zip(tensors, handles):
            combined = h.wait()
            with torch.no_grad():
                p.copy_(starts[p] + combined.to(p.dtype).reshape(p.shape))
        return loss


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step=1, op=Average,
                         gradient_predivide_factor=1.0,
                         num_groups=None, groups=None,
                         sparse_as_dense=False,
                         process_set=global_process_set):
    """Wrap a torch optimizer for data-parallel training (reference:
    torch/optimizer.py DistributedOptimizer factory — dynamic subclass
    so isinstance(opt, type(inner)) still holds)."""
    if op == Adasum:
        cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
                   dict(_DistributedAdasumOptimizer.__dict__))
        return cls(optimizer.param_groups, named_parameters, compression,
                   backward_passes_per_step)
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step, op, gradient_predivide_factor,
               groups or num_groups, sparse_as_dense, process_set)
