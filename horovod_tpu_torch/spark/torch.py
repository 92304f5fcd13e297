"""TorchEstimator: fit a PyTorch model to a DataFrame on distributed
workers (reference: spark/torch/estimator.py:91 — TorchEstimator /
TorchModel; remote-trainer semantics from spark/torch/remote.py:36-200:
restore from the last checkpoint state, broadcast parameters and
optimizer state from rank 0, hvd.DistributedOptimizer training loop,
per-epoch checkpoint through the Store).

Counterpart of :mod:`horovod_tpu.spark.torch`, on the port's binding
(:mod:`horovod_tpu_torch.torch`).  The ``device`` param places the net
and its batches: ``None`` means each rank's card, chosen by
``hvd.init()``, and with no card the estimator raises before any worker
starts; pass ``device="cpu"`` to train on the CPU.  The state bytes in
the Store and in the fitted model hold CPU tensors, so a CPU-only driver
and the JAX package's estimator load them as they are.
"""

import io
from typing import List

from .estimator import (HorovodEstimator, HorovodModel, checkpoint_epoch,
                        save_checkpoint)
from . import util


def _state_to_bytes(model, optimizer=None) -> bytes:
    import torch
    from ..torch import _to_cpu
    buf = io.BytesIO()
    payload = {"model": model.state_dict()}
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    torch.save(_to_cpu(payload), buf)
    return buf.getvalue()


def _state_from_bytes(raw: bytes, map_location=None):
    import torch
    return torch.load(io.BytesIO(raw), map_location=map_location,
                      weights_only=False)


def _device(device):
    from ..models.gpt import resolve_device
    return resolve_device(device)


class _Trainer:
    """The remote trainer: one call trains on one rank, on ``device``
    (``None``: the card that ``hvd.init()`` gave the rank)."""

    def __init__(self, store, meta, resume_state, feature_cols, label_cols,
                 epochs, batch_size, seed, model, loss_fn, opt_cls,
                 opt_defaults, start_epoch, run_id, device):
        self.__dict__.update(
            store=store, meta=meta, resume_state=resume_state,
            feature_cols=feature_cols, label_cols=label_cols,
            epochs=epochs, batch_size=batch_size, seed=seed, model=model,
            loss_fn=loss_fn, opt_cls=opt_cls, opt_defaults=opt_defaults,
            start_epoch=start_epoch, run_id=run_id, device=device)

    def __call__(self):
        import itertools
        import torch
        from .. import torch as hvd

        hvd.init()
        # After init, which sets this rank's card.
        device = _device(self.device)
        rank, size = hvd.rank(), hvd.size()
        torch.manual_seed(self.seed)
        feature_cols, store = self.feature_cols, self.store
        cols = feature_cols + self.label_cols
        net = self.model.to(device)
        optimizer = hvd.DistributedOptimizer(
            self.opt_cls(net.parameters(), **self.opt_defaults),
            named_parameters=net.named_parameters())
        if self.resume_state is not None:
            state = _state_from_bytes(self.resume_state, device)
            net.load_state_dict(state["model"])
            # Into the wrapper, which is a new optimizer: state loaded
            # into the one it wraps would not reach it (the JAX
            # package's trainer loses its momentum there).
            if "optimizer" in state:
                optimizer.load_state_dict(state["optimizer"])
        hvd.broadcast_parameters(net.state_dict(), root_rank=0)
        hvd.broadcast_optimizer_state(optimizer, root_rank=0)

        # The SAME step count on every rank: the per-batch gradient
        # allreduce would otherwise desync on unequal shards and hang
        # the larger ranks at epoch end.
        max_steps = util.sync_steps_per_epoch(
            self.meta, "train", size, self.batch_size, ceil=True,
            store=store, col=feature_cols[0])

        history = []
        for epoch in range(self.start_epoch, self.epochs):
            epoch_loss, steps = 0.0, 0
            # Streaming iterator: one part file resident at a time.
            for batch in itertools.islice(util.stream_batches(
                    store, "train", rank, size, cols, self.batch_size,
                    seed=self.seed + epoch, drop_remainder=False),
                    max_steps):
                bx = [torch.as_tensor(b).float().to(device)
                      for b in batch[:len(feature_cols)]]
                by = [torch.as_tensor(b).float().to(device)
                      for b in batch[len(feature_cols):]]
                optimizer.zero_grad()
                out = net(*bx)
                outs = out if isinstance(out, (list, tuple)) else [out]
                loss = sum(self.loss_fn(o.squeeze(-1), t)
                           for o, t in zip(outs, by))
                loss.backward()
                optimizer.step()
                epoch_loss += float(loss.detach())
                steps += 1
            history.append(epoch_loss / max(steps, 1))
            if rank == 0:
                save_checkpoint(store, self.run_id,
                                _state_to_bytes(net, optimizer), epoch)
        result = {"history": history, "start_epoch": self.start_epoch}
        if rank == 0:
            result["state"] = _state_to_bytes(net)
        hvd.shutdown()
        return result


class TorchEstimator(HorovodEstimator):
    """Usage mirrors the reference (spark/torch/estimator.py):

        est = TorchEstimator(model=net, optimizer=torch.optim.SGD(
                                 net.parameters(), lr=0.1),
                             loss=torch.nn.MSELoss(),
                             feature_cols=["x"], label_cols=["y"],
                             store=store, num_proc=2, epochs=4)
        torch_model = est.fit(df)
        pred_df = torch_model.transform(test_df)

    ``device``: where each rank trains (``None``: its card).
    """

    _params = dict(device=None)

    def __init__(self, **kwargs):
        super().__init__()
        if kwargs:
            self.setParams(**kwargs)

    def fit(self, df, params=None):
        # Before the data is materialized or any worker starts; with
        # params, the copy's own fit checks.
        if not params:
            self._check_device()
        return super().fit(df, params)

    def fit_on_prepared_data(self, backend=None):
        self._check_device()
        return super().fit_on_prepared_data(backend)

    def _check_device(self):
        _device(self.getDevice())

    def _remote_trainer(self, meta, resume_state, run_id):
        store = self.getStore()
        opt = self.getOptimizer()
        return _Trainer(
            store=store, meta=meta, resume_state=resume_state,
            feature_cols=list(self.getFeatureCols()),
            label_cols=list(self.getLabelCols()),
            epochs=self.getEpochs(), batch_size=self.getBatchSize(),
            seed=self._get("seed"), model=self.getModel(),
            loss_fn=self.getLoss(), opt_cls=type(opt),
            opt_defaults=dict(opt.defaults),
            start_epoch=(checkpoint_epoch(store, run_id) + 1
                         if resume_state is not None else 0),
            run_id=run_id, device=self.getDevice())

    def _create_model(self, rank0_result, run_id) -> "TorchModel":
        model = self.getModel()
        state = _state_from_bytes(rank0_result["state"])
        model.load_state_dict(state["model"])
        m = TorchModel(model=model,
                       feature_cols=self.getFeatureCols(),
                       label_cols=self.getLabelCols(),
                       run_id=run_id, device=self.getDevice())
        m.history = rank0_result["history"]
        m.start_epoch = rank0_result["start_epoch"]
        return m


class TorchModel(HorovodModel):
    """The fitted model; ``device`` is where it predicts (``None``: the
    card)."""

    _params = dict(device=None)

    def __init__(self, **kwargs):
        super().__init__()
        if kwargs:
            self.setParams(**kwargs)

    def _predict(self, features) -> List:
        import torch
        device = _device(self.getDevice())
        net = self.getModel().to(device)
        net.eval()
        with torch.no_grad():
            xs = [torch.as_tensor(f).float().to(device) for f in features]
            out = net(*xs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [o.squeeze(-1).cpu().numpy() for o in outs]
