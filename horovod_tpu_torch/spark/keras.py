"""KerasEstimator: fit a Keras model to a DataFrame on distributed
workers (reference: spark/keras/estimator.py — KerasEstimator /
KerasModel over the shared HorovodEstimator machinery; remote trainer
semantics from spark/keras/remote.py: broadcast initial state, shard
the materialized data per rank, per-epoch checkpoint on rank 0,
resume from the last checkpoint when re-fit with the same run_id).

Counterpart of :mod:`horovod_tpu.spark.keras`, on the port's Keras
binding (:mod:`horovod_tpu_torch.keras`).  The workers run Keras on its
torch backend (``KERAS_BACKEND=torch``), inside ``keras.device`` of the
``device`` param: ``None`` means each rank's card, chosen by
``hvd.init()``, and with no card the estimator raises before any data is
written or any worker starts; pass ``device="cpu"`` to train on the CPU.
The Store's checkpoint is the JAX package's payload (the ``.keras``
archive and the optimizer variables as numpy), so each package resumes
the other's.
"""

import os
import pickle
import tempfile
from typing import List

from .estimator import (HorovodEstimator, HorovodModel, checkpoint_epoch,
                        save_checkpoint)
from . import util


def _model_to_bytes(model) -> bytes:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.keras")
        model.save(path)
        with open(path, "rb") as f:
            return f.read()


def _model_from_bytes(raw: bytes):
    import keras
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.keras")
        with open(path, "wb") as f:
            f.write(raw)
        return keras.models.load_model(path, compile=False)


def _device(device):
    from ..models.gpt import resolve_device
    return resolve_device(device)


def _read_checkpoint(resume_state, run_id):
    """(model bytes, optimizer variables or None) of a Store
    checkpoint."""
    try:
        ckpt = pickle.loads(resume_state)
    except Exception:
        # Legacy/model-only checkpoint: raw .keras archive bytes with
        # no optimizer slots.
        return resume_state, None
    if not isinstance(ckpt, dict) or "model" not in ckpt:
        raise ValueError(
            f"corrupt checkpoint for run {run_id!r}: "
            f"unexpected payload {type(ckpt).__name__}")
    return ckpt["model"], ckpt.get("opt_vars")


class _Trainer:
    """The remote trainer: one call trains on one rank, with Keras on
    its torch backend inside ``keras.device(device)`` (``None``: the
    card that ``hvd.init()`` gave the rank)."""

    def __init__(self, store, meta, model_bytes, opt_vars, opt_cfg, loss,
                 metrics, feature_cols, label_cols, epochs, batch_size,
                 seed, verbose, callbacks, start_epoch, run_id, device):
        self.__dict__.update(
            store=store, meta=meta, model_bytes=model_bytes,
            opt_vars=opt_vars, opt_cfg=opt_cfg, loss=loss,
            metrics=metrics, feature_cols=feature_cols,
            label_cols=label_cols, epochs=epochs, batch_size=batch_size,
            seed=seed, verbose=verbose, callbacks=callbacks,
            start_epoch=start_epoch, run_id=run_id, device=device)

    def __call__(self):
        # Before Keras loads: its backend is fixed at import.
        os.environ["KERAS_BACKEND"] = "torch"
        import keras
        if keras.backend.backend() != "torch":
            raise RuntimeError(
                "KerasEstimator workers need Keras on its torch backend, "
                f"and Keras was loaded on {keras.backend.backend()!r}")
        from .. import keras as hvd

        hvd.init()
        # After init, which sets this rank's card.
        device = _device(self.device)
        with keras.device(str(device)):
            result = self._fit(keras, hvd)
        hvd.shutdown()
        return result

    def _fit(self, keras, hvd):
        import itertools
        rank, size = hvd.rank(), hvd.size()
        store, feature_cols = self.store, self.feature_cols
        cols = feature_cols + self.label_cols
        model = _model_from_bytes(self.model_bytes)
        optimizer = (keras.optimizers.get(self.opt_cfg)
                     if isinstance(self.opt_cfg, str)
                     else keras.optimizers.deserialize(self.opt_cfg))
        optimizer = hvd.DistributedOptimizer(optimizer)
        model.compile(optimizer=optimizer, loss=self.loss,
                      metrics=self.metrics)
        if self.opt_vars is not None:
            optimizer.build(model.trainable_variables)
            live = list(optimizer.variables)
            if len(live) == len(self.opt_vars) and all(
                    tuple(v.shape) == tuple(s.shape)
                    for v, s in zip(live, self.opt_vars)):
                for var, val in zip(live, self.opt_vars):
                    var.assign(val)
            else:
                import warnings
                warnings.warn(
                    "checkpointed optimizer state does not match the "
                    "current optimizer (changed optimizer between "
                    "resumes?); continuing with fresh optimizer slots")

        # The SAME step count on every rank: the per-batch gradient
        # allreduce would otherwise desync on unequal shards and hang
        # the larger ranks at end of fit.
        my_rows = util.shard_rows(self.meta, "train", rank, size)
        steps_per_epoch = util.sync_steps_per_epoch(
            self.meta, "train", size, self.batch_size,
            store=store, col=feature_cols[0])
        nfeat = len(feature_cols)

        def epoch_pass(e, drop):
            # Streaming input: one part file resident at a time.
            n = 0
            for b in util.stream_batches(
                    store, "train", rank, size, cols, self.batch_size,
                    seed=self.seed + e, drop_remainder=drop):
                bx, by = list(b[:nfeat]), list(b[nfeat:])
                yield (bx[0] if nfeat == 1 else bx,
                       by[0] if len(by) == 1 else by)
                n += 1
            if not n and drop:
                # Shard smaller than one batch: emit the short
                # remainder so fit() never starves.
                yield from epoch_pass(e, False)
            elif not n:
                raise RuntimeError(
                    f"rank {rank}: no batches streamed from "
                    f"{store.get_train_data_path()} (metadata "
                    f"promised {my_rows} rows)")

        def gen():
            # Each pass truncated to the SYNCED step count, so epoch
            # boundaries (reshuffle seed, checkpoint) stay aligned; a
            # pass that yields fewer fails loudly.
            e = self.start_epoch
            while True:
                n = 0
                for item in itertools.islice(epoch_pass(e, True),
                                             steps_per_epoch):
                    yield item
                    n += 1
                if n < steps_per_epoch:
                    raise RuntimeError(
                        f"rank {rank}: epoch {e} streamed only "
                        f"{n}/{steps_per_epoch} synced batches from "
                        f"{store.get_train_data_path()} — part files no "
                        f"longer match the metadata row counts "
                        f"(rewritten/lost part?)")
                e += 1

        cbs = [hvd.callbacks.BroadcastGlobalVariablesCallback(0)]
        if rank == 0:
            run_id = self.run_id

            class _Ckpt(keras.callbacks.Callback):
                def on_epoch_end(cb, epoch, logs=None):
                    payload = pickle.dumps({
                        "model": _model_to_bytes(model),
                        "opt_vars": [v.numpy()
                                     for v in optimizer.variables],
                    })
                    save_checkpoint(store, run_id, payload, epoch)
            cbs.append(_Ckpt())
        cbs.extend(self.callbacks)

        history = {}
        if self.start_epoch < self.epochs:
            h = model.fit(gen(), steps_per_epoch=steps_per_epoch,
                          initial_epoch=self.start_epoch,
                          epochs=self.epochs,
                          verbose=self.verbose if rank == 0 else 0,
                          callbacks=cbs)
            history = {k: [float(v) for v in vs]
                       for k, vs in h.history.items()}
        result = {"history": history, "start_epoch": self.start_epoch}
        if rank == 0:
            result["model"] = _model_to_bytes(model)
        return result


class KerasEstimator(HorovodEstimator):
    """Usage mirrors the reference (spark/keras/estimator.py):

        est = KerasEstimator(model=model, optimizer="sgd", loss="mse",
                             feature_cols=["x"], label_cols=["y"],
                             store=store, num_proc=2, epochs=4)
        keras_model = est.fit(df)
        pred_df = keras_model.transform(test_df)

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
        import keras

        store = self.getStore()
        opt = self.getOptimizer() or "sgd"
        opt_cfg = (keras.optimizers.serialize(opt)
                   if not isinstance(opt, str) else opt)
        # Checkpoint payload: model bytes + optimizer slot variables
        # (momentum/Adam moments, iteration counter) so a resumed run
        # continues the optimizer trajectory.
        if resume_state is not None:
            model_bytes, opt_vars = _read_checkpoint(resume_state, run_id)
            start_epoch = checkpoint_epoch(store, run_id) + 1
        else:
            model_bytes = _model_to_bytes(self.getModel())
            opt_vars = None
            start_epoch = 0
        return _Trainer(
            store=store, meta=meta, model_bytes=model_bytes,
            opt_vars=opt_vars, opt_cfg=opt_cfg, loss=self.getLoss(),
            metrics=self.getMetrics() or [],
            feature_cols=list(self.getFeatureCols()),
            label_cols=list(self.getLabelCols()),
            epochs=self.getEpochs(), batch_size=self.getBatchSize(),
            seed=self._get("seed") or 0, verbose=self.getVerbose(),
            callbacks=self.getCallbacks() or [], start_epoch=start_epoch,
            run_id=run_id, device=self.getDevice())

    def _create_model(self, rank0_result, run_id) -> "KerasModel":
        model = _model_from_bytes(rank0_result["model"])
        m = KerasModel(model=model,
                       feature_cols=self.getFeatureCols(),
                       label_cols=self.getLabelCols(),
                       run_id=run_id, device=self.getDevice())
        m.history = rank0_result["history"]
        m.start_epoch = rank0_result["start_epoch"]
        return m


class KerasModel(HorovodModel):
    """The fitted model; ``device`` is where it predicts under Keras's
    torch backend (``None``: the card)."""

    _params = dict(device=None)

    def __init__(self, **kwargs):
        super().__init__()
        if kwargs:
            self.setParams(**kwargs)

    def _predict(self, features) -> List:
        import contextlib
        import keras
        x = features[0] if len(features) == 1 else features
        scope = (keras.device(str(_device(self.getDevice())))
                 if keras.backend.backend() == "torch"
                 else contextlib.nullcontext())
        with scope:
            preds = self.getModel().predict(x, verbose=0)
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        return list(preds)
