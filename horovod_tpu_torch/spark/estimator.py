"""Estimator API: fit a model to a DataFrame on distributed workers.

Counterpart of :mod:`horovod_tpu.spark.estimator` (reference:
spark/common/estimator.py:25-108): ``HorovodEstimator.fit``
materializes the DataFrame through the Store, runs a remote trainer on
every worker via the backend, and returns a ``HorovodModel``
transformer; ``_has_checkpoint``/per-epoch checkpoints in the Store
give resumable runs.  As in the JAX package: npz shards instead of
Petastorm parquet, a LocalBackend so one host works without a Spark
cluster, and framework trainers that drive the port's binding
(DistributedOptimizer + broadcast) over its data plane.
"""

import json
import os
import uuid
from typing import List, Optional

from .backend import Backend, LocalBackend
from .params import Params
from . import util

CHECKPOINT_META = "checkpoint.meta.json"


class EstimatorParams(Params):
    _params = dict(
        num_proc=None, model=None, backend=None, store=None,
        optimizer=None, loss=None, metrics=None, feature_cols=None,
        label_cols=None, validation=None, callbacks=None,
        batch_size=32, val_batch_size=None, epochs=1, verbose=1,
        shuffle_buffer_size=None, partitions_per_process=4,
        run_id=None, train_steps_per_epoch=None,
        validation_steps_per_epoch=None, sample_weight_col=None,
        gradient_compression=None, seed=0,
    )


class ModelParams(Params):
    _params = dict(
        model=None, feature_cols=None, label_cols=None,
        output_cols=None, run_id=None, metadata=None,
    )

    def get_output_cols(self) -> List[str]:
        out = self._get("output_cols")
        if out:
            return out
        # Reference default: <label>__output.
        return [f"{c}__output" for c in self._get("label_cols")]


class HorovodEstimator(EstimatorParams):
    """Base estimator; subclasses implement ``_remote_trainer()``
    returning a picklable fn(run_id, rank-invariant args) run on every
    worker, and ``_create_model(rank0_result)``."""

    def fit(self, df, params: Optional[dict] = None) -> "HorovodModel":
        if params:
            return self.copy(params).fit(df)
        backend = self._get_or_create_backend()
        store = self.getStore()
        num_parts = (backend.num_processes()
                     * (self.getPartitionsPerProcess() or 1))
        util.prepare_data(num_parts, store, df,
                          feature_cols=self.getFeatureCols(),
                          label_cols=self.getLabelCols(),
                          validation=self.getValidation(),
                          seed=self._get("seed"))
        return self.fit_on_prepared_data(backend=backend)

    def fit_on_prepared_data(self, backend: Optional[Backend] = None
                             ) -> "HorovodModel":
        """Train on shards already materialized in the Store (analog of
        reference fit_on_parquet, spark/common/estimator.py:37-50)."""
        backend = backend or self._get_or_create_backend()
        store = self.getStore()
        run_id = self.getRunId() or ("run_" + uuid.uuid4().hex[:12])
        self.setRunId(run_id)
        meta = util.read_metadata(store)
        resume_state = None
        if self._has_checkpoint(run_id):
            resume_state = store.read(store.get_checkpoint_path(run_id))
        trainer = self._remote_trainer(meta, resume_state, run_id)
        results = backend.run(trainer)
        model = self._create_model(results[0], run_id)
        # Column metadata rides along so transform() can derive its
        # output schema without collecting data to the driver.
        if model.getMetadata() is None:
            model.setMetadata(meta)
        return model

    # -- checkpoint/resume (reference: estimator.py:90-94,
    #    torch/remote.py:139-141,190-200) ------------------------------
    def _has_checkpoint(self, run_id: str) -> bool:
        store = self.getStore()
        path = store.get_checkpoint_path(run_id)
        return path is not None and store.exists(path)

    def _get_or_create_backend(self) -> Backend:
        backend = self.getBackend()
        if backend is None:
            backend = LocalBackend(self.getNumProc() or 2,
                                   verbose=self.getVerbose())
        elif self.getNumProc() is not None:
            raise ValueError('At most one of "backend" and "num_proc" '
                             'may be specified')
        return backend

    def _remote_trainer(self, meta, resume_state, run_id):
        raise NotImplementedError()

    def _create_model(self, rank0_result, run_id) -> "HorovodModel":
        raise NotImplementedError()


class HorovodModel(ModelParams):
    """Transformer: adds prediction columns to a DataFrame
    (reference: spark/common/estimator.py:97-108).  pyspark DataFrames
    transform distributedly via ``mapInPandas`` and stay Spark
    DataFrames; pandas input predicts in-process."""

    def transform(self, df):
        if hasattr(df, "mapInPandas"):
            return self._transform_spark(df)
        return self._transform_pandas(df)

    def _transform_pandas(self, pdf):
        import numpy as np
        features = [np.asarray(pdf[c].tolist())
                    for c in self.getFeatureCols()]
        preds = self._predict(features)
        out = pdf.copy()
        for col, pred in zip(self.get_output_cols(), preds):
            out[col] = list(np.asarray(pred))
        return out

    def _output_ranks(self):
        """Per-output-column prediction rank (row dims), derived by
        running ``_predict`` on a SYNTHETIC zero batch built from the
        Store's column metadata — exact (it exercises the real model)
        yet driver-side-data-free: works on empty DataFrames and never
        collects feature rows to the driver."""
        import numpy as np
        meta = self.getMetadata()
        cols = (meta or {}).get("columns", {})
        feats = []
        for c in self.getFeatureCols():
            info = cols.get(c)
            if info is None or "dtype" not in info:
                return None           # insufficient metadata: fallback
            feats.append(np.zeros((1, *info.get("shape", [])),
                                  dtype=np.dtype(info["dtype"])))
        preds = self._predict(feats)
        return [max(np.asarray(p).ndim - 1, 0) for p in preds]

    def _transform_spark(self, df):
        """Distributed transform: one model instance per task, no
        driver-side collect (reference transforms via a UDF,
        spark/torch/estimator.py TorchModel._transform)."""
        import numpy as np
        from pyspark.sql.types import (ArrayType, FloatType, StructField,
                                       StructType)
        # Output schema: input schema + one field per prediction
        # column, ranks inferred from a synthetic metadata-shaped
        # batch.  Legacy fallback (model built without metadata, e.g.
        # hand-constructed): probe one collected row.
        ranks = self._output_ranks()
        if ranks is None:
            sample = df.limit(1).toPandas()
            probe = self._transform_pandas(sample)
            ranks = [max(np.asarray(probe[col].tolist()).ndim - 1, 0)
                     for col in self.get_output_cols()]
        fields = list(df.schema.fields)
        for col, rank in zip(self.get_output_cols(), ranks):
            typ = FloatType()
            for _ in range(rank):                   # nest per row dim
                typ = ArrayType(typ)
            fields.append(StructField(col, typ))
        schema = StructType(fields)
        transform_pandas = self._transform_pandas
        out_cols = self.get_output_cols()

        def fn(iterator):
            for pdf in iterator:
                out = transform_pandas(pdf)
                for col in out_cols:
                    vals = np.asarray(out[col].tolist()).astype(float)
                    out[col] = (vals if vals.ndim == 1
                                else list(vals.tolist()))
                yield out

        return df.mapInPandas(fn, schema=schema)

    def _predict(self, features) -> List:
        """Returns one prediction array per label column."""
        raise NotImplementedError()


def save_checkpoint(store, run_id: str, payload: bytes, epoch: int):
    """Atomic per-epoch checkpoint + meta (epoch offset for resume)."""
    store.write(store.get_checkpoint_path(run_id), payload)
    store.write(os.path.join(store.get_run_path(run_id), CHECKPOINT_META),
                json.dumps({"epoch": epoch}).encode())


def checkpoint_epoch(store, run_id: str) -> int:
    """Last completed epoch recorded for the run; -1 if none."""
    path = os.path.join(store.get_run_path(run_id), CHECKPOINT_META)
    if not store.exists(path):
        return -1
    return int(json.loads(store.read(path).decode())["epoch"])
