"""Lightweight estimator-parameter machinery.

The reference builds its Estimator params on pyspark.ml.param.Params
(reference: spark/common/params.py:24-300 — a Param descriptor per
knob plus hand-written setX/getX pairs).  pyspark is an optional
orchestrator here, so the param system is self-contained: a
``Param``-table per class, generated camel-case accessors, and
``setParams(**kwargs)`` — the same user surface
(``est.setEpochs(4)``, ``est.getEpochs()``) without the pyspark
dependency.  When pyspark is present the estimator still plugs into
its DataFrames; only the Params base class differs.
"""

import copy
from typing import Any, Dict


def _camel(name: str) -> str:
    return "".join(p.capitalize() for p in name.split("_"))


class Params:
    """Base with a class-level ``_params`` table: name -> default."""

    _params: Dict[str, Any] = {}

    def __init__(self):
        self._values = {}
        for cls in reversed(type(self).__mro__):
            self._values.update(getattr(cls, "_params", {}))

    # -- generic access -------------------------------------------------
    def _set(self, **kwargs):
        for k, v in kwargs.items():
            if k not in self._values:
                raise ValueError(f"unknown param {k!r} for "
                                 f"{type(self).__name__}")
            self._values[k] = v
        return self

    def _get(self, name: str):
        return self._values[name]

    def setParams(self, **kwargs):
        return self._set(**kwargs)

    def copy(self, extra: Dict[str, Any] = None) -> "Params":
        dup = copy.copy(self)
        dup._values = dict(self._values)
        if extra:
            dup._set(**extra)
        return dup

    # -- generated accessors -------------------------------------------
    def __getattr__(self, attr):
        # Only called when normal lookup fails: synthesize set<Param> /
        # get<Param> accessors from the param table.
        values = self.__dict__.get("_values")
        if values is not None:
            if attr.startswith("set"):
                name = _uncamel(attr[3:], values)
                if name is not None:
                    return lambda v: self._set(**{name: v})
            elif attr.startswith("get"):
                name = _uncamel(attr[3:], values)
                if name is not None:
                    return lambda: values[name]
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {attr!r}")


def _uncamel(camel: str, values: Dict[str, Any]):
    """Map CamelCase accessor suffix back to a snake_case param name."""
    out, prev = [], False
    for ch in camel:
        if ch.isupper() and out:
            out.append("_")
        out.append(ch.lower())
    name = "".join(out)
    if name in values:
        return name
    # Single-word fallbacks where capitalization is ambiguous
    # (e.g. RunId -> run_id handled above; NumProc -> num_proc).
    return None
