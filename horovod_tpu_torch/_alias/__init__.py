"""Where the ``horovod`` drop-in alias of the port lives.

``ALIAS_DIR`` (this directory) holds a package named ``horovod`` that
sends every ``horovod.X`` import to ``horovod_tpu_torch.X``, so that a
script written for upstream Horovod (``import horovod.torch as hvd``)
runs on the port unmodified.  It is a path entry, not an import: put it
first on ``sys.path``.  The port's launchers do that for every worker
(:func:`worker_pythonpath`); outside a launcher::

    export PYTHONPATH=/path/to/horovod_tpu_torch/_alias:$PYTHONPATH

A script's own directory is ``sys.path[0]`` and comes before
``PYTHONPATH``: a script that sits beside another ``horovod`` package
(the repository root holds the JAX package's) gets that one.
"""

import os
import sys
from typing import Optional

ALIAS_DIR = os.path.dirname(os.path.abspath(__file__))
# The directory that holds horovod_tpu_torch, which the alias imports.
PACKAGE_ROOT = os.path.dirname(os.path.dirname(ALIAS_DIR))


def worker_pythonpath(existing: Optional[str] = None) -> str:
    """A worker's ``PYTHONPATH``: the alias directory first, then the
    directory holding the package, then ``existing``'s entries less
    those two."""
    ours = [ALIAS_DIR, PACKAGE_ROOT]
    rest = [p for p in (existing or "").split(os.pathsep)
            if p and os.path.abspath(p) not in ours]
    return os.pathsep.join(ours + rest)


def install():
    """What a launcher does for the processes it starts, for a process
    that runs the training function in place (a Spark task, a Ray
    actor): the alias directory first on ``sys.path``, and first on the
    ``PYTHONPATH`` its children inherit.  A ``horovod`` module this
    process already imported stays what it is."""
    if ALIAS_DIR in sys.path:
        sys.path.remove(ALIAS_DIR)
    sys.path.insert(0, ALIAS_DIR)
    # hvdlint: env-ok(PYTHONPATH is passed through to the children with
    # the alias put first, not a Horovod knob)
    inherited = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = worker_pythonpath(inherited)
