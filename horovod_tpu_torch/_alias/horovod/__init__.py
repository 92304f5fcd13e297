"""Drop-in alias of the port: ``horovod.*`` -> ``horovod_tpu_torch.*``.

Scripts written for upstream Horovod (``import horovod.torch as hvd``,
``import horovod.tensorflow.keras as hvd``, ...) run on the port
unmodified when this package's directory, ``horovod_tpu_torch/_alias``,
comes first on ``sys.path`` (the port's launchers put it first on every
worker's ``PYTHONPATH``).  A meta-path finder sends every
``horovod.X...`` import to the module object ``horovod_tpu_torch.X...``
itself, so names, submodules and module identity are the port's at any
depth, with no duplicate module objects.  This package holds no logic
of its own and imports nothing of JAX.
"""

import importlib
import importlib.abc
import importlib.util
import sys

from horovod_tpu_torch.version import __version__  # noqa: F401

# Aliases whose implementation path is not a literal horovod_tpu_torch.<X>.
_SPECIAL = {
    "horovod.elastic": "horovod_tpu_torch.common.elastic",
}


class _AliasLoader(importlib.abc.Loader):
    def __init__(self, target: str):
        self._target = target

    def create_module(self, spec):
        # Returning the implementation module makes the import system
        # register it under the alias name: one object, not re-executed.
        return importlib.import_module(self._target)

    def exec_module(self, module):
        pass


class _AliasFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith("horovod."):
            return None
        impl = _SPECIAL.get(fullname) or \
            "horovod_tpu_torch." + fullname[len("horovod."):]
        try:
            importlib.import_module(impl)
        except ModuleNotFoundError as e:
            if e.name == impl:
                return None   # no such module in the port
            # A missing dependency (tensorflow, keras, ...) or a fault
            # inside the port surfaces as itself, not as a bogus
            # "No module named horovod.X".
            raise
        return importlib.util.spec_from_loader(fullname,
                                               _AliasLoader(impl))


sys.meta_path.insert(0, _AliasFinder())
