"""MXNet binding — FORMALLY DESCOPED (see docs/mxnet_descope.md).

The port's counterpart of :mod:`horovod_tpu.mxnet`.  The reference
ships an MXNet binding (reference: horovod/mxnet/ — DistributedOptimizer,
gluon DistributedTrainer, broadcast_parameters).  MXNet reached
end-of-life upstream (attic'd by Apache in September 2023), so neither
package implements the binding; this module keeps the import surface
with an actionable error instead of a silent gap.  Migration: module
API and gluon → horovod_tpu_torch.torch (full rationale in
docs/mxnet_descope.md).
"""

_MSG = ("horovod_tpu_torch.mxnet is formally descoped: MXNet is "
        "end-of-life upstream (Apache attic, Sept 2023). Use the PyTorch "
        "binding (horovod_tpu_torch.torch) instead; see "
        "docs/mxnet_descope.md for the migration table.")

try:
    import mxnet  # noqa: F401
    _HAS_MXNET = True
except ImportError:
    _HAS_MXNET = False

if not _HAS_MXNET:
    def __getattr__(name):
        raise ImportError(_MSG)
