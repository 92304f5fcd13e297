"""Operator tools of horovod_tpu_torch, the counterparts of the JAX
package's ``tools/`` scripts, each run as ``python -m
horovod_tpu_torch.tools.<name>`` with the same flags, exit codes and
printed keys:

* ``validate_trace``: checks a Chrome trace (``hvd.start_timeline``,
  ``start_xla_trace``, ``blackbox_merge``'s merge);
* ``blackbox_merge``: merges the flight recorder's per-rank dumps into
  one Chrome trace and a verdict;
* ``tune_report``: prints or diffs tuned profiles;
* ``hvdtop``: renders a live ``/status``;
* ``flame``: merges ``/profile`` payloads into collapsed stacks and an
  SVG flamegraph;
* ``measure_torch_staging``: the cost of the host-staged torch data path;
* ``measure_elastic``: death to the first step after an elastic resize;
* ``profile_resnet``: ResNet-50's step time, achieved TFLOP/s and MFU.

The last three run on the card unless ``--device cpu`` is given.  Every
module imports only the standard library and the port at import.
"""
