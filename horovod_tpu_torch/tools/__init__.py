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
* ``profile_resnet``: ResNet-50's step time, achieved TFLOP/s and MFU;
* ``chaos_soak``: seeded fault schedules and the kill, wedge, relay,
  checkpoint, serve, tune and autoscale drills against the control
  plane, with the simulated data plane on the card;
* ``hvdlint``: the port's static-analysis gate, five AST checks over
  ``horovod_tpu_torch/`` and ``chip_smoke.py`` against the port's own
  knob, metric and failpoint catalogs (``horovod_tpu_torch/docs/``)
  and an empty baseline (``python -m horovod_tpu_torch.tools.hvdlint
  --check all``).

``measure_torch_staging``, ``measure_elastic``, ``profile_resnet`` and
``chaos_soak`` run on the card unless ``--device cpu`` is given.  Every
module imports only the standard library, numpy, torch and the port at
import; ``hvdlint`` imports the standard library only.
"""
