"""Profile-guided auto-tuner, the counterpart of ``lux_tpu/tune``: close
the measurement -> knob loop per (graph fingerprint, program, engine
kind, mesh shape, device kind).

- :mod:`space` declares the knob axes the tuner may turn
  (:data:`TUNER_MANAGED`) and enumerates candidates deterministically.
- :mod:`probe` builds an executor under a candidate flag overlay
  (:func:`lux_tpu_torch.utils.flags.overrides`) and scores a short
  fixed-iteration burst from the engobs phase split — never wall-clock
  alone.
- :mod:`search` runs successive halving over the space and returns a
  ``tuneconf.v1`` artifact; every probe and the selection land in the
  run ledger.
- :mod:`artifact` persists/loads the artifact JSON (the same files
  ``lux_tpu`` writes); :mod:`cache` is the ShardPlanCache-shaped LRU
  serving warmup consults, evicted with the plan cache on snapshot
  swaps.

``python -m lux_tpu_torch.tools.luxlint --tune DIR`` (analysis/tuneck.py,
LUX5xx) verifies the artifacts offline.
"""

from lux_tpu_torch.tune.artifact import (SCHEMA, key_string,
                                         list_artifacts, load, load_path,
                                         make_key, save)
from lux_tpu_torch.tune.cache import TuneCache, tune_cache
from lux_tpu_torch.tune.probe import ProbeResult, run_probe
from lux_tpu_torch.tune.search import tune
from lux_tpu_torch.tune.space import (TUNER_MANAGED, default_candidate,
                                      knob_space)

__all__ = [
    "SCHEMA", "TUNER_MANAGED", "TuneCache", "ProbeResult",
    "default_candidate", "key_string", "knob_space", "list_artifacts",
    "load", "load_path", "make_key", "run_probe", "save", "tune",
    "tune_cache",
]
