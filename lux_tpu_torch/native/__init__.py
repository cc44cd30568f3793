"""Native (C++) fast paths for host-side work, the counterpart of
``lux_tpu/native``.

The reference's host runtime work — partitioned parallel file loading
(core/pull_model.inl:253-320), the edge-list converter (tools/converter.cc),
CSR construction (sssp/sssp_gpu.cu:550-607) — is C++ there and C++ here
(``lux_native.cc``, the port's own copy). The shared library is compiled
with ``g++`` on first use into ``build/lux_tpu_torch/`` and bound through
ctypes (:mod:`build`); every entry point has a numpy fallback that gives
byte-identical graphs (:mod:`io`). A failed build is logged once and
visible through :func:`available`.
"""

from lux_tpu_torch.native import io  # noqa: F401
from lux_tpu_torch.native.build import available  # noqa: F401
