"""H100 counterparts of the TPU gather probes (``tools/probe_dgather.py``,
``tools/probe_dgather2.py``, ``tools/probe_merge_kernel.py``): the same
functions at the same shapes, timed with CUDA events.

    python -m lux_tpu_torch.probes.dgather [name ...]
    python -m lux_tpu_torch.probes.dgather2 [name ...]
    python -m lux_tpu_torch.probes.merge_kernel

The kernels and their plain versions are in :mod:`.gather`.
"""
