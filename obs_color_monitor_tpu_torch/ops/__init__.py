"""Device ops of the torch port (counterpart of ``obs_color_monitor_tpu/ops``).

Plain torch: ``convert``, ``overlays``, ``stats``, ``render``; numpy:
``graticule``.  Kernel wrappers with their plain versions beside them:
``pipeline`` (K1, the whole-frame pass), ``scope_stats`` (K2, vectorscope +
waveform, either alone), ``fused_overlays`` (K3, the three overlays) and
``decode`` (K4/K5, NV12/P010 decode).  ``fused.analyze`` runs K1 + K2.
Importing this package imports no kernel toolchain; kernels build at their
first CUDA launch.
"""
