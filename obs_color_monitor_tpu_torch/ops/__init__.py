"""Device ops of the torch port (counterpart of ``obs_color_monitor_tpu/ops``).

Plain torch: ``convert``, ``overlays``, ``stats``, ``render``.  Kernel
wrappers with their plain versions beside them: ``pipeline`` (K1, the
whole-frame pass) and ``scope_stats`` (K2, vectorscope + waveform).
Importing this package imports no kernel toolchain; kernels build at their
first CUDA launch.
"""
