"""The JAX package's own tests of the files below, run against the port
(``_torch_jax_suite`` rewrites and loads them): each JAX case is one test
here, ``<file>__<test>[case]``."""

from _torch_jax_suite import expose

expose(globals(), [
    "test_fuzz",
    "test_pallas_convert",
    "test_pallas_stats",
    "test_pipeline_kernel",
])
