"""The JAX package's own tests of the files below, run against the port
(``_torch_jax_suite`` rewrites and loads them): each JAX case is one test
here, ``<file>__<test>[case]``."""

from _torch_jax_suite import expose

expose(globals(), [
    "test_stream_step",
])
