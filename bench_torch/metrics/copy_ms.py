"""copy_ms: the producer's host copy of a frame's planes into the driver's
pinned ring, ms per upload (``PipelineDriver.staging`` over the window)."""


def read(run):
    st = run.staging
    return st["host_copy_s"] / st["uploads"] * 1e3 if st["uploads"] else None
