"""queue_wait_ms: the mean time a frame waited in the driver's queue, in ms:
from its accepted push (the producer's ``PipelineDriver.push_nv12``) to
the worker's pop, the program's ``queue.wait`` spans."""

from ..spans import ms, spans


def read(run):
    w = spans(run, "queue.wait")
    return sum(ms(s) for s in w) / len(w) if w else None
