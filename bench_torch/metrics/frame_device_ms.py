"""frame_device_ms: the mean time on the card from a frame's arrival (the
worker's stream after the upload) to its panel (before the sink), in ms:
the program's ``frame.device`` CUDA-event pairs.  The gaps the worker's
host leaves between the frame's operations count in it, so it reads above
``card_ms`` by the card's idle while the worker issues.  None off a card."""

from ..spans import device


def read(run):
    t = device(run, "frame.device")
    return sum(t) / len(t) if t else None
