"""step_roofline: the least time a frame's step needs over ``card_ms``, in %.

The least time is the bytes the step must read once (the NV12 frame) and
write once (the published panel and counts: the vectorscope's 256x256 u8,
the waveform's 3x256 u8 per capture column, the histogram's 3x256 int32)
at the card's published 3.35 TB/s.  It counts the work whatever
implements it, so it holds across a change that fuses the step's kernels."""

from ..arith import byte_bound_s
from ..spec import reader


def frame_bytes(cfg: dict) -> int:
    f, d = cfg["frame"], cfg["dock"]
    sw = f["width"] // d["target_scale"]
    return (f["width"] * f["height"] * 3 // 2 + d["width"] * d["height"] * 4
            + 256 * 256 + 3 * 256 * sw + 3 * 256 * 4)


def read(run):
    step = reader("card_ms")(run)
    return None if not step else 100.0 * byte_bound_s(frame_bytes(run.cfg)) * 1e3 / step
