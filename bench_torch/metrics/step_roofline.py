"""step_roofline: the least time a frame's step needs over ``card_ms``, in %.

The least time is the bytes a frame must move once at the card's published
3.35 TB/s, the mean over one interleave cycle of ``roi.interleave + 1``
frames.  The analysed frame reads the NV12 frame and writes the published
panel and counts (the vectorscope's 256x256 u8, the waveform's 3x256 u8
per capture column, the histogram's 3x256 int32).  Each skipped frame
reads the published capture (RGBA) and counts and writes the panel; it
reads no NV12 frame.  It counts the work whatever implements it, so it
holds across a change that fuses the step's kernels."""

from ..arith import byte_bound_s
from ..spec import reader


def frame_bytes(cfg: dict) -> float:
    f, d = cfg["frame"], cfg["dock"]
    n = cfg["roi"]["interleave"]
    sw, sh = f["width"] // d["target_scale"], f["height"] // d["target_scale"]
    panel = d["width"] * d["height"] * 4
    counts = 256 * 256 + 3 * 256 * sw + 3 * 256 * 4
    analysed = f["width"] * f["height"] * 3 // 2 + panel + counts
    skipped = sw * sh * 4 + counts + panel
    return (analysed + n * skipped) / (n + 1)


def read(run):
    step = reader("card_ms")(run)
    return None if not step else 100.0 * byte_bound_s(frame_bytes(run.cfg)) * 1e3 / step
