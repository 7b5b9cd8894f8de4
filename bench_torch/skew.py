"""How a configuration's frames pile into the vectorscope's bins.

    python3 -m bench_torch.skew --config obs_qhd60_screen_dock --seeds 1,2,3 [--content camera]

makes the first ``--frames`` frames of each seed's pool as a run makes
them (``--content`` puts the other picture in the same frame size),
takes each frame's capture as the dock sees it (the reference's decode
and downscale) and prints, over every capture pixel of those frames:

- ``top16``: the share of pixels in the 16 fullest vectorscope bins;
- ``run32``: the share of 32-pixel runs (a row's pixels in order, 32 to a
  run) that lie wholly in one bin;
- ``run256``: the same for 256-pixel runs, what one warp of K2's
  vectorscope grid counts at a time (32 lanes of 8 consecutive pixels):
  only a run in one bin takes its one-atomic path.
"""

from __future__ import annotations

import argparse
import sys

import torch

from . import serve, spec
from .reference import golden
from .reference.panel import DockReference


def bins(capture: torch.Tensor, cs: int) -> torch.Tensor:
    """(sh, sw) int64 vectorscope bin ``v * 256 + u`` of each capture pixel."""
    yuv = golden.to_yuv(capture, cs).to(torch.int64)
    return yuv[..., 2] * 256 + yuv[..., 1]


def runs_in_one_bin(b: torch.Tensor, n: int) -> tuple[int, int]:
    """(runs wholly in one bin, runs) over the n-pixel runs of each row."""
    r = b[:, : b.shape[1] // n * n].reshape(-1, n)
    return int((r == r[:, :1]).all(dim=1).sum()), r.shape[0]


def measure(pool: list, h: int, w: int, dock: dict, device) -> dict:
    """``top16``, ``run32`` and ``run256`` over every frame of ``pool``."""
    ref = DockReference(dock, h, w, device)
    counts = torch.zeros(65536, dtype=torch.int64, device=ref.dev)
    runs = {32: [0, 0], 256: [0, 0]}
    for buf in pool:
        buf = torch.from_numpy(buf)
        b = bins(ref.capture(buf[:h], buf[h:]), ref.cs)
        counts += torch.bincount(b.reshape(-1), minlength=65536)
        for n, acc in runs.items():
            one, total = runs_in_one_bin(b, n)
            acc[0] += one
            acc[1] += total
    share = lambda a: a[0] / a[1] if a[1] else float("nan")  # noqa: E731
    return {"top16": float(counts.topk(16).values.sum() / counts.sum()),
            "run32": share(runs[32]), "run256": share(runs[256])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--content", choices=sorted(serve.POOLS), help="the picture, if not the file's")
    p.add_argument("--frames", type=int, default=6, help="frames of each seed's pool")
    args = p.parse_args(argv)
    cfg = spec.config(spec.load_benchmark(), args.config)
    kind = args.content or cfg.get("content", "camera")
    f = cfg["frame"]
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds.split(","):
        pool = serve.POOLS[kind](int(seed), 0, args.frames, f["height"], f["width"],
                                 f["colorspace"], dev)
        m = measure(pool, f["height"], f["width"], cfg["dock"], dev)
        print(f"skew {args.config} {kind} {f['width']}x{f['height']} seed {seed} "
              f"frames {args.frames}: " + ", ".join(f"{k} {v:.4f}" for k, v in m.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
