"""What the examples share: the ``--device`` option (checked as the CLI
checks it: no card, no fallback), ``WxH`` sizes, and joining a
torch.distributed group from torchrun's environment."""

from __future__ import annotations

import argparse
import os
from datetime import timedelta

from ..__main__ import _check_device as check_device  # noqa: F401
from ..__main__ import _parse_size as size  # noqa: F401

GROUP_TIMEOUT = timedelta(seconds=120)


def add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the example runs (default: the card)")


def join_group_from_env(device: str) -> None:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL for
    the card, gloo for the CPU.  Without that environment nothing is
    joined, and ``parallel.make_mesh`` starts a world-size-1 group."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method="env://",
                            timeout=GROUP_TIMEOUT)


def leave_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
