"""CLI frontend: run the scopes from the command line.

Counterpart of ``obs_color_monitor_tpu/__main__.py``: the same ``dock``,
``scope`` and ``info`` subcommands and flags, plus ``--device {cuda,cpu}``
(default ``cuda``; without a CUDA GPU ``--device cuda`` exits non-zero and
runs nothing on the CPU).  The reference's frontend is a Qt dock inside OBS
(SURVEY.md §2 #18-22); the standalone equivalent is this CLI: feed frames
from a synthetic pattern / raw RGBA / NV12 file through the dock pipeline
and write composited scope images.

Examples:
    python -m obs_color_monitor_tpu_torch dock --pattern bars --size 1280x720 \\
        --frames 30 --out /tmp/dock.png
    python -m obs_color_monitor_tpu_torch scope vectorscope --input clip.rgba \\
        --size 1920x1080 --out vs.png
    python -m obs_color_monitor_tpu_torch info
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_size(s: str) -> tuple[int, int]:
    w, h = s.lower().split("x")
    return int(w), int(h)


def _make_source(args):
    from .pipeline.ingest import (
        FFmpegSource,
        NV12Source,
        PatternSource,
        RawRGBASource,
        Y4MSource,
    )

    w, h = _parse_size(args.size)
    if args.input:
        if args.input.endswith(".y4m"):
            return Y4MSource(args.input, cs=args.colorspace or 2)
        if args.input.endswith(".nv12"):
            return NV12Source(args.input, w, h, cs=args.colorspace or 2)
        if args.input.endswith(".p010"):
            # P010 = 10-bit NV12 layout, samples MSB-aligned in 16-bit LE
            return NV12Source(
                args.input, w, h, cs=args.colorspace or 2,
                bits=10, msb_aligned=True,
            )
        if args.input.endswith(".rgba"):
            return RawRGBASource(args.input, w, h)
        # anything else (mp4/mkv/webm/rtmp...) decodes through the system
        # ffmpeg, gated on the binary being installed
        return FFmpegSource(args.input)
    return PatternSource(w, h, args.pattern)


def _make_tee(args, src):
    """``--out-video`` recording tee (or None): records every rendered
    frame.

    The file analog of the reference's live dock surface — OBS records
    whatever its displays show; here the composited panel writes straight
    to .y4m (native) or any ffmpeg-encodable container.
    """
    if not getattr(args, "out_video", None):
        return None
    from .pipeline.sinks import RecordingTee

    return RecordingTee(args.out_video, args.fps, src, cs=args.colorspace or 2)


def cmd_dock(args) -> int:
    import numpy as np

    from .models import Dock
    from .config import ROIConfig
    from .utils.image_io import write_png
    from .utils.persistence import load_dock, save_dock

    roi_cfg = ROIConfig(target_scale=args.scale, interleave=args.interleave)
    if args.roi:
        x0, y0, x1, y1 = (int(v) for v in args.roi.split(","))
        roi_cfg.x0, roi_cfg.y0, roi_cfg.x1, roi_cfg.y1 = x0, y0, x1, y1
    dock = Dock(roi=roi_cfg, device=args.device)
    if args.load_settings:
        load_dock(dock, args.load_settings)
    src = _make_source(args)
    if args.live:
        return _run_live(args, dock, src)
    tee = _make_tee(args, src)
    # NV12-layout sources stream raw (y, uv) planes and decode ON DEVICE
    # (1.5 B/px uploads, no host color conversion) — bit-identical output
    use_nv12 = not args.one_program and getattr(src, "can_stream_nv12", False)
    frames_it = (
        src.frames_nv12(args.frames) if use_nv12 else src.frames(args.frames)
    )
    t0 = time.perf_counter()
    n = 0
    img = None
    ok = False
    try:
        for frame in frames_it:
            if args.one_program:
                img = dock.render_device(
                    frame, tm=n / 15.0, width=args.out_width, height=args.out_height
                )
            else:
                if use_nv12:
                    dock.push_nv12(*frame, cs=getattr(src, "cs", None),
                                   shift=getattr(src, "nv12_shift", 0))
                else:
                    dock.push_frame(frame)
                if tee is not None:
                    img = dock.render(width=args.out_width, height=args.out_height)
            if tee is not None and img is not None:
                tee.write(img)
            n += 1
        ok = True
    finally:
        # a failing close (ffmpeg nonzero exit) surfaces only when it is
        # the sole error — raising from finally would mask the loop's own
        if tee is not None:
            tee.close(raise_errors=ok)
    if not args.one_program and tee is None:
        img = dock.render(width=args.out_width, height=args.out_height)
    dt = time.perf_counter() - t0
    if img is None:
        print("no frames processed", file=sys.stderr)
        return 1
    write_png(args.out, np.asarray(img))
    if args.save_settings:
        save_dock(dock, args.save_settings)
    if args.one_program:
        print(f"dock (one-program): {n} frames in {dt:.2f}s -> {args.out}")
    else:
        print(
            f"dock: {n} frames in {dt:.2f}s "
            f"(processed {dock.hub.frames_processed}, "
            f"interleave-skipped {dock.hub.frames_skipped}) -> {args.out}"
        )
    return 0


class _Readback:
    """The ``--live`` loop's one-frame-late readback of device images (the
    JAX loop's ``copy_to_host_async``, which a torch tensor does not have).

    :meth:`stage` starts an image's host copy and returns the PREVIOUS
    staged image on the host.  On a CUDA device the copy goes into one of
    two pinned host buffers, ``non_blocking`` on a copy stream that first
    waits on the current stream, followed by an event; the previous
    buffer is handed out once its event has completed, as a copy of its
    own (the buffer is written again two frames later, and a sink may keep
    what it is given).  On the CPU the image is already on the host."""

    def __init__(self, device):
        import torch

        self._torch = torch
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._bufs: list = [None, None]
        self._events = [torch.cuda.Event(), torch.cuda.Event()] if self._cuda else None
        self._k = 0
        self._staged = None  # (image or pinned buffer, its event or None)

    def stage(self, img):
        torch = self._torch
        if not self._cuda:
            prev, self._staged = self.take(), (img, None)
            return prev
        k, self._k = self._k, self._k ^ 1
        buf = self._bufs[k]
        if buf is None or buf.shape != img.shape or buf.dtype != img.dtype:
            buf = self._bufs[k] = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            buf.copy_(img, non_blocking=True)
            self._events[k].record(self._stream)
        img.record_stream(self._stream)
        prev, self._staged = self.take(), (buf, self._events[k])
        return prev

    def take(self):
        """The staged image on the host (None when nothing is staged)."""
        if self._staged is None:
            return None
        (img, ev), self._staged = self._staged, None
        if ev is None:
            return img.numpy()
        ev.synchronize()
        return img.numpy().copy()


def _live_serve(args, src, produce, label, extra_stats=None) -> int:
    """Paced MJPEG-over-HTTP serving loop shared by the dock view and the
    per-scope projector view: decode, ``produce(frame) -> RGBA | None``,
    publish, sleep to the source rate.

    Readback is PIPELINED one frame deep, exactly the reference's staging
    pattern (gs_stagesurface: each tick maps the texture staged on the
    PREVIOUS tick, src/common.c:223-333): ``produce`` returns a
    device-resident image, its host copy is started asynchronously
    (:class:`_Readback`) and the PREVIOUS frame's (now ready) image is
    published — the device→host transfer overlaps the next frame's decode
    + device work instead of serializing after it.  Frames display one
    frame late, like the reference."""
    import numpy as np

    from .pipeline.live import MJPEGServer

    tee = _make_tee(args, src)
    fps = tee.fps if tee is not None else (
        args.fps or getattr(src, "fps", None) or 30.0
    )
    server = MJPEGServer(host=args.host, port=args.port).start()
    print(f"live {label} at {server.url}  (source {fps:g} fps, ctrl-C stops)")
    period = 1.0 / fps
    t0 = time.perf_counter()
    next_t = t0
    n = 0
    n_late = 0
    ok = False
    readback = _Readback(args.device)

    def _publish(img):
        img = np.asarray(img)
        server.publish(img)
        if tee is not None:
            tee.write(img)

    try:
        n_frames = None if args.frames <= 0 else args.frames
        # NV12-layout sources stream raw planes; produce() device-decodes
        frames_fn = (
            src.frames_nv12
            if getattr(src, "can_stream_nv12", False)
            else src.frames
        )
        for frame in frames_fn(n_frames):
            img = produce(frame)
            if img is not None:
                img = readback.stage(img)  # publish the PREVIOUS image
            if img is not None:
                _publish(img)
            n += 1
            next_t += period
            now = time.perf_counter()
            if now < next_t:
                time.sleep(next_t - now)
            else:
                n_late += 1
        last = readback.take()  # flush the last staged image
        if last is not None:
            _publish(last)
        ok = True
    except KeyboardInterrupt:
        ok = True  # a clean stop: a failing encode should still surface
    finally:
        dt = time.perf_counter() - t0
        rate = n / dt if dt > 0 else 0.0
        extra = extra_stats() if extra_stats else ""
        print(
            f"live: {n} frames in {dt:.2f}s ({rate:.1f} fps, "
            f"{n_late} late), {extra}published {server.n_published}"
        )
        try:
            if tee is not None:
                tee.close(raise_errors=ok)
        finally:
            server.stop()  # runs even when the tee close raises
    return 0


def _run_live(args, dock, src) -> int:
    """Stream the dock at source rate to an MJPEG-over-HTTP viewer.

    The reference's dock is live inside OBS's render loop
    (src/scope-widget.cpp:99-175); this is the standalone equivalent: every
    decoded frame goes through the shared capture and the fused one-program
    render, and the composited panel is pushed to connected browsers.
    """

    use_nv12 = getattr(src, "can_stream_nv12", False)

    def produce(frame):
        if use_nv12:
            dock.push_nv12(*frame, cs=getattr(src, "cs", None),
                           shift=getattr(src, "nv12_shift", 0))
        else:
            dock.push_frame(frame)
        # device-resident panel: _live_serve pipelines the host readback
        # one frame deep (the reference's stagesurface pattern)
        return dock.render_async(width=args.out_width, height=args.out_height)

    def stats():
        return (
            f"processed {dock.hub.frames_processed}, "
            f"interleave-skipped {dock.hub.frames_skipped}, "
        )

    return _live_serve(args, src, produce, "dock", stats)


def cmd_scope(args) -> int:
    from .models import FalseColor, FocusPeaking, Histogram, Vectorscope, Waveform, Zebra
    from .utils.image_io import load_lut, write_png
    from . import config as cfg

    scopes = {
        "vectorscope": (Vectorscope, cfg.VectorscopeConfig),
        "waveform": (Waveform, cfg.WaveformConfig),
        "histogram": (Histogram, cfg.HistogramConfig),
        "zebra": (Zebra, cfg.ZebraConfig),
        "falsecolor": (FalseColor, cfg.FalseColorConfig),
        "focuspeaking": (FocusPeaking, cfg.FocusPeakingConfig),
    }
    cls, config_cls = scopes[args.scope]
    scope = cls(config_cls(target_scale=args.scale), device=args.device)
    if args.lut and args.scope == "falsecolor":
        scope.update(use_lut=True, lut=load_lut(args.lut))
    src = _make_source(args)
    use_nv12 = getattr(src, "can_stream_nv12", False)

    def push(frame):
        if use_nv12:
            scope.push_nv12(*frame, cs=getattr(src, "cs", None),
                            shift=getattr(src, "nv12_shift", 0))
        else:
            scope.push_frame(frame)
        scope._hub.tick()  # publish double buffers

    if args.live:
        # the reference's per-scope fullscreen "Open Projector" menu entry
        # (src/scope-widget.cpp:467-471): one scope, served live;
        # device-resident image — _live_serve pipelines the readback
        def produce(frame):
            push(frame)
            return scope.render_image()

        return _live_serve(args, src, produce, args.scope)
    import numpy as np

    tee = _make_tee(args, src)
    img = None
    ok = False
    try:
        frames_it = (
            src.frames_nv12(args.frames) if use_nv12 else src.frames(args.frames)
        )
        for frame in frames_it:
            push(frame)
            if tee is not None:
                img = scope.render()
                if img is not None:
                    img = tee.write(img)
        ok = True
    finally:
        if tee is not None:
            tee.close(raise_errors=ok)
    if img is None:
        img = scope.render()
    if img is None:
        print("no frames processed", file=sys.stderr)
        return 1
    from .utils.image_io import write_png as _wp

    img = np.asarray(img)
    _wp(args.out, img)
    print(f"{args.scope}: {img.shape[1]}x{img.shape[0]} -> {args.out}")
    return 0


def cmd_info(args) -> int:
    import torch

    from . import __version__, _kernels
    from .runtime import native

    cuda = args.device == "cuda"
    print(
        json.dumps(
            {
                "version": __version__,
                "torch": torch.__version__,
                "cuda": torch.version.cuda,
                "device": args.device,
                "device_name": torch.cuda.get_device_name(0) if cuda else None,
                "capability": list(torch.cuda.get_device_capability(0)) if cuda else None,
                "device_count": torch.cuda.device_count(),
                "kernels_built": _kernels.built(),
                "native_runtime": native.available(),
            },
            indent=2,
        )
    )
    return 0


# every subcommand's ``--device`` default: the card (a test may point it at
# the CPU for a ``main()`` it runs in-process)
_DEFAULT_DEVICE = "cuda"


def _check_device(device: str) -> bool:
    """False (after saying why on stderr) when ``device`` is ``cuda`` and
    no CUDA GPU is available: the CLI never falls back to the CPU."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA GPU is available (torch.cuda.is_available() is "
              "False); pass --device cpu to run on the CPU", file=sys.stderr)
        return False
    return True


def _parser() -> argparse.ArgumentParser:
    """The CLI's argument parser: the JAX CLI's subcommands and options,
    each subcommand with ``--device``."""
    p = argparse.ArgumentParser(prog="obs_color_monitor_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_device(sp):
        sp.add_argument("--device", choices=["cuda", "cpu"], default=_DEFAULT_DEVICE,
                        help="where the scopes run (cuda needs a CUDA GPU)")

    def add_io(sp):
        add_device(sp)
        sp.add_argument("--input", help="raw .rgba or .nv12 file (else synthetic)")
        sp.add_argument("--pattern", default="bars", choices=["bars", "ramp", "zoneplate"])
        sp.add_argument("--size", default="1280x720", help="input WxH")
        sp.add_argument("--frames", type=int, default=30)
        sp.add_argument("--scale", type=int, default=2, help="target_scale 1..128")
        sp.add_argument("--colorspace", type=int, choices=[0, 1, 2], default=0)
        sp.add_argument("--out", default="scope.png")

    d = sub.add_parser(
        "dock",
        help="composited scope panel (reference new-dock default: ROI "
        "preview + 5 scopes; toggle via --save/--load-settings)",
    )
    add_io(d)
    d.add_argument("--interleave", type=int, default=1)
    d.add_argument("--roi", help="x0,y0,x1,y1 in scaled coordinates")
    d.add_argument(
        "--one-program",
        action="store_true",
        help="render via make_dock_step (one CUDA graph replay per frame)",
    )
    d.add_argument("--out-width", type=int, default=512)
    d.add_argument("--out-height", type=int, default=1536)
    d.add_argument(
        "--live",
        action="store_true",
        help="serve the dock as a live MJPEG stream instead of writing a PNG "
        "(--frames 0 = until the source ends)",
    )
    d.add_argument("--host", default="127.0.0.1", help="--live bind address")
    d.add_argument("--port", type=int, default=8787, help="--live port")
    d.add_argument(
        "--fps", type=float, default=0.0,
        help="--live pacing (0 = the source's own rate, else 30)",
    )
    d.add_argument(
        "--out-video",
        help="also record every rendered panel to a video file "
        "(.y4m written natively; other extensions encode via the system "
        "ffmpeg)",
    )
    d.add_argument("--save-settings", help="write dock settings JSON")
    d.add_argument("--load-settings", help="read dock settings JSON")
    d.set_defaults(fn=cmd_dock)

    s = sub.add_parser("scope", help="one scope")
    s.add_argument(
        "scope",
        choices=["vectorscope", "waveform", "histogram", "zebra", "falsecolor", "focuspeaking"],
    )
    add_io(s)
    s.add_argument("--lut", help="false-color LUT image")
    s.add_argument(
        "--live",
        action="store_true",
        help="serve this one scope as a live MJPEG stream (the reference "
        "dock's per-scope projector; --frames 0 = until the source ends)",
    )
    s.add_argument("--host", default="127.0.0.1", help="--live bind address")
    s.add_argument("--port", type=int, default=8787, help="--live port")
    s.add_argument(
        "--fps", type=float, default=0.0,
        help="--live pacing (0 = the source's own rate, else 30)",
    )
    s.add_argument(
        "--out-video",
        help="also record every rendered scope image to a video file "
        "(.y4m written natively; other extensions encode via the system "
        "ffmpeg)",
    )
    s.set_defaults(fn=cmd_scope)

    i = sub.add_parser("info", help="device/runtime info")
    add_device(i)
    i.set_defaults(fn=cmd_info)
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if not _check_device(args.device):
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
