"""setup_s: seconds from the benchmark's start to the end of set-up: torch's
import and CUDA start, the kernel library's load (its nvcc build on a
checkout's first run), the seeded frames, the docks and drivers, and the
warm-up that captures every graph the window replays.  The profiler's
start, which comes after (in every run of a cell that reads the device
trace), is the benchmark's and is left out."""


def read(run):
    return run.window["t_ready"] - run.t_start
