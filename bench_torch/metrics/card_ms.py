"""card_ms: the card's time per frame, in ms: the device time of every
kernel and device-to-device copy the workers run on the card (the captured
dock step, its input and output copies) over the panels that landed in
the traced window.  The copies between host and card (the producers'
uploads, the sink's panel to the host) are left out: they run on the copy
engines, beside the rest of a video pipeline's work, at a speed the host's
memory sets.  What the scopes take of the card, frame by frame, from the
pipeline they monitor (OBS's render and encoder).  Read from the
profiler's trace, which a run takes whenever its cell reports this."""

HOST_COPIES = ("HtoD", "DtoH")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    n = sum(1 for f in run.frames if f.t_landed is not None and tr["lo"] <= f.t_landed < tr["hi"])
    ops = [e - s for name, s, e in tr["ops"] if not any(k in name for k in HOST_COPIES)]
    return sum(ops) / n * 1e3 if n and ops else None
