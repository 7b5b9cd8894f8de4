"""idle_share: the share of the traced slice in which no operation ran on
the card, in % (1 minus the union of the device intervals)."""

from ..arith import busy


def read(run):
    tr = run.trace
    if tr is None or tr["hi"] <= tr["lo"]:
        return None
    return 100.0 * (1.0 - busy((s, e) for _, s, e in tr["ops"]) / (tr["hi"] - tr["lo"]))
