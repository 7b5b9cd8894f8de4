"""replay_ms: the card's time in the captured step's graph per frame, in
ms: the program's CUDA-event pairs around ``graph.replay()`` (``step.replay``
device times), their mean times the replays per frame the worker consumed.
A pair opens as the host starts the graph's launch, so where the host
launches the graph's nodes more slowly than the card runs them, the card's
wait for the launch counts in it.  None off a card, where no events are
made."""

from ..spans import device, frames, pairs


def read(run):
    n, t = frames(run), device(run, "step.replay")
    return sum(t) / len(t) * pairs(run, "step.replay") / n if n and t else None
