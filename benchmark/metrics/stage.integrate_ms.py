"""stage.integrate_ms: the ms a frame of the step's ``integrate`` stage on
the card (the image pack, the inverse pose and I1's launch), from the
program's span ``integrate`` (marks at the stage's entry and exit inside
the captured graph); the mean over the window's frames that the span ring
holds."""
from benchmark.trace import span_ms


def read(run):
    return span_ms(run["spans"], "integrate")
