"""stage.allocate_ms: the ms a frame of the step's ``allocate`` stage on the
card (``allocate_for_frame`` and ``update_visibility``), from the
program's span ``allocate`` (marks at the stage's entry and exit inside
the captured graph); the mean over the window's frames that the span ring
holds."""
from benchmark.trace import span_ms


def read(run):
    return span_ms(run["spans"], "allocate")
