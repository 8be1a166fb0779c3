"""stage.track_ms: the ms a frame of the step's ``track`` stage on the card
(the model pyramid, the Gauss-Newton levels and the gate; no span at a
given pose), from the program's span ``track`` (marks at the stage's entry
and exit inside the captured graph); the mean over the window's frames
that the span ring holds."""
from benchmark.trace import span_ms


def read(run):
    return span_ms(run["spans"], "track")
