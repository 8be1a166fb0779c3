"""stage.preprocess_ms: the ms a frame of the step's ``preprocess`` stage on
the card (K1, the pyramid when tracked, the bilateral filter alone at a
given pose), from the program's span ``preprocess`` (marks at the stage's
entry and exit inside the captured graph); the mean over the window's
frames that the span ring holds."""
from benchmark.trace import span_ms


def read(run):
    return span_ms(run["spans"], "preprocess")
