"""step.device_ms: the ms a frame of the captured step on the card, from
the program's span ``step`` (its first mark to its last); the mean over
the window's frames that the span ring holds."""
from benchmark.trace import span_ms


def read(run):
    return span_ms(run["spans"], "step")
