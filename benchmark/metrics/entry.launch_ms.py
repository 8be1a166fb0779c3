"""entry.launch_ms: the host's ms a frame in the launch of the step
(``StepGraphs.run``'s copy into the graph's inputs and its replay), from
the program's host span ``launch``; the mean over the window's frames
that the span ring holds."""
from benchmark.trace import span_ms


def read(run):
    return span_ms(run["spans"], "launch")
