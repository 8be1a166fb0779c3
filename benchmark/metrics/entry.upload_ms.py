"""entry.upload_ms: the host's ms a frame in ``Pipeline.process``'s
upload of the frame's depth and colour arrays, from the program's host
span ``upload``; the mean over the window's frames that the span ring
holds."""
from benchmark.trace import span_ms


def read(run):
    return span_ms(run["spans"], "upload")
