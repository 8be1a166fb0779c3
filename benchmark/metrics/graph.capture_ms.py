"""graph.capture_ms: the ms the capture of the step's CUDA graphs took,
summed over the kinds of frame captured (``Pipeline.graph_stats``)."""


def read(run):
    stats = run["graph_stats"]
    return sum(s["capture_ms"] for s in stats.values()) if stats else None
