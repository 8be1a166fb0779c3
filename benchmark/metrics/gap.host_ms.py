"""gap.host_ms: the ms the card waits for the host between two steps, from
the end of one frame's span ``step`` to the start of the next frame's
(the pose read, the loop, the upload and the launch); the mean over the
pairs of consecutive window frames that the span ring holds."""


def read(run):
    spans = run["spans"]
    if not spans:
        return None
    steps = sorted((f, s, e) for f, name, _, s, e in spans["spans"] if name == "step")
    gaps = [b[1] - a[2] for a, b in zip(steps, steps[1:]) if b[0] == a[0] + 1]
    return sum(gaps) / len(gaps) / 1e6 if gaps else None
