"""entry.host_ms: the host's ms in ``Pipeline.process`` a frame (the
upload of the frame's arrays and the launch of the captured step), the
benchmark's own host clock around the call before the pose is read; the
mean over the window's frames."""


def read(run):
    host = run["host_s"]
    return 1e3 * sum(host) / len(host) if host else None
