"""track.roofline: the share of its roofline the track's hand kernels
reach (H1a ``associate_kernel`` and the fused GN step ``gn_step_kernel``):
the least time their launches of the profiled frames could take (bytes
at the memory rate or f32 operations at the peak, the larger, each
launch by ``roofline.icp_bytes_ops``) over their traced device time."""

from benchmark.roofline import track_launches

# The counted kernels read from the trace: the run fails unless the trace
# holds every launch the card counted of them.
TRACED = ("icp_associate", "icp_rows_solve")


def read(run):
    span = run["span"]
    frames = span["frames"]
    conf = run["config"]
    sensor = conf["sensor"]
    per_frame = track_launches(conf["settings"], conf["mode"], sensor["height"], sensor["width"])
    want = {"icp_associate": sum(k for kind, *_, k in per_frame if kind == "associate"),
            "icp_rows_solve": sum(k for kind, *_, k in per_frame if kind == "rows_solve")}
    if any(span["card"][name] != n * frames for name, n in want.items()):
        return None      # the track ran off its top-level path (a branch)
    t = sum(e - s for name, s, e in span["device"]
            if "associate_kernel" in name or "gn_step_kernel" in name) / 1e9
    return 100.0 * run["track_bound_s"] * frames / t if t > 0 else None
