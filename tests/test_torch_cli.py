"""The port's CLI (``vulcan_tpu_torch.cli.main`` with ``--device cpu``)
against the reference's (``vulcan_tpu.cli.main``) on the same argv:
tests/test_cli.py's tiny preset at 160x120, voxel 0.02, every output flag
in one run a package; the error paths, the ``mesh`` subcommand, the
``--resume`` fault both packages share, a mini TUM sequence, and the host
reads the CLI loop adds (none).

The full runs fuse the same input: the port's CLI is handed the
reference CLI's rendered frames and poses (``_reference_frames``), so
what differs is the step alone: the loop is held bit for bit against
``Pipeline.process`` on the same frames.  Where both packages fuse at the
same poses (the TUM run with ``--known-poses``), block and triangle
counts are held to ROADMAP section 3's allowance for integer results
derived from floats (``COUNT_TOL``).  In the tracked combined-mode run
the two steps' float32 reassociation parts the trajectories by up to
0.82 mm over the 6 frames (0.07 mm after frame 1, then amplified by
tracking at 160x120), and the counts fuse along those poses: measured
0 of 454 blocks and 55 of 35543 triangles (0.155%), held to
``TRACKED_COUNT_TOL``; the trajectory to ``TRAJ_TOL``, ATE (measured
0.23 mm apart) to ``ATE_TOL``."""
import json
import types

import numpy as np
import pytest

from vulcan_tpu.cli import main as jmain
from vulcan_tpu_torch import cli
from vulcan_tpu_torch.tools.cli_counts import counting

from ._torch_port import make_mini_tum, se3_t, t

ARGS_COMMON = [
    "--preset", "tiny", "--width", "160", "--height", "120",
    "--voxel-size", "0.02",
]
CPU = ["--device", "cpu"]
TRAJ_TOL = 1e-3            # m, per trajectory row (translation) and quaternion entry
ATE_TOL = 5e-4             # m
COUNT_TOL = 1e-3           # relative: blocks and triangles fused at the same poses
TRACKED_COUNT_TOL = 2e-3   # relative: the same along the two tracked trajectories


def _reference_frames(args, device):
    """The reference CLI's synthetic frames and ground-truth poses, as the
    port's CLI takes them (tensors on ``device``, a CPU ``SE3``)."""
    from vulcan_tpu.cli import _synthetic_frames as j_frames

    for depth, color, pose in j_frames(args):
        yield t(depth).to(device), t(color).to(device), se3_t(pose)


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else {}), out


def _traj(path):
    return np.loadtxt(path, comments="#", ndmin=2)


def _full_run(main, extra, tmp, capsys):
    tmp.mkdir()
    paths = {k: str(tmp / name) for k, name in (
        ("mesh", "m.ply"), ("snap", "s.npz"), ("traj", "traj.txt"))}
    argv = ["run", *ARGS_COMMON, "--synthetic", "6",
            "--mesh-out", paths["mesh"], "--snapshot-out", paths["snap"],
            "--traj-out", paths["traj"], "--eval-ate", "--profile",
            "--verbose", "--log-every", "2", "--mesh-every", "2", *extra]
    rc, report, lines = _run(main, argv, capsys)
    assert rc == 0
    return dict(report=report, logs=[json.loads(x) for x in lines[:-1]
                                     if x.startswith("{")], **paths)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    capsys = _Capture()
    tmp = tmp_path_factory.mktemp("cli")
    with capsys, pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "_synthetic_frames", _reference_frames)
        port = _full_run(cli.main, CPU, tmp / "port", capsys)
        ref = _full_run(jmain, [], tmp / "ref", capsys)
    return port, ref


class _Capture:
    """capsys for a module-scoped fixture: stdout into a buffer."""

    def __enter__(self):
        import contextlib
        import io

        self._buf = io.StringIO()
        self._cm = contextlib.redirect_stdout(self._buf)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        self._cm.__exit__(*exc)

    def readouterr(self):
        out = self._buf.getvalue()
        self._buf.seek(0)
        self._buf.truncate()
        return types.SimpleNamespace(out=out)


def _close(a, b, rel):
    return abs(a - b) <= rel * max(a, b)


def test_cli_report_matches_reference(runs):
    (port, ref) = runs
    p, r = port["report"], ref["report"]
    assert set(p) == set(r)
    for key in ("frames", "frame", "track_failures", "track_degen_frames",
                "alloc_overflow", "visible_overflow", "photo_armed_frames",
                "mesh_extractions"):
        assert p[key] == r[key], key
    assert p["frames"] == 6 and p["track_failures"] == 0
    for key in ("allocated_blocks", "visible_blocks", "mesh_triangles",
                "mesh_triangles_online"):
        assert _close(p[key], r[key], TRACKED_COUNT_TOL), (key, p[key], r[key])
    assert p["mesh_triangles"] == p["mesh_triangles_online"]
    assert abs(p["ate_rmse_m"] - r["ate_rmse_m"]) < ATE_TOL
    assert p["ate_rmse_m"] < 0.01 and p["track_inliers"] > 1000
    assert set(p["stage_ms"]) == set(r["stage_ms"]) == {"step"}
    assert [set(d) for d in port["logs"]] == [set(d) for d in ref["logs"]]
    assert [d["frame"] for d in port["logs"]] == [1, 3, 5]


def test_cli_trajectory_matches_reference(runs):
    port, ref = runs
    tp, tr = _traj(port["traj"]), _traj(ref["traj"])
    assert tp.shape == tr.shape == (6, 8)
    np.testing.assert_array_equal(tp[:, 0], tr[:, 0])
    np.testing.assert_allclose(tp[:, 1:], tr[:, 1:], rtol=0, atol=TRAJ_TOL)
    np.testing.assert_allclose(np.linalg.norm(tp[:, 4:], axis=1), 1.0, atol=1e-5)


def test_cli_outputs_are_readable(runs):
    from vulcan_tpu.pipeline.api import Volume as JVolume
    from vulcan_tpu_torch.io.ply import read_ply

    port, ref = runs
    head = open(port["mesh"], "rb").read(80)
    assert head.startswith(b"ply\n") and b"comment vulcan-tpu mesh (native)" in head
    assert len(read_ply(port["mesh"])[2]) == port["report"]["mesh_triangles"]
    # The port's snapshot is the reference's v4 format.
    vol = JVolume(cli._make_config(cli.build_parser().parse_args(
        ["mesh", "x", "--out", "y", "--preset", "tiny", "--voxel-size", "0.02"])))
    vol.load(port["snap"])
    assert vol.num_allocated == port["report"]["allocated_blocks"]


def test_cli_mesh_subcommand_on_port_snapshot(runs, tmp_path, capsys):
    port, _ = runs
    out = str(tmp_path / "m2.ply")
    rc, report, _ = _run(cli.main, ["mesh", port["snap"], "--out", out, *CPU,
                                    "--preset", "tiny", "--voxel-size", "0.02"],
                         capsys)
    assert rc == 0
    assert report == {"snapshot": port["snap"],
                      "allocated_blocks": port["report"]["allocated_blocks"],
                      "mesh_triangles": port["report"]["mesh_triangles"],
                      "mesh": out}
    assert open(out, "rb").read() == open(port["mesh"], "rb").read()


def test_cli_error_paths(tmp_path, capsys):
    assert cli.main(["run", *CPU]) == 2
    assert cli.main(["run", *CPU, "--dataset", "/nonexistent-seq"]) == 1
    assert "not a TUM sequence directory" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        cli.main(["frobnicate"])
    assert e.value.code == 2
    assert cli.main(["mesh", str(tmp_path / "no.npz"), "--out",
                     str(tmp_path / "m.ply"), *CPU]) == 1
    bad = tmp_path / "v3.npz"
    np.savez(bad, __snapshot_version__=np.asarray(3))
    assert cli.main(["mesh", str(bad), "--out", str(tmp_path / "m.ply"), *CPU]) == 1
    assert "cannot load snapshot" in capsys.readouterr().err


def test_cli_resume_meshes_only_blocks_dirtied_after_it(runs, tmp_path, capsys):
    """The reference's ``--resume`` pairs an empty mesh cache with a
    snapshot whose dirty flags the last re-mesh cleared, so the online
    mesh holds only blocks dirtied after the resume (a reference-side
    fault, mirrored).  Both packages resume from the port's snapshot and
    fuse the next frames at their true poses: the same online triangle
    count, fewer than a full extraction of the same volume."""
    port, _ = runs
    argv = ["run", *ARGS_COMMON, "--synthetic", "3", "--resume", port["snap"],
            "--known-poses", "--mesh-every", "3"]
    got = {}
    for name, main, extra in (("port", cli.main, CPU), ("ref", jmain, [])):
        rc, report, _ = _run(main, argv + ["--mesh-out", str(tmp_path / f"{name}.ply"),
                                           *extra], capsys)
        assert rc == 0 and report["mesh_extractions"] == 1
        assert report["allocated_blocks"] >= port["report"]["allocated_blocks"]
        assert 0 < report["mesh_triangles_online"] < report["mesh_triangles"]
        got[name] = report
    assert got["port"]["mesh_triangles_online"] == got["ref"]["mesh_triangles_online"]
    assert got["port"]["allocated_blocks"] == got["ref"]["allocated_blocks"]


def test_cli_tum_dataset_known_poses_matches_reference(tmp_path, capsys):
    root = make_mini_tum(tmp_path / "seq")
    reports = {}
    for name, main, extra in (("port", cli.main, CPU), ("ref", jmain, [])):
        traj = str(tmp_path / f"{name}.txt")
        rc, report, _ = _run(main, ["run", "--preset", "tiny", "--voxel-size", "0.02",
                                    "--dataset", str(root), "--known-poses",
                                    "--eval-ate", "--traj-out", traj,
                                    "--mesh-out", str(tmp_path / f"{name}.ply"),
                                    *extra], capsys)
        assert rc == 0
        reports[name] = (report, _traj(traj))
    (p, tp), (r, tr) = reports["port"], reports["ref"]
    assert p["frames"] == r["frames"] == 4
    assert p["ate_rmse_m"] < 1e-4 and r["ate_rmse_m"] < 1e-4
    for key in ("allocated_blocks", "mesh_triangles"):
        assert _close(p[key], r[key], COUNT_TOL), (key, p[key], r[key])
    assert p["allocated_blocks"] > 20 and p["mesh_triangles"] > 1000
    # Known poses: both trajectories are the ground truth, at the sensor's
    # timestamps.
    np.testing.assert_array_equal(tp, tr)
    np.testing.assert_array_equal(tp[:, 0], [1.0, 1.05, 1.1, 1.15])


def test_cli_loop_adds_no_host_reads(tmp_path, capsys):
    """Between two steps the CLI's own code reads nothing from the device
    and never synchronizes: the poses stay on the device until the loop
    ends.  Its step reads, its trajectory file and its report equal
    ``Pipeline.process``'s on the same frames, bit for bit."""
    from vulcan_tpu_torch import Pipeline
    from vulcan_tpu_torch.utils.evaluate import write_tum_trajectory
    from vulcan_tpu_torch.utils.sync import read_int

    traj = tmp_path / "cli.txt"
    argv = ["run", *ARGS_COMMON, *CPU, "--synthetic", "5", "--mode", "depth",
            "--eval-ate", "--traj-out", str(traj)]
    with counting() as counts:
        rc, report, _ = _run(cli.main, argv, capsys)
    assert rc == 0 and report["frames"] == 5
    assert counts["loop_windows"] == 3
    assert counts["loop_transfers"] == 0 and counts["loop_syncs"] == 0
    assert counts["frames"] == 5 and counts["mesh_calls"] == 0

    args = cli.build_parser().parse_args(argv)
    frames = list(cli._synthetic_frames(args, "cpu"))
    pipe = Pipeline(cli._make_config(args), cli._synthetic_camera(args), 120, 160,
                    init_pose=frames[0][2], mode="depth", device="cpu")
    read_int.count = 0
    poses = []
    for d, c, _ in frames:
        pipe.process(d, c)
        poses.append(pipe.pose)
    assert counts["step_reads"] == read_int.count == 3 * 5
    diag = pipe.diagnostics()
    assert {k: report[k] for k in diag} == diag
    write_tum_trajectory(tmp_path / "pipe.txt", range(5),
                         [p.rotation.numpy() for p in poses],
                         [p.translation.numpy() for p in poses])
    assert traj.read_bytes() == (tmp_path / "pipe.txt").read_bytes()
