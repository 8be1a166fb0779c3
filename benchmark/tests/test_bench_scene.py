"""The traffic generator: frames and poses are a function of the seed."""
import numpy as np
import pytest
import torch

from benchmark import scene, spec

SENSOR = {"width": 80, "height": 60, "fx": 517.3 / 8, "fy": 516.5 / 8, "cx": 39.5, "cy": 31.5,
          "depth_units_per_m": 5000}


@pytest.mark.parametrize("traffic", ["desk", "orbit"])
def test_same_seed_same_frames(traffic):
    t = spec.load_json(spec.HERE / "traffic" / f"{traffic}.json")
    a = scene.make_stream(t, SENSOR, 2**31 + 11, "cpu")
    b = scene.make_stream(t, SENSOR, 2**31 + 11, "cpu")
    c = scene.make_stream(t, SENSOR, 2**31 + 12, "cpu")
    assert len(a) == scene.turn_length(t) == 463
    assert np.array_equal(a.depth, b.depth) and np.array_equal(a.color, b.color)
    assert np.array_equal(a.rotation, b.rotation) and np.array_equal(a.translation, b.translation)
    assert not np.array_equal(a.depth, c.depth)           # the noise follows the seed
    assert np.array_equal(a.rotation, c.rotation)         # the work does not
    assert a.depth.dtype == np.uint16 and a.color.dtype == np.uint8
    valid = a.depth > 0
    assert 0.3 < valid.mean() < 1.0


def test_trajectory_is_a_closed_circle_at_the_stated_speed():
    t = spec.load_json(spec.HERE / "traffic" / "desk.json")
    rot, trans = scene.trajectory(t)
    step = torch.linalg.vector_norm(trans[1] - trans[0]).item()
    assert abs(step * 30 - 0.41) < 0.01                    # m/s at 30 Hz
    rel = rot[0].T @ rot[1]
    angle = np.degrees(np.arccos((torch.trace(rel).item() - 1) / 2))
    assert abs(angle - 0.777) < 0.01
    for R in rot[::50]:
        assert torch.allclose(R @ R.T, torch.eye(3, dtype=R.dtype), atol=1e-12)


def test_stream_loops():
    t = spec.load_json(spec.HERE / "traffic" / "orbit.json")
    s = scene.make_stream(t, SENSOR, 5, "cpu")
    assert np.array_equal(s.frame(3)[0], s.frame(3 + len(s))[0])
    assert np.array_equal(s.frame(7)[1], s.frame(7 + 2 * len(s))[1])
