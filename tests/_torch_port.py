"""Shared fixtures of the ``test_torch_*`` files: one scene, one config,
and helpers that carry values between the JAX package (the reference) and
the PyTorch port as numpy arrays."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import vulcan_tpu_torch as P
from vulcan_tpu.config import TINY as J_TINY
from vulcan_tpu.core.camera import PinholeCamera as JCam
from vulcan_tpu.io.synthetic import orbit_poses, render_scene_depth
from vulcan_tpu_torch.core.se3 import SE3 as TSE3
from vulcan_tpu_torch.ops import cuda_kernels
from vulcan_tpu_torch.utils.convert import flatten

# The suite runs as several worker processes on the machine's cores: one
# intra-op thread a worker keeps PyTorch's thread pools from spinning
# against each other (with a pool as wide as the machine in every worker,
# a 150x200 port step ran ~50x slower than alone).
torch.set_num_threads(1)

# tests/test_pipeline.py's closed-loop configuration and scene.
_KW = dict(
    voxel_size=0.015,
    trunc_dist=0.06,
    icp_iters=(4, 5, 16),
    num_blocks=8192,
    hash_size=32768,
    max_visible=8192,
    depth_max=4.0,
)
CFG_J = dataclasses.replace(J_TINY, **_KW)
CFG_T = dataclasses.replace(P.TINY, **_KW)
CAM_J = JCam.create(160.0, 160.0, 99.5, 74.5)
CAM_T = P.PinholeCamera.create(160.0, 160.0, 99.5, 74.5)
H, W = 150, 200
SPHERES = (
    ((0.0, 0.0, 0.0), 0.5),
    ((0.6, 0.3, 0.2), 0.25),
    ((-0.5, 0.4, -0.1), 0.3),
)
FLOOR = -0.6


def orbit(n, span_per_frame=0.9 * np.pi / 16):
    """JAX ground-truth poses of the closed-loop orbit (~18 cm/frame)."""
    return orbit_poses(n, (0.0, 0.0, 0.0), radius=1.6, height=0.35,
                       span=span_per_frame * n)


def scene(pose_j):
    """(depth (H, W), color (H, W, 3)) float32 numpy frames, rendered by
    the reference's synthetic scene."""
    d, c = render_scene_depth(CAM_J, pose_j, H, W, SPHERES, FLOOR)
    return np.asarray(d), np.asarray(c)


def jflat(obj):
    """Flatten a JAX dataclass tree to {dotted path: numpy copy}; copies,
    so a later donated step cannot invalidate the arrays."""
    return {k: np.array(v, copy=True) for k, v in flatten(obj).items()}


def t(x):
    """numpy / JAX array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(x, copy=True))


def se3_t(p) -> TSE3:
    """A JAX package SE3 -> the port's."""
    return TSE3(t(p.rotation), t(p.translation))


# The main path's kernel entries of ``cuda_kernels``: K1, K2, H1a-H1c, the
# fused track step, R1, I1 and S1.
KERNEL_ENTRIES = ("bilateral", "fill_smooth", "icp_associate", "icp_rows", "icp_solve",
                  "icp_rows_solve", "range_image", "integrate", "splat_zbuf")


@pytest.fixture
def no_kernel(monkeypatch):
    """Every main-path kernel entry raises: a test that takes this fixture
    fails if a CPU tensor reaches a kernel in place of its plain version."""
    for name in KERNEL_ENTRIES:
        def reached(*_args, _name=name, **_kwargs):
            raise AssertionError(f"a CPU tensor reached kernel {_name}")
        monkeypatch.setattr(cuda_kernels, name, reached)


def close_frac(a, b, atol):
    """Fraction of entries of two arrays that differ by more than atol."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.mean(np.abs(a.astype(np.float64) - b.astype(np.float64)) > atol))


def rot_angle(Ra, Rb):
    """Angle (rad) between two float32 rotations, from the antisymmetric
    part of Ra^T Rb: unlike arccos of the trace, it stays accurate for
    small angles when the matrices are orthonormal only to float32."""
    m = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    w = 0.5 * np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
    return float(np.arcsin(min(1.0, np.linalg.norm(w))))


# --- tests/test_mcubes.py's sphere scene (marching cubes and the API) ---
SPHERE_KW = dict(voxel_size=0.02, trunc_dist=0.08)
MC_CFG_J = dataclasses.replace(J_TINY, **SPHERE_KW)
MC_CFG_T = dataclasses.replace(P.TINY, **SPHERE_KW)
MC_CAM_J = JCam.create(120.0, 120.0, 79.5, 59.5)
MC_CAM_T = P.PinholeCamera.create(120.0, 120.0, 79.5, 59.5)
MC_H, MC_W = 120, 160
SPHERE_CENTER = (0.0, 0.0, 0.0)
SPHERE_RADIUS = 0.5


def full_coverage_poses(n_ring=8):
    """Rings at three latitudes and both poles: the whole sphere."""
    from vulcan_tpu.io.synthetic import look_at

    poses = []
    for height in (-1.0, 0.0, 1.0):
        poses += orbit_poses(n_ring, SPHERE_CENTER, radius=1.3, height=height)
    poses.append(look_at((0.01, 0.0, 1.7), SPHERE_CENTER))
    poses.append(look_at((0.01, 0.0, -1.7), SPHERE_CENTER))
    return poses


def sphere_views(n_views):
    """tests/test_mcubes.py's ``fused_sphere_volume`` orbit."""
    return orbit_poses(n_views, SPHERE_CENTER, radius=1.6, height=0.2)


def sphere_frames(poses):
    """(depth, color) numpy frames of the analytic sphere, rendered by the
    reference's ``render_sphere_depth``."""
    from vulcan_tpu.io.synthetic import render_sphere_depth

    return [
        tuple(np.asarray(x) for x in render_sphere_depth(
            MC_CAM_J, p, MC_H, MC_W, SPHERE_CENTER, SPHERE_RADIUS))
        for p in poses
    ]


def reference_sphere_volume(poses, frames, cfg_j=MC_CFG_J):
    """The reference's volume after fusing the frames at their poses
    (allocate, visibility, integrate over the visible list, as
    tests/test_mcubes.py does), one jitted call a frame."""
    import jax

    from vulcan_tpu.core.frame import make_frame as j_make_frame
    from vulcan_tpu.ops import allocate as jal
    from vulcan_tpu.ops import blocks as jB
    from vulcan_tpu.ops import sparse as jsp

    @jax.jit
    def fuse(vol, depth, color, pose):
        frame = j_make_frame(depth, color, MC_CAM_J, pose)
        vol, _, _ = jal.allocate_for_frame(vol, frame.depth, MC_CAM_J, pose, cfg_j)
        vol = jal.update_visibility(vol, MC_CAM_J, pose, MC_H, MC_W, cfg_j)
        return jsp.integrate_sparse(vol, frame, cfg_j)

    vol = jB.create_volume(cfg_j)
    for pose, (d, c) in zip(poses, frames):
        vol = fuse(vol, d, c, pose)
    return vol


def port_sphere_volume(poses, frames, cfg_t=MC_CFG_T, each=None):
    """The port's five-class ``Volume`` after integrating the frames at
    their poses on the CPU; ``each(k, volume)`` runs after frame k."""
    volume = P.Volume(cfg_t, device="cpu")
    integrator = P.Integrator(volume)
    for k, (pose, (d, c)) in enumerate(zip(poses, frames)):
        integrator.integrate(P.make_frame(d, c, MC_CAM_T, se3_t(pose), device="cpu"))
        if each is not None:
            each(k, volume)
    return volume


# --- the reference's five-class API, each method traced under jax.jit ---
def _j_volume(state, cfg_j):
    from vulcan_tpu import Volume as JVolume

    v = JVolume.__new__(JVolume)
    v.config, v.state, v.band = cfg_j, state, None
    return v


def reference_five_class(cfg_j=CFG_J, cam_j=CAM_J, h=H, w=W):
    """(integrate, trace, track) that run the reference's ``Integrator``,
    ``Tracer`` and ``Tracker`` methods jitted on a carried volume state:
    eager JAX takes ~12 s a frame here, jitted ~0.4 s."""
    import jax

    from vulcan_tpu import Integrator as JIntegrator
    from vulcan_tpu import Tracer as JTracer
    from vulcan_tpu import Tracker as JTracker
    from vulcan_tpu import make_frame as j_make_frame

    @jax.jit
    def integrate(state, depth, color, pose):
        v = _j_volume(state, cfg_j)
        JIntegrator(v).integrate(j_make_frame(depth, color, cam_j, pose))
        return v.state

    @jax.jit
    def trace(state, pose):
        v = _j_volume(state, cfg_j)
        render = JTracer(v).trace(cam_j, pose, h, w)
        return v.state, render

    @functools.partial(jax.jit, static_argnums=4)
    def track(model, depth, color, pose, mode="depth"):
        return JTracker(cfg_j, mode).track(
            model, j_make_frame(depth, color, cam_j, pose), init_pose=pose)

    return integrate, trace, track


# --- a fused orbit volume on both sides (the render paths' input) ---
@functools.lru_cache(maxsize=None)
def _fused_orbit_reference():
    import jax.numpy as jnp

    from vulcan_tpu.core.frame import make_frame as j_make_frame
    from vulcan_tpu.ops import allocate as jal
    from vulcan_tpu.ops import blocks as jB
    from vulcan_tpu.ops import sparse as jsp

    poses = orbit(3)
    jv = jB.create_volume(CFG_J)
    for pose in poses[1:]:
        d, c = scene(pose)
        frame = j_make_frame(jnp.asarray(d), jnp.asarray(c), CAM_J, pose)
        jv, band, n_band = jal.allocate_for_frame(jv, frame.depth, CAM_J, pose, CFG_J)
        jv = jal.update_visibility(jv, CAM_J, pose, H, W, CFG_J)
        jv = jsp.integrate_sparse(jv, frame, CFG_J, ids=band, count=n_band)
    return jv, poses[2]


def fused_orbit_volumes():
    """(reference volume, port volume, reference pose, port pose): the
    reference's volume after fusing two orbit frames at their true poses,
    carried to the port, with the visible list of the second pose."""
    from vulcan_tpu_torch.ops import blocks as tB

    jv, pose_j = _fused_orbit_reference()
    tv = tB.VolumeState(**{k: t(v) for k, v in jflat(jv).items()})
    return jv, tv, pose_j, se3_t(pose_j)


# --- a mini TUM sequence (tests/test_cli.py's) ---
TUM_H, TUM_W = 120, 160


def tum_camera_j():
    """The camera the TUM reader derives for a 160x120 sequence (the fr1
    intrinsics scaled to the probed size), as the reference's JAX camera."""
    sx, sy = TUM_W / 640, TUM_H / 480
    return JCam.create(517.3 * sx, 516.5 * sy,
                       (318.6 + 0.5) * sx - 0.5, (255.3 + 0.5) * sy - 0.5)


def make_mini_tum(root, n=4):
    """tests/test_cli.py's mini TUM sequence: n sphere frames on a short
    orbit, 16-bit depth and 8-bit BGR PNGs written by OpenCV, depth.txt,
    rgb.txt and a quaternion groundtruth.txt.  Returns ``root``."""
    import cv2

    from vulcan_tpu.io.synthetic import render_sphere_depth

    camera = tum_camera_j()
    (root / "depth").mkdir(parents=True)
    (root / "rgb").mkdir()
    poses = orbit_poses(n, radius=1.6, height=0.3, span=0.12)
    with open(root / "depth.txt", "w") as fd, open(root / "rgb.txt", "w") as fr, \
            open(root / "groundtruth.txt", "w") as fg:
        fd.write("# ts file\n")
        fg.write("# ts tx ty tz qx qy qz qw\n")
        for i, pose in enumerate(poses):
            depth, color = render_sphere_depth(camera, pose, TUM_H, TUM_W,
                                               (0.0, 0.0, 0.0), 0.5)
            d16 = (np.asarray(depth) * 5000).astype(np.uint16)
            c8 = (np.clip(np.asarray(color), 0, 1) * 255).astype(np.uint8)
            t = 1.0 + 0.05 * i
            cv2.imwrite(str(root / "depth" / f"{i}.png"), d16)
            cv2.imwrite(str(root / "rgb" / f"{i}.png"), c8[..., ::-1])
            fd.write(f"{t} depth/{i}.png\n")
            fr.write(f"{t + 0.001 * (i % 2)} rgb/{i}.png\n")
            R = np.asarray(pose.rotation, np.float64)
            tr = np.asarray(pose.translation, np.float64)
            qw = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
            qx = (R[2, 1] - R[1, 2]) / (4 * qw)
            qy = (R[0, 2] - R[2, 0]) / (4 * qw)
            qz = (R[1, 0] - R[0, 1]) / (4 * qw)
            fg.write(f"{t} {tr[0]} {tr[1]} {tr[2]} {qx} {qy} {qz} {qw}\n")
    return root


# --- the photometric track's inputs (the GN loop's entry points) ---
@functools.lru_cache(maxsize=None)
def photo_track_inputs():
    """tests/test_torch_photo.py's scene: the reference's luma model render
    at orbit pose 2 (two fused frames), its model pyramid on each side, and
    the live pyramid, with intensity, of the frame at pose 3, carried to the
    port.  Returns a dict (cached: build once a worker)."""
    import jax.numpy as jnp

    from vulcan_tpu.core.frame import make_frame as j_make_frame
    from vulcan_tpu.ops import allocate as jal
    from vulcan_tpu.ops import blocks as jB
    from vulcan_tpu.ops import icp as jicp
    from vulcan_tpu.ops import preprocess as jpp
    from vulcan_tpu.ops import sparse as jsp
    from vulcan_tpu.ops import splat as jsplat
    from vulcan_tpu_torch.core.frame import FrameMaps
    from vulcan_tpu_torch.ops import icp as ticp
    from vulcan_tpu_torch.ops.raycast import Render

    flat = max(0.05, 6.0 * CFG_T.voxel_size)
    poses = orbit(4)
    jv = jB.create_volume(CFG_J)
    for pose in poses[1:3]:
        d, c = scene(pose)
        frame = j_make_frame(jnp.asarray(d), jnp.asarray(c), CAM_J, pose)
        jv, band, n_band = jal.allocate_for_frame(jv, frame.depth, CAM_J, pose, CFG_J)
        jv = jal.update_visibility(jv, CAM_J, pose, H, W, CFG_J)
        jv = jsp.integrate_sparse(jv, frame, CFG_J, ids=band, count=n_band)
    rj = jsplat.render_splat(jv, CAM_J, poses[2], H, W, CFG_J,
                             with_color=True, color_space="luma")
    rt = Render(
        **{k: t(getattr(rj, k)) for k in
           ("depth", "vx", "vy", "vz", "nx", "ny", "nz", "color", "valid")},
        camera=CAM_T, pose=se3_t(rj.pose),
    )
    d, c = scene(poses[3])
    live_j = jpp.build_pyramid(
        j_make_frame(jnp.asarray(d), jnp.asarray(c), CAM_J, poses[3]), CFG_J)
    cams_t = [CAM_T, CAM_T.scaled(0.5), CAM_T.scaled(0.5).scaled(0.5)]
    live_t = tuple(
        FrameMaps(t(m.depth), t(m.vertices), t(m.normals), t(m.intensity), cam)
        for m, cam in zip(live_j, cams_t)
    )
    return dict(
        live_j=live_j, live_t=live_t, poses=poses,
        mj=jicp.model_pyramid(rj, 3, flat_thresh=flat),
        mt=ticp.model_pyramid(rt, 3, flat_thresh=flat),
    )
