"""Pipeline configuration.

Field-for-field the reference's ``vulcan_tpu/config.py``: the same names,
defaults and ``__post_init__`` checks, so one set of numbers drives both
packages.  The long calibration notes on each field live in the reference;
the comments here only say what a field is.  Fields that steer TPU-only
layouts (``integrate_gather``, ``assoc_patch``, ``coarse_patch_after``)
keep their names and defaults; the port rejects their TPU-only values
(``pipeline/fusion.check_supported``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    # --- volume geometry ---
    voxel_size: float = 0.008          # meters per voxel
    trunc_dist: float = 0.04           # TSDF truncation band mu (meters)
    max_weight: float = 128.0          # running-average weight clamp W_max

    # --- voxel-block hashing ---
    block_size: int = 8                # voxels per block edge (8^3 blocks)
    num_blocks: int = 65536            # capacity of voxel-block storage
    hash_size: int = 262144            # open-addressed table slots (power of 2)
    max_probes: int = 8                # linear-probe bound for lookup/insert
    max_visible: int = 16384           # capacity of the visible-block list
    alloc_samples: int = 4             # ray samples in [d-mu, d+mu] per pixel
    alloc_subsample: int = 4           # allocate from every Nth pixel (x and y)
    alloc_capacity: int = 8192         # max new+touched unique blocks per frame
    range_scale: int = 16              # coarse min/max range image downscale
    range_stamp: int = 6               # per-block stamp size in coarse cells
    render_grid_size: int = 128        # dense block-coord grid for raycast

    # --- integration ---
    integrate_gather: str = "auto"     # "onehot" (TPU), "flat", "auto"
    integrate_chunk: int = 1024        # visible blocks fused per loop round
    depth_raw_scale: float = 5000.0    # uint16 depth units per meter (TUM)
    depth_min: float = 0.1             # valid depth range (meters)
    depth_max: float = 5.0

    # --- raycast ---
    ray_near: float = 0.1
    ray_far: float = 5.0
    raycast_steps: int = 192           # total sample budget along each ray
    raycast_chunk: int = 64            # coarse-march samples per round
    raycast_fine_chunk: int = 8        # fine-march samples per round
    raycast_coarse: int = 4            # coarse march at 1/N resolution
    raycast_step_scale: float = 0.75   # sample spacing in units of mu
    raycast_coarse_compact: int = 2    # coarse-march survivor compaction
    raycast_fine_compact: int = 4      # fine-march survivor compaction
    refine_steps: int = 1              # trilinear secant polish rounds
    render_mode: str = "splat"         # "splat" or "march"
    splat_fill_rounds: int = 2         # hole-fill dilation rounds
    splat_band: float = 0.3            # |tsdf| gate (mu units) for surfels
    splat_source: str = "surfels"      # "surfels" or "direct"
    surfel_slots: int = 192            # persistent surfel-list slots per block
    splat_backface_cull: bool = True   # cull surfels facing away from the ray
    model_color: str = "luma"          # "luma" or "rgb" model render color
    splat_polish: int = 0              # trilinear snap rounds (0 = off)

    # --- bilateral filter ---
    bilateral_enabled: bool = True
    bilateral_radius: int = 2
    bilateral_sigma_space: float = 2.0
    bilateral_sigma_depth: float = 0.05

    # --- ICP tracking (coarse-to-fine; level 0 = full res) ---
    pyramid_levels: int = 3
    icp_iters: tuple[int, ...] = (3, 5, 16)     # per level, fine -> coarse
    icp_assoc: tuple[int, ...] = (2, 2, 8)      # association rounds per level
    icp_stride: tuple[int, ...] = (2, 1, 1)     # live-pixel stride per level
    assoc_patch: str = "auto"          # "auto", "on", "off", "geom"
    coarse_patch_after: int = 2        # flat coarse rounds before patching
    motion_prediction: float = 0.5     # damped constant-velocity init
    icp_dist_thresh: float = 0.1       # association gates (meters / cos angle)
    icp_normal_thresh: float = 0.8
    icp_damping: float = 1e-4          # relative Levenberg damping on the 6x6
    icp_huber_delta: float = 0.03      # Huber width for point-to-plane (m)
    icp_min_inliers: int = 100         # fewer associated pixels => invalid
    icp_max_error: float = 0.05        # robust rms (m) above which fusion skips
    degen_min_eig: float = 0.01        # degeneracy threshold (0 disables)
    rgb_weight: float = 0.1            # photometric term weight ("combined")
    rgb_huber_delta: float = 0.1       # Huber width for intensity residuals
    auto_photo: bool = True            # depth-mode collapse rescue
    auto_photo_enter: float = 0.02     # arm when geo_degen < this
    auto_photo_hold: int = 60          # armed frames per weak reading
    photo_levels: int = 2              # photometric rows on the coarsest N

    # --- profiling ---
    ablate: str = ""                   # stages to skip in fusion.step

    # --- mesh extraction ---
    max_mesh_triangles: int = 2_000_000
    mesh_chunk: int = 1024
    mesh_active_frac: float = 0.25
    mesh_cache_active_frac: float = 0.3
    mesh_dirty_eps: float = 8e-3       # tsdf delta that marks a block dirty
    mesh_slots: int = 256

    def __post_init__(self):
        assert self.block_size == 8, "voxel blocks are 8^3 (InfiniTAM layout)"
        assert self.hash_size & (self.hash_size - 1) == 0, "hash_size must be a power of 2"
        assert len(self.icp_iters) == self.pyramid_levels
        assert len(self.icp_assoc) == self.pyramid_levels
        if not isinstance(self.icp_stride, int):
            assert len(self.icp_stride) == self.pyramid_levels
        assert self.max_visible & (self.max_visible - 1) == 0, (
            "max_visible must be a power of 2 (chunked-loop divisibility)"
        )
        assert self.integrate_chunk & (self.integrate_chunk - 1) == 0, (
            "integrate_chunk must be a power of 2 (chunked-loop divisibility)"
        )
        assert self.num_blocks & (self.num_blocks - 1) == 0, (
            "num_blocks must be a power of 2 (chunked-loop divisibility)"
        )
        assert self.alloc_capacity & (self.alloc_capacity - 1) == 0, (
            "alloc_capacity must be a power of 2 (chunked-loop divisibility)"
        )
        assert self.mesh_chunk & (self.mesh_chunk - 1) == 0, (
            "mesh_chunk must be a power of 2 (chunked-loop divisibility)"
        )
        assert self.model_color in ("luma", "rgb"), self.model_color
        assert 0.0 <= float(self.motion_prediction) <= 1.0, (
            "motion_prediction is an extrapolation fraction in [0, 1] "
            "(values above 0.5 risk tracking instability -- see "
            "pipeline/fusion.predict_pose)"
        )
        assert max(self.ray_far, self.depth_max) <= 12.0, (
            "ray_far/depth_max above 12 m would overflow the 21-bit "
            "camera-relative vertex packing in the ICP model maps "
            "(+-16 m span); lower the range or widen _VERTEX_SCALE"
        )

    @property
    def block_volume(self) -> int:
        return self.block_size ** 3

    @property
    def block_extent(self) -> float:
        """World-space edge length of one voxel block (meters)."""
        return self.block_size * self.voxel_size


# Small configs for tests on the CPU.
TINY = Config(
    refine_steps=2,
    num_blocks=2048,
    hash_size=8192,
    max_visible=1024,
    raycast_steps=96,
    max_mesh_triangles=200_000,
)
