"""Semantic surround cameras for the E2E camera egos (port of
rift_tpu/ego/sensors.py).

A six-camera pinhole rig (the Bench2Drive layout) is ray-cast from each
ego to the z=0 plane: every ground pixel is labelled with drivable, route,
vehicle, walker and static occupancy, the ego's red-light hazard on the
front camera, and inverse depth, all rendered on the device from the
SimState ([S, N_CAM, H, W, C], channels last as in the JAX package).

The rig is fixed in the ego frame, so the ray table, the per-pixel ground
points (`pixel_ground_table`) and the projection of fixed ego-frame points
(`project_points` of the BEV cell centres) do not depend on the state:
they are computed once per device (the ray table here, the others as
buffers of the E2E model), where the JAX package folds them into constants
under jit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..sim.state import CLASS_STATIC, CLASS_VEHICLE, CLASS_WALKER

# --- rig geometry (Bench2Drive six-camera surround layout) -------------------
# yaw (deg, ccw from vehicle forward), horizontal FOV (deg)
CAMERA_YAWS_DEG = (0.0, 55.0, -55.0, 180.0, 110.0, -110.0)
CAMERA_FOVS_DEG = (70.0, 70.0, 70.0, 110.0, 70.0, 70.0)
NUM_CAMERAS = len(CAMERA_YAWS_DEG)
CAM_HEIGHT = 1.6  # meters above ground
CAM_FORWARD = 0.8  # meters ahead of the box center
IMG_H, IMG_W = 24, 48
MAX_RANGE = 64.0  # ground-hit clip (meters)
ROUTE_WINDOW = 64  # route waypoints sampled around the cursor
ROUTE_HALF_WIDTH = 2.5  # meters: pixel counts as on-route within this

# channel layout
CH_VALID = 0  # ground hit inside range
CH_DRIVABLE = 1
CH_ROUTE = 2
CH_VEHICLE = 3
CH_WALKER = 4
CH_STATIC = 5
CH_RED_LIGHT = 6  # ego red-light hazard, broadcast on the front camera
CH_INV_DEPTH = 7
NUM_CHANNELS = 8


def _rig_rays(h: int = IMG_H, w: int = IMG_W) -> np.ndarray:
    """Static per-camera pixel ray table [N_CAM, h, w, 3] (float32): unit-free
    direction (forward, left, down) in the CAMERA frame, z-forward pinhole
    with square pixels sized by the horizontal FOV."""
    rays = []
    for fov in CAMERA_FOVS_DEG:
        fx = (w / 2.0) / np.tan(np.radians(fov) / 2.0)
        u = (np.arange(w) - w / 2.0 + 0.5) / fx  # right +
        v = (np.arange(h) - h / 2.0 + 0.5) / fx  # down +
        vv, uu = np.meshgrid(v, u, indexing="ij")
        rays.append(np.stack([np.ones_like(uu), -uu, vv], axis=-1))
    return np.stack(rays).astype(np.float32)  # (fwd, left, down)


@functools.lru_cache(maxsize=None)
def _rays(device: torch.device) -> torch.Tensor:
    """The ray table on `device`, made once per device."""
    return torch.from_numpy(_rig_rays()).to(device)


def _cam_yaws(device) -> torch.Tensor:
    return torch.tensor(np.radians(CAMERA_YAWS_DEG), dtype=torch.float32, device=device)


def _cam_poses(ego_pos, ego_heading):
    """World (x, y) and yaw of each camera: [..., N_CAM, 2], [..., N_CAM]."""
    fwd = torch.stack([torch.cos(ego_heading), torch.sin(ego_heading)], -1)
    xy = ego_pos + CAM_FORWARD * fwd
    return (xy[..., None, :].expand(ego_pos.shape[:-1] + (NUM_CAMERAS, 2)),
            ego_heading[..., None] + _cam_yaws(ego_pos.device))


def _ground_points(ego_pos, ego_heading):
    """Ray-cast every pixel of egos at `ego_pos` [..., 2], `ego_heading`
    [...] to z=0: world points [..., N_CAM, h, w, 2], hit mask and range t
    [N_CAM, h, w] (clipped)."""
    rays = _rays(ego_pos.device)  # [N_CAM, h, w, 3] (fwd, left, down)
    cam_xy, cam_yaw = _cam_poses(ego_pos, ego_heading)  # [..., N_CAM, 2], [..., N_CAM]

    down = rays[..., 2]
    hit = down > 1e-4  # below the horizon
    t = torch.where(hit, CAM_HEIGHT / torch.clamp(down, min=1e-4),
                    torch.full_like(down, MAX_RANGE))
    hit = hit & (t <= MAX_RANGE)
    t = torch.clamp(t, max=MAX_RANGE)

    c = torch.cos(cam_yaw)[..., None, None]
    s = torch.sin(cam_yaw)[..., None, None]
    fwd, left = rays[..., 0], rays[..., 1]
    dx = fwd * c - left * s
    dy = fwd * s + left * c
    pts = cam_xy[..., None, None, :] + t[..., None] * torch.stack([dx, dy], -1)
    return pts, hit, t


def _point_in_obb(pts, pos, heading, shape):
    """pts [S, ..., 2] vs boxes pos [S, A, 2], heading [S, A], shape
    [S, A, 2] (width, length): [S, ..., A] bool."""
    S, A = heading.shape
    mid = (1,) * (pts.dim() - 2)
    pos, heading, shape = (x.reshape((S,) + mid + x.shape[1:]) for x in (pos, heading, shape))
    rel = pts[..., None, :] - pos  # [S, ..., A, 2]
    c, s = torch.cos(heading), torch.sin(heading)
    lx = rel[..., 0] * c + rel[..., 1] * s  # longitudinal
    ly = -rel[..., 0] * s + rel[..., 1] * c  # lateral
    half_l = shape[..., 1] * 0.5
    half_w = shape[..., 0] * 0.5
    return (torch.abs(lx) <= half_l) & (torch.abs(ly) <= half_w)


def render_cameras(tmap, spec, state) -> torch.Tensor:
    """SimState -> semantic surround cameras [S, N_CAM, H, W, C] (float32),
    every scenario at once; channels documented at module top."""
    from ..sim.traffic_lights import red_ahead

    S, A = state.alive.shape
    dev = state.pos.device
    pts, hit, t = _ground_points(state.pos[:, 0], state.heading[:, 0])
    # weather: fog and rain shorten the usable sensing range
    vis = spec.visibility if spec.visibility is not None else torch.ones(S, device=dev)
    hit = hit & (t <= MAX_RANGE * vis[:, None, None, None])  # [S, N_CAM, h, w]

    drivable = tmap.on_road_raster(pts)

    # route channel: distance to a cursor-centred window of waypoints
    start = torch.minimum(
        torch.clamp(state.ego_route_cursor.to(torch.int32) - 8, min=0),
        torch.clamp(spec.ego_route_len - ROUTE_WINDOW, min=0),
    )
    idx = start[:, None] + torch.arange(ROUTE_WINDOW, device=dev)  # [S, RW]
    Lr = spec.ego_route.shape[1]
    wp = torch.gather(spec.ego_route[..., :2], 1,
                      torch.clamp(idx, max=Lr - 1).long()[..., None].expand(-1, -1, 2))
    wp_valid = idx < spec.ego_route_len[:, None]
    d2 = torch.sum((pts[..., None, :] - wp[:, None, None, None]) ** 2, -1)
    d2 = torch.where(wp_valid[:, None, None, None], d2, torch.inf)
    on_route = torch.amin(d2, -1) <= ROUTE_HALF_WIDTH ** 2

    occ = _point_in_obb(pts, state.pos, state.heading, state.shape)  # [S, .., A]
    others = (state.alive & (torch.arange(A, device=dev) != 0))[:, None, None, None]
    cls = state.agent_class[:, None, None, None]
    veh = (occ & others & (cls == CLASS_VEHICLE)).any(-1)
    wlk = (occ & others & (cls == CLASS_WALKER)).any(-1)
    stc = (occ & others & (cls == CLASS_STATIC)).any(-1)

    red, _ = red_ahead(tmap, state.lane[:, :1], state.pos[:, :1], state.tick)
    f = torch.float32
    inv_depth = torch.where(hit, 1.0 / torch.clamp(t, min=1.0), 0.0)
    front = (torch.arange(NUM_CAMERAS, device=dev) == 0).to(f)[:, None, None]
    chans = [
        hit.to(f),
        (drivable & hit).to(f),
        (on_route & hit).to(f),
        (veh & hit).to(f),
        (wlk & hit).to(f),
        (stc & hit).to(f),
        (red[:, 0].to(f)[:, None, None, None] * front).expand(hit.shape),
        inv_depth,
    ]
    return torch.stack(chans, -1)


# ---------------------------------------------------------------------------
# inverse mapping: ego-frame points -> per-camera normalized image coords
# ---------------------------------------------------------------------------
def pixel_ground_table():
    """Static per-pixel EGO-frame ground intersections: ([N_CAM, H, W, 2]
    points, [N_CAM, H, W] hit mask). The rig is fixed in the ego frame and
    the ground is the z=0 plane, so the pixel -> ground geometry does not
    depend on the state: only each pixel's semantic content varies. The E2E
    models' pillar-splat BEV priors (models/e2e/model.py) lift camera
    pixels into BEV cells with it (ops/e2e.py voxelize,
    dynamic_scatter_mean), made on the CPU."""
    pts, hit, _ = _ground_points(torch.zeros(2), torch.zeros(()))
    return pts, hit


def project_points(pts_ego: torch.Tensor, z: float = 0.0):
    """Ego-frame ground points [..., 2] -> (uv [..., N_CAM, 2] in [0, 1],
    in_view [..., N_CAM] bool). The anchors of the deformable sampling
    (ops/e2e.py ms_deform_attn, deformable_aggregation)."""
    dev = pts_ego.device
    yaws = _cam_yaws(dev)
    fovs = torch.tensor(np.radians(CAMERA_FOVS_DEG), dtype=torch.float32, device=dev)
    fx = (IMG_W / 2.0) / torch.tan(fovs / 2.0)

    rel = pts_ego[..., None, :] - torch.tensor([CAM_FORWARD, 0.0], device=dev)
    c, s = torch.cos(yaws), torch.sin(yaws)
    fwd = rel[..., 0] * c + rel[..., 1] * s
    left = -rel[..., 0] * s + rel[..., 1] * c
    down = torch.full_like(fwd, CAM_HEIGHT - z)

    safe_fwd = torch.clamp(fwd, min=0.1)
    u = (-left / safe_fwd) * fx + IMG_W / 2.0 - 0.5
    v = (down / safe_fwd) * fx + IMG_H / 2.0 - 0.5
    uv = torch.stack([(u + 0.5) / IMG_W, (v + 0.5) / IMG_H], -1)
    in_view = ((fwd > 0.2) & (uv[..., 0] > 0.0) & (uv[..., 0] < 1.0)
               & (uv[..., 1] > 0.0) & (uv[..., 1] < 1.0))
    return uv, in_view
