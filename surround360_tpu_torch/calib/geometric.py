"""Geometric rig calibration: bundle adjustment of the rig JSON.

Port of ``surround360_tpu/calib/geometric.py`` (reference:
surround360_render/source/calibration/GeometricCalibration.{h,cpp}, with
Ceres replaced by a Levenberg-Marquardt solver), in float64 on the device:

- residuals are the reference's ReprojectionFunctor
  (GeometricCalibration.h:31-102): project the world point through the
  parameterized camera and subtract the observed pixel. Residuals and
  Jacobians come from one ``torch.func.vmap(torch.func.jacfwd(...))`` over
  every observation;
- the normal equations use the bundle-adjustment Schur complement (3x3
  point blocks eliminated), built without a loop over points: the
  camera-point coupling is scattered into a dense (points, cameras x 11,
  3) tensor ``W`` and the reduced camera system is ``B - W C^-1 W^T``, one
  batched product. Sums over observations accumulate in observation order
  on every device (``index_put_`` with ``accumulate``: serial on the CPU,
  sorted and not atomic on the card), so a run repeats bit for bit: the
  culls between passes turn a last-bit difference into a different set of
  observations;
- pass structure as refine() (GeometricCalibration.cpp:794-895): pass 0
  locks position, focal and distortion, later passes optionally lock
  positions only; camera 0 is the gauge; outliers are culled before each
  pass at ``outlier_factor x median`` reprojection error
  (removeOutliers, GeometricCalibration.cpp:344-388);
- robustness by Huber IRLS (the --robust flag's loss);
- the synthetic self-test trio (generateArtificalPoints, perturbCameras,
  the RMSE report, GeometricCalibration.cpp:115-129, :235-268, :613-689)
  on the host, drawing the reference's random numbers in its order.

Where the port departs from the reference on purpose: the rotation's
Jacobian is finite at angle 0 (``rotation_from_angle_axis_torch``), and
locked columns are selected away, not multiplied by 0, so a NaN in a
locked column cannot reach the solve (ROADMAP queue C). The reference runs
in float32 (JAX without x64); the port in float64.

Camera parameters per camera (11): position(3), rotation angle-axis(3),
principal(2), scalar focal(1), distortion(2).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..geometry.camera import (
    FTHETA,
    NEAR_INFINITY,
    angle_axis_from_rotation,
    pixel_to_rig_direction,
    ray_midpoint,
    rotation_from_angle_axis,
    rotation_from_angle_axis_torch,
    sees,
    world_to_pixel,
)
from ..geometry.rig import Rig
from ..utils.math_util import median

__all__ = [
    "CalibrationObservations",
    "GeometricCalibrationConfig",
    "calibrate_geometric",
    "generate_artificial_points",
    "perturb_rig",
    "reprojection_errors",
    "reprojection_report",
    "triangulate_points",
]

N_PAR = 11


@dataclass
class CalibrationObservations:
    """Flattened trace observations: observation k is (camera cam_idx[k]
    sees world point pt_idx[k] at pixel pixels[k])."""

    cam_idx: np.ndarray  # (M,) int32
    pt_idx: np.ndarray  # (M,) int32
    pixels: np.ndarray  # (M, 2) float64
    num_points: int

    def cull(self, keep: np.ndarray) -> "CalibrationObservations":
        # drop observations, re-index surviving points densely
        cam_idx = self.cam_idx[keep]
        pt_idx = self.pt_idx[keep]
        pixels = self.pixels[keep]
        # keep only points with >= 2 observations
        counts = np.bincount(pt_idx, minlength=self.num_points)
        keep2 = (counts >= 2)[pt_idx]
        cam_idx, pt_idx, pixels = cam_idx[keep2], pt_idx[keep2], pixels[keep2]
        remap = -np.ones(self.num_points, dtype=np.int64)
        used = np.unique(pt_idx)
        remap[used] = np.arange(len(used))
        return CalibrationObservations(
            cam_idx, remap[pt_idx].astype(np.int32), pixels, len(used)
        )


@dataclass
class GeometricCalibrationConfig:
    passes: int = 10
    lock_positions: bool = True  # pass 0 always locks positions
    lock_focal: bool = False  # lock focal beyond pass 0
    lock_distortion: bool = False  # lock distortion beyond pass 0
    lock_principal: bool = False  # rotation/principal degenerate on sparse
    # overlap-only match graphs; lock when matches don't span the frame
    outlier_factor: float = 5.0
    robust: bool = True
    huber_delta: float = 1.0  # px
    lm_iterations: int = 20
    lm_lambda0: float = 1e-3
    shared_distortion: bool = True  # unused, as in the reference


# --------------------------------------------------------------------------
# parameter packing (host)
# --------------------------------------------------------------------------


def _rig_to_params(rig: Rig) -> np.ndarray:
    """(N, 11) per-camera parameter rows."""
    rows = []
    for cam in rig.cameras:
        rows.append(
            np.concatenate(
                [
                    np.asarray(cam.position, dtype=np.float64),
                    angle_axis_from_rotation(np.asarray(cam.rotation)),
                    np.asarray(cam.principal, dtype=np.float64),
                    [float(np.asarray(cam.focal)[0])],
                    np.asarray(cam.distortion, dtype=np.float64),
                ]
            )
        )
    return np.stack(rows)


def _params_to_rig(rig: Rig, params: np.ndarray) -> Rig:
    cams = [
        cam._replace(
            position=row[0:3],
            rotation=rotation_from_angle_axis(row[3:6]),
            principal=row[6:8],
            focal=np.array([row[8], -row[8]]),
            distortion=row[9:11],
        )
        for cam, row in zip(rig.cameras, params)
    ]
    return Rig(cams, list(rig.ids), list(rig.groups), rig.filename)


# --------------------------------------------------------------------------
# the projection on the device (the ReprojectionFunctor's model)
# --------------------------------------------------------------------------


def _project(rows, points, ftheta):
    """World points (..., 3) -> pixels (..., 2) through camera parameter
    rows (..., 11); ``ftheta`` (...) bool picks the lens per row. Both
    lens branches are computed and selected, as the reference traces
    them (geometry/camera.py: world_to_pixel)."""
    rot = rotation_from_angle_axis_torch(rows[..., 3:6])
    rel = points - rows[..., 0:3]
    pc = torch.stack([torch.sum(rot[..., i, :] * rel, dim=-1) for i in range(3)], -1)
    xy = pc[..., :2]
    z = pc[..., 2]
    d0, d1 = rows[..., 9], rows[..., 10]

    def distort_factor(r2):
        return 1.0 + r2 * (d0 + r2 * d1)

    norm_xy = torch.sqrt(torch.sum(xy * xy, dim=-1))
    safe_norm = torch.where(norm_xy == 0, torch.ones_like(norm_xy), norm_xy)
    theta = torch.atan2(norm_xy, -z)
    ftheta_sensor = (distort_factor(theta * theta) * theta / safe_norm)[..., None] * xy
    safe_z = torch.where(z == 0, torch.full_like(z, -1e-20), z)
    planar = xy / (-safe_z)[..., None]
    r2 = torch.sum(planar * planar, dim=-1)
    rect_sensor = distort_factor(r2)[..., None] * planar
    sensor = torch.where(ftheta[..., None], ftheta_sensor, rect_sensor)
    focal = torch.stack([rows[..., 8], -rows[..., 8]], -1)
    return focal * sensor + rows[..., 6:8]


def _project_with_value(rows, points, ftheta):
    out = _project(rows, points, ftheta)
    return out, out


# d(pixel)/d(row) and d(pixel)/d(point) per observation, and the pixel
_JACOBIAN = torch.func.vmap(
    torch.func.jacfwd(_project_with_value, argnums=(0, 1), has_aux=True)
)


class _Observations:
    """One observation set on the device: its index vectors, measured
    pixels and lens per observation, built once per pass (the
    reference's _residuals_fn)."""

    def __init__(self, rig: Rig, obs: CalibrationObservations, device):
        self.cam_idx = torch.as_tensor(obs.cam_idx, dtype=torch.long, device=device)
        self.pt_idx = torch.as_tensor(obs.pt_idx, dtype=torch.long, device=device)
        self.measured = torch.as_tensor(obs.pixels, dtype=torch.float64, device=device)
        ftheta = torch.as_tensor(
            [int(c.lens_type) == FTHETA for c in rig.cameras], device=device
        )
        self.ftheta = ftheta[self.cam_idx]

    def residuals(self, cam_params, points):
        pix = _project(cam_params[self.cam_idx], points[self.pt_idx], self.ftheta)
        return pix - self.measured

    def res_and_jac(self, cam_params, points):
        """(M, 2) residuals, (M, 2, 11) Jc, (M, 2, 3) Jp."""
        (Jc, Jp), pix = _JACOBIAN(
            cam_params[self.cam_idx], points[self.pt_idx], self.ftheta
        )
        return pix - self.measured, Jc, Jp


def _huber_cost(r: torch.Tensor, cfg: GeometricCalibrationConfig) -> float:
    e = torch.linalg.vector_norm(r, dim=1)
    if cfg.robust:
        d = cfg.huber_delta
        return float(torch.where(e <= d, 0.5 * e**2, d * (e - 0.5 * d)).sum())
    return float(0.5 * (e**2).sum())


# --------------------------------------------------------------------------
# triangulation (GeometricCalibration.h:160-185)
# --------------------------------------------------------------------------


def triangulate_points(rig: Rig, obs: CalibrationObservations, device="cuda"):
    """Initial world points (num_points, 3) float64 on ``device``: per
    trace, the midpoint of its first two observation rays in observation
    order; a single-view trace sits NEAR_INFINITY along its ray (the
    reference's nonlinear triangulation is absorbed by the world-point
    blocks of the bundle adjustment itself). The rays are cast on the host
    in float64, one camera at a time."""
    M = len(obs.cam_idx)
    dirs = np.zeros((M, 3))
    origins = np.zeros((M, 3))
    for c, cam in enumerate(rig.cameras):
        sel = obs.cam_idx == c
        if sel.any():
            dirs[sel] = pixel_to_rig_direction(cam, obs.pixels[sel])
            origins[sel] = np.asarray(cam.position)
    order = np.argsort(obs.pt_idx, kind="stable")
    counts = np.bincount(obs.pt_idx, minlength=obs.num_points)
    if (counts == 0).any():
        raise ValueError("triangulate_points: a point has no observation")
    first = order[np.cumsum(counts) - counts]
    second = order[np.minimum(np.cumsum(counts) - counts + 1, M - 1)]
    pts = ray_midpoint(
        origins[first], dirs[first], origins[second], dirs[second],
        force_in_front=True,
    )
    single = origins[first] + dirs[first] * NEAR_INFINITY
    pts = np.where((counts >= 2)[:, None], pts, single)
    return torch.as_tensor(pts, dtype=torch.float64, device=device)


# --------------------------------------------------------------------------
# the LM solver with Schur complement
# --------------------------------------------------------------------------


def _sum_into(n: int, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(n, ...) sums of ``values`` rows by ``index``, added in row order on
    every device: ``index_put_`` with ``accumulate`` runs serially on the
    CPU and sorts on the card, where ``index_add_`` adds by atomics in no
    fixed order."""
    out = torch.zeros((n,) + values.shape[1:], dtype=values.dtype, device=values.device)
    return out.index_put_((index,), values, accumulate=True)


def _lm_solve(cam_params, points, data: _Observations, free, cfg):
    """Levenberg-Marquardt with the bundle-adjustment Schur complement:
    eliminate the block-diagonal 3x3 point blocks, solve the reduced
    camera system, back-substitute. ``free`` (N, 11) bool on the device
    says which camera parameters move. Returns (cam_params, points, cost,
    iterations run)."""
    n_cams = cam_params.shape[0]
    n_pts = points.shape[0]
    n_flat = n_cams * N_PAR
    dev, f64 = cam_params.device, torch.float64
    ci, pi = data.cam_idx, data.pt_idx
    free_obs = free[ci][:, None, :]  # (M, 1, 11)
    mask_flat = free.reshape(-1)
    pair = pi * n_cams + ci  # the (point, camera) slot of each observation
    eye3 = torch.eye(3, dtype=f64, device=dev)
    diag = torch.arange(N_PAR, device=dev)
    lam = cfg.lm_lambda0
    cost = _huber_cost(data.residuals(cam_params, points), cfg)
    iterations = 0
    for _ in range(cfg.lm_iterations):
        iterations += 1
        r, Jc, Jp = data.res_and_jac(cam_params, points)
        if cfg.robust:
            # Huber IRLS weights, square-rooted into residual and Jacobian
            e = torch.linalg.vector_norm(r, dim=1, keepdim=True)
            w = torch.sqrt(
                torch.where(
                    e <= cfg.huber_delta,
                    torch.ones_like(e),
                    cfg.huber_delta / torch.clamp(e, min=1e-12),
                )
            )
            r = r * w
            Jc = Jc * w[:, :, None]
            Jp = Jp * w[:, :, None]
        # locked columns selected away (not multiplied: NaN * 0 is NaN)
        Jc = torch.where(free_obs, Jc, torch.zeros_like(Jc))

        B = _sum_into(n_cams, ci, torch.einsum("mri,mrj->mij", Jc, Jc))
        C = _sum_into(n_pts, pi, torch.einsum("mri,mrj->mij", Jp, Jp))
        gc = _sum_into(n_cams, ci, torch.einsum("mri,mr->mi", Jc, r))
        gp = _sum_into(n_pts, pi, torch.einsum("mri,mr->mi", Jp, r))
        E = torch.einsum("mri,mrj->mij", Jc, Jp)  # (M, 11, 3)
        # W[p, c] sums E over point p's observations in camera c
        W = _sum_into(n_pts * n_cams, pair, E)
        W = W.view(n_pts, n_flat, 3)

        improved = False
        for _try in range(6):
            Cinv = torch.linalg.inv(C + (lam + 1e-12) * eye3)
            WC = W @ Cinv  # (P, n_flat, 3)
            # S = damped block diagonal of B - sum_p W_p C_p^-1 W_p^T
            Bd = B.clone()
            Bd[:, diag, diag] = Bd[:, diag, diag] * (1.0 + lam) + 1e-9
            S = torch.block_diag(*Bd) - torch.einsum("pia,pja->ij", WC, W)
            v = gc.reshape(-1) - torch.einsum("pia,pa->i", WC, gp)
            S_f = S[mask_flat][:, mask_flat]
            try:
                dc_f = torch.linalg.solve(S_f, -v[mask_flat])
            except torch.linalg.LinAlgError:
                lam *= 10
                continue
            dc = torch.zeros(n_flat, dtype=f64, device=dev)
            dc[mask_flat] = dc_f
            dc = dc.view(n_cams, N_PAR)
            # back-substitute points: dp = -C^-1 (gp + sum_obs E^T dc)
            rhs = gp.clone().index_put_((pi,), torch.einsum("mij,mi->mj", E, dc[ci]),
                                        accumulate=True)
            dp = -torch.einsum("pkl,pl->pk", Cinv, rhs)
            new_cams = cam_params + dc
            new_pts = points + dp
            new_cost = _huber_cost(data.residuals(new_cams, new_pts), cfg)
            if new_cost < cost:  # false for NaN: a NaN step is rejected
                cam_params, points, cost = new_cams, new_pts, new_cost
                lam = max(lam / 10, 1e-9)
                improved = True
                break
            lam *= 10
        if not improved:
            break
    return cam_params, points, cost, iterations


def reprojection_errors(rig: Rig, obs: CalibrationObservations, points, device="cuda"):
    """(M,) reprojection error norms on ``device`` of ``points`` (P, 3),
    through the rig's parameter rows."""
    device = torch.device(device)
    data = _Observations(rig, obs, device)
    params = torch.as_tensor(_rig_to_params(rig), device=device)
    pts = torch.as_tensor(points, dtype=torch.float64, device=device)
    return torch.linalg.vector_norm(data.residuals(params, pts), dim=1)


def reprojection_report(errors) -> dict:
    """RMSE / median / percentile report (getCameraRmseReport-style,
    GeometricCalibration.cpp:582-607); percentiles are ``e[int(n * q)]``
    of the sorted errors, not interpolated."""
    e = torch.sort(torch.as_tensor(errors, dtype=torch.float64).reshape(-1)).values
    n = e.numel()
    return {
        "count": n,
        "rmse": float(torch.sqrt(torch.mean(e**2))) if n else float("nan"),
        "median": median(e),
        "p90": float(e[int(n * 0.9)]) if n else 0.0,
        "p99": float(e[int(n * 0.99)]) if n else 0.0,
        "worst": float(e[-1]) if n else 0.0,
    }


def calibrate_geometric(
    rig: Rig,
    obs: CalibrationObservations,
    cfg: GeometricCalibrationConfig | None = None,
    verbose: bool = False,
    device="cuda",
):
    """Run the multi-pass refine loop on ``device``. Returns (refined rig,
    final report). With ``verbose``, one line a pass: its report, LM
    iterations and seconds."""
    cfg = cfg or GeometricCalibrationConfig()
    device = torch.device(device)

    points = triangulate_points(rig, obs, device)
    cam_params = torch.as_tensor(_rig_to_params(rig), device=device)
    data = _Observations(rig, obs, device)

    report = None
    for pass_idx in range(cfg.passes):
        t0 = time.perf_counter()
        # outlier cull at factor x median before each solve (refine(),
        # GeometricCalibration.cpp:802-813 culls per pass, including the
        # first)
        errors = torch.linalg.vector_norm(data.residuals(cam_params, points), dim=1)
        keep = errors <= cfg.outlier_factor * max(median(errors), 1e-9)
        if not bool(keep.all()):
            obs = obs.cull(keep.cpu().numpy())
            points = triangulate_points(
                _params_to_rig(rig, cam_params.cpu().numpy()), obs, device
            )
            data = _Observations(rig, obs, device)

        # parameter locking (GeometricCalibration.cpp:860-875): camera 0
        # fully locked as gauge; pass 0 locks position/focal/distortion
        free = np.ones((len(rig.cameras), N_PAR), dtype=bool)
        if pass_idx == 0 or cfg.lock_positions:
            free[:, 0:3] = False
        if pass_idx == 0 or cfg.lock_focal:
            free[:, 8] = False
        if pass_idx == 0 or cfg.lock_distortion:
            free[:, 9:11] = False
        if cfg.lock_principal:
            free[:, 6:8] = False
        free[0, :] = False

        cam_params, points, _, iterations = _lm_solve(
            cam_params, points, data, torch.as_tensor(free, device=device), cfg
        )
        errors = torch.linalg.vector_norm(data.residuals(cam_params, points), dim=1)
        report = reprojection_report(errors)
        if verbose:
            print(
                f"pass {pass_idx}: {report} lm_iterations {iterations} "
                f"seconds {time.perf_counter() - t0:.4f}",
                flush=True,
            )

    return _params_to_rig(rig, cam_params.cpu().numpy()), report


# --------------------------------------------------------------------------
# synthetic self-test inputs (GeometricCalibration.cpp:115-129, :235-268)
# --------------------------------------------------------------------------


def generate_artificial_points(
    rig: Rig,
    num_points: int = 1000,
    distance: float = 1000.0,
    seed: int = 0,
    noise_px: float = 0.0,
) -> tuple[CalibrationObservations, np.ndarray]:
    """World points on a sphere and their observations in every camera
    that sees them (>= 2 views kept). The noise is drawn per camera, per
    visible point, two normals each, as the reference draws it."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(num_points, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    world = dirs * distance

    cam_idx, pt_idx, pixels = [], [], []
    for ci, cam in enumerate(rig.cameras):
        vis = np.nonzero(sees(cam, world))[0]
        pix = world_to_pixel(cam, world)[vis]
        cam_idx.append(np.full(len(vis), ci, np.int32))
        pt_idx.append(vis.astype(np.int32))
        pixels.append(pix + rng.normal(size=(len(vis), 2)) * noise_px)
    obs = CalibrationObservations(
        np.concatenate(cam_idx),
        np.concatenate(pt_idx),
        np.concatenate(pixels).reshape(-1, 2),
        num_points,
    )
    return obs.cull(np.ones(len(obs.cam_idx), bool)), world


def perturb_rig(
    rig: Rig,
    rotation_amount: float = 0.01,
    principal_amount: float = 2.0,
    seed: int = 1,
) -> Rig:
    """Corrupt the rig like perturbCameras (GeometricCalibration.cpp:115-129);
    camera 0, the gauge, stays."""
    rng = np.random.default_rng(seed)
    cams = [rig.cameras[0]]
    for cam in rig.cameras[1:]:
        aa = angle_axis_from_rotation(np.asarray(cam.rotation))
        aa = aa + rng.normal(size=3) * rotation_amount
        cams.append(
            cam._replace(
                rotation=rotation_from_angle_axis(aa),
                principal=np.asarray(cam.principal)
                + rng.normal(size=2) * principal_amount,
            )
        )
    return Rig(cams, list(rig.ids), list(rig.groups), rig.filename)
