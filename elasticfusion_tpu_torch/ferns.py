"""Randomized fern place recognition / global loop closure — the equivalent of
`Ferns` (Core/Ferns.{h,cpp}).

Behaviour (as in the reference package): 500 ferns at random pixels of the
8x-decimated predicted view, 4-bit codes (r>, g>, b>, depth_mm>)
(Ferns.cpp:114-117, 255 where there is no depth); a keyframe is kept when its
smallest dissimilarity over the DB exceeds the threshold (cpp:129-152);
retrieval by co-occurrence scoring with an age gate (cpp:213-222),
blockHDAware > 0.3 (cpp:378-393), a fern-resolution depth-only ICP from the
keyframe pose (cpp:241-250) and a photometric reprojection check
(cpp:300-364).

The tables are drawn from `np.random.default_rng(cfg.fern_seed)` in the
reference package's order, so both packages encode a view to the same codes.
Decimation, encoding and scoring run on the tensors' device
(`decimate_views`, `fern_encode_device`, `fern_score_device`) against a
fixed-capacity keyframe DB there, for the engine's frames and for
`add_frame` / `find_frame` alike; the host reads the views of a frame only
when it keeps a keyframe or verifies a retrieval.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ._device import DeviceLike, read_back, resolve_device
from .config import CameraConfig, EngineConfig
from .ops.preprocess import resize_nmap, resize_vmap
from .tracking import OdometryInputs, get_incremental_transformation

BAD_CODE = 255


def decimate_views(img, vtx, nrm, factor: int):
    """Nearest decimation at output-pixel centres for the fern views (the
    reference's Resize pass, Resize.cpp:69-146), on the device."""
    off = factor // 2
    return (
        img[off::factor, off::factor],
        vtx[:, off::factor, off::factor],
        nrm[:, off::factor, off::factor],
    )


def fern_encode_device(img_s, vtx_s, fern_flat, fern_rgbd):
    """Fern encoding on the device (Ferns.cpp:108-127): gather the fern pixels
    of the decimated predicted view and compare them with each fern's RGBD
    thresholds.

    img_s: [h,w,3] f32 RGB, vtx_s: [3,h,w] camera-frame vertices, fern_flat:
    [F] flat pixel index (y*w+x), fern_rgbd: [F,4] f32 thresholds (r, g, b,
    depth_mm).  Returns (codes i32 [F], good i32)."""
    table = torch.stack(
        [img_s[:, :, 0], img_s[:, :, 1], img_s[:, :, 2], vtx_s[2]]).reshape(4, -1)
    r, g, b, z = table[:, fern_flat.long()]
    i32 = torch.int32
    code = (
        (r > fern_rgbd[:, 0]).to(i32) * 8
        + (g > fern_rgbd[:, 1]).to(i32) * 4
        + (b > fern_rgbd[:, 2]).to(i32) * 2
        + (torch.floor(z * 1000.0) > fern_rgbd[:, 3]).to(i32)
    )
    valid = z > 0
    codes = torch.where(valid, code, torch.full_like(code, BAD_CODE))
    return codes, valid.sum().to(i32)


def fern_score_device(codes, good, db_codes, db_good, db_times, db_count,
                      tick, min_age: int):
    """Retrieval scoring against the keyframe code DB, reduced to four
    scalars:

      add_min   — least dissimilarity over all keyframes (addFrame gate)
      best_id   — the first keyframe of least dissimilarity among those older
                  than `min_age` (`torch.argmin` returns the first minimum)
      best_d    — its dissimilarity
      block_hd  — blockHDAware agreement with that keyframe (cpp:378-393)
    """
    f32 = torch.float32
    F = db_codes.shape[0]
    co = ((db_codes == codes[None, :]) & (codes[None, :] != BAD_CODE)).to(f32).sum(1)
    max_co = torch.minimum(good.to(f32), db_good)
    dissim = (max_co - co) / torch.clamp(max_co, min=1.0)
    valid = torch.arange(F, device=db_codes.device) < db_count
    inf = torch.full_like(dissim, float("inf"))
    add_min = torch.where(valid, dissim, inf).min()

    old = valid & ((tick - db_times) > min_age)
    find_d = torch.where(old, dissim, inf)
    best_id = torch.argmin(find_d)
    best_d = find_d.min()
    brow = db_codes.index_select(0, best_id.reshape(1))[0]
    both = (codes != BAD_CODE) & (brow != BAD_CODE)
    block_hd = (((codes == brow) & both).to(f32).sum()
                / torch.clamp(both.to(f32).sum(), min=1.0))
    return add_min, best_id.to(torch.int32), best_d, block_hd


@dataclass
class FernFrame:
    """Keyframe record (Ferns.h:76-137)."""

    id: int
    codes: np.ndarray        # [num] uint8
    good_codes: int
    T_wc: np.ndarray         # 4x4
    src_time: int
    rgb: np.ndarray          # [h, w, 3] u8 (decimated predicted view)
    verts: np.ndarray        # [3, h, w] f32 camera frame
    norms: np.ndarray        # [3, h, w] f32


@dataclass
class SurfaceConstraint:
    source_point: np.ndarray   # world, via the current pose
    target_point: np.ndarray   # world, via the estimated (recovery) pose


def _to_small(img, verts, norms):
    """Decimated device views (`decimate_views`) → host numpy (u8 RGB, f32
    vertices, f32 normals), read in ONE device→host copy."""
    parts = (img, verts, norms)
    flat = read_back(torch.cat([p.reshape(-1).to(torch.float32) for p in parts]))
    out, o = [], 0
    for p in parts:
        out.append(flat[o:o + p.numel()].reshape(p.shape))
        o += p.numel()
    return np.clip(out[0], 0, 255).astype(np.uint8), out[1], out[2]


class Ferns:
    """The fern keyframe DB: tables, keyframes (host), their codes (device),
    addFrame / findFrame."""

    def __init__(self, cfg: EngineConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num = cfg.num_ferns
        self.factor = cfg.fern_pyramid_factor
        cam = cfg.camera
        self.width = cam.width // self.factor
        self.height = cam.height // self.factor
        self.max_depth_mm = int(cfg.depth_cutoff * 1000)
        # decimated pixel u_s samples full-res pixel u = factor*u_s + factor/2,
        # so the principal point shifts by half a small pixel
        self.fern_cam = CameraConfig(
            width=self.width, height=self.height,
            fx=cam.fx / self.factor, fy=cam.fy / self.factor,
            cx=cam.cx / self.factor - 0.5, cy=cam.cy / self.factor - 0.5,
        )
        # fern odometry: depth only, one level, no SO(3) (Ferns.cpp:250)
        self.fern_cfg = cfg.with_(
            camera=self.fern_cam, icp_weight=100.0, pyramid=False, so3=False,
            fast_odom=False, rgb_only=False,
        )
        # the reference package's draw order: x, y, then rgb, then depth
        rng = np.random.default_rng(cfg.fern_seed)
        self.pos = np.stack(
            [rng.integers(0, self.width, self.num),
             rng.integers(0, self.height, self.num)], axis=1
        )  # [num, 2] = (x, y)
        self.rgbd = np.concatenate(
            [rng.integers(0, 256, (self.num, 3)),
             rng.integers(400, max(self.max_depth_mm, 401), (self.num, 1))],
            axis=1,
        )  # [num, 4] thresholds
        self.frames: List[FernFrame] = []
        self.last_closest = -1
        self._dev_tables = None
        # device keyframe DB, fixed capacity, doubled when it fills
        self.db_capacity = cfg.max_fern_keyframes
        self._db_codes_dev = None   # [F, num] i32
        self._db_good_dev = None    # [F] f32
        self._db_time_dev = None    # [F] f32
        self._db_count_dev = None   # 0-d i32

    def device_db(self):
        """(codes [F,num] i32, good [F] f32, times [F] f32, count 0-d i32) on
        the device; rows >= count are dead (time +inf never passes the age
        gate).  Keyframes are written into these tensors in place, so a
        captured frame keeps reading the current DB until its capacity
        grows."""
        if self._db_codes_dev is None:
            F = self.db_capacity
            codes = np.full((F, self.num), BAD_CODE, np.int32)
            good = np.zeros((F,), np.float32)
            times = np.full((F,), np.inf, np.float32)
            for i, fr in enumerate(self.frames[:F]):
                codes[i] = fr.codes
                good[i] = fr.good_codes
                times[i] = fr.src_time
            self._db_codes_dev = torch.from_numpy(codes).to(self.device)
            self._db_good_dev = torch.from_numpy(good).to(self.device)
            self._db_time_dev = torch.from_numpy(times).to(self.device)
            self._db_count_dev = torch.full(
                (), min(len(self.frames), F), dtype=torch.int32, device=self.device)
        return (self._db_codes_dev, self._db_good_dev, self._db_time_dev,
                self._db_count_dev)

    def _grow_db(self) -> None:
        """Double the device DB's capacity (the reference DB is unbounded)."""
        self.db_capacity *= 2
        if self._db_codes_dev is None:
            return
        n = self._db_codes_dev.shape[0]
        pad = self.db_capacity - n
        F = torch.nn.functional.pad
        self._db_codes_dev = F(self._db_codes_dev, (0, 0, 0, pad), value=BAD_CODE)
        self._db_good_dev = F(self._db_good_dev, (0, pad))
        self._db_time_dev = F(self._db_time_dev, (0, pad), value=float("inf"))

    def _db_upload(self, idx: int, codes: np.ndarray, good: int,
                   src_time: int) -> None:
        if idx >= self.db_capacity:
            self._grow_db()
        if self._db_codes_dev is None:
            return
        self._db_codes_dev[idx] = torch.from_numpy(
            codes.astype(np.int32)).to(self.device)
        self._db_good_dev[idx] = float(good)
        self._db_time_dev[idx] = float(src_time)
        self._db_count_dev.fill_(min(len(self.frames), self.db_capacity))

    def encode_tables(self):
        """Device constants of `fern_encode_device`: (flat pixel index [F]
        i64, RGBD thresholds [F,4] f32)."""
        if self._dev_tables is None:
            flat = self.pos[:, 1] * self.width + self.pos[:, 0]
            self._dev_tables = (
                torch.from_numpy(flat.astype(np.int64)).to(self.device),
                torch.from_numpy(self.rgbd.astype(np.float32)).to(self.device),
            )
        return self._dev_tables

    def _views_and_scores(self, image, vertex, normal, time):
        """Full-resolution views (tensors or arrays) → their decimated views
        on the device, codes and retrieval scores, as the engine's frame
        computes them; the codes and scores are read in ONE copy.  Returns
        (views, codes i32 [num], good, add_min, best_id, best_d, block_hd)."""
        dev = self.device
        views = decimate_views(*(torch.as_tensor(x, dtype=torch.float32, device=dev)
                                 for x in (image, vertex, normal)), self.factor)
        codes, good = fern_encode_device(views[0], views[1], *self.encode_tables())
        db_c, db_g, db_t, db_n = self.device_db()
        scores = fern_score_device(
            codes, good, db_c, db_g, db_t, db_n,
            torch.tensor(float(time), device=dev), self.cfg.fern_min_age)
        f32 = torch.float32
        vec = read_back(torch.cat(
            [codes.to(f32), torch.stack([good.to(f32), *(x.to(f32) for x in scores)])]))
        n = self.num
        add_min, best_id, best_d, block_hd = vec[n + 1:]
        return (views, vec[:n].astype(np.int32), int(vec[n]), float(add_min),
                int(best_id), float(best_d), float(block_hd))

    # -- public surface (addFrame / findFrame) -------------------------------

    def add_frame(self, image, vertex, normal, T_wc: np.ndarray, src_time: int,
                  threshold: Optional[float] = None) -> bool:
        """Ferns::addFrame (Ferns.cpp:78-160) of a full-resolution predicted
        view: keep it as a keyframe iff its least dissimilarity over the DB
        exceeds the threshold."""
        views, codes, good, add_min, *_ = self._views_and_scores(
            image, vertex, normal, src_time)
        return self.add_frame_scored(add_min, codes, good, views, T_wc, src_time,
                                     threshold)

    def _append_keyframe(self, codes, good, views, T_wc, src_time) -> bool:
        rgb_s, vert_s, norm_s = _to_small(*views)
        f = FernFrame(
            id=len(self.frames), codes=codes, good_codes=int(good),
            T_wc=np.asarray(T_wc, np.float64).copy(), src_time=int(src_time),
            rgb=rgb_s, verts=vert_s, norms=norm_s,
        )
        self.frames.append(f)
        self._db_upload(f.id, codes, int(good), int(src_time))
        return True

    def add_frame_scored(self, add_min: float, codes, good, views,
                         T_wc: np.ndarray, src_time: int,
                         threshold: Optional[float] = None) -> bool:
        """addFrame with the dissimilarity minimum already scored on the
        device: no host compute unless the keyframe is kept."""
        threshold = self.cfg.fern_threshold if threshold is None else threshold
        if good == 0:
            return False
        if len(self.frames) == 0 or add_min > threshold:
            return self._append_keyframe(
                np.asarray(codes, np.uint8).reshape(-1), int(good), views,
                T_wc, src_time,
            )
        return False

    def closest_src_time(self) -> int:
        """src_time of the last accepted retrieval winner (check
        `last_closest != -1` first)."""
        return self.frames[self.last_closest].src_time

    def find_frame_scored(self, best_id: int, best_d: float, block_hd: float,
                          codes, good, views, T_wc: np.ndarray, time: int,
                          lost: bool):
        """findFrame with scoring and blockHDAware done on the device; the host
        runs only the accept branch: fern-resolution ICP, photometric check,
        constraints (Ferns.cpp:231-291)."""
        self.last_closest = -1
        constraints: List[SurfaceConstraint] = []
        if (not self.frames or good == 0 or not np.isfinite(best_d)
                or best_id >= len(self.frames) or block_hd <= 0.3):
            return None, constraints
        fern = self.frames[int(best_id)]

        rgb_s, vert_s, norm_s = _to_small(*views)
        T_est_mat, icp_error, icp_count = self._fern_icp(fern, vert_s, norm_s)

        photo = self._photometric_check(vert_s, rgb_s, T_est_mat, fern)
        icp_count_thresh = (
            self.cfg.lost_inlier_relax if lost else self.cfg.fern_inlier_count
        )
        if not (icp_error < self.cfg.fern_icp_error
                and icp_count > icp_count_thresh
                and photo < self.cfg.photo_threshold):
            return None, constraints

        self.last_closest = int(best_id)
        return T_est_mat, self._emit_constraints(vert_s, T_wc, T_est_mat)

    def _emit_constraints(self, vert_s, T_wc, T_est_mat):
        """Surface constraints at every num/50-th fern (Ferns.cpp:265-291)."""
        constraints: List[SurfaceConstraint] = []
        T_wc = np.asarray(T_wc, np.float64)
        step = max(self.num // 50, 1)
        for i in range(0, self.num, step):
            x, y = self.pos[i]
            z = vert_s[2, y, x]
            if z > 0 and int(z * 1000.0) < self.max_depth_mm:
                p = np.array([vert_s[0, y, x], vert_s[1, y, x], z, 1.0])
                constraints.append(SurfaceConstraint(
                    source_point=(T_wc @ p)[:3],
                    target_point=(T_est_mat @ p)[:3],
                ))
        return constraints

    def find_frame(self, image, vertex, normal, T_wc: np.ndarray, time: int,
                   lost: bool):
        """Ferns::findFrame (Ferns.cpp:162-298) of a full-resolution predicted
        view.  Returns (T_wc_recovery | None, [SurfaceConstraint]); sets
        `last_closest`."""
        views, codes, good, _, best_id, best_d, block_hd = self._views_and_scores(
            image, vertex, normal, time)
        return self.find_frame_scored(
            best_id, best_d, block_hd, codes, good, views, T_wc, time, lost)

    # -- internals -----------------------------------------------------------

    def _fern_icp(self, fern: FernFrame, vert_s, norm_s):
        """Depth-only ICP of the current view against the keyframe's, from the
        keyframe pose, through the tracker at fern resolution.  Returns
        (T float64, icp_error, icp_count), read in one copy."""
        cfg = self.fern_cfg
        dev = self.device
        h, w = self.height, self.width
        zeros_img = [torch.zeros((h >> lvl, w >> lvl), device=dev) for lvl in range(3)]

        def pyramid(v, n):
            up = lambda a: torch.from_numpy(  # noqa: E731
                np.ascontiguousarray(a, np.float32)).to(dev)
            vm, nm = [up(v)], [up(n)]
            for _ in range(2):
                vm.append(resize_vmap(vm[-1]))
                nm.append(resize_nmap(nm[-1]))
            return vm, nm

        vmaps_c, nmaps_c = pyramid(vert_s, norm_s)
        vm, nm = pyramid(fern.verts, fern.norms)
        Td = torch.from_numpy(np.asarray(fern.T_wc, np.float32)).to(dev)
        R, t = Td[:3, :3], Td[:3, 3]

        def to_world(v, n):
            valid = v[2] > 0
            _, H, W = v.shape
            vg = (R @ v.reshape(3, -1) + t[:, None]).reshape(3, H, W)
            ng = (R @ n.reshape(3, -1)).reshape(3, H, W)
            nvalid = torch.sum(n * n, dim=0) > 1e-12
            return (torch.where(valid[None], vg, torch.zeros_like(vg)),
                    torch.where(nvalid[None], ng, torch.zeros_like(ng)))

        world = [to_world(v, n) for v, n in zip(vm, nm)]
        inputs = OdometryInputs(
            vmaps_curr=tuple(vmaps_c), nmaps_curr=tuple(nmaps_c),
            vmaps_prev_g=tuple(w_[0] for w_ in world),
            nmaps_prev_g=tuple(w_[1] for w_ in world),
            last_images=tuple(zeros_img), next_images=tuple(zeros_img),
            last_depths=tuple(zeros_img), next_depths=tuple(zeros_img),
            so3_last_image=zeros_img[2], T_prev=Td,
        )
        res = get_incremental_transformation(inputs, cfg)
        got = read_back(torch.cat([res.T_curr.reshape(-1), res.icp_error[None],
                                   res.icp_count[None]])).astype(np.float64)
        return got[:16].reshape(4, 4), float(got[16]), float(got[17])

    def _photometric_check(self, vert_s, rgb_s, T_est, fern: FernFrame) -> float:
        """Reprojection colour error at the fern pixels (Ferns.cpp:300-364)."""
        cam = self.fern_cam
        T = np.linalg.inv(fern.T_wc) @ T_est
        x, y = self.pos[:, 0], self.pos[:, 1]
        z = vert_s[2, y, x]
        ok = (z > 0) & ((z * 1000.0).astype(np.int64) < self.max_depth_mm)
        p = np.stack([vert_s[0, y, x], vert_s[1, y, x], z], axis=0)
        pf = T[:3, :3] @ p + T[:3, 3:4]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = (pf[0] * cam.fx / pf[2] + cam.cx).astype(np.int64)
            v = (pf[1] * cam.fy / pf[2] + cam.cy).astype(np.int64)
        inb = (u >= 0) & (v >= 0) & (u < cam.width) & (v < cam.height) & ok
        uc = np.clip(u, 0, cam.width - 1)
        vc = np.clip(v, 0, cam.height - 1)
        fern_px = fern.rgb[vc, uc].astype(np.int64)     # [num, 3]
        cur_px = rgb_s[y, x].astype(np.int64)
        nonblack = fern_px.sum(axis=1) > 0
        use = inb & nonblack
        if use.sum() == 0:
            return np.inf
        return float(np.abs(fern_px[use] - cur_px[use]).sum() / use.sum())
