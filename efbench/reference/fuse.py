"""Surfel fusion and cleanup — the equivalent of `GlobalModel::fuse` and
`GlobalModel::clean` (Core/GlobalModel.cpp:356-671) and their GLSL programs
(data.vert/geom, update.vert, copy_unstable.vert/geom).

Structure (as in the reference package):
  - *Data pass*: per input pixel, search the index-map window for the best
    existing surfel (K3, ops/fuse_window.py); matched pixels contribute an
    update to the winner, unmatched ones become new unstable surfels.
  - *Update pass*: every map surfel fetches the contribution sums at its own
    pixel and merges by confidence-weighted averaging.  ALL matching
    measurements accumulate (not last-write-wins), in a fixed order.
  - *Clean pass*: cull merged / free-space-violating / stale-unstable
    surfels with the {1,2,1}x{1,2,1} window weights, and compact survivors.

`fuse` also runs on one shard of a sharded map (`parallel/shard_step.py`)
with the reference's shard-local arguments (`id_base`, `append_*`).  Both
functions return new map tensors and leave their inputs untouched (no
in-place update of the caller's map), so a caller may keep the old map.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .config import CameraConfig
from .surfels import (
    SurfelMap,
    central_diff_normals,
    compact,
    pack_map,
    pixel_confidence,
    pixel_grid,
    recip32,
    surfel_radius,
    unpack_map,
)
from .fuse_window import fuse_window
from .gatherpack import gather_fx16, pack_fx16
from .preprocess import shift2d
from .splat import IndexPrediction

WINDOW_INPUTS_SPAN = "fuse.window_inputs_cat"
# K3's "no match" id in shard-local mode, where the prediction carries
# global ids: above every global id (a sharded map's capacity stays below it)
GLOBAL_ID_LIMIT = (1 << 24) - 1

# clean()'s 3x3 window weights — the pixel-aliasing multiplicity of the
# original's 16-sample loop
_W3 = (1.0, 2.0, 1.0)


class FuseStats(NamedTuple):
    matched: torch.Tensor   # pixels merged into existing surfels
    added: torch.Tensor     # new unstable surfels appended
    count: torch.Tensor     # live surfel count after fuse


def _project_floor(pos_c: torch.Tensor, cam: CameraConfig):
    zs = pos_c[2]
    safe = torch.where(torch.abs(zs) > 1e-12, zs, torch.ones_like(zs))
    us = torch.floor(pos_c[0] * cam.fx / safe + cam.cx).to(torch.int64)
    vs = torch.floor(pos_c[1] * cam.fy / safe + cam.cy).to(torch.int64)
    return zs, us, vs


def fuse(
    m: SurfelMap,
    pred: IndexPrediction,
    T_wc: torch.Tensor,
    tick,
    rgb: torch.Tensor,              # [H,W,3] u8/f32
    depth_raw_m: torch.Tensor,      # [H,W] metric raw depth
    depth_filtered_m: torch.Tensor,  # [H,W] metric filtered depth
    cam: CameraConfig,
    max_depth: float,
    weighting,
    return_updated_pred: bool = False,
    id_base: Optional[int] = None,
    append_on=None,
    append_base=None,
    append_free=None,
):
    """GlobalModel::fuse (GlobalModel.cpp:356-525).  See module docstring.

    Shard-local mode (ref ops/fuse.py:148-173): `m` is ONE shard of the map
    while `pred` carries GLOBAL surfel ids.  `id_base` is this shard's first
    global id (the winner test becomes pred.index == id_base + slot);
    `append_on` (bool, or a 0-d bool tensor) lets only the frame's owner
    shard write the appended surfels, at most `append_free` of them;
    `append_base` is the global id of the first one (the owner's id_base +
    count), so the updated prediction is the same on every shard.

    With `return_updated_pred` the POST-fuse index prediction is derived in
    the pixel domain and returned as a third output, replacing the original's
    second `predictIndices` render before clean (ElasticFusion.cpp:554-555).
    This is exact for merges (a raster winner projects to its own pixel, so
    its pixel's contribution sums ARE its update) and for appended surfels (a
    new surfel projects exactly to the pixel it was measured at); the only
    divergence from a re-render is a merged surfel whose averaged position
    crosses a pixel boundary — its entry stays at the old pixel, within the
    3x3 window every consumer searches anyway."""
    H, W = depth_raw_m.shape
    dev = depth_raw_m.device
    n_px = H * W
    cap = m.capacity
    tickf = torch.as_tensor(tick, dtype=torch.float32, device=dev)

    u, v = pixel_grid(H, W, dev)
    ui = u.to(torch.int64)
    vi = v.to(torch.int64)

    # --- measurement construction (data.vert:76-105) ---
    z = depth_raw_m
    xl = (u - cam.cx) * recip32(cam.fx)
    yl = (v - cam.cy) * recip32(cam.fy)
    v_local = torch.stack([xl * z, yl * z, z])                # raw-depth vertex
    n_local, n_valid = central_diff_normals(depth_filtered_m, cam)
    rad_new = surfel_radius(depth_filtered_m, n_local[2], cam)
    conf_new = pixel_confidence(u, v, weighting, cam)

    # --- validity gates (data.vert:110-114) ---
    par = torch.remainder(tickf, 2.0).to(torch.int64)
    sub = ((ui % 2) == par) & ((vi % 2) == par)
    nb_ok = torch.ones((H, W), dtype=torch.bool, device=dev)
    for dy, dx in ((0, -1), (-1, 0), (0, 1), (1, 0)):
        nb_ok &= shift2d(z, dy, dx) > 0          # out-of-image reads 0: fails
    measuring = sub & nb_ok & (z > 0) & (z <= max_depth) & n_valid

    R = T_wc[:3, :3]
    t = T_wc[:3, 3]
    rgbf = rgb.to(torch.float32)

    # --- window search (data.vert:123-158) + merge accumulation
    # (update.vert:49-92, generalized to all matches): K3.  A surfel wins at
    # most ONE index-map pixel w, and a measuring pixel q matches it only
    # when w lies in q's 3x3 window, so all of its contributions live in the
    # 3x3 neighbourhood of w: they are accumulated as pixel-domain images and
    # fetched per surfel with one gather.
    planes = [
        (pred.index + 1).to(torch.float32)[None],
        pred.vert, pred.normal, pred.radius[None],
        z[None], n_local,
        measuring.to(torch.float32)[None],
        conf_new[None], rad_new[None],
        rgbf.permute(2, 0, 1),
    ]
    # named for the profiler: the device time of this copy is K3's input cost
    with torch.profiler.record_function(WINDOW_INPUTS_SPAN):
        chan = torch.cat(planes)
    params = torch.cat([R.reshape(-1), t]).to(torch.float32).contiguous()
    outk = fuse_window(chan, params, cam.fx, cam.fy, cam.cx, cam.cy,
                       cap if id_base is None else GLOBAL_ID_LIMIT)
    matched = outk[3] > 0.0
    contrib = outk[4:16]
    new_pt = measuring & ~matched

    v_g = (R @ v_local.reshape(3, -1) + t[:, None])            # world
    n_g = R @ n_local.reshape(3, -1)
    col_meas = rgbf.reshape(-1, 3).T

    # per-surfel fetch at its own projected pixel; valid only if it is the
    # index-map winner there (the contribution images are keyed to winners)
    T_cw_R = R.T
    pos_cs = T_cw_R @ (m.pos - t[:, None])
    zs, us, vs = _project_floor(pos_cs, cam)
    proj_ok = (zs > 0) & (us >= 0) & (vs >= 0) & (us < W) & (vs < H)
    wflat = torch.where(
        proj_ok, torch.clamp(vs, 0, H - 1) * W + torch.clamp(us, 0, W - 1),
        torch.zeros_like(us),
    )
    slot_ids = torch.arange(cap, device=dev)
    is_winner = proj_ok & (pred.index.reshape(-1)[wflat]
                           == slot_ids + (id_base or 0))
    got = contrib.reshape(12, -1)[:, wflat]
    got = torch.where(is_winner[None], got, torch.zeros_like(got))
    sum_a, sum_af = got[0], got[1]
    sum_av, sum_ac, sum_an, sum_ar = got[2:5], got[5:8], got[8:11], got[11]

    c_k = m.conf
    denom_f = c_k + sum_af
    has_full = sum_af > 0
    safe_den = torch.where(has_full, denom_f, torch.ones_like(denom_f))
    new_pos = torch.where(has_full[None], (c_k[None] * m.pos + sum_av) / safe_den[None], m.pos)
    new_col = torch.where(has_full[None], (c_k[None] * m.color + sum_ac) / safe_den[None], m.color)
    nr = c_k[None] * m.normal + sum_an
    nr_n = torch.sqrt(torch.sum(nr * nr, dim=0, keepdim=True))
    new_norm = torch.where(has_full[None], nr / torch.clamp(nr_n, min=1e-12), m.normal)
    new_rad = torch.where(has_full, (c_k * m.radius + sum_ar) / safe_den, m.radius)
    touched = sum_a > 0
    new_conf = c_k + sum_a
    new_last = torch.where(touched, tickf, m.last_t)

    # --- append new unstable surfels (data.geom:36-49) ---
    # A stable sort brings the new points' pixel rows to a dense prefix in
    # raster order; slot s of the map then takes row s - count when that row
    # exists and the slot is free.  Appends clamp at capacity.  n_app: the
    # frame's append count (the same on every shard); n_new: the slots THIS
    # call writes (none off the owner shard).
    npm = new_pt.reshape(-1)
    count = m.count.to(torch.int64)
    free = cap - count if append_free is None else append_free
    n_app = torch.minimum(npm.sum(), free)
    n_new = n_app if append_on is None else torch.where(
        torch.as_tensor(append_on, device=dev), n_app, torch.zeros_like(n_app))
    n_new = torch.minimum(n_new, cap - count)

    _, px_perm = torch.sort((~npm).to(torch.int8), stable=True)
    ticks = tickf.expand(n_px)
    rows = torch.cat([
        v_g, conf_new.reshape(1, -1), col_meas, ticks[None], ticks[None],
        n_g, rad_new.reshape(1, -1),
    ])[:, px_perm]                                             # [13, n_px]
    j = slot_ids - count
    take = (j >= 0) & (j < n_new)
    appended = rows[:, torch.clamp(j, 0, n_px - 1)]            # [13, cap]
    merged = pack_map(SurfelMap(
        pos=new_pos, conf=new_conf, color=new_col, init_t=m.init_t,
        last_t=new_last, normal=new_norm, radius=new_rad, count=m.count))
    out = unpack_map(torch.where(take[None], appended, merged),
                     (count + n_new).to(torch.int32))
    stats = FuseStats(
        matched=matched.sum().to(torch.int32),
        added=n_new.to(torch.int32),
        count=out.count,
    )
    if not return_updated_pred:
        return out, stats

    # --- pixel-domain post-fuse index prediction ---------------------------
    idx_valid = pred.index >= 0
    sum_a_px = contrib[0]
    sum_af_px = contrib[1]
    sum_av_px = contrib[2:5]
    sum_an_px = contrib[8:11]
    sum_ar_px = contrib[11]
    c_px = pred.conf
    touched_px = idx_valid & (sum_a_px > 0)
    hf = idx_valid & (sum_af_px > 0)
    den = torch.where(hf, c_px + sum_af_px, torch.ones_like(c_px))
    world_old = (R @ pred.vert.reshape(3, -1) + t[:, None]).reshape(3, H, W)
    new_world = (c_px[None] * world_old + sum_av_px) / den[None]
    vert_m = (T_cw_R @ (new_world.reshape(3, -1) - t[:, None])).reshape(3, H, W)
    p_vert = torch.where(hf[None], vert_m, pred.vert)
    nw_old = (R @ pred.normal.reshape(3, -1)).reshape(3, H, W)
    nw = c_px[None] * nw_old + sum_an_px
    nw_len = torch.sqrt(torch.sum(nw * nw, dim=0, keepdim=True))
    norm_m = (T_cw_R @ (nw / torch.clamp(nw_len, min=1e-12)).reshape(3, -1)
              ).reshape(3, H, W)
    p_norm = torch.where(hf[None], norm_m, pred.normal)
    p_rad = torch.where(hf, (c_px * pred.radius + sum_ar_px) / den, pred.radius)
    p_conf = torch.where(idx_valid, c_px + sum_a_px, pred.conf)
    p_last = torch.where(touched_px, tickf, pred.last_t)

    # appended surfels: the stable sort preserves pixel raster order, so a
    # new point's slot is count + its exclusive-prefix rank
    npm_i = npm.to(torch.int64)
    rank = (torch.cumsum(npm_i, 0) - npm_i).reshape(H, W)
    app_px = new_pt & (rank < n_app)
    z_new = v_local[2]
    # z-buffer vs the existing winner (ties keep the old, lower id)
    app_wins = app_px & (~idx_valid | (z_new < p_vert[2]))
    new_ids = ((count if append_base is None else append_base) + rank).to(torch.int32)
    p_index = torch.where(app_wins, new_ids, pred.index)
    p_vert = torch.where(app_wins[None], v_local, p_vert)
    p_norm = torch.where(app_wins[None], n_local, p_norm)
    p_rad = torch.where(app_wins, rad_new, p_rad)
    p_conf = torch.where(app_wins, conf_new, p_conf)
    p_init = torch.where(app_wins, tickf, pred.init_t)
    p_last = torch.where(app_wins, tickf, p_last)

    upd = IndexPrediction(
        index=p_index, vert=p_vert, normal=p_norm, radius=p_rad,
        conf=p_conf, init_t=p_init, last_t=p_last,
    )
    return out, stats, upd


def clean(
    m: SurfelMap,
    pred: IndexPrediction,
    T_wc: torch.Tensor,
    tick,
    cam: CameraConfig,
    conf_threshold: float,
    time_delta: int,
    max_depth: float,
    unstable_age: int = 20,
    do_compact: bool = True,
    fx16_patch: bool = False,
) -> SurfelMap:
    """GlobalModel::clean (GlobalModel.cpp:527-671, copy_unstable.vert).

    Culling rules (copy_unstable.vert:75-128): a surfel dies if >=3 distinct
    stable older surfels overlap it in the index-map window (count>8 with
    {1,2,1} weights), or >=2 same-tick closer surfels occlude it (zCount>4 —
    free-space violation), or it timed out unstable (age>20 & conf<thresh);
    surfels outside the time window always survive.

    The window's 5 candidate channels are gathered per surfel at its centre
    pixel, exactly in float32, or with `fx16_patch` as the reference's u16
    fixed-point patch (ref ops/fuse.py:507-531): the 45 shifted channel
    images quantized by `gatherpack.pack_fx16` and decoded per surfel, so
    every test compares the reference's decoded values.  The flag tests sit
    at the mid-points 0.5 / 2.5 because a decoded flag can land an ulp below
    its integer.  The older-candidate test on decoded creation ticks takes a
    half-tick margin, `c_it < init_t - 0.5`, which on integer ticks is the
    exact `<`; the reference's strict `<` on the decoded value can flip when
    a decode lands just below an equal tick.  The deformation inputs of the
    reference (`deformed`, `depth_synth`) are applied by the engine's closure
    repair instead."""
    cap = m.capacity
    H, W = cam.height, cam.width
    dev = m.pos.device
    tickf = torch.as_tensor(tick, dtype=torch.float32, device=dev)
    T_cw_R = T_wc[:3, :3].T
    t = T_wc[:3, 3]
    lp = T_cw_R @ (m.pos - t[:, None])          # [3,N] camera frame
    ln = T_cw_R @ m.normal
    ln = ln / torch.clamp(torch.sqrt(torch.sum(ln * ln, dim=0, keepdim=True)), min=1e-12)

    safe_z = torch.where(torch.abs(lp[2]) > 1e-12, lp[2], torch.ones_like(lp[2]))
    x = lp[0] * cam.fx / safe_z + cam.cx
    y = lp[1] * cam.fy / safe_z + cam.cy
    px = torch.round(x).to(torch.int64)
    py = torch.round(y).to(torch.int64)

    in_view = (
        ((tickf - m.last_t) < time_delta)
        & (lp[2] > 0)
        & (x > 0) & (y > 0) & (x < W) & (y < H)
    )

    # candidate-side predicates fold into one flag channel (valid+stable=1,
    # +seen-this-tick=2)
    stable_px = (pred.index >= 0) & (pred.conf > conf_threshold)
    flag_px = stable_px.to(torch.float32) + 2.0 * (
        stable_px & (pred.last_t == tickf)).to(torch.float32)

    # the 3x3 window of the 5 candidate channels, gathered per surfel at its
    # centre pixel; out-of-image neighbours zero-fill, which clears the flag
    chans = torch.stack(
        [flag_px, pred.vert[2], pred.vert[0], pred.vert[1], pred.init_t])
    # dead / out-of-view surfels all read pixel 0: their rows are masked
    flat = torch.where(
        in_view, torch.clamp(py, 0, H - 1) * W + torch.clamp(px, 0, W - 1),
        torch.zeros_like(px),
    )
    offsets = [(iy, ix) for iy in (-1, 0, 1) for ix in (-1, 0, 1)]
    if fx16_patch:
        patch = gather_fx16(pack_fx16(
            [c for iy, ix in offsets for c in shift2d(chans, iy, ix)]), flat)
        window = [patch[5 * k:5 * k + 5] for k in range(9)]
        older_than = m.init_t - 0.5
    else:
        window = (shift2d(chans, iy, ix).reshape(5, -1)[:, flat] for iy, ix in offsets)
        older_than = m.init_t
    count = torch.zeros((cap,), dtype=torch.float32, device=dev)
    zcount = torch.zeros((cap,), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for (iy, ix), (c_flag, c_z, c_x, c_y, c_it) in zip(offsets, window):
        w = torch.full((), _W3[iy + 1] * _W3[ix + 1], dtype=torch.float32, device=dev)
        has = (c_flag >= 0.5) & in_view
        behind_me = c_z > lp[2]
        dz = c_z - lp[2]
        dxy = torch.sqrt((c_x - lp[0]) ** 2 + (c_y - lp[1]) ** 2)
        # merged-candidate overlap (copy_unstable.vert:84-96)
        count += torch.where(
            has & (c_it < older_than) & behind_me & (dz < 0.01)
            & (dxy < m.radius * 1.4),
            w, zero,
        )
        # free-space violation (copy_unstable.vert:98-106)
        zcount += torch.where(
            has & (c_flag >= 2.5) & behind_me & (dz > 0.01)
            & (torch.abs(ln[2]) > 0.85),
            w, zero,
        )

    keep = ~((count > 8.0) | (zcount > 4.0))
    # stale unstable (copy_unstable.vert:120-123)
    keep &= ~(((tickf - m.last_t) > unstable_age) & (m.conf < conf_threshold))
    # outside time window: always keep (copy_unstable.vert:125-128)
    keep |= (m.last_t > 0) & ((tickf - m.last_t) > time_delta)

    if do_compact:
        return compact(m, keep)
    # Amortized compaction: mark culled surfels dead IN PLACE of their slots
    # (the same zeroing compact applies) instead of compacting every frame.
    # Dead rows below `count` are inert: last_t=-1e9 fails every time-window
    # gate, conf=0 fails the stable gates, init_t=+inf never counts as older.
    slot = torch.arange(cap, device=dev)
    live_keep = keep | (slot >= m.count)
    kf = live_keep.to(torch.float32)
    return m._replace(
        pos=m.pos * kf[None],
        normal=m.normal * kf[None],
        color=m.color * kf[None],
        conf=m.conf * kf,
        radius=m.radius * kf,
        last_t=torch.where(live_keep, m.last_t, torch.full_like(m.last_t, -1e9)),
        init_t=torch.where(live_keep, m.init_t,
                           torch.full_like(m.init_t, float("inf"))),
    )
