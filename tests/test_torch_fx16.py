"""The fx16 clean patch on the CPU: `ops/gatherpack.py` against the
reference's (the fixed-point cases of `tests/test_gatherpack.py`; its exact
packed gather is a plain indexed gather in the port),
`clean(fx16_patch=True)` against the reference's on a real frame, the
`init_t` compare on a constructed window, and `slam_step` at the default
`EngineConfig` (`fx16_clean=True`) against the reference's.

Tolerances: u16 codes bit-equal; decoded values within 1 ulp (XLA:CPU
contracts `code * scale + lo` into one fused multiply-add, the port rounds
the product first); clean's keep decisions identical (0 flips) on the real
frame; `slam_step` within the slice's tolerance (1e-3 m, 1e-3 rad, 1 % of the
surfels a frame).  Every reference call of the module is in ONE `jax.jit`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SMALL_CAM, both_cams, nn, rot_err, tt
from elasticfusion_tpu import engine as ref_engine
from elasticfusion_tpu.config import EngineConfig as RefConfig
from elasticfusion_tpu.ops import fuse as ref_fuse
from elasticfusion_tpu.ops import gatherpack as ref_gp
from elasticfusion_tpu.ops.splat import IndexPrediction as RefIndexPrediction
from elasticfusion_tpu.utils.synthetic import make_scene, render_frame, synthetic_trajectory
from elasticfusion_tpu_torch import convert
from elasticfusion_tpu_torch import engine as port_engine
from elasticfusion_tpu_torch.config import EngineConfig as PortConfig
from elasticfusion_tpu_torch.ops import fuse as port_fuse
from elasticfusion_tpu_torch.ops import gatherpack as port_gp
from elasticfusion_tpu_torch.ops.splat import IndexPrediction
from elasticfusion_tpu_torch.surfels import SurfelMap

N_FRAMES = 3            # the first initialises the map, two are tracked
CAP = 1 << 16
CFG = dict(closeLoops=False, confidence_threshold=0.3, initial_surfels=CAP,
           max_surfels=CAP)                       # fx16_clean: the default, True
WEIGHT = 0.5
CONF = 0.3


def _gp_inputs():
    rng = np.random.default_rng(1)
    bound = [rng.uniform(-5.0, 5.0, size=4096).astype(np.float32),
             rng.uniform(-1.0, 1.0, size=4096).astype(np.float32),
             rng.uniform(0.0, 20.0, size=4096).astype(np.float32)]
    rng = np.random.default_rng(2)
    odd = [rng.uniform(-1, 1, size=512).astype(np.float32) for _ in range(3)]
    rng = np.random.default_rng(3)
    six = [rng.uniform(-3, 3, size=2048).astype(np.float32) for _ in range(6)]
    six_idx = rng.integers(0, 2048, size=777, dtype=np.int32)
    return dict(bound=bound, odd=odd, six=six, six_idx=six_idx)


def _window_case():
    """A map of one surfel and a 9x9 index prediction around it whose every
    candidate is stable, just behind it (5 mm), at its position and created
    at the SAME tick 7: none is older, so nothing may cull it.  Two far
    pixels created at ticks 0 and 11 set every shifted init-time channel's
    range to [0, 11], where the u16 code of 7 (41704) decodes to
    7 - 1.5e-5."""
    H = W = 9
    m = dict(pos=np.array([[0.0], [0.0], [1.0]], np.float32),
             conf=np.array([5.0], np.float32), color=np.zeros((3, 1), np.float32),
             init_t=np.array([7.0], np.float32), last_t=np.array([11.0], np.float32),
             normal=np.array([[0.0], [0.0], [-1.0]], np.float32),
             radius=np.array([0.01], np.float32), count=np.int32(1))
    vert = np.zeros((3, H, W), np.float32)
    vert[2] = 1.005
    init_t = np.full((H, W), 7.0, np.float32)
    init_t[1, 1], init_t[8, 8] = 11.0, 0.0
    pred = dict(index=np.zeros((H, W), np.int32), vert=vert,
                normal=np.zeros((3, H, W), np.float32), radius=np.full((H, W), 0.01, np.float32),
                conf=np.full((H, W), 5.0, np.float32), init_t=init_t,
                last_t=np.full((H, W), 11.0, np.float32))
    cam = dict(width=W, height=H, fx=10.0, fy=10.0, cx=4.5, cy=4.5)
    return m, pred, cam


@pytest.fixture(scope="module")
def world():
    ref_cam, port_cam = both_cams(SMALL_CAM)
    scene = make_scene(n_side=500)
    poses = synthetic_trajectory("sweep", 120)[:N_FRAMES]
    rendered = [render_frame(scene[0], scene[1], T, ref_cam) for T in poses]
    gp = _gp_inputs()
    wm, wpred, wcam = _window_case()
    ref_wcam = type(ref_cam)(**wcam)
    cfg = RefConfig(camera=ref_cam, **CFG)

    @jax.jit
    def reference(depth, rgb, T, gp, wm, wpred):
        out = {}
        for k in ("bound", "odd", "six"):
            pk = ref_gp.pack_fx16(gp[k])
            out[k + "_words"] = pk[1]
            out[k + "_los"], out[k + "_scales"] = pk[2], pk[3]
            n = gp[k][0].shape[0]
            out[k] = ref_gp.gather_fx16(pk, jnp.arange(n, dtype=jnp.int32))
        out["six_exact"] = ref_gp.gather_packed(
            ref_gp.pack_channels(gp["six"]), gp["six_idx"])
        out["six_quant"] = ref_gp.gather_fx16(ref_gp.pack_fx16(gp["six"]), gp["six_idx"])

        # a real frame: first-frame map, then frame 2's fuse with its depth
        # 3 % farther (the measured surface lands 6 cm behind the map's, fails
        # association and appends there; clean then culls map surfels in
        # free space before it), and clean with both patches
        d0, rgb0 = depth[0], rgb[0]
        raw_m, filt_m = ref_engine._preprocess(d0, cfg)
        m = ref_engine._init_map(raw_m, filt_m, rgb0, cfg, CAP)
        raw1, filt1 = ref_engine._preprocess(depth[1].astype(jnp.float32) * 1.03, cfg)
        tick = jnp.float32(2.0)
        pidx = ref_engine.predict_indices(m, T[1], ref_cam, tick, 200, 20.0)
        m2, _, upd = ref_fuse.fuse(m, pidx, T[1], tick, rgb[1], raw1, filt1, ref_cam,
                                   20.0, jnp.float32(WEIGHT), return_updated_pred=True)
        out["frame"] = (m, m2, upd)
        out["clean_fx16"] = ref_fuse.clean(m2, upd, T[1], tick, ref_cam, CONF, 200,
                                           20.0, 20, do_compact=False, fx16_patch=True)
        out["clean_exact"] = ref_fuse.clean(m2, upd, T[1], tick, ref_cam, CONF, 200,
                                            20.0, 20, do_compact=False)
        wmap = ref_engine.SurfelMap(**wm)
        wp = RefIndexPrediction(**wpred)
        eye = jnp.eye(4, dtype=jnp.float32)
        out["window_fx16"] = ref_fuse.clean(wmap, wp, eye, jnp.float32(11.0), ref_wcam,
                                            CONF, 200, 20.0, 20, do_compact=False,
                                            fx16_patch=True)
        out["window_exact"] = ref_fuse.clean(wmap, wp, eye, jnp.float32(11.0), ref_wcam,
                                             CONF, 200, 20.0, 20, do_compact=False)
        return out

    depth = jnp.asarray(np.stack([d for d, _ in rendered]))
    rgb = jnp.asarray(np.stack([r for _, r in rendered]))
    T = jnp.asarray(np.stack(poses).astype(np.float32))
    ref = jax.tree.map(np.asarray, reference(depth, rgb, T, gp, wm, wpred))
    return dict(ref=ref, gp=gp, window=(wm, wpred, wcam), ref_cam=ref_cam,
                port_cam=port_cam, poses=poses, rendered=rendered)


def _ulps(a, b):
    """Distance in float32 units in the last place, elementwise."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("case", ["bound", "odd", "six"])
def test_fx16_codes_equal_the_reference_and_decode_within_an_ulp(world, case):
    """The u16 words bit-equal, lo and scale equal, decoded values within 1
    ulp of the reference's and within scale/2 (+ one rounding) of the
    input — the bound `tests/test_gatherpack.py` pins."""
    chans = world["gp"][case]
    ref = world["ref"]
    packed = port_gp.pack_fx16([tt(c) for c in chans])
    assert packed[1].dtype == torch.int32
    np.testing.assert_array_equal(nn(packed[1]).view(np.uint32),
                                  ref[case + "_words"].view(np.uint32))
    np.testing.assert_array_equal(nn(packed[2]), ref[case + "_los"])
    np.testing.assert_array_equal(nn(packed[3]), ref[case + "_scales"])
    n = chans[0].shape[0]
    got = port_gp.gather_fx16(packed, torch.arange(n))
    assert len(got) == len(chans)
    for c, g, r in zip(chans, got, ref[case]):
        assert _ulps(nn(g), r).max() <= 1
        lo, hi = float(c.min()), float(c.max())
        scale = max(hi - lo, 1e-20) / 65535.0
        assert np.abs(nn(g) - c).max() <= scale * 0.5 + 1e-6 * max(abs(lo), abs(hi))


def test_fx16_matches_f32_table_on_same_indices(world):
    six, idx = world["gp"]["six"], tt(world["gp"]["six_idx"]).long()
    exact = torch.stack([tt(c) for c in six])[:, idx]
    quant = port_gp.gather_fx16(port_gp.pack_fx16([tt(c) for c in six]), idx)
    for e, q, re_, rq in zip(exact, quant, world["ref"]["six_exact"],
                             world["ref"]["six_quant"]):
        np.testing.assert_array_equal(nn(e), re_)
        assert _ulps(nn(q), rq).max() <= 1
        assert np.abs(nn(e) - nn(q)).max() < 6.0 / 65535.0


def _port_clean(world, fx16):
    m, m2, upd = world["ref"]["frame"]
    m2p = convert.surfel_map_from_numpy({f: m2[i] for i, f in enumerate(SurfelMap._fields)},
                                        "cpu")
    updp = IndexPrediction(*(tt(a) for a in upd))
    T = tt(np.asarray(world["poses"][1], np.float32))
    return port_fuse.clean(m2p, updp, T, 2.0, world["port_cam"], CONF, 200, 20.0, 20,
                           do_compact=False, fx16_patch=fx16)


@pytest.mark.parametrize("fx16", [True, False], ids=["fx16", "exact"])
def test_clean_on_a_real_frame_makes_the_references_decisions(world, fx16):
    """From the reference's fused map and post-fuse prediction of frame 2
    (its depth 3 % farther):
    every surfel's keep decision is the reference's (0 flips) and the
    surviving rows are bit-equal."""
    got = _port_clean(world, fx16)
    want = world["ref"]["clean_fx16" if fx16 else "clean_exact"]
    live = int(want[7])
    got_conf, want_conf = nn(got.conf)[:live], want[1][:live]
    kept_port, kept_ref = got_conf != 0, want_conf != 0
    assert int((kept_port != kept_ref).sum()) == 0
    assert 0 < int((~kept_ref).sum()), "the frame must cull something"
    for i, f in enumerate(SurfelMap._fields[:-1]):
        np.testing.assert_array_equal(nn(getattr(got, f)), want[i], err_msg=f)


def test_fx16_init_time_compare_keeps_a_same_tick_window():
    """The constructed window (`_window_case`): every candidate was created
    at the surfel's own tick.  The exact patch and the port's fx16 patch
    (half-tick margin) keep the surfel; the reference's fx16 patch, whose
    strict `<` meets the decoded 6.99992, counts all nine candidates as
    older and culls it."""
    wm, wpred, wcam = _window_case()
    m = convert.surfel_map_from_numpy(wm, "cpu")
    pred = IndexPrediction(**{k: tt(v) for k, v in wpred.items()})
    _, cam = both_cams(wcam)
    eye = torch.eye(4)
    decoded = port_gp.gather_fx16(port_gp.pack_fx16([pred.init_t]), torch.tensor([4 * 9 + 4]))[0]
    assert float(decoded) < 7.0                      # the code of 7 decodes below 7
    for fx16 in (True, False):
        out = port_fuse.clean(m, pred, eye, 11.0, cam, CONF, 200, 20.0, 20,
                              do_compact=False, fx16_patch=fx16)
        assert float(out.conf[0]) == 5.0, f"fx16={fx16} culled the surfel"


def test_the_reference_flips_on_the_constructed_window(world):
    ref = world["ref"]
    assert float(ref["window_exact"][1][0]) == 5.0          # kept
    assert float(ref["window_fx16"][1][0]) == 0.0           # culled: the flip


def test_slam_step_at_the_default_config_matches_the_reference(world):
    """`slam_step` at the default `EngineConfig` (fx16_clean on) in both
    packages from the same state, two frames."""
    ref_cam, port_cam = world["ref_cam"], world["port_cam"]
    rendered, poses = world["rendered"], world["poses"]
    rcfg, pcfg = RefConfig(camera=ref_cam, **CFG), PortConfig(camera=port_cam, **CFG)
    assert rcfg.fx16_clean and pcfg.fx16_clean
    d0, rgb0 = rendered[0]
    T0 = np.asarray(poses[0], np.float32)
    state = {}
    for name, pkg, cfg in (("ref", ref_engine, rcfg), ("port", port_engine, pcfg)):
        arr = (lambda a: jnp.asarray(a)) if name == "ref" else tt
        raw_m, filt_m = pkg._preprocess(arr(d0.astype(np.float32)), cfg)
        m = pkg._init_map(raw_m, filt_m, arr(rgb0), cfg, CAP)
        one = jnp.float32(1.0) if name == "ref" else 1.0
        _, fill, _, _ = pkg._predict_only(m, arr(T0), one, one, filt_m, arr(rgb0),
                                          jnp.bool_(False) if name == "ref" else False, cfg)
        state[name] = (m, arr(T0), pkg._coarse_intensity(arr(rgb0), cfg), fill)
    assert int(state["ref"][0].count) == int(state["port"][0].count)
    for i in range(1, N_FRAMES):
        d, rgb = rendered[i]
        out = {}
        for name, pkg, cfg in (("ref", ref_engine, rcfg), ("port", port_engine, pcfg)):
            m, T, so3, fill = state[name]
            if name == "ref":
                args = (jnp.asarray(d), jnp.asarray(rgb), jnp.float32(i + 1),
                        jnp.float32(WEIGHT))
            else:
                args = (tt(d.astype(np.float32)), tt(rgb), float(i + 1), WEIGHT)
            m, T, so3, fill, pred, dense, res = pkg.slam_step(
                m, T, so3, fill[0], fill[1], fill[2], *args, cfg)
            state[name] = (m, T, so3, fill)
            out[name] = (nn(T), int(m.count))
        (Tp, cp), (Tr, cr) = out["port"], out["ref"]
        assert np.linalg.norm(Tp[:3, 3] - Tr[:3, 3]) < 1e-3, f"frame {i + 1}"
        assert rot_err(Tp, Tr) < 1e-3, f"frame {i + 1}"
        assert abs(cp - cr) <= 0.01 * cr, f"frame {i + 1}: {cp} vs {cr}"
        assert np.linalg.norm(Tp[:3, 3] - np.asarray(poses[i])[:3, 3]) < 5e-3
