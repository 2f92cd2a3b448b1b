"""ops/preprocess parity on the CPU: every stencil of the port against the
reference function on one rendered 160x120 frame.  The reference side is one
jitted function, compiled once for the module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SMALL_CAM, both_cams, nn, tt
from _torch_kernels import kernel_calls  # noqa: F401
from elasticfusion_tpu.ops import preprocess as ref_pp
from elasticfusion_tpu.utils.synthetic import make_scene, pose_from_xyzrpy, render_frame
from elasticfusion_tpu_torch.ops import bilateral as port_bf
from elasticfusion_tpu_torch.ops import preprocess as port_pp
from elasticfusion_tpu_torch.ops import pyramid as port_pyr


# every uint16 depth value, as a 256x256 image
EVERY_MM = np.arange(1 << 16, dtype=np.float32).reshape(256, 256)


@pytest.fixture(scope="module")
def frame():
    ref_cam, port_cam = both_cams(SMALL_CAM)
    scene = make_scene(n_side=400)
    depth_mm, rgb = render_frame(scene[0], scene[1],
                                 pose_from_xyzrpy(x=0.05, yaw=0.02), ref_cam)
    depth_mm = depth_mm.copy()
    depth_mm[40:60, 50:70] = 0              # a hole
    depth_mm[10:20, 100:120] = 250          # below the 300 mm gate
    return ref_cam, port_cam, depth_mm.astype(np.float32), rgb


@pytest.fixture(scope="module")
def ref_out(frame):
    ref_cam, _, depth_mm, rgb = frame

    @jax.jit
    def run(depth_mm, rgb, every_mm):
        filt = ref_pp.bilateral_filter(depth_mm, 20.0, 6)
        filt_m = ref_pp.metricise_depth(filt, 3.0)
        vmap = ref_pp.compute_vmap(filt_m, ref_cam, 20.0)
        nmap = ref_pp.compute_nmap(vmap)
        inten = ref_pp.rgb_to_intensity(rgb)
        dx, dy = ref_pp.compute_derivatives(inten)
        zdepth = ref_pp.vertices_to_depth(vmap, 2.2)
        return dict(
            bilateral=filt, metricise=filt_m, vmap=vmap, nmap=nmap,
            metricise_every_mm=ref_pp.metricise_depth(every_mm, 20.0),
            pyr_down_depth=ref_pp.pyr_down_depth(filt_m),
            vertices_to_depth=zdepth,
            pyr_down_gauss=ref_pp.pyr_down_gauss(zdepth),
            intensity=inten,
            pyr_down_intensity=ref_pp.pyr_down_intensity(inten),
            resize_vmap=ref_pp.resize_vmap(vmap),
            resize_nmap=ref_pp.resize_nmap(nmap),
            deriv_x=dx, deriv_y=dy,
        )

    out = run(jnp.asarray(depth_mm), jnp.asarray(rgb), jnp.asarray(EVERY_MM))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def port_out(frame, ref_out):
    """Each port function on the REFERENCE's input to that stage, so that one
    stage's rounding does not leak into the next comparison."""
    _, port_cam, depth_mm, rgb = frame
    r = {k: tt(v) for k, v in ref_out.items()}
    dx, dy = port_pyr.compute_derivatives(r["intensity"])
    return dict(
        bilateral=port_bf.bilateral_filter(tt(depth_mm), 20.0, 6),
        metricise=port_pp.metricise_depth(r["bilateral"], 3.0),
        metricise_every_mm=port_pp.metricise_depth(tt(EVERY_MM), 20.0),
        vmap=port_pp.compute_vmap(r["metricise"], port_cam, 20.0),
        nmap=port_pp.compute_nmap(r["vmap"]),
        pyr_down_depth=port_pyr.pyr_down_depth(r["metricise"]),
        vertices_to_depth=port_pp.vertices_to_depth(r["vmap"], 2.2),
        pyr_down_gauss=port_pyr.pyr_down_gauss(r["vertices_to_depth"]),
        intensity=port_pp.rgb_to_intensity(tt(rgb)),
        pyr_down_intensity=port_pyr.pyr_down_intensity(r["intensity"]),
        resize_vmap=port_pp.resize_vmap(r["vmap"]),
        resize_nmap=port_pp.resize_nmap(r["nmap"]),
        deriv_x=dx, deriv_y=dy,
    )


# name -> (atol, share of pixels allowed outside it, why)
TOLERANCE = {
    # whole millimetres after a round(): a 169-tap float32 sum that lands within
    # rounding of x.5 may round the other way
    "bilateral": (1e-3, 1e-3, "1 mm flips at <0.1 % of pixels"),
    # the reference's compiler turns the division by 1000 into a
    # multiplication by the float32 reciprocal, and so does the port
    "metricise": (0.0, 0.0, "bit-identical"),
    "metricise_every_mm": (0.0, 0.0, "bit-identical at every uint16 depth"),
    "vmap": (1e-6, 0.0, "two multiplications"),
    "nmap": (1e-5, 0.0, "normalised cross product"),
    "pyr_down_depth": (1e-6, 1e-3, "25-tap weighted mean; a tap at the 3-sigma gate may flip"),
    "vertices_to_depth": (0.0, 0.0, "a select"),
    "pyr_down_gauss": (1e-6, 0.0, "25-tap weighted mean"),
    # floor() of a 3-term float32 sum: a sum within rounding of an integer
    # may land on the other side
    "intensity": (1e-6, 2e-3, "1 grey level at <0.2 % of pixels"),
    "pyr_down_intensity": (1e-4, 0.0, "25-tap weighted mean of 0..255 values"),
    "resize_vmap": (1e-6, 0.0, "4-term mean"),
    "resize_nmap": (1e-5, 0.0, "4-term mean, normalised"),
    # trunc() of an 8-tap sum of 0..255 values times 0.5..0.8
    "deriv_x": (1e-6, 2e-3, "1 unit at <0.2 % of pixels"),
    "deriv_y": (1e-6, 2e-3, "1 unit at <0.2 % of pixels"),
}


@pytest.mark.parametrize("name", sorted(TOLERANCE))
def test_preprocess_stage_matches_reference(name, ref_out, port_out):
    atol, share, _why = TOLERANCE[name]
    ref, got = ref_out[name], nn(port_out[name])
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(ref).max() > 0, "stage produced nothing"
    bad = np.abs(got - ref) > atol
    assert bad.mean() <= share, f"{name}: {bad.mean() * 100:.3f}% beyond {atol}"
    if share > 0:       # the stragglers are single quantisation steps
        step = {"bilateral": 1.0, "intensity": 1.0, "deriv_x": 1.0, "deriv_y": 1.0,
                "pyr_down_depth": 0.1}[name]
        assert np.abs(got - ref).max() <= step + atol


@pytest.mark.parametrize("radius", [6, 3])
def test_bilateral_filter_on_the_cpu_is_its_plain_version(frame, radius, kernel_calls):
    """The wrapper takes the plain version for a CPU tensor, bit for bit,
    and reaches no kernel."""
    depth = tt(frame[2])
    got = port_bf.bilateral_filter(depth, 20.0, radius)
    assert torch.equal(got, port_bf.bilateral_filter_plain(depth, 20.0, radius))
    assert kernel_calls == []


def test_borders_are_zero_filled_shifts():
    """Taps outside the image read zero and are masked out of the weights:
    neither wrap-around nor replicate padding."""
    img = np.zeros((8, 10), np.float32)
    img[:, -1] = 100.0                      # bright last column
    got = nn(port_pp.shift2d(tt(img), 0, 1))
    assert got[:, -1].max() == 0.0 and got[:, -2].min() == 100.0
    assert nn(port_pp.shift2d(tt(img), 0, -1))[:, 0].max() == 0.0     # no wrap
    flat = np.full((8, 10), 50.0, np.float32)
    down = nn(port_pyr.pyr_down_intensity(tt(flat)))
    np.testing.assert_allclose(down, 50.0, rtol=1e-6)   # masked weights renormalise


PYRAMID_STENCILS = ("pyr_down_depth", "pyr_down_gauss", "pyr_down_intensity",
                    "compute_derivatives")


def _pyramid_image(name, shape, kind):
    """A depth image in metres with holes and jumps of 0.2 and 1.5 m (beyond
    the depth pyrDown's 3-sigma gate of 0.09 m), or its 0..255 intensity
    stand-in for the intensity stencils; or all zeros."""
    H, W = shape
    if kind == "zeros":
        return torch.zeros(shape)
    rng = np.random.default_rng(H * 1000 + W)
    depth = (1.0 + 0.5 * np.arange(W)[None, :] / W
             + 0.01 * rng.standard_normal((H, W))).astype(np.float32)
    depth[:, W // 2:] += 0.2
    depth[H // 2:, W // 3:] += 1.5
    depth[rng.random((H, W)) < 0.1] = 0.0
    if name in ("pyr_down_intensity", "compute_derivatives"):
        depth = np.floor(depth * 80.0)
    return tt(depth)


@pytest.mark.parametrize("kind", ["depth jumps", "zeros"])
@pytest.mark.parametrize("shape", [(480, 640), (240, 320), (120, 160), (15, 20), (61, 81)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("name", PYRAMID_STENCILS)
def test_pyramid_stencil_on_the_cpu_is_its_plain_version(name, shape, kind, kernel_calls):
    """Each pyramid stencil takes its plain version for a CPU tensor, bit for
    bit, and reaches no kernel: at every level's size of a 640x480 frame, at
    odd sizes, across depth jumps and on an all-zero image."""
    img = _pyramid_image(name, shape, kind)
    fn = getattr(port_pyr, name)
    got, plain = fn(img), getattr(port_pyr, name + "_plain")(img)
    if name != "compute_derivatives":
        got, plain = (got,), (plain,)
        assert got[0].shape == (shape[0] // 2, shape[1] // 2)
    for g, p in zip(got, plain):
        assert g.dtype == torch.float32
        assert torch.equal(g.view(torch.int32), p.view(torch.int32))
    assert kernel_calls == []
    if kind != "zeros":     # the images exercise the stencils
        assert float(plain[0].abs().max()) > 0


@pytest.mark.parametrize("name", PYRAMID_STENCILS)
def test_pyramid_stencils_want_one_image(name):
    """A batch of images, or one with channels, raises instead of being read
    as one image."""
    with pytest.raises(ValueError, match=r"wants \[H,W\]"):
        getattr(port_pyr, name)(torch.zeros((2, 12, 16)))
