"""The port's voxel grid, PCD I/O and cloud path against brute force and the
JAX package (tests/test_cloud.py case by case).

The port's voxel keys multiply by the float32 reciprocal of the leaf, as
the JAX function does under ``jit`` (its ``PointCloudGenerator`` is
jitted), so voxels are held to the jitted JAX function. Voxel counts and
the voxel order are exact; centroids are held at atol
1e-3 and colours at 1e-2, since the order of a segment's float additions
differs. The cloud's disparity is bitwise equal to the jnp matcher's, its
voxel count exact."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from stereo_depth_ruler_tpu.calib.config import StereoRig as JaxRig
from stereo_depth_ruler_tpu.cloud import CloudConfig as JaxCloudConfig
from stereo_depth_ruler_tpu.cloud import PointCloudGenerator as JaxGenerator
from stereo_depth_ruler_tpu.io.synthetic import make_scene, render_stereo_pair
from stereo_depth_ruler_tpu.ops.sgbm_ref import SGBMParams as JaxParams
from stereo_depth_ruler_tpu.ops.voxel import voxel_downsample as jax_voxel
from stereo_depth_ruler_tpu_torch import SGBMParams, StereoRig
from stereo_depth_ruler_tpu_torch.cloud import CloudConfig, PointCloudGenerator
from stereo_depth_ruler_tpu_torch.io.pcd import (pack_rgb, read_pcd,
                                                 unpack_rgb, write_pcd)
from stereo_depth_ruler_tpu_torch.ops.voxel import voxel_downsample

ATOL_XYZ, ATOL_RGB = 1e-3, 1e-2
jax_voxel_jit = jax.jit(jax_voxel, static_argnums=2)


def keys_of(xyz, leaf):
    """floor(p * (1 / leaf)) in float32, the voxel key both packages use."""
    return np.floor(xyz * (np.float32(1) / np.float32(leaf)))


def brute_voxel(xyz, rgb, leaf):
    vox = {}
    for p, c in zip(xyz, rgb):
        if not np.isfinite(p).all():
            continue
        key = tuple(keys_of(p, leaf).astype(int))
        vox.setdefault(key, []).append((p, c))
    pts = np.array([np.mean([p for p, _ in v], axis=0)
                    for v in vox.values()])
    cols = np.array([np.mean([c for _, c in v], axis=0)
                     for v in vox.values()])
    return pts, cols


def both(xyz, rgb, leaf):
    """(port, jitted JAX) voxel_downsample on the same numpy inputs, as
    numpy."""
    got = voxel_downsample(torch.from_numpy(xyz),
                           None if rgb is None else torch.from_numpy(rgb),
                           leaf)
    want = jax_voxel_jit(xyz, rgb, leaf)
    return ([g.numpy() for g in got[:2]] + [int(got[2])],
            [np.asarray(w) for w in want[:2]] + [int(want[2])])


def assert_same_voxels(got, want):
    """Count exact; centroids in the same order (the voxel order)."""
    (gp, gc, gn), (wp, wc, wn) = got, want
    assert gn == wn
    np.testing.assert_allclose(gp[:gn], wp[:wn], atol=ATOL_XYZ)
    np.testing.assert_allclose(gc[:gn], wc[:wn], atol=ATOL_RGB)
    np.testing.assert_array_equal(gp[gn:], 0)


def test_voxel_vs_brute_force_and_jax():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-100, 100, (500, 3)).astype(np.float32)
    xyz[::50] = np.inf          # some invalid points
    xyz[7::50, 1] = np.nan
    rgb = rng.uniform(0, 255, (500, 3)).astype(np.float32)
    got, want = both(xyz, rgb, 25.0)
    assert_same_voxels(got, want)
    pts, cols, count = got
    bp, bc = brute_voxel(xyz, rgb, 25.0)
    assert count == len(bp)
    oi = np.lexsort(pts[:count].T)
    bi = np.lexsort(bp.T)
    np.testing.assert_allclose(pts[:count][oi], bp[bi], atol=ATOL_XYZ)
    np.testing.assert_allclose(cols[:count][oi], bc[bi], atol=ATOL_RGB)
    # the voxel order is the lexicographic order of (kx, ky, kz)
    keys = keys_of(pts[:count], 25.0).astype(np.int64)
    assert (np.lexsort(keys[:, ::-1].T) == np.arange(count)).all()


def test_voxel_leaf_quirk_is_identity():
    """leaf=0.005 on mm-unit data: every point its own voxel (the
    reference quirk, SURVEY.md §2.7)."""
    rng = np.random.default_rng(1)
    xyz = rng.uniform(0, 500, (200, 3)).astype(np.float32)
    got, want = both(xyz, None, 0.005)
    assert got[2] == 200
    assert_same_voxels(got, want)
    np.testing.assert_array_equal(got[1], 0)


def test_voxel_edge_keys_by_reciprocal():
    """Points where floor(x / leaf) and floor(x * (1 / leaf)) differ in
    float32: the port keys them by the product, as the jitted JAX function
    does, and not as the JAX function run op by op (a true division)."""
    leaf = np.float32(3.0)
    x = np.array([776.99994, 857.99994, 989.99994], np.float32)
    assert (np.floor(x / leaf) + 1 == keys_of(x, leaf)).all()
    # each edge point beside a point well inside its product's voxel
    inside = keys_of(x, leaf) * leaf + np.float32(0.5)
    xyz = np.zeros((2 * len(x), 3), np.float32)
    xyz[:, 0] = np.concatenate([x, inside])
    got, want = both(xyz, None, float(leaf))
    assert got[2] == want[2] == len(x)
    assert_same_voxels(got, want)
    np.testing.assert_array_equal(keys_of(got[0][:got[2], 0], leaf),
                                  keys_of(x, leaf))
    # op by op the JAX function divides and keeps each pair apart
    assert int(jax_voxel(xyz, None, leaf=float(leaf))[2]) == 2 * len(x)


def test_rgb_packing_roundtrip():
    rgb = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [12, 34, 56]],
                   np.uint8)
    np.testing.assert_array_equal(unpack_rgb(pack_rgb(rgb)), rgb)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("organized", [True, False])
def test_pcd_roundtrip(tmp_path, binary, organized):
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-10, 10, (64, 3)).astype(np.float32)
    xyz[5] = np.nan
    rgb = rng.integers(0, 256, (64, 3)).astype(np.uint8)
    p = write_pcd(tmp_path / "t.pcd", xyz, rgb, binary=binary,
                  organized_shape=(8, 8) if organized else None)
    x2, c2, shape = read_pcd(p)
    assert shape == ((8, 8) if organized else (1, 64))
    np.testing.assert_allclose(x2, xyz, atol=1e-4)
    np.testing.assert_array_equal(c2, rgb)


def test_pcd_readable_header(tmp_path):
    p = write_pcd(tmp_path / "h.pcd", np.zeros((3, 3), np.float32))
    head = p.read_bytes()[:200].decode(errors="replace")
    assert "VERSION 0.7" in head and "FIELDS x y z" in head
    assert "POINTS 3" in head and "DATA binary" in head


PARAMS = dict(num_disparities=16, block_size=5, speckle_window_size=20,
              speckle_range=2)
RIG = dict(width=96, height=64, focal=80.0, baseline_mm=50.0)


@pytest.fixture(scope="module")
def scene_pair():
    scene = make_scene(JaxRig.synthetic(**RIG), n_boxes=2,
                       z_range_mm=(300.0, 600.0), background_z_mm=1000.0,
                       seed=4)
    return render_stereo_pair(scene, seed=4)


def generators(leaf=5.0, **kw):
    jg = JaxGenerator(JaxRig.synthetic(**RIG), JaxCloudConfig(
        sgbm=JaxParams(**PARAMS), leaf=leaf, matcher="jnp", **kw))
    tg = PointCloudGenerator(StereoRig.synthetic(**RIG), CloudConfig(
        sgbm=SGBMParams(**PARAMS), leaf=leaf, **kw), device="cpu")
    return jg, tg


@pytest.mark.parametrize("leaf", [5.0, 20.0])
def test_cloud_from_pair_matches_jax(scene_pair, leaf):
    left, right, _ = scene_pair
    rng = np.random.default_rng(5)
    color = rng.integers(0, 256, left.shape + (3,)).astype(np.uint8)
    jg, tg = generators(leaf=leaf, organized=True)
    want = jg.cloud_from_pair(left, right, color)
    got = tg.cloud_from_pair(left, right, color)
    np.testing.assert_array_equal(got["disparity"], want["disparity"])
    assert got["count"] == want["count"] > 100
    np.testing.assert_allclose(got["points"], want["points"], atol=ATOL_XYZ)
    assert np.abs(got["colors"].astype(int)
                  - want["colors"].astype(int)).max() <= 1
    np.testing.assert_array_equal(got["organized_colors"],
                                  want["organized_colors"])
    assert got["organized_shape"] == tuple(want["organized_shape"])
    wo = np.asarray(want["organized_points"])
    np.testing.assert_array_equal(np.isnan(got["organized_points"]),
                                  np.isnan(wo))
    fin = np.isfinite(wo)
    np.testing.assert_allclose(got["organized_points"][fin], wo[fin],
                               rtol=1e-5)


def test_cloud_edge_points_match_jitted_jax(scene_pair):
    """At a 2.4 mm leaf some of the scene's kept points lie on a voxel
    edge, where the float32 product and the true division disagree: the
    port's cloud keeps the jitted JAX cloud's voxels there."""
    left, right, _ = scene_pair
    jg, tg = generators(leaf=2.4, organized=True)
    want = jg.cloud_from_pair(left, right)
    got = tg.cloud_from_pair(left, right)
    pts = np.asarray(want["organized_points"])
    pts = pts[np.isfinite(pts).all(axis=1)]
    assert (np.floor(pts / np.float32(2.4)) != keys_of(pts, 2.4)).any()
    np.testing.assert_array_equal(got["disparity"], want["disparity"])
    assert got["count"] == want["count"]
    np.testing.assert_allclose(got["points"], want["points"], atol=ATOL_XYZ)
    # keyed by a true division, the same points give other voxels
    div_pts, _, div_count = jax_voxel(pts, None, leaf=2.4)
    div_pts = np.asarray(div_pts)[:int(div_count)]
    assert (int(div_count) != got["count"]
            or np.abs(div_pts - got["points"]).max() > 0.1)


def test_cloud_pipeline_geometry(tmp_path, scene_pair):
    """Points from a synthetic scene land at the right metric depths, and
    write_frame's file holds the cloud."""
    left, right, gt = scene_pair
    _, tg = generators()
    out = tg.cloud_from_pair(left, right)
    assert out["count"] > 300
    z = out["points"][:, 2]
    assert (z > 150).all() and (z < 2000).all()
    path = tg.write_frame(tmp_path, 100, left, right)
    assert path.name == "frame_00100.pcd"
    xyz2, rgb2, _ = read_pcd(path)
    assert len(xyz2) == out["count"]
    np.testing.assert_allclose(xyz2, out["points"], atol=1e-4)


def test_process_sbs_video_matches_jax(tmp_path, scene_pair):
    """Both packages' process_sbs_video on the same BGR side-by-side frame
    write the same cloud."""
    left, right, _ = scene_pair
    bgr = np.stack([np.concatenate([left, right], axis=1)] * 3, axis=-1)
    bgr = bgr.astype(np.float32)
    bgr[..., 0] *= 0.5
    bgr[..., 2] = 255 - bgr[..., 2]
    frames = bgr.astype(np.uint8)[None]
    jg, tg = generators()
    (jp,) = jg.process_sbs_video(frames, tmp_path / "jax")
    (tp_,) = tg.process_sbs_video(frames, tmp_path / "torch")
    assert jp.name == tp_.name == "frame_00000.pcd"
    jx, jc, js = read_pcd(jp)
    tx, tc, ts = read_pcd(tp_)
    assert js == ts and len(jx) == len(tx)
    np.testing.assert_allclose(tx, jx, atol=ATOL_XYZ)
    assert np.abs(tc.astype(int) - jc.astype(int)).max() <= 1


def test_process_sbs_video_uses_bgr_gray_weights(tmp_path, monkeypatch):
    """The cloud path's grayscale uses the OpenCV BGR weights
    (pcd_write.cpp:87-89 calls cvtColor), not a channel mean."""
    from stereo_depth_ruler_tpu.pipeline import bgr_to_gray

    gen = PointCloudGenerator(StereoRig.synthetic(width=64, height=32),
                              CloudConfig(sgbm=SGBMParams(
                                  num_disparities=16, block_size=3),
                                  leaf=0.0), device="cpu")
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 255, (1, 32, 128, 3)).astype(np.uint8)

    captured = {}

    def spy_write_frame(out_dir, idx, gray, gray_r, color_l=None):
        captured["gray"] = np.asarray(gray)
        captured["color"] = color_l
        return tmp_path / "f.pcd"

    monkeypatch.setattr(gen, "write_frame", spy_write_frame)
    gen.process_sbs_video(frames, tmp_path, target_frames=[0])
    expect = np.asarray(bgr_to_gray(frames[0].astype(np.float32)))[:, :64]
    np.testing.assert_allclose(captured["gray"], expect, rtol=1e-6)
    assert not np.allclose(captured["gray"],
                           frames[0, :, :64].mean(axis=2), atol=0.5)
    np.testing.assert_array_equal(captured["color"], frames[0, :, :64])


def test_cloud_config_fields_match_jax():
    mine = {f.name: f.default for f in dataclasses.fields(CloudConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxCloudConfig)}
    assert mine.keys() == ref.keys()
    for k in ref:
        if k == "sgbm":
            assert dataclasses.asdict(mine[k]) == dataclasses.asdict(ref[k])
        else:
            assert mine[k] == ref[k], k


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PointCloudGenerator(StereoRig.synthetic(width=32, height=24))


@pytest.mark.parametrize("matcher", ["pallas", "jnp"])
def test_cloud_config_other_matcher_raises(matcher):
    """The port's matcher follows the device: a CloudConfig that names one
    of the JAX package's matchers is refused, not ignored."""
    with pytest.raises(ValueError, match="matcher must be 'auto'"):
        PointCloudGenerator(StereoRig.synthetic(width=32, height=24),
                            CloudConfig(matcher=matcher), device="cpu")
