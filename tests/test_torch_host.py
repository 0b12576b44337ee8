"""The port's host modules against the JAX package: the ruler
(tests/test_measure.py), the metrics records, the viewer with a fake cv2
(tests/test_viewer.py), video I/O and the per-process segments (the video
half of tests/test_multihost.py), capture and the epipolar overlay
(tests/test_pipeline.py), calibration geometry, and the native host
runtime (tests/test_native.py, skipped where its library is not built)."""

import json
import sys

import numpy as np
import pytest
import torch

from stereo_depth_ruler_tpu import measure as jmeasure
from stereo_depth_ruler_tpu import metrics as jmetrics
from stereo_depth_ruler_tpu import viz as jviz
from stereo_depth_ruler_tpu.calib import calibrate as jcal
from stereo_depth_ruler_tpu.io import video as jvideo
from stereo_depth_ruler_tpu_torch import SGBMParams, StereoRig
from stereo_depth_ruler_tpu_torch import viewer as viewer_mod
from stereo_depth_ruler_tpu_torch.calib import calibrate as tcal
from stereo_depth_ruler_tpu_torch.io import video
from stereo_depth_ruler_tpu_torch.io.pcd import read_pcd
from stereo_depth_ruler_tpu_torch.io.synthetic import (make_scene,
                                                       render_stereo_pair)
from stereo_depth_ruler_tpu_torch.measure import (MeasurementSession,
                                                  depth_coverage,
                                                  measure_distance)
from stereo_depth_ruler_tpu_torch.metrics import (FrameMetrics, MetricsLog,
                                                  frame_metrics)
from stereo_depth_ruler_tpu_torch.utils import capture, native
from stereo_depth_ruler_tpu_torch.viz import (DepthVis, DisparityVis,
                                              draw_epipolar_lines,
                                              overlay_heat)


def _flat_xyz(h=40, w=60, z=1000.0, f=100.0):
    """XYZ for a flat plane at depth z with pinhole (f, cx=w/2, cy=h/2)."""
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    X = (xs - w / 2) * z / f
    Y = (ys - h / 2) * z / f
    Z = np.full_like(X, z)
    return np.stack([X, Y, Z], axis=-1).astype(np.float32)


# -- the ruler (tests/test_measure.py) ------------------------------------

def test_measure_distance_euclidean():
    xyz = _flat_xyz()
    d = measure_distance(xyz, (10, 10), (40, 10))
    assert d == pytest.approx(1000.0 / 100.0 * 30.0)
    assert d == jmeasure.measure_distance(xyz, (10, 10), (40, 10))


def test_reference_measurement_semantics():
    """dist = ||xyz1-xyz2||, printed /10 as cm (stereo_displayer.cpp:47-57)."""
    xyz = np.zeros((4, 4, 3), np.float32)
    xyz[1, 1] = [0.0, 0.0, 2400.0]
    xyz[2, 2] = [10.0, 10.0, 2400.29]
    rec = MeasurementSession().measure((1, 1), (2, 2), xyz)
    expect_mm = np.linalg.norm([10.0, 10.0, 0.29])
    assert rec.distance_mm == pytest.approx(expect_mm, rel=1e-6)
    assert rec.distance_cm == pytest.approx(expect_mm / 10.0, rel=1e-6)


def test_session_click_pairs_and_csv_match_jax(tmp_path):
    """The same clicks give the JAX session's CSV, byte for byte."""
    xyz = _flat_xyz()
    texts = []
    for mod, name in ((sys.modules[MeasurementSession.__module__], "t"),
                      (jmeasure, "j")):
        csv = tmp_path / f"{name}.csv"
        s = mod.MeasurementSession(csv)
        assert s.click(5, 5, xyz) is None
        rec = s.click(25, 5, xyz)
        assert rec is not None
        s.new_session()
        s.measure((1, 1), (2, 2), xyz)
        s.save_csv()
        texts.append(csv.read_text())
    assert texts[0] == texts[1]
    assert texts[0].startswith("Image, First_point,   Second_point, Distance")
    recs = MeasurementSession.load_csv(tmp_path / "t.csv")
    assert [r.image_index for r in recs] == [0, 1]
    assert recs[0].distance_cm == pytest.approx(20.0, abs=1e-4)
    with pytest.raises(ValueError):
        MeasurementSession().click(60, 0, xyz)


def test_session_reset_truncates(tmp_path):
    csv = tmp_path / "m.csv"
    s = MeasurementSession(csv)
    s.measure((1, 1), (2, 2), _flat_xyz())
    s.save_csv()
    assert csv.stat().st_size > 0
    s.reset()
    assert csv.stat().st_size == 0
    assert not s.records


def test_invalid_point_nan():
    xyz = _flat_xyz()
    xyz[3, 3] = np.inf
    assert np.isnan(measure_distance(xyz, (3, 3), (10, 10)))


def test_depth_coverage_quirk():
    """Numerator counts only cols >= skip, denominator ALL pixels
    (stereo_displayer.cpp:105-118)."""
    z = np.full((10, 100), 500.0)
    assert depth_coverage(z, skip_cols=20) == pytest.approx(0.8)
    z[:, 50:] = np.inf
    assert depth_coverage(z, skip_cols=20) == pytest.approx(0.3)
    assert depth_coverage(z, 20) == jmeasure.depth_coverage(z, 20)


def test_frame_metrics_log_and_timer_match_jax(tmp_path):
    disp = np.array([[1.0, -1.0], [2.0, 3.0]], np.float32)
    z = np.array([[100.0, np.inf], [200.0, 300.0]])
    m = frame_metrics(0, disp, z, ref_disp=disp + 0.5, wall_ms=4.0)
    assert m.valid_disparity_frac == pytest.approx(0.75)
    assert m.disparity_mae_vs_ref == pytest.approx(0.5)
    jm = jmetrics.frame_metrics(0, disp, z, ref_disp=disp + 0.5, wall_ms=4.0)
    assert m.to_json() == jm.to_json()
    log, jlog = MetricsLog(tmp_path / "m.jsonl"), jmetrics.MetricsLog()
    for rec, jrec in ((m, jm), (FrameMetrics(1, 0.5, 0.25, 900.0),
                                jmetrics.FrameMetrics(1, 0.5, 0.25, 900.0))):
        log.append(rec)
        jlog.append(jrec)
    assert log.summary() == jlog.summary()
    assert log.summary()["frames"] == 2
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert json.loads(lines[0]) == json.loads(jm.to_json())


def test_measurement_on_synthetic_scene_ground_truth():
    """Two points with known ground-truth 3D positions, through the port's
    matcher (plain versions) and reprojection."""
    from stereo_depth_ruler_tpu_torch.ops.reproject import reproject_to_3d
    from stereo_depth_ruler_tpu_torch.ops.sgbm_cuda import sgbm_cuda

    rig = StereoRig.synthetic(width=256, height=160, focal=240.0,
                              baseline_mm=80.0)
    scene = make_scene(rig, n_boxes=3, z_range_mm=(600.0, 1600.0),
                       background_z_mm=3000.0, seed=5)
    left, right, gt = render_stereo_pair(scene, seed=5)
    disp = sgbm_cuda(torch.tensor(np.float32(left[None])),
                     torch.tensor(np.float32(right[None])),
                     SGBMParams(num_disparities=48, speckle_window_size=50))
    xyz = reproject_to_3d(disp[0], rig.Q).numpy()
    p1, p2 = (200, 10), (240, 20)

    def gt_xyz(p):
        z = 240.0 * 80.0 / gt[p[1], p[0]]
        return np.array([(p[0] - (-rig.Q[0, 3])) * z / 240.0,
                         (p[1] - (-rig.Q[1, 3])) * z / 240.0, z])

    truth = np.linalg.norm(gt_xyz(p1) - gt_xyz(p2))
    rec = MeasurementSession().measure(p1, p2, xyz)
    assert rec.distance_mm == pytest.approx(truth, rel=0.02)


# -- visualization and the viewer (tests/test_viewer.py) -------------------

def test_viz_matches_jax():
    rng = np.random.default_rng(0)
    disp = rng.uniform(-1, 48, (2, 24, 32)).astype(np.float32)
    z = rng.uniform(0, 12000, (2, 24, 32)).astype(np.float32)
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    dv, jdv, zv, jzv = (DisparityVis(48), jviz.DisparityVis(48), DepthVis(),
                        jviz.DepthVis())
    for k in range(2):   # the second frame runs the temporal EMA
        a, b = dv(disp[k]), jdv(disp[k])
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(zv(z[k]), jzv(z[k]))
        np.testing.assert_array_equal(overlay_heat(img, a),
                                      jviz.overlay_heat(img, b))


def test_available_degrades_headless():
    assert viewer_mod.available() in (True, False)


class _FakeCV2:
    """Minimal cv2 surface InteractiveViewer touches; records calls and
    feeds a scripted key sequence."""

    EVENT_LBUTTONDOWN = 1
    EVENT_FLAG_SHIFTKEY = 16

    def __init__(self, keys):
        self.keys = list(keys)
        self.shown = []
        self.callbacks = {}

    def imshow(self, win, img):
        self.shown.append((win, np.asarray(img).shape))

    def waitKey(self, ms):
        return self.keys.pop(0) if self.keys else 255

    def setMouseCallback(self, win, cb, param):
        self.callbacks[win] = (cb, param)

    def circle(self, img, c, r, color, thick):
        pass

    def line(self, img, p1, p2, color, thick):
        pass

    def destroyWindow(self, win):
        pass

    def destroyAllWindows(self):
        pass


def _make_viewer(keys, csv_path=None):
    v = viewer_mod.InteractiveViewer.__new__(viewer_mod.InteractiveViewer)
    fake = _FakeCV2(keys)
    v.cv2 = fake
    v.dvis = DisparityVis(48)
    v.zvis = DepthVis()
    v.session = MeasurementSession(csv_path)
    v.num_disp = 48
    v.verbose = False
    v._clicks = []
    v._quit = False
    return v, fake


def _frame(h=48, w=64):
    rng = np.random.default_rng(0)
    left = rng.uniform(0, 255, (h, w)).astype(np.float32)
    disp = np.full((h, w), 12.0, np.float32)
    xyz = np.dstack([np.zeros((h, w)), np.zeros((h, w)),
                     np.full((h, w), 1500.0)]).astype(np.float32)
    return left, disp, xyz


def test_show_frame_plays_and_quits():
    left, disp, xyz = _frame()
    v, fake = _make_viewer(keys=[255, 27])        # no key, then ESC
    assert v.show_frame(left, disp, xyz) is True
    assert v.show_frame(left, disp, xyz) is False  # ESC -> quit
    assert len(fake.shown) == 6                    # 3 windows x 2 frames


def test_freeze_measure_flow(tmp_path):
    """'f' freezes, Shift+clicks measure, 's' saves CSV, 'f' resumes."""
    left, disp, xyz = _frame()
    csv = tmp_path / "m.csv"
    v, fake = _make_viewer(keys=[ord("f"), 255, ord("s"), ord("f")],
                           csv_path=csv)
    orig_measure_loop = v._measure_loop

    def wrapped(overlay, xyz_arr):
        # inject two Shift+clicks through the installed mouse callback
        def set_cb(win, cb, param):
            fake.callbacks[win] = (cb, param)
            cb(fake.EVENT_LBUTTONDOWN, 10, 10, fake.EVENT_FLAG_SHIFTKEY,
               param)
            cb(fake.EVENT_LBUTTONDOWN, 30, 20, fake.EVENT_FLAG_SHIFTKEY,
               param)
        fake.setMouseCallback = set_cb
        return orig_measure_loop(overlay, xyz_arr)

    v._measure_loop = wrapped
    assert v.show_frame(left, disp, xyz) is True
    assert len(v.session.records) == 1
    text = csv.read_text()
    assert "First_point" in text and "Distance" in text


def test_measure_loop_esc_quits():
    left, disp, xyz = _frame()
    v, fake = _make_viewer(keys=[ord("f"), 27])    # freeze then ESC
    assert v.show_frame(left, disp, xyz) is False


# -- video I/O and per-process segments (tests/test_multihost.py) ----------

@pytest.mark.parametrize("channels", [1, 3])
def test_sbsv_roundtrip_and_convert_match_jax(tmp_path, channels):
    rng = np.random.default_rng(3)
    shape = (5, 8, 24) + ((3,) if channels == 3 else ())
    frames = rng.integers(0, 256, shape, dtype=np.uint8)
    video.write_sbsv(tmp_path / "t.sbsv", frames)
    jvideo.write_sbsv(tmp_path / "j.sbsv", frames)
    assert ((tmp_path / "t.sbsv").read_bytes()
            == (tmp_path / "j.sbsv").read_bytes())
    np.testing.assert_array_equal(video.read_sbsv(tmp_path / "t.sbsv", 1, 3),
                                  frames[1:4])
    src = video.VideoSource(tmp_path / "t.sbsv")
    jsrc = jvideo.VideoSource(tmp_path / "t.sbsv")
    assert len(src) == 5
    for (ti, tl, tr), (ji, jl, jr) in zip(src.batches(2), jsrc.batches(2)):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tr, jr)
        assert tl.dtype == jl.dtype == (np.uint8 if channels == 1
                                        else np.float32)


def test_host_segment_partition():
    for n, pc, batch in [(100, 4, 8), (7, 3, 2), (16, 2, 4), (5, 8, 4)]:
        covered = []
        for pi in range(pc):
            s, e = video.host_segment(n, pi, pc, batch=batch)
            assert (s, e) == jvideo.host_segment(n, pi, pc, batch=batch)
            assert 0 <= s <= e <= n
            if s < e < n:
                assert (e - s) % batch == 0
            covered.extend(range(s, e))
        assert covered == list(range(n)), (n, pc, batch)


def test_host_batches_only_yields_own_segment():
    n, h, w = 11, 8, 12
    frames = (np.arange(n)[:, None, None]
              * np.ones((h, 2 * w))).astype(np.uint8)
    seen = []
    for pi in range(3):
        src = video.VideoSource(frames, gray=False)
        for idxs, lefts, rights in video.host_batches(
                src, 2, process_index=pi, process_count=3):
            for k, fi in enumerate(idxs):
                if fi < 0:
                    continue
                assert lefts[k].shape == (h, w)
                assert float(lefts[k][0, 0]) == float(fi)
                seen.append(int(fi))
    assert sorted(seen) == list(range(n))


def test_host_batches_default_asks_torch_distributed(monkeypatch):
    """Without a process group a process is 0 of 1; with one, its rank of
    the world size."""
    import torch.distributed as dist
    frames = (np.arange(10)[:, None, None] * np.ones((4, 8))).astype(np.uint8)

    def frames_seen():
        return [int(i) for idxs, _, _ in video.host_batches(
            video.VideoSource(frames, gray=False), 2) for i in idxs if i >= 0]

    assert frames_seen() == list(range(10))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    assert frames_seen() == list(range(6, 10))


def test_host_batches_cursor_resume():
    """At-least-once resume: a job killed mid-batch re-processes that
    batch."""
    n = 8
    frames = (np.arange(n)[:, None, None] * np.ones((4, 8))).astype(np.uint8)
    cur = video.FrameCursor(source="<array>")
    it = video.host_batches(video.VideoSource(frames, gray=False), 2,
                            process_index=0, process_count=1, cursor=cur)
    next(it)
    next(it)
    it.close()
    assert cur.next_frame == 2
    got = []
    for idxs, _, _ in video.host_batches(
            video.VideoSource(frames, gray=False), 2, process_index=0,
            process_count=1, cursor=cur):
        got.extend(int(i) for i in idxs if i >= 0)
    assert got == list(range(2, n))


def test_replan_segments_covers_unfinished_exactly_once():
    n_frames, n_hosts, batch = 103, 4, 4
    cursors = {}
    for h in range(n_hosts):
        s, e = video.host_segment(n_frames, h, n_hosts, batch=batch)
        cursors[h] = {0: e, 1: s + 9, 2: s + 4, 3: s}[h]
    plan = video.replan_segments(n_frames, cursors, surviving=[0, 2],
                                 batch=batch)
    assert plan == jvideo.replan_segments(n_frames, cursors,
                                          surviving=[0, 2], batch=batch)
    covered = [f for iv in plan.values() for a, b in iv for f in range(a, b)]
    expected = []
    for h in range(n_hosts):
        s, e = video.host_segment(n_frames, h, n_hosts, batch=batch)
        expected.extend(range(min(max(cursors[h], s), e), e))
    assert sorted(covered) == sorted(expected)
    assert len(covered) == len(set(covered))
    assert plan == video.replan_segments(n_frames, cursors, surviving=[2, 0],
                                         batch=batch)


@pytest.mark.parametrize("cursors,survivor,expect", [
    ({0: 8, 1: 14}, 0, list(range(8, 12)) + list(range(14, 24))),
    # a survivor that inherits an interval below its own cursor
    ({0: 2, 1: 14}, 1, list(range(2, 12)) + list(range(14, 24))),
])
def test_recovered_batches_processes_plan(tmp_path, cursors, survivor,
                                          expect):
    n_frames = 24
    frames = np.stack([np.full((8, 16), i, np.uint8)
                       for i in range(n_frames)])
    src = video.VideoSource(frames, gray=False)
    plan = video.replan_segments(n_frames, cursors, surviving=[survivor],
                                 batch=2)
    assert plan[survivor] == sorted(plan[survivor])
    cur = video.FrameCursor(source="x")
    seen = [int(i) for idxs, _, _ in video.recovered_batches(
        src, 2, plan[survivor], cursor=cur) for i in idxs if i >= 0]
    assert sorted(seen) == expect
    assert len(seen) == len(set(seen))
    assert cur.next_frame == 24


def test_frame_cursor_roundtrip(tmp_path):
    cur = video.FrameCursor(source="v.sbsv", next_frame=7, total_frames=9)
    cur.save(tmp_path / "c.json")
    assert video.FrameCursor.load(tmp_path / "c.json") == cur
    assert ((tmp_path / "c.json").read_text()
            == json.dumps({"source": "v.sbsv", "next_frame": 7,
                           "total_frames": 9}))


# -- capture, epipolar overlay, calibration geometry -----------------------

@pytest.fixture(scope="module")
def small_pair():
    rig = StereoRig.synthetic(width=128, height=96, focal=120.0,
                              baseline_mm=60.0)
    scene = make_scene(rig, n_boxes=3, z_range_mm=(300.0, 900.0),
                       background_z_mm=1500.0, seed=3)
    return rig, render_stereo_pair(scene, seed=3)


def test_capture_utils(tmp_path, small_pair):
    """split, change_filename, image_disparity (helper.cpp equivalents);
    image_disparity bitwise equal to the JAX package's."""
    from stereo_depth_ruler_tpu.ops.sgbm_ref import SGBMParams as JaxParams
    from stereo_depth_ruler_tpu.utils import capture as jcapture

    rig, (left, right, gt) = small_pair
    sbs = np.concatenate([left, right], axis=1)
    l2, r2 = capture.split_sbs(sbs)
    np.testing.assert_array_equal(l2, left)

    src = tmp_path / "flat"
    src.mkdir()
    for i in range(4):
        (src / f"img_{i:02d}.txt").write_text(str(i))
    nl, nr = capture.change_filename(str(src), str(tmp_path / "L"),
                                     str(tmp_path / "R"), n_left=2)
    assert (nl, nr) == (2, 2)

    kw = dict(num_disparities=32, speckle_window_size=0)
    disp = capture.image_disparity(sbs, rig=rig, rectify=False,
                                   params=SGBMParams(**kw), device="cpu")
    assert (disp[:, 32:] >= 0).mean() > 0.5
    want = jcapture.image_disparity(sbs, rig=None, rectify=False,
                                    params=JaxParams(**kw))
    np.testing.assert_array_equal(disp, want)
    # colour input: the plain channel mean, not the BGR weights
    bgr = np.stack([sbs, sbs // 2, 255 - sbs], axis=-1).astype(np.uint8)
    np.testing.assert_array_equal(
        capture.image_disparity(bgr, rectify=False, params=SGBMParams(**kw),
                                device="cpu"),
        jcapture.image_disparity(bgr, rectify=False, params=JaxParams(**kw)))


def test_capture_rectified_matches_the_pipeline_matcher(small_pair):
    """rectify=True remaps both eyes (f32) with the rig's grids first."""
    from stereo_depth_ruler_tpu_torch.ops.remap import (build_remap_grids,
                                                        rectify_pair)
    from stereo_depth_ruler_tpu_torch.ops.sgbm import sgbm

    rig, (left, right, _) = small_pair
    rig = StereoRig.synthetic(width=128, height=96, focal=120.0,
                              baseline_mm=60.0, distortion=True)
    params = SGBMParams(num_disparities=32, speckle_window_size=0)
    disp = capture.image_disparity(np.concatenate([left, right], axis=1),
                                   rig=rig, params=params, device="cpu")
    lt, rt = rectify_pair(torch.tensor(np.float32(left)),
                          torch.tensor(np.float32(right)),
                          *build_remap_grids(rig, "cpu"))
    np.testing.assert_array_equal(disp, sgbm(lt, rt, params).numpy())


def test_capture_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        capture.image_disparity(np.zeros((8, 32), np.uint8))


def test_epipolar_overlay():
    img = np.zeros((64, 32), np.uint8)
    out = draw_epipolar_lines(img, spacing=16)
    assert out.shape == (64, 32, 3)
    assert (out[0] == [0, 255, 0]).all() and (out[16] == [0, 255, 0]).all()
    assert (out[1] == 0).all()


def test_stereo_rectify_np_matches_jax():
    rng = np.random.default_rng(7)
    K1 = np.array([[700.0, 0, 640], [0, 702.0, 360], [0, 0, 1]])
    K2 = np.array([[705.0, 0, 630], [0, 699.0, 362], [0, 0, 1]])
    d = np.zeros(5)
    for t in ([-120.0, 1.5, -0.8], [118.0, -2.0, 3.0]):
        R = tcal._rodrigues_to_rotation(rng.normal(0, 0.02, 3))
        got = tcal.stereo_rectify_np(K1, d, K2, d, (1280, 720), R,
                                     np.array(t))
        want = jcal.stereo_rectify_np(K1, d, K2, d, (1280, 720), R,
                                      np.array(t))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        R1, R2 = got[:2]
        np.testing.assert_allclose(R1 @ R1.T, np.eye(3), atol=1e-12)
        np.testing.assert_allclose(R2 @ R2.T, np.eye(3), atol=1e-12)
    assert tcal.CalibrationSettings() == tcal.CalibrationSettings(
        **vars(jcal.CalibrationSettings()))
    np.testing.assert_array_equal(
        tcal._object_points(tcal.CalibrationSettings()),
        jcal._object_points(jcal.CalibrationSettings()))


def test_calibrate_needs_enough_pairs():
    """Blank frames hold no chessboard: the calibrator refuses them."""
    pytest.importorskip("cv2")
    blank = [np.zeros((48, 64), np.uint8)] * 3
    with pytest.raises(ValueError, match="valid pairs"):
        tcal.StereoCalibrator().calibrate_pairs(blank, blank)


# -- the native host runtime (tests/test_native.py) ------------------------

def _need_native():
    if not native.available():
        pytest.skip("native lib not built (make -C native)")


def test_native_pcd_matches_python(tmp_path):
    _need_native()
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-10, 10, (256, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    p_native = tmp_path / "n.pcd"
    assert native.write_pcd_native(p_native, xyz, rgb)
    x2, c2, _ = read_pcd(p_native)
    np.testing.assert_allclose(x2, xyz, atol=1e-5)
    np.testing.assert_array_equal(c2, rgb)


def test_native_voxel_matches_torch():
    _need_native()
    from stereo_depth_ruler_tpu_torch.ops.voxel import voxel_downsample
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-100, 100, (400, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (400, 3)).astype(np.uint8)
    nx, _ = native.voxel_downsample_native(xyz, rgb, 25.0)
    px, _, cnt = voxel_downsample(torch.from_numpy(xyz),
                                  torch.from_numpy(rgb).float(), 25.0)
    cnt = int(cnt)
    assert len(nx) == cnt
    px = px[:cnt].numpy()
    np.testing.assert_allclose(nx[np.lexsort(nx.T)], px[np.lexsort(px.T)],
                               atol=1e-3)


def test_native_sbsv_reader(tmp_path):
    _need_native()
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (10, 16, 32), dtype=np.uint8)
    video.write_sbsv(tmp_path / "v.sbsv", frames)
    r = native.NativeSbsvReader(tmp_path / "v.sbsv")
    assert (r.n, r.height, r.width, r.channels) == (10, 16, 32, 1)
    np.testing.assert_array_equal(r.read(2, 3), frames[2:5])
    r.prefetch(5, 4)
    np.testing.assert_array_equal(r.read(5, 4), frames[5:9])
    r.close()


def test_native_csv_append(tmp_path):
    _need_native()
    p = tmp_path / "m.csv"
    assert native.csv_append_native(
        p, "Image, First_point,   Second_point, Distance",
        "3, [434, 117],    [440, 189], 240.02902 cm   \n")
    native.csv_append_native(p, "Image, ...",
                             "4, [1, 2],    [3, 4], 10.00000 cm   \n")
    text = p.read_text()
    assert text.count("Image,") == 1 and "240.02902 cm" in text


def test_native_absent_is_not_an_error(monkeypatch, tmp_path):
    """Without the library every fast path reports that it did nothing."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_LIB_PATH", tmp_path / "missing.so")
    assert native.available() is False
    assert native.write_pcd_native(tmp_path / "x.pcd",
                                   np.zeros((1, 3), np.float32)) is False
    assert native.voxel_downsample_native(np.zeros((1, 3), np.float32),
                                          None, 1.0) is None
    assert native.csv_append_native(tmp_path / "x.csv", "h", "r") is False
    with pytest.raises(RuntimeError, match="native library not built"):
        native.NativeSbsvReader(tmp_path / "v.sbsv")
