"""The port's CLI (``python -m stereo_depth_ruler_tpu_torch.cli``) against
the JAX package's, both in this process on the same small synthetic
videos, the port with ``--device cpu`` (the kernels' plain versions).

``synth`` writes the same bytes. ``run``'s per-frame metrics: the frame
indices, valid fractions and depth coverages are equal, the mean depth at
rtol 1e-5 (a float sum whose order differs between XLA and PyTorch);
with WLS every value is held at the WLS bound (rtol 2e-3, atol 2e-2).
``measure`` and ``cloud`` give the JAX CLI's output within the same
tolerances. ``bench`` runs in-process at a cut shape and prints one JSON
line with the JAX bench's keys plus ``device``."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stereo_depth_ruler_tpu import cli as jcli
from stereo_depth_ruler_tpu.utils import cache as jcache
from stereo_depth_ruler_tpu_torch import cli
from stereo_depth_ruler_tpu_torch.io.pcd import read_pcd
from stereo_depth_ruler_tpu_torch.io.video import read_sbsv, write_sbsv

ROOT = Path(__file__).resolve().parent.parent
SIZE = ["--width", "96", "--height", "48"]
MATCH = SIZE + ["--num-disp", "16"]
RTOL = 1e-5
WLS_RTOL, WLS_ATOL = 2e-3, 2e-2


@pytest.fixture(autouse=True)
def no_jax_compile_cache(monkeypatch):
    """The JAX CLI's run turns on a persistent compile cache under the
    user's home; keep the tests from writing there."""
    monkeypatch.setattr(jcache, "enable_compile_cache", lambda *a, **k: None)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """A gray synthetic video from the port's synth, and a BGR one whose
    channels differ, from the same frames."""
    d = tmp_path_factory.mktemp("videos")
    gray = d / "gray.sbsv"
    assert cli.main(["synth", "--out", str(gray), "--frames", "5",
                     "--seed", "2"] + SIZE) == 0
    frames = read_sbsv(gray).astype(np.float32)
    bgr = np.stack([frames, 0.5 * frames + 64.0, 0.8 * frames], axis=-1)
    write_sbsv(d / "bgr.sbsv", bgr.astype(np.uint8))
    return gray, d / "bgr.sbsv"


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_synth_matches_jax_bytes(tmp_path):
    args = ["--frames", "3", "--boxes", "3", "--seed", "4"] + SIZE
    assert cli.main(["synth", "--out", str(tmp_path / "t.sbsv"),
                     "--gt-out", str(tmp_path / "t.npy")] + args) == 0
    assert jcli.main(["synth", "--out", str(tmp_path / "j.sbsv"),
                      "--gt-out", str(tmp_path / "j.npy")] + args) == 0
    assert ((tmp_path / "t.sbsv").read_bytes()
            == (tmp_path / "j.sbsv").read_bytes())
    assert ((tmp_path / "t.npy").read_bytes()
            == (tmp_path / "j.npy").read_bytes())
    assert read_sbsv(tmp_path / "t.sbsv").shape == (3, 48, 192)


def _run_both(tmp_path, capsys, video, extra):
    out = {}
    for name, mod, dev in (("torch", cli, ["--device", "cpu"]),
                           ("jax", jcli, [])):
        metrics = tmp_path / f"{name}.jsonl"
        assert mod.main(["run", str(video), "--batch", "2", "--metrics",
                         str(metrics)] + MATCH + extra + dev) == 0
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        out[name] = (_records(metrics), summary)
    return out


@pytest.mark.parametrize("which,extra", [("gray", ["--no-wls"]),
                                         ("bgr", ["--no-wls"]),
                                         ("gray", [])],
                         ids=["no_wls", "bgr_no_wls", "wls"])
def test_run_metrics_match_jax(tmp_path, capsys, videos, which, extra):
    video = videos[0] if which == "gray" else videos[1]
    out = _run_both(tmp_path, capsys, video, extra)
    got, want = out["torch"][0], out["jax"][0]
    assert [r["frame_index"] for r in got] == list(range(5))
    assert [r["frame_index"] for r in want] == list(range(5))
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("valid_disparity_frac", "depth_coverage", "mean_depth_mm"):
            if extra:
                if k == "mean_depth_mm":
                    assert g[k] == pytest.approx(w[k], rel=RTOL), k
                else:
                    assert g[k] == w[k], k
            else:
                assert g[k] == pytest.approx(w[k], rel=WLS_RTOL,
                                             abs=WLS_ATOL), k
        assert g["disparity_mae_vs_ref"] is w["disparity_mae_vs_ref"] is None
    assert set(out["torch"][1]) == set(out["jax"][1])
    assert out["torch"][1]["frames"] == 5
    assert out["torch"][1]["video_end_to_end_fps"] > 0


def test_run_resume_split_matches_one_run(tmp_path, capsys, videos):
    """--max-frames then --resume: the cursor file is the JAX CLI's, and
    the two runs' records, the later of two for one frame (at-least-once
    replay), are one whole run's."""
    video = str(videos[0])
    base = ["run", video, "--batch", "2", "--no-wls"] + MATCH
    whole = tmp_path / "whole.jsonl"
    assert cli.main(base + ["--metrics", str(whole), "--device", "cpu"]) == 0
    split = tmp_path / "split.jsonl"
    cursor, jcursor = tmp_path / "c.json", tmp_path / "jc.json"
    first = ["--max-frames", "4", "--metrics", str(split)]
    assert cli.main(base + first + ["--resume", str(cursor),
                                    "--device", "cpu"]) == 0
    assert jcli.main(base + ["--max-frames", "4", "--resume",
                             str(jcursor)]) == 0
    assert cursor.read_text() == jcursor.read_text().replace(
        str(jcursor), str(cursor))
    assert cli.main(base + ["--metrics", str(split), "--resume",
                            str(cursor), "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    start = int(re.search(r"resuming at frame (\d+)", err).group(1))
    assert 0 < start < 5
    recs = _records(split)
    assert len(recs) == 4 + 5 - start
    last = {r["frame_index"]: r for r in recs}
    want = {r["frame_index"]: r for r in _records(whole)}
    assert sorted(last) == sorted(want) == list(range(5))
    for i in want:
        last[i].pop("wall_ms")
        want[i].pop("wall_ms")
        assert last[i] == want[i]
    assert json.loads(cursor.read_text())["next_frame"] == 5


def _distances(text):
    return [float(v) for v in re.findall(r": ([0-9.]+|nan) cm", text)]


@pytest.mark.parametrize("extra,rtol", [(["--no-wls"], RTOL), ([], WLS_RTOL)],
                         ids=["no_wls", "wls"])
def test_measure_matches_jax(tmp_path, capsys, videos, extra, rtol):
    points = ["--points", "60,10,70,20", "50,30,80,12"]
    args = ["measure", str(videos[0]), "--frame", "3"] + points + MATCH + extra
    assert cli.main(args + ["--csv", str(tmp_path / "t.csv"),
                            "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jcli.main(args + ["--csv", str(tmp_path / "j.csv")]) == 0
    want = capsys.readouterr().out
    g, w = _distances(got), _distances(want)
    assert len(g) == len(w) == 2
    np.testing.assert_allclose(g, w, rtol=rtol)
    assert got.splitlines()[0].startswith("(60, 10) -> (70, 20): ")
    gl = (tmp_path / "t.csv").read_text().splitlines()
    wl = (tmp_path / "j.csv").read_text().splitlines()
    assert len(gl) == len(wl) == 3 and gl[0] == wl[0]


def test_cloud_matches_jax(tmp_path, capsys, videos):
    args = ["cloud", str(videos[0]), "--frame", "2", "--leaf", "20"] + MATCH
    assert cli.main(args + ["--out", str(tmp_path / "t"),
                            "--device", "cpu"]) == 0
    assert jcli.main(args + ["--out", str(tmp_path / "j")]) == 0
    assert "frame_00002.pcd" in capsys.readouterr().err
    tx, tc, ts = read_pcd(tmp_path / "t" / "frame_00002.pcd")
    jx, jc, js = read_pcd(tmp_path / "j" / "frame_00002.pcd")
    assert ts == js and len(tx) == len(jx) > 0
    np.testing.assert_allclose(tx, jx, atol=1e-3)
    assert np.abs(tc.astype(int) - jc.astype(int)).max() <= 1


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "cv_baseline_fps",
              "compile_s", "full_pipeline_fps", "full_pipeline_vs_cv_sgbm",
              "sweep_2560x1440x256_fps"}


@pytest.fixture
def small_bench(monkeypatch):
    """The bench's shapes cut to 2 frames of 96x48 with 16 disparities,
    the sweep to 40x80x16."""
    import functools
    from stereo_depth_ruler_tpu_torch import bench
    monkeypatch.setattr(bench, "H", 48)
    monkeypatch.setattr(bench, "W", 96)
    monkeypatch.setattr(bench, "D", 16)
    monkeypatch.setattr(bench, "SWEEP", (40, 80, 16))
    monkeypatch.setattr(bench, "make_inputs",
                        functools.partial(bench.make_inputs, batch=2))


def _bench_line(capsys, argv):
    import subprocess

    def refuse(*a, **k):
        raise AssertionError("bench must run in-process")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(subprocess, "call", refuse)
        assert cli.main(["bench", "--device", "cpu", "--iters", "1",
                         "--cv-frames", "1"] + argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_bench_prints_the_jax_bench_keys(capsys, small_bench):
    """bench.py's keys and meanings, plus the device it ran on."""
    pytest.importorskip("cv2")
    line = _bench_line(capsys, ["--sweep"])
    assert set(line) == BENCH_KEYS | {"device"}
    assert line["metric"] == "stereo_fps_per_chip_96x48_16disp_sgbm"
    assert line["unit"] == "frames/s" and line["device"] == "cpu"
    for k in ("value", "cv_baseline_fps", "full_pipeline_fps",
              "sweep_2560x1440x256_fps"):
        assert line[k] > 0, k
    assert line["vs_baseline"] == round(line["value"]
                                         / line["cv_baseline_fps"], 3)
    assert set(line["compile_s"]) == {"sgbm", "full_pipeline"}


def test_bench_module_takes_the_cli_flags(capsys, small_bench):
    """``python -m stereo_depth_ruler_tpu_torch.bench`` parses the CLI's
    bench flags: --no-full drops the full pipeline's keys."""
    pytest.importorskip("cv2")
    from stereo_depth_ruler_tpu_torch import bench
    assert bench.main(["--device", "cpu", "--iters", "1", "--cv-frames",
                       "1", "--no-full"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == BENCH_KEYS - {
        "full_pipeline_fps", "full_pipeline_vs_cv_sgbm",
        "sweep_2560x1440x256_fps"} | {"device"}
    assert line["value"] > 0 and set(line["compile_s"]) == {"sgbm"}


def test_only_bench_imports_the_bench_module(tmp_path):
    """Building the parser and running another command leaves the bench
    module (and the entry points it loads) unimported."""
    import subprocess
    import sys
    code = ("import sys; from stereo_depth_ruler_tpu_torch import cli; "
            f"cli.main(['synth', '--out', {str(tmp_path / 'v.sbsv')!r}, "
            "'--frames', '1', '--width', '64', '--height', '32']); "
            "print(sorted(m for m in sys.modules if m.startswith("
            "'stereo_depth_ruler_tpu_torch.') and m.rsplit('.', 1)[1] in "
            "('bench', 'entry')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("cmd", ["run", "measure", "cloud", "bench"])
def test_cuda_device_without_cuda_raises(monkeypatch, videos, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"measure": [str(videos[0])] + MATCH + ["--points", "1,1,2,2"],
            "cloud": [str(videos[0])] + MATCH + ["--frame", "0"],
            "run": [str(videos[0])] + MATCH,
            "bench": ["--iters", "1", "--cv-frames", "1"]}[cmd]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([cmd] + argv)


def test_calibrate_refuses_frames_without_a_board(tmp_path):
    cv2 = pytest.importorskip("cv2")
    for side in ("L", "R"):
        (tmp_path / side).mkdir()
        for i in range(2):
            cv2.imwrite(str(tmp_path / side / f"{i}.png"),
                        np.zeros((48, 64), np.uint8))
    with pytest.raises(ValueError, match="valid pairs"):
        cli.main(["calibrate", str(tmp_path / "L"), str(tmp_path / "R"),
                  "--out", str(tmp_path / "s.yaml")])


def test_mae_tool_meets_its_bound_on_the_cpu(tmp_path):
    """tools/mae_torch.py, the accuracy gate against cv2.StereoSGBM, at a
    small size on the plain versions."""
    pytest.importorskip("cv2")
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "tools" / "mae_torch.py"
    spec = importlib.util.spec_from_file_location("mae_torch", path)
    mae = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mae)
    out = tmp_path / "mae.json"
    assert mae.main(["--device", "cpu", "--size", "48x96x16", "--frames",
                     "1", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["pass"] and rec["disp_mae_px"] < 0.5
    assert rec["frames"][0]["n_both"] > 1000
    assert np.isfinite(rec["depth_mae_mm"])
