# Copy of stereo_depth_ruler_tpu/viewer.py: the port keeps its own, framework-free.
"""Local interactive viewer — UX parity with the reference's overlay +
freeze-frame mouse ruler (stereo_displayer.cpp:121-250), for hosts with a
display. The TPU pipeline stays the compute path; this module only renders
its outputs with OpenCV HighGUI and drives the same MeasurementSession
engine the headless API/CLI uses.

Windows (stereo_displayer.cpp:176-183): "Left Rectified", "Depth Map",
"Left: rectified image + disparity overlay". Keys in playback
(:187-197): ESC quit, 'f' freeze -> measurement mode. Keys in
measurement mode (:217-248): 'f'/'F' back to playback, 'a'/'A' return,
's' save CSV, 'r' reset (truncates CSV, :225-235), 'n' new session.
Shift+LeftClick picks points; the pair distance comes from the XYZ map
(cv::norm(xyz1-xyz2), :47-57). Degrades gracefully headless: `available()`
is False when HighGUI cannot open windows.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from .measure import MeasurementSession, depth_coverage
from .viz import DepthVis, DisparityVis, overlay_heat


def available() -> bool:
    """True when an OpenCV HighGUI backend can actually show windows."""
    try:
        import cv2
    except Exception:
        return False
    import os
    if sys.platform.startswith("linux") and not (
            os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        # headless: some HighGUI builds abort() (not raise) inside
        # namedWindow, so don't even probe without a display server
        return False
    try:
        cv2.namedWindow("__sdr_probe__", cv2.WINDOW_NORMAL)
        cv2.destroyWindow("__sdr_probe__")
        return True
    except Exception:
        return False


class InteractiveViewer:
    """Streaming overlay viewer + freeze-frame two-point ruler."""

    WIN_RECT = "Left Rectified"
    WIN_DEPTH = "Depth Map"
    WIN_OVERLAY = "Left: rectified image + disparity overlay"
    WIN_PAUSED = "Paused Image"

    def __init__(self, num_disparities: int, csv_path=None,
                 session: Optional[MeasurementSession] = None,
                 verbose: bool = False):
        import cv2
        self.cv2 = cv2
        self.dvis = DisparityVis(num_disparities)
        self.zvis = DepthVis()
        self.session = session or MeasurementSession(csv_path)
        self.num_disp = num_disparities
        self.verbose = verbose
        self._clicks = []
        self._quit = False

    # -- playback ---------------------------------------------------------

    def show_frame(self, left_rect: np.ndarray, disp: np.ndarray,
                   xyz: np.ndarray) -> bool:
        """Render one frame; returns False when the user quit (ESC)."""
        cv2 = self.cv2
        z = xyz[..., 2]
        depth_rgb = self.zvis(z)
        overlay = overlay_heat(left_rect, self.dvis(disp))
        cv2.imshow(self.WIN_RECT, left_rect.astype(np.uint8))
        cv2.imshow(self.WIN_DEPTH, depth_rgb[..., ::-1])   # RGB -> BGR
        cv2.imshow(self.WIN_OVERLAY, overlay[..., ::-1])
        if self.verbose:
            cov = depth_coverage(z, skip_cols=self.num_disp)
            print(f"depth coverage: {cov * 100.0:.2f}%", file=sys.stderr)
        key = cv2.waitKey(1) & 0xFF
        if key == 27:                                      # ESC
            return False
        if key in (ord("f"), ord("F")):
            return self._measure_loop(overlay, xyz)
        return True

    # -- freeze-frame measurement (test_mouse, :202-250) ------------------

    def _on_mouse(self, event, x, y, flags, param):
        cv2 = self.cv2
        if event != cv2.EVENT_LBUTTONDOWN or not (flags & cv2.EVENT_FLAG_SHIFTKEY):
            return
        frozen, xyz = param
        h, w = xyz.shape[:2]
        if not (0 <= x < w and 0 <= y < h):
            return
        self._clicks.append((x, y))
        cv2.circle(frozen, (x, y), 4, (0, 255, 255), -1)
        if len(self._clicks) == 2:
            p1, p2 = self._clicks
            cv2.line(frozen, p1, p2, (255, 255, 0), 1)
            rec = self.session.measure(p1, p2, xyz)
            print(f"Measured: {rec.distance_cm:.5f} cm", file=sys.stderr)
            self._clicks.clear()
        cv2.imshow(self.WIN_PAUSED, frozen)

    def _measure_loop(self, overlay_rgb: np.ndarray, xyz: np.ndarray) -> bool:
        cv2 = self.cv2
        frozen = overlay_rgb[..., ::-1].copy()
        self._clicks.clear()
        cv2.imshow(self.WIN_PAUSED, frozen)
        cv2.setMouseCallback(self.WIN_PAUSED, self._on_mouse, (frozen, xyz))
        while True:
            key = cv2.waitKey(30) & 0xFF
            if key in (ord("f"), ord("F"), ord("a"), ord("A")):
                break
            if key == ord("s"):
                if self.session.csv_path:
                    self.session.save_csv()
                    print(f"saved {self.session.csv_path}", file=sys.stderr)
                else:
                    print("no CSV path configured (--show-csv); "
                          "measurements not saved", file=sys.stderr)
            elif key == ord("r"):
                self.session.reset()
                print("session reset", file=sys.stderr)
            elif key == ord("n"):
                self.session.new_session()
                print("new measurement session", file=sys.stderr)
            elif key == 27:
                cv2.destroyWindow(self.WIN_PAUSED)
                return False
        cv2.destroyWindow(self.WIN_PAUSED)
        return True

    def close(self) -> None:
        try:
            self.cv2.destroyAllWindows()
        except Exception:
            pass
