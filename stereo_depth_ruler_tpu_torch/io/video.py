# Copy of stereo_depth_ruler_tpu/io/video.py, host_batches' default aside: the port keeps its own.
"""Video ingestion: decode -> split side-by-side -> batch for the device.

Counterpart of the reference's frame loop input handling
(cv::VideoCapture("assets/output.mp4") + cv::Rect split,
stereo_displayer.cpp:132-156) and its ZED live capture
(utils/src/helper.cpp:166-205 — replaced by generic file/stream
ingestion, SURVEY.md §2.8). Decoding uses OpenCV when available; a raw
``.sbsv`` container (written by this module or the native C++ loader in
native/) and in-memory arrays work without it.

The iterator yields fixed-size batches (pipeline-friendly: one jitted
call per batch) and supports resumable cursors for checkpoint/restart
(SURVEY.md §5 'checkpoint/resume': the frame cursor is the only state).
"""

from __future__ import annotations

import dataclasses
import json
import struct
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["VideoSource", "SbsVideoWriter", "read_sbsv", "write_sbsv",
           "FrameCursor", "host_segment", "host_batches",
           "replan_segments", "recovered_batches"]

_SBSV_MAGIC = b"SBSV0001"


def write_sbsv(path, frames: np.ndarray) -> Path:
    """Write a raw side-by-side video container: header + uint8 frames.

    Layout: magic(8) | n,h,w,channels int32 LE | frame data. Exists so the
    pipeline and the native C++ loader share a trivially-parseable format
    when FFmpeg/OpenCV aren't available.
    """
    path = Path(path)
    frames = np.ascontiguousarray(frames, np.uint8)
    n, h, w = frames.shape[:3]
    c = frames.shape[3] if frames.ndim == 4 else 1
    with open(path, "wb") as f:
        f.write(_SBSV_MAGIC)
        f.write(struct.pack("<4i", n, h, w, c))
        f.write(frames.tobytes())
    return path


def read_sbsv(path, start: int = 0, count: Optional[int] = None
              ) -> np.ndarray:
    path = Path(path)
    with open(path, "rb") as f:
        assert f.read(8) == _SBSV_MAGIC, f"{path}: not an SBSV file"
        n, h, w, c = struct.unpack("<4i", f.read(16))
        frame_bytes = h * w * c
        count = n - start if count is None else min(count, n - start)
        f.seek(24 + start * frame_bytes)
        data = np.frombuffer(f.read(count * frame_bytes), np.uint8)
    shape = (count, h, w) if c == 1 else (count, h, w, c)
    return data.reshape(shape)


@dataclasses.dataclass
class FrameCursor:
    """Resumable position in a video job; JSON round-trip for restarts."""
    source: str
    next_frame: int = 0
    total_frames: Optional[int] = None

    def save(self, path) -> None:
        Path(path).write_text(json.dumps(dataclasses.asdict(self)))

    @classmethod
    def load(cls, path) -> "FrameCursor":
        return cls(**json.loads(Path(path).read_text()))


class VideoSource:
    """Uniform frame source over mp4/avi (OpenCV), .sbsv, .npy, or arrays.

    ``split=True`` yields (left, right) halves of side-by-side frames
    (split at W/2 — the reference's layout, stereo_displayer.cpp:155-156);
    ``gray=True`` converts to single-channel.
    """

    def __init__(self, source, split: bool = True, gray: bool = True):
        self.split = split
        self.gray = gray
        self._frames = None
        self._cap = None
        if isinstance(source, np.ndarray):
            self._frames = source
            self.path = "<array>"
        else:
            self.path = str(source)
            p = Path(source)
            if p.suffix == ".sbsv":
                self._frames = read_sbsv(p)
            elif p.suffix == ".npy":
                self._frames = np.load(p)
            else:
                import cv2
                self._cap = cv2.VideoCapture(str(p))
                if not self._cap.isOpened():
                    raise IOError(f"cannot open video {p}")

    def __len__(self) -> int:
        if self._frames is not None:
            return len(self._frames)
        import cv2
        return int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))

    def _convert(self, frame: np.ndarray):
        if self.gray and frame.ndim == 3:
            # OpenCV BGR weights (stereo_disparity.cpp:19-20)
            frame = (0.114 * frame[..., 0] + 0.587 * frame[..., 1]
                     + 0.299 * frame[..., 2]).astype(np.float32)
        if not self.split:
            return frame
        w = frame.shape[1] // 2
        return frame[:, :w], frame[:, w:]

    def frames(self, start: int = 0) -> Iterator:
        """Yield converted frames from ``start`` (seek support for the
        reference's read-101-frames seek, pcd_write.cpp:66-73 — but O(1)
        for indexable sources)."""
        if self._frames is not None:
            for f in self._frames[start:]:
                yield self._convert(f)
            return
        import cv2
        self._cap.set(cv2.CAP_PROP_POS_FRAMES, start)
        while True:
            ok, frame = self._cap.read()
            if not ok:
                return
            yield self._convert(frame)

    def batches(self, batch_size: int, start: int = 0,
                cursor: Optional[FrameCursor] = None) -> Iterator:
        """Yield (frame_indices, left_batch, right_batch) arrays; partial
        final batch is padded by repeating the last frame (static shapes
        for jit) with indices marking real frames."""
        assert self.split, "batches requires split mode"
        buf_l, buf_r, idxs = [], [], []
        i = start if cursor is None else cursor.next_frame
        for pair in self.frames(start=i):
            left, right = pair
            buf_l.append(left)
            buf_r.append(right)
            idxs.append(i)
            i += 1
            if len(buf_l) == batch_size:
                yield (np.array(idxs), np.stack(buf_l), np.stack(buf_r))
                if cursor is not None:
                    cursor.next_frame = i
                buf_l, buf_r, idxs = [], [], []
        if buf_l:
            while len(buf_l) < batch_size:
                buf_l.append(buf_l[-1])
                buf_r.append(buf_r[-1])
                idxs.append(-1)
            yield (np.array(idxs), np.stack(buf_l), np.stack(buf_r))
            if cursor is not None:
                cursor.next_frame = i


def host_segment(n_frames: int, process_index: int, process_count: int,
                 batch: int = 1) -> Tuple[int, int]:
    """Per-host video-segment assignment (SURVEY.md §2.10 'Host I/O
    sharding': each host decodes only its own contiguous slice).

    Returns [start, stop) for this host. Segments are contiguous (good
    for sequential decoders) and rounded so every host's length is a
    multiple of ``batch`` except possibly the last host's.
    """
    per = -(-n_frames // process_count)            # ceil
    per = -(-per // batch) * batch                 # round up to batch
    start = min(process_index * per, n_frames)
    stop = min(start + per, n_frames)
    return start, stop


def host_batches(source, batch_size: int, process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 cursor: Optional[FrameCursor] = None) -> Iterator:
    """Batches over only this host's segment of ``source``.

    process_index/count default to this process's rank and the world size
    of an initialized torch.distributed group (multi-process runtime),
    else 0 of 1; the cursor, if given, is interpreted host-locally (each
    host checkpoints its own cursor file).
    """
    if process_index is None or process_count is None:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            process_index = dist.get_rank()
            process_count = dist.get_world_size()
        else:
            process_index, process_count = 0, 1
    src = source if isinstance(source, VideoSource) else VideoSource(source)
    start, stop = host_segment(len(src), process_index, process_count,
                               batch=batch_size)
    if cursor is not None and cursor.next_frame > start:
        start = cursor.next_frame
    n_left = stop - start
    if n_left <= 0:
        return
    done = 0
    for idxs, lefts, rights in src.batches(batch_size, start=start):
        keep = (idxs >= 0) & (idxs < stop)
        idxs = np.where(keep, idxs, -1)
        yield idxs, lefts, rights
        done += int(keep.sum())
        if cursor is not None:
            cursor.next_frame = start + done
        if start + done >= stop:
            return


def replan_segments(n_frames: int, cursors: dict, surviving,
                    batch: int = 1) -> dict:
    """Re-partition unfinished frames after a host failure (SURVEY.md §5
    'failure detection / elastic recovery': per-frame idempotent
    processing makes recovery natural — checkpoint the frame cursor; on
    multi-host failure, re-shard remaining frames).

    ``cursors`` maps EVERY original host id -> its last saved
    ``FrameCursor.next_frame`` (hosts that never checkpointed should map
    to their segment start). ``surviving`` lists the host ids still
    alive. Returns {survivor: [(start, stop), ...]} such that every
    unfinished frame is covered exactly once: survivors keep their own
    remaining slice; dead hosts' remaining slices are split evenly
    (batch-aligned) across survivors. Deterministic, so every surviving
    host can run this locally from the shared cursor directory and agree
    on the plan without coordination.
    """
    surviving = sorted(surviving)
    n_hosts = len(cursors)
    assert surviving and all(h in cursors for h in surviving)
    plan = {h: [] for h in surviving}
    orphans = []
    for h in sorted(cursors):
        start, stop = host_segment(n_frames, h, n_hosts, batch=batch)
        lo = max(start, min(cursors[h], stop))
        if lo >= stop:
            continue
        if h in surviving:
            plan[h].append((lo, stop))
        else:
            orphans.append((lo, stop))
    # split each orphaned interval across survivors, batch-aligned
    for lo, stop in orphans:
        n = stop - lo
        per = -(-n // len(surviving))
        per = -(-per // batch) * batch
        for k, h in enumerate(surviving):
            a = min(lo + k * per, stop)
            b = min(a + per, stop)
            if a < b:
                plan[h].append((a, b))
    # ascending order per survivor: recovered_batches tracks progress with
    # a single monotone FrameCursor.next_frame, which silently skips any
    # interval that starts BELOW an already-finished one (a survivor whose
    # own segment follows a dead host's inherited slice would lose the
    # inherited frames)
    for h in plan:
        plan[h].sort()
    return plan


def recovered_batches(source, batch_size: int, plan_intervals,
                      cursor: Optional[FrameCursor] = None) -> Iterator:
    """Iterate batches over this host's re-planned intervals (the output
    of replan_segments()[host]); the cursor tracks progress through the
    concatenated intervals for further restarts."""
    src = source if isinstance(source, VideoSource) else VideoSource(source)
    done_total = 0
    # the monotone cursor is only valid over ascending intervals;
    # replan_segments emits them sorted, but sort defensively for plans
    # assembled by hand
    for (start, stop) in sorted(plan_intervals):
        if cursor is not None and cursor.next_frame > start:
            start = max(start, cursor.next_frame)
        if start >= stop:
            continue
        done = 0
        for idxs, lefts, rights in src.batches(batch_size, start=start):
            keep = (idxs >= 0) & (idxs < stop)
            idxs = np.where(keep, idxs, -1)
            yield idxs, lefts, rights
            done += int(keep.sum())
            if cursor is not None:
                cursor.next_frame = start + done
            if start + done >= stop:
                break
        done_total += done


class SbsVideoWriter:
    """Encode side-by-side frames to mp4 via OpenCV (for demo export)."""

    def __init__(self, path, fps: float = 30.0):
        self.path = str(path)
        self.fps = fps
        self._writer = None

    def write(self, frame: np.ndarray) -> None:
        import cv2
        if frame.ndim == 2:
            frame = np.repeat(frame[..., None], 3, axis=2)
        frame = np.clip(frame, 0, 255).astype(np.uint8)
        if self._writer is None:
            h, w = frame.shape[:2]
            fourcc = cv2.VideoWriter_fourcc(*"mp4v")
            self._writer = cv2.VideoWriter(self.path, fourcc, self.fps,
                                           (w, h))
        self._writer.write(frame)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None
