"""Video container ingestion: file -> uniformly sampled RGB frames
(`grasp_any_region_tpu/data/video.py`). The frames feed
`data/builders.build_video_sample`: one 448 x 448 tile and one crop-token
run per annotated frame. `cv2` is imported only when a file is read.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def uniform_frame_indices(total: int, num_frames: int) -> List[int]:
    """Uniform temporal sampling: linspace over [0, total - 1] rounded to
    ints; every frame when there are no more than num_frames."""
    if total <= 0:
        return []
    if total <= num_frames:
        return list(range(total))
    return [int(round(x)) for x in np.linspace(0, total - 1, num_frames)]


def read_video_frames(path: str, num_frames: int = 32) -> Tuple[List[np.ndarray], List[int], float]:
    """Decode a video file -> (frames RGB uint8, frame indices, fps).

    Seeks to each sampled index when the container reports a frame count;
    falls back to a sequential decode for streams without one.
    """
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    try:
        fps = float(cap.get(cv2.CAP_PROP_FPS) or 0.0)
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
        if total > 0:
            frames: List[np.ndarray] = []
            kept: List[int] = []
            for i in uniform_frame_indices(total, num_frames):
                cap.set(cv2.CAP_PROP_POS_FRAMES, i)
                ok, fr = cap.read()
                if not ok:  # the count was over-reported; stop at the real end
                    break
                frames.append(cv2.cvtColor(fr, cv2.COLOR_BGR2RGB))
                kept.append(i)
            if frames:
                return frames, kept, fps
        # no (reliable) frame count: decode sequentially, then sample
        cap.release()
        cap = cv2.VideoCapture(path)
        all_frames: List[np.ndarray] = []
        while True:
            ok, fr = cap.read()
            if not ok:
                break
            all_frames.append(cv2.cvtColor(fr, cv2.COLOR_BGR2RGB))
        idx = uniform_frame_indices(len(all_frames), num_frames)
        return [all_frames[i] for i in idx], idx, fps
    finally:
        cap.release()
