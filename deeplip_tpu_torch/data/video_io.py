"""Video and media helpers on the host.

Counterpart of ``deeplip_tpu/data/video_io.py``: video decode to uint8
frames, text/JSON readers and the ``npz`` container (key ``'data'``) that
clips and per-clip embeddings are stored in. Decode stays on the host; the
frames feed the on-device transforms (``deeplip_tpu_torch.ops.video``).
OpenCV is optional: callers check :func:`cv2_available` first.
"""

from __future__ import annotations

import json
import os

import numpy as np


def cv2_available() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def extract_video_frames(path: str, to_gray: bool = True) -> np.ndarray:
    """Decode a video file to ``(T, H, W[, 3])`` uint8 frames (needs cv2)."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    try:
        while cap.isOpened():
            ok, frame = cap.read()
            if not ok:
                break
            code = cv2.COLOR_BGR2GRAY if to_gray else cv2.COLOR_BGR2RGB
            frames.append(cv2.cvtColor(frame, code))
    finally:
        cap.release()
    return np.stack(frames) if frames else np.zeros((0, 0, 0), np.uint8)


def read_txt_lines(path: str) -> list[str]:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path} not found")
    with open(path) as f:
        return [line.rstrip() for line in f]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def save2npz(path: str, data: np.ndarray) -> None:
    """An ``.npz`` with the array under key ``'data'``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, data=data)
