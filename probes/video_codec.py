#!/usr/bin/env python3
"""Check OpenCV's video I/O on the machine that holds the card: the
versions of cv2, imageio, matplotlib and PIL, whether an ``mp4v``
``VideoWriter`` opens at Cityscapes' 2048x1024, the host-clock time to
write and read 12 random frames, and whether a writer in a missing
directory reports ``isOpened() == False``.

    python3 probes/video_codec.py

``viz.overlay.segment_video`` and ``create_video_from_images`` use this
writer; their ``isOpened()`` check relies on the last line.
"""

import importlib
import os
import tempfile
import time

import numpy as np

for name in ("cv2", "imageio", "matplotlib", "PIL"):
    try:
        print(name, getattr(importlib.import_module(name), "__version__", "present"))
    except ImportError as e:
        print(name, "absent", e)

import cv2  # noqa: E402

with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "v.mp4")
    frames = np.random.default_rng(0).integers(0, 256, (4, 1024, 2048, 3), dtype=np.uint8)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (2048, 1024))
    print("writer opened", writer.isOpened())
    t0 = time.perf_counter()
    for i in range(12):
        writer.write(frames[i % 4])
    writer.release()
    print(f"wrote 12 frames in {time.perf_counter() - t0:.3f} s, {os.path.getsize(path)} bytes")
    cap = cv2.VideoCapture(path)
    print("reader opened", cap.isOpened(), cap.get(cv2.CAP_PROP_FPS),
          cap.get(cv2.CAP_PROP_FRAME_WIDTH), cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    t0, n = time.perf_counter(), 0
    while cap.read()[0]:
        n += 1
    cap.release()
    print(f"read {n} frames in {time.perf_counter() - t0:.3f} s")
    missing = cv2.VideoWriter(os.path.join(d, "missing", "x.mp4"),
                              cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (64, 32))
    print("writer in a missing directory opened", missing.isOpened())
print(cv2.getBuildInformation().split("Video I/O:")[1][:400])
