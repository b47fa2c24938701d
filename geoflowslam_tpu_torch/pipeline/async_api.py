"""Asynchronous tracking API: enqueue frames, receive pose futures (port of
geoflowslam_tpu/pipeline/async_api.py).

Parity with System::TrackRGBDAsync (the reference's src/System.cc:558-742):
the reference posts frame construction to a 2-thread pool and runs Track()
on a dedicated consumer thread, returning std::future<SE3f>. Here a single
consumer thread drains a bounded ordered queue and drives the SlamSystem;
image decode-ahead is the native loader's job (io/native_loader.py). Python
futures deliver the poses.

On a CUDA device the worker thread queues its work on the current CUDA
stream of its own thread, which is the device's default stream (PyTorch
keeps the current stream per thread, and a new thread starts on the default
one); the kernels' launchers take the current stream, so the worker's
kernels and its PyTorch operations stay ordered on that one stream. Every
call into the façade happens on the worker thread, one frame at a time.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Optional

import numpy as np


class AsyncSlam:
    """Wraps a SlamSystem with a consumer thread + bounded frame queue."""

    def __init__(self, slam, queue_cap: int = 50):
        self.slam = slam
        self.q: "queue.Queue" = queue.Queue(maxsize=queue_cap)
        self._stop = False
        self.worker = threading.Thread(target=self._run, daemon=True)
        self.worker.start()

    def track_rgbd_async(self, gray, depth, timestamp: float,
                         imu: Optional[tuple] = None,
                         odom: Optional[np.ndarray] = None) -> Future:
        fut: Future = Future()
        self.q.put(("rgbd", (gray, depth, timestamp, imu, odom), fut))
        return fut

    def track_monocular_async(self, gray, timestamp: float) -> Future:
        fut: Future = Future()
        self.q.put(("mono", (gray, timestamp), fut))
        return fut

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            kind, args, fut = item
            try:
                if kind == "rgbd":
                    gray, depth, ts, imu, odom = args
                    if odom is not None:
                        self.slam.set_odom(odom)
                    if imu is not None:
                        pose = self.slam.track_rgbd_inertial(
                            gray, depth, *imu, ts)
                    else:
                        pose = self.slam.track_rgbd(gray, depth, ts)
                else:
                    gray, ts = args
                    pose = self.slam.track_monocular(gray, ts)
                fut.set_result(pose)
            except Exception as e:  # propagate to the caller's future
                fut.set_exception(e)

    def shutdown(self, save_dir: Optional[str] = None):
        """Drain the queue, stop the consumer, flush stats."""
        self.q.put(None)
        self.worker.join(timeout=60)
        self.slam.shutdown(save_dir)
