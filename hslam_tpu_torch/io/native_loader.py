"""The prefetching frame loader (counterpart of hslam_tpu/io/native_loader.py
and native/loader.cpp): a pool of worker threads decodes frames ahead of the
consumer and corrects them, so that decoding overlaps the frame's SLAM work.

The JAX package binds a C++ pool through ctypes. That library includes
OpenCV's headers, which the card's machine does not have, so this pool is
Python threads instead. They overlap because every step of a worker runs
outside the interpreter lock: `cv2.imread` / `cv2.imdecode` release it, and
so do torch's CPU operators. The API is the JAX module's: `available()`,
`NativeLoader` over file paths, `NativeMemLoader` fed with compressed blobs
(zip archives), `get(idx)` -> (H, W) float32 numpy array, `len()`, `close()`.

Per frame a worker does, in the reference's order (loader.cpp:101-150,
DatasetLoader.h:436-506):
  1. decode to 8-bit grayscale (cv2);
  2. the inverse response LUT and the inverse vignette at the raw size;
  3. the geometric remap (clamped bilinear; a table entry x < 0 gives 0).
Steps 2 and 3 are the port's own `ops/undistort.photometric_correct` and
`remap_image` on CPU tensors, the functions `tools/run_sequence.FrameCorrector`
runs on the card. One difference from the C++ pool: an inverse vignette of
another size than the decoded frame fails that frame (`get` raises IOError)
where loader.cpp skips the vignette silently.

Scheduling is loader.cpp's: a `get(idx)` queues [idx, idx + n_prefetch) that
are not decoded or queued yet and drops decoded frames more than 2 behind
idx (`schedule_ahead`, loader.cpp:173-200); a `get` that jumps ahead still
works. `NativeMemLoader` reads the blobs on the consumer's thread
(`zipfile.ZipFile` must not be read from several threads at once) and hands
them to the pool `n_prefetch` frames ahead. A frame that fails to decode
raises IOError from `get`; so does a blob-fed frame that was never pushed or
was already dropped. `close()` joins every worker.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from ..ops.undistort import photometric_correct, remap_image

STALE = 2        # decoded frames kept behind the consumer (loader.cpp:193)


def available() -> bool:
    """The pool needs only cv2 (no build step, unlike the JAX package's)."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


class _Pool:
    """The worker pool and its cache (loader.cpp's `Loader`). `decode(idx,
    blob)` returns the uint8 frame or None; `blob` is None in path mode."""

    def __init__(self, n_frames: int, decode: Callable, n_threads: int,
                 inv_response, inv_vignette, remap):
        self.n_frames = n_frames
        self._decode = decode
        as_t = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a, np.float32))
        self._resp, self._vig, self._remap = as_t(inv_response), as_t(inv_vignette), as_t(remap)
        if self._resp is not None and self._resp.shape != (256,):
            raise ValueError(f"inv_response must have 256 entries, not {tuple(self._resp.shape)}")
        if self._remap is not None and (self._remap.dim() != 3 or self._remap.shape[2] != 2):
            raise ValueError(f"remap must be (H, W, 2), not {tuple(self._remap.shape)}")
        self._cv = threading.Condition()
        self._cache: dict = {}         # idx -> float32 frame, or the exception it raised
        self._queue: deque = deque()
        self._blobs: dict = {}         # blob-fed: idx -> compressed bytes not yet decoded
        self._decoding: set = set()
        self._stop = False
        self._workers = [threading.Thread(target=self._work, daemon=True, name=f"loader-{i}")
                         for i in range(max(1, n_threads))]
        for t in self._workers:
            t.start()

    def _correct(self, img: np.ndarray) -> np.ndarray:
        out = torch.from_numpy(img).to(torch.float32)
        if self._vig is not None and self._vig.shape != out.shape:
            raise ValueError(f"inverse vignette {tuple(self._vig.shape)} does not fit the "
                             f"{tuple(out.shape)} frame")
        out = photometric_correct(out, self._resp, self._vig)
        if self._remap is not None:
            out = remap_image(out, self._remap)
        return out.numpy()

    def _work(self):
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._stop or self._queue)
                if self._stop:
                    return
                idx = self._queue.popleft()
                self._decoding.add(idx)
                blob = self._blobs.pop(idx, None)
            try:
                img = self._decode(idx, blob)
                if img is None:
                    raise IOError("cv2 could not decode it")
                frame = self._correct(img)
            except Exception as e:       # handed to the consumer's get()
                frame = e
            with self._cv:
                self._cache[idx] = frame
                self._decoding.discard(idx)
                self._cv.notify_all()

    def push(self, idx: int, blob: bytes):
        """Blob-fed mode: queue frame idx's compressed bytes (loader_push)."""
        with self._cv:
            if idx in self._cache or idx in self._blobs or idx in self._decoding:
                return
            self._blobs[idx] = blob
            self._queue.append(idx)
            self._cv.notify_all()

    def get(self, idx: int, n_prefetch: int) -> np.ndarray:
        """Block until frame idx is corrected. With n_prefetch > 0 (path
        mode) queue [idx, idx + n_prefetch) first; drop what is stale."""
        if not 0 <= idx < self.n_frames:
            raise IndexError(f"frame {idx} of {self.n_frames}")
        with self._cv:
            for k in [k for k in self._cache if k < idx - STALE]:
                del self._cache[k]
            if n_prefetch:
                queued = set(self._queue)
                for k in queued:
                    if k < idx - STALE:
                        self._queue.remove(k)
                for k in range(idx, min(idx + n_prefetch, self.n_frames)):
                    if k not in self._cache and k not in queued and k not in self._decoding:
                        self._queue.append(k)
                self._cv.notify_all()
            # blob-fed: give up once the frame is neither cached, pending nor
            # being decoded (never pushed, or consumed and dropped)
            self._cv.wait_for(lambda: self._stop or idx in self._cache or not (
                n_prefetch or idx in self._blobs or idx in self._decoding))
            if self._stop:
                raise ValueError("the loader is closed")
            frame = self._cache.get(idx)
        if frame is None:
            raise IOError(f"loader: frame {idx} was never pushed or was already dropped")
        if isinstance(frame, Exception):
            raise IOError(f"loader failed on frame {idx}: {frame}") from frame
        return frame.copy()

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._workers:
            t.join()


class _Loader:
    """What both loaders share: the pool, its length and its lifetime."""
    _pool: _Pool

    def __len__(self):
        return self._pool.n_frames

    def close(self):
        self._pool.close()

    def __del__(self):
        if hasattr(self, "_pool"):
            self._pool.close()


class NativeLoader(_Loader):
    """Threaded prefetching decoder over an explicit file list."""

    def __init__(self, paths: List[str], n_prefetch: int = 8, n_threads: int = 2,
                 inv_response: Optional[np.ndarray] = None,
                 inv_vignette: Optional[np.ndarray] = None,
                 remap: Optional[np.ndarray] = None):
        import cv2
        paths = list(paths)
        self._prefetch = max(1, n_prefetch)
        self._pool = _Pool(len(paths), lambda i, _: cv2.imread(paths[i], cv2.IMREAD_GRAYSCALE),
                           n_threads, inv_response, inv_vignette, remap)

    def get(self, idx: int) -> np.ndarray:
        """Blocking fetch of frame idx as (H, W) float32, corrected."""
        return self._pool.get(idx, self._prefetch)


class NativeMemLoader(_Loader):
    """Decode pool fed with compressed blobs: the archive path (the reference
    reads zips through libzip, DatasetLoader.h:410-434). `read_blob(i)` runs
    on the consumer's thread only; decoding and correction run in the pool,
    `n_prefetch` frames ahead of the consumer."""

    def __init__(self, n_frames: int, read_blob: Callable[[int], bytes], n_prefetch: int = 8,
                 n_threads: int = 2, inv_response: Optional[np.ndarray] = None,
                 inv_vignette: Optional[np.ndarray] = None,
                 remap: Optional[np.ndarray] = None):
        import cv2

        def decode(_, blob):
            return cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_GRAYSCALE)

        self._read_blob = read_blob
        self._prefetch = max(1, n_prefetch)
        self._pushed = -1          # highest index handed to the pool
        self._pool = _Pool(n_frames, decode, n_threads, inv_response, inv_vignette, remap)

    def _feed_to(self, upto: int):
        for i in range(self._pushed + 1, min(upto, len(self) - 1) + 1):
            self._pool.push(i, self._read_blob(i))
            self._pushed = i

    def get(self, idx: int) -> np.ndarray:
        """Blocking fetch of frame idx as (H, W) float32, corrected; feeds
        the pool `n_prefetch` frames ahead so decoding overlaps the caller."""
        self._feed_to(idx + self._prefetch)
        return self._pool.get(idx, 0)
