"""Dataset readers: TUM-MonoVO, EuRoC, KITTI (host side; a copy of
hslam_tpu/io/dataset.py over the port's calib_io).

Equivalent of the reference's DatasetReader (Include/DatasetLoader.h):
directory-layout detection (:125-139), timestamp + exposure parsing per
dataset (:160-292), zipped-archive reads (:61-119 via libzip -> python
zipfile here), and orchestration of photometric-then-geometric correction
(:436-506). Image decode via cv2; correction itself runs on the device
(ops/undistort.py) — this module only stages raw frames and calibration.
"""
from __future__ import annotations

import dataclasses
import os
import zipfile
from typing import List, Optional, Tuple

import numpy as np

from .calib_io import CameraModel, parse_camera_txt, parse_opencv_yaml


@dataclasses.dataclass
class FrameData:
    image: np.ndarray          # (H, W) float32 raw grayscale
    timestamp: float
    exposure: float
    id: int


@dataclasses.dataclass
class PhotometricCalib:
    gamma: Optional[np.ndarray]        # (256,) response G
    inv_vignette: Optional[np.ndarray]  # (H, W)


def _decode_gray(buf: bytes) -> np.ndarray:
    import cv2

    arr = np.frombuffer(buf, np.uint8)
    img = cv2.imdecode(arr, cv2.IMREAD_GRAYSCALE)
    return img.astype(np.float32)


class DatasetReader:
    """Unified reader. `kind` in {'tum', 'euroc', 'kitti'} or auto-detected
    from the directory layout (DatasetLoader.h:125-139)."""

    def __init__(self, path: str, kind: Optional[str] = None,
                 calib_path: Optional[str] = None):
        self.path = path.rstrip("/")
        self.kind = kind or self._detect(self.path)
        self._zip: Optional[zipfile.ZipFile] = None
        self.files: List[str] = []
        self.timestamps: List[float] = []
        self.exposures: List[float] = []
        self._load_index()
        self.camera = self._load_geometric(calib_path)
        self.photometric = self._load_photometric()

    # --- layout detection -------------------------------------------------
    @staticmethod
    def _detect(path: str) -> str:
        if os.path.isdir(os.path.join(path, "mav0")) or os.path.isdir(
            os.path.join(path, "cam0")
        ):
            return "euroc"
        if os.path.isdir(os.path.join(path, "image_0")) or os.path.basename(
            os.path.dirname(path)
        ) == "sequences":
            return "kitti"
        return "tum"

    # --- index ------------------------------------------------------------
    def _load_index(self):
        p = self.path
        if self.kind == "tum":
            img_zip = os.path.join(p, "images.zip")
            img_dir = os.path.join(p, "images")
            if os.path.exists(img_zip):
                self._zip = zipfile.ZipFile(img_zip)
                names = sorted(
                    n for n in self._zip.namelist()
                    if n.lower().endswith((".jpg", ".png"))
                )
                self.files = names
            else:
                self.files = sorted(
                    os.path.join(img_dir, f) for f in os.listdir(img_dir)
                    if f.lower().endswith((".jpg", ".png"))
                )
            times_file = os.path.join(p, "times.txt")
            if os.path.exists(times_file):
                with open(times_file) as f:
                    for ln in f:
                        parts = ln.strip().split()
                        if not parts or parts[0].startswith("#"):
                            continue
                        # id timestamp [exposure]
                        self.timestamps.append(float(parts[1]))
                        self.exposures.append(
                            float(parts[2]) if len(parts) > 2 else 1.0
                        )
        elif self.kind == "euroc":
            # zipped EuRoC: archive containing mav0/cam0/data/*.png
            # (DatasetLoader.h:410-434 reads any layout through libzip)
            img_zip = os.path.join(p, "images.zip")
            if os.path.exists(img_zip):
                self._zip = zipfile.ZipFile(img_zip)
                names = sorted(
                    n for n in self._zip.namelist()
                    if n.lower().endswith(".png") and "/data/" in n
                )
                self.files = names
                self.timestamps = [
                    float(os.path.splitext(os.path.basename(f))[0]) * 1e-9
                    for f in names
                ]
                self.exposures = [1.0] * len(names)
            else:
                cam = os.path.join(p, "mav0", "cam0")
                if not os.path.isdir(cam):
                    cam = os.path.join(p, "cam0")
                data_dir = os.path.join(cam, "data")
                csv = os.path.join(cam, "data.csv")
                if os.path.exists(csv):
                    with open(csv) as f:
                        for ln in f:
                            if ln.startswith("#"):
                                continue
                            ts, name = ln.strip().split(",")[:2]
                            self.files.append(os.path.join(data_dir, name))
                            self.timestamps.append(float(ts) * 1e-9)
                            self.exposures.append(1.0)
                else:
                    self.files = sorted(
                        os.path.join(data_dir, f) for f in os.listdir(data_dir)
                    )
                    self.timestamps = [
                        float(os.path.splitext(os.path.basename(f))[0]) * 1e-9
                        for f in self.files
                    ]
                    self.exposures = [1.0] * len(self.files)
        elif self.kind == "kitti":
            img_zip = os.path.join(p, "images.zip")
            if os.path.exists(img_zip):
                self._zip = zipfile.ZipFile(img_zip)
                self.files = sorted(
                    n for n in self._zip.namelist()
                    if n.endswith(".png") and "image_0/" in n
                )
            else:
                img_dir = os.path.join(p, "image_0")
                self.files = sorted(
                    os.path.join(img_dir, f) for f in os.listdir(img_dir)
                    if f.endswith(".png")
                )
            times_file = os.path.join(p, "times.txt")
            if os.path.exists(times_file):
                with open(times_file) as f:
                    self.timestamps = [float(ln) for ln in f if ln.strip()]
            self.exposures = [1.0] * len(self.files)

        n = len(self.files)
        if len(self.timestamps) < n:
            self.timestamps = list(np.arange(n) / 30.0)
        if len(self.exposures) < n:
            self.exposures = [1.0] * n

    # --- calibration ------------------------------------------------------
    def _load_geometric(self, calib_path: Optional[str]) -> Optional[CameraModel]:
        cands = []
        if calib_path:
            cands.append(calib_path)
        cands += [
            os.path.join(self.path, "camera.txt"),
            os.path.join(self.path, "calib.txt"),
            os.path.join(self.path, "camera.yaml"),
        ]
        for c in cands:
            if c and os.path.exists(c):
                if c.endswith((".yaml", ".yml")):
                    return parse_opencv_yaml(c)
                return parse_camera_txt(c)
        return None

    def _load_photometric(self) -> PhotometricCalib:
        gamma = None
        inv_vig = None
        pcalib = os.path.join(self.path, "pcalib.txt")
        if os.path.exists(pcalib):
            with open(pcalib) as f:
                vals = np.array([float(x) for x in f.read().split()], np.float64)
            if len(vals) == 256:
                # normalize to 0..255 like the reference
                # (photometricUndistorter.cpp:56-76)
                vals = vals * (255.0 / vals[-1])
                gamma = vals.astype(np.float32)
        vig_png = os.path.join(self.path, "vignette.png")
        if os.path.exists(vig_png):
            import cv2

            v = cv2.imread(vig_png, cv2.IMREAD_UNCHANGED).astype(np.float32)
            v = v / np.max(v)
            inv_vig = 1.0 / np.maximum(v, 1e-3)
        return PhotometricCalib(gamma=gamma, inv_vignette=inv_vig)

    # --- frames -----------------------------------------------------------
    def __len__(self):
        return len(self.files)

    def close(self):
        """Close the images.zip archive, if the sequence is zipped."""
        if self._zip is not None:
            self._zip.close()
            self._zip = None

    def get_raw(self, i: int) -> FrameData:
        if self._zip is not None:
            buf = self._zip.read(self.files[i])
        else:
            with open(self.files[i], "rb") as f:
                buf = f.read()
        return FrameData(
            image=_decode_gray(buf),
            timestamp=self.timestamps[i],
            exposure=self.exposures[i],
            id=i,
        )
