"""COLMAP reconstruction parsers (binary + text), pure numpy.

The port's own copy of `bags_tpu/data/colmap.py` (importing that module
would import JAX through `bags_tpu/__init__.py`). Reads
`cameras.bin/images.bin/points3D.bin` and the text variants as written by
COLMAP (formats defined by colmap/src/base/reconstruction.cc): records are
decoded with `struct` against the documented layouts, with vectorized numpy
for the bulk arrays.

Conventions: qvec is (w, x, y, z) for the world-to-camera rotation; tvec is
the world-to-camera translation.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Tuple

import numpy as np

# model_id -> (name, num_params); COLMAP's fixed camera-model table
# (colmap_loader.py:24-40).
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray   # (4,) w2c rotation (w, x, y, z)
    tvec: np.ndarray   # (3,) w2c translation
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Eigen-decomposition method (colmap_loader.py:57-66 semantics).
    Note COLMAP's variable naming follows row-major flat order: 'Ryx' is
    R[0,1], not R[1,0]."""
    (Rxx, Ryx, Rzx,
     Rxy, Ryy, Rzy,
     Rxz, Ryz, Rzz) = R.flatten()
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def _unpack(fid, fmt: str):
    size = struct.calcsize("<" + fmt)
    return struct.unpack("<" + fmt, fid.read(size))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _unpack(f, "Q")
        for _ in range(n):
            cam_id, model_id, width, height = _unpack(f, "iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_unpack(f, "d" * num_params))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height),
                                        params)
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _unpack(f, "Q")
        for _ in range(n):
            vals = _unpack(f, "idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name_bytes = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name_bytes += c
            (n2d,) = _unpack(f, "Q")
            rec = np.frombuffer(f.read(24 * n2d),
                                dtype=[("x", "<f8"), ("y", "<f8"),
                                       ("id", "<i8")])
            xys = np.stack([rec["x"], rec["y"]], axis=-1) if n2d \
                else np.zeros((0, 2))
            images[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id,
                name_bytes.decode("utf-8"), xys, rec["id"].copy())
    return images


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (xyz (N,3), rgb (N,3) uint8-valued, error (N,1))."""
    with open(path, "rb") as f:
        (n,) = _unpack(f, "Q")
        xyzs = np.empty((n, 3))
        rgbs = np.empty((n, 3))
        errs = np.empty((n, 1))
        for i in range(n):
            vals = _unpack(f, "QdddBBBd")
            xyzs[i] = vals[1:4]
            rgbs[i] = vals[4:7]
            errs[i] = vals[7]
            (track_len,) = _unpack(f, "Q")
            f.seek(8 * track_len, 1)
    return xyzs, rgbs, errs


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cams[int(el[0])] = ColmapCamera(
                int(el[0]), el[1], int(el[2]), int(el[3]),
                np.array([float(x) for x in el[4:]]))
    return cams


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f
                 if l.strip() and not l.strip().startswith("#")]
    for meta, pts in zip(lines[0::2], lines[1::2]):
        el = meta.split()
        image_id = int(el[0])
        qvec = np.array([float(x) for x in el[1:5]])
        tvec = np.array([float(x) for x in el[5:8]])
        camera_id = int(el[8])
        name = el[9]
        pe = pts.split()
        xys = np.array([float(x) for x in pe]).reshape(-1, 3)[:, :2] \
            if pe else np.zeros((0, 2))
        ids = np.array([int(x) for x in pe[2::3]]) if pe else np.zeros(0, int)
        images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name,
                                       xys, ids)
    return images


def read_points3d_text(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            xyzs.append([float(x) for x in el[1:4]])
            rgbs.append([int(x) for x in el[4:7]])
            errs.append([float(el[7])])
    return np.array(xyzs), np.array(rgbs), np.array(errs)


# --- writers (for convert-style tooling and tests) -------------------------

def write_cameras_binary(path: str, cams: Dict[int, ColmapCamera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = MODEL_NAME_TO_ID[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def write_images_binary(path: str, images: Dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n2d = len(im.xys)
            f.write(struct.pack("<Q", n2d))
            for (x, y), pid in zip(im.xys, im.point3d_ids):
                f.write(struct.pack("<ddq", x, y, int(pid)))


def write_points3d_binary(path: str, xyz: np.ndarray, rgb: np.ndarray,
                          err: np.ndarray | None = None) -> None:
    err = err if err is not None else np.zeros((len(xyz), 1))
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<QdddBBBd", i, *xyz[i],
                                *rgb[i].astype(np.uint8), float(err[i][0])))
            f.write(struct.pack("<Q", 0))
