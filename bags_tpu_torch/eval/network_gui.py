"""SIBR remote-viewer bridge over non-blocking TCP (port of
`bags_tpu/eval/network_gui.py`).

The reference's wire protocol: in, a 4-byte little-endian length and a JSON
camera request (resolution, FoVs, z range, flags, the row-major view and
view-projection matrices with SIBR's y / z column flips); out, the raw RGB
bytes of the frame, then a 4-byte length and the verify string. Polled
once per training iteration without blocking.

One difference from the JAX package: `poll` drops the connection only on
the connection's own errors (a socket error, a closed peer, a malformed
request). A failure of the render itself, a kernel fault among them,
raises to the caller, where the JAX package drops the viewer silently.
"""

from __future__ import annotations

import json
import socket
from typing import Callable, Optional, Tuple

import numpy as np
import torch


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    def close(self) -> None:
        self._drop()
        self.listener.close()

    def _drop(self) -> None:
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def try_connect(self) -> None:
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
        except OSError:           # no viewer waiting (BlockingIOError)
            pass

    def _read(self) -> dict:
        n = int.from_bytes(self.conn.recv(4), "little")
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                break
            buf += chunk
        return json.loads(buf.decode("utf-8"))

    def send(self, image_bytes: Optional[bytes], verify: str) -> None:
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def receive(self) -> Tuple[Optional[dict], bool, bool, bool, bool, float]:
        msg = self._read()
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None, False, False, False, False, 1.0
        view = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        # SIBR sends OpenGL-style axes: flip the y / z columns
        view[:, 1] *= -1
        view[:, 2] *= -1
        req = dict(width=width, height=height,
                   fovx=float(msg["fov_x"]), fovy=float(msg["fov_y"]),
                   znear=float(msg["z_near"]), zfar=float(msg["z_far"]),
                   view_matrix=view)
        return (req, bool(msg["train"]), bool(msg["shs_python"]),
                bool(msg["rot_scale_python"]), bool(msg["keep_alive"]),
                float(msg["scaling_modifier"]))

    def poll(self, render_fn: Callable[[dict], torch.Tensor], verify: str,
             training_done: bool) -> None:
        """One per-iteration poll: accept a waiting viewer, then serve its
        frames until it asks training to go on (after training, with
        keep_alive, until it disconnects). render_fn(request) gives a
        (3, H, W) image in [0, 1]; its errors propagate."""
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                req, do_training, _, _, keep_alive, _ = self.receive()
            except (OSError, ValueError, KeyError):
                # closed or broken connection, or a malformed request
                # (json's JSONDecodeError is a ValueError)
                self._drop()
                return
            image_bytes = None
            if req is not None:
                img = torch.clamp(render_fn(req).detach(), 0, 1).cpu().numpy()
                image_bytes = ((img * 255).astype(np.uint8)
                               .transpose(1, 2, 0).tobytes())
            try:
                self.send(image_bytes, verify)
            except OSError:
                self._drop()
                return
            if do_training and (not training_done or not keep_alive):
                break


def request_to_camera(req: dict, device=None):
    """Viewer request -> (CameraParams, CameraStatic) for render()."""
    from ..core.camera import CameraParams, CameraStatic

    w2c = req["view_matrix"].T    # the request's is transposed (row-vector)
    cam = CameraParams.create(w2c[:3, :3], w2c[:3, 3], req["fovx"],
                              req["fovy"], device=device)
    static = CameraStatic(width=req["width"], height=req["height"],
                          znear=req["znear"], zfar=req["zfar"])
    return cam, static
