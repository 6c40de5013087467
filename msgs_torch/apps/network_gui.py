"""SIBR remote-viewer socket service: port of msgs/apps/network_gui.py.

Serves the stock SIBR_remoteGaussian client from the port's renderer, so it
can connect to a training run (msgs_torch.apps.train without
--disable_gui).

Wire protocol (the reference's gaussian_renderer/network_gui.py):
  in : 4-byte LE length + JSON {resolution_x/y, fov_y, fov_x, z_near,
       z_far, train, shs_python, rot_scale_python, keep_alive,
       scaling_modifier, view_matrix (16 floats),
       view_projection_matrix (16 floats)}
  out: H*W*3 raw RGB bytes, then 4-byte LE length + source_path string.
  The camera takes the view matrix with its Y and Z columns negated and
  the view-projection matrix with its Y column negated.

One connection per process: the listener and the connection are module
globals (`_listener`, `conn`, `addr`), as in the JAX module.
"""
from __future__ import annotations

import json
import socket
import struct
import traceback
from typing import Optional

import numpy as np
import torch

_listener: Optional[socket.socket] = None
conn: Optional[socket.socket] = None
addr = None


def init(wish_host: str = "127.0.0.1", wish_port: int = 6009):
    global _listener
    _listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    _listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    _listener.bind((wish_host, wish_port))
    _listener.listen()
    _listener.settimeout(0)


def try_connect():
    global conn, addr
    if _listener is None:
        return
    try:
        conn, addr = _listener.accept()
        print(f"\nConnected by {addr}")
        conn.settimeout(None)
    except OSError:
        pass    # no client waiting (the listener does not block)


def _read_bytes(n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = conn.recv(n - len(out))
        if not chunk:
            raise ConnectionError("client closed")
        out += chunk
    return out


def receive(device=None):
    """One client request. Returns six values: (camera or None,
    do_training, shs_python, rot_scale_python, keep_alive,
    scaling_modifier). The camera's tensors are on `device` (None: the
    CUDA device); there is no camera when the request's resolution is 0."""
    from msgs_torch.core.camera import make_camera_from_matrices

    msg_len = struct.unpack("I", _read_bytes(4))[0]
    msg = json.loads(_read_bytes(msg_len).decode("utf-8"))
    width = msg["resolution_x"]
    height = msg["resolution_y"]
    cam = None
    if width != 0 and height != 0:
        fovy = msg["fov_y"]
        fovx = msg["fov_x"]
        wvt = np.reshape(msg["view_matrix"], (4, 4))
        wvt[:, 1] = -wvt[:, 1]
        wvt[:, 2] = -wvt[:, 2]
        fpt = np.reshape(msg["view_projection_matrix"], (4, 4))
        fpt[:, 1] = -fpt[:, 1]
        cam = make_camera_from_matrices(wvt, fpt, fovx, fovy, width, height,
                                        device=device)
    return (cam, msg["train"], msg["shs_python"], msg["rot_scale_python"],
            msg["keep_alive"], msg["scaling_modifier"])


def send(image_bytes: Optional[bytes], source_path: str):
    if image_bytes is not None:
        conn.sendall(image_bytes)
    enc = source_path.encode("ascii")
    conn.sendall(struct.pack("I", len(enc)))
    conn.sendall(enc)


def disconnect():
    global conn
    if conn is not None:
        try:
            conn.close()
        except OSError:
            pass
    conn = None


def frame_bytes(img) -> bytes:
    """The wire form of an (H, W, 3) image in [0, 1], a tensor on any
    device or an array: clipped, scaled by 255 and truncated to uint8."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    arr = np.clip(np.asarray(img), 0, 1)
    return (arr * 255).astype(np.uint8).tobytes()


def serve_step(render_fn, source_path: str, keep_alive_training: bool,
               device=None) -> bool:
    """One head-of-iteration GUI pump: accept a waiting client, then answer
    its requests with render_fn(camera, scaling_modifier) → (H, W, 3) image
    in [0, 1]. Cameras are built on `device` (None: the CUDA device).
    Returns True once the client asks for training to go on; False when no
    client is connected or the connection failed (then it is closed)."""
    if conn is None:
        try_connect()
    while conn is not None:
        try:
            cam, do_training, _, _, keep_alive, scale_mod = receive(device)
            img_bytes = None
            if cam is not None:
                img_bytes = memoryview(frame_bytes(render_fn(cam, scale_mod)))
            send(img_bytes, source_path)
            if do_training and (not keep_alive or keep_alive_training):
                return True
        except Exception:
            traceback.print_exc()
            disconnect()
            return False
    return False
