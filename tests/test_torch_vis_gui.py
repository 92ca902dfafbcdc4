"""Port parity, pose plots and the network viewer: `eval/vis.py` and
`eval/network_gui.py` against the JAX package's, with a visdom server and a
SIBR viewer client on 127.0.0.1."""

import http.server
import json
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bags_tpu.core.camera import CameraParams as JCameraParams
from bags_tpu.eval import network_gui as jgui
from bags_tpu.eval import vis as jvis
from bags_tpu_torch.core.camera import CameraParams
from bags_tpu_torch.eval import network_gui as pgui
from bags_tpu_torch.eval import vis as pvis
from bags_tpu_torch.raster.render import RenderConfig, render
from bags_tpu_torch.utils.testing import make_toy_scene
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-6      # frustum coordinates, float32 poses


@pytest.fixture(scope="module")
def cams():
    """The same 4 cameras (and 4 perturbed 'GT' ones) in both packages."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(7)
    out = {}
    for name in ("pred", "gt"):
        R = Rotation.from_rotvec(rng.normal(0, 0.4, (4, 3))).as_matrix().astype(np.float32)
        t = rng.normal(0, 1.0, (4, 3)).astype(np.float32)
        out[name] = (
            CameraParams.stack([CameraParams.create(R[i], t[i], 0.9, 0.8, device="cpu")
                                for i in range(4)]),
            jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[
                JCameraParams.create(R[i], t[i], 0.9, 0.8) for i in range(4)]))
    return out


def _close(a, b):
    """Equal structure, numbers within TOL."""
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, float) and not isinstance(b, str):
        assert a == pytest.approx(b, abs=TOL)
    else:
        assert a == b


def test_frusta_and_plotly_match_jax(cams):
    R = np.diag([1.0, -1.0, -1.0])
    t = np.array([0.3, -0.2, 1.5])
    np.testing.assert_array_equal(pvis.camera_frustum_points(R, t, 0.2),
                                  jvis.camera_frustum_points(R, t, 0.2))
    got = pvis.poses_to_plotly(cams["pred"][0], cams["gt"][0], scale=0.15)
    want = jvis.poses_to_plotly(cams["pred"][1], cams["gt"][1], scale=0.15)
    _close(got, want)
    assert len(got["data"][0]["x"]) == 4 * 17


class _Events(http.server.BaseHTTPRequestHandler):
    posts = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        type(self).posts.append((self.path, json.loads(body)))
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b"ok")

    def log_message(self, *args):
        pass


@pytest.fixture
def visdom_server():
    _Events.posts = []
    server = http.server.HTTPServer(("127.0.0.1", 0), _Events)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server.server_address[1], _Events.posts
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_visdom_client_posts_jax_payload(cams, visdom_server):
    port, posts = visdom_server
    assert pvis.VisdomClient("127.0.0.1", port).plot_cameras(
        500, cams["pred"][0], cams["gt"][0])
    assert jvis.VisdomClient("127.0.0.1", port).plot_cameras(
        500, cams["pred"][1], cams["gt"][1])
    assert [p for p, _ in posts] == ["/events", "/events"]
    _close(posts[0][1], posts[1][1])
    assert posts[0][1]["opts"]["title"] == "main poses (500)"


def test_visdom_client_reports_a_dead_server(cams):
    with socket.socket() as s:           # a port with nothing listening
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    client = pvis.VisdomClient("127.0.0.1", port, timeout=0.5)
    assert not client.plot_cameras(1, cams["pred"][0]) and not client.ok


def test_plot_poses_writes_a_png(cams, tmp_path):
    path = str(tmp_path / "poses.png")
    pvis.plot_poses(cams["pred"][0], cams["gt"][0], path=path)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_vector_field_figure_matches_jax(tmp_path):
    """The lens-residual quiver: the same RGBA image as JAX's, and its PNG."""
    res = np.random.default_rng(2).normal(0, 1e-5, (1, 2, 40, 30))
    got = pvis.vector_field_figure(res, grid=5)
    np.testing.assert_array_equal(got, jvis.vector_field_figure(res, grid=5))
    assert got.ndim == 3 and got.shape[-1] == 4
    path = str(tmp_path / "field.png")
    pvis.log_vector_field(None, res, 3, path=path)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def _request(view, width=40, height=32):
    msg = dict(resolution_x=width, resolution_y=height, train=True, fov_x=0.9,
               fov_y=0.8, z_near=0.01, z_far=100.0, shs_python=False,
               rot_scale_python=False, keep_alive=False, scaling_modifier=1.0,
               view_matrix=view.reshape(-1).tolist(),
               view_projection_matrix=np.eye(4).reshape(-1).tolist())
    data = json.dumps(msg).encode()
    return len(data).to_bytes(4, "little") + data


def _recv(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "viewer connection closed early"
        buf += chunk
    return buf


# a view matrix as SIBR sends it: transposed w2c with the y / z columns
# flipped, camera at the origin looking at the toy scene along +z
VIEW = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
VIEW[3, :3] = [0.05, -0.02, 0.1]


def test_viewer_round_trip(tmp_path):
    """One SIBR request over 127.0.0.1: the served bytes are the port's
    render at `request_to_camera`'s camera, and the camera is JAX's."""
    sc = make_toy_scene(n=300, width=40, height=32, sh_degree=1, seed=3, device="cpu")
    args = [sc[k] for k in ("xyz", "scales", "quats", "opacity", "sh_coeffs")]
    gui = pgui.NetworkGUI("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]
    reqs = []

    def render_fn(req):
        reqs.append(req)
        cam, static = pgui.request_to_camera(req, "cpu")
        return render(*args, cam, static, RenderConfig(sh_degree=1)).render

    with socket.create_connection(("127.0.0.1", port), timeout=10) as client:
        client.sendall(_request(VIEW))
        gui.poll(render_fn, "scene", training_done=False)
        frame = _recv(client, 40 * 32 * 3)
        n = int.from_bytes(_recv(client, 4), "little")
        assert _recv(client, n) == b"scene"
    gui.poll(render_fn, "scene", training_done=False)  # the closed viewer
    assert gui.conn is None
    gui.close()

    [req] = reqs
    cam, static = pgui.request_to_camera(req, "cpu")
    jcam, jstatic = jgui.request_to_camera(req)
    assert (static.width, static.height, static.znear, static.zfar) == \
        (jstatic.width, jstatic.height, jstatic.znear, jstatic.zfar)
    for f in ("q_init", "t_init", "dq", "dt", "fovx", "fovy"):
        np.testing.assert_allclose(getattr(cam, f).numpy(), np.asarray(getattr(jcam, f)),
                                   atol=TOL)
    img = render(*args, cam, static, RenderConfig(sh_degree=1)).render
    want = (np.clip(img.numpy(), 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
    assert frame == want.tobytes()
    assert want.mean() > 5, "nothing in view"


def test_viewer_render_error_propagates():
    """A render that raises inside `poll` reaches the caller (the JAX
    package drops the viewer there)."""
    gui = pgui.NetworkGUI("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]

    def broken(req):
        raise RuntimeError("kernel fault")

    with socket.create_connection(("127.0.0.1", port), timeout=10) as client:
        client.sendall(_request(VIEW))
        with pytest.raises(RuntimeError, match="kernel fault"):
            gui.poll(broken, "scene", training_done=False)
    gui.close()
