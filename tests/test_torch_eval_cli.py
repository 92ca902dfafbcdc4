"""Port parity, the evaluation CLIs: `cli/metrics.py` against the JAX
`metrics.py`, `tools/import_reference_checkpoint.py` against the JAX tool,
`cli/bench.py` and `cli/bench_calib.py` at a tiny size, and the train CLI's
LPIPS line, pose plot, network viewer (`--gui`) and visdom pose plots
(`--vis_pose`) on a toy run (CPU)."""

import http.server
import json
import os
import socket
import threading

import numpy as np
import pytest
import torch

from bags_tpu_torch.cli import bench as bench_cli
from bags_tpu_torch.cli import bench_calib as bench_calib_cli
from bags_tpu_torch.cli import metrics as metrics_cli
from bags_tpu_torch.cli import train as train_cli
from bags_tpu_torch.eval import network_gui
from bags_tpu_torch.tools import import_reference_checkpoint as port_import
from bags_tpu_torch.utils.testing import write_image
from test_data import _write_colmap_scene
from test_torch_vis_gui import _Events, _request
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5      # metrics, port against JAX (relative)


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    """A seeded LPIPS bundle in the npz layout: 3 convs, a pool, 3 taps."""
    rng = np.random.default_rng(0)
    arrays, chans = {}, [3, 8, 8, 16]
    for i in range(3):
        arrays[f"conv{i}_w"] = rng.normal(0, 0.2, (chans[i + 1], chans[i], 3, 3)
                                          ).astype(np.float32)
        arrays[f"conv{i}_b"] = rng.normal(0, 0.01, chans[i + 1]).astype(np.float32)
        arrays[f"tap_{i}"] = np.asarray(i)
        arrays[f"lin{i}_w"] = np.abs(rng.normal(0, 0.1, chans[i + 1])).astype(np.float32)
    arrays["pool_after_0"] = np.asarray(1)
    path = str(tmp_path_factory.mktemp("lpips") / "bundle.npz")
    np.savez(path, **arrays)
    return path


def test_metrics_cli_matches_jax(tmp_path, lpips_npz, monkeypatch):
    import metrics as jax_metrics

    model = tmp_path / "model"
    rng = np.random.default_rng(3)
    for split in ("test", "train"):
        for sub in ("renders", "gt"):
            os.makedirs(model / split / "ours_7" / sub)
        for i in range(2):
            gt = rng.integers(0, 256, (32, 40, 3)).astype(np.uint8)
            noisy = np.clip(gt + rng.normal(0, 12, gt.shape), 0, 255).astype(np.uint8)
            write_image(str(model / split / "ours_7" / "gt" / f"{i:05d}.png"), gt)
            write_image(str(model / split / "ours_7" / "renders" / f"{i:05d}.png"), noisy)

    def run(main, extra):
        main(["-m", str(model)] + extra)
        return [json.loads((model / f).read_text())
                for f in ("results.json", "per_view.json")]

    for weights in (lpips_npz, None):
        if weights:
            monkeypatch.setenv("BAGS_TPU_LPIPS_WEIGHTS", weights)
        else:
            monkeypatch.delenv("BAGS_TPU_LPIPS_WEIGHTS")
        want, got = run(jax_metrics.main, []), run(metrics_cli.main, ["--device", "cpu"])
        for w, g in zip(want, got):
            assert list(g) == list(w) == ["test/ours_7", "train/ours_7"]
            for key in w:
                assert list(g[key]) == list(w[key]) == ["PSNR", "SSIM", "LPIPS"]
                for metric, val in w[key].items():
                    if isinstance(val, str):
                        assert g[key][metric] == val == "n/a (no weights)"
                        assert weights is None and metric == "LPIPS"
                    elif isinstance(val, dict):
                        assert list(g[key][metric]) == list(val)
                        np.testing.assert_allclose(list(g[key][metric].values()),
                                                   list(val.values()), rtol=TOL)
                    else:
                        assert g[key][metric] == pytest.approx(val, rel=TOL)
        if weights:
            assert got[0]["test/ours_7"]["LPIPS"] > 0


def _capture(n_elements, rng, n=40):
    """A reference `gaussians.capture()` at SH degree 1, 12 or 15 elements,
    with an optimizer state dict as the reference's Adam writes it."""
    f = {"xyz": rng.normal(size=(n, 3)), "f_dc": rng.normal(size=(n, 1, 3)),
         "f_rest": rng.normal(size=(n, 3, 3)), "scaling": rng.normal(size=(n, 3)),
         "rotation": rng.normal(size=(n, 4)), "opacity": rng.normal(size=(n, 1))}
    f = {k: torch.tensor(v.astype(np.float32)) for k, v in f.items()}
    opt = {"state": {0: {"step": torch.tensor(7.0), "exp_avg": torch.zeros(n, 3),
                         "exp_avg_sq": torch.zeros(n, 3)}},
           "param_groups": [{"lr": 1.6e-4, "name": "xyz", "params": [0],
                             "betas": (0.9, 0.999), "eps": 1e-15}]}
    stats = [torch.zeros(n), torch.zeros(n, 1), torch.zeros(n, 1)]
    main = [f["f_dc"], f["f_rest"], f["scaling"], f["rotation"], f["opacity"]]
    if n_elements == 12:
        return (1, f["xyz"], *main, *stats, opt, 2.0)
    return (1, f["xyz"], torch.zeros(n, 24), torch.zeros(10), *main,
            torch.zeros(n, 24), *stats, opt, 2.0)


@pytest.mark.parametrize("n_elements", [12, 15])
def test_import_reference_checkpoint_writes_jax_ply(tmp_path, n_elements):
    from tools import import_reference_checkpoint as jax_import

    pth = str(tmp_path / "chkpnt30000.pth")
    torch.save((_capture(n_elements, np.random.default_rng(n_elements)), 30000), pth)
    jax_import.main(["--pth", pth, "--out", str(tmp_path / "jax.ply")])
    port_import.main(["--pth", pth, "--out", str(tmp_path / "port.ply"),
                      "--device", "cpu"])
    want = (tmp_path / "jax.ply").read_bytes()
    assert (tmp_path / "port.ply").read_bytes() == want
    assert b"element vertex 40" in want


def test_bench_prints_its_json_line(capsys):
    line = bench_cli.main(device="cpu", n=300, width=48, height=32, iters=2)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("instances ") and int(out[0].split()[1]) > 0
    assert json.loads(out[-1]) == line
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "precision"]
    assert line["metric"] == "pixels_per_s_fwd_bwd" and line["precision"] == "exact"
    assert line["value"] > 0 and line["unit"] == "pixels/s/chip"
    with pytest.raises(NotImplementedError, match="Queue 1 #14"):
        bench_cli.main(batch_cams=2, device="cpu")


def test_bench_calib_prints_its_json_lines(capsys):
    lines = bench_calib_cli.main(["--device", "cpu", "--n", "300", "--wh", "32",
                                  "--iters", "1"])
    out = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert out == lines
    assert [x["metric"] for x in lines] == ["fisheye_pixels_per_s_fwd_bwd",
                                            "cubemap_pixels_per_s_fwd_bwd"]
    for x in lines:
        assert sorted(x) == ["metric", "precision", "unit", "value", "vs_baseline"]
        assert x["value"] > 0 and x["precision"] == "exact"


def test_train_cli_gui_vis_pose_lpips(tmp_path, lpips_npz, monkeypatch, capsys):
    """Two iterations with --opt_cam, --gui (a viewer client asks for one
    frame), --vis_pose (a visdom server on 127.0.0.1, plots every 2
    iterations) and local LPIPS weights: the LPIPS line, poses_2.png, one
    served frame of the request's size and one POST."""
    root = str(tmp_path / "scene")
    os.makedirs(root)
    _write_colmap_scene(root, n_cams=4)
    server = http.server.HTTPServer(("127.0.0.1", 0), _Events)
    _Events.posts = []
    threading.Thread(target=server.serve_forever, daemon=True).start()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        gui_port = s.getsockname()[1]
    frames = []
    connected = threading.Event()

    def viewer():
        with socket.create_connection(("127.0.0.1", gui_port), timeout=60) as c:
            connected.set()
            c.sendall(_request(np.diag([1.0, -1.0, -1.0, 1.0]), 24, 16))
            buf = b""
            while len(buf) < 24 * 16 * 3 + 4:
                buf += c.recv(65536)
            frames.append(buf[:24 * 16 * 3])

    class GUI(network_gui.NetworkGUI):
        """The viewer connects as soon as the CLI listens."""

        def __init__(self, *args):
            super().__init__(*args)
            client.start()
            assert connected.wait(60)

    client = threading.Thread(target=viewer, daemon=True)
    monkeypatch.setattr(network_gui, "NetworkGUI", GUI)
    monkeypatch.setattr(train_cli, "VIS_POSE_EVERY", 2)
    monkeypatch.setenv("BAGS_TPU_LPIPS_WEIGHTS", lpips_npz)
    model = str(tmp_path / "model")
    try:
        train_cli.main([
            "-s", root, "-m", model, "--device", "cpu", "--iterations", "2",
            "--sh_degree", "1", "--opt_cam", "--r_t_noise", "0.05", "0.05",
            "--test_iterations", "2", "--save_iterations", "9",
            "--checkpoint_iterations", "9", "--gui", "--port", str(gui_port),
            "--vis_pose", "--visdom_server", "127.0.0.1",
            "--visdom_port", str(server.server_address[1])])
    finally:
        server.shutdown()
        server.server_close()
    client.join(timeout=60)
    assert not client.is_alive()
    out = capsys.readouterr().out
    lpips_lines = [s for s in out.splitlines() if "Evaluating" in s]
    assert len(lpips_lines) == 2 and all("LPIPS n/a" not in s for s in lpips_lines)
    assert float(lpips_lines[0].split("LPIPS ")[1]) > 0
    assert os.path.exists(os.path.join(model, "poses_2.png"))
    assert len(frames) == 1 and len(frames[0]) == 24 * 16 * 3
    [(_, post)] = _Events.posts
    assert post["win"] == "poses" and post["layout"]["title"] == "(2)"
    assert [d["name"] for d in post["data"]] == ["optimized", "ground truth"]
