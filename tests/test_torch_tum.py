"""TUM RGB-D sequences in the port (datasets/tum.py and its PNG codec,
datasets/png.py) against the reference's cv2 reader and writer, and a TUM
directory through the port's runner and command line on the CPU.

Tolerances: the uint16 depth images equal on both sides, in every
direction; depths read back equal the written uint16 / 5000 bit for bit;
ground-truth poses equal to the reference's bit for bit (the same float64
numpy); the run through the port's runner within 1e-5 m and 1e-5 rad a
frame of the reference's run on the same directory (as
tests/test_torch_rgbd.py).
"""

import contextlib
import io
import json
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from test_torch_rgbd import _assert_poses_agree, _cfg
from tpu_icp_slam.datasets import synthetic as jsyn
from tpu_icp_slam.datasets import tum as jtum
from tpu_icp_slam.slam import runner as jrunner
from tpu_icp_slam_torch import cli
from tpu_icp_slam_torch.datasets import png, tum
from tpu_icp_slam_torch.slam import runner as trunner


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _depth_image(seed=0, h=48, w=64):
    """A depth image as TUM stores it: the synthetic scene at 5000 per
    metre, a block of invalid (0) pixels, and random full-range words so
    every byte value and carry occurs."""
    depths, _, _ = jsyn.rgbd_log(n_frames=2, seed=seed,
                                 K=jsyn.Intrinsics.tum_default(w, h))
    img = np.clip(depths[1] * tum.DEPTH_FACTOR, 0, 65535).astype(np.uint16)
    rng = np.random.default_rng(seed)
    img[: h // 4, : w // 4] = 0
    img[-4:] = rng.integers(0, 65536, (4, w), dtype=np.uint16)
    return img


def _png_with_filters(path, img, types):
    """A 16-bit greyscale PNG of img whose row r is filtered with
    types[r]."""
    h, w = img.shape
    png._write(path, w, h, 16, 0, png.filter_rows(img, types))


@pytest.mark.parametrize("types", ["none", "sub", "up", "average", "paeth",
                                   "cycle", "paeth_average", "random"])
def test_every_row_filter_read_by_cv2_and_the_port(tmp_path, types):
    """Each of the five row filters alone, and mixed row by row as
    libpng's adaptive writers mix them: cv2 (the reference's reader) and
    the port's decoder read back the same uint16 image."""
    img = _depth_image(seed=1)
    h = img.shape[0]
    rng = np.random.default_rng(7)
    t = {"cycle": np.arange(h) % 5, "paeth_average": 3 + np.arange(h) % 2,
         "random": rng.integers(0, 5, h)}.get(types)
    if t is None:
        t = np.full(h, png.FILTERS.index(types))
    path = str(tmp_path / f"{types}.png")
    _png_with_filters(path, img, t)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert back.dtype == np.uint16
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(png.read_gray16(path), img)


def test_port_writer_read_by_cv2(tmp_path):
    img = _depth_image()
    path = str(tmp_path / "up.png")
    png.write_gray16(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  img)
    np.testing.assert_array_equal(png.read_gray16(path), img)


def test_decoder_reads_cv2_files(tmp_path):
    """cv2's own files (its filter choice, 640x480 included)."""
    for shape, seed in (((48, 64), 2), ((480, 640), 3)):
        img = _depth_image(seed=seed, h=shape[0], w=shape[1])
        path = str(tmp_path / f"cv2_{shape[1]}.png")
        assert cv2.imwrite(path, img)
        np.testing.assert_array_equal(png.read_gray16(path), img)


def _write_raw(path, ihdr, raw, crc_ok=True):
    chunk = png._chunk(b"IHDR", struct.pack(">IIBBBBB", *ihdr))
    if not crc_ok:
        chunk = chunk[:-1] + bytes([chunk[-1] ^ 1])
    with open(path, "wb") as fh:
        fh.write(png._SIGNATURE + chunk
                 + png._chunk(b"IDAT", zlib.compress(raw))
                 + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("case", ["interlaced", "rgb", "8bit", "bad_crc",
                                  "short", "bad_filter", "not_png",
                                  "cut_stream"])
def test_decoder_raises_on_what_it_does_not_read(tmp_path, case):
    path = str(tmp_path / "x.png")
    w, h = 4, 3
    raw = bytes(h * (1 + 2 * w))
    ihdr = {"interlaced": (w, h, 16, 0, 0, 0, 1), "rgb": (w, h, 16, 2, 0, 0, 0),
            "8bit": (w, h, 8, 0, 0, 0, 0)}.get(case, (w, h, 16, 0, 0, 0, 0))
    if case == "short":
        raw = raw[:-1]
    if case == "bad_filter":
        raw = b"\x05" + raw[1:]
    _write_raw(path, ihdr, raw, crc_ok=case != "bad_crc")
    if case == "not_png":
        with open(path, "r+b") as fh:
            fh.write(b"GIF8")
    if case == "cut_stream":  # a valid chunk holding half a zlib stream
        idat = zlib.compress(raw)
        with open(path, "wb") as fh:
            fh.write(png._SIGNATURE + png._chunk(b"IHDR", struct.pack(
                ">IIBBBBB", *ihdr)) + png._chunk(b"IDAT", idat[:len(idat) // 2])
                + png._chunk(b"IEND", b""))
    with pytest.raises(ValueError):
        png.read_gray16(path)
    with pytest.raises(ValueError):
        png.write_gray16(path, np.zeros((2, 2), np.float32))


def test_sequences_cross_both_ways(tmp_path):
    depths, poses, _ = jsyn.rgbd_log(
        n_frames=3, K=jsyn.Intrinsics.tum_default(64, 48))
    # the reference's writer (cv2) read by the port
    jtum.write_sequence(str(tmp_path / "ref"), depths, gt_poses=poses)
    a = tum.load_sequence(str(tmp_path / "ref"))
    b = jtum.load_sequence(str(tmp_path / "ref"))
    np.testing.assert_array_equal(a.depths, b.depths)
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    np.testing.assert_array_equal(a.gt_poses, b.gt_poses)
    assert a.intrinsics == b.intrinsics == (517.3, 516.5, 318.6, 255.3)
    # the port's writer read by the reference (cv2)
    tum.write_sequence(str(tmp_path / "port"), depths, gt_poses=poses)
    c = jtum.load_sequence(str(tmp_path / "port"))
    np.testing.assert_array_equal(c.depths, b.depths)
    np.testing.assert_array_equal(c.gt_poses, b.gt_poses)
    for name in ("depth.txt", "groundtruth.txt"):
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "ref" / name).read_text())
    # read back: exactly the written uint16 / 5000
    img = np.clip(depths * tum.DEPTH_FACTOR, 0, 65535).astype(np.uint16)
    np.testing.assert_array_equal(tum.load_sequence(str(tmp_path / "port"))
                                  .depths, img / tum.DEPTH_FACTOR)
    assert tum.load_sequence(str(tmp_path / "port"), max_frames=2).depths \
        .shape == (2, 48, 64)


def test_ground_truth_association(tmp_path):
    """groundtruth.txt at its own rate and clock offset, with comments:
    each depth frame takes the nearest stamp, as in the reference."""
    depths, _, _ = jsyn.rgbd_log(n_frames=4,
                                 K=jsyn.Intrinsics.tum_default(64, 48))
    stamps = 1305031102.175304 + np.array([0.0, 0.031, 0.070, 0.098])
    tum.write_sequence(str(tmp_path), depths, timestamps=stamps)
    rng = np.random.default_rng(5)
    gt_t = 1305031102.16 + np.arange(60) * 0.0101
    q = rng.standard_normal((60, 4))
    lines = ["# ground truth trajectory", "# timestamp tx ty tz qx qy qz qw"]
    lines += [" ".join(f"{v:.4f}" for v in (t, *rng.uniform(-1, 1, 3), *qq))
              for t, qq in zip(gt_t, q)]
    (tmp_path / "groundtruth.txt").write_text("\n".join(lines) + "\n\n")
    a = tum.load_sequence(str(tmp_path))
    b = jtum.load_sequence(str(tmp_path))
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    np.testing.assert_array_equal(a.gt_poses, b.gt_poses)
    np.testing.assert_allclose(a.gt_poses[:, :3, :3]
                               @ np.swapaxes(a.gt_poses[:, :3, :3], 1, 2),
                               np.broadcast_to(np.eye(3), (4, 3, 3)),
                               atol=1e-12)


def test_tum_dir_through_runner_and_cli(tmp_path):
    """A 640x480 log (fr1's sensor grid, the one its intrinsics fit)
    written as a TUM directory: load_dataset, run_slam at
    rgbd_src_stride=2 against the reference's run on the same directory,
    then `cli run` and `cli eval` on the CPU. A smaller image is read with
    fr1's intrinsics all the same, as in the reference."""
    depths, poses, _ = jsyn.rgbd_log(
        n_frames=4, K=jsyn.Intrinsics.tum_default(640, 480))
    root = str(tmp_path / "fr1_sim")
    tum.write_sequence(root, depths, gt_poses=poses)
    data = trunner.load_dataset(root, 4)
    ref = jrunner.load_dataset(root, 4)
    assert (data.kind, data.name, data.intrinsics) == (
        ref.kind, ref.name, ref.intrinsics) == (
        "rgbd", "fr1_sim", (517.3, 516.5, 318.6, 255.3, 640, 480))
    np.testing.assert_array_equal(data.depths, ref.depths)
    np.testing.assert_array_equal(data.gt_poses, ref.gt_poses)
    cfg, tcfg = _cfg(rgbd_src_stride=2)
    jposes, jrep = jrunner.run_slam(cfg, ref)
    tposes, trep = trunner.run_slam(tcfg, data, device="cpu")
    _assert_poses_agree(tposes, jposes)
    assert list(trep) == list(jrep)
    assert trep["ate_rmse"] < 0.03
    args = ["--dataset", root, "--frames", "4", "--device", "cpu",
            "icp.max_corr_dist=0.15", "icp.max_iters=15",
            "pipeline.rgbd_src_stride=2"]
    out = tmp_path / "out"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["run", "--out", str(out), *args,
                         "icp.method=point_to_plane"]) == 0
    rep = json.loads(buf.getvalue())
    assert rep["dataset"] == "fr1_sim" and rep["frames"] == 4
    np.testing.assert_array_equal(
        np.load(out / "trajectory.npz")["poses"], tposes)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["eval", *args]) == 0
    ev = json.loads(buf.getvalue())
    assert set(ev) == {"dataset", "frames", "mode", "tpu_ate"}, ev
    assert ev["tpu_ate"] == rep["ate_rmse"]
    small = tmp_path / "small"
    tum.write_sequence(str(small), depths[:2, ::4, ::4])
    assert trunner.load_dataset(str(small), 2).intrinsics == \
        jrunner.load_dataset(str(small), 2).intrinsics == (
            517.3, 516.5, 318.6, 255.3, 160, 120)
