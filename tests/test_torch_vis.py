"""The port's debug images (``utils/vis.py``) and float warp against the JAX
package and OpenCV.

- ``_to_uint8`` gives the JAX function's bits on uint8, [0, 1] and
  ImageNet-normalized batches.
- The joint grid and the heatmap strip have the JAX grid's geometry: with
  no joint visible the grid is the JAX grid's bits (captured from its
  ``cv2.imwrite``); drawn joints change pixels only near the joints; the
  heatmap strip's tiles sit where JAX puts them (the thumbnails within
  one grey level: the port's resize is ``resize_bilinear_u8``).
- PNG files decode through ``cv2.imread`` to the same bits; a bad CRC is
  refused; the JET table is within one grey level of OpenCV's.
- The ``DEBUG.*`` gates follow ``tests/test_vis_refine.py``.
- ``warp_affine_f32`` against ``cv2.warpAffine(float32, INTER_LINEAR)``:
  within 1e-5 on the ``tests/test_warp.py`` crops (equal there in fact);
  on 20 random warps of noise, equal bits but in OpenCV's scalar tail
  (the last W mod 16 columns), there within 3e-5.
"""

import pathlib

import cv2
import numpy as np
import pytest

import epipolarpose_tpu.utils.vis as jvis
from epipolarpose_tpu.geometry import get_affine_transform
from epipolarpose_tpu_torch.config import load_config
from epipolarpose_tpu_torch.data.imgproc import warp_affine_f32
from epipolarpose_tpu_torch.utils import vis

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def jax_written(monkeypatch):
    """The arrays the JAX functions hand to ``cv2.imwrite``, as RGB."""
    written = {}

    def imwrite(name, img):
        written[name] = img[..., ::-1].copy()
        return True
    monkeypatch.setattr(cv2, "imwrite", imwrite)
    return written


@pytest.mark.parametrize("kind", ["uint8", "unit", "normalized", "bright"])
def test_to_uint8_matches_jax(kind, rng):
    imgs = rng.uniform(0, 1, (3, 8, 8, 3)).astype(np.float32)
    if kind == "uint8":
        imgs = (imgs * 255).astype(np.uint8)
    elif kind == "normalized":
        imgs = (imgs - vis.IMAGENET_MEAN) / vis.IMAGENET_STD
    elif kind == "bright":             # normalized, min about -0.37
        imgs = (0.4 + 0.6 * imgs - vis.IMAGENET_MEAN) / vis.IMAGENET_STD
    got = vis._to_uint8(imgs)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jvis._to_uint8(imgs))


@pytest.mark.parametrize("n,nrow", [(4, 8), (5, 2), (9, 4)])
def test_joint_grid_geometry_matches_jax(n, nrow, rng, tmp_path,
                                         jax_written):
    imgs = rng.uniform(0, 1, (n, 24, 20, 3)).astype(np.float32)
    joints = rng.uniform(3, 17, (n, 5, 2)).astype(np.float32)
    for vis_value in (0.0, 1.0):
        visible = np.full((n, 5), vis_value, np.float32)
        path = str(tmp_path / f"grid{vis_value}.png")
        vis.save_batch_image_with_joints(imgs, joints, visible, path,
                                         nrow=nrow)
        jvis.save_batch_image_with_joints(imgs, joints, visible, "j.jpg",
                                          nrow=nrow)
        got, want = vis.read_png(path), jax_written["j.jpg"]
        assert got.shape == want.shape
        if vis_value == 0.0:
            np.testing.assert_array_equal(got, want)
        else:
            # each joint is a disc of radius 3 in the port, cv2's ring of
            # radius 2 and thickness 2 in JAX: pixels differ only near one
            H, W = 24 + 2, 20 + 2
            yy, xx = np.nonzero((got != want).any(-1))
            near = np.zeros(len(yy), bool)
            for k in range(n):
                r, c = divmod(k, min(nrow, n))
                for x, y in joints[k]:
                    near |= ((np.abs(xx - (c * W + x)) <= 4)
                             & (np.abs(yy - (r * H + y)) <= 4))
            assert near.all()
            red = (got == [255, 0, 0]).all(-1)
            assert red.sum() >= n * 5


def test_heatmap_strip_matches_jax(rng, tmp_path, jax_written):
    imgs = rng.integers(0, 256, (2, 32, 32, 3), np.uint8)
    hms = rng.uniform(0, 1, (2, 3, 8, 8)).astype(np.float32)   # NCHW
    path = str(tmp_path / "hm.png")
    vis.save_batch_heatmaps(imgs, hms, path)
    jvis.save_batch_heatmaps(imgs, hms.transpose(0, 2, 3, 1), "j.jpg")
    got, want = vis.read_png(path), jax_written["j.jpg"]
    assert got.shape == want.shape == (2 * 8, 4 * 8, 3)
    # thumbnails within one grey level; blended tiles within two
    thumbs = np.concatenate([got[:8, :8], got[8:, :8]]).astype(int)
    jthumbs = np.concatenate([want[:8, :8], want[8:, :8]]).astype(int)
    assert np.abs(thumbs - jthumbs).max() <= 1
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 2


def test_jet_table_within_one_level_of_opencv():
    v = np.arange(256, dtype=np.uint8)
    want = cv2.applyColorMap(v[:, None], cv2.COLORMAP_JET)[:, 0, ::-1]
    got = vis.jet_colors(v)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("shape", [(5, 7, 3), (6, 9)])
def test_png_round_trips_through_opencv(shape, rng, tmp_path):
    img = rng.integers(0, 256, shape, np.uint8)
    path = str(tmp_path / "a.png")
    vis.write_png(path, img)
    np.testing.assert_array_equal(vis.read_png(path), img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back[..., ::-1] if img.ndim == 3 else back,
                                  img)


def test_png_reader_refuses_a_bad_crc(tmp_path):
    path = tmp_path / "a.png"
    vis.write_png(str(path), np.zeros((4, 4, 3), np.uint8))
    data = bytearray(path.read_bytes())
    data[-20] ^= 0xFF                       # inside the IDAT chunk
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        vis.read_png(str(path))


def test_save_debug_images_gated(tmp_path, rng):
    cfg = load_config(ROOT / "experiments/debug/synth_smoke.yaml")
    batch = {
        "input": rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32),
        "joints": rng.uniform(2, 30, (2, 4, 2)).astype(np.float32),
        "joints_vis": np.ones((2, 4), np.float32),
    }
    prefix = str(tmp_path / "dbg")
    vis.save_debug_images(cfg, batch, None, None, None, prefix)
    assert not list(tmp_path.iterdir())
    cfg.DEBUG.DEBUG = True
    cfg.DEBUG.SAVE_BATCH_IMAGES_GT = True
    vis.save_debug_images(cfg, batch, None, None, None, prefix)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["dbg_gt.png"]
    cfg.DEBUG.SAVE_BATCH_IMAGES_PRED = True
    cfg.DEBUG.SAVE_HEATMAPS_GT = cfg.DEBUG.SAVE_HEATMAPS_PRED = True
    hms = rng.uniform(0, 1, (2, 4, 8, 8)).astype(np.float32)
    vis.save_debug_images(cfg, batch, hms, hms, batch["joints"], prefix)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "dbg_gt.png", "dbg_hm_gt.png", "dbg_hm_pred.png", "dbg_pred.png"]


def test_plot_3d_skeleton_draws_two_panels(tmp_path, rng):
    pose = rng.standard_normal((17, 3)).astype(np.float32) * 100
    path = str(tmp_path / "skel.png")
    vis.plot_3d_skeleton(pose, path)
    img = vis.read_png(path)
    assert img.shape == (256, 512, 3)
    blue = (img == [0, 0, 255]).all(-1)
    assert blue[:, :255].any() and blue[:, 257:].any()


@pytest.mark.parametrize("rot", [0.0, 15.0, -40.0])
def test_warp_affine_f32_matches_cv2_crop(rot, rng):
    img = rng.uniform(0, 255, (480, 640, 3)).astype(np.float32)
    img = cv2.GaussianBlur(img, (0, 0), 2.0)
    center = np.array([320.0, 240.0], np.float32)
    scale = np.array([1.1, 1.1], np.float32)
    M = np.asarray(get_affine_transform(center, scale, rot, (256, 256)))
    want = cv2.warpAffine(img, M, (256, 256), flags=cv2.INTER_LINEAR)
    got = warp_affine_f32(img, M, (256, 256))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_warp_affine_f32_random_warps_match_cv2(channels):
    """20 random warps of [0, 1] noise: equal bits but in OpenCV's scalar
    tail (the last W mod 16 columns, where it rounds otherwise), there
    within 3e-5. (Two-channel images take OpenCV's older fixed-point path,
    which neither warp reproduces.)"""
    rng = np.random.default_rng(5)
    for _ in range(20):
        h, w = rng.integers(20, 200, 2)
        img = rng.uniform(0, 1, (h, w, channels)).astype(np.float32)
        M = np.array([[rng.uniform(0.5, 2), rng.uniform(-0.5, 0.5),
                       rng.uniform(-20, 20)],
                      [rng.uniform(-0.5, 0.5), rng.uniform(0.5, 2),
                       rng.uniform(-20, 20)]])
        W, H = (int(v) for v in rng.integers(10, 150, 2))
        want = cv2.warpAffine(img, M, (W, H), flags=cv2.INTER_LINEAR)
        got = warp_affine_f32(img, M, (W, H))
        want = want.reshape(got.shape)
        tail = W - W % 16
        np.testing.assert_array_equal(got[:, :tail], want[:, :tail])
        np.testing.assert_allclose(got[:, tail:], want[:, tail:], rtol=0,
                                   atol=3e-5)
    with pytest.raises(TypeError):
        warp_affine_f32(np.zeros((4, 4, 3), np.uint8), np.eye(2, 3), (4, 4))
