"""Port geometry vs the JAX package's geometry/affine.py (float32).

Tolerances: both sides solve the same 3x3 systems in float32 with
different LAPACK paths, so affines agree to ~1e-4 relative at pixel scale.
"""

import numpy as np
import pytest
import torch

from epipolarpose_tpu.data.h36m import FLIP_PAIRS as H36M_FLIP_PAIRS
from epipolarpose_tpu.geometry import affine as jaff
from epipolarpose_tpu_torch.geometry import affine as taff



@pytest.mark.parametrize("inv", [False, True])
def test_get_affine_transform(rng, inv):
    center = rng.uniform(100, 900, (5, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (5, 2)).astype(np.float32)
    rot = rng.uniform(-30, 30, (5,)).astype(np.float32)
    want = np.asarray(jaff.get_affine_transform(center, scale, rot,
                                                (256, 192), inv=inv))
    got = taff.get_affine_transform(torch.from_numpy(center),
                                    torch.from_numpy(scale),
                                    torch.from_numpy(rot), (256, 192),
                                    inv=inv).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_transform_preds(rng):
    coords = rng.uniform(0, 256, (4, 17, 2)).astype(np.float32)
    center = rng.uniform(100, 900, (4, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (4, 2)).astype(np.float32)
    want = np.asarray(jaff.transform_preds(coords, center, scale, (256, 256)))
    got = taff.transform_preds(torch.from_numpy(coords),
                               torch.from_numpy(center),
                               torch.from_numpy(scale), (256, 256)).numpy()
    # source pixels up to ~1000: 1e-3 px is ~1e-6 relative
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("depth_dim", [1, 4])
def test_flip_back_volume_and_shift(rng, depth_dim):
    j, h, w = 17, 6, 8
    nhwc = rng.standard_normal((2, h, w, j * depth_dim)).astype(np.float32)
    want = np.asarray(jaff.flip_back_volume(nhwc, H36M_FLIP_PAIRS, j,
                                            depth_dim))
    # JAX's SHIFT_HEATMAP: out_f.at[:, :, 1:, :].set(out_f[:, :, :-1, :])
    want_shift = want.copy()
    want_shift[:, :, 1:, :] = want[:, :, :-1, :]
    nchw = torch.from_numpy(nhwc).permute(0, 3, 1, 2).contiguous()
    got = taff.flip_back_volume(nchw, H36M_FLIP_PAIRS, j, depth_dim)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    got_shift = taff.shift_right(got)
    np.testing.assert_array_equal(got_shift.permute(0, 2, 3, 1).numpy(),
                                  want_shift)


def test_flip_back_heatmaps(rng):
    nhwc = rng.standard_normal((2, 5, 7, 16)).astype(np.float32)
    pairs = ((0, 5), (1, 4), (2, 3))
    want = np.asarray(jaff.flip_back(nhwc, pairs))
    got = taff.flip_back(torch.from_numpy(nhwc).permute(0, 3, 1, 2), pairs)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_affine_transform_points(rng):
    m = rng.standard_normal((3, 2, 3)).astype(np.float32)
    pts = rng.standard_normal((3, 2)).astype(np.float32)
    want = np.asarray(jaff.affine_transform(pts, m))
    got = taff.affine_transform(torch.from_numpy(pts),
                                torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
