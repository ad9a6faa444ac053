"""H36M camera model in float32 torch: projection, undistortion, frames.

Counterpart of the JAX package's ``geometry/camera.py``, with the same
conventions:

- World -> camera: ``X_cam = R @ (X_world - T)``; R is the world-to-camera
  rotation, T the camera centre in world coordinates (the H36M release).
- Intrinsics: focal ``f = (fx, fy)``, principal point ``c = (cx, cy)``.
- Distortion: radial (k1, k2, k3) and tangential (p1, p2) in the H36M
  ``project_point_radial`` form (its tangential term is not OpenCV's).

The JAX code runs its contractions at ``Precision.HIGHEST``. Here every
product is written out as elementwise float32 multiplies and sums, never a
matmul, so ``torch.backends.cuda.matmul.allow_tf32`` cannot change a result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_FIELDS = ("R", "T", "f", "c", "k", "p")


@dataclasses.dataclass
class Camera:
    """Per-camera parameters as float32 tensors; every field broadcasts
    over leading batch dims.

    R: (..., 3, 3) world -> camera rotation; T: (..., 3) camera centre in
    the world; f: (..., 2); c: (..., 2); k: (..., 3) radial;
    p: (..., 2) tangential.
    """

    R: torch.Tensor
    T: torch.Tensor
    f: torch.Tensor
    c: torch.Tensor
    k: torch.Tensor
    p: torch.Tensor

    @classmethod
    def from_arrays(cls, cam=None, device=None, **fields) -> "Camera":
        """A camera from numpy arrays (or anything ``np.asarray`` takes):
        the six fields of ``cam`` (any object with attributes R, T, f, c,
        k, p, such as the JAX package's ``Camera``), or keyword fields."""
        if cam is not None:
            fields = {n: getattr(cam, n) for n in _FIELDS}
        return cls(**{n: torch.as_tensor(np.asarray(fields[n], np.float32),
                                         device=device) for n in _FIELDS})

    @classmethod
    def stack(cls, cams, dim: int = 0) -> "Camera":
        """Stack cameras of one batch shape along a new dim."""
        return cls(**{n: torch.stack([getattr(c, n) for c in cams], dim)
                      for n in _FIELDS})

    @staticmethod
    def identity(batch_shape=(), device=None) -> "Camera":
        bs = tuple(batch_shape)
        kw = dict(dtype=torch.float32, device=device)
        return Camera(R=torch.eye(3, **kw).expand(bs + (3, 3)).clone(),
                      T=torch.zeros(bs + (3,), **kw),
                      f=torch.ones(bs + (2,), **kw),
                      c=torch.zeros(bs + (2,), **kw),
                      k=torch.zeros(bs + (3,), **kw),
                      p=torch.zeros(bs + (2,), **kw))

    def replace(self, **fields) -> "Camera":
        return dataclasses.replace(self, **fields)

    def to(self, device) -> "Camera":
        return Camera(**{n: getattr(self, n).to(device, torch.float32)
                         for n in _FIELDS})

    def map(self, fn) -> "Camera":
        """Apply ``fn`` to every field (reshape, index, ...)."""
        return Camera(**{n: fn(getattr(self, n)) for n in _FIELDS})

    @property
    def K(self) -> torch.Tensor:
        """(..., 3, 3) intrinsic matrix."""
        fx, fy = self.f[..., 0], self.f[..., 1]
        cx, cy = self.c[..., 0], self.c[..., 1]
        z, o = torch.zeros_like(fx), torch.ones_like(fx)
        return torch.stack([torch.stack([fx, z, cx], -1),
                            torch.stack([z, fy, cy], -1),
                            torch.stack([z, z, o], -1)], -2)

    @property
    def P(self) -> torch.Tensor:
        """(..., 3, 4) projection matrix K [R | -R T] (pinhole part)."""
        t = -(self.R * self.T[..., None, :]).sum(-1)
        rt = torch.cat([self.R, t[..., None]], dim=-1)
        return (self.K[..., :, :, None] * rt[..., None, :, :]).sum(-2)


def world_to_camera_frame(points: torch.Tensor, cam: Camera) -> torch.Tensor:
    """(..., N, 3) world points -> the camera frame."""
    d = points - cam.T[..., None, :]
    return (cam.R[..., None, :, :] * d[..., :, None, :]).sum(-1)


def camera_to_world_frame(points: torch.Tensor, cam: Camera) -> torch.Tensor:
    """Inverse of :func:`world_to_camera_frame`."""
    rt = cam.R.transpose(-1, -2)
    return ((rt[..., None, :, :] * points[..., :, None, :]).sum(-1)
            + cam.T[..., None, :])


def _distort(xx: torch.Tensor, k: torch.Tensor,
             p: torch.Tensor) -> torch.Tensor:
    """Radial and tangential distortion of normalized coords (..., N, 2)."""
    x, y = xx[..., 0], xx[..., 1]
    r2 = x * x + y * y
    radial = (1.0 + k[..., 0:1] * r2 + k[..., 1:2] * r2 * r2
              + k[..., 2:3] * r2 * r2 * r2)
    tan = p[..., 0:1] * y + p[..., 1:2] * x
    x_d = x * (radial + tan) + p[..., 1:2] * r2
    y_d = y * (radial + tan) + p[..., 0:1] * r2
    return torch.stack([x_d, y_d], dim=-1)


def project_point_radial(points: torch.Tensor, cam: Camera
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """World points (..., N, 3) -> (distorted pixels (..., N, 2), camera
    depth (..., N))."""
    x = world_to_camera_frame(points, cam)
    d = x[..., 2]
    xx = x[..., :2] / d[..., None]
    return cam.f[..., None, :] * _distort(xx, cam.k, cam.p) \
        + cam.c[..., None, :], d


def undistort_points(pixels: torch.Tensor, cam: Camera,
                     iters: int = 5) -> torch.Tensor:
    """Distorted pixels (..., N, 2) -> ideal pinhole pixels, by ``iters``
    fixed-point steps ``x = (obs - q r^2) / (radial + tan)`` evaluated at
    the current estimate."""
    obs = (pixels - cam.c[..., None, :]) / cam.f[..., None, :]
    k, p = cam.k, cam.p
    x = obs
    for _ in range(iters):
        xx, yy = x[..., 0], x[..., 1]
        r2 = xx * xx + yy * yy
        radial = (1.0 + k[..., 0:1] * r2 + k[..., 1:2] * r2 * r2
                  + k[..., 2:3] * r2 * r2 * r2)
        tan = p[..., 0:1] * yy + p[..., 1:2] * xx
        qx = p[..., 1:2] * r2
        qy = p[..., 0:1] * r2
        x = torch.stack([(obs[..., 0] - qx) / (radial + tan),
                         (obs[..., 1] - qy) / (radial + tan)], dim=-1)
    return x * cam.f[..., None, :] + cam.c[..., None, :]


def normalized_camera_coords(pixels: torch.Tensor,
                             cam: Camera) -> torch.Tensor:
    """Pixels -> normalized (K^-1) coords, no distortion handling."""
    return (pixels - cam.c[..., None, :]) / cam.f[..., None, :]


def pixel2cam(pixels: torch.Tensor, depth: torch.Tensor,
              cam: Camera) -> torch.Tensor:
    """Ideal pixels (..., N, 2) and absolute camera depth (..., N) ->
    camera-frame points (..., N, 3)."""
    xy = normalized_camera_coords(pixels, cam) * depth[..., None]
    return torch.cat([xy, depth[..., None]], dim=-1)
