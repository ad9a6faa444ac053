"""The traffic generator: a mix file's parameters and a seed -> a pool of
batches on the device, cycled by the window.

A mix (``traffic/<mix>.json``) is data. Its ``kind`` names the maker of
its batches, ``traffic/<kind>.py``, found by name as a metric's reader
is (:meth:`benchmark.spec.Spec.generator`), with two functions:

- ``pool(mix, arch, g, device) -> list[dict]``: the mix's batches, made
  on ``device`` from the generator ``g``;
- ``samples_per_batch(mix) -> int``.

Every batch of a pool has the same shapes, so each step does the same
work whatever the seed; the seed changes the pixels, the labels, the
poses and the crops' boxes. The crops are seeded uint8 noise: a
convolution's work does not depend on its pixels. This module holds what
the makers share.
"""

from __future__ import annotations

import torch


def uniform(g, shape, lo, hi, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def crops(g, shape, device) -> torch.Tensor:
    return torch.randint(0, 256, shape, generator=g, device=device,
                         dtype=torch.uint8)
