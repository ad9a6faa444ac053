"""Weights from the seed, made on the device in one draw.

One ``torch.randn`` of every float tensor's size together, from a
generator on the device, then scaled in place leaf by leaf: backbone
convolutions He-normal over fan-out, cut at two standard deviations; the
deconvolutions at std ``HEAD_STD``; the final convolution at
``FINAL_STD``; the last batch norm of each residual branch at scale
``RESIDUAL_SCALE``; the other batch norms at scale 1; shifts and running
means 0, running variances 1.

Two choices keep a comparison with the float32 reference well posed, as
a trained network's would be:

- ``RESIDUAL_SCALE`` 0.1, near the zero-scale initialisation of Goyal et
  al. (arXiv:1706.02677), starts the residual branches small. At scale 1
  a random ResNet-50 is chaotic: bfloat16's rounding grows through the
  blocks to 54% of the output volume (56% on an H100, the program and
  a bfloat16 emulation of the reference alike), and fp8's to 83%, so no
  limit tells them apart. At 0.1: 2.8% and 34% (on a CPU, batch 4).
- The published initialisation draws the head at std 0.001, which
  leaves every volume near uniform and every joint at the crop's centre,
  where any decode agrees. ``FINAL_STD`` 0.25 puts the logits at a
  standard deviation of about 3, so the joints land some pixels apart.
  A cell may draw it wider (``final_std`` in its file): at 0.5 a crop's
  joints land tens of pixels apart.

The same seed gives the same tensors to the program (loaded with
``strict=True`` under the reference state-dict names) and to the
reference.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import model as ref_model

HEAD_STD = 0.05
FINAL_STD = 0.25
RESIDUAL_SCALE = 0.1
# std of a unit normal cut to [-2, 2]
_CUT_STD = 0.87962566103423978
# stream numbers of one seed's independent draws
WEIGHTS, TEACHER, DATA, CALIBRATION = 1, 2, 3, 4


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of ``seed`` (any whole
    number; mixed into 63 bits)."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9)
    return torch.Generator(device).manual_seed(mixed % (2 ** 63))


def make(arch: dict, seed: int, stream: int, device,
         final_std: float = FINAL_STD) -> dict:
    """{state-dict name: tensor} of the network ``arch`` describes, its
    final convolution at ``final_std``."""
    lay = ref_model.layout(arch)
    floats = [(n, s, k) for n, s, k in lay if k != "count"]
    sizes = [math.prod(s) for _, s, _ in floats]
    flat = torch.randn(sum(sizes), generator=generator(seed, stream, device),
                       device=device)
    out = {}
    for (name, shape, kind), v in zip(floats, flat.split(sizes)):
        v = v.view(shape)
        if kind == "conv":
            std = math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
            v.clamp_(-2.0, 2.0).mul_(std / _CUT_STD)
        elif kind == "head":
            v.mul_(HEAD_STD)
        elif kind == "final":
            v.mul_(final_std)
        elif kind == "one":
            v.fill_(1.0)
        elif kind == "residual":
            v.fill_(RESIDUAL_SCALE)
        else:
            v.zero_()
        out[name] = v
    for name, shape, kind in lay:
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
    return {name: out[name] for name, _, _ in lay}


@torch.no_grad()
def calibrate_running_stats(params: dict, arch: dict,
                            crops: torch.Tensor) -> None:
    """Set batch norm's running buffers to one train-mode pass's batch
    statistics over ``crops`` (uint8 NHWC), in float32 by the reference,
    so that a network run in eval mode with random weights sees
    normalised activations: for the eval cell's model and the
    self-supervised cell's teacher. ``crops`` are the calibration stream's,
    not the traffic's."""
    from benchmark.reference.integral import normalize
    stats: dict = {}
    # cuDNN's default algorithms: autotuning float32 shapes the program
    # never runs would only lengthen the set-up
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        ref_model.forward(params, normalize(crops), arch, train=True,
                          stats=stats)
    for name, (mean, var) in stats.items():
        params[f"{name}.running_mean"].copy_(mean)
        params[f"{name}.running_var"].copy_(var)
