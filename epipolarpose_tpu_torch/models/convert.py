"""Weight bridge: the JAX package's Flax variables -> this port's state_dict.

Counterpart of the JAX package's ``models/torch_convert.py::
export_state_dict``: takes ``{'params': ..., 'batch_stats': ...}`` with
numpy (or array-like) leaves and returns a state_dict of float32 tensors
keyed by the reference PyTorch names, which :class:`PoseResNet` loads with
``strict=True``. Conv kernels go HWIO -> OIHW. Deconv kernels go HWIO ->
IOHW *and* flip spatially: torch's ConvTranspose2d correlates, flax's
ConvTranspose convolves. :func:`refiner_from_jax_variables` does the same
for the refinement unit.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(w) -> torch.Tensor:
    """flax HWIO -> torch OIHW."""
    return _t(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _deconv(w) -> torch.Tensor:
    """flax ConvTranspose HWIO (flipped) -> torch ConvTranspose IOHW."""
    return _t(np.transpose(np.asarray(w)[::-1, ::-1], (2, 3, 0, 1)))


def from_jax_variables(variables) -> dict[str, torch.Tensor]:
    """Flax ``{'params', 'batch_stats'}`` -> reference-named state_dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: dict[str, torch.Tensor] = {}

    def bn(p, s, prefix):
        n = np.asarray(p["scale"]).shape[0]
        s = s or {}
        out[f"{prefix}.weight"] = _t(p["scale"])
        out[f"{prefix}.bias"] = _t(p["bias"])
        out[f"{prefix}.running_mean"] = _t(s.get("mean", np.zeros(n)))
        out[f"{prefix}.running_var"] = _t(s.get("var", np.ones(n)))
        out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    blk_re = re.compile(r"^layer(\d+)_(\d+)$")
    dec_re = re.compile(r"^deconv(\d+)$")
    for name, node in params.items():
        if name == "conv1":
            out["conv1.weight"] = _conv(node["kernel"])
        elif name == "bn1":
            bn(node, stats.get("bn1"), "bn1")
        elif name == "final_layer":
            out["final_layer.weight"] = _conv(node["kernel"])
            out["final_layer.bias"] = _t(node["bias"])
        elif blk_re.match(name):
            li, bi = blk_re.match(name).groups()
            blk_stats = stats.get(name, {})
            for sub, val in node.items():
                cm = re.match(r"^Conv_(\d+)$", sub)
                bm = re.match(r"^bn(\d+)$", sub)
                if cm:
                    out[f"layer{li}.{bi}.conv{int(cm.group(1)) + 1}.weight"] \
                        = _conv(val["kernel"])
                elif bm:
                    bn(val, blk_stats.get(sub),
                       f"layer{li}.{bi}.bn{bm.group(1)}")
                elif sub == "downsample_conv":
                    out[f"layer{li}.{bi}.downsample.0.weight"] = \
                        _conv(val["kernel"])
                elif sub == "downsample_bn":
                    bn(val, blk_stats.get(sub), f"layer{li}.{bi}.downsample.1")
                else:
                    raise KeyError(f"unknown block entry {name}/{sub}")
        elif dec_re.match(name):
            stage = int(dec_re.match(name).group(1)) - 1
            out[f"deconv_layers.{3 * stage}.weight"] = _deconv(node["kernel"])
            if "bias" in node:
                out[f"deconv_layers.{3 * stage}.bias"] = _t(node["bias"])
        elif name.startswith("deconv_bn"):
            stage = int(name[len("deconv_bn"):]) - 1
            bn(node, stats.get(name), f"deconv_layers.{3 * stage + 1}")
        else:
            raise KeyError(f"unknown parameter group {name}")
    return out


def refiner_from_jax_variables(variables) -> dict[str, torch.Tensor]:
    """The JAX package's ``PoseRefiner`` variables -> this port's
    :class:`~epipolarpose_tpu_torch.models.refiner.PoseRefiner`
    state_dict. flax ``Dense`` kernels (in, out) become ``Linear`` weights
    (out, in)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: dict[str, torch.Tensor] = {}

    def block(p, s, prefix):
        out[f"{prefix}.linear.weight"] = _t(
            np.asarray(p["Dense_0"]["kernel"]).T)
        out[f"{prefix}.linear.bias"] = _t(p["Dense_0"]["bias"])
        bn, bs = p["BatchNorm_0"], (s or {}).get("BatchNorm_0", {})
        n = np.asarray(bn["scale"]).shape[0]
        out[f"{prefix}.bn.weight"] = _t(bn["scale"])
        out[f"{prefix}.bn.bias"] = _t(bn["bias"])
        out[f"{prefix}.bn.running_mean"] = _t(bs.get("mean", np.zeros(n)))
        out[f"{prefix}.bn.running_var"] = _t(bs.get("var", np.ones(n)))
        out[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0)

    res_re = re.compile(r"^_ResidualBlock_(\d+)$")
    for name, node in params.items():
        if name == "_LinearBlock_0":
            block(node, stats.get(name), "stem")
        elif res_re.match(name):
            i = res_re.match(name).group(1)
            for sub, tag in (("_LinearBlock_0", "a"), ("_LinearBlock_1", "b")):
                block(node[sub], stats.get(name, {}).get(sub),
                      f"blocks.{i}.{tag}")
        elif name == "Dense_0":
            out["head.weight"] = _t(np.asarray(node["kernel"]).T)
            out["head.bias"] = _t(node["bias"])
        else:
            raise KeyError(f"unknown refiner parameter group {name}")
    return out
