"""Config system: the reference YAML schema, with ``TPU.*`` kept as keys.

Same schema as the JAX package's config, so every ``experiments/**/*.yaml``
file loads here unchanged: unknown keys raise, nested mappings merge
recursively. ``TPU.*`` keys are accepted; on the GPU among others
``TPU.COMPUTE_DTYPE`` (the forward's autocast dtype), ``TPU.REMAT``
(each backbone block recomputed in the backward), ``TPU.FUSED_STEPS``
(K steps a call of the train and eval steps, one CUDA-graph replay on the
card) and ``TPU.MESH`` (``DATA``: -1 or the number of processes;
``MODEL > 1`` raises) have a meaning; the TPU's compiler settings are
no-ops.
``CUDNN.*`` sets ``torch.backends.cudnn`` as the original PyTorch code did.
"""

from __future__ import annotations

import copy
import os
from typing import Any

import yaml


class ConfigDict(dict):
    """dict with attribute access (EasyDict-alike, but tiny and typed)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _section(**items) -> ConfigDict:
    return ConfigDict(items)


def _default_config() -> ConfigDict:
    c = ConfigDict()
    c.OUTPUT_DIR = "output"
    c.LOG_DIR = "log"
    c.DATA_DIR = ""
    c.GPUS = "0"
    c.WORKERS = 4
    c.PRINT_FREQ = 100
    c.CUDNN = _section(BENCHMARK=True, DETERMINISTIC=False, ENABLED=True)

    c.MODEL = _section(
        NAME="pose_resnet", INIT_WEIGHTS=True, PRETRAINED="",
        NUM_JOINTS=16, IMAGE_SIZE=[256, 256], STYLE="pytorch")   # [w, h]
    c.MODEL.EXTRA = _section(
        TARGET_TYPE="gaussian", HEATMAP_SIZE=[64, 64], SIGMA=2,
        FINAL_CONV_KERNEL=1, DECONV_WITH_BIAS=False, NUM_DECONV_LAYERS=3,
        NUM_DECONV_FILTERS=[256, 256, 256], NUM_DECONV_KERNELS=[4, 4, 4],
        NUM_LAYERS=50,
        DEPTH_DIM=1,            # >1 => volumetric 3D head
        DEPTH_BOUND=1000.0,     # +-mm mapped to z in [-.5, .5)
        AGGRE=False)

    c.LOSS = _section(USE_TARGET_WEIGHT=True, TYPE="JointsMSELoss")

    c.DATASET = _section(
        ROOT="", DATASET="mpii", TRAIN_SET="train", TEST_SET="valid",
        DATA_FORMAT="jpg", HYBRID_JOINTS_TYPE="", SELECT_DATA=False,
        FLIP=True, SCALE_FACTOR=0.25, ROT_FACTOR=30, LABEL_SOURCE="gt",
        NUM_VIEWS=4, SUBSAMPLE=1, MAP_H36M_JOINTS=True)

    c.TRAIN = _section(
        LR_FACTOR=0.1, LR_STEP=[90, 110], LR=0.001, OPTIMIZER="adam",
        MOMENTUM=0.9, WD=0.0001, NESTEROV=False, GAMMA1=0.99, GAMMA2=0.0,
        BEGIN_EPOCH=0, END_EPOCH=140, RESUME=False, CHECKPOINT="",
        BATCH_SIZE=32, SHUFFLE=True)

    c.TEST = _section(
        BATCH_SIZE=32, FLIP_TEST=False, POST_PROCESS=True,
        SHIFT_HEATMAP=True, USE_GT_BBOX=False, MODEL_FILE="")

    c.DEBUG = _section(
        DEBUG=False, SAVE_BATCH_IMAGES_GT=False, SAVE_BATCH_IMAGES_PRED=False,
        SAVE_HEATMAPS_GT=False, SAVE_HEATMAPS_PRED=False)

    # Keys of the JAX package's TPU section, accepted so that the same YAML
    # files load; see the module docstring for the ones read here.
    c.TPU = _section(
        MESH=_section(DATA=-1, MODEL=1),
        COMPUTE_DTYPE="bfloat16", PARAM_DTYPE="float32", REMAT=False,
        DONATE=True, PREFETCH=2, FUSED_STEPS=1, SEED=0, CHECKPOINT_EVERY=0,
        TRIANGULATION=_section(METHOD="fast", CONF_WEIGHT=True),
        SS_CONF_MIN=0.05, SS_CAMERAS="given", SS_BONE_LENGTH_MM=0.0,
        SS_TEACHER_SCALE=1.0, NATIVE_LOADER="auto", LOADER="threads",
        GRAIN_WORKERS=-1, SS_REFINER="")
    return c


config: ConfigDict = _default_config()


def _merge(dst: ConfigDict, src: dict, path: str = "") -> None:
    for k, v in src.items():
        here = f"{path}.{k}" if path else k
        if k not in dst:
            raise KeyError(f"unknown config key: {here}")
        if isinstance(v, dict):
            if not isinstance(dst[k], dict):
                raise TypeError(f"{here}: scalar overridden by mapping")
            _merge(dst[k], v, here)
        else:
            if isinstance(dst[k], dict):
                # an emptied YAML section parses as None: fail here, not
                # with an AttributeError far away at first use
                raise TypeError(f"{here}: mapping overridden by scalar {v!r}")
            dst[k] = v


def _read_yaml(config_file: str | os.PathLike) -> dict:
    with open(config_file) as f:
        return yaml.safe_load(f) or {}


def update_config(config_file: str | os.PathLike) -> ConfigDict:
    """Merge a YAML experiment file into the global ``config`` (in place)."""
    _merge(config, _read_yaml(config_file))
    return config


def reset_config() -> ConfigDict:
    """Restore the global ``config`` to its defaults."""
    config.clear()
    config.update(_default_config())
    return config


def load_config(config_file: str | os.PathLike) -> ConfigDict:
    """Return a fresh merged ConfigDict; the global ``config`` is untouched."""
    cfg = _default_config()
    _merge(cfg, _read_yaml(config_file))
    return cfg


def update_dir(cfg: ConfigDict, model_dir: str | None = None,
               log_dir: str | None = None,
               data_dir: str | None = None) -> None:
    """Rebase the output, log and data directories (the CLIs' ``--modelDir``,
    ``--logDir``, ``--dataDir``). Empty model files stay empty."""
    if model_dir:
        cfg.OUTPUT_DIR = model_dir
    if log_dir:
        cfg.LOG_DIR = log_dir
    if data_dir:
        cfg.DATA_DIR = data_dir
        cfg.DATASET.ROOT = os.path.join(data_dir, cfg.DATASET.ROOT)
        if cfg.TEST.MODEL_FILE:
            cfg.TEST.MODEL_FILE = os.path.join(data_dir, cfg.TEST.MODEL_FILE)
        if cfg.MODEL.PRETRAINED:
            cfg.MODEL.PRETRAINED = os.path.join(data_dir,
                                                cfg.MODEL.PRETRAINED)


def get_model_name(cfg: ConfigDict) -> tuple[str, str]:
    """(name, full_name) of the run, e.g. ``pose_resnet_50`` and
    ``pose_resnet_50_256x256_d64``; the run directory is
    ``<OUTPUT_DIR>/<dataset>/<full_name>/<cfg_name>/``."""
    name = cfg.MODEL.NAME
    extra = cfg.MODEL.EXTRA
    if name not in ("pose_resnet", "pose3d_resnet"):
        raise ValueError(f"unknown model: {cfg.MODEL.NAME}")
    name = f"{cfg.MODEL.NAME}_{extra.NUM_LAYERS}"
    full_name = f"{name}_{cfg.MODEL.IMAGE_SIZE[1]}x{cfg.MODEL.IMAGE_SIZE[0]}"
    if int(extra.get("DEPTH_DIM", 1)) > 1:
        full_name = f"{full_name}_d{extra.DEPTH_DIM}"
    return name, full_name
