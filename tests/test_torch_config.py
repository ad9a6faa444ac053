"""The port's config loads every experiment file to the JAX package's dict."""

import pathlib

import pytest

from epipolarpose_tpu.config import load_config as jax_load_config
from epipolarpose_tpu_torch import config as tconfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXPERIMENTS = sorted(ROOT.glob("experiments/**/*.yaml"))


def _plain(d):
    return {k: _plain(v) if isinstance(v, dict) else v for k, v in d.items()}


def test_all_experiment_files_are_listed():
    assert len(EXPERIMENTS) == 17


@pytest.mark.parametrize("path", EXPERIMENTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_experiment_loads_like_jax(path):
    assert _plain(tconfig.load_config(path)) == _plain(jax_load_config(path))


def test_defaults_match_jax():
    from epipolarpose_tpu.config import _default_config
    assert _plain(tconfig._default_config()) == _plain(_default_config())


def test_unknown_key_rejected(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("MODEL:\n  NOT_A_KEY: 1\n")
    with pytest.raises(KeyError, match="MODEL.NOT_A_KEY"):
        tconfig.load_config(p)
    p.write_text("MODEL: 3\n")
    with pytest.raises(TypeError):
        tconfig.load_config(p)


def test_update_and_reset_global_config():
    path = ROOT / "experiments/h36m/valid_r50_256_integral.yaml"
    try:
        cfg = tconfig.update_config(path)
        assert cfg is tconfig.config
        assert cfg.MODEL.EXTRA.DEPTH_DIM == 64 and cfg.TEST.FLIP_TEST
        fresh = tconfig.load_config(path)
        assert fresh is not tconfig.config
    finally:
        tconfig.reset_config()
    assert tconfig.config.MODEL.EXTRA.DEPTH_DIM == 1
