"""The port's configuration (``sparkfm_tpu_torch/config.py``) against the
JAX package's: every dataclass and enum field for field (names, order,
defaults), and the public names of ``sparkfm_tpu/__init__.py`` exported
by the port too."""

import dataclasses

import pytest

import sparkfm_tpu
import sparkfm_tpu_torch
from sparkfm_tpu import config as JC
from sparkfm_tpu_torch import config as PC


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        default = (f.default_factory() if f.default_factory
                   is not dataclasses.MISSING else f.default)
        if dataclasses.is_dataclass(default):
            default = dataclasses.asdict(default)
        elif hasattr(default, "value"):
            default = default.value
        out.append((f.name, default))
    return out


@pytest.mark.parametrize("name", ["FMConfig", "SGDConfig", "ALSConfig",
                                  "MCMCConfig", "MeshConfig",
                                  "TrainConfig"])
def test_dataclass_fields_match_jax(name):
    pcls, jcls = getattr(PC, name), getattr(JC, name)
    assert _fields(pcls) == _fields(jcls)
    assert pcls.__dataclass_params__.frozen == jcls.__dataclass_params__.frozen


@pytest.mark.parametrize("name", ["Task", "Solver"])
def test_enums_match_jax(name):
    assert ([(m.name, m.value) for m in getattr(PC, name)]
            == [(m.name, m.value) for m in getattr(JC, name)])


def test_public_names_cover_the_jax_package():
    missing = sorted(set(sparkfm_tpu.__all__) - set(sparkfm_tpu_torch.__all__))
    assert missing == []
    cfg = sparkfm_tpu_torch.TrainConfig(fm=PC.FMConfig(num_features=10))
    assert cfg.solver is PC.Solver.SGD and cfg.mesh == PC.MeshConfig()
