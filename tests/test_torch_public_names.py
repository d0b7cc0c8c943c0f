"""The port's copies of four public names of the JAX package, each held
against the JAX name on the same inputs: ``configs.all_configs``,
``configs.cifar_cnn.CONFIG``, ``sharding.logical_to_mesh_spec``
(exported from ``repro_torch.sharding``) and ``layers.conv.avg_pool``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as jax_all_configs
from repro.configs.cifar_cnn import CONFIG as JAX_CNN_CONFIG
from repro.layers.conv import avg_pool as jax_avg_pool
from repro.sharding import axes as jax_axes
from repro.sharding import logical_to_mesh_spec as jax_logical_to_mesh_spec
from repro_torch import sharding
from repro_torch.configs import ARCH_IDS, all_configs
from repro_torch.configs.cifar_cnn import CONFIG as CNN_CONFIG
from repro_torch.layers.conv import avg_pool
from repro_torch.sharding import axes

RULES = ("LOGICAL_RULES_MEGATRON", "LOGICAL_RULES_GATHER",
         "LOGICAL_RULES_FSDP", "LOGICAL_RULES_ZERO1")


def _fields(cfg) -> dict:
    """A config's fields, nested dataclasses flattened to dicts."""
    return dataclasses.asdict(cfg)


def test_all_configs_equal_jax():
    ours, theirs = all_configs(), jax_all_configs()
    assert list(ours) == list(theirs) == ARCH_IDS
    for arch in ARCH_IDS:
        assert type(ours[arch]).__name__ == type(theirs[arch]).__name__
        assert _fields(ours[arch]) == _fields(theirs[arch]), arch


def test_cifar_cnn_config_is_the_headline_net():
    assert CNN_CONFIG.arch_id == "cifar_cnn_500_1500"
    assert vars(CNN_CONFIG) == vars(JAX_CNN_CONFIG)


# every logical axis any rule table names, plus None and an unknown name
_LOGICAL = sorted({a for r in RULES for a in getattr(jax_axes, r).rules}) + [None, "no-such-axis"]


@pytest.mark.parametrize("rules", RULES)
def test_logical_to_mesh_spec_equals_jax(rules):
    ours, theirs = getattr(axes, rules), getattr(jax_axes, rules)
    assert sharding.logical_to_mesh_spec is axes.logical_to_mesh_spec
    for i, a in enumerate(_LOGICAL):
        for b in _LOGICAL[i:] + [None]:
            if a is not None and a == b:
                continue  # an axis named twice in one spec is refused by both
            got = sharding.logical_to_mesh_spec(ours, (a, b))
            want = jax_logical_to_mesh_spec(theirs, (a, b))
            assert tuple(got) == tuple(want), (rules, a, b)


@pytest.mark.parametrize("window,stride,shape", [
    (2, 2, (2, 8, 8, 3)),     # the paper's pool geometry
    (3, 2, (1, 9, 7, 4)),     # overlapping windows, ragged VALID edge
    (2, 1, (3, 5, 6, 2)),
])
def test_avg_pool_equals_jax(window, stride, shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = avg_pool(torch.from_numpy(x), window, stride).numpy()
    want = np.asarray(jax_avg_pool(jnp.asarray(x), window, stride))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
