"""The port's copy of the fixture configs (``metalhuffman_tpu_torch/utils/
fixtures.py``) against the JAX package's: the same names, and every config
renders the same array."""

import numpy as np
import pytest
import torch

from metalhuffman_tpu.utils import fixtures as jfx
from metalhuffman_tpu_torch.utils import fixtures as tfx

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

UNKNOWN = "no_such_config"
PATH = "path=bridge_512x512.png"


@pytest.mark.parametrize("name", [*sorted(jfx.CONFIGS), UNKNOWN, PATH])
def test_render_frame_matches_the_jax_package(name):
    assert tfx.CONFIGS.keys() == jfx.CONFIGS.keys()
    assert tfx.SMALL_CONFIGS == jfx.SMALL_CONFIGS
    assert tfx.LARGE_CONFIGS == jfx.LARGE_CONFIGS
    if name == UNKNOWN:
        with pytest.raises(ValueError, match="unknown config"):
            jfx.render_frame(name)
        with pytest.raises(ValueError, match="unknown config"):
            tfx.render_frame(name)
        return
    if name == PATH:
        path = str(jfx.asset_path("bridge_512x512.png"))
        assert tfx.asset_path("bridge_512x512.png") == jfx.asset_path(
            "bridge_512x512.png")
        want, got = (jfx.render_frame("", path=path),
                     tfx.render_frame("", path=path))
    else:
        want, got = jfx.render_frame(name), tfx.render_frame(name)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_photo_is_the_bridge_config():
    assert tfx.PHOTO == tfx.asset_path("bridge_2048x1536.png")
    np.testing.assert_array_equal(tfx.photo(), jfx.render_frame("bridge"))
    with pytest.raises(FileNotFoundError, match="no_such.png"):
        tfx.asset_path("no_such.png")
