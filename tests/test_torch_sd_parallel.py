"""Stable Diffusion on several devices of one host (the port's
models/sd/sd.py `place_components` and `shard_for_mesh`), the cases of
tests/test_sd.py:340-465, against the port's single-device generator
(itself held to JAX's images by tests/test_torch_sd_generate.py) on the
CPU, at f32 and tiny_sd_config: components placed by a topology over
mesh positions, the UNet's batch over a ("dp",) mesh of 2 and 4
positions and a two-sample batch over 4; one seed, the same noise."""

import numpy as np
import pytest

import torch

from cake_tpu_torch.args import ImageGenerationArgs
from cake_tpu_torch.models.sd import config as tcfg
from cake_tpu_torch.models.sd.image import decode_png
from cake_tpu_torch.parallel.mesh import make_mesh
from cake_tpu_torch.topology import Topology

from test_torch_sd_generate import _port_gen, _port_params


@pytest.fixture(scope="module")
def tiny():
    cfg = tcfg.tiny_sd_config()
    return cfg, _port_params(cfg)


def _images(gen, **kw):
    out = []
    gen.generate_image(ImageGenerationArgs(
        image_prompt="a robot", sd_n_steps=2, sd_num_samples=1, sd_seed=7,
        sd_guidance_scale=7.5, **kw),
        lambda pngs: out.extend(decode_png(p) for p in pngs))
    return out


def test_sd_component_placement_across_devices(tiny, tmp_path):
    """clip, unet and vae on three positions named by a topology file:
    the single-device image, exactly."""
    cfg, params = tiny
    want = _images(_port_gen(cfg, params))
    topo = tmp_path / "sd_topo.yml"
    topo.write_text(
        "enc:\n  host: 10.0.0.1:10128\n  description: clip\n"
        "  devices: [1]\n  layers:\n    - clip\n"
        "gpu:\n  host: 10.0.0.2:10128\n  description: unet\n"
        "  devices: [2]\n  layers:\n    - unet\n"
        "dec:\n  host: 10.0.0.3:10128\n  description: vae\n"
        "  devices: [3]\n  layers:\n    - vae\n")
    gen = _port_gen(cfg, params)
    gen.place_components(Topology.from_path(str(topo)),
                         devices=["cpu"] * 4)
    assert set(gen._devices) == {"clip", "unet", "vae"}
    got = _images(gen)
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sd_mesh_matches_single_device(tiny, n_dev):
    """The guidance pair over 2 and 4 dp positions: the single-device
    image, exactly."""
    cfg, params = tiny
    want = _images(_port_gen(cfg, params))
    gen = _port_gen(cfg, params)
    gen.shard_for_mesh(make_mesh(dp=n_dev, device_type="cpu"))
    assert len(gen.unet_runner.replicas) == n_dev
    got = _images(gen)
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0], want[0])


def test_sd_mesh_multi_sample_batch(tiny):
    """Two samples (four UNet rows) over 4 positions: every sample within
    one u8 level of the unsharded run (a row alone rounds its
    convolutions apart from a batch of four)."""
    cfg, params = tiny
    want = _images(_port_gen(cfg, params), sd_bsize=2)
    gen = _port_gen(cfg, params)
    gen.shard_for_mesh(make_mesh(dp=4, device_type="cpu"))
    got = _images(gen, sd_bsize=2)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


def test_context_dp_mesh_and_its_refusals(tiny, tmp_path, monkeypatch):
    """--dp through Context.load_image_model shards the UNet batch; with
    an SD component topology it is refused, as in JAX."""
    from cake_tpu_torch.args import Args, ModelType, SDArgs
    from cake_tpu_torch.context import Context
    from cake_tpu_torch.models.sd import sd as tsd
    cfg, params = tiny
    monkeypatch.setattr(tsd, "get_sd_config", lambda *a, **k: cfg)
    ctx = Context.from_args(Args(model_type=ModelType.IMAGE, cpu=True,
                                 dp=2), SDArgs(sd_use_f16=False))
    gen = ctx.load_image_model()
    assert len(gen.unet_runner.replicas) == 2
    topo = tmp_path / "t.yml"
    topo.write_text("g:\n  layers:\n    - unet\n")
    ctx = Context.from_args(Args(model_type=ModelType.IMAGE, cpu=True, dp=2,
                                 topology=str(topo)),
                            SDArgs(sd_use_f16=False))
    with pytest.raises(ValueError, match="mutually exclusive"):
        ctx.load_image_model()
    assert torch.device("cpu") in gen._devices.values()
