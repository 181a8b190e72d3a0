"""The port's Stable Diffusion generator end to end against the JAX
package's, on the CPU at f32.

The two packages draw their noise differently (JAX from threefry keys,
the port from a `torch.Generator` seeded with `sd_seed`), so these
tests feed both sides the same numpy noise: JAX's `jax.random.normal`
and the port's `SDGenerator._noise` are replaced by one queue of
numpy-seeded draws, in the order both generators draw (the VAE
posterior's noise of img2img first, then each sample's latents). With
the same trees (drawn by the port's init and carried to JAX):

  * txt2img (guidance 7.5: the doubled batch), img2img at strength 0.5
    (a PIL-written PNG, resized by the port's Lanczos), strength 0.1 (no
    step left: the clean latents decoded), two samples of batch 2 with
    intermediary images, and an SDXL-shaped turbo config (two encoders,
    Euler, the added condition, no guidance): the u8 images are within
    one level of JAX's;
  * one seed gives one image in the port, another seed another;
  * `/api/v1/image` answers {"images": [base64 PNG]} and the text
    server's route fails as JAX's does; the CLI's `--model-type image`
    writes image_0.png; `--sd-flash-attention` and
    `--sd-sliced-attention-size`, which JAX parses and reads nowhere, are
    refused by argparse; component placement and the --dp mesh exclude
    each other.

The `cuda` cases (the captured UNet step against its eager call; the
card generator against the CPU generator, one seed; a generation under
`torch.cuda.set_sync_debug_mode("error")` but its fetches) skip without
a card:

    python -m pytest --noconftest -m cuda tests/test_torch_sd_generate.py
"""

import base64
import dataclasses
import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch

from cake_tpu_torch.args import ImageGenerationArgs
from cake_tpu_torch.models.sd import config as tcfg
from cake_tpu_torch.models.sd.clip import init_clip_params
from cake_tpu_torch.models.sd.sd import SDGenerator, SimpleClipTokenizer
from cake_tpu_torch.models.sd.unet import init_unet_params
from cake_tpu_torch.models.sd.vae import init_vae_params


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the UNet step replays on CUDA")


def _xl_tiny(cfg_mod, version):
    """tiny_sd_config with SDXL's structure: a second (gelu, projected)
    encoder, the added condition, Euler."""
    base = cfg_mod.tiny_sd_config()
    clip2 = cfg_mod.ClipConfig(vocab_size=1000, hidden_size=32,
                               intermediate_size=64, num_hidden_layers=2,
                               num_attention_heads=2, hidden_act="gelu",
                               projection_dim=32)
    unet = dataclasses.replace(base.unet, cross_attention_dim=96,
                               addition_embed_dim=32 + 6 * 256)
    return dataclasses.replace(base, version=version, clip2=clip2, unet=unet,
                               default_steps=1, default_guidance=0.0)


def _port_params(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = {"clip": init_clip_params(cfg.clip, g),
         "unet": init_unet_params(cfg.unet, g),
         "vae": init_vae_params(cfg.vae, g)}
    if cfg.clip2 is not None:
        p["clip2"] = init_clip_params(cfg.clip2, g)
    return p


def _tokenizers(cfg):
    toks = [SimpleClipTokenizer(cfg.clip.vocab_size)]
    if cfg.clip2 is not None:
        toks.append(SimpleClipTokenizer(cfg.clip2.vocab_size))
    return toks


def _port_gen(cfg, params=None, device="cpu"):
    params = params or _port_params(cfg)
    if device != "cpu":
        params = _to(params, device)
    return SDGenerator(cfg, params, _tokenizers(cfg), torch.float32,
                       device=device)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _jtree(tree):
    import jax.numpy as jnp
    if isinstance(tree, dict):
        return {k: _jtree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jtree(v) for v in tree]
    return jnp.asarray(tree.numpy())


class _NoiseQueue:
    """The same numpy normal draws for both packages, in draw order."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.jax_draws, self.port_draws = [], []

    def _draw(self, draws, shape):
        """The i-th draw of one side: the other side's i-th when it has
        drawn it (the shapes must agree), else a fresh one."""
        i = len(draws)
        other = self.port_draws if draws is self.jax_draws \
            else self.jax_draws
        if i < len(other):
            a = other[i]
            assert a.shape == tuple(shape), (a.shape, shape)
        else:
            a = self.rng.standard_normal(tuple(shape)).astype(np.float32)
        draws.append(a)
        return a

    def jax_normal(self, key, shape, dtype=None):
        import jax.numpy as jnp
        return jnp.asarray(self._draw(self.jax_draws, shape),
                           dtype or jnp.float32)

    def port_noise(self, gen_self, shape, generator):
        return torch.from_numpy(self._draw(self.port_draws, shape).copy()) \
            .to(gen_self.device, gen_self.dtype)


def _jax_images(cfg_t, params, args_dict, noise, version=None):
    """JAX's generate_image over the port's tree, `noise` feeding
    jax.random.normal; decoded u8 images, one list per callback."""
    import jax
    from PIL import Image

    from cake_tpu.args import ImageGenerationArgs as JArgs
    from cake_tpu.args import SDVersion as JV
    from cake_tpu.models.sd import config as jcfg
    from cake_tpu.models.sd import sd as jsd
    from cake_tpu.models.sd.sd import SDGenerator as JGen
    from cake_tpu.models.sd.sd import SimpleClipTokenizer as JTok

    jc = _xl_tiny(jcfg, JV(version)) if version else jcfg.tiny_sd_config()
    toks = [JTok(jc.clip.vocab_size)]
    if jc.clip2 is not None:
        toks.append(JTok(jc.clip2.vocab_size))
    gen = JGen(jc, _jtree(params), toks)
    out = []
    real, real_decode = jax.random.normal, jsd.vae_decode
    jax.random.normal = noise.jax_normal
    # JAX's generator calls its VAE decode eagerly, op by op: jitted, the
    # same function costs one compile a shape instead of a dispatch an op
    # (the file's largest cost under the suite's six workers)
    jsd.vae_decode = _jitted_vae_decode()
    try:
        gen.generate_image(JArgs(**args_dict), lambda pngs: out.append(
            [np.asarray(Image.open(io.BytesIO(p))) for p in pngs]))
    finally:
        jax.random.normal, jsd.vae_decode = real, real_decode
    return out


_JIT: dict = {}


def _jitted_vae_decode():
    """JAX's vae_decode under jax.jit (the VAE config static), one jitted
    function for the whole file so each latent shape compiles once."""
    if "vae_decode" not in _JIT:
        import jax
        from cake_tpu.models.sd import vae as jvae
        _JIT["vae_decode"] = jax.jit(jvae.vae_decode, static_argnums=1)
    return _JIT["vae_decode"]


def _port_images(gen, args_dict, noise, monkeypatch):
    from cake_tpu_torch.models.sd.image import decode_png
    monkeypatch.setattr(SDGenerator, "_noise",
                        lambda self, shape, g: noise.port_noise(self, shape,
                                                                g))
    out = []
    gen.generate_image(ImageGenerationArgs(**args_dict), lambda pngs:
                       out.append([decode_png(p) for p in pngs]))
    return out


def _within_one_level(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.shape == b.shape
            # a real picture, not a saturated or flat one
            assert b.std() > 5 and max((b == 0).mean(),
                                       (b == 255).mean()) < 0.5
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU side on one intra-op thread while this file runs:
    the tiny UNet's ops are too small to share, and with every xdist
    worker's torch spinning a thread per core the suite oversubscribes
    the cores (one_seed's three generations took 50 s there, 0.5 s
    alone). The previous count comes back after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg = tcfg.tiny_sd_config()
    return cfg, _port_params(cfg)


@pytest.fixture
def src_png(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    path = tmp_path / "src.png"
    Image.fromarray(img).save(path)
    return str(path)


# -- against JAX, the same noise -------------------------------------------------


def test_txt2img_is_jaxs(tiny, monkeypatch):
    cfg, params = tiny
    body = dict(image_prompt="a robot", sd_n_steps=2, sd_seed=7,
                sd_guidance_scale=7.5)
    noise = _NoiseQueue(0)
    want = _jax_images(cfg, params, body, noise)
    got = _port_images(_port_gen(cfg, params), body, noise, monkeypatch)
    assert len(got) == 1 and got[0][0].shape == (64, 64, 3)
    _within_one_level(got, want)


@pytest.mark.parametrize("strength,steps", [(0.5, 4), (0.1, 4)])
def test_img2img_is_jaxs(tiny, src_png, monkeypatch, strength, steps):
    """Strength 0.5 runs two of four steps; 0.1 leaves t_start == steps,
    so the noised-to-nothing latents decode clean."""
    cfg, params = tiny
    body = dict(image_prompt="x", sd_img2img=src_png,
                sd_img2img_strength=strength, sd_n_steps=steps, sd_seed=1)
    noise = _NoiseQueue(1)
    want = _jax_images(cfg, params, body, noise)
    got = _port_images(_port_gen(cfg, params), body, noise, monkeypatch)
    assert len(noise.port_draws) == 2          # the posterior, the sample
    _within_one_level(got, want)


def test_batches_samples_and_intermediary_images_are_jaxs(tiny,
                                                          monkeypatch):
    cfg, params = tiny
    body = dict(image_prompt="two robots", image_uncond_prompt="blurry",
                sd_n_steps=5, sd_num_samples=2, sd_bsize=2, sd_seed=3,
                sd_intermediary_images=True)
    noise = _NoiseQueue(2)
    want = _jax_images(cfg, params, body, noise)
    got = _port_images(_port_gen(cfg, params), body, noise, monkeypatch)
    assert len(got) == len(want) > 2 and all(len(g) == 2 for g in got)
    _within_one_level(got, want)


def test_sdxl_shaped_turbo_is_jaxs(monkeypatch):
    cfg = _xl_tiny(tcfg, tcfg.SDVersion.TURBO)
    params = _port_params(cfg, seed=5)
    body = dict(image_prompt="a cat", sd_seed=4)   # 1 Euler step, no CFG
    noise = _NoiseQueue(4)
    want = _jax_images(cfg, params, body, noise, version="turbo")
    got = _port_images(_port_gen(cfg, params), body, noise, monkeypatch)
    _within_one_level(got, want)


# -- the port on its own ---------------------------------------------------------


def test_one_seed_gives_one_image(tiny):
    cfg, params = tiny
    gen = _port_gen(cfg, params)

    def run(seed):
        out = []
        gen.generate_image(ImageGenerationArgs(image_prompt="a robot",
                                               sd_n_steps=2, sd_seed=seed),
                           out.extend)
        return out

    a, b, c = run(11), run(11), run(12)
    assert a == b and a != c


def test_text_embeddings_pad_to_77_and_guidance_doubles(tiny):
    cfg, params = tiny
    gen = _port_gen(cfg, params)
    ctx, added = gen.text_embeddings("a b c", "", use_guidance=True)
    assert tuple(ctx.shape) == (2, 77, cfg.clip.hidden_size) and added is None
    ctx1, _ = gen.text_embeddings("a b c", "", use_guidance=False)
    assert torch.equal(ctx1, ctx[1:])


def test_multi_device_paths_are_refused(tiny):
    """Component placement and the --dp mesh exclude each other (both
    are ported: tests/test_torch_sd_parallel.py)."""
    from cake_tpu_torch.parallel.mesh import make_mesh
    from cake_tpu_torch.topology import Topology
    cfg, params = tiny
    topo = Topology.from_dict({"g": {"layers": ["unet"]}})
    gen = _port_gen(cfg, params)
    gen.shard_for_mesh(make_mesh(dp=2, device_type="cpu"))
    with pytest.raises(ValueError, match="mutually exclusive"):
        gen.place_components(topo, devices=["cpu", "cpu"])
    gen = _port_gen(cfg, params)
    gen.place_components(topo, devices=["cpu"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        gen.shard_for_mesh(make_mesh(dp=2, device_type="cpu"))


def test_non_png_img2img_is_refused(tiny, tmp_path):
    from PIL import Image
    cfg, params = tiny
    jpg = tmp_path / "in.jpg"
    Image.new("RGB", (64, 64), (1, 2, 3)).save(jpg, format="JPEG")
    with pytest.raises(ValueError, match="JPEG"):
        _port_gen(cfg, params).generate_image(
            ImageGenerationArgs(sd_img2img=str(jpg), sd_n_steps=2),
            lambda _: None)


# -- entry points ------------------------------------------------------------------


def _tiny_load(monkeypatch, tiny):
    cfg, params = tiny

    def load(cls, ctx, rng_seed=0):
        return cls(cfg, params, _tokenizers(cfg), torch.float32,
                   device=ctx.device)
    monkeypatch.setattr(SDGenerator, "load", classmethod(load))


def test_api_image_route(tiny, monkeypatch):
    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import parse_all_args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.sd.image import decode_png

    _tiny_load(monkeypatch, tiny)
    args, sd, _ = parse_all_args(["--cpu", "--model-type", "image"])
    master = Master.from_args(args, sd)
    assert master.llm is None
    httpd = start(master, "127.0.0.1:0", block=False)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        body = {"image_prompt": "a robot", "sd_n_steps": 2, "sd_seed": 7,
                "sd_num_samples": 2, "unknown_key": 1}
        req = urllib.request.Request(
            url + "/api/v1/image", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        assert list(out) == ["images"] and len(out["images"]) == 2
        pngs = [base64.b64decode(s) for s in out["images"]]
        direct = []
        master.generate_image(ImageGenerationArgs(
            image_prompt="a robot", sd_n_steps=2, sd_seed=7,
            sd_num_samples=2), direct.extend)
        assert pngs == direct
        assert decode_png(pngs[0]).shape == (64, 64, 3)
        with urllib.request.urlopen(url + "/api/v1/health") as r:
            assert json.loads(r.read())["status"] == "ok"
        with urllib.request.urlopen(url + "/metrics") as r:
            assert b'route="/api/v1/image"' in r.read()
        for path, data in (("/api/v1/steps", None),
                           ("/api/v1/chat/completions", b"{}")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(
                    url + path, data=data))
            assert ei.value.code == 404
        bad = urllib.request.Request(url + "/api/v1/image", data=b"{x",
                                     headers={"Content-Type":
                                              "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad)
        assert ei.value.code == 400
    finally:
        httpd.shutdown()


def test_text_server_image_route_fails_as_jaxs():
    """A text model's server: POST /api/v1/image raises "no image
    generator loaded" in the master, a 500, as in JAX."""
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.args import Args

    m = Master(Args(), text_generator=None)
    with pytest.raises(RuntimeError, match="no image generator"):
        m.generate_image(ImageGenerationArgs(), lambda _: None)


def test_cli_image_writes_image_0(tiny, monkeypatch, tmp_path, src_png):
    from cake_tpu_torch import cli
    from cake_tpu_torch.models.sd.image import decode_png

    _tiny_load(monkeypatch, tiny)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--cpu", "--model-type", "image", "--sd-img2img",
                     src_png, "--sd-img2img-strength", "0.8",
                     "--sd-n-steps", "4", "--sd-seed", "5"]) == 0
    got = (tmp_path / "image_0.png").read_bytes()
    assert not (tmp_path / "image_1.png").exists()
    want = []
    _port_gen(*tiny).generate_image(ImageGenerationArgs(
        image_prompt=ImageGenerationArgs().image_prompt,
        sd_img2img=src_png, sd_img2img_strength=0.8, sd_n_steps=4,
        sd_seed=5), want.extend)
    assert got == want[0] and decode_png(got).shape == (64, 64, 3)


def test_sd_flags_without_effect_warn_once(capsys):
    """JAX parses --sd-flash-attention and --sd-sliced-attention-size and
    reads neither; the port's SDArgs leave them out, so argparse refuses
    them (every other SDArgs field keeps JAX's name and default)."""
    from cake_tpu.args import SDArgs as JSDArgs
    from cake_tpu_torch.args import SDArgs, parse_all_args

    mine, jaxs = dataclasses.asdict(SDArgs()), dataclasses.asdict(JSDArgs())
    assert mine.pop("sd_version").value == jaxs.pop("sd_version").value
    assert {k: v for k, v in jaxs.items() if k not in mine} == {
        "sd_flash_attention": False, "sd_sliced_attention_size": None}
    assert mine == {k: jaxs[k] for k in mine}
    parse_all_args(["--cpu", "--model-type", "image"])
    for flag in (["--sd-flash-attention"],
                 ["--sd-sliced-attention-size", "4"]):
        with pytest.raises(SystemExit):
            parse_all_args(["--cpu", "--model-type", "image"] + flag)
        assert "unrecognized arguments" in capsys.readouterr().err


# -- the card ------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_unet_step_replay_matches_its_eager_call():
    """The captured UNet step (guidance on and off) against the same step
    run eagerly on the card, f32: the same eps within 1e-4 of its scale;
    one capture a variant, counted under the JAX function's name, and a
    second guidance scale replays the same graph."""
    _cuda_or_skip()
    from cake_tpu_torch.models.sd.sd import unet_step
    cfg = tcfg.tiny_sd_config()
    gen = _port_gen(cfg, device="cuda")
    caps = []
    gen.flight.count_capture = lambda fn, s: caps.append(fn)
    g = torch.Generator(device="cuda").manual_seed(0)
    for cfg_scale, on in ((7.5, True), (3.0, True), (1.0, False)):
        B = 2
        lat = torch.randn(B, 8, 8, 4, generator=g, device="cuda")
        ctx = torch.randn(2 * B if on else B, 77, 64, generator=g,
                          device="cuda")
        for t in (901.0, 1.0):
            got = gen.unet_runner.run(lat, t, ctx, None, cfg_scale,
                                      on).clone()
            want = unet_step(gen.params["unet"], cfg.unet, lat,
                             torch.tensor([t], device="cuda"), ctx, None,
                             cfg_scale, on)
            scale = want.abs().max().item()
            assert (got - want).abs().max().item() <= 1e-4 * scale
    assert caps == ["_make_unet_step"] * 2


@pytest.mark.cuda
def test_cuda_generator_matches_the_cpu_generator():
    """One seed, the tiny config at f32: the card's u8 images within one
    level of the CPU generator's (the noise drawn on the CPU and moved,
    so both sides denoise the same latents)."""
    _cuda_or_skip()
    from cake_tpu_torch.models.sd.image import decode_png
    cfg = tcfg.tiny_sd_config()
    params = _port_params(cfg)
    imgs = {}
    for dev in ("cpu", "cuda"):
        gen = _port_gen(cfg, params, device=dev)
        host = torch.Generator().manual_seed(9)
        gen._noise = (lambda shape, _g, gen=gen, host=host: torch.randn(
            shape, generator=host).to(gen.device, gen.dtype))
        out = []
        gen.generate_image(ImageGenerationArgs(image_prompt="a robot",
                                               sd_n_steps=3, sd_seed=7),
                           out.extend)
        imgs[dev] = [decode_png(p) for p in out]
    for a, b in zip(imgs["cuda"], imgs["cpu"]):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.cuda
def test_cuda_generation_never_waits_for_the_stream():
    """The second generation's UNet steps and scheduler updates run under
    `torch.cuda.set_sync_debug_mode("error")` (the PNG fetch outside):
    nothing between the prompt and the decode waits for the stream."""
    _cuda_or_skip()
    cfg = tcfg.tiny_sd_config()
    gen = _port_gen(cfg, device="cuda")
    args = ImageGenerationArgs(image_prompt="a robot", sd_n_steps=3,
                               sd_seed=7)
    first = []
    gen.generate_image(args, first.extend)
    real_run, real_decode = gen.unet_runner.run, gen._decode_to_pngs
    guarded = []

    def run(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        guarded.append(1)
        return real_run(*a, **k)

    def decode(latents):
        torch.cuda.set_sync_debug_mode(0)
        return real_decode(latents)

    gen.unet_runner.run = run
    gen._decode_to_pngs = decode
    second = []
    try:
        gen.generate_image(args, second.extend)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(guarded) == 3 and second == first
