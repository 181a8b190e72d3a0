"""The port's Stable Diffusion modules (`cake_tpu_torch/models/sd/`)
against the JAX package's, on the CPU at f32 with numpy-seeded inputs
and the same random trees on both sides (drawn by the port's init and
carried to JAX leaf for leaf):

  * CLIP against transformers' CLIPTextModel (2e-4, as tests/test_sd.py
    holds JAX) and against JAX (1e-5), quick_gelu and gelu with a
    projection and clip skip;
  * the UNet (SD and SDXL-shaped with the added condition) and the VAE
    (encode with and without the same posterior noise, decode) against
    JAX (1e-4 of the outputs' scale);
  * DDIM and Euler schedules equal JAX's, their steps and add_noise
    within 1e-6;
  * the safetensors export of the UNet (SD and SDXL) and the VAE is the
    JAX export's file byte for byte; the port loads JAX's file into
    JAX's tree, legacy VAE attention names included;
  * the simple tokenizer and the presets are JAX's;
  * hub resolution: the repo/file mapping, an explicit path winning, a
    miss naming repo and file, and (the port's divergence) a local HF
    cache tree read without `huggingface_hub` and no download ever;
  * the PNG codec and the Lanczos resize against PIL (equal bytes of
    pixels: within one u8 level is the bound, none is the measure).
"""

import io

import numpy as np
import pytest

import torch

from cake_tpu_torch.models.llama.params import params_from_numpy
from cake_tpu_torch.models.sd import config as tcfg

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cake_tpu.models.sd import config as jcfg  # noqa: E402


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _tree(jtree):
    return params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")


def _jtree(ttree):
    """A port tree as JAX's (the same dicts and lists, jnp leaves): the
    random trees are drawn by the port's init, much quicker than JAX's
    key splitting op by op."""
    if isinstance(ttree, dict):
        return {k: _jtree(v) for k, v in ttree.items()}
    if isinstance(ttree, list):
        return [_jtree(v) for v in ttree]
    return jnp.asarray(ttree.numpy())


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * scale,
                               rtol=0)


@pytest.fixture(scope="module")
def tiny():
    return jcfg.tiny_sd_config(), tcfg.tiny_sd_config()


# -- configs -------------------------------------------------------------------


@pytest.mark.parametrize("version", ["v1-5", "v2-1", "xl", "turbo"])
def test_presets_are_jaxs(version):
    from cake_tpu.args import SDVersion as JV
    import dataclasses
    j = jcfg.get_sd_config(JV(version), 512, 768)
    t = tcfg.get_sd_config(tcfg.SDVersion(version), 512, 768)
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert jd.pop("version").value == td.pop("version").value
    assert jd == td
    assert dataclasses.asdict(jcfg.tiny_sd_config()).keys() == \
        dataclasses.asdict(tcfg.tiny_sd_config()).keys()
    with pytest.raises(ValueError, match="multiples of 8"):
        tcfg.get_sd_config(tcfg.SDVersion.V1_5, 100, 512)


def test_sdxl_config_shapes():
    cfg = tcfg.get_sd_config(tcfg.SDVersion.XL)
    assert cfg.clip2 is not None
    assert cfg.unet.addition_embed_dim == 2816
    assert cfg.unet.cross_attention_dim == 2048


# -- CLIP ----------------------------------------------------------------------


def test_clip_matches_transformers_and_jax(tmp_path):
    transformers = pytest.importorskip("transformers")
    from cake_tpu.models.sd.clip import clip_encode as j_encode
    from cake_tpu.models.sd.params import load_clip_params as j_load
    from cake_tpu_torch.models.sd.clip import clip_encode
    from cake_tpu_torch.models.sd.params import load_clip_params

    hf_cfg = transformers.CLIPTextConfig(
        vocab_size=1000, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=77, hidden_act="quick_gelu")
    torch.manual_seed(0)
    model = transformers.CLIPTextModel(hf_cfg).eval()
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    kw = dict(vocab_size=1000, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4)
    params = load_clip_params(str(tmp_path), tcfg.ClipConfig(**kw))
    jp = j_load(str(tmp_path), jcfg.ClipConfig(**kw))
    ids = np.array([[49, 2, 7, 999, 3, 0, 0, 0]], dtype=np.int64)
    with torch.no_grad():
        ref = model(torch.tensor(ids)).last_hidden_state
    ours, pooled = clip_encode(params, tcfg.ClipConfig(**kw),
                               torch.from_numpy(ids))
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=2e-4,
                               rtol=2e-3)
    jo, jpool = jax.jit(lambda p, i: j_encode(p, jcfg.ClipConfig(**kw), i))(
        jp, jnp.asarray(ids))
    np.testing.assert_allclose(ours.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpool), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("skip", [-1, -2])
def test_clip_gelu_projection_and_skip_match_jax(skip):
    from cake_tpu.models.sd.clip import clip_encode as j_encode
    from cake_tpu_torch.models.sd.clip import clip_encode, init_clip_params

    kw = dict(vocab_size=500, hidden_size=32, intermediate_size=64,
              num_hidden_layers=3, num_attention_heads=2,
              hidden_act="gelu", projection_dim=48)
    tp = init_clip_params(tcfg.ClipConfig(**kw), _gen(1))
    ids = np.random.default_rng(2).integers(0, 499, (2, 77))
    ids[:, 10] = 499                            # the EOT of each row
    jo, jpool = jax.jit(lambda p, i: j_encode(
        p, jcfg.ClipConfig(**kw), i, output_hidden_state=skip))(
            _jtree(tp), jnp.asarray(ids))
    o, pool = clip_encode(tp, tcfg.ClipConfig(**kw),
                          torch.from_numpy(ids), output_hidden_state=skip)
    _close(o.numpy(), jo, 1e-5)
    _close(pool.numpy(), jpool, 1e-5)


# -- UNet / VAE ----------------------------------------------------------------


def _xl_unet():
    kw = dict(cross_attention_dim=64, block_out_channels=(32, 64),
              layers_per_block=1, attn_blocks=(True, False),
              transformer_layers_per_block=(1, 0), attention_head_dim=(4, 4),
              num_groups=8, addition_embed_dim=32 + 6 * 256)
    return jcfg.UNetConfig(**kw), tcfg.UNetConfig(**kw)


@pytest.fixture(scope="module")
def unets(tiny):
    """The tiny SD and SDXL-shaped UNets' trees (JAX's leaves)."""
    from cake_tpu_torch.models.sd.unet import init_unet_params
    return (_jtree(init_unet_params(tiny[1].unet, _gen(3))),
            _jtree(init_unet_params(_xl_unet()[1], _gen(6))))


@pytest.fixture(scope="module")
def vae(tiny):
    from cake_tpu_torch.models.sd.vae import init_vae_params
    return _jtree(init_vae_params(tiny[1].vae, _gen(10)))


def test_unet_matches_jax(tiny, unets):
    from cake_tpu.models.sd.unet import unet_forward as j_fwd
    from cake_tpu_torch.models.sd.unet import unet_forward

    rng = np.random.default_rng(4)
    lat = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 77, 64)).astype(np.float32)
    t = np.asarray([7.0, 501.0], np.float32)
    want = jax.jit(lambda p, *a: j_fwd(p, tiny[0].unet, *a))(
        unets[0], jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx))
    got = unet_forward(_tree(unets[0]), tiny[1].unet, _t(lat), _t(t),
                       _t(ctx))
    assert tuple(got.shape) == (2, 8, 8, 4)
    _close(got.numpy(), want)


def test_sdxl_unet_with_added_cond_matches_jax(unets):
    from cake_tpu.models.sd.unet import unet_forward as j_fwd
    from cake_tpu_torch.models.sd.unet import unet_forward

    ju, tu = _xl_unet()
    rng = np.random.default_rng(5)
    lat = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(1, 77, 64)).astype(np.float32)
    te = rng.normal(size=(1, 32)).astype(np.float32)
    tid = np.asarray([[64, 64, 0, 0, 64, 64]], np.float32)
    want = jax.jit(lambda p, *a, added_cond: j_fwd(
        p, ju, *a, added_cond=added_cond))(
            unets[1], jnp.asarray(lat), jnp.asarray([7.0]), jnp.asarray(ctx),
            added_cond={"text_embeds": jnp.asarray(te),
                        "time_ids": jnp.asarray(tid)})
    got = unet_forward(_tree(unets[1]), tu, _t(lat), _t([7.0]), _t(ctx),
                       added_cond={"text_embeds": _t(te),
                                   "time_ids": _t(tid)})
    _close(got.numpy(), want)


def test_vae_encode_and_decode_match_jax(tiny, vae):
    from cake_tpu.models.sd import vae as jv
    from cake_tpu_torch.models.sd import vae as tv

    rng = np.random.default_rng(11)
    img = rng.uniform(-1, 1, size=(1, 32, 32, 3)).astype(np.float32)
    tp = _tree(vae)
    want = jax.jit(lambda p, x: jv.vae_encode(p, tiny[0].vae, x,
                                              sample=False))(
        vae, jnp.asarray(img))
    got = tv.vae_encode(tp, tiny[1].vae, _t(img), sample=False)
    _close(got.numpy(), want)
    # the posterior's sample with the same noise on both sides
    noise = rng.normal(size=want.shape).astype(np.float32)
    real = jax.random.normal
    try:
        jax.random.normal = lambda key, shape, dtype=jnp.float32: \
            jnp.asarray(noise, dtype)
        want_s = jax.jit(lambda p, x: jv.vae_encode(
            p, tiny[0].vae, x, rng=jax.random.PRNGKey(0)))(
                vae, jnp.asarray(img))
    finally:
        jax.random.normal = real
    got_s = tv.vae_encode(tp, tiny[1].vae, _t(img), noise=_t(noise))
    _close(got_s.numpy(), want_s)
    with pytest.raises(ValueError, match="generator"):
        tv.vae_encode(tp, tiny[1].vae, _t(img))
    lat = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    _close(tv.vae_decode(tp, tiny[1].vae, _t(lat)).numpy(),
           jax.jit(lambda p, x: jv.vae_decode(p, tiny[0].vae, x))(
               vae, jnp.asarray(lat)))


# -- schedulers ----------------------------------------------------------------


@pytest.mark.parametrize("kind,pred", [("ddim", "epsilon"),
                                       ("euler", "epsilon"),
                                       ("ddim", "v_prediction"),
                                       ("euler", "v_prediction")])
def test_scheduler_matches_jax(kind, pred):
    from cake_tpu.models.sd import scheduler as js
    from cake_tpu_torch.models.sd import scheduler as ts

    j = js.Schedule.create(js.SchedulerConfig(kind=kind,
                                              prediction_type=pred), 10)
    t = ts.Schedule.create(ts.SchedulerConfig(kind=kind,
                                              prediction_type=pred), 10)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    np.testing.assert_array_equal(t.sigmas, j.sigmas)
    assert t.init_noise_sigma == j.init_noise_sigma
    rng = np.random.default_rng(7)
    lat = rng.normal(size=(1, 4, 4, 4)).astype(np.float32)
    eps = rng.normal(size=(1, 4, 4, 4)).astype(np.float32)
    for i in (0, 5, 9):
        np.testing.assert_allclose(
            t.step(_t(eps), i, t.scale_model_input(_t(lat), i)).numpy(),
            np.asarray(j.step(jnp.asarray(eps), i,
                              j.scale_model_input(jnp.asarray(lat), i))),
            atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(
            t.add_noise(_t(lat), _t(eps), i).numpy(),
            np.asarray(j.add_noise(jnp.asarray(lat), jnp.asarray(eps), i)),
            atol=1e-6, rtol=1e-6)
    # step_idx == steps: strength ~ 0 leaves the latents clean
    assert torch.equal(t.add_noise(_t(lat), _t(eps), 10), _t(lat))
    if kind == "ddim":
        # the last DDIM step predicts x0 (a_prev = 1)
        x0 = (lat - np.sqrt(1 - t.alphas_cumprod[t.timesteps[-1]]) * eps
              ) / np.sqrt(t.alphas_cumprod[t.timesteps[-1]])
        if pred == "epsilon":
            np.testing.assert_allclose(t.step(_t(eps), 9, _t(lat)).numpy(),
                                       x0, atol=1e-4)


# -- checkpoints ---------------------------------------------------------------


@pytest.mark.parametrize("which", ["unet", "unet_xl", "vae"])
def test_export_is_jaxs_file_and_loads_jaxs_tree(tiny, unets, vae, which,
                                                 tmp_path):
    from cake_tpu.models.sd import params as jparams
    from cake_tpu_torch.models.sd import params as tparams

    if which == "vae":
        comp, jtree, jc, tc = "vae", vae, tiny[0], tiny[1]
    elif which == "unet":
        comp, jtree, jc, tc = "unet", unets[0], tiny[0], tiny[1]
    else:
        ju, tu = _xl_unet()
        comp, jtree = "unet", unets[1]
        jc, tc = jcfg.SDConfig(unet=ju), tcfg.SDConfig(unet=tu)
    jf, tf = tmp_path / "jax.safetensors", tmp_path / "port.safetensors"
    jparams.save_sd_component(comp, jtree, jc, str(jf))
    tparams.save_sd_component(comp, _tree(jtree), tc, str(tf))
    assert jf.read_bytes() == tf.read_bytes()
    got = tparams.load_sd_component(comp, str(jf), tc, torch.float32)
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    n = 0
    for path, leaf in flat:
        node = got
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
        n += 1
    assert n == len(jax.tree.leaves(jtree))


def test_vae_legacy_attention_names(tiny, vae, tmp_path):
    from cake_tpu_torch.models.sd import params as tparams
    from cake_tpu_torch.models.sd.vae import vae_decode
    from cake_tpu_torch.utils.loading import save_safetensors

    p = _tree(vae)
    legacy = {}
    for name, arr in tparams.export_sd_component("vae", p, tiny[1]).items():
        for new, old in (("to_q", "query"), ("to_k", "key"),
                         ("to_v", "value"), ("to_out.0", "proj_attn")):
            if f"attentions.0.{new}." in name:
                name = name.replace(f"{new}.", f"{old}.")
                break
        legacy[name] = arr
    f = str(tmp_path / "vae_legacy.safetensors")
    save_safetensors(f, legacy)
    p2 = tparams.load_sd_component("vae", f, tiny[1], torch.float32)
    lat = torch.randn(1, 16, 16, 4, generator=torch.Generator().manual_seed(1))
    assert torch.equal(vae_decode(p, tiny[1].vae, lat),
                       vae_decode(p2, tiny[1].vae, lat))
    bad = dict(legacy)
    bad.pop(next(k for k in bad if "proj_attn" in k))
    save_safetensors(f, bad)
    with pytest.raises(KeyError, match="legacy fallbacks"):
        tparams.load_sd_component("vae", f, tiny[1], torch.float32)


def test_simple_tokenizer_is_jaxs():
    from cake_tpu.models.sd.sd import SimpleClipTokenizer as J
    from cake_tpu_torch.models.sd.sd import SimpleClipTokenizer as T
    t = T(1000)
    a = t.encode("a rusty robot")
    assert a == t.encode("a rusty robot") == J(1000).encode("a rusty robot")
    assert len(a) == 77 and a[0] == 998 and a[-1] == 999
    long = " ".join(f"w{i}" for i in range(100))
    assert t.encode(long) == J(1000).encode(long)


# -- hub -----------------------------------------------------------------------


def test_hub_repo_file_mapping_is_jaxs():
    from cake_tpu.models.sd.hub import _component_repo_file as j_map
    from cake_tpu_torch.models.sd.hub import _component_repo_file

    repo, f = _component_repo_file("unet", "v1-5", use_f16=False)
    assert repo == "stable-diffusion-v1-5/stable-diffusion-v1-5"
    assert f == "unet/diffusion_pytorch_model.safetensors"
    for comp in ("tokenizer", "tokenizer_2", "clip", "clip2", "unet", "vae"):
        for v in ("v1-5", "v2-1", "xl", "turbo"):
            for f16 in (False, True):
                assert _component_repo_file(comp, v, f16) == \
                    j_map(comp, v, f16)
    assert _component_repo_file("vae", tcfg.SDVersion.XL, True)[0] == \
        "madebyollin/sdxl-vae-fp16-fix"
    with pytest.raises(ValueError):
        _component_repo_file("unet", "v9", True)


def test_hub_resolve_explicit_path_wins(tmp_path):
    from cake_tpu_torch.models.sd.hub import resolve_sd_asset
    f = tmp_path / "x.safetensors"
    f.write_text("")
    assert resolve_sd_asset("unet", "v1-5", filename=str(f)) == str(f)


def test_hub_resolve_offline_miss_is_actionable(monkeypatch, tmp_path):
    from cake_tpu_torch.models.sd.hub import resolve_sd_asset
    # the port never downloads, whatever the offline switches say
    monkeypatch.setenv("HF_HUB_OFFLINE", "0")
    monkeypatch.delenv("CAKE_HUB_OFFLINE", raising=False)
    with pytest.raises(FileNotFoundError) as ei:
        resolve_sd_asset("unet", "v1-5", use_f16=False,
                         cache_dir=str(tmp_path))
    msg = str(ei.value)
    assert "stable-diffusion-v1-5" in msg
    assert "unet/diffusion_pytorch_model.safetensors" in msg
    assert "does not download" in msg


def test_hub_reads_the_hf_cache_layout(monkeypatch, tmp_path):
    """The port reads `models--org--name/snapshots/<commit>/path` itself
    (the commit from refs/main), the legacy v1-5 repo as an alias, and
    $HF_HUB_CACHE when no cache_dir is given."""
    from cake_tpu_torch.models.sd.hub import resolve_sd_asset

    def put(repo, path, commit="abc123", ref=True):
        root = tmp_path / ("models--" + repo.replace("/", "--"))
        f = root / "snapshots" / commit / path
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text("w")
        if ref:
            (root / "refs").mkdir(exist_ok=True)
            (root / "refs" / "main").write_text(commit)
        return str(f)

    want = put("runwayml/stable-diffusion-v1-5",
               "unet/diffusion_pytorch_model.fp16.safetensors")
    assert resolve_sd_asset("unet", "v1-5", cache_dir=str(tmp_path)) == want
    tok = put("openai/clip-vit-large-patch14", "tokenizer.json", "def")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    assert resolve_sd_asset("tokenizer", "xl") == tok
    # a snapshot with no ref for the revision is not read
    put("stabilityai/sdxl-turbo", "unet/diffusion_pytorch_model.safetensors",
        "zzz", ref=False)
    with pytest.raises(FileNotFoundError):
        resolve_sd_asset("unet", "turbo", use_f16=False)


# -- images --------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_png_decode_is_pils(mode):
    Image = pytest.importorskip("PIL.Image")
    from cake_tpu_torch.models.sd.image import decode_png

    rng = np.random.default_rng(0)
    img = Image.fromarray(rng.integers(0, 256, (21, 34, 3), dtype=np.uint8))
    img = img.convert(mode)
    for optimize in (False, True):
        buf = io.BytesIO()
        img.save(buf, format="PNG", optimize=optimize)
        got = decode_png(buf.getvalue())
        np.testing.assert_array_equal(got, np.asarray(img.convert("RGB")))


def test_png_encode_reads_back_in_pil_and_refusals():
    Image = pytest.importorskip("PIL.Image")
    from cake_tpu_torch.models.sd.image import decode_png, encode_png

    x = np.random.default_rng(1).integers(0, 256, (19, 23, 3),
                                          dtype=np.uint8)
    png = encode_png(x)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))), x)
    np.testing.assert_array_equal(decode_png(png), x)
    g = x[:, :, 0]
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(encode_png(g)))), g)
    jpg = io.BytesIO()
    Image.fromarray(x).save(jpg, format="JPEG")
    with pytest.raises(ValueError, match="JPEG"):
        decode_png(jpg.getvalue())
    buf = io.BytesIO()
    Image.fromarray(x).save(buf, format="PNG")
    raw = bytearray(buf.getvalue())
    raw[28] = 1                                 # the IHDR's interlace byte
    with pytest.raises(ValueError, match="interlac"):
        decode_png(bytes(raw))


@pytest.mark.parametrize("src,dst", [((50, 70), (64, 64)),
                                     ((300, 200), (64, 96)),
                                     ((64, 64), (32, 48)),
                                     ((17, 33), (64, 8)),
                                     ((512, 512), (512, 512))])
def test_lanczos_resize_is_pils(src, dst):
    Image = pytest.importorskip("PIL.Image")
    from cake_tpu_torch.models.sd.image import resize_lanczos

    rng = np.random.default_rng(sum(src) + sum(dst))
    img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    if src == (512, 512):
        img = img[:, :, :1].repeat(3, axis=2)
    want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]),
                                                  Image.LANCZOS))
    got = resize_lanczos(img, dst[1], dst[0])
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1
