"""Stable Diffusion generator: text embeddings, guidance, denoise, decode.

Counterpart of `cake_tpu/models/sd/sd.py`:
  * the prompt's and the negative prompt's CLIP embeddings, padded or
    truncated to 77 tokens and concatenated for classifier-free
    guidance; SDXL's two encoders and its added condition;
  * txt2img from random latents; img2img from the VAE-encoded input
    image, noised to `strength` (PNG inputs, resized by the port's
    Lanczos, models/sd/image.py);
  * a step: the UNet on the doubled batch and the guidance mix, then the
    scheduler's update; intermediary decodes every steps // 5 steps and
    the final VAE decode to u8 RGB PNGs through a callback.

On the card the denoise step (JAX's jitted `_make_unet_step` body) is a
CUDA graph (`UNetStepRunner`), captured once for each (guidance on,
batch, height, width) and replayed every step, the timestep and the
guidance scale device scalars; the scheduler's update runs between
replays.
There is no eager fallback on the card: a capture that fails raises.

The noise streams are the port's own: the initial latents and the VAE
posterior's noise come from a `torch.Generator` seeded with `sd_seed`,
where JAX draws them from threefry keys, so the two packages give
different images for one seed (the port gives one image for one seed).

On one host the components may live on several devices:
`place_components(topology)` puts clip, clip2, vae and unet on
`devices[idx % n]` of the node that names each, as JAX does, and the
activations move between them; `shard_for_mesh` (`--dp`) replicates
every component on the mesh's devices and splits the UNet's batch (the
guidance pair, several samples) over the dp positions, each running its
rows, inside the one captured step. The noise is drawn on the
generator's device either way, so a placed or meshed generator gives
the single-device image.

Over a ("dp",) mesh that spans processes (multi-process image serving,
Context.load_image_model) each process holds the UNet on its own
positions and runs only their rows; the rows reach every rank by hop
(parallel/hop.py: each block from its owner to every other process, in
row order), so every process runs the guidance mix, the scheduler
update and the VAE decode itself, as every JAX process does, and the
captured step is a chain of graphs cut at the hops. The noise is drawn
from `sd_seed` alike on every process.
"""

from __future__ import annotations

import logging
import os
import time
import zlib
from typing import Callable, List

import numpy as np
import torch

from cake_tpu_torch.models.sd.clip import clip_encode, init_clip_params
from cake_tpu_torch.models.sd.config import SDConfig, SDVersion, get_sd_config
from cake_tpu_torch.models.sd.image import (
    decode_png, encode_png, resize_lanczos,
)
from cake_tpu_torch.models.sd.scheduler import Schedule, SchedulerConfig
from cake_tpu_torch.models.sd.unet import init_unet_params, unet_forward
from cake_tpu_torch.models.sd.vae import init_vae_params, vae_decode, vae_encode
from cake_tpu_torch.obs.steps import StepTelemetry
from cake_tpu_torch.serve.graphs import _Graphs
from cake_tpu_torch.utils.devices import resolve_device

log = logging.getLogger(__name__)

# the name the captures count under in cake_jit_compiles_total: the JAX
# method whose jitted function the graph is
UNET_STEP_FN = "_make_unet_step"
DEFAULT_SEED = 299792458


class SimpleClipTokenizer:
    """The tokenizer without a tokenizer.json: CRC32 word ids
    (deterministic across processes). Real deployments pass
    --sd-tokenizer."""

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self.bos = vocab_size - 2
        self.eos = vocab_size - 1

    def encode(self, text: str, max_len: int = 77) -> List[int]:
        ids = [self.bos]
        for word in text.lower().split():
            ids.append(zlib.crc32(word.encode()) % (self.vocab_size - 2))
        ids = ids[: max_len - 1] + [self.eos]
        ids += [self.eos] * (max_len - len(ids))
        return ids


class ClipTokenizer:
    """A CLIP `tokenizer.json` read by the port's own reader
    (models/llama/tokenizer.py): `encode` pads and truncates as JAX's
    `HFClipTokenizer.encode` does, keeping the EOS terminal so the EOT
    pooling stays valid."""

    def __init__(self, path: str):
        from cake_tpu_torch.models.llama.tokenizer import BpeTokenizer
        self.tok = BpeTokenizer.from_file(path)

    def encode(self, text: str, max_len: int = 77) -> List[int]:
        ids = list(self.tok.encode(text))
        eos = ids[-1] if ids else 0
        if len(ids) > max_len:
            ids = ids[: max_len - 1] + [eos]
        return ids + [eos] * (max_len - len(ids))


def _unet_dp(replicas, ucfg, inp, ts, context, added, across=None):
    """The UNet's batch split over the dp positions' replicas (device,
    params): each runs its contiguous rows on its device, the outputs
    gathered back in row order on the first row's device.

    across: (hops, owners) where the positions span processes: a
    replica of another process is (device, None); this process runs its
    own rows, and each block of rows reaches every rank from its owner
    (`Hops.bcast`, blocks in row order)."""
    n = len(replicas)
    parts = []
    for r, rows in enumerate(torch.arange(inp.shape[0]).tensor_split(n)):
        if not len(rows):
            continue
        dev, params = replicas[r]
        a, b = int(rows[0]), int(rows[-1]) + 1
        out = None
        if params is not None:
            add = (None if added is None else
                   {k: v[a:b].to(dev) for k, v in added.items()})
            out = unet_forward(params, ucfg, inp[a:b].to(dev),
                               ts[a:b].to(dev), context[a:b].to(dev),
                               added_cond=add).to(inp.device)
        if across is not None:
            hops, owners = across
            out = hops.bcast(out, owners[r], (b - a, *inp.shape[1:]),
                             inp.dtype, inp.device)
        parts.append(out)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def unet_step(unet_params, ucfg, latents, t, context, added,
              guidance_scale, use_guidance: bool, replicas=None,
              across=None):
    """JAX's `_make_unet_step` body: the UNet on the (doubled, with
    guidance) batch at timestep t (a 0-d or [1] tensor), then the
    guidance mix, its product in f32 for a float scale and for an f32
    [1] tensor alike. Returns eps like latents. replicas: the dp mesh's
    (device, params), the batch split over them (`_unet_dp`; across: its
    processes' hops)."""
    inp = torch.cat([latents, latents], dim=0) if use_guidance else latents
    ts = t.float().reshape(1).expand(inp.shape[0])
    if replicas is not None:
        eps = _unet_dp(replicas, ucfg, inp, ts, context, added, across)
    else:
        eps = unet_forward(unet_params, ucfg, inp, ts, context,
                           added_cond=added)
    if use_guidance:
        eps_u, eps_c = eps.chunk(2, dim=0)
        eps = eps_u + (guidance_scale
                       * (eps_c - eps_u).float()).to(eps.dtype)
    return eps


class UNetStepRunner(_Graphs):
    """The denoise step as CUDA graphs over static buffers, one a
    variant (use_guidance, batch, height, width), the guidance scale a
    buffer like the timestep, so a request's scale costs no capture:
    `run` copies the step's inputs in and replays; on the CPU it runs
    the step eagerly. The warm-up before each capture runs on the side
    stream under `serve/graphs._capturing`, so cuDNN has picked its
    convolution algorithms before the capture."""

    def __init__(self, params, ucfg, device, pool=None, on_capture=None,
                 replicas=None, across=None):
        super().__init__(device, pool=pool, on_capture=on_capture)
        self.params, self.ucfg = params, ucfg
        self.replicas, self.across = replicas, across
        self._bufs: dict = {}

    def _idle(self, variant):
        return None                # a pure function of its buffers

    def step(self, variant) -> None:
        b = self._bufs[variant]
        b["eps"].copy_(unet_step(self.params, self.ucfg, b["latents"],
                                 b["t"], b["context"], b["added"],
                                 b["g"], variant[0],
                                 replicas=self.replicas,
                                 across=self.across))

    @torch.inference_mode()
    def run(self, latents, t: float, context, added, guidance_scale: float,
            use_guidance: bool) -> torch.Tensor:
        """eps for `latents` at timestep t (the returned tensor is the
        variant's buffer: the next run overwrites it)."""
        B, H, W, _ = latents.shape
        variant = (bool(use_guidance), B, H, W)
        b = self._bufs.get(variant)
        if b is None:
            b = self._bufs[variant] = dict(
                latents=torch.empty_like(latents),
                t=self._zeros(1, dtype=torch.float32),
                g=self._zeros(1, dtype=torch.float32),
                context=torch.empty_like(context),
                added=(None if added is None else
                       {k: torch.empty_like(v) for k, v in added.items()}),
                eps=torch.empty_like(latents))
        b["latents"].copy_(latents)
        b["context"].copy_(context)
        if added is not None:
            for k, v in added.items():
                b["added"][k].copy_(v)
        if self._cuda:
            self._put(b["t"], [t])
            self._put(b["g"], [guidance_scale])
        else:
            b["t"].fill_(t)
            b["g"].fill_(guidance_scale)
        self.replay(variant)
        return b["eps"]


class SDGenerator:
    """The image generator of the `image` model type."""

    MODEL_NAME = "stable-diffusion"

    def __init__(self, config: SDConfig, params: dict, tokenizers: list,
                 dtype=torch.float32, device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.params = params          # {"clip", "clip2"?, "unet", "vae"}
        self.tokenizers = tokenizers  # [tok] or [tok, tok2] for XL
        self.dtype = dtype
        # component -> its device (place_components); the dp mesh's
        # UNet replicas (shard_for_mesh)
        self._devices = {name: self.device for name in params}
        self._mesh = None
        self._placed = False
        self._replicas = None
        self._across = None
        # the capture counter (cake_jit_compiles_total{fn=...})
        self.flight = StepTelemetry(impl="sd", capacity=1)
        self._new_unet_runner()

    def _new_unet_runner(self) -> None:
        """The captured UNet step on the UNet's device (anew after a
        placement: its graphs hold the old buffers)."""
        dev = self._devices["unet"]
        self._pool = (torch.cuda.graph_pool_handle()
                      if dev.type == "cuda" else None)
        self.unet_runner = UNetStepRunner(
            self.params["unet"], self.config.unet, dev, pool=self._pool,
            on_capture=self._count_capture, replicas=self._replicas,
            across=self._across)

    def _count_capture(self, variant, seconds: float) -> None:
        log.info("sd: captured the UNet step %s in %.2f s", variant, seconds)
        self.flight.count_capture(UNET_STEP_FN, seconds)

    # -- multi-device --------------------------------------------------------

    def place_components(self, topology, devices=None) -> None:
        """Map the components onto devices by topology names (the
        reference's clip/vae/unet worker assignment, done as placement):
        a node naming `clip`, `clip2`, `vae` or `unet` puts it on
        devices[idx % n], idx its first `devices:` entry (0 without).
        devices: default every visible card, or the CPU on the CPU."""
        from cake_tpu_torch.parallel.mesh import default_devices
        if self._mesh is not None:
            raise ValueError(
                "an SD component topology and the --dp mesh are mutually "
                "exclusive")
        devices = [torch.device(d) for d in
                   (devices or default_devices(self.device.type))]
        self._placed = True
        self.params = dict(self.params)      # the caller's dict stays
        for name in ("clip", "clip2", "vae", "unet"):
            found = topology.get_node_for_layer(name)
            if found is None or name not in self.params:
                continue
            node_name, node = found
            idx = node.devices[0] if node.devices else 0
            dev = devices[idx % len(devices)]
            self.params[name] = _tree_to(self.params[name], dev)
            self._devices[name] = dev
            log.info("sd: %s -> %s (node %s)", name, dev, node_name)
        self._new_unet_runner()

    def shard_for_mesh(self, mesh) -> None:
        """The UNet's batch over the dp positions of `mesh` (a Mesh whose
        only axis is "dp", or a ("dp", "stage", "tp") mesh of stage and
        tp 1): the UNet is replicated once on each distinct device and
        each position runs its contiguous rows of the (guidance-doubled,
        multi-sample) batch, inside the one captured step. Mutually
        exclusive with per-component placement.

        A mesh across processes (`Mesh.ranks`): the UNet is held on this
        process's positions only, and the rows of the others arrive by
        hop (`_unet_dp`)."""
        if self._placed:
            raise ValueError(
                "--dp and an SD component topology are mutually "
                "exclusive: the mesh replicates every component")
        devices = list(mesh.devices.flat)
        owned = [mesh.owns(pos) for pos in np.ndindex(*mesh.devices.shape)]
        copies: dict = {}
        for dev, mine in zip(devices, owned):
            if mine and dev not in copies:
                copies[dev] = (self.params["unet"] if dev == self.device
                               else _tree_to(self.params["unet"], dev))
        self._mesh = mesh
        self._replicas = [(dev, copies[dev] if mine else None)
                          for dev, mine in zip(devices, owned)]
        if mesh.multiprocess:
            from cake_tpu_torch.parallel.distributed import hops
            self._across = (hops(), [int(r) for r in mesh.ranks.flat])
        self._new_unet_runner()
        log.info("sd: the UNet batch over dp=%d positions", len(devices))

    # -- loading -------------------------------------------------------------

    @classmethod
    def load(cls, ctx, rng_seed: int = 0) -> "SDGenerator":
        """Build from a Context: the version's preset with --sd-height /
        --sd-width, each component's weights from its --sd-* path or the
        local HF cache, else a random init from `rng_seed` (with JAX's
        warning); the tokenizers likewise, else SimpleClipTokenizer."""
        from cake_tpu_torch.args import SDArgs
        from cake_tpu_torch.models.sd.hub import resolve_sd_asset
        from cake_tpu_torch.models.sd.params import load_sd_component

        sd_args: SDArgs = ctx.sd_args or SDArgs()
        cfg = get_sd_config(SDVersion(sd_args.sd_version), sd_args.sd_height,
                            sd_args.sd_width)
        dtype = torch.bfloat16 if sd_args.sd_use_f16 else torch.float32
        dev = ctx.device
        gen = torch.Generator(device=dev).manual_seed(rng_seed)

        def resolve(component, explicit):
            """explicit path > HF cache; None when nothing resolves. An
            explicit path that does not exist is an error: a mistyped
            --sd-* flag must not give a random-weight model."""
            if explicit:
                if os.path.exists(explicit):
                    return explicit
                raise FileNotFoundError(
                    f"--sd-{component.replace('_', '-')} path does not "
                    f"exist: {explicit}")
            try:
                return resolve_sd_asset(component, cfg.version,
                                        use_f16=sd_args.sd_use_f16)
            except FileNotFoundError as e:
                log.warning("sd: %s", e)
                return None

        def maybe_load(component, path, init_fn):
            path = resolve(component, path)
            if path:
                return load_sd_component(component, path, cfg, dtype, dev)
            log.warning("sd: no weights for %s; using random init",
                        component)
            return init_fn()

        def tokenizer_for(component, explicit):
            path = resolve(component, explicit)
            return ClipTokenizer(path) if path else SimpleClipTokenizer()

        params = {
            "clip": maybe_load("clip", sd_args.sd_clip, lambda:
                               init_clip_params(cfg.clip, gen, dtype, dev)),
            "unet": maybe_load("unet", sd_args.sd_unet, lambda:
                               init_unet_params(cfg.unet, gen, dtype, dev)),
            "vae": maybe_load("vae", sd_args.sd_vae, lambda:
                              init_vae_params(cfg.vae, gen, dtype, dev)),
        }
        toks = [tokenizer_for("tokenizer", sd_args.sd_tokenizer)]
        if cfg.clip2 is not None:
            params["clip2"] = maybe_load(
                "clip2", sd_args.sd_clip2,
                lambda: init_clip_params(cfg.clip2, gen, dtype, dev))
            toks.append(tokenizer_for("tokenizer_2", sd_args.sd_tokenizer_2))
        gen = cls(cfg, params, toks, dtype, device=dev)
        if getattr(ctx, "topology", None) is not None:
            gen.place_components(ctx.topology,
                                 devices=getattr(ctx, "mesh_devices", None))
        return gen

    # -- text embeddings -----------------------------------------------------

    @torch.inference_mode()
    def text_embeddings(self, prompt: str, uncond_prompt: str,
                        use_guidance: bool):
        """[2B or B, 77, ctx] context (uncond first) and SDXL's added
        condition (None otherwise)."""
        cfg = self.config
        added = None

        unet_dev = self._devices["unet"]

        def encode_with(name, tok, clip_cfg, text, skip):
            ids = torch.tensor([tok.encode(text)], dtype=torch.int64,
                               device=self._devices[name])
            out = clip_encode(self.params[name], clip_cfg, ids,
                              output_hidden_state=skip)
            # the embeddings go to the UNet's device at once (the two
            # encoders may live apart)
            return tuple(o.to(unet_dev) for o in out)

        # clip skip (-2, no final_ln) for the XL encoders only; v2.1's
        # ViT-H ships truncated to 23 layers and uses its final state
        skip = -2 if cfg.version in (SDVersion.XL, SDVersion.TURBO) else -1
        cond, pooled = encode_with("clip", self.tokenizers[0], cfg.clip,
                                   prompt, skip)
        if cfg.clip2 is not None:
            cond2, pooled2 = encode_with("clip2", self.tokenizers[1],
                                         cfg.clip2, prompt, -2)
            cond = torch.cat([cond, cond2], dim=-1)
            pooled = pooled2
        if not use_guidance:
            if cfg.clip2 is not None:
                added = {"text_embeds": pooled,
                         "time_ids": self._time_ids(1)}
            return cond, added

        un, un_pooled = encode_with("clip", self.tokenizers[0], cfg.clip,
                                    uncond_prompt, skip)
        if cfg.clip2 is not None:
            un2, un_pooled2 = encode_with("clip2", self.tokenizers[1],
                                          cfg.clip2, uncond_prompt, -2)
            un = torch.cat([un, un2], dim=-1)
            un_pooled = un_pooled2
            added = {"text_embeds": torch.cat([un_pooled, pooled], dim=0),
                     "time_ids": self._time_ids(2)}
        return torch.cat([un, cond], dim=0), added

    def _time_ids(self, b: int) -> torch.Tensor:
        h, w = self.config.height, self.config.width
        return torch.tensor([[h, w, 0, 0, h, w]], dtype=torch.float32,
                            device=self._devices["unet"]).repeat(b, 1)

    # -- generation ----------------------------------------------------------

    def _noise(self, shape, generator: torch.Generator) -> torch.Tensor:
        """Standard normal noise of `shape` in the model dtype, drawn on
        the generator's device (the callers hand it to a component's)."""
        return torch.randn(shape, generator=generator, device=self.device,
                           dtype=self.dtype)

    def generate_image(self, args, callback: Callable[[List[bytes]], None]
                       ) -> None:
        """Generate per `args` (ImageGenerationArgs), handing each batch
        of PNGs to `callback`; --sd-tracing profiles the whole
        generation into the `sd-trace` directory."""
        from cake_tpu_torch.utils.profiling import trace
        with trace("sd-trace" if args.sd_tracing else None):
            self._generate_image(args, callback)

    @torch.inference_mode()
    def _generate_image(self, args, callback) -> None:
        cfg = self.config
        steps = args.sd_n_steps or cfg.default_steps
        guidance = (args.sd_guidance_scale
                    if args.sd_guidance_scale is not None
                    else cfg.default_guidance)
        use_guidance = guidance > 1.0
        seed = args.sd_seed if args.sd_seed is not None else DEFAULT_SEED
        gen = torch.Generator(device=self.device).manual_seed(seed)

        sched = Schedule.create(
            SchedulerConfig(
                prediction_type=cfg.prediction_type,
                kind="euler" if cfg.version in (SDVersion.XL,
                                                SDVersion.TURBO)
                else "ddim"),
            steps)
        context, added = self.text_embeddings(
            args.image_prompt, args.image_uncond_prompt, use_guidance)

        f = cfg.vae.downscale_factor
        lat_h, lat_w = cfg.height // f, cfg.width // f
        lat_c = cfg.vae.latent_channels
        bsize = args.sd_bsize

        init_latent, t_start = None, 0
        if args.sd_img2img:
            image = image_preprocess(args.sd_img2img, cfg.height, cfg.width)
            init_latent = vae_encode(
                self.params["vae"], cfg.vae,
                torch.as_tensor(image, device=self._devices["vae"])
                .to(self.dtype)[None],
                noise=self._noise((1, lat_h, lat_w, lat_c), gen).to(
                    self._devices["vae"])).to(self._devices["unet"])
            t_start = max(steps - int(args.sd_img2img_strength * steps), 0)

        for sample_idx in range(args.sd_num_samples):
            noise = self._noise((bsize, lat_h, lat_w, lat_c), gen).to(
                self._devices["unet"])
            if init_latent is not None:
                latents = sched.add_noise(init_latent.repeat(bsize, 1, 1, 1),
                                          noise, t_start)
            else:
                latents = noise * sched.init_noise_sigma
            ctx_b = (context.repeat_interleave(bsize, dim=0) if bsize > 1
                     else context)
            added_b = added
            if added is not None and bsize > 1:
                added_b = {k: v.repeat_interleave(bsize, dim=0)
                           for k, v in added.items()}
            for i in range(t_start, steps):
                t0 = time.perf_counter()
                scaled = sched.scale_model_input(latents, i)
                eps = self.unet_runner.run(scaled,
                                           float(sched.timesteps[i]), ctx_b,
                                           added_b, guidance, use_guidance)
                latents = sched.step(eps, i, latents)
                log.info("sample %d step %d/%d (%.2fs)", sample_idx + 1,
                         i + 1, steps, time.perf_counter() - t0)
                if (args.sd_intermediary_images and i > t_start
                        and (i - t_start) % max(steps // 5, 1) == 0):
                    callback(self._decode_to_pngs(latents))
            callback(self._decode_to_pngs(latents))

    def decode_to_u8(self, latents) -> np.ndarray:
        """VAE decode -> u8 RGB [B, H, W, 3] on the host."""
        imgs = vae_decode(self.params["vae"], self.config.vae,
                          latents.to(self._devices["vae"]))
        return ((imgs.clamp(-1, 1) + 1.0) * 127.5).to(torch.uint8).cpu() \
            .numpy()

    def _decode_to_pngs(self, latents) -> List[bytes]:
        return [encode_png(img) for img in self.decode_to_u8(latents)]


def _tree_to(tree, dev):
    """A component's param tree (dicts, lists, tensors) on `dev`."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def image_preprocess(path: str, height: int, width: int) -> np.ndarray:
    """A PNG file resized (Lanczos) to height x width and mapped to
    [-1, 1], [H, W, 3] f32; another format raises naming it."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    img = resize_lanczos(img, width, height)
    return img.astype(np.float32) / 127.5 - 1.0
