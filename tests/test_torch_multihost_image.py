"""Multi-process image serving of the port on the CPU: a tiny Stable
Diffusion model served by `cli.main --api --model-type image` in two
OS processes joined by gloo. Context lays the ("dp",) mesh over both
processes' devices, each process runs its own rows of the
guidance-doubled UNet batch and the rows reach the other by hop;
process 0 serves `POST /api/v1/image` and publishes the generation's
args, the follower replays it (`cli._run_image_follower`).

  * The PNG's u8 pixels are within one level of JAX's image and of the
    port's single-process `--dp 2` generator, fed the same noise (one
    numpy-seeded queue of draws, as tests/test_torch_sd_generate.py
    feeds both packages).
  * img2img is refused with JAX's message (the init image lives on the
    coordinator only), and the server goes on serving.
  * SIGTERM stops both processes, the follower on the stop op.
"""

import base64
import json
import signal
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
NOISE_SEED = 0
BODY = dict(image_prompt="a robot", sd_n_steps=2, sd_seed=7,
            sd_guidance_scale=7.5)

WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    pid, port, api_addr, seed = sys.argv[1:5]
    os.environ["CAKE_COORDINATOR"] = f"127.0.0.1:{port}"
    os.environ["CAKE_NUM_PROCESSES"] = "2"
    os.environ["CAKE_PROCESS_ID"] = pid
    from cake_tpu_torch.models.sd import config as tcfg
    from cake_tpu_torch.models.sd import sd as sd_mod
    from cake_tpu_torch.models.sd.clip import init_clip_params
    from cake_tpu_torch.models.sd.unet import init_unet_params
    from cake_tpu_torch.models.sd.vae import init_vae_params
    cfg = tcfg.tiny_sd_config()

    def load(cls, ctx, rng_seed=0):
        g = torch.Generator().manual_seed(0)
        params = {"clip": init_clip_params(cfg.clip, g),
                  "unet": init_unet_params(cfg.unet, g),
                  "vae": init_vae_params(cfg.vae, g)}
        return cls(cfg, params,
                   [sd_mod.SimpleClipTokenizer(cfg.clip.vocab_size)],
                   torch.float32, device=ctx.device)

    rng = np.random.default_rng(int(seed))
    sd_mod.SDGenerator.load = classmethod(load)
    sd_mod.SDGenerator._noise = lambda self, shape, g: torch.from_numpy(
        rng.standard_normal(tuple(shape)).astype(np.float32)).to(
        self.device, self.dtype)
    from cake_tpu_torch import cli
    sys.exit(cli.main(["--cpu", "--model-type", "image",
                       "--api", api_addr]))
""")


def _env():
    import os
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def references():
    """JAX's image and the port's single-process --dp 2 image, the same
    noise queue feeding each."""
    from test_torch_sd_generate import (
        _jax_images, _NoiseQueue, _port_gen, _port_params,
    )

    from cake_tpu_torch.args import ImageGenerationArgs
    from cake_tpu_torch.models.sd import config as tcfg
    from cake_tpu_torch.models.sd.image import decode_png
    from cake_tpu_torch.models.sd.sd import SDGenerator
    from cake_tpu_torch.parallel.mesh import make_mesh

    cfg = tcfg.tiny_sd_config()
    params = _port_params(cfg)
    jax_img = _jax_images(cfg, params, BODY, _NoiseQueue(NOISE_SEED))[0][0]
    gen = _port_gen(cfg, params)
    gen.shard_for_mesh(make_mesh(dp=2, device_type="cpu"))
    rng = np.random.default_rng(NOISE_SEED)
    real = SDGenerator._noise
    SDGenerator._noise = lambda self, shape, g: torch.from_numpy(
        rng.standard_normal(tuple(shape)).astype(np.float32))
    out = []
    try:
        gen.generate_image(ImageGenerationArgs(**BODY),
                           lambda pngs: out.extend(decode_png(p)
                                                   for p in pngs))
    finally:
        SDGenerator._noise = real
    return jax_img, out[0]


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_two_processes_serve_the_single_process_image(references,
                                                      tmp_path):
    from cake_tpu_torch.models.sd.image import decode_png

    jax_img, dp2_img = references
    port, api = _free_port(), _free_port()
    base = f"http://127.0.0.1:{api}"
    logs = [tmp_path / f"p{i}.log" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(i), str(port),
         f"127.0.0.1:{api}", str(NOISE_SEED)],
        stdout=open(logs[i], "w"), stderr=subprocess.STDOUT, env=_env(),
        cwd=str(ROOT)) for i in range(2)]

    def tail(i):
        return logs[i].read_text()[-3000:] if logs[i].exists() else ""

    try:
        deadline = time.monotonic() + 120
        while True:
            assert all(p.poll() is None for p in procs), \
                f"a worker died:\n{tail(0)}\n---\n{tail(1)}"
            try:
                with urllib.request.urlopen(base + "/api/v1/health",
                                            timeout=2) as r:
                    if json.loads(r.read())["status"] == "ok":
                        break
            except OSError:
                assert time.monotonic() < deadline, "the API never came up"
                time.sleep(0.2)
        doc = _post(base + "/api/v1/image", BODY)
        got = decode_png(base64.b64decode(doc["images"][0]))
        assert got.shape == jax_img.shape == (64, 64, 3)
        assert jax_img.std() > 5
        assert np.abs(got.astype(int) - dp2_img.astype(int)).max() <= 1
        assert np.abs(got.astype(int) - jax_img.astype(int)).max() <= 1
        assert "sd: the UNet batch over dp=2 positions" in tail(1)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/api/v1/image",
                  dict(BODY, sd_img2img=str(tmp_path / "x.png")))
        assert e.value.code in (400, 500)
        assert "img2img is unavailable under multi-host serving: the " \
            "init image exists on the coordinator only; serve img2img " \
            "on one host" in e.value.read().decode()
        procs[0].send_signal(signal.SIGTERM)
        assert procs[1].wait(60) == 0, tail(1)
        assert procs[0].wait(60) in (0, -signal.SIGTERM), tail(0)
        assert "image follower: coordinator stopped" in tail(1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# -- on the card --------------------------------------------------------------

UNET_WORKER = textwrap.dedent("""
    import sys
    import torch
    pid, port = int(sys.argv[1]), sys.argv[2]
    dev = torch.device("cuda", 0)
    from cake_tpu_torch.parallel import distributed
    assert distributed.initialize(coordinator=f"127.0.0.1:{port}",
                                  num_processes=2, process_id=pid,
                                  device=dev)
    from cake_tpu_torch.models.sd import config as tcfg
    from cake_tpu_torch.models.sd.clip import init_clip_params
    from cake_tpu_torch.models.sd.sd import (
        SDGenerator, SimpleClipTokenizer, unet_step,
    )
    from cake_tpu_torch.models.sd.unet import init_unet_params
    from cake_tpu_torch.models.sd.vae import init_vae_params
    cfg = tcfg.tiny_sd_config()
    g = torch.Generator().manual_seed(0)
    params = {"clip": init_clip_params(cfg.clip, g),
              "unet": init_unet_params(cfg.unet, g),
              "vae": init_vae_params(cfg.vae, g)}
    def to(t):
        if isinstance(t, dict):
            return {k: to(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to(v) for v in t]
        return t.to(dev)
    gen = SDGenerator(cfg, to(params), [SimpleClipTokenizer(
        cfg.clip.vocab_size)], torch.float32, device=dev)
    gen.shard_for_mesh(distributed.make_multihost_mesh(
        dp=2, devices=distributed.global_devices([dev], 2)))
    r = torch.Generator(device=dev).manual_seed(4)
    lat = torch.randn(1, 8, 8, cfg.unet.in_channels, generator=r,
                      device=dev)
    ctx = torch.randn(2, 77, cfg.unet.cross_attention_dim, generator=r,
                      device=dev)
    run = gen.unet_runner
    for t in (500.0, 300.0, 100.0):     # a capture, then replays
        got = run.run(lat, t, ctx, None, 7.5, True).clone()
        with torch.inference_mode():   # as the generator runs it
            want = unet_step(run.params, run.ucfg, lat,
                             torch.tensor([t], device=dev), ctx, None,
                             torch.tensor([7.5], device=dev), True,
                             replicas=run.replicas, across=run.across)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        assert err <= 1e-4 * scale, (t, err, scale)
    segs = max(len(p) for p, _, _ in run._graphs.values())
    print("UNET OK segments %d hops %d" % (
        segs, distributed.hops().count), flush=True)
    distributed.shutdown()
""")


@pytest.mark.cuda
def test_cuda_unet_segment_graphs_across_processes_match_the_eager_step():
    """Two processes on the card, one dp position each: the captured UNet
    step, a chain of graphs cut at the hops of each half of the
    guidance batch, replays the eager step (f32, within 1e-4 of its
    scale, as the single-process replay test holds it) on both
    processes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the UNet step's graphs run on "
                    "CUDA")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", UNET_WORKER, str(i), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), cwd=str(ROOT)) for i in range(2)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0 and "UNET OK" in out, out[-3000:]
            segs = int(out.split("UNET OK segments ")[1].split()[0])
            assert segs >= 2, out[-500:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
