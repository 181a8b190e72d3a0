"""Multi-process serving of the port on the CPU: two OS processes joined
by a gloo process group (`parallel/distributed.initialize`, the
CAKE_COORDINATOR path), a 2-stage x tp 2 topology split by process, the
weights streamed stage-locally from one tiny safetensors checkpoint.

  * The generator over the process-spanning mesh: both processes call
    the same `generate_on_device` and get the same greedy tokens, equal
    to JAX's single-process generator on the same checkpoint.
  * `cli.main --api` in both processes: a chat, the same chat streamed
    over SSE, a second conversation sharing the system prompt (a prefix
    hit on the coordinator, the register_prefix op replayed by the
    follower), `/api/v1/cluster` (two processes, gloo), `/api/v1/fleet`
    (proc1 with lag 0 after a drain), then SIGTERM: the follower exits
    0 and the checkpoint is on disk. The greedy f32 texts are JAX's
    single-process engine's.
  * (tests/test_torch_multihost_failover.py) a follower killed in the
    middle of a stream, and a restarted pair resuming the request.
  * The refusals: control over the paged engine (JAX's message), JAX's
    multi-process refusals of an sp mesh that leaves devices out, an
    image --dp other than the total and a component topology with
    multi-process image serving (before any weight loads), and
    `--mode worker` with rc 2.

JAX's references are computed once for the module. `cuda` cases (two
processes on the card) hold a gloo hop of card tensors through the
pinned buffers, and a follower's segment graphs against the unsharded
card generator.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]

TOPOLOGY = """\
worker0:
  host: 10.0.0.1:10128
  layers:
    - model.layers.0-1
worker1:
  host: 10.0.0.2:10128
  layers:
    - model.layers.2-3
"""

GEN_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    pid, port, topo, model, dev, tp = sys.argv[1:7]
    from cake_tpu_torch.parallel.distributed import initialize
    assert initialize(coordinator=f"127.0.0.1:{port}", num_processes=2,
                      process_id=int(pid), device=torch.device(dev))
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.context import Context
    args = Args(model=model, topology=topo, tp=int(tp), max_seq_len=128,
                temperature=0.0, repeat_penalty=1.0, dtype="f32",
                cpu=dev == "cpu", flash_attention=False).validate()
    gen = Context.from_args(args).load_text_model()
    mesh = gen.parallel[1]
    stage_procs = [sorted({int(r) for r in mesh.ranks[:, s, :].flat})
                   for s in range(mesh.shape["stage"])]
    assert stage_procs == [[0], [1]], stage_procs
    # only this process's positions hold weights
    emb = gen.params["embed"]
    held = [pos for pos in np.ndindex(*emb.shards.shape)
            if emb.shards[pos] is not None]
    assert all(mesh.owns(pos) for pos in held) and len(held) == int(tp)
    prompt = np.full((1, 9), 5, np.int32)
    out = gen.generate_on_device(prompt, np.full((1,), 9, np.int32), 6)
    print("TOKENS:" + json.dumps(np.asarray(out)[0].tolist()), flush=True)
    if dev != "cpu":
        from cake_tpu_torch.parallel.distributed import hops
        runner = gen._scan
        segs = max(len(p) for p, _, _ in runner._graphs.values())
        print("SEGMENTS:%d HOPS:%d" % (segs, hops().count), flush=True)
""")

API_WORKER = textwrap.dedent("""
    import os, sys
    pid, port, topo, api_addr, ckpt, model = sys.argv[1:7]
    extra = sys.argv[7:]
    os.environ["CAKE_COORDINATOR"] = f"127.0.0.1:{port}"
    os.environ["CAKE_NUM_PROCESSES"] = "2"
    os.environ["CAKE_PROCESS_ID"] = pid
    from cake_tpu_torch import cli
    sys.exit(cli.main([
        "--cpu", "--dtype", "f32", "--model", model, "--topology", topo,
        "--tp", "2", "--max-seq-len", "256", "--temperature", "0.0",
        "--repeat-penalty", "1.0", "--max-slots", "2", "--api", api_addr,
        "--checkpoint", ckpt, "--decode-scan", "4", "--auto-prefix",
        "--telemetry-interval", "0.2",
    ] + extra))
""")

MESSAGES = [
    {"role": "system", "content": "You are a test."},
    {"role": "user", "content": "Say hi"},
]
SECOND = [MESSAGES[0], {"role": "user", "content": "Say more"}]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    # the tiny model needs no intra-op threads; two processes with one a
    # core each would crowd the test workers beside them
    env["OMP_NUM_THREADS"] = "1"
    return env


def _http_json(method, url, body=None, timeout=30.0):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _until(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.1)
    assert cond(), f"timed out waiting for {what}"


def jax_world(tmp, convs):
    """The tiny checkpoint, the topology, and JAX's references over it:
    the single-process engine's (text, prompt ids, out tokens) of each
    (max_seq_len, max_new_tokens, messages) in `convs`."""
    import jax.numpy as jnp

    from cake_tpu.models import load_text_params
    from cake_tpu.models.chat import Message
    from cake_tpu.models.llama.config import LlamaConfig
    from cake_tpu.models.llama.generator import ByteTokenizer
    from cake_tpu.ops.sampling import SamplingConfig
    from cake_tpu.serve.engine import InferenceEngine
    from test_stream_load import write_tiny_hf_checkpoint

    cfg = LlamaConfig.tiny()
    model = write_tiny_hf_checkpoint(tmp / "model", cfg)
    topo = tmp / "topology.yml"
    topo.write_text(TOPOLOGY)
    params = load_text_params(cfg, model, jnp.float32)
    greedy = SamplingConfig(temperature=0.0, repeat_penalty=1.0)
    out = []
    for max_seq_len, max_new, msgs in convs:
        eng = InferenceEngine(cfg, params, ByteTokenizer(cfg.vocab_size),
                              max_slots=2, max_seq_len=max_seq_len,
                              sampling=greedy)
        with eng:
            h = eng.chat([Message.from_json(m) for m in msgs],
                         max_new_tokens=max_new, temperature=0.0,
                         top_p=1.0)
            assert h.wait(timeout=300)
            out.append((h.text(), list(h._req.prompt_ids),
                        list(h._req.out_tokens)))
    return dict(model=model, topo=str(topo), tmp=tmp, cfg=cfg,
                params=params, chats=out)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's references: the generator's greedy tokens and the engine's
    texts of MESSAGES and SECOND."""
    from cake_tpu.models.llama.generator import ByteTokenizer, LlamaGenerator
    from cake_tpu.ops.sampling import SamplingConfig

    w = jax_world(tmp_path_factory.mktemp("multihost"),
                  [(256, 8, MESSAGES), (256, 8, SECOND)])
    gen = LlamaGenerator(
        w["cfg"], w["params"], ByteTokenizer(w["cfg"].vocab_size),
        max_seq_len=128,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0))
    w["gen_tokens"] = np.asarray(gen.generate_on_device(
        np.full((1, 9), 5, np.int32), np.full((1,), 9, np.int32),
        6))[0].tolist()
    w["texts"] = [t for t, _, _ in w["chats"]]
    return w


def _launch(world, tag, extra=(), ckpt=None):
    port, api = _free_port(), _free_port()
    addr = f"127.0.0.1:{api}"
    ckpt = ckpt or str(world["tmp"] / f"{tag}.ckpt")
    logs = [world["tmp"] / f"{tag}_p{i}.log" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", API_WORKER, str(i), str(port), world["topo"],
         addr, ckpt, world["model"]] + list(extra),
        stdout=open(logs[i], "w"), stderr=subprocess.STDOUT,
        env=_env(), cwd=str(ROOT)) for i in range(2)]
    base = f"http://{addr}"

    def tail(i):
        return logs[i].read_text()[-3000:] if logs[i].exists() else ""

    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if any(p.poll() is not None for p in procs):
            raise AssertionError(f"worker died at startup:\n{tail(0)}\n"
                                 f"---\n{tail(1)}")
        try:
            if _http_json("GET", base + "/api/v1/health",
                          timeout=2.0)["status"] == "ok":
                return procs, base, ckpt, tail
        except OSError:
            time.sleep(0.2)
    raise AssertionError("the API never came up")


def _kill_all(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _stream(base, body, on_chunk=None, timeout=120.0):
    req = urllib.request.Request(
        base + "/api/v1/chat/completions",
        data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    pieces = []
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            obj = json.loads(line[6:])
            if "choices" not in obj:
                continue
            piece = obj["choices"][0]["delta"].get("content", "")
            if piece:
                pieces.append(piece)
                if on_chunk is not None:
                    on_chunk(len(pieces))
    return "".join(pieces)


def _run_pair(script_args, timeout=180):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", GEN_WORKER, str(i), str(port)]
        + script_args, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_env(), cwd=str(ROOT)) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0, out[-3000:]
            outs.append(out)
    finally:
        _kill_all(procs)
    return outs


def _tokens(out):
    line = next(ln for ln in out.splitlines() if ln.startswith("TOKENS:"))
    return json.loads(line[len("TOKENS:"):])


def test_generator_over_two_processes_matches_jax(world):
    outs = _run_pair([world["topo"], world["model"], "cpu", "2"])
    got = [_tokens(o) for o in outs]
    assert got[0] == got[1] == world["gen_tokens"], got


def test_api_pair_serves_streams_replays_prefixes_and_shuts_down(world):
    procs, base, ckpt, tail = _launch(world, "api")
    try:
        cluster = _http_json("GET", base + "/api/v1/cluster")
        assert cluster["process_count"] == 2
        assert cluster["backend"] == "gloo"
        body = {"messages": MESSAGES, "max_tokens": 8,
                "temperature": 0.0, "top_p": 1.0}
        resp = _http_json("POST", base + "/api/v1/chat/completions", body,
                          timeout=120)
        assert resp["choices"][0]["message"]["content"] == \
            world["texts"][0], tail(0)
        assert _stream(base, body) == world["texts"][0]
        resp2 = _http_json("POST", base + "/api/v1/chat/completions",
                           {**body, "messages": SECOND}, timeout=120)
        assert resp2["choices"][0]["message"]["content"] == \
            world["texts"][1]
        metrics = urllib.request.urlopen(base + "/metrics",
                                         timeout=10).read().decode()
        vals = {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
                for ln in metrics.splitlines()
                if ln and not ln.startswith("#")}
        assert vals["cake_engine_prefix_hits_total"] > 0
        assert vals['cake_control_ops_total{op="register_prefix"}'] == 1
        assert vals["cake_serving_healthy"] == 1

        def drained():
            f = _http_json("GET", base + "/api/v1/fleet")
            h = f["hosts"].get("proc1", {})
            return (h.get("lag_ops") == 0 and h.get("applied_seq")
                    == f["published_seq"])
        _until(drained, "proc1 to report lag 0")

        procs[0].send_signal(signal.SIGTERM)
        assert procs[1].wait(60) == 0, tail(1)
        assert procs[0].wait(60) in (0, -signal.SIGTERM), tail(0)
        assert os.path.exists(ckpt), "checkpoint not written on SIGTERM"
        assert "engine follower: coordinator stopped" in tail(1)
    finally:
        _kill_all(procs)


def test_control_refuses_the_paged_engine_with_jaxs_message():
    import torch

    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.serve.engine import InferenceEngine

    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    msgs = []
    for kw in (dict(kv_pages=32), {}):
        eng = InferenceEngine(cfg, params, ByteTokenizer(cfg.vocab_size),
                              max_slots=2, max_seq_len=128, device="cpu",
                              **kw)
        with pytest.raises(ValueError) as e:
            eng.attach_control(object())
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert msgs[0].startswith(
        "multi-host control requires pipelined step fns")
    assert "--kv-pages" in msgs[0]


@pytest.mark.parametrize("case", ["sp_span", "image_dp", "image_topology"])
def test_multiprocess_sp_and_image_refusals_are_jaxs(monkeypatch, tmp_path,
                                                     case):
    """JAX's multi-process refusals, in its words and before any weight
    loads: an sp mesh that leaves devices out (cake_tpu/context.py's span
    check), an image --dp other than the total device count, and an SD
    component topology with multi-process image serving."""
    import torch

    import cake_tpu_torch.parallel.distributed as pdist
    from cake_tpu_torch.args import Args, ModelType, SDArgs
    from cake_tpu_torch.context import Context

    monkeypatch.setattr(pdist, "process_count", lambda: 2)
    loaded = []
    import cake_tpu_torch.models as models
    monkeypatch.setattr(models, "load_text_params",
                        lambda *a, **k: loaded.append(a))
    cpus = [torch.device("cpu")] * 2     # two devices a process: four
    if case == "sp_span":
        ctx = Context.from_args(Args(cpu=True, sp=2, max_seq_len=256),
                                mesh_devices=cpus)
        with pytest.raises(ValueError) as e:
            ctx.load_text_model()
        assert str(e.value) == (
            "multi-host --sp meshes must span every device: sp x tp "
            "(x dp/stages) = 2 != 4 global devices")
    else:
        from cake_tpu_torch.models.sd import sd as sd_mod
        monkeypatch.setattr(sd_mod.SDGenerator, "load", classmethod(
            lambda cls, ctx: loaded.append(ctx)))
        if case == "image_dp":
            ctx = Context.from_args(Args(cpu=True, dp=3,
                                         model_type=ModelType.IMAGE),
                                    SDArgs(), mesh_devices=cpus)
            want = ("multi-host image serving meshes over ALL 4 devices; "
                    "--dp 3 cannot be honored (drop the flag or set it to "
                    "the total device count)")
        else:
            topo = tmp_path / "sd.yml"
            topo.write_text("w0:\n  host: 10.0.0.1:1\n  layers:\n"
                            "    - unet\n")
            ctx = Context.from_args(Args(cpu=True, topology=str(topo),
                                         model_type=ModelType.IMAGE),
                                    SDArgs())
            want = ("multi-host image serving (which meshes the whole "
                    "pipeline) and an SD component topology are mutually "
                    "exclusive: one SPMD program cannot mix mesh-sharded "
                    "and committed-to-device components")
        with pytest.raises(ValueError) as e:
            ctx.load_image_model()
        assert str(e.value) == want
    assert loaded == []


def test_mode_worker_is_explained_with_rc_2(capsys):
    from cake_tpu_torch import cli

    assert cli.main(["--mode", "worker"]) == 2
    assert "no separate worker process" in capsys.readouterr().err


# -- on the card -----------------------------------------------------------------

def _cuda_or_skip():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the hops of card tensors and "
                    "the segment graphs run on CUDA")


HOP_WORKER = textwrap.dedent("""
    import sys
    import torch
    pid, port = int(sys.argv[1]), sys.argv[2]
    from cake_tpu_torch.parallel import distributed
    assert distributed.initialize(coordinator=f"127.0.0.1:{port}",
                                  num_processes=2, process_id=pid,
                                  device=torch.device("cuda", 0))
    assert distributed.hop_backend() == "gloo"   # two ranks, one card
    hops = distributed.hops()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(4, 1, 4096, device=dev, generator=g,
                    dtype=torch.bfloat16)
    for _ in range(3):                 # the pinned buffers are reused
        if pid == 0:
            hops.send(x, 1)
            y = hops.recv((4, 1, 4096), torch.bfloat16, dev, 1)
        else:
            y = hops.recv((4, 1, 4096), torch.bfloat16, dev, 0)
            hops.send(y * 2, 0)
        want = x * 2 if pid == 0 else x
        assert y.device == dev and torch.equal(y, want)
    assert len(hops._pinned) == 2
    print("HOP OK", flush=True)
    distributed.shutdown()
""")


@pytest.mark.cuda
def test_cuda_gloo_hop_of_card_tensors_through_pinned_buffers():
    _cuda_or_skip()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", HOP_WORKER, str(i), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), cwd=str(ROOT)) for i in range(2)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0 and "HOP OK" in out, out[-3000:]
    finally:
        _kill_all(procs)


@pytest.mark.cuda
def test_cuda_follower_segment_graphs_replay_the_unsharded_tokens(tmp_path):
    """Both processes' generators on the card (f32, greedy) replay their
    captured decode step as a chain of graphs cut at the hops, and give
    the tokens of the unsharded card generator over the same weights."""
    _cuda_or_skip()
    import torch

    from cake_tpu_torch.args import Args
    from cake_tpu_torch.context import Context
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.utils.loading import save_safetensors

    cfg = LlamaConfig.tiny()
    rng = np.random.default_rng(7)
    D, F = cfg.hidden_size, cfg.intermediate_size
    H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    shapes = {"self_attn.q_proj.weight": (H * hd, D),
              "self_attn.k_proj.weight": (KV * hd, D),
              "self_attn.v_proj.weight": (KV * hd, D),
              "self_attn.o_proj.weight": (D, H * hd),
              "mlp.gate_proj.weight": (F, D), "mlp.up_proj.weight": (F, D),
              "mlp.down_proj.weight": (D, F),
              "input_layernorm.weight": (D,),
              "post_attention_layernorm.weight": (D,)}
    tensors = {f"model.layers.{i}.{k}": (rng.standard_normal(s) * 0.02
                                         ).astype(np.float32)
               for i in range(cfg.num_hidden_layers)
               for k, s in shapes.items()}
    tensors["model.embed_tokens.weight"] = (rng.standard_normal(
        (cfg.vocab_size, D)) * 0.02).astype(np.float32)
    tensors["model.norm.weight"] = np.ones((D,), np.float32)
    tensors["lm_head.weight"] = (rng.standard_normal(
        (cfg.vocab_size, D)) * 0.02).astype(np.float32)
    model = tmp_path / "model"
    model.mkdir()
    save_safetensors(str(model / "model.safetensors"), tensors)
    (model / "config.json").write_text(json.dumps({
        "vocab_size": cfg.vocab_size, "hidden_size": D,
        "intermediate_size": F, "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": H, "num_key_value_heads": KV,
        "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_position_embeddings,
        "bos_token_id": cfg.bos_token_id,
        "eos_token_id": list(cfg.eos_token_ids)}))
    topo = tmp_path / "topology.yml"
    topo.write_text(TOPOLOGY)

    args = Args(model=str(model), max_seq_len=128, temperature=0.0,
                repeat_penalty=1.0, dtype="f32", flash_attention=False)
    gen = Context.from_args(args).load_text_model()
    want = np.asarray(gen.generate_on_device(
        np.full((1, 9), 5, np.int32), np.full((1,), 9, np.int32),
        6))[0].tolist()
    del gen
    torch.cuda.empty_cache()
    # one card a process: one stage each, no tp
    outs = _run_pair([str(topo), str(model), "cuda", "1"])
    for out in outs:
        assert _tokens(out) == want, (out[-2000:], want)
        seg = next(ln for ln in out.splitlines()
                   if ln.startswith("SEGMENTS:"))
        n_seg, n_hops = (int(x.split(":")[1]) for x in seg.split())
        assert n_seg >= 3 and n_hops > 0, seg
