"""Multi-process sequence parallelism of the port on the CPU: two OS
processes joined by a gloo process group, each owning one position of
JAX's ("sp",) mesh over every process's devices
(`parallel/distributed.make_multihost_sp_mesh`), the weights of one
tiny safetensors checkpoint.

  * The generator: both processes call `generate_on_device` over the
    process-spanning mesh (the ring's K/V chunks cross by send/recv, a
    decode step's q out and attention stats back) and get the greedy
    tokens of JAX's single-process sp generator on the same checkpoint;
    so do stage 2 x sp 2 with a stage a process (the hidden state
    crosses at the stage boundary, each ring stays in its process).
  * `cli.main --api --sp 2` in both processes: the follower replays each
    sp step; the buffered and streamed f32 texts of two chats are JAX's
    single-process sp engine's, /api/v1/cluster shows two processes, and
    SIGTERM stops both.
  * The mesh: positions alternate processes along sp, each process
    holds only its own context shard.

JAX's references are computed once for the module.
"""

import json
import signal
import subprocess
import sys
import textwrap
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
MAX_SEQ, SAMPLE = 320, 8

GEN_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    pid, port, model, topo = sys.argv[1:5]
    from cake_tpu_torch.parallel.distributed import initialize
    assert initialize(coordinator=f"127.0.0.1:{port}", num_processes=2,
                      process_id=int(pid), device=torch.device("cpu"))
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.context import Context
    args = Args(model=model, sp=2, max_seq_len=%d, sample_len=%d,
                temperature=0.0, repeat_penalty=1.0, dtype="f32",
                cpu=True, flash_attention=False,
                topology=topo or None).validate()
    gen = Context.from_args(args).load_text_model()
    mesh = gen._forward_fn._mesh
    held = [pos for pos in np.ndindex(*mesh.devices.shape)
            if gen.cache.sp.ctx_k.shards[pos] is not None]
    if topo:    # a stage a process, its whole sp group
        assert mesh.axis_names == ("stage", "sp")
        assert mesh.ranks.tolist() == [[0, 0], [1, 1]]
        assert held == [(int(pid), 0), (int(pid), 1)], held
    else:       # an sp position a process
        assert mesh.axis_names == ("sp",) and mesh.ranks.tolist() == [0, 1]
        assert held == [(int(pid),)], held
    prompt = np.asarray([[3, 9, 27, 81, 5, 15, 45, 7, 21, 63, 11]],
                        np.int32)
    out = gen.generate_on_device(prompt, np.full((1,), 11, np.int32), 6)
    print("TOKENS:" + json.dumps(np.asarray(out)[0].tolist()), flush=True)
""" % (MAX_SEQ, SAMPLE))

API_WORKER = textwrap.dedent("""
    import os, sys
    pid, port, api_addr, model = sys.argv[1:5]
    os.environ["CAKE_COORDINATOR"] = f"127.0.0.1:{port}"
    os.environ["CAKE_NUM_PROCESSES"] = "2"
    os.environ["CAKE_PROCESS_ID"] = pid
    from cake_tpu_torch import cli
    sys.exit(cli.main([
        "--cpu", "--dtype", "f32", "--model", model, "--sp", "2",
        "--max-seq-len", "%d", "--sample-len", "%d",
        "--temperature", "0.0", "--repeat-penalty", "1.0",
        "--max-slots", "2", "--api", api_addr,
        "--telemetry-interval", "0.2"]))
""" % (MAX_SEQ, SAMPLE))

CHATS = [
    [{"role": "system", "content": "You are a test."},
     {"role": "user", "content": "Say hi"}],
    [{"role": "user", "content": "Count: one two"}],
]


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
def world(tmp_path_factory):
    """The tiny checkpoint, and JAX's single-process sp generator tokens
    and sp engine texts over it."""
    import jax.numpy as jnp

    from cake_tpu.args import Args as JArgs
    from cake_tpu.context import Context as JContext
    from cake_tpu.master import Master as JMaster
    from cake_tpu.models.chat import Message
    from cake_tpu.models.llama.config import LlamaConfig
    from test_stream_load import write_tiny_hf_checkpoint

    tmp = tmp_path_factory.mktemp("multihost_sp")
    model = str(write_tiny_hf_checkpoint(tmp / "model", LlamaConfig.tiny()))
    jargs = JArgs(model=model, sp=2, max_seq_len=MAX_SEQ,
                  sample_len=SAMPLE, temperature=0.0, repeat_penalty=1.0,
                  dtype="f32", max_slots=2)
    gen = JContext.from_args(jargs).load_text_model()
    prompt = np.asarray([[3, 9, 27, 81, 5, 15, 45, 7, 21, 63, 11]],
                        np.int32)
    tokens = np.asarray(gen.generate_on_device(
        prompt, np.full((1,), 11, np.int32), 6))[0].tolist()
    master = JMaster.from_args(jargs)
    eng = master.make_engine()
    texts = []
    with eng:
        for msgs in CHATS:
            h = eng.chat([Message.from_json(m) for m in msgs],
                         max_new_tokens=SAMPLE, temperature=0.0,
                         top_p=1.0)
            assert h.wait(timeout=300)
            texts.append(h.text())
    del jnp
    return dict(model=model, tmp=tmp, tokens=tokens, texts=texts)


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


@pytest.mark.parametrize("layout", ["sp", "stage_sp"])
def test_generator_over_two_processes_is_jaxs_sp_generator(world, layout):
    topo = ""
    if layout == "stage_sp":
        topo = str(world["tmp"] / "topology.yml")
        Path(topo).write_text(TOPOLOGY)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", GEN_WORKER, str(i), str(port),
         world["model"], topo], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_env(), cwd=str(ROOT))
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            assert p.returncode == 0, out[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = [json.loads(next(ln for ln in o.splitlines()
                           if ln.startswith("TOKENS:"))[7:]) for o in outs]
    assert got[0] == got[1] == world["tokens"], got


def _http(method, url, body=None, timeout=120.0):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode() if body is not None else None,
        method=method, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _stream(base, body):
    req = urllib.request.Request(
        base + "/api/v1/chat/completions",
        data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    pieces = []
    with urllib.request.urlopen(req, timeout=120) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: {") and '"choices"' in line:
                pieces.append(json.loads(line[6:])["choices"][0]["delta"]
                              .get("content", ""))
    return "".join(pieces)


def test_api_pair_serves_jaxs_sp_engine_texts(world):
    port, api = _free_port(), _free_port()
    base = f"http://127.0.0.1:{api}"
    logs = [world["tmp"] / f"api_p{i}.log" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", API_WORKER, str(i), str(port),
         f"127.0.0.1:{api}", world["model"]],
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
                if _http("GET", base + "/api/v1/health",
                         timeout=2)["status"] == "ok":
                    break
            except OSError:
                assert time.monotonic() < deadline, "the API never came up"
                time.sleep(0.2)
        assert _http("GET", base + "/api/v1/cluster")["process_count"] == 2
        for msgs, want in zip(CHATS, world["texts"]):
            body = {"messages": msgs, "max_tokens": SAMPLE,
                    "temperature": 0.0, "top_p": 1.0}
            got = _http("POST", base + "/api/v1/chat/completions", body)
            assert got["choices"][0]["message"]["content"] == want, tail(0)
            assert _stream(base, body) == want
        procs[0].send_signal(signal.SIGTERM)
        assert procs[1].wait(60) == 0, tail(1)
        assert procs[0].wait(60) in (0, -signal.SIGTERM), tail(0)
        assert "engine follower: coordinator stopped" in tail(1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# -- on the card --------------------------------------------------------------

CARD_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    pid, port, model = sys.argv[1:4]
    from cake_tpu_torch.parallel.distributed import hops, initialize
    assert initialize(coordinator=f"127.0.0.1:{port}", num_processes=2,
                      process_id=int(pid), device=torch.device("cuda", 0))
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.context import Context
    args = Args(model=model, sp=2, max_seq_len=%d, sample_len=%d,
                temperature=0.0, repeat_penalty=1.0, dtype="f32",
                flash_attention=False).validate()
    gen = Context.from_args(args).load_text_model()
    prompt = np.asarray([[3, 9, 27, 81, 5, 15, 45, 7, 21, 63, 11]],
                        np.int32)
    out = gen.generate_on_device(prompt, np.full((1,), 11, np.int32), 6)
    print("TOKENS:" + json.dumps(np.asarray(out)[0].tolist()), flush=True)
    segs = max(len(p) for p, _, _ in gen._scan._graphs.values())
    print("SEGMENTS:%%d HOPS:%%d" %% (segs, hops().count), flush=True)
""" % (MAX_SEQ, SAMPLE))


def _card_checkpoint(tmp_path) -> str:
    """A tiny safetensors checkpoint written by the port (the card has no
    JAX): seeded numpy weights, the tiny config."""
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
    return str(model)


@pytest.mark.cuda
def test_cuda_sp_segment_graphs_across_processes_give_the_unsharded_tokens(
        tmp_path):
    """Two processes on the card, each one sp position (f32, greedy):
    their generators replay the captured decode step as a chain of
    graphs cut at the hops (q out, stats back, the logits), and give the
    tokens of the unsharded card generator over the same weights."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the segment graphs and the "
                    "hops of card tensors run on CUDA")
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.context import Context

    model = _card_checkpoint(tmp_path)
    gen = Context.from_args(Args(
        model=model, max_seq_len=MAX_SEQ, temperature=0.0,
        repeat_penalty=1.0, dtype="f32",
        flash_attention=False)).load_text_model()
    want = np.asarray(gen.generate_on_device(
        np.asarray([[3, 9, 27, 81, 5, 15, 45, 7, 21, 63, 11]], np.int32),
        np.full((1,), 11, np.int32), 6))[0].tolist()
    del gen
    torch.cuda.empty_cache()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", CARD_WORKER, str(i), str(port), model],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), cwd=str(ROOT)) for i in range(2)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, out[-3000:]
            tokens = json.loads(next(ln for ln in out.splitlines()
                                     if ln.startswith("TOKENS:"))[7:])
            assert tokens == want, (out[-2000:], want)
            seg = next(ln for ln in out.splitlines()
                       if ln.startswith("SEGMENTS:"))
            n_seg, n_hops = (int(x.split(":")[1]) for x in seg.split())
            assert n_seg >= 3 and n_hops > 0, seg
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
