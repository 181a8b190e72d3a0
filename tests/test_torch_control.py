"""The port's multi-process control channel (`cake_tpu_torch/serve/
control.py`) against the JAX package's (`cake_tpu/serve/control.py`):

  * the frames each server writes for the same ops are byte-identical,
    and each package's server feeds the other's client;
  * a peer with a wrong token is dropped without occupying a slot;
  * a gap in the op seq raises ControlDesyncError, and a length past
    MAX_OP_BYTES is refused;
  * after the same publishes, receives and acks, the control families
    of the /metrics text equal JAX's (the publish histogram's count:
    its sums are wall times);
  * the `control.publish` and `control.recv` fault sites fire from a
    --fault-plan;
  * `broadcast_control_address` crosses a gloo process group as a
    length-prefixed uint8 tensor.
"""

import socket
import struct
import threading

import pytest

from cake_tpu_torch.obs import metrics as pm
from cake_tpu_torch.serve import control as pc

TOKEN = "0123456789abcdef0123456789abcdef"
OPS = [
    {"op": "prefill", "ids": [1, 2, 3], "slot": 0, "temp": 0.0,
     "top_p": 1.0, "penalty": 1.0, "prime": [], "n_top": 0},
    {"op": "decode_scan", "rows": [0, 1], "n": 4, "n_top": 0,
     "budget": [4, 4]},
    {"op": "register_prefix", "pid": 0, "ids": [7, 8, 9]},
    {"op": "reset"},
    {"op": "stop"},
]


def _jax():
    from cake_tpu.obs import metrics as jm
    from cake_tpu.serve import control as jc
    return jc, jm


def _raw_follower(port, token=TOKEN):
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    if token is not None:
        s.sendall(struct.pack("!I", len(token)) + token.encode())
    return s


def _served(server_cls, n=1, token=TOKEN, accept_timeout=10.0):
    srv = server_cls(n, host="127.0.0.1", token=token,
                     accept_timeout=accept_timeout)
    return srv


def _accept(srv):
    t = threading.Thread(target=srv.accept_followers, daemon=True)
    t.start()
    return t


def _read_all(sock, n_bytes):
    buf = b""
    while len(buf) < n_bytes:
        part = sock.recv(n_bytes - len(buf))
        if not part:
            break
        buf += part
    return buf


def test_frames_are_byte_identical_to_jax():
    jc, _ = _jax()
    frames = []
    for mod in (jc, pc):
        srv = _served(mod.ControlServer)
        t = _accept(srv)
        s = _raw_follower(srv.port)
        t.join(10)
        for op in OPS:
            srv.publish(op)
        want = sum(4 + len(pc.json.dumps({**op, "seq": i + 1}).encode())
                   for i, op in enumerate(OPS))
        frames.append(_read_all(s, want))
        s.close()
        srv.close()
    assert frames[0] == frames[1]
    assert len(frames[0]) > 0


@pytest.mark.parametrize("server", ["jax", "port"])
def test_each_package_server_feeds_the_other_client(server):
    jc, _ = _jax()
    srv_mod, cli_mod = (jc, pc) if server == "jax" else (pc, jc)
    srv = _served(srv_mod.ControlServer)
    t = _accept(srv)
    cli = cli_mod.ControlClient(f"127.0.0.1:{srv.port}", token=TOKEN,
                                connect_timeout=10)
    t.join(10)
    try:
        for op in OPS:
            srv.publish(op)
        got = [cli.recv(timeout=10) for _ in OPS]
        assert got == [{**op, "seq": i + 1} for i, op in enumerate(OPS)]
        srv.note_ack("proc1", 5)
        assert srv.wire_state() == {
            "published_seq": 5,
            "followers": [{"peer": srv.wire_state()["followers"][0]["peer"],
                           "last_sent_seq": 5}],
            "acks": {"proc1": 5}}
    finally:
        cli.close()
        srv.close()


def test_bad_token_is_refused():
    srv = _served(pc.ControlServer, accept_timeout=1.5)
    bad = _raw_follower(srv.port, token="f" * 32)
    with pytest.raises(TimeoutError, match="0/1 followers"):
        srv.accept_followers()
    # the rogue peer never became a follower and sees no op
    srv.publish({"op": "decode", "rows": [0]})
    bad.settimeout(2)
    assert bad.recv(64) == b""          # dropped: EOF, no frame
    bad.close()
    srv.close()


def test_seq_gap_raises_desync_and_oversized_op_is_refused():
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    port = lst.getsockname()[1]
    got = {}

    def serve():
        conn, _ = lst.accept()
        got["conn"] = conn

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    cli = pc.ControlClient(f"127.0.0.1:{port}", connect_timeout=10)
    t.join(10)
    conn = got["conn"]
    try:
        for seq in (1, 3):
            pc._send_msg(conn, pc.json.dumps(
                {"op": "decode", "seq": seq}).encode())
        assert cli.recv(timeout=10)["seq"] == 1
        with pytest.raises(pc.ControlDesyncError, match="expected 2, got 3"):
            cli.recv(timeout=10)
        conn.sendall(struct.pack("!I", pc.MAX_OP_BYTES + 1))
        with pytest.raises(ValueError, match="oversized control op"):
            cli.recv(timeout=10)
    finally:
        cli.close()
        conn.close()
        lst.close()


def _control_text(mod_metrics) -> list:
    """The control families' lines of a registry's exposition, the
    publish histogram reduced to its count."""
    out = []
    for ln in mod_metrics.REGISTRY.render().splitlines():
        name = ln.split(" ", 3)[2] if ln.startswith("#") else ln
        if not name.startswith("cake_control_"):
            continue
        if ln.startswith("cake_control_publish_seconds") and \
                not ln.startswith("cake_control_publish_seconds_count"):
            continue
        out.append(ln)
    return out


def test_metrics_text_equals_jax_after_the_same_publishes():
    jc, jm = _jax()
    before = (_control_text(jm), _control_text(pm))
    for mod in (jc, pc):
        srv = _served(mod.ControlServer)
        t = _accept(srv)
        cli = mod.ControlClient(f"127.0.0.1:{srv.port}", token=TOKEN,
                                connect_timeout=10)
        t.join(10)
        for op in OPS:
            srv.publish(op)
        for _ in OPS:
            cli.recv(timeout=10)
        srv.note_ack("proc1", 3)
        cli.close()
        srv.close()
    after = (_control_text(jm), _control_text(pm))
    # the same families, HELP and TYPE lines; the same increments
    assert sorted(ln for ln in after[0] if ln.startswith("#")) == \
        sorted(ln for ln in after[1] if ln.startswith("#"))

    def values(lines):
        return {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
                for ln in lines if not ln.startswith("#")}

    deltas = []
    for b, a in zip(before, after):
        vb, va = values(b), values(a)
        deltas.append({k: v - vb.get(k, 0.0) for k, v in va.items()
                       if "follower_lag" not in k
                       and v != vb.get(k, 0.0)})
        deltas[-1]["lag"] = va['cake_control_follower_lag_ops{follower="proc1"}']
    assert deltas[0] == deltas[1], deltas
    assert deltas[1]['cake_control_ops_total{op="decode_scan"}'] == 2.0
    assert deltas[1]["lag"] == 2.0


def test_fault_plan_fires_at_publish_and_recv():
    from cake_tpu_torch.faults import build_injector
    from cake_tpu_torch.faults.plan import InjectedFault

    srv = _served(pc.ControlServer)
    t = _accept(srv)
    cli = pc.ControlClient(f"127.0.0.1:{srv.port}", token=TOKEN,
                           connect_timeout=10)
    t.join(10)
    try:
        srv.faults = build_injector("seed=3;control.publish:nth=2:transient")
        srv.publish(OPS[0])
        with pytest.raises(InjectedFault):
            srv.publish(OPS[1])
        assert srv.published_seq == 1      # the failed op never went out
        cli.faults = build_injector("control.recv:nth=1:oom")
        with pytest.raises(InjectedFault):
            cli.recv(timeout=10)
        cli.faults = None
        assert cli.recv(timeout=10)["seq"] == 1
    finally:
        cli.close()
        srv.close()


def test_broadcast_control_address_over_a_gloo_group():
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        payload = f"127.0.0.1:4242|{TOKEN}|127.0.0.1:4243|"
        assert pc.broadcast_control_address(payload) == payload
        with pytest.raises(ValueError, match="too long"):
            pc.broadcast_control_address("x" * (pc.MAX_ADDR_BYTES + 1))
    finally:
        dist.destroy_process_group()
