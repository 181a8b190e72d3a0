"""Command-line entry point: `python -m cake_tpu_torch.cli`.

Counterpart of `cake_tpu/cli.py:main` for one device:

    python -m cake_tpu_torch.cli --model DIR --prompt "..."   # one-shot
    python -m cake_tpu_torch.cli --model DIR --api 0.0.0.0:8080
    python -m cake_tpu_torch.cli --cpu --prompt hi --sample-len 4
    python -m cake_tpu_torch.cli --batch-size 2 --tracing /tmp/trace
    python -m cake_tpu_torch.cli --model DIR --draft-model DRAFT
    python -m cake_tpu_torch.cli --model DIR --api 0.0.0.0:8080 \
        --kv-pages 512 --spec-draft DRAFT --repeat-penalty 1.0
    python -m cake_tpu_torch.cli --model-type image --sd-version v1-5 \
        --image-prompt "a red barn" --sd-n-steps 20      # image_0.png
    python -m cake_tpu_torch.cli --model-type image --api 0.0.0.0:8080
    python -m cake_tpu_torch.cli --model DIR --topology topology.yml \
        --tp 2 --microbatches 2 --api 0.0.0.0:8080     # sharded serving

Without --model the model is the tiny config with random weights;
`<model>/tokenizer.json` is read by the port's own reader
(models/llama/tokenizer.py). It runs on cuda:<--device-idx> and raises
when there is no card, unless --cpu is given. `--api` serves the dense
engine without --kv-pages (the ring engine for a sliding-window config
shorter than --max-seq-len) and the paged engine with it.
`--draft-model` is the batch-1 speculative generator of one-shot
generation, and with --api the dense spec engine (batched rounds over
every slot); `--spec-draft` serves paged speculative rows (a row
speculates only at repeat_penalty 1.0, so pass --repeat-penalty 1.0).
A `config.json` of `model_type: "mixtral"` loads the mixture-of-experts
family. `--model-type image` loads Stable Diffusion (--sd-* weights
from their paths or the local HF cache, else random): one-shot it
writes image_N.png into the working directory, with --api it serves
POST /api/v1/image.

`--topology FILE` maps contiguous block ranges onto pipeline stages,
`--tp` shards each stage's heads and ffn, `--dp` the generator's batch
rows (an image model's UNet batch), `--microbatches` the GPipe schedule
(parallel/): the one-shot generator and the --api engine then run the
pipelined steps over a mesh of the visible cards (the CPU at every
position with --cpu). `--sp N` splits the context window over an "sp"
axis instead (parallel/context_parallel.py: ring-attention prefill,
merged-stats decode against a replicated tail), with `--tp`, `--dp` or
a topology's stages: the one-shot generator runs SPGeneratorForward,
--api the sp engine:

    python -m cake_tpu_torch.cli --model DIR --sp 4 --max-seq-len 4112 \
        --api 0.0.0.0:8080
    python -m cake_tpu_torch.cli --cpu --sp 2 --max-seq-len 512 --prompt hi

Multi-process serving: every process runs the same command, with
CAKE_COORDINATOR=host:port (the process group's rendezvous, hosted by
process 0), CAKE_NUM_PROCESSES and CAKE_PROCESS_ID; process 0 serves
the API and publishes each engine step over the control channel
(serve/control.py), the others replay it (`_serve_multihost`).
CAKE_CONTROL_HOST names the address the followers dial (default the
coordinator's host):

    CAKE_COORDINATOR=10.0.0.1:29500 CAKE_NUM_PROCESSES=2 CAKE_PROCESS_ID=0 \
        python -m cake_tpu_torch.cli --model DIR --topology topo.yml \
        --api 0.0.0.0:8080
    CAKE_COORDINATOR=10.0.0.1:29500 CAKE_NUM_PROCESSES=2 CAKE_PROCESS_ID=1 \
        python -m cake_tpu_torch.cli --model DIR --topology topo.yml \
        --api 0.0.0.0:8080

The front-door router (router/) is a third process role with no weights
and no card: it spreads chats over `--api` replicas by the system
prompt's prefix fingerprint (page-aligned through `<model>/tokenizer.json`
when --model names a directory), polls their lite health and fails a
keyed stream over to a survivor. Replicas are named with --replicas or
join by announcing themselves (--router-announce on both roles, the
token in $CAKE_ANNOUNCE_TOKEN):

    python -m cake_tpu_torch.cli --model DIR --api 127.0.0.1:8001 \
        --kv-pages 512 --auto-prefix --router-announce 127.0.0.1:9000
    python -m cake_tpu_torch.cli --router --model DIR \
        --api 127.0.0.1:8080 --replicas 127.0.0.1:8002 \
        --router-announce 127.0.0.1:9000
"""

from __future__ import annotations

import logging
import os
import sys


def _serve_multihost(master, args) -> int:
    """Serve the REST API over a mesh that spans processes.

    Every process runs the positions it owns and hops to the others
    inside each step, so the coordinator publishes one op record per
    engine step over a TCP control channel and every other process
    replays it (JAX's `_serve_multihost`, with its teardown order).
    Every process runs this same command; its role comes from the
    process group (parallel/distributed.initialize)."""
    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.parallel.distributed import (
        is_coordinator, process_count, process_index,
    )
    from cake_tpu_torch.serve.control import (
        ControlClient, ControlServer, broadcast_control_address,
    )

    # an image model: Context.load_image_model split its UNet batch over
    # a ("dp",) mesh of every process's devices; a generation follows
    # from its args (the seed rides in them), so one op a request: the
    # followers replay master.generate_image (_run_image_follower)
    image_mode = master.llm is None
    engine = None
    if not image_mode:
        if args.sp > 1 and args.dp > 1:
            # dp x sp shards the slot axis over dp: decode outputs would
            # be process-local, which the replicated logits cannot serve
            raise ValueError(
                "dp x sp serving is single-host only (dp-sharded "
                "decode outputs are process-local); drop --dp or "
                "serve on one host")
        if args.draft_model is not None:
            raise ValueError(
                "this serving mode (--draft-model multi-host, or an "
                "sp composition without an engine contract) has no "
                "multi-host step replay; serve it on one host")
        # every process builds the identical engine
        engine = master.make_engine()
        # the pre-fail capture must outlive the heartbeat stale window
        # (the monitor is exactly the late-arriving consumer)
        engine.fail_recs_ttl = args.heartbeat_timeout + 60.0
    # a model without a cross-process placement runs entirely inside the
    # coordinator: the followers idle on the channel until the stop op.
    # An sp model (its forward, no plan) is cross-process: every step
    # is replayed
    replayed = (image_mode
                or getattr(master.llm, "parallel", None) is not None
                or getattr(master.llm, "_forward_fn", None) is not None)
    n = process_count()
    if is_coordinator():
        import secrets
        import signal
        import threading

        from cake_tpu_torch.parallel.health import ServingHealth

        token = secrets.token_hex(16)
        adv = _advertised_host(args)
        try:
            control = ControlServer(n - 1, host=adv, token=token)
            bind_host = adv
        except OSError:
            # the advertised name may not be a bindable interface (NAT,
            # aliases): all interfaces, the token still gates the channel
            control = ControlServer(n - 1, token=token)
            bind_host = ""
        # follower heartbeats feed the serving health: a dead process
        # 503s the API instead of leaving the next hop waiting. An image
        # model has no engine to watch: a dead follower shows as the
        # next generation's publish error
        health = None
        hb_adv = ""
        if engine is not None:
            health = ServingHealth(engine, stall_after_s=args.stall_timeout)
            hb_addr = health.expect_workers(
                [f"proc{i}" for i in range(1, n)], bind_host=bind_host,
                stale_after_s=args.heartbeat_timeout)
            hb_adv = f"{adv}:{hb_addr.rsplit(':', 1)[1]}"
        # fleet telemetry federation (obs/federation.py), token-gated
        # with the control secret
        collector = None
        tel_adv = ""
        tel_enabled, tel_interval = master.telemetry_settings()
        if tel_enabled:
            from cake_tpu_torch.obs.federation import TelemetryCollector
            tel_kwargs = dict(
                token=token, control=control, local_host="proc0",
                stale_after_s=max(args.heartbeat_timeout,
                                  3 * tel_interval),
                max_hosts=max(8, 2 * n))
            try:
                collector = TelemetryCollector(host=bind_host, **tel_kwargs)
            except OSError:
                collector = TelemetryCollector(**tel_kwargs)
            tel_adv = f"{adv}:{collector.port}"
        broadcast_control_address(
            f"{adv}:{control.port}|{token}|{hb_adv}|{tel_adv}")
        control.accept_followers()
        if image_mode:
            master.attach_image_control(control)
        elif replayed:
            engine.attach_control(control)

        done = threading.Event()

        def teardown():
            # the order matters: stop (publishes the stop op), then wait
            # for each control socket's EOF (the follower is about to
            # leave the process group), then close the collector (the
            # followers' last frames have come), then leave the group,
            # whose store this process hosts
            if done.is_set():
                return
            done.set()
            try:
                if health is not None:
                    health.close()
            except Exception:  # noqa: BLE001
                pass
            if engine is not None:
                engine.stop()
            if engine is None or not replayed:
                # image and idle followers get no stop from an engine
                try:
                    control.publish({"op": "stop"})
                except Exception:  # noqa: BLE001
                    pass
            control.wait_closed()
            _hop_report(engine)
            if collector is not None:
                try:
                    collector.close()
                except Exception:  # noqa: BLE001
                    pass
            control.close()
            _distributed_shutdown()

        def on_sigterm(signum, frame):
            # api.start's own handler saves first and chains here; exit
            # 0 instead of a default-handler death that would strand
            # the followers mid-heartbeat
            teardown()
            os._exit(0)

        try:
            signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:
            pass  # not the main thread; the caller owns signals
        try:
            start(master, address=args.api, engine=engine,
                  checkpoint_path=args.checkpoint, health=health,
                  collector=collector, **_announce_kwargs(args))
        finally:
            teardown()
    else:
        from cake_tpu_torch.parallel.health import HeartbeatSender

        payload = broadcast_control_address(None)
        addr, _, rest = payload.partition("|")
        token, _, rest = rest.partition("|")
        hb_addr, _, tel_addr = rest.partition("|")
        client = ControlClient(addr, token=token or None)
        if args.fault_plan:
            # follower-side chaos: control.recv rules fire here (the
            # plan string is the same on every process)
            from cake_tpu_torch.faults import build_injector
            client.faults = build_injector(args.fault_plan)
        proc_name = f"proc{process_index()}"
        beat = HeartbeatSender(hb_addr, proc_name) if hb_addr else None
        exporter = None
        tel_enabled, tel_interval = master.telemetry_settings()
        if tel_enabled and tel_addr:
            from cake_tpu_torch.obs.federation import TelemetryExporter

            def _health_snapshot(beat=beat):
                out = {}
                if beat is not None:
                    out["heartbeat_ok"] = beat.alive_within(
                        beat.worst_case_gap_s)
                return out

            exporter = TelemetryExporter(
                tel_addr, host=proc_name, token=token or None,
                interval_s=tel_interval,
                events=engine.events if engine is not None else None,
                flight=engine.flight if engine is not None else None,
                applied_seq=((lambda: engine.applied_op_seq)
                             if engine is not None else None),
                health_snapshot=_health_snapshot)
        try:
            if image_mode:
                _run_image_follower(master, client)
            else:
                # the liveness window covers the sender's worst quiet gap
                # (a monitor blip parks it in a capped backoff, which is
                # no evidence that the coordinator died)
                hb_window = max(args.heartbeat_timeout,
                                beat.worst_case_gap_s if beat is not None
                                else 5.0)
                engine.run_follower_loop(
                    client,
                    op_timeout_s=hb_window if beat is not None else None,
                    liveness=((lambda: beat.alive_within(hb_window))
                              if beat is not None else None))
        finally:
            _hop_report(engine)
            if exporter is not None:
                # the terminal frame (the final applied seq: the fleet's
                # lag drains to 0) before the control socket's EOF, for
                # which the coordinator keeps its collector open
                exporter.close(flush=True)
            if beat is not None:
                beat.close()
            # the socket's EOF first, then leave the process group: the
            # coordinator leaves it only after every EOF
            client.close()
            _distributed_shutdown()
    return 0


def _run_image_follower(master, client) -> None:
    """An image model's follower: replay each generation op. A
    generation follows from its args (the seed rides in them), so
    master.generate_image with the coordinator's args runs the same
    steps and meets the same hops. A failed replay disconnects: the
    coordinator's next publish then fails instead of a hop waiting
    forever."""
    from cake_tpu_torch.args import ImageGenerationArgs

    log = logging.getLogger(__name__)
    log.info("image follower: replaying generation ops")
    while True:
        op = client.recv()
        if op is None or op.get("op") == "stop":
            log.info("image follower: coordinator %s",
                     "stopped" if op else "closed the channel")
            return
        if op.get("op") != "image":
            log.error("image follower: unknown op %r", op.get("op"))
            continue
        try:
            master.generate_image(ImageGenerationArgs.from_json(op["args"]),
                                  lambda _pngs: None)
        except Exception:  # noqa: BLE001
            log.exception("image follower: generation replay failed; "
                          "disconnecting")
            return


def _hop_report(engine) -> None:
    """One log line of this process's cross-process cost at teardown:
    the hops replayed between graphs and their host seconds, the graphs
    each captured decode step is cut into (one replay each a step), and
    the kernels' launch counts."""
    import json

    from cake_tpu_torch.parallel.distributed import hops
    from cake_tpu_torch.serve.graphs import COUNTERS
    h = hops()
    runner = engine._runner if engine is not None else None
    segs = ({str(v): len(g[0]) for v, g in runner._graphs.items()}
            if runner is not None else {})
    launches = {k: n for c in COUNTERS for k, n in c.items() if n}
    logging.getLogger(__name__).info("multihost report: %s", json.dumps({
        "hops": h.count, "hop_seconds": h.seconds,
        "decode_segments": segs, "launches": launches}))


def _distributed_shutdown() -> None:
    try:
        from cake_tpu_torch.parallel.distributed import shutdown
        shutdown()
    except Exception:  # noqa: BLE001 — teardown must never mask the exit
        logging.getLogger(__name__).debug("distributed shutdown failed",
                                          exc_info=True)


def _advertised_host(args) -> str:
    """The address followers use to reach the coordinator's control
    socket: CAKE_CONTROL_HOST, else the host the process group's
    rendezvous was reached at (CAKE_COORDINATOR), else this host's
    name."""
    import socket

    if os.environ.get("CAKE_CONTROL_HOST"):
        return os.environ["CAKE_CONTROL_HOST"]
    coord = os.environ.get("CAKE_COORDINATOR", "")
    if ":" in coord:
        return coord.rsplit(":", 1)[0]
    return socket.gethostname()


def _announce_kwargs(args) -> dict:
    """start()'s announce arguments under --router-announce (a replica
    registering itself with a router), else none."""
    if not args.router_announce:
        return {}
    return dict(announce=args.router_announce,
                announce_interval_s=args.announce_interval,
                announce_token=os.environ.get("CAKE_ANNOUNCE_TOKEN"))


def _serve_router(args) -> int:
    """The router process role: no weights and no card, a thin HTTP
    front door (router/) over --replicas and the replicas that announce
    themselves. With a --model directory holding tokenizer.json the
    affinity keys are page-aligned token fingerprints; otherwise
    system-prompt text fingerprints (RouterServer warns once)."""
    from cake_tpu_torch.args import parse_replicas
    from cake_tpu_torch.router import start_router

    log = logging.getLogger(__name__)
    replicas = parse_replicas(args.replicas) if args.replicas else []
    tokenizer = None
    if args.model:
        try:
            from cake_tpu_torch.models.llama.generator import load_tokenizer
            tokenizer = load_tokenizer(args.model)
        except Exception as e:  # noqa: BLE001 — degraded, not fatal
            log.warning("router: could not load tokenizer from %s "
                        "(%s); affinity falls back to text "
                        "fingerprints", args.model, e)
    address = args.api or args.address
    log.info("router: fronting %d replica(s) on %s", len(replicas),
             address)
    start_router(replicas, address=address, tokenizer=tokenizer,
                 poll_interval_s=args.router_poll,
                 load_watermark=args.router_watermark,
                 policy_mode=args.router_policy,
                 trace_ring=args.trace_ring,
                 trace_events=args.trace_events,
                 event_ring=args.event_ring,
                 event_log=args.event_log,
                 sentinel=args.sentinel,
                 sentinel_interval_s=args.sentinel_interval,
                 anomaly_weighting=args.router_anomaly_weighting,
                 announce=args.router_announce,
                 announce_interval_s=args.announce_interval,
                 announce_token=os.environ.get("CAKE_ANNOUNCE_TOKEN"))
    return 0


def router_main(argv=None) -> int:
    """The router's entry: main with --router implied."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--router" not in argv:
        argv = ["--router"] + argv
    return main(argv)


def main(argv=None) -> int:
    from cake_tpu_torch.args import ModelType, parse_all_args
    from cake_tpu_torch.master import Master

    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] %(levelname)s %(name)s: %(message)s")
    args, sd_args, img_args = parse_all_args(argv)
    warn = logging.getLogger(__name__).warning
    if args.router:
        # before any context, process group or card: the router loads
        # no weights and joins no mesh
        return _serve_router(args)
    if args.replicas:
        warn("--replicas has no effect without --router: the replica "
             "list names the backends of the front-door router "
             "(router/)")
    if args.router_announce and not args.api:
        warn("--router-announce has no effect without --api (or "
             "--router): a replica announces its serving address to "
             "the front door (router/discovery.py)")
    if args.router_anomaly_weighting:
        warn("--router-anomaly-weighting has no effect without "
             "--router: the placement de-weighting actuator runs in "
             "the front-door process (router/)")
    if args.disagg and not args.api:
        # the prefill/decode split is a pair of SERVING engines wired by
        # the transfer channel; a one-shot generation has neither: warn
        # AND clear, so no channel is bound or dialed
        warn("--disagg applies to engine serving (--api): a one-shot "
             "generation has no peer to ship KV pages to "
             "(kv/transfer.py); ignoring it")
        args.disagg = None
    if args.journal_fsync != "batch" and not args.journal:
        logging.getLogger(__name__).warning(
            "--journal-fsync has no effect without --journal: it tunes "
            "the write-ahead request journal's durability barrier "
            "(serve/journal.py)")
    if args.mode == "worker":
        print(
            "cake-tpu runs the whole topology as one program per process "
            "over the device mesh; there is no separate worker process. "
            "Run every process in master mode, each with its "
            "CAKE_PROCESS_ID.",
            file=sys.stderr,
        )
        return 2
    # multi-process: every process runs this same program; the process
    # group's coordinates come from the CAKE_* variables
    from cake_tpu_torch.parallel.distributed import (
        initialize, process_count,
    )
    import torch
    initialize(device=torch.device(
        "cpu" if args.cpu else f"cuda:{args.device_idx}"))
    master = Master.from_args(args, sd_args)
    if args.api:
        from cake_tpu_torch.api.server import start
        if process_count() > 1:
            return _serve_multihost(master, args)
        if args.telemetry_export:
            # the federation plane ships follower telemetry to the
            # coordinator; one process has no followers to federate
            warn("--telemetry-export has no effect on single-host "
                 "serving: there are no follower processes to "
                 "federate (obs/federation.py); /api/v1/fleet will "
                 "report only this host")
        kw = ({"checkpoint_path": args.checkpoint} if args.checkpoint
              else {})
        kw.update(_announce_kwargs(args))
        start(master, address=args.api, **kw)
        return 0
    if args.telemetry_export:
        # the exporter/collector pair lives in multi-process API serving
        warn("--telemetry-export applies to multi-host API serving "
             "(--api across processes); one-shot generation runs one "
             "process with nothing to federate")
    if (args.step_log or args.event_log or args.slo_targets
            or args.trace_events or args.priority_classes
            or args.preemption or args.shed or args.checkpoint
            or args.fault_plan or args.journal
            or args.recovery is not None):
        # the step recorder, the event bus, SLO accounting and the
        # scheduler live in the serving engine: a one-shot generation
        # has one request and records nothing
        logging.getLogger(__name__).warning(
            "--step-log / --event-log / --trace-events / --slo-targets / "
            "--priority-classes / --preemption / --shed / --checkpoint / "
            "--fault-plan / --recovery / --journal apply to engine "
            "serving (--api); one-shot generation has a single request "
            "and records nothing")
    if args.model_type == ModelType.IMAGE:
        count = [0]

        def save(pngs):
            for png in pngs:
                path = f"image_{count[0]}.png"
                with open(path, "wb") as f:
                    f.write(png)
                print(f"wrote {path}")
                count[0] += 1

        master.generate_image(img_args, save)
        return 0
    from cake_tpu_torch.utils.profiling import trace
    with trace(args.tracing):
        master.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
