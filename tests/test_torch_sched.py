"""The port's SLO scheduling (`cake_tpu_torch/sched`) and the engine's
preemption and shedding seams, against the JAX package.

  * `SLOScheduler` and `ShedController` are host-only: seeded random
    sequences of submit / plan / report / cancel / requeue (with victim,
    ranking and depth queries between them) and of retirements and
    admission decisions give exactly the JAX package's results.
  * The engine (tiny config, f32 params and KV, greedy): under slot
    starvation, page starvation and with shared prefix pages, at
    `decode_scan` 1 and 4 and `--mixed-batch` auto and off, every stream
    is token-identical to the JAX paged engine's and the preemptions by
    reason (read from each engine's event bus) are the JAX engine's;
    the port's pages all come back.
  * Shed and queue-full refusals carry the JAX engine's Retry-After.

The JAX package is imported inside the cases that use it, so on the
card (which has no jax) the file collects and its `cuda` cases run:

    python -m pytest --noconftest -m cuda tests/test_torch_sched.py
"""

import random
import time
from collections import Counter

import pytest

import torch

from cake_tpu_torch import sched as tsched
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import ByteTokenizer
from cake_tpu_torch.models.llama.params import init_params
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve.engine import InferenceEngine, QueueFullError

T = 64
PAGE = 16
CLASSES = ("interactive", "standard", "batch")


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the captured steps replay only "
                    "on CUDA")


# -- the scheduler and the shed controller, op for op ---------------------------


def _drive_schedulers(seed: int, n_ops: int = 400):
    """The same seeded sequence of operations on the JAX scheduler and
    the port's; yields (op, jax result, port result)."""
    from cake_tpu.sched import SchedConfig as JCfg
    from cake_tpu.sched import SLOScheduler as JSLO

    rng = random.Random(seed)
    slots = rng.choice([1, 2, 3, 5])
    cfg_kw = dict(preempt_budget=rng.choice([0, 1, 2]))
    j = JSLO(slots, max_queue=rng.choice([3, 8, 64]),
             config=JCfg(**cfg_kw))
    t = tsched.SLOScheduler(j.max_slots, j.max_queue,
                            config=tsched.SchedConfig(**cfg_kw))
    now, next_rid, known = 0.0, 1, []
    for _ in range(n_ops):
        now += rng.choice([0.0, 0.5, 3.0, 40.0])
        op = rng.choice(["submit", "submit", "plan", "plan", "report",
                         "cancel", "requeue", "victims", "slot_victims",
                         "outranks", "query"])
        if op == "submit":
            rid = next_rid if rng.random() < 0.9 else rng.choice(
                known + [0])
            if rid == next_rid:
                next_rid += 1
                known.append(rid)
            args = (rid, rng.randint(1, 50), rng.randint(1, 20))
            cls = rng.choice(CLASSES + (None,))
            yield op, j.submit(*args, priority=cls, now=now), \
                t.submit(*args, priority=cls, now=now)
        elif op == "plan":
            yield op, j.plan(now=now), t.plan(now=now)
        elif op in ("report", "cancel", "requeue") and known:
            rid = rng.choice(known)
            if op == "report":
                args = (rid, rng.randint(1, 3), rng.random() < 0.1)
                yield op, j.report(*args), t.report(*args)
            elif op == "cancel":
                yield op, j.cancel(rid), t.cancel(rid)
            else:
                args = (rid, rng.randint(1, 60), rng.randint(1, 10))
                pre = rng.random() < 0.5
                yield op, j.requeue(*args, preempted=pre), \
                    t.requeue(*args, preempted=pre)
        elif op == "victims":
            r = rng.randint(0, 2)
            yield op, j.preemption_victims(r), t.preemption_victims(r)
        elif op == "slot_victims":
            yield op, j.slot_preemption_victims(now=now), \
                t.slot_preemption_victims(now=now)
        elif op == "outranks" and len(known) > 1:
            a, b = rng.sample(known, 2)
            yield op, j.outranks(a, b, now=now), t.outranks(a, b, now=now)
        elif op == "query":
            cls = rng.choice(CLASSES)
            for name, jv, tv in (
                    ("depth_ahead", j.depth_ahead(cls), t.depth_ahead(cls)),
                    ("class_depths", j.class_depths(), t.class_depths()),
                    ("preemption_victims", j.preemption_victims(2),
                     t.preemption_victims(2)),
                    ("counts", (j.queue_depth, j.active, j.completed),
                     (t.queue_depth, t.active, t.completed))):
                yield name, jv, tv


@pytest.mark.parametrize("seed", range(6))
def test_slo_scheduler_matches_jax_op_for_op(seed):
    n = 0
    for op, want, got in _drive_schedulers(seed):
        assert got == want, (seed, n, op)
        n += 1
    assert n > 300


@pytest.mark.parametrize("seed", range(4))
def test_shed_controller_matches_jax_op_for_op(seed):
    from cake_tpu.sched import SchedConfig as JCfg
    from cake_tpu.sched import ShedController as JShed

    rng = random.Random(100 + seed)
    window = rng.choice([5.0, 30.0])
    j = JShed(JCfg(shed_window_s=window), rng=random.Random(seed))
    t = tsched.ShedController(tsched.SchedConfig(shed_window_s=window),
                              rng=random.Random(seed))
    now = 0.0
    decisions = 0
    for _ in range(300):
        now += rng.choice([0.0, 0.05, 0.4, 2.0, 9.0])
        op = rng.random()
        if op < 0.4:
            j.observe_retire(now)
            t.observe_retire(now)
            continue
        cls = rng.choice(CLASSES)
        depth = rng.randint(0, 400)
        if op < 0.8:
            dj, dt = j.decide(cls, depth, now), t.decide(cls, depth, now)
            assert (dt.admit, dt.retry_after_s, dt.probability,
                    dt.est_wait_s) == (dj.admit, dj.retry_after_s,
                                       dj.probability, dj.est_wait_s)
            decisions += not dt.admit
        else:
            assert t.estimate_retry_after(cls, depth, now) == \
                j.estimate_retry_after(cls, depth, now)
            assert t.service_rate(now) == j.service_rate(now)
    assert decisions > 0      # the sequence reached the shedding regime


def test_classes_and_errors_match_jax():
    from cake_tpu import sched as jsched

    assert tsched.PRIORITY_CLASSES == jsched.PRIORITY_CLASSES
    assert tsched.CLASS_RANK == jsched.CLASS_RANK
    assert tsched.SchedConfig().policies == tuple(
        tsched.ClassPolicy(*(getattr(p, f) for f in
                             ("name", "rank", "aging_s", "target_wait_s")))
        for p in jsched.SchedConfig().policies)
    for p in (None, *CLASSES):
        assert tsched.validate_priority(p) == jsched.validate_priority(p)
    with pytest.raises(ValueError) as ej:
        jsched.validate_priority("vip")
    with pytest.raises(ValueError) as et:
        tsched.validate_priority("vip")
    assert str(et.value) == str(ej.value)
    e, f = tsched.ShedError("batch", 7.5, 12.25), \
        jsched.ShedError("batch", 7.5, 12.25)
    assert (str(e), e.priority, e.retry_after, e.est_wait_s) == (
        str(f), f.priority, f.retry_after, f.est_wait_s)


def test_scheduler_seam_keeps_the_fifo_without_classes():
    """Without classes the seam gives the FIFO, as JAX's does
    (tests/test_sched.py, tests/test_native.py): the native one wherever
    the library builds, the Python one only where it cannot; with
    classes, the SLOScheduler."""
    from cake_tpu_torch.native import is_available
    from cake_tpu_torch.native.scheduler import NativeScheduler, PyScheduler
    fifo = tsched.make_scheduler(2)
    assert not isinstance(fifo, tsched.SLOScheduler)
    assert isinstance(fifo, NativeScheduler if is_available()
                      else PyScheduler)
    assert isinstance(tsched.make_scheduler(2, priority_classes=True),
                      tsched.SLOScheduler)


# -- the engine against the JAX engine ------------------------------------------


@pytest.fixture(scope="module")
def models():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.params import init_params as j_init
    from cake_tpu_torch.models.llama.params import params_from_numpy

    jc = JConfig.tiny(num_hidden_layers=2)
    jp = j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, LlamaConfig.tiny(num_hidden_layers=2), tp


def _wait_tokens(handle, n, timeout=120.0):
    t0 = time.perf_counter()
    while (len(handle._req.out_tokens) < n
           and time.perf_counter() - t0 < timeout):
        time.sleep(0.001)
    assert len(handle._req.out_tokens) >= n, "victim never got going"


INTER = [2, 9, 4, 7, 3]
PREFIX = [(3 * j) % 50 + 3 for j in range(2 * PAGE)]
# scenario -> (engine kwargs, the preemptions by reason it must give)
SCENARIOS = {
    # one slot: an interactive arrival preempts the decoding batch slot
    "slots": (dict(max_slots=1, kv_pages=8), {"slots": 1}),
    # three slots, a pool for two batch residents: the interactive
    # admission is page-starved and preempts the youngest batch slot
    "pages": (dict(max_slots=3, kv_pages=4), {"pages": 1}),
    # two slots mapping shared prefix pages: the victim drops its
    # references, the registry keeps the pages
    "prefix": (dict(max_slots=2, kv_pages=8), {"slots": 1}),
}


def _drive(eng, scenario):
    """One scenario's arrivals (greedy, penalty 1.1): returns the
    streams and the preemptions by reason from the engine's event bus;
    the pages come back once the prefix is dropped."""
    kw = dict(temperature=0.0, repeat_penalty=1.1)
    with eng:
        pid = None
        if scenario == "slots":
            hs = [eng.submit([5] * 9, max_new_tokens=24, priority="batch",
                             **kw)]
            _wait_tokens(hs[0], 4)
            hs.append(eng.submit(INTER, max_new_tokens=4,
                                 priority="interactive", **kw))
        elif scenario == "pages":
            hs = [eng.submit([5 + i] * 9, max_new_tokens=23,
                             priority="batch", **kw) for i in range(2)]
            for h in hs:
                _wait_tokens(h, 2)
            hs.append(eng.submit(INTER, max_new_tokens=7,
                                 priority="interactive", **kw))
        else:
            pid = eng.register_prefix(PREFIX)
            hs = [eng.submit(PREFIX + [7, 11, 13], max_new_tokens=28,
                             priority="batch", **kw)]
            _wait_tokens(hs[0], 3)
            hs.append(eng.submit(PREFIX + [19, 23], max_new_tokens=28,
                                 priority="batch", **kw))
            _wait_tokens(hs[1], 1)
            hs.append(eng.submit(INTER, max_new_tokens=3,
                                 priority="interactive", **kw))
        assert all(h.wait(timeout=300) for h in hs)
        if pid is not None:
            eng.unregister_prefix(pid)
    reasons = Counter(e["reason"] for e in eng.events.dump(type="preempted"))
    return [list(h._req.out_tokens) for h in hs], dict(reasons)


_JAX_RUNS: dict = {}


def _jax_run(models, scenario, mixed):
    import jax.numpy as jnp
    from cake_tpu.models.llama.generator import ByteTokenizer as JTok
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.sched import SchedConfig as JCfg
    from cake_tpu.serve.engine import InferenceEngine as JEngine

    key = (scenario, mixed)
    if key not in _JAX_RUNS:
        jc, jp, _, _ = models
        eng_kw, _ = SCENARIOS[scenario]
        eng = JEngine(jc, jp, JTok(jc.vocab_size), max_seq_len=T,
                      sampling=JSampling(temperature=0.0),
                      cache_dtype=jnp.float32, kv_page_size=PAGE,
                      paged_attn="fold", mixed_batch=mixed,
                      priority_classes=True, preemption=True,
                      sched_config=JCfg(preempt_budget=8), **eng_kw)
        _JAX_RUNS[key] = _drive(eng, scenario)
    return _JAX_RUNS[key]


def _engine(cfg, params, device="cpu", **kw):
    return InferenceEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), device=device,
        max_seq_len=kw.pop("max_seq_len", T),
        sampling=SamplingConfig(temperature=0.0),
        cache_dtype=torch.float32, kv_page_size=PAGE,
        priority_classes=True, preemption=True,
        sched_config=tsched.SchedConfig(preempt_budget=8), **kw)


@pytest.mark.parametrize("mixed", ["auto", "off"])
@pytest.mark.parametrize("scan", [1, 4])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_preempted_streams_token_identical_to_jax(models, scenario, scan,
                                                  mixed):
    _, _, tc, tp = models
    want, want_reasons = _jax_run(models, scenario, mixed)
    eng_kw, reasons = SCENARIOS[scenario]
    assert want_reasons == reasons
    eng = _engine(tc, tp, mixed_batch=mixed, decode_scan_steps=scan,
                  **eng_kw)
    got, got_reasons = _drive(eng, scenario)
    assert got == want
    assert got_reasons == reasons
    assert eng.stats.preemptions == sum(reasons.values())
    assert eng._pager.free_pages == eng.cache.n_pages
    assert eng._pager.live_pages == 0
    assert (eng.cache.table == -1).all()
    # the victim's trace holds its preemption and its second admission
    victim = eng.events.dump(type="preempted")[0]["rid"]
    names = [s["name"] for s in eng.tracer.dump(rid=victim)[0]["spans"]]
    assert "preempted" in names and names.count("prefill") >= 2
    assert names[-1] == "retired"


def test_preemption_follows_the_jax_default(models):
    """preemption=None is on with the classes and off without them;
    asked for without the classes it is off, as in JAX."""
    _, _, tc, tp = models
    mk = lambda **kw: InferenceEngine(  # noqa: E731
        tc, tp, ByteTokenizer(tc.vocab_size), device="cpu",
        max_seq_len=T, kv_pages=4, kv_page_size=PAGE, **kw)
    assert mk(priority_classes=True)._preemption
    assert not mk(priority_classes=True, preemption=False)._preemption
    assert not mk()._preemption
    assert not mk(preemption=True)._preemption
    assert isinstance(mk().scheduler, type(tsched.make_scheduler(1)))


def _jax_engine(models, **kw):
    import jax.numpy as jnp
    from cake_tpu.models.llama.generator import ByteTokenizer as JTok
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.serve.engine import InferenceEngine as JEngine

    jc, jp, _, _ = models
    return JEngine(jc, jp, JTok(jc.vocab_size), max_seq_len=T,
                   sampling=JSampling(temperature=0.0),
                   cache_dtype=jnp.float32, kv_pages=8,
                   kv_page_size=PAGE, paged_attn="fold",
                   priority_classes=True, **kw)


def test_shed_retry_after_matches_jax(models):
    """Both engines with a shed controller on the same seeded rng and
    the same retirement clock, queues filled by the same arrivals (the
    engines not started): the same admissions are shed, with the same
    Retry-After and event, and the queue-full refusal that follows
    carries the shed estimate on both."""
    from cake_tpu.sched import SchedConfig as JCfg
    from cake_tpu.sched import ShedController as JShed
    from cake_tpu.sched import ShedError as JShedError
    from cake_tpu.serve.engine import QueueFullError as JQueueFull

    _, _, tc, tp = models
    clock = [100.0]
    jeng = _jax_engine(models, shed=True, max_queue=40)
    teng = _engine(tc, tp, kv_pages=8, shed=True, max_queue=40)
    jeng._shed = JShed(JCfg(), rng=random.Random(7),
                       clock=lambda: clock[0])
    teng._shed = tsched.ShedController(
        tsched.SchedConfig(), rng=random.Random(7), clock=lambda: clock[0])
    for k in range(6):              # a measured rate of ~2 retirements/s
        jeng._shed.observe_retire(95.0 + 0.5 * k)
        teng._shed.observe_retire(95.0 + 0.5 * k)
    outcomes = []
    for i in range(60):
        cls = CLASSES[i % 3]
        res = []
        for eng, shed_err, full_err in ((jeng, JShedError, JQueueFull),
                                        (teng, tsched.ShedError,
                                         QueueFullError)):
            try:
                eng.submit([5, 6, 7], max_new_tokens=2, priority=cls)
                res.append(("admitted",))
            except shed_err as e:
                res.append(("shed", e.priority, e.retry_after,
                            e.est_wait_s))
            except full_err as e:
                res.append(("full", e.retry_after))
        assert res[1] == res[0], (i, res)
        outcomes.append(res[0][0])
        clock[0] += 0.01
    assert {"admitted", "shed", "full"} <= set(outcomes)
    assert teng.stats.shed == jeng.stats.shed > 0
    strip = [{k: v for k, v in e.items() if k not in ("ts", "seq")}
             for e in teng.events.dump(type="shed")]
    assert strip == [{k: v for k, v in e.items() if k not in ("ts", "seq")}
                     for e in jeng.events.dump(type="shed")]


def test_queue_full_and_unknown_class_match_jax(models):
    from cake_tpu.serve.engine import QueueFullError as JQueueFull

    _, _, tc, tp = models
    jeng = _jax_engine(models)
    teng = _engine(tc, tp, kv_pages=8)
    for eng in (jeng, teng):
        eng.scheduler.max_queue = 0
    with pytest.raises(JQueueFull) as ej:
        jeng.submit([5] * 4, max_new_tokens=2)
    with pytest.raises(QueueFullError) as et:
        teng.submit([5] * 4, max_new_tokens=2)
    assert et.value.retry_after == ej.value.retry_after == 1.0
    # a refused submission leaves no trace behind
    assert teng.tracer.active_count == 0
    with pytest.raises(ValueError, match="priority"):
        teng.submit([5] * 4, max_new_tokens=2, priority="vip")


# -- on the card ------------------------------------------------------------------


def _card_params(device):
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    return cfg, {k: ({n: t.to(device) for n, t in v.items()}
                     if isinstance(v, dict) else v.to(device))
                 for k, v in params.items()}


def _card_drive(eng):
    """Two long batch streams and an interactive arrival that is
    page-starved (a 10-page pool holds the two), on 3 slots."""
    kw = dict(temperature=0.0, repeat_penalty=1.1)
    with eng:
        hs = [eng.submit([5 + i] * 9, max_new_tokens=60, priority="batch",
                         **kw) for i in range(2)]
        for h in hs:
            _wait_tokens(h, 2)
        hs.append(eng.submit(INTER, max_new_tokens=7,
                             priority="interactive", **kw))
        assert all(h.wait(timeout=300) for h in hs)
    return ([list(h._req.out_tokens) for h in hs],
            dict(Counter(e["reason"]
                         for e in eng.events.dump(type="preempted"))))


@pytest.mark.cuda
@pytest.mark.parametrize("scan", [1, 4])
def test_cuda_preempting_engine_matches_the_cpu_engine(scan):
    """The engine on the card (both steps captured), with classes and
    preemption, gives the CPU engine's greedy streams and preemptions,
    and every page returns; its step records carry device time."""
    _cuda_or_skip()
    runs = []
    for device in ("cpu", "cuda"):
        cfg, params = _card_params(device)
        eng = _engine(cfg, params, device=device, max_seq_len=128,
                      max_slots=3, kv_pages=10, prefill_chunk=8,
                      decode_scan_steps=scan)
        runs.append(_card_drive(eng))
        assert eng._pager.free_pages == 10
    assert runs[1] == runs[0]
    assert runs[0][1] == {"pages": 1}
    recs = eng.flight.records()
    assert {r.kind for r in recs} >= {"mixed"}
    assert all(r.mfu is not None and 0 < r.mfu <= 1 for r in recs)


@pytest.mark.cuda
def test_cuda_preemptions_and_admissions_add_no_sync():
    """A wave of preemptions and re-admissions on the card, the flight
    recorder, tracer and event bus on: every `_maybe_preempt`, every
    admission and every mixed step in which no row emits runs under
    `torch.cuda.set_sync_debug_mode("error")`, so none of them (nor the
    records, spans and events they write) waits for the stream. The
    streams equal the CPU engine's."""
    _cuda_or_skip()
    kw = dict(temperature=0.0, repeat_penalty=1.1)
    runs = []
    guarded = Counter()
    for device in ("cpu", "cuda"):
        cfg, params = _card_params(device)
        eng = _engine(cfg, params, device=device, max_seq_len=128,
                      max_slots=2, kv_pages=16, prefill_chunk=8)

        def guard(name, fn, when=lambda *a: True):
            def wrapped(*a):
                if device != "cuda" or not when(*a):
                    return fn(*a)
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return fn(*a)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    guarded[name] += 1
            return wrapped

        def no_emit(decode_plan):
            C = eng._mixed_chunk
            return not (any(s not in eng._mixed_pending
                            for _, s in decode_plan)
                        or any(p["off"] + C >= len(p["ids"])
                               for p in eng._mixed_pending.values()))

        eng._maybe_preempt = guard("preempt", eng._maybe_preempt)
        eng._mixed_admit = guard("admit", eng._mixed_admit)
        eng._mixed_dispatch = guard("chunk_step", eng._mixed_dispatch,
                                    no_emit)
        with eng:
            # a warm-up wave captures the graphs' variants
            eng.submit([4] * 20, max_new_tokens=4, **kw).wait(300)
            hs = [eng.submit([5] * 40, max_new_tokens=50,
                             priority="batch", **kw)]
            _wait_tokens(hs[0], 3)
            hs.append(eng.submit([6] * 30, max_new_tokens=30,
                                 priority="interactive", **kw))
            _wait_tokens(hs[1], 2)
            hs.append(eng.submit([7] * 30, max_new_tokens=30,
                                 priority="interactive", **kw))
            assert all(h.wait(timeout=300) for h in hs)
        runs.append([list(h._req.out_tokens) for h in hs])
        assert eng.stats.preemptions >= 1
        assert eng._pager.free_pages == 16
    assert runs[1] == runs[0]
    assert guarded["preempt"] > 0 and guarded["admit"] >= 4
    assert guarded["chunk_step"] >= 2
