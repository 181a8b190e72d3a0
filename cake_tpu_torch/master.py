"""Master: drives the text or image generator and builds the serving
engine.

Counterpart of `cake_tpu/master.py` (`from_args`, `make_engine`,
`generate_text`, `generate_image`, `run`, `reset`, `add_message`,
`_spec_kwargs`, `telemetry_settings`, `attach_image_control`: under
multi-process image serving each generation's args are published for
the followers to replay). `generate_text` streams each token
through a callback and times the tokens after the first, so the
prefill does not skew tokens/s; `make_engine` builds the continuous-batching engine over the
generator's config, params and tokenizer for the REST server: the paged
engine with --kv-pages (and the --spec-draft draft for paged speculative
rows), the dense engine without it (the ring engine for a sliding-window
config shorter than max_seq_len), over a --draft-model generator the
dense spec engine, over a topology-sharded generator the dense (or
ring) engine on the pipelined step fns (parallel/pipeline
.make_engine_step_fns) with its own sharded cache, and over an `--sp`
generator the sp engine (`_sp_engine`: the forward's `engine_pieces`,
the windowed limits prompt_limit = ctx_len and decode_budget =
tail_len, JAX's warnings for the flags it ignores).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

from cake_tpu_torch.args import Args
from cake_tpu_torch.models import Token
from cake_tpu_torch.models.chat import Message

log = logging.getLogger(__name__)


class Master:
    """Drives a text generator (`models/llama/generator.LlamaGenerator`)
    or an image generator (`models/sd/sd.SDGenerator`)."""

    def __init__(self, args: Args, text_generator=None,
                 image_generator=None):
        self.args = args
        self.llm = text_generator
        self.image = image_generator
        self.tokens_per_s: float = 0.0

    @classmethod
    def from_args(cls, args: Args, sd_args=None,
                  mesh_devices=None) -> "Master":
        """The generator of the args' model type. mesh_devices: a sharded
        plan's devices in mesh-position order (Python only; a card may
        repeat)."""
        from cake_tpu_torch.args import ModelType
        from cake_tpu_torch.context import Context
        ctx = Context.from_args(args, sd_args, mesh_devices=mesh_devices)
        if args.model_type == ModelType.IMAGE:
            return cls(args, image_generator=ctx.load_image_model())
        return cls(args, text_generator=ctx.load_text_model())

    def make_engine(self, max_slots: Optional[int] = None,
                    **engine_kwargs):
        """Build the continuous-batching engine over the loaded
        generator's params (no weight copy; the engine allocates its own
        KV cache) on the generator's device: the paged engine with
        --kv-pages, else the dense engine (the ring engine for a
        sliding-window config shorter than max_seq_len), and over a
        --draft-model generator the dense spec engine, with JAX's
        warnings for the flags it ignores. engine_kwargs pass through to
        InferenceEngine."""
        if self.llm is None:
            raise RuntimeError("no text generator loaded")
        from cake_tpu_torch.models.llama.speculative import (
            SpeculativeGenerator,
        )
        from cake_tpu_torch.serve.engine import InferenceEngine
        a = self.args
        g = self.llm
        common = dict(
            device=g.device,
            max_slots=max_slots or a.max_slots,
            max_seq_len=g.max_seq_len,
            sampling=g.sampling,
            seed=a.seed,
            # the observability planes and the SLO scheduler
            trace_events=a.trace_events,
            trace_ring=a.trace_ring,
            step_log=a.step_log,
            step_ring=a.step_ring,
            event_log=a.event_log,
            event_ring=a.event_ring,
            slo_targets=a.slo_targets,
            priority_classes=a.priority_classes,
            preemption=a.preemption,
            shed=a.shed,
            sentinel=a.sentinel,
            sentinel_interval=a.sentinel_interval,
            sentinel_act=a.sentinel_act,
            postmortem_dir=a.postmortem_dir,
            # fault injection and the journal
            fault_plan=a.fault_plan,
            journal=a.journal,
            journal_fsync=a.journal_fsync,
            # passed through so the engine's guard WARNS that multi-step
            # scans do not apply to speculative rounds
            decode_scan_steps=a.decode_scan,
        )
        fwd = getattr(g, "_forward_fn", None)
        if fwd is not None and hasattr(fwd, "engine_pieces"):
            # a forward that builds its own engine: the --sp adapter
            return self._sp_engine(fwd, common, engine_kwargs)
        # the generator's cache dtype (a float --kv-dtype); an int8/int4
        # --kv-dtype quantizes the engine's pool instead
        common["cache_dtype"] = g.cache.k.dtype
        if isinstance(g, SpeculativeGenerator):
            # speculation inside the batching engine: the draft/verify
            # rounds run batched across slots (spec_round_batched)
            if a.kv_dtype in ("int8", "int4"):
                from cake_tpu_torch.args import INT8_KV_SPEC_ERROR
                raise ValueError(INT8_KV_SPEC_ERROR)
            for flag, on, why in (
                    ("--kv-pages", a.kv_pages, "the spec engine's "
                     "target+draft caches are not paged"),
                    ("--kv-host-pages", a.kv_host_pages, "the host KV "
                     "tier spills paged pool pages"),
                    ("--auto-prefix", a.auto_prefix, "prefix caching is "
                     "not implemented for the spec engine (draft cache "
                     "has no prefix install path)"),
                    ("--mixed-batch", a.mixed_batch == "on", "the mixed "
                     "ragged step is a paged-engine path and the spec "
                     "engine is not paged"),
                    ("--autotune", a.autotune != "off", "speculative "
                     "serving has no hot-switch fold (the draft cache "
                     "cannot be rebuilt mid-round)")):
                if on:
                    log.warning("%s ignored with --draft-model: %s", flag,
                                why)
            kw = dict(common, draft_params=g.draft_params,
                      draft_config=g.draft_config, spec_gamma=g.gamma,
                      # unset: off for this flavor, with no warning
                      recovery=bool(a.recovery))
            kw.update(engine_kwargs)
            return InferenceEngine(g.config, g.params, g.tokenizer, **kw)
        if getattr(g, "parallel", None) is not None:
            common.update(self._parallel_kwargs(common["max_slots"]))
        kw = dict(
            common,
            kv_dtype=a.kv_dtype,
            prefill_chunk=a.prefill_chunk,
            # None: the dense (or ring) engine, as in JAX
            kv_pages=a.kv_pages,
            kv_page_size=a.kv_page_size,
            # --kv-host-pages arms the host-RAM spill tier
            kv_host_pages=a.kv_host_pages,
            paged_attn=a.paged_attn,
            mixed_batch=a.mixed_batch,
            auto_prefix_system=a.auto_prefix,
            # crash recovery: unset = on, the JAX default
            recovery=a.recovery is not False,
            # live reconfiguration
            autotune=a.autotune,
            autotune_policy=a.autotune_policy,
            # disaggregated prefill/decode (kv/transfer.py): the role
            # and the channel's peer; the shared token rides
            # $CAKE_DISAGG_TOKEN (Args.validate checked it)
            disagg=a.disagg,
            disagg_peer=a.disagg_peer,
            disagg_timeout_s=a.disagg_timeout,
            **self._spec_kwargs(),
        )
        kw.update(engine_kwargs)
        return InferenceEngine(g.config, g.params, g.tokenizer, **kw)

    def _sp_engine(self, fwd, common: dict, engine_kwargs: dict):
        """The sp engine over the adapter's mesh and window: its step fns
        and cache (`engine_pieces`, max slots divisible by dp for dp x
        sp), prompt_limit = ctx_len and decode_budget = tail_len, and
        JAX's warnings for the flags it ignores; --prefill-chunk passes
        through, so the engine warns that the sp steps have no chunked
        variant."""
        from cake_tpu_torch.serve.engine import InferenceEngine
        a = self.args
        g = self.llm
        slots = common["max_slots"]
        fns, cache, ctx_len, tail_len = fwd.engine_pieces(slots, g.params)
        for flag, on, why in (
                ("--kv-pages", a.kv_pages, "the sp engine's ctx/tail "
                 "cache is not paged (the ctx region is "
                 "sequence-sharded, not slot-paged)"),
                ("--kv-dtype int8/int4 / --kv-host-pages",
                 a.kv_dtype in ("int8", "int4") or a.kv_host_pages,
                 "KV tiering (cake_tpu_torch/kv) applies to the paged "
                 "pool, and the sp engine's ctx/tail cache is not paged"),
                ("--auto-prefix", a.auto_prefix, "prefix caching is not "
                 "implemented for the sp engine's sequence-sharded ctx "
                 "cache"),
                ("--mixed-batch", a.mixed_batch == "on", "the sp engine's "
                 "ctx/tail cache is not paged, so there is no mixed "
                 "ragged step to dispatch"),
                ("--autotune", a.autotune != "off", "the sp engine's "
                 "custom step fns own their cache contract; only the "
                 "built-in dense/paged engines can hot-switch configs"),
                ("--disagg", a.disagg, "disaggregated prefill/decode "
                 "ships paged pool pages (cake_tpu_torch/kv/transfer.py), "
                 "and the sp engine's ctx/tail cache is not paged")):
            if on:
                log.warning("%s ignored: %s", flag, why)
        log.info("sp engine: %d slots, ctx window %d + decode tail %d",
                 slots, ctx_len, tail_len)
        kw = dict(common, max_seq_len=ctx_len + tail_len,
                  cache_dtype=cache.dtype, step_fns=fns, cache=cache,
                  prompt_limit=ctx_len, decode_budget=tail_len,
                  prefill_chunk=a.prefill_chunk,
                  recovery=a.recovery is not False)
        kw.update(engine_kwargs)
        return InferenceEngine(g.config, g.params, g.tokenizer, **kw)

    def _parallel_kwargs(self, slots: int) -> dict:
        """A topology-sharded generator's engine: the pipelined step fns
        over the generator's mesh and a batched cache placed to match (a
        ring of W positions a slot for a sliding-window config), as
        JAX's make_engine builds them."""
        from cake_tpu_torch.parallel.pipeline import make_engine_step_fns
        from cake_tpu_torch.parallel.sharding import create_sharded_cache

        g = self.llm
        plan, mesh = g.parallel
        tp = plan.tp > 1
        microbatches = self.args.microbatches
        if slots % microbatches != 0:
            raise ValueError(
                f"--max-slots {slots} must be divisible by "
                f"--microbatches {microbatches}")
        ring = (g.config.sliding_window is not None
                and g.config.sliding_window < g.max_seq_len)
        cache = create_sharded_cache(
            g.config, slots,
            g.config.sliding_window if ring else g.max_seq_len, mesh,
            tp_axis="tp" if tp else None, dp_axis=None,
            stage_axis="stage", dtype=g.cache.k.dtype)
        return dict(
            step_fns=make_engine_step_fns(
                mesh, g.config, num_microbatches=microbatches, tp=tp,
                ring=ring),
            cache=cache, ring=ring)

    def telemetry_settings(self) -> tuple:
        """(enabled, interval_s) of fleet telemetry federation
        (--telemetry-export / --telemetry-interval, obs/federation.py),
        resolved in ONE place so the coordinator's collector and every
        follower's exporter agree: None = on exactly when serving spans
        processes, an explicit True/False as given."""
        enabled = getattr(self.args, "telemetry_export", None)
        if enabled is None:
            from cake_tpu_torch.parallel.distributed import process_count
            enabled = process_count() > 1
        return (bool(enabled),
                float(getattr(self.args, "telemetry_interval", 2.0)))

    def _spec_kwargs(self) -> dict:
        """Paged speculative decoding: the --spec-draft draft's params and
        config for the engine (which builds the draft pool itself). The
        config resolves as the context's; the draft stays unquantized,
        as in JAX (--quant targets the big model)."""
        d_dir = self.args.spec_draft
        if not d_dir:
            return {}
        from cake_tpu_torch.context import draft_config
        from cake_tpu_torch.models import load_text_params
        from cake_tpu_torch.utils.devices import resolve_dtype

        g = self.llm
        d_cfg = draft_config(self.args, g.device, d_dir)
        if d_cfg.vocab_size != g.config.vocab_size:
            raise ValueError(
                f"spec draft vocab {d_cfg.vocab_size} != target vocab "
                f"{g.config.vocab_size}: the verify pass scores draft "
                "token ids directly, so the models must share a "
                "tokenizer")
        d_params = load_text_params(d_cfg, d_dir,
                                    resolve_dtype(self.args.dtype), g.device)
        log.info("paged speculative serving: gamma=%d draft=%s",
                 self.args.spec_gamma, d_dir)
        return dict(spec_draft_params=d_params, spec_draft_config=d_cfg,
                    spec_gamma=self.args.spec_gamma)

    # -- image ---------------------------------------------------------------

    def attach_image_control(self, control) -> None:
        """Multi-process image serving: publish each generation's args
        before running it, so every follower replays the same generation
        and its hops meet (cli._run_image_follower)."""
        self._image_control = control

    def generate_image(self, image_args, callback) -> None:
        """Generate images per ImageGenerationArgs, handing each batch of
        PNG bytes to `callback`. Under multi-process serving the args are
        published first; img2img is refused there, as in JAX (the init
        image exists on the coordinator only)."""
        if self.image is None:
            raise RuntimeError("no image generator loaded")
        control = getattr(self, "_image_control", None)
        if control is not None:
            if image_args.sd_img2img:
                raise ValueError(
                    "img2img is unavailable under multi-host serving: "
                    "the init image exists on the coordinator only; "
                    "serve img2img on one host")
            control.publish({"op": "image", "args": image_args.to_json()})
        self.image.generate_image(image_args, callback)

    # -- text ----------------------------------------------------------------

    def reset(self) -> None:
        if self.llm is not None:
            self.llm.reset()

    def add_message(self, message: Message) -> None:
        self.llm.add_message(message)

    def generate_text(self, stream: Callable[[Token], None],
                      sample_len: Optional[int] = None) -> str:
        """Generate up to sample_len tokens, streaming each through
        `stream`. tokens_per_s counts from the first token on, so the
        prefill is not in it."""
        sample_len = sample_len or self.args.sample_len
        pieces = []
        start = time.perf_counter()
        generated = 0
        for index in range(sample_len):
            token = self.llm.next_token(index)
            if index == 0:
                start = time.perf_counter()
            else:
                generated += 1
            if token.is_end_of_stream:
                if token.text:
                    # EOS carries the flushed UTF-8 tail
                    pieces.append(token.text)
                    stream(token)
                break
            pieces.append(token.text)
            stream(token)
        dt = time.perf_counter() - start
        self.tokens_per_s = generated / dt if dt > 0 else 0.0
        log.info("%d tokens generated (%.2f token/s)",
                 generated + 1, self.tokens_per_s)
        return "".join(pieces)

    def run(self) -> None:
        """One-shot generation of the command line: the system prompt and
        the prompt, streamed to stdout."""
        self.add_message(Message.system(self.args.system_prompt))
        self.add_message(Message.user(self.args.prompt))
        print(f"[{self.args.system_prompt}] {self.args.prompt}\n")
        self.generate_text(lambda t: print(t.text, end="", flush=True))
        print()
