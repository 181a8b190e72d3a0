"""Context: process-wide state built once from Args.

Counterpart of `cake_tpu/context.py` (`_resolve_flash`,
`Context.from_args`, `load_text_model`, `_load_params_streamed`,
`_maybe_quantize`, `load_image_model`): the dtype, the device
(`cuda:<device_idx>`, or the CPU with `--cpu`), the topology, the model
config and the text generator (`--batch-size` rows, or with
`--draft-model` the batch-1 SpeculativeGenerator, `_load_speculative`),
its weights quantized with `--quant int8|int4`; or, with `--model-type
image`, the Stable Diffusion generator of the SDArgs, its components
placed by a topology or its UNet batch over `--dp` positions.

A topology with several stages, or `--tp` / `--dp` above 1, builds the
ParallelPlan's ("dp", "stage", "tp") mesh (parallel/): the generator's
params and cache are placed on it (streamed shard by shard from the
safetensors files when the model has weights) and it drives the
pipelined forward. `--sp N` builds JAX's sequence-parallel mesh
instead, ("sp",), ("sp", "tp"), ("dp", "sp"[, "tp"]) or ("stage",
"sp"[, "tp"]) (`_place_sp`): the window max_seq_len splits into a
context of ctx_len = ((max_seq_len - tail) // sp) * sp positions over
sp and a replicated decode tail of tail = max(sample_len, 16), and the
generator drives parallel/context_parallel.SPGeneratorForward (its
weights streamed stage-locally with stages). The mesh's default devices
are every visible card (the CPU at every position with --cpu);
`mesh_devices=` (Python only) names them, a card repeated for a
co-located mesh.

With several processes (parallel/distributed.initialize, the CAKE_*
variables) the plan's mesh spans them (`ParallelPlan.build_mesh`): each
process allocates, streams and quantizes only the positions it owns,
and the pipelined forward hops between processes (parallel/hop.py).
Multi-process `--sp` lays JAX's sp mesh over every process's devices
(`make_multihost_sp_mesh`; the mesh must span them all), and a
multi-process image model splits its UNet batch over a ("dp",) mesh of
every process's devices.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass
from typing import Optional

import torch

from cake_tpu_torch.args import Args, SDArgs
from cake_tpu_torch.kv.quantized_pool import QUANTIZED_CACHES
from cake_tpu_torch.models.llama.config import LlamaConfig, load_config
from cake_tpu_torch.topology import Topology
from cake_tpu_torch.utils.devices import (
    resolve_device, resolve_dtype, resolve_kv_dtype,
)

log = logging.getLogger(__name__)


def _resolve_flash(args: Args, device: torch.device) -> bool:
    """--flash-attention / --no-flash-attention; default on iff the
    device is CUDA (on the CPU the wrappers would run their plain
    versions, which the einsum path already is)."""
    if args.flash_attention is not None:
        return args.flash_attention
    return device.type == "cuda"


def draft_config(args: Args, device: torch.device,
                 d_dir: Optional[str]) -> LlamaConfig:
    """A draft model's config: `<d_dir>/config.json`, or the tiny config
    without one; flash as the target's."""
    if d_dir and os.path.exists(os.path.join(d_dir, "config.json")):
        d_cfg = load_config(d_dir)
    else:
        d_cfg = LlamaConfig.tiny()
    return dataclasses.replace(
        d_cfg, use_flash_attention=_resolve_flash(args, device))


@dataclass
class Context:
    args: Args
    dtype: torch.dtype
    device: torch.device
    llama_config: Optional[LlamaConfig] = None
    sd_args: Optional[SDArgs] = None
    topology: Optional[Topology] = None
    # the mesh's devices in position order (None: the defaults)
    mesh_devices: Optional[list] = None

    @classmethod
    def from_args(cls, args: Args, sd_args: Optional[SDArgs] = None,
                  mesh_devices=None) -> "Context":
        """Resolve dtype and device (a CUDA device without a card raises),
        read the topology and `<model>/config.json` when there is one.
        mesh_devices: the devices of a sharded plan's mesh, in position
        order (a card may repeat: the co-located mesh)."""
        dtype = resolve_dtype(args.dtype)
        device = resolve_device(
            "cpu" if args.cpu else f"cuda:{args.device_idx}")
        if mesh_devices is not None:
            mesh_devices = [torch.device(d) for d in mesh_devices]
            device = mesh_devices[0]
        topology = Topology.from_path(args.topology) if args.topology \
            else None
        llama_config = None
        if args.model and os.path.exists(
                os.path.join(args.model, "config.json")):
            llama_config = dataclasses.replace(
                load_config(args.model),
                use_flash_attention=_resolve_flash(args, device))
        log.info("context: device=%s dtype=%s topology=%s", device,
                 args.dtype, list(topology.keys()) if topology else None)
        return cls(args=args, dtype=dtype, device=device,
                   llama_config=llama_config, sd_args=sd_args,
                   topology=topology, mesh_devices=mesh_devices)

    def _maybe_quantize(self, params):
        """Apply --quant to a parameter dict without holding two trees:
        both settings quantize leaf by leaf, dropping each full-precision
        leaf as its quantized copy lands (eager PyTorch has no donation;
        the JAX context donates the int8 tree and goes leaf by leaf for
        int4, to the same bytes and scales)."""
        a = self.args
        if a.quant not in ("int8", "int4"):
            return params
        from cake_tpu_torch.ops.quant import quantize_params_leafwise

        params = quantize_params_leafwise(
            params, bits=8 if a.quant == "int8" else 4)
        log.info("weights quantized to %s (weight-only, %s)", a.quant,
                 "per-channel" if a.quant == "int8" else "group-wise")
        return params

    def load_text_model(self):
        """Build the LlamaGenerator: the model's config, weights and
        tokenizer, or without --model the tiny config with random
        weights and the byte tokenizer; over a sharded plan, its params
        and cache placed on the plan's mesh and the pipelined forward."""
        from cake_tpu_torch.models import load_text_params
        from cake_tpu_torch.models.llama.generator import (
            ByteTokenizer, LlamaGenerator, load_tokenizer,
        )
        from cake_tpu_torch.ops.sampling import SamplingConfig
        from cake_tpu_torch.parallel.plan import ParallelPlan
        from cake_tpu_torch.utils.loading import has_weights

        a = self.args
        cfg = self.llama_config or dataclasses.replace(
            LlamaConfig.tiny(),
            use_flash_attention=_resolve_flash(a, self.device))
        if a.model and os.path.exists(os.path.join(a.model,
                                                   "tokenizer.json")):
            tokenizer = load_tokenizer(a.model)
        else:
            tokenizer = ByteTokenizer(cfg.vocab_size)
        sp = a.sp > 1
        # the sp branch counts its devices itself (sp x the plan's)
        plan = ParallelPlan.from_topology(
            cfg, self.topology, args=a,
            num_devices=None if sp else self._device_count())
        if sp:
            self._check_sp(cfg, plan)
        elif plan.sharded:
            self._check_plan(cfg, plan)
        if a.draft_model is not None and (plan.sharded or sp
                                          or a.batch_size != 1):
            raise ValueError(
                "--draft-model (speculative decoding) is batch-1 "
                "single-device; it does not compose with "
                "--sp/--tp/--dp/topology stages")
        # the sharded plan streams each shard's slice from the files
        # (no whole-model copy ever exists); everything else loads whole,
        # sp without stages too, as in JAX
        stream = (plan.sharded and (not sp or plan.stages > 1)
                  and has_weights(a.model))
        params = None
        if not stream:
            params = self._maybe_quantize(
                load_text_params(cfg, a.model, self.dtype, self.device))
        # --repeat-penalty unset: the reference default 1.1, except under
        # --draft-model, where it is 1.0 (the parallel verify replays no
        # penalty ring); an explicit value is honoured. Under
        # --spec-draft it stays 1.1, as in JAX: the engine then serves a
        # request that does not ask for 1.0 on the plain path
        penalty = a.repeat_penalty
        if penalty is None:
            penalty = 1.0 if a.draft_model is not None else 1.1
        sampling = SamplingConfig(
            temperature=a.temperature, top_k=a.top_k, top_p=a.top_p,
            repeat_penalty=penalty, repeat_last_n=a.repeat_last_n)
        if a.kv_dtype in QUANTIZED_CACHES:
            # int8/int4 KV is the paged engine's quantized pool
            # (master.make_engine passes --kv-dtype through): the
            # generator's dense cache keeps the compute dtype, having no
            # per-page scales. The JAX context does this for int8 only.
            kv_dtype = self.dtype
        else:
            kv_dtype = (resolve_kv_dtype(a.kv_dtype) if a.kv_dtype
                        else self.dtype)
        max_seq = min(a.max_seq_len, cfg.max_position_embeddings)
        kwargs = {}
        if sp:
            kwargs = self._place_sp(cfg, plan, params, max_seq, kv_dtype)
            params = kwargs.pop("params")
        elif plan.sharded:
            kwargs = self._place(cfg, plan, params, max_seq, kv_dtype)
            params = kwargs.pop("params")
        if a.draft_model is not None:
            if a.prefill_chunk is not None:
                raise ValueError(
                    "--prefill-chunk is not supported with --draft-model "
                    "(speculative prefill is whole-prompt)")
            gen = self._load_speculative(cfg, params, tokenizer, sampling,
                                         max_seq, kv_dtype)
        else:
            gen = LlamaGenerator(
                cfg, params, tokenizer,
                max_seq_len=max_seq,
                batch_size=a.batch_size,
                sampling=sampling, seed=a.seed, cache_dtype=kv_dtype,
                prefill_chunk=a.prefill_chunk, device=self.device, **kwargs)
        from cake_tpu_torch.utils.profiling import log_memory
        log_memory("model loaded")  # reference llama.rs:233-236
        return gen

    def _device_count(self) -> Optional[int]:
        """The devices a plan may take: the named mesh devices, else every
        visible card, in each process of the group (every process holds
        alike); no bound on the CPU (every position is the CPU)."""
        from cake_tpu_torch.parallel.distributed import process_count
        if self.mesh_devices is not None:
            return len(self.mesh_devices) * process_count()
        if self.device.type == "cuda":
            return torch.cuda.device_count() * process_count()
        return None

    def _check_plan(self, cfg, plan) -> None:
        """JAX's refusals of a plan the pipeline cannot run, before any
        weight loads, and the port's tp-divides-KV-heads check (JAX
        makes it on its --sp branch only)."""
        a = self.args
        if a.batch_size % plan.dp != 0:
            raise ValueError(
                f"--batch-size {a.batch_size} must be divisible by "
                f"--dp {plan.dp}")
        if (a.batch_size // plan.dp) % a.microbatches != 0:
            raise ValueError(
                f"per-replica batch {a.batch_size // plan.dp} must be "
                f"divisible by --microbatches {a.microbatches} "
                "(GPipe slices the batch into microbatches)")
        if plan.tp > 1 and cfg.num_key_value_heads % plan.tp != 0:
            raise ValueError(
                f"--tp {plan.tp} must divide kv heads "
                f"{cfg.num_key_value_heads}")
        if plan.tp > 1 and a.quant == "int4":
            # a tp shard of a row-parallel int4 weight must hold whole
            # groups (the packed nibbles and the per-group scales are
            # then its own); misaligned dims would split a group
            from cake_tpu_torch.ops.quant import pick_group
            for name, dim in (
                    ("wo", cfg.num_attention_heads * cfg.head_dim),
                    ("w_down", cfg.intermediate_size)):
                g = pick_group(dim)
                if (dim // g) % plan.tp:
                    raise ValueError(
                        f"--tp {plan.tp} with --quant int4: {name}'s "
                        f"contract dim {dim} has {dim // g} groups of {g}, "
                        "not divisible over tp — a tp shard would split a "
                        "quantization group. Use int8, drop --tp, or pick "
                        "a tp that divides the group count")

    def _sp_window(self, max_seq: int) -> tuple:
        """(ctx_len, tail): the tail holds sample_len generated tokens
        (a smaller one would clamp its writes over live entries), the
        context the rest, a multiple of sp."""
        a = self.args
        tail = max(a.sample_len, 16)
        return ((max_seq - tail) // a.sp) * a.sp, tail

    def _check_sp(self, cfg, plan) -> None:
        """JAX's refusals of an sp plan, in its order and words, before
        any weight loads."""
        a = self.args
        if plan.dp > 1 and plan.stages > 1:
            raise ValueError(
                "--sp composes with --dp OR topology stages, not both in "
                "one mesh")
        if plan.dp > 1 and a.batch_size % plan.dp != 0:
            raise ValueError(
                f"--batch-size {a.batch_size} must be divisible by --dp "
                f"{plan.dp}")
        if plan.tp > 1 and a.quant == "int4":
            # a tp shard of a contract-sharded int4 weight must hold
            # whole groups (its nibbles and scales are then its own)
            from cake_tpu_torch.ops.quant import pick_group
            for name, dim in (
                    ("wo", cfg.num_attention_heads * cfg.head_dim),
                    ("w_down", cfg.intermediate_size)):
                g = pick_group(dim)
                if (dim // g) % plan.tp:
                    raise ValueError(
                        f"--sp with --tp {plan.tp} and --quant int4: "
                        f"{name}'s contract dim {dim} has {dim // g} "
                        f"groups of {g}, not divisible over tp — a tp "
                        "shard would split a quantization group. Use "
                        "int8, drop --tp, or pick a tp that divides the "
                        "group count")
        if cfg.sliding_window is not None:
            raise ValueError(
                "--sp (ring attention) does not implement sliding-window "
                "attention; serve this model without --sp")
        need = plan.stages * plan.dp * a.sp * plan.tp
        have = self._device_count()
        if have is not None and need > have:
            raise ValueError(
                f"stages {plan.stages} x --dp {plan.dp} x --sp {a.sp} x "
                f"--tp {plan.tp} needs {need} devices, have {have}")
        from cake_tpu_torch.parallel.distributed import process_count
        if process_count() > 1 and have is not None and need != have:
            # a mesh over a subset of the devices could leave a process
            # with no position: every process must take part
            raise ValueError(
                f"multi-host --sp meshes must span every device: "
                f"sp x tp (x dp/stages) = {need} != {have} global devices")
        if plan.tp > 1 and cfg.num_key_value_heads % plan.tp != 0:
            raise ValueError(
                f"--tp {plan.tp} must divide kv heads "
                f"{cfg.num_key_value_heads}")
        if plan.stages > 1 and cfg.num_hidden_layers % plan.stages != 0:
            raise ValueError(
                f"topology stages {plan.stages} must divide layer count "
                f"{cfg.num_hidden_layers}")
        max_seq = min(a.max_seq_len, cfg.max_position_embeddings)
        ctx_len, tail = self._sp_window(max_seq)
        if ctx_len <= 0:
            raise ValueError(
                f"--max-seq-len {max_seq} leaves no context window for "
                f"sp={a.sp} after a {tail}-token decode tail; raise "
                "--max-seq-len or lower --sample-len")

    def _place_sp(self, cfg, plan, params, max_seq: int, kv_dtype) -> dict:
        """The generator's sequence-parallel state: JAX's sp mesh, the
        params placed on it (streamed stage-locally with stages and
        weights on disk), the SPGeneratorForward and JAX's placeholder
        cache of length 1 (the generator takes the forward's own)."""
        from cake_tpu_torch.models.llama.cache import KVCache
        from cake_tpu_torch.parallel.context_parallel import (
            SPGeneratorForward, place_sp_params,
        )
        from cake_tpu_torch.parallel.mesh import make_sp_mesh
        from cake_tpu_torch.parallel.sp_pipeline import place_sp_stage_params

        from cake_tpu_torch.parallel.distributed import (
            global_devices, make_multihost_sp_mesh, process_count,
        )

        a = self.args
        stages = plan.stages
        n = process_count()
        if n > 1:
            # JAX's global device list, process-major, reshaped into the
            # sp mesh: each process holds its share of the positions
            need = stages * plan.dp * a.sp * plan.tp
            local_devs = self.mesh_devices or [self.device] * -(-need // n)
            mesh = make_multihost_sp_mesh(
                a.sp, dp=plan.dp, stage=stages, tp=plan.tp,
                devices=global_devices(
                    [torch.device(d) for d in local_devs], n))
        else:
            mesh = make_sp_mesh(a.sp, dp=plan.dp, stage=stages, tp=plan.tp,
                                devices=self.mesh_devices,
                                device_type=self.device.type)
        if mesh.home != self.device:
            raise ValueError(
                f"the mesh's first device {mesh.home} is not "
                f"the context's {self.device}")
        if stages > 1:
            if params is None:      # the streamed stage-local load
                params = self._load_params_streamed(cfg, mesh,
                                                    plan.tp > 1)
            else:
                params = place_sp_stage_params(mesh, cfg, params)
        else:
            params = place_sp_params(mesh, cfg, params)
        ctx_len, _ = self._sp_window(max_seq)
        fwd = SPGeneratorForward(
            mesh, cfg, ctx_len, max_seq - ctx_len, kv_dtype=kv_dtype)
        log.info("sp serving: ring prefill over sp=%d%s, ctx=%d tail=%d",
                 a.sp, f" x stages={stages}" if stages > 1 else "",
                 ctx_len, max_seq - ctx_len)
        return dict(params=params, forward_fn=fwd,
                    cache=KVCache.create(cfg, a.batch_size, 1,
                                         dtype=kv_dtype, device=self.device))

    def _place(self, cfg, plan, params, max_seq: int, kv_dtype) -> dict:
        """The generator's sharded state: the plan's mesh, the cache
        allocated shard by shard, the params placed (or streamed) on it,
        the pipelined forward."""
        from cake_tpu_torch.parallel.pipeline import (
            make_pipeline_forward, place_params,
        )
        from cake_tpu_torch.parallel.sharding import create_sharded_cache

        a = self.args
        mesh = plan.build_mesh(devices=self.mesh_devices,
                               device_type=self.device.type)
        if mesh.home != self.device:
            raise ValueError(
                f"the mesh's first device {mesh.home} is not the "
                f"context's {self.device}")
        tp, dp = plan.tp > 1, plan.dp > 1
        cache = create_sharded_cache(
            cfg, a.batch_size, max_seq, mesh,
            tp_axis="tp" if tp else None, dp_axis="dp" if dp else None,
            stage_axis="stage", dtype=kv_dtype)
        if params is None:
            params = self._load_params_streamed(cfg, mesh, tp)
        else:
            params = place_params(params, mesh, tp=tp)
        fwd = make_pipeline_forward(mesh, cfg,
                                    num_microbatches=a.microbatches,
                                    tp=tp, dp=dp)
        log.info("topology-sharded serving:\n%s", plan.describe())
        return dict(params=params, forward_fn=fwd, cache=cache,
                    parallel=(plan, mesh))

    def _load_params_streamed(self, cfg, mesh, tp: bool):
        """Stream the weights from disk onto their pipeline shards
        (`load_params_sharded`): each tensor is read once a shard slice
        and never exists whole; --quant then runs shard by shard."""
        from cake_tpu_torch.models.llama.params import block_param_keys
        from cake_tpu_torch.parallel.pipeline import pipeline_param_specs
        from cake_tpu_torch.parallel.sharding import quantize_sharded

        if cfg.is_moe:
            from cake_tpu_torch.models.moe.params import load_params_sharded
        else:
            from cake_tpu_torch.models.llama.params import (
                load_params_sharded,
            )
        specs = pipeline_param_specs(block_param_keys(cfg),
                                     tp_axis="tp" if tp else None)
        log.info("streaming stage-local weight load from %s",
                 self.args.model)
        params = load_params_sharded(self.args.model, cfg, mesh, specs,
                                     dtype=self.dtype)
        if self.args.quant in ("int8", "int4"):
            params = quantize_sharded(
                params, bits=8 if self.args.quant == "int8" else 4)
        return params

    def load_image_model(self):
        """The Stable Diffusion generator of the SDArgs (models/sd/sd.py)
        on the context's device, its components placed by the topology,
        or with --dp its UNet batch over a ("dp",) mesh. With several
        processes the ("dp",) mesh spans every process's devices (each
        runs its rows; cli._serve_multihost replays each generation on
        the followers), as JAX's; a --dp other than the total is
        refused, and so is a component topology."""
        from cake_tpu_torch.models.sd.sd import SDGenerator
        from cake_tpu_torch.parallel.distributed import process_count
        from cake_tpu_torch.parallel.mesh import make_mesh
        a = self.args
        multi = process_count() > 1
        if (a.dp > 1 or multi) and self.topology is not None:
            why = ("--dp" if a.dp > 1
                   else "multi-host image serving (which meshes the "
                        "whole pipeline)")
            raise ValueError(
                f"{why} and an SD component topology are mutually "
                "exclusive: one SPMD program cannot mix mesh-sharded "
                "and committed-to-device components")
        total = self._device_count()
        if multi and total is not None and a.dp > 1 and a.dp != total:
            raise ValueError(
                f"multi-host image serving meshes over ALL {total} "
                f"devices; --dp {a.dp} cannot be honored (drop the flag "
                "or set it to the total device count)")
        gen = SDGenerator.load(self)
        if multi:
            from cake_tpu_torch.parallel.distributed import (
                global_devices, make_multihost_mesh,
            )
            n = process_count()
            local_devs = self.mesh_devices or [self.device]
            devs = global_devices([torch.device(d) for d in local_devs], n)
            gen.shard_for_mesh(make_multihost_mesh(dp=len(devs),
                                                   devices=devs))
            return gen
        if a.dp > 1:
            n = self._device_count()
            if n is not None and a.dp > n:
                raise ValueError(
                    f"--dp {a.dp} needs {a.dp} devices, have {n}")
            gen.shard_for_mesh(make_mesh(dp=a.dp, devices=self.mesh_devices,
                                         device_type=self.device.type))
        return gen

    def _load_speculative(self, cfg, params, tokenizer, sampling, max_seq,
                          kv_dtype):
        """The batch-1 SpeculativeGenerator over the --draft-model draft
        (quantized with --quant as the target)."""
        from cake_tpu_torch.models import load_text_params
        from cake_tpu_torch.models.llama.speculative import (
            SpeculativeGenerator,
        )

        a = self.args
        d_dir = a.draft_model
        d_cfg = draft_config(a, self.device, d_dir)
        if d_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab {d_cfg.vocab_size} != target vocab "
                f"{cfg.vocab_size}: speculation verifies draft token ids "
                "directly, so the models must share a tokenizer")
        d_params = self._maybe_quantize(
            load_text_params(d_cfg, d_dir, self.dtype, self.device))
        log.info("speculative generation: gamma=%d draft=%s", a.spec_gamma,
                 d_dir or "<random tiny>")
        return SpeculativeGenerator(
            cfg, params, d_cfg, d_params, tokenizer,
            gamma=a.spec_gamma, max_seq_len=max_seq, sampling=sampling,
            seed=a.seed, cache_dtype=kv_dtype, spec_rounds=a.spec_rounds,
            device=self.device)
