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
"""

from __future__ import annotations

import logging
import sys


def main(argv=None) -> int:
    from cake_tpu_torch.args import ModelType, parse_all_args
    from cake_tpu_torch.master import Master

    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] %(levelname)s %(name)s: %(message)s")
    args, sd_args, img_args = parse_all_args(argv)
    warn = logging.getLogger(__name__).warning
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
    master = Master.from_args(args, sd_args)
    if args.api:
        from cake_tpu_torch.api.server import start
        kw = ({"checkpoint_path": args.checkpoint} if args.checkpoint
              else {})
        start(master, address=args.api, **kw)
        return 0
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
