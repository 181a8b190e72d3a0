"""Command-line entry point: `python -m cake_tpu_torch.cli`.

Counterpart of `cake_tpu/cli.py:main` for one device:

    python -m cake_tpu_torch.cli --model DIR --prompt "..."   # one-shot
    python -m cake_tpu_torch.cli --model DIR --api 0.0.0.0:8080
    python -m cake_tpu_torch.cli --cpu --prompt hi --sample-len 4

Without --model the model is the tiny config with random weights. It
runs on cuda:<--device-idx> and raises when there is no card, unless
--cpu is given.
"""

from __future__ import annotations

import logging
import sys


def main(argv=None) -> int:
    from cake_tpu_torch.args import parse_args
    from cake_tpu_torch.master import Master

    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] %(levelname)s %(name)s: %(message)s")
    args = parse_args(argv)
    master = Master.from_args(args)
    if args.api:
        from cake_tpu_torch.api.server import start
        start(master, address=args.api)
        return 0
    if (args.step_log or args.event_log or args.slo_targets
            or args.trace_events or args.priority_classes
            or args.preemption or args.shed):
        # the step recorder, the event bus, SLO accounting and the
        # scheduler live in the serving engine: a one-shot generation
        # has one request and records nothing
        logging.getLogger(__name__).warning(
            "--step-log / --event-log / --trace-events / --slo-targets / "
            "--priority-classes / --preemption / --shed apply to engine "
            "serving (--api); one-shot generation has a single request "
            "and records nothing")
    master.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
