"""CLI: `python -m rsem_tpu_torch <command> [args...]`.

Counterpart of rsem_tpu/__main__.py for the commands ported so far.
"""

from __future__ import annotations

import sys


def _cmd_calculate_expression(argv):
    from .pipeline.calculate_expression import main
    return main(argv)


def _cmd_prepare_reference(argv):
    from .pipeline.prepare_reference import main
    return main(argv)


def _cmd_simulate_reads(argv):
    from .pipeline.simulate_reads import main
    return main(argv)


COMMANDS = {
    "calculate-expression": _cmd_calculate_expression,
    "prepare-reference": _cmd_prepare_reference,
    "simulate-reads": _cmd_simulate_reads,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m rsem_tpu_torch <command> [args...]\n\n"
              "commands:")
        for name in sorted(COMMANDS):
            print(f"  {name}")
        return 0 if argv else 1
    fn = COMMANDS.get(argv[0])
    if fn is None:
        print(f"unknown command: {argv[0]}", file=sys.stderr)
        return 1
    return fn(argv[1:]) or 0


if __name__ == "__main__":
    sys.exit(main())
