"""The JAX package's CLI flags whose modules the port has not ported
(autotune's).

The port's CLIs take each such flag with its JAX spelling, so that a
command line written for the JAX package parses, and refuse it: argparse
exits non-zero with a message that names ROADMAP.md Queue 1 Item 8.4."""

from __future__ import annotations

import argparse
from typing import Iterable


def add_refused_flags(parser: argparse.ArgumentParser, flags: Iterable[str]) -> None:
    """Take each flag of ``flags`` with or without a value, hidden from
    ``--help``."""
    for flag in flags:
        parser.add_argument(flag, nargs="?", const="", default=None, help=argparse.SUPPRESS)


def refuse_unported(parser: argparse.ArgumentParser, args, flags: Iterable[str],
                    what: str) -> None:
    """Exit through ``parser.error`` if ``args`` holds any flag of
    ``flags``; ``what`` names the unported modules in the message."""
    for flag in flags:
        if getattr(args, flag[2:]) is not None:
            parser.error(f"{flag} is not ported: {what} is ROADMAP.md Queue 1 Item 8.4")
