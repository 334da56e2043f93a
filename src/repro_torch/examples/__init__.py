"""The port's counterparts of the reference's ``examples/*.py``.

Each module runs as ``python -m repro_torch.examples.<name>`` (the names
are the reference's) with the reference example's options and defaults,
plus two:

* ``--device``: the card (the default) or ``cpu``; without a CUDA device
  only an explicit ``cpu`` runs, as the launchers do;
* ``--full``: the architecture at full width, where the reference example
  takes ``reduced(...)`` (an example that already runs a full-width
  configuration accepts it and changes nothing).

``main(argv)`` draws the weights (``Model``'s seed 0 on the device) and
the inputs from a seed and calls ``run(...)``, which takes the model or
the weights (a tree in the reference's layout) and returns what the
example prints: its lines and the tokens and metrics behind them.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_engine --full
"""
from __future__ import annotations

import argparse
from typing import Optional, Tuple

import torch

from repro_torch.core.hardware import (H100_SXM5_80GB, Hardware,
                                       for_device_name)


class Lines(list):
    """The lines an example prints, kept in order; ``echo`` prints each as
    it comes (a streamed example prints while it serves)."""

    def __init__(self, echo: bool = True):
        super().__init__()
        self.echo = echo

    def __call__(self, line: str = ""):
        for part in line.split("\n"):
            self.append(part)
            if self.echo:
                print(part, flush=True)


def parser(prog: str, doc: Optional[str]) -> argparse.ArgumentParser:
    """An empty parser for an example, described by the first paragraph
    of its docstring; the example adds the reference's options to it,
    then :func:`add_port_options`."""
    return argparse.ArgumentParser(
        prog=f"python -m repro_torch.examples.{prog}",
        description=(doc or "").strip().split("\n\n")[0])


def add_port_options(ap: argparse.ArgumentParser, full_help: str = (
        "take the architecture at full width instead of reduced(...)")
                     ) -> argparse.ArgumentParser:
    ap.add_argument("--device", default="cuda",
                    help="the device to run on: the card (the default) or "
                         "'cpu'; without a CUDA device only an explicit "
                         "'cpu' runs")
    ap.add_argument("--full", action="store_true", help=full_help)
    return ap


def card_hardware(device: torch.device) -> Tuple[Hardware, str]:
    """The card's own ``Hardware`` and where its peaks come from: the card
    ``torch.cuda.get_device_name`` names, or on the CPU the H100 SXM5 entry
    labelled as the data sheet."""
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        return for_device_name(name), f"the card, {name}"
    return H100_SXM5_80GB, "the data sheet; no card"
