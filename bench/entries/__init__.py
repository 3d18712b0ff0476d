"""The kinds of traffic the harness drives, and what they share.

A traffic file (``bench/traffic/<mix>.json``) names its kind under
``"entry"``; the kind is the module ``bench/entries/<entry>.py``, found by
that name (``bench.cells.Cell.entry_class``), whose ``ENTRY`` class sets
the program up from the seed (``setup``), runs one step of a client (``step``: a block or a job through
the program's own entry point, inside the harness's spans), counts the
work of a step (``work``, from ``bench.counts``), frees the program's
state (``free``), and judges the window's answers against
``bench.reference`` (``judge``).  ``control`` gives the reference's
answers in the program's place.  The traffic file's other keys are the
kind's parameters, so a new size of a kind is a data file alone, and a
new kind is a module and a data file, with no existing file edited.

Every number a judgement compares is a count of exact mismatches
(``*_mismatches``, limit 0), beside a count of what was compared
(``*_compared``, at least 1).
"""

from __future__ import annotations

import contextlib
import time

import torch

from bench import counts
from bench.images import StrokeImages
from bench.reference import hdc as ref_hdc


class Spans:
    """One client's host spans, (name, start ns, end ns) on ``perf_counter_ns``."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter_ns()))


class Entry:
    """Set-up, step and judgement of one kind of traffic."""

    def __init__(self, cell, seed: int, device: torch.device):
        self.cell = cell
        self.hdc = dict(cell.config["hdc"])
        self.t = cell.traffic
        self.seed = int(seed)
        self.device = device
        self.outputs: dict = {}

    @property
    def clients(self) -> int:
        return int(self.t.get("clients", 1))

    @property
    def images_per_step(self) -> int:
        return int(self.t["block"])

    def stroke_images(self) -> StrokeImages:
        return StrokeImages(self.cell.config["images"], self.seed, self.device)

    def model(self):
        from repro_torch.core.hdc_model import HDCModel
        from repro_torch.core.model import HDCConfig

        return HDCModel.create(HDCConfig(**self.hdc), device=self.device)

    def shape(self) -> tuple[int, int, int, str]:
        """(H, D, C, encoder) of the configuration."""
        h = self.hdc
        return int(h["n_features"]), int(h["d"]), int(h["n_classes"]), h["encoder"]

    def work(self) -> counts.Work:
        raise NotImplementedError

    def reference(self, image_dtype=torch.float32) -> ref_hdc.Reference:
        return ref_hdc.Reference(self.hdc, self.device, image_dtype)

    def n_blocks(self) -> int:
        return int(self.t["pool_images"]) // int(self.t["block"])

    def keep(self) -> None:
        """Hold what the program made that the judgement reads."""


def bound(name: str) -> dict:
    """A judgement number's limit: a mismatch count at most 0 (an exact
    comparison), a count of what was compared at least 1."""
    return {"limit": 0} if name.endswith("_mismatches") else {"min": 1}


def passed(checks: dict) -> bool:
    return all(v <= 0 if k.endswith("_mismatches") else v >= 1 for k, v in checks.items())
