"""Blocks of test images through ``ServingEngine.staged`` + ``predict`` (its
CUDA graph on a card), the model fit at set-up.

Parameters: ``block`` (images a block, the engine's batch), ``pool_images``
(the test images the blocks are cut from), ``fit_images`` and
``fit_block`` (the set-up's fit), ``clients``.
"""

from __future__ import annotations

import numpy as np
import torch

from bench import counts
from bench.entries import Entry, Spans


class Classify(Entry):
    def setup(self) -> None:
        from repro_torch.serving.engine import ServingEngine

        gen = self.stroke_images()
        n, fb = int(self.t["fit_images"]), int(self.t["fit_block"])
        self.train_x, self.train_y = gen.draw(n)
        self.pool_x, _ = gen.draw(int(self.t["pool_images"]))
        model = self.model().fit_batches(
            (self.train_x[i:i + fb], self.train_y[i:i + fb]) for i in range(0, n, fb))
        self.engine = ServingEngine(model, batch_size=int(self.t["block"]),
                                    device=self.device).warmup()
        self.pool = self.pool_x.cpu().numpy()

    def step(self, blk: int, spans: Spans) -> np.ndarray:
        b = int(self.t["block"])
        with self.engine.staged() as buf:
            with spans.span("staging write"):
                np.copyto(buf, self.pool[blk * b:(blk + 1) * b])
            with spans.span("engine predict"):
                return self.engine.predict(buf)

    def work(self) -> counts.Work:
        h, d, c, enc = self.shape()
        return counts.classify(int(self.t["block"]), h, d, c, enc)

    def keep(self) -> None:
        self.outputs["class_sums"] = self.engine.model.class_sums.cpu()

    def free(self) -> None:
        del self.engine

    def _expected(self, ref):
        """`ref`'s class sums of the training images and labels of the pool."""
        sums = ref.class_sums(self.train_x, self.train_y)
        return sums.cpu(), ref.labels(self.pool_x, sums).cpu().numpy()

    def control(self, ref) -> list:
        """The reference in the program's place: its class sums and labels."""
        self.outputs["class_sums"], labels = self._expected(ref)
        b = int(self.t["block"])
        return [(i, labels[i * b:(i + 1) * b]) for i in range(self.n_blocks())]

    def judge(self, answers: list) -> dict:
        sums, labels = self._expected(self.reference())
        b = int(self.t["block"])
        wrong = sum(int((np.asarray(a) != labels[blk * b:(blk + 1) * b]).sum())
                    for blk, a in answers)
        return {
            "class_sum_mismatches": int((self.outputs["class_sums"].to(torch.int64)
                                         != sums).sum()),
            "label_mismatches": wrong,
            "labels_compared": len(answers) * b,
        }


ENTRY = Classify
