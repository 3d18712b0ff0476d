"""Blocks of query images through ``HDCModel.encode`` and ``pack_queries``
(the packing policy: row-centred sign bits), then ``ItemMemory.search``
over a store of images encoded and packed the same way at set-up.  (The
store's own ``add`` packs raw sign bits, which are all 0 for these
images: a uHD encoding carries the image's brightness in every
dimension.)

Parameters: ``block`` (queries a block), ``k``, ``pool_images`` (the
query images the blocks are cut from), ``store_rows``, ``clients``.

The judgement builds the store again from the seed's images with the
reference alone and holds the top k of :data:`CHECK_BLOCKS` query
blocks, drawn from the seed, to the program's answers to them.
"""

from __future__ import annotations

import numpy as np
import torch

from bench import counts
from bench.entries import Entry, Spans
from bench.reference import hdc as ref_hdc

#: store images made, encoded and packed at a time, at set-up and in the judgement
CHUNK = 65536
#: query blocks whose answers the judgement compares
CHECK_BLOCKS = 16


class Search(Entry):
    def setup(self) -> None:
        from repro_torch.core import unary
        from repro_torch.core.item_memory import ItemMemory

        rows, d = int(self.t["store_rows"]), int(self.hdc["d"])
        rng = np.random.default_rng([self.seed, 1])
        self.check = np.sort(rng.choice(self.n_blocks(), min(CHECK_BLOCKS, self.n_blocks()),
                                        replace=False))
        self.model = self.model()
        gen = self.stroke_images()
        words = torch.empty((rows, unary.n_words(d)), dtype=torch.int32, device=self.device)
        start = 0
        for x, _ in gen.draw_chunks(rows, CHUNK):
            words[start:start + x.shape[0]] = self.model.pack_queries(self.model.encode(x))
            start += x.shape[0]
        self.store = ItemMemory(d, device=self.device)
        self.store.add_packed(words)
        del words
        self.pool_x, _ = gen.draw(int(self.t["pool_images"]))
        self.pool = self.pool_x.cpu().numpy()

    def step(self, blk: int, spans: Spans):
        b = int(self.t["block"])
        with spans.span("encode"):
            words = self.model.pack_queries(self.model.encode(self.pool[blk * b:(blk + 1) * b]))
        with spans.span("store search"):
            return self.store.search(words.view(torch.uint32), int(self.t["k"]))

    def work(self) -> counts.Work:
        h, d, _, enc = self.shape()
        return counts.search(int(self.t["block"]), h, d, int(self.t["store_rows"]),
                             int(self.t["k"]), enc)

    def free(self) -> None:
        del self.store, self.model

    def _topk(self, ref) -> tuple[np.ndarray, np.ndarray]:
        """`ref`'s top k of the checked query blocks over `ref`'s own store,
        encoded from the seed's store images (drawn as at set-up)."""
        rows, d, b = int(self.t["store_rows"]), int(self.hdc["d"]), int(self.t["block"])
        words = torch.empty((rows, -(-d // 32)), dtype=torch.int32, device=self.device)
        start = 0
        for x, _ in self.stroke_images().draw_chunks(rows, CHUNK):
            for i in range(0, x.shape[0], 8192):
                stop = start + min(8192, x.shape[0] - i)
                words[start:stop] = ref_hdc.pack_bits(
                    ref.centred_bits(ref.encode(x[i:i + 8192])))
                start = stop
        queries = torch.cat([self.pool_x[i * b:(i + 1) * b] for i in self.check])
        idx, dist = ref_hdc.topk_pinned(ref.centred_bits(ref.encode(queries)), words, d,
                                        int(self.t["k"]), self.device)
        return idx.cpu().numpy(), dist.cpu().numpy()

    def control(self, ref) -> list:
        """The reference in the program's place: its store and its top k of
        the checked query blocks."""
        idx, dist = self._topk(ref)
        b = int(self.t["block"])
        return [(blk, (idx[j * b:(j + 1) * b], dist[j * b:(j + 1) * b]))
                for j, blk in enumerate(self.check)]

    def judge(self, answers: list) -> dict:
        b = int(self.t["block"])
        idx, dist = self._topk(self.reference())
        at = {int(blk): j for j, blk in enumerate(self.check)}
        wrong_idx = wrong_dist = compared = 0
        for blk, (a_idx, a_dist) in answers:
            j = at.get(int(blk))
            if j is None:
                continue
            compared += 1
            wrong_idx += int((np.asarray(a_idx) != idx[j * b:(j + 1) * b]).sum())
            wrong_dist += int((np.asarray(a_dist) != dist[j * b:(j + 1) * b]).sum())
        return {
            "topk_row_mismatches": wrong_idx,
            "topk_distance_mismatches": wrong_dist,
            "blocks_compared": compared,
        }


ENTRY = Search
