"""Length-grouped, modality-aware batch sampling.

A copy of ``fastvlm_tpu/train/sampler.py``: the same numpy draws
(``np.random.RandomState(seed + epoch)``) give the same order. It
reimplements the sampling strategy of the reference LLaVATrainer
(llava/train/llava_trainer.py:42-134): shuffle, split into world-sized
megabatches, sort each megabatch by length so batch shapes are uniform
(less padding waste -> static-shape-friendly on TPU), and optionally keep
multimodal and text-only samples in separate megabatches
(``group_by_modality_length``), since their sequence-length profiles differ.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


def _split_to_even_chunks(indices: List[int], lengths: Sequence[int],
                          num_chunks: int) -> List[List[int]]:
    """Greedy balanced split by total length (reference llava_trainer.py:42-61)."""
    if len(indices) % num_chunks:
        return [indices[i::num_chunks] for i in range(num_chunks)]
    num_per = len(indices) // num_chunks
    chunks: List[List[int]] = [[] for _ in range(num_chunks)]
    sums = [0] * num_chunks
    for idx in indices:
        shortest = int(np.argmin(sums))
        chunks[shortest].append(idx)
        sums[shortest] += lengths[idx]
        if len(chunks[shortest]) == num_per:
            sums[shortest] = float("inf")
    return chunks


def get_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                               world_size: int, rng: np.random.RandomState,
                               merge: bool = True) -> List[int]:
    perm = rng.permutation(len(lengths)).tolist()
    mb = batch_size * world_size
    megabatches = [perm[i: i + mb] for i in range(0, len(perm), mb)]
    megabatches = [sorted(m, key=lambda i: lengths[i], reverse=True)
                   for m in megabatches]
    if merge:
        return [i for m in megabatches for i in m]
    return [_split_to_even_chunks(m, lengths, world_size) for m in megabatches]


def get_modality_length_grouped_indices(
    lengths: Sequence[int], batch_size: int, world_size: int,
    rng: np.random.RandomState,
) -> List[int]:
    """Sign-encoded lengths: >0 multimodal, <0 text-only
    (reference llava_trainer.py:65-89)."""
    if all(l != 0 for l in lengths) and (
            all(l > 0 for l in lengths) or all(l < 0 for l in lengths)):
        return get_length_grouped_indices(
            [abs(l) for l in lengths], batch_size, world_size, rng)

    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, -l) for i, l in enumerate(lengths) if l < 0]
    mm_shuf = [mm[i] for i in rng.permutation(len(mm))]
    lang_shuf = [lang[i] for i in rng.permutation(len(lang))]
    mb = batch_size * world_size
    mm_sorted = [sorted(mm_shuf[i:i + mb], key=lambda t: t[1], reverse=True)
                 for i in range(0, len(mm_shuf), mb)]
    lang_sorted = [sorted(lang_shuf[i:i + mb], key=lambda t: t[1], reverse=True)
                   for i in range(0, len(lang_shuf), mb)]
    megabatches = mm_sorted + lang_sorted
    # shuffle megabatch order, keep the (possibly short) last one last
    if megabatches:
        last = megabatches[-1]
        rest = megabatches[:-1]
        order = rng.permutation(len(rest))
        megabatches = [rest[i] for i in order] + [last]
    return [i for m in megabatches for i, _ in m]


class LengthGroupedSampler:
    """Iterator over sample indices (reference llava_trainer.py:92-134)."""

    def __init__(self, lengths: Sequence[int], batch_size: int,
                 world_size: int = 1, group_by_modality: bool = False,
                 seed: int = 0):
        self.lengths = lengths
        self.batch_size = batch_size
        self.world_size = world_size
        self.group_by_modality = group_by_modality
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.lengths)

    def __iter__(self) -> Iterator[int]:
        rng = np.random.RandomState(self.seed + self.epoch)
        if self.group_by_modality:
            idx = get_modality_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, rng)
        else:
            idx = get_length_grouped_indices(
                [abs(l) for l in self.lengths], self.batch_size,
                self.world_size, rng)
        self.epoch += 1
        return iter(idx)
