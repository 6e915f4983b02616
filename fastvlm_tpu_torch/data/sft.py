"""Supervised fine-tuning data pipeline: conversations -> (ids, labels).

A copy of ``fastvlm_tpu/data/sft.py`` (host code on numpy and PIL, so the
port carries its own; the ids, labels and arrays are the JAX package's):

  * target masking built span by span (``_SpanBuilder``): each conversation
    version (``qwen_2``, ``plain``, ``v1``, ``llama_2``, ``mpt``) renders
    its turns as spans; instruction spans and role headers get
    IGNORE_INDEX, only assistant replies (and their separators) are
    targets. Whole-string tokenization decides the ids; a BPE merge across
    a span boundary is found by prefix comparison and the straddling token
    is masked.
  * ``SupervisedDataset``: LLaVA-format JSON (one file or a comma-separated
    list, each with its image folder), ``lengths`` / ``modality_lengths``
    for the sampler, a zero image for text-only samples of a multimodal
    run, a fall-back to sample 0 on a load error, and anyres tile stacks
    with their (grid, original size) meta. ``image_loads`` counts which
    image loader ran: the native C++ JPEG path (``utils/native_image.py``)
    or PIL.
  * ``collate``: image sentinels expanded to static slots (labels
    IGNORE_INDEX there), rows right-padded to a multiple of 64, images
    stacked; numpy out, the trainer moves the batch to the device.
"""

from __future__ import annotations

import collections
import copy
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from fastvlm_tpu_torch.data.constants import (
    DEFAULT_IMAGE_TOKEN, IGNORE_INDEX, IMAGE_TOKEN_INDEX)
from fastvlm_tpu_torch.data.preprocessing import tokenizer_image_token

logger = logging.getLogger(__name__)

QWEN_SYSTEM = "<|im_start|>system\nYou are a helpful assistant."
QWEN_SEP = "<|im_end|>\n"
QWEN_USER = "<|im_start|>user\n"
QWEN_ASSISTANT = "<|im_start|>assistant\n"


def _tok_full(tokenizer, text: str) -> List[int]:
    """Tokenize a full rendered conversation, routing <image> through the
    sentinel splicer (the reference tokenizes whole conversations the same
    way, tokenizer_image_token over the rendered prompt)."""
    if DEFAULT_IMAGE_TOKEN in text:
        return list(tokenizer_image_token(text, tokenizer))
    return list(tokenizer(text).input_ids)


class _SpanBuilder:
    """Span tokenization that is exact-by-construction.

    The final ids always equal the reference's
    tokenize-once-over-the-rendered-conversation result — for every
    tokenizer, including sentencepiece/Llama-style BPEs whose
    ``add_dummy_prefix`` whitespace semantics make naive per-span
    tokenization drift (the class of bug the reference guards at
    train_qwen.py:624-630 by zeroing mismatched samples).

    Fast path (one verification, O(total) tokenizer work): each span is
    tokenized alone and the concatenation compared against the whole-string
    tokenization; equality proves per-span labels are exact. Any mismatch
    (a BPE merge across a span boundary, a tokenizer that inserts BOS per
    call) falls back to the incremental path, which re-tokenizes the
    accumulated string per span — O(spans x total), but rare.

    If a merge crosses a span boundary, the re-tokenized head of the span is
    labeled IGNORE_INDEX up to the longest token suffix that is byte-
    identical to the span's standalone tokenization (matching suffix tokens
    provably cover only this span's bytes, so everything kept as a target is
    pure answer; everything ambiguous is masked). The reference instead
    zeroes the whole sample and warns — this keeps the provably-clean
    signal."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.spans: List[Tuple[str, bool]] = []
        self._ids: Optional[List[int]] = None
        self._labels: Optional[List[int]] = None
        self.boundary_merges = 0

    def add(self, text: str, is_target: bool) -> None:
        self.spans.append((text, is_target))
        self._ids = self._labels = None

    @property
    def ids(self) -> List[int]:
        self._compute()
        return self._ids

    @property
    def labels(self) -> List[int]:
        self._compute()
        return self._labels

    def _compute(self) -> None:
        if self._ids is not None:
            return
        texts = [t for t, _ in self.spans]
        full = _tok_full(self.tokenizer, "".join(texts))
        per = [_tok_full(self.tokenizer, t) if t else [] for t in texts]
        if sum(per, []) == full:
            ids: List[int] = []
            labels: List[int] = []
            for toks, (_, is_target) in zip(per, self.spans):
                ids.extend(toks)
                labels.extend(toks if is_target
                              else [IGNORE_INDEX] * len(toks))
            self._ids, self._labels = ids, labels
            return
        self._ids, self._labels = self._incremental(per)

    def _incremental(self, per: List[List[int]]):
        text = ""
        ids: List[int] = []
        labels: List[int] = []
        for (span_text, is_target), alone in zip(self.spans, per):
            text += span_text
            full = _tok_full(self.tokenizer, text)
            n = len(ids)
            contaminated = False
            if full[:n] != ids:
                # merge across the span boundary: keep the agreeing prefix,
                # relabel the re-tokenized remainder as part of this span
                common = 0
                limit = min(len(full), n)
                while common < limit and full[common] == ids[common]:
                    common += 1
                del labels[common:]
                n = common
                contaminated = True
                self.boundary_merges += 1
            span = full[n:]
            ids = full
            if not is_target:
                labels.extend([IGNORE_INDEX] * len(span))
                continue
            if contaminated:
                # attribute conservatively: tokens in the longest common
                # suffix of (span, standalone tokenization) are byte-
                # identical to pure span text — safe targets; the ambiguous
                # head (mixing previous-span bytes) is masked
                s = 0
                while (s < min(len(span), len(alone))
                       and span[-1 - s] == alone[-1 - s]):
                    s += 1
                keep = len(span) - s
                labels.extend([IGNORE_INDEX] * keep + span[keep:])
                logger.warning(
                    "tokenization merge across span boundary at token %d; "
                    "masked %d ambiguous head token(s) of the target span",
                    common, keep)
            else:
                labels.extend(span)
        return ids, labels

    def result(self, max_len: Optional[int] = None):
        self._compute()
        ids, labels = self._ids, self._labels
        if max_len is not None:
            ids, labels = ids[:max_len], labels[:max_len]
        return ids, labels


def preprocess_qwen_2(
    conversations: Sequence[Dict[str, str]],
    tokenizer,
    *,
    max_len: Optional[int] = None,
) -> Tuple[List[int], List[int]]:
    """ChatML rounds -> (input_ids, labels) with instruction masking.

    conversations: [{"from": "human"|"gpt", "value": str}, ...]
    """
    b = _SpanBuilder(tokenizer)
    b.add(QWEN_SYSTEM + QWEN_SEP, False)
    for turn in conversations:
        who = turn["from"]
        msg = turn["value"]
        if who == "human":
            b.add(QWEN_USER + msg + QWEN_SEP, False)
        elif who == "gpt":
            b.add(QWEN_ASSISTANT, False)
            b.add(msg + QWEN_SEP, True)
        else:  # system override or unknown: mask
            b.add(msg, False)
    return b.result(max_len)


def preprocess_plain(
    conversations: Sequence[Dict[str, str]],
    tokenizer,
) -> Tuple[List[int], List[int]]:
    """Stage-1 pretraining pairs (reference train_qwen.py:284-310): the image
    sentinel alone as the prompt, the caption as the target."""
    assert len(conversations) == 2
    b = _SpanBuilder(tokenizer)
    b.add(DEFAULT_IMAGE_TOKEN, False)
    b.add(conversations[1]["value"] + "\n", True)
    return b.result()


V1_SYSTEM = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's "
    "questions."
)


def preprocess_v1(
    conversations: Sequence[Dict[str, str]],
    tokenizer,
    *,
    max_len: Optional[int] = None,
) -> Tuple[List[int], List[int]]:
    """Vicuna-v1 rounds (reference preprocess_v1, train_qwen.py:396-474):
    ``system USER: q ASSISTANT: a</s>`` with only the answers (+</s>) as
    targets. _SpanBuilder re-tokenizes the whole accumulated string per
    span, so the ids match whole-conversation tokenization exactly even for
    sentencepiece BPEs; a merge across the "ASSISTANT:" boundary masks the
    straddling token (vs the reference's zero-the-sample guard,
    train_qwen.py:624-630)."""
    b = _SpanBuilder(tokenizer)
    b.add(V1_SYSTEM + " ", False)
    for turn in conversations:
        if turn["from"] == "human":
            b.add("USER: " + turn["value"] + " ", False)
        else:
            b.add("ASSISTANT:", False)
            b.add(" " + turn["value"] + "</s>", True)
    return b.result(max_len)


def preprocess_llama_2(
    conversations: Sequence[Dict[str, str]],
    tokenizer,
    *,
    max_len: Optional[int] = None,
    system: Optional[str] = None,
) -> Tuple[List[int], List[int]]:
    """Llama-2 chat rounds (reference preprocess_llama_2, train_qwen.py:313-393):
    ``[INST] <<SYS>>...<</SYS>> q [/INST] a </s>``; answers (+</s>) are the
    only targets."""
    from fastvlm_tpu_torch.data.conversation import conv_llama_2

    sys_msg = system if system is not None else conv_llama_2.system
    wrap = f"<<SYS>>\n{sys_msg}\n<</SYS>>\n\n" if sys_msg else ""
    b = _SpanBuilder(tokenizer)
    first = True
    for turn in conversations:
        if turn["from"] == "human":
            q = (wrap if first else "") + turn["value"]
            b.add(f"[INST] {q} [/INST]", False)
            first = False
        else:
            b.add(f" {turn['value']} </s>", True)
    return b.result(max_len)


def preprocess_mpt(
    conversations: Sequence[Dict[str, str]],
    tokenizer,
    *,
    max_len: Optional[int] = None,
) -> Tuple[List[int], List[int]]:
    """ChatML/MPT rounds (reference preprocess_mpt, train_qwen.py:477-524):
    like qwen_2 but with the mpt system prompt and bare <|im_end|> separator."""
    system = "<|im_start|>system\nAnswer the questions."
    sep = "<|im_end|>"
    b = _SpanBuilder(tokenizer)
    b.add(system + sep, False)
    for turn in conversations:
        if turn["from"] == "human":
            b.add("<|im_start|>user\n" + turn["value"] + sep, False)
        else:
            b.add("<|im_start|>assistant\n", False)
            b.add(turn["value"] + sep, True)
    return b.result(max_len)


PREPROCESSORS = {
    "qwen_2": preprocess_qwen_2,
    "plain": preprocess_plain,
    "v1": preprocess_v1,
    "llama_2": preprocess_llama_2,
    "mpt": preprocess_mpt,
}


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------


@dataclass
class DataArguments:
    data_path: str = ""
    image_folder: Optional[str] = None
    image_aspect_ratio: str = "pad"
    # anyres training (reference train_qwen.py:957-958 routes
    # image_aspect_ratio == 'anyres' through process_anyres_image): tile
    # grids are chosen from these (width, height) pinpoints
    image_grid_pinpoints: Optional[Sequence[Tuple[int, int]]] = None
    is_multimodal: bool = True
    conv_version: str = "qwen_2"
    max_len: int = 2048


class SupervisedDataset:
    """Lazy LLaVA-format dataset (list of {id, image?, conversations}).

    data_path may be one JSON file or a comma-separated list; entries of a
    multi-dataset run can carry their own image roots via ``dataset_name``
    keys (reference train_qwen.py:894-907 uses a parallel image-folder list).
    """

    def __init__(self, data_args: DataArguments, tokenizer, image_processor=None):
        self.args = data_args
        self.tokenizer = tokenizer
        self.image_processor = image_processor
        self.records: List[Dict[str, Any]] = []
        paths = [p for p in data_args.data_path.split(",") if p]
        folders = (data_args.image_folder or "").split(",")
        for i, p in enumerate(paths):
            with open(p) as f:
                items = json.load(f)
            folder = folders[i] if i < len(folders) else (folders[0] if folders[0] else None)
            for it in items:
                it["_image_folder"] = folder
            self.records.extend(items)
        self.preprocess = PREPROCESSORS[data_args.conv_version]
        self.image_loads = collections.Counter()  # "native" / "pil"

    def __len__(self) -> int:
        return len(self.records)

    @property
    def lengths(self) -> List[int]:
        """Approximate sample lengths for the sampler
        (reference train_qwen.py:912-918)."""
        out = []
        for r in self.records:
            img_tokens = 128 if "image" in r else 0
            n_words = sum(len(t["value"].split()) for t in r["conversations"])
            out.append(n_words + img_tokens)
        return out

    @property
    def modality_lengths(self) -> List[int]:
        """Sign encodes modality: positive = has image, negative = text-only
        (reference train_qwen.py:920-927)."""
        out = []
        for r in self.records:
            n_words = sum(len(t["value"].split()) for t in r["conversations"])
            out.append(n_words if "image" in r else -n_words)
        return out

    @property
    def _anyres(self) -> bool:
        return (self.args.image_aspect_ratio == "anyres"
                and bool(self.args.image_grid_pinpoints))

    def _image_path(self, record) -> str:
        path = record["image"]
        if record.get("_image_folder"):
            path = os.path.join(record["_image_folder"], path)
        return path

    def anyres_meta(self, idx: int):
        """(grid_shape, original_size) for sample ``idx`` from the image
        HEADER only (no pixel decode) — the trainer buckets batches by grid
        so every anyres batch is static-shape (one tower compile per grid,
        the same anyres-as-long-context discipline as inference). Text-only
        samples map to the (1, 1) dummy grid."""
        from PIL import Image

        from fastvlm_tpu_torch.data.preprocessing import select_best_resolution

        record = self.records[idx]
        s = self.image_processor.image_size
        if not self._anyres or "image" not in record:
            return ((1, 1), (s, s)) if self._anyres else None
        try:
            with Image.open(self._image_path(record)) as im:
                size = im.size
        except Exception:
            return (1, 1), (s, s)  # __getitem__ falls back to sample 0
        best = select_best_resolution(
            size, list(self.args.image_grid_pinpoints))
        return (best[0] // s, best[1] // s), size

    def _load_anyres(self, record):
        """[global view + tiles] stack for anyres training
        (reference train_qwen.py:957-958 -> mm_utils.process_anyres_image).
        Returns (tiles (T, S, S, 3), grid_shape, original_size); text-only
        samples get a single dummy zero tile on the (1, 1) grid (the anyres
        analog of the reference's dummy zero image, train_qwen.py:978-982)."""
        from PIL import Image

        from fastvlm_tpu_torch.data.preprocessing import (
            process_anyres_image, select_best_resolution)

        s = self.image_processor.image_size
        if "image" not in record:
            return np.zeros((1, s, s, 3), np.float32), (1, 1), (s, s)
        image = Image.open(self._image_path(record)).convert("RGB")
        pins = list(self.args.image_grid_pinpoints)
        best = select_best_resolution(image.size, pins)
        tiles = process_anyres_image(image, self.image_processor, pins)
        return (np.asarray(tiles, np.float32),
                (best[0] // s, best[1] // s), image.size)

    def _load_image(self, record) -> Optional[np.ndarray]:
        from PIL import Image

        from fastvlm_tpu_torch.data.preprocessing import expand2square

        if "image" not in record:
            if self.args.is_multimodal and self.image_processor is not None:
                # dummy zero image for text-only samples in multimodal runs
                # (reference train_qwen.py:978-982)
                s = self.image_processor.image_size
                return np.zeros((s, s, 3), np.float32)
            return None
        path = record["image"]
        if record.get("_image_folder"):
            path = os.path.join(record["_image_folder"], path)

        # fast path: native C++ JPEG decode + preprocess (keeps image work
        # off the GIL); falls back to PIL on any failure
        if (self.args.image_aspect_ratio == "pad"
                and path.lower().endswith((".jpg", ".jpeg"))):
            try:
                from fastvlm_tpu_torch.utils import native_image as ni

                if ni.available():
                    with open(path, "rb") as f:
                        out = ni.preprocess_jpeg_bytes(
                            f.read(), self.image_processor.image_size,
                            ni.MODE_PAD_SQUARE)
                    self._count_load("native")
                    return out
            except Exception:
                logger.debug("native image load failed for %s; using PIL",
                             path, exc_info=True)

        image = Image.open(path).convert("RGB")
        if self.args.image_aspect_ratio == "pad":
            bg = tuple(int(x * 255) for x in self.image_processor.image_mean)
            image = expand2square(image, bg)
        out = self.image_processor.preprocess(image)
        self._count_load("pil")
        return out

    def _count_load(self, loader: str) -> None:
        if not self.image_loads[loader]:
            logger.info("image loader: %s", loader)
        self.image_loads[loader] += 1

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        try:
            return self._get(idx)
        except Exception:
            # error fallback to sample 0 (reference train_qwen.py:985-991)
            logger.exception("failed to load sample %d; falling back to 0", idx)
            return self._get(0)

    def _get(self, idx: int) -> Dict[str, Any]:
        record = self.records[idx]
        ids, labels = self.preprocess(
            record["conversations"], self.tokenizer)
        if self.args.max_len:
            ids, labels = ids[: self.args.max_len], labels[: self.args.max_len]
        has_image = "image" in record
        if not has_image and IMAGE_TOKEN_INDEX in ids:
            raise ValueError(f"sample {idx} has <image> token but no image")
        if self._anyres and self.args.is_multimodal:
            tiles, grid_shape, original_size = self._load_anyres(record)
            return {"ids": ids, "labels": labels, "image": tiles,
                    "has_image": has_image,
                    "anyres": (grid_shape, original_size)}
        image = self._load_image(record)
        return {"ids": ids, "labels": labels, "image": image,
                "has_image": has_image}


def collate(
    samples: List[Dict[str, Any]],
    num_image_tokens: int,
    *,
    pad_to_multiple: int = 64,
    pad_id: int = 0,
    cfg=None,
) -> Dict[str, np.ndarray]:
    """Batch: expand image sentinels to static slots (labels -100 there),
    right-pad to a bucket, stack images. Output feeds train.step.loss_fn.

    AnyRes samples (``sample["anyres"] = (grid_shape, original_size)``,
    image = a (T, S, S, 3) tile stack) need ``cfg`` (FastVLMConfig) to size
    the merged token span. The batch must be GRID-UNIFORM — same
    (grid_shape, crop_box) for every row (the trainer's grid bucketing
    guarantees it) — so tiles stack to one static (B, T, S, S, 3) array and
    the whole step is one compiled program per grid. The merge meta rides in
    the non-array key ``_anyres``; the trainer pops it and passes it to
    train_step as a static argument."""
    from fastvlm_tpu_torch.ops.splice import expand_image_ids

    anyres = "anyres" in samples[0]
    tok_counts = [num_image_tokens] * len(samples)
    meta = None
    if anyres:
        from fastvlm_tpu_torch.models.vlm import anyres_crop_box
        from fastvlm_tpu_torch.ops.anyres import num_merged_tokens

        assert cfg is not None, "anyres collation needs cfg"
        metas = [(s["anyres"][0],
                  anyres_crop_box(cfg, s["anyres"][0], s["anyres"][1]))
                 for s in samples]
        if len(set(metas)) != 1:
            raise ValueError(
                f"anyres batch mixes grids {sorted(set(metas))}: batches "
                "must be grid-uniform (trainer.batches buckets by grid)")
        meta = metas[0]
        tok_counts = [
            num_merged_tokens(s["anyres"][0], cfg.vision.grid_size,
                              cfg.mm_patch_merge_type, s["anyres"][1])
            for s in samples
        ]

    rows, label_rows, starts, images = [], [], [], []
    for s, n_tok in zip(samples, tok_counts):
        row, start = expand_image_ids(s["ids"], n_tok, pad_id=pad_id)
        lab = list(s["labels"])
        if start >= 0:
            lab = lab[:start] + [IGNORE_INDEX] * n_tok + lab[start + 1:]
        rows.append(np.asarray(row, np.int32))
        label_rows.append(np.asarray(lab, np.int32))
        starts.append(start)
        images.append(s["image"])

    max_len = max(len(r) for r in rows)
    bucket = -(-max_len // pad_to_multiple) * pad_to_multiple
    b = len(rows)
    ids = np.full((b, bucket), pad_id, np.int32)
    labels = np.full((b, bucket), IGNORE_INDEX, np.int32)
    lens = np.zeros((b,), np.int32)
    for i, (r, l) in enumerate(zip(rows, label_rows)):
        ids[i, : len(r)] = r
        labels[i, : len(l)] = l
        lens[i] = len(r)

    batch = {
        "ids": ids,
        "labels": labels,
        "image_starts": np.asarray(starts, np.int32),
        "attn_lens": lens,
    }
    if anyres:
        batch["tiles"] = np.stack(images)  # (B, T, S, S, 3), grid-uniform
        batch["_anyres"] = meta            # static (grid_shape, crop_box)
    elif any(im is not None for im in images):
        batch["images"] = np.stack([im for im in images])
    return batch
