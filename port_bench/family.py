"""The decoder family of a configuration: the module that its file names
under ``"decoder"`` (a path from the checkout's root), or ``DEFAULT``, the
dense Qwen2 family, where it names none.

Everything the benchmark takes from the decoder's architecture is in that
module, so a configuration of a new architecture brings its own:

  draw(plan, cfg) -> dict
      the decoder's leaves, added to ``weights.Plan`` after the
      projector's (the embedding table under ``"embed"``, which the
      reference's splice reads);
  Reference
      a subclass of ``reference.Base`` that writes the decoder:
      ``hidden(embeds)`` (input embeddings -> final-normed hidden states,
      float32) and ``head(h)`` (-> logits), with the base's ``linear`` /
      ``_w`` so that the fp8 control rounds its products too;
  flops(cfg, new, cached=0, head_rows=1) -> float
      operations of ``new`` tokens of one row after ``cached`` ones, the
      LM head at ``head_rows`` positions;
  attention(cfg) -> [(query heads, kv heads, head size, window), ...]
      each layer's attention: a window of W keys (a query sees a key
      fewer than W positions back), or None for full causal attention.

The port's side of the family is the port's own: ``harness.port_config``
builds the decoder's config with ``models/builder.build_decoder_config``.
"""

from __future__ import annotations

import importlib.util
import os
import re
import sys
from types import ModuleType

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = "port_bench/decoders/qwen2.py"


def of(cfg: dict) -> ModuleType:
    """The family module of configuration ``cfg``, loaded once a process."""
    path = cfg.get("decoder", DEFAULT)
    name = "port_bench.family_" + re.sub(r"\W", "_", path)
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO, path))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    return mod
