"""Shared set-up of the quantization, int8-KV, export and tools tests of the
PyTorch port: the tiny VLM (128 px FastViTHD, 2-layer decoder) in both
packages, weights drawn with numpy once and converted (utils/convert.py),
and a tokenizer whose text is the token ids."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from fastvlm_tpu import config as jcfg
from fastvlm_tpu import engine as jengine
from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch import engine as tengine
from fastvlm_tpu_torch.data import preprocessing
from fastvlm_tpu_torch.utils.convert import from_jax_params


class IdTokenizer(preprocessing.ByteTokenizer):
    """Byte tokenizer whose decode spells out the ids."""

    def decode(self, ids, skip_special_tokens=True):
        return ",".join(str(int(i)) for i in ids)


def tiny(pkg, kv_cache_dtype=None, **extra):
    """The tiny VLM config of ``pkg`` (either package's ``config``): 128 px
    FastViTHD (4 image tokens), a 2-layer 64-wide decoder, untied LM head
    unless ``extra`` ties it."""
    vision = pkg.FastViTConfig(layers=(1, 1, 1, 1, 1),
                               embed_dims=(8, 16, 32, 64, 128),
                               image_size=128, attn_head_dim=16,
                               **extra.get("vision", {}))
    decoder = pkg.Qwen2Config(vocab_size=258, hidden_size=64, num_layers=2,
                              num_heads=4, num_kv_heads=2, head_dim=16,
                              intermediate_size=128,
                              tie_word_embeddings=False,
                              kv_cache_dtype=kv_cache_dtype,
                              **extra.get("decoder", {}))
    return pkg.FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=pkg.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                      hidden_size=64))


def jax_config(kv_cache_dtype=None):
    """The JAX side runs its Pallas kernels (interpret mode on the CPU)."""
    return tiny(jcfg, kv_cache_dtype, vision={"ffn_backend": "pallas"},
                decoder={"attn_backend": "pallas"})


def draw_weights(seed=0):
    """numpy weights of the JAX init's shapes: norm scales near 1, the
    decoder's matrices and embeddings N(0, 0.2) (at 0.02 the tiny decoder
    only echoes its last input token), the rest N(0, 0.02)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("ln1", "ln2", "final_norm", "norm_scale"):
            return (1 + 0.02 * rng.randn(*leaf.shape)).astype(np.float32)
        scale = 0.2 if path[0].key == "decoder" and leaf.ndim >= 2 else 0.02
        return (scale * rng.randn(*leaf.shape)).astype(np.float32)

    jc = jax_config()
    shapes = jax.eval_shape(lambda k: jvlm.init(k, jc), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(draw, shapes)


def engines(np_params, kv_cache_dtype=None, **engine_kw):
    """(JAX engine, port engine) over the same numpy tree (which may hold
    quantized decoder leaves)."""
    tok = IdTokenizer()
    engine_kw.setdefault("eos_ids", (tok.eos_token_id,))
    jc = jax_config(kv_cache_dtype)
    tc = tiny(tcfg, kv_cache_dtype)
    je = jengine.Engine(jc, jax.tree.map(jnp.asarray, np_params), tok,
                        **engine_kw)
    te = tengine.Engine(tc, from_jax_params(np_params, tc), tok, **engine_kw)
    return je, te


def with_decoder(cfg, **kw):
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                **kw))


def image(seed=0):
    return np.random.RandomState(seed).randint(0, 256, (128, 128, 3),
                                               dtype=np.uint8)
