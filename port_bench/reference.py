"""The plain reference of a FastVLM configuration: FastViTHD (inference
form) -> mlp2x_gelu projector -> splice -> the decoder, in float32 plain
PyTorch, with TF32 off. It imports nothing of the port.

``Base`` is the part every configuration shares: the tower, the projector,
the splice of the image's rows into the embedded ids, ``logits``, and the
products (``linear``, ``conv``, ``_w``) with the control's rounding. The
decoder is its family's (``family.py``): a subclass that writes ``hidden``
and ``head`` from the family's published description.

It reads the benchmark's own weights (``weights.draw``: layer scales
unfolded, q / k / v and gate / up apart) and works out again what the
port's set-up derives from them. It follows the published description:
GELU is the exact erf form; where the port computes in bf16 it uses the
tanh form, inside the tolerance the check sets. The tower's RepMixer and
RepCPE are their reparameterised convs (the identity lies in the weights'
centre taps), as a released checkpoint's inference form is.

``quant="fp8"`` is the control: the same computation with the operands of
every product (convs, linears, the LM head) rounded to float8 e4m3, the
weights a scale an output channel, the activations a scale a row; norms,
softmax and residuals stay float32. It is the step below the bf16 the
configurations state, and has to come out as not correct.

The decoder runs one request at a time over the whole sequence, a layer
at a time. Each weight is cast to float32 (and, for the control, rounded
to fp8) once, at its first use, and kept for the next request: the
reference runs after the program is freed, so the copies fit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def q8(x: torch.Tensor, dims) -> torch.Tensor:
    """x rounded to float8 e4m3 under a scale a slice (amax over ``dims``
    to 448), back in float32."""
    amax = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Base:
    """The shared part; a family's ``Reference`` adds ``hidden`` and
    ``head``."""

    def __init__(self, cfg: dict, tree: dict, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant {quant!r}")
        self.cfg = cfg
        self.tree = tree
        self.quant = quant
        self._cast = {}
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # ------------------------------------------------------------ products

    def _w(self, t: torch.Tensor, q8_dims=None) -> torch.Tensor:
        """``t`` in float32 (rounded to fp8 over ``q8_dims`` under the
        control), made once."""
        key = (id(t), q8_dims)
        hit = self._cast.get(key)
        if hit is None or hit[0] is not t:
            w = t.float()
            if self.quant and q8_dims is not None:
                w = q8(w, q8_dims)
            hit = self._cast[key] = (t, w)
        return hit[1]

    def linear(self, x, p, bias=True):
        """x (..., in) @ w (in, out) + b."""
        w = self._w(p["w"], 0)
        if self.quant:
            x = q8(x, -1)
        y = torch.matmul(x, w)
        if bias and "b" in p:
            y = y + self._w(p["b"])
        return y

    def conv(self, x, p, stride=1, groups=1, wkey="w", bkey="b"):
        w = self._w(p[wkey], (1, 2, 3))
        if self.quant:
            x = q8(x, (1, 2, 3))
        return F.conv2d(x, w, self._w(p[bkey]) if bkey in p else None,
                        stride=stride, padding=w.shape[-1] // 2,
                        groups=groups)

    # --------------------------------------------------------------- tower

    def _ffn(self, x, p, ls):
        c = x.shape[1]
        t = self.conv(x, p["dw"], groups=c)
        b, _, hh, ww = t.shape
        rows = t.permute(0, 2, 3, 1).reshape(-1, c)
        y = self.linear(F.gelu(self.linear(rows, p["fc1"])), p["fc2"])
        y = y.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return x + self._w(ls)[None, :, None, None] * y

    def _attention(self, x, p):
        v = self.cfg["vision"]
        b, c, hh, ww = x.shape
        rows = x.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        y = F.layer_norm(rows, (c,), self._w(p["norm_scale"]),
                         self._w(p["norm_bias"]), v["ln_eps"])
        hd = v["attn_head_dim"]
        nh = c // hd
        qkv = self.linear(y, p["qkv"], bias=False).reshape(b, -1, 3, nh, hd)
        q, k, vv = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        att = torch.softmax((q * hd ** -0.5) @ k.transpose(-1, -2), dim=-1)
        o = (att @ vv).transpose(1, 2).reshape(b, -1, c)
        o = self.linear(o, p["proj"])
        o = o.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return x + self._w(p["ls1"])[None, :, None, None] * o

    def tower(self, image_u8: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) uint8 -> (tokens, out_channels) float32 features."""
        v, p = self.cfg["vision"], self.tree["vision"]
        x = (image_u8.float() / 255.0).permute(2, 0, 1)[None]
        c0 = v["embed_dims"][0]
        x = F.gelu(self.conv(x, p["stem"][0], stride=2))
        x = F.gelu(self.conv(x, p["stem"][1], stride=2, groups=c0))
        x = F.gelu(self.conv(x, p["stem"][2]))
        for i, st in enumerate(p["stages"]):
            c = x.shape[1]
            if "cpe" in st:
                x = self.conv(x, st["cpe"], groups=c)
            for bp in st["blocks"]:
                if v["token_mixers"][i] == "repmixer":
                    x = self.conv(x, bp["mixer"], groups=c)
                    x = self._ffn(x, bp["ffn"], bp["ls"])
                else:
                    x = self._attention(x, bp)
                    x = self._ffn(x, bp["ffn"], bp["ls2"])
            if "down" in st:
                x = F.gelu(self.conv(x, st["down"]["lk"], stride=v["down_stride"],
                                     groups=c))
                x = F.gelu(self.conv(x, st["down"]["pw"]))
        ce = p["conv_exp"]
        x = self.conv(x, ce, groups=x.shape[1])
        se = ce["se"]
        z = x.mean(dim=(2, 3), keepdim=True)
        z = torch.relu(self.conv(z, se, wkey="reduce_w", bkey="reduce_b"))
        z = self.conv(z, se, wkey="expand_w", bkey="expand_b")
        x = F.gelu(x * torch.sigmoid(z))
        return x[0].flatten(1).t()

    def image_embeds(self, image_u8: torch.Tensor) -> torch.Tensor:
        """Tower then the mlp2x_gelu projector: (tokens, hidden)."""
        f = self.tower(image_u8)
        l0, l1 = self.tree["projector"]["layers"]
        return self.linear(F.gelu(self.linear(f, l0)), l1)

    # ------------------------------------------------------------- decoder

    def hidden(self, embeds: torch.Tensor) -> torch.Tensor:
        """(T, hidden) input embeddings -> final-normed hidden states."""
        raise NotImplementedError

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """(rows, hidden) -> (rows, vocab) logits."""
        raise NotImplementedError

    def logits(self, ids: Sequence[int], image_u8: Optional[torch.Tensor],
               image_at: int, rows: Sequence[int]) -> torch.Tensor:
        """f32 logits (len(rows), vocab) at positions ``rows`` of the
        sequence ``ids`` (image slots hold any id), whose image tokens
        start at ``image_at`` (-1: none)."""
        emb = self.tree["decoder"]["embed"]
        x = emb[torch.as_tensor(list(ids), device=emb.device).clamp_min(0)
                ].float()
        if image_u8 is not None and image_at >= 0:
            img = self.image_embeds(image_u8)
            x[image_at:image_at + img.shape[0]] = img
        h = self.hidden(x)
        return self.head(h[torch.as_tensor(list(rows), device=h.device)])


def gaps(ref_logits: torch.Tensor, tokens: Sequence[int]) -> List[float]:
    """How far each served token's reference logit lies below the
    reference's best at its position."""
    top = ref_logits.max(-1).values
    got = ref_logits[torch.arange(len(tokens), device=ref_logits.device),
                     torch.as_tensor(list(tokens), device=ref_logits.device)]
    return (top - got).tolist()
