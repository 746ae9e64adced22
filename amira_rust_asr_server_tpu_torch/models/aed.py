"""Attention-decoder (AED) model family: the conformer encoder + a
transformer decoder with causal self-attention and cross-attention over
the encoder frames (port of models/aed.py).

State dict: ``encoder.*`` and ``decoder.{embed, layers.i.{ln1, self, ln2,
cross, ln3, ff}, ln_out, out}`` with the reference's names and layouts
(``w [in, out]``, LayerNorm ``g``/``b``), so the converter carries the
decoder over as it is. The decoder's arithmetic is the reference's, in the
dtype it is given: LayerNorm with eps 1e-5 written out, the ``-1e9`` masks
in the activation dtype (bf16 too), attention logits scaled by
``sqrt(dh)`` in that dtype, GELU's tanh form (``jax.nn.gelu``'s default).

``config.blank_id`` doubles as BOS (decoder input position 0) and EOS.
Every decode runs a fixed ``max_len`` loop of device ops with no host read
inside, so a CUDA graph captures it whole: :meth:`AEDModel.decode_greedy`
and :meth:`AEDModel.decode_beam` re-run the causally masked full decoder
every step, as the reference does; :meth:`AEDModel.decode_greedy_cached`
keeps static ``[L, B, U+1, H, Dh]`` self-attention K/V buffers and projects
the cross-attention K/V once. :meth:`AEDModel.loss` is the teacher-forced
cross-entropy the family trains on.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.beam import topk_first
from .encoder import EncoderModel, init_encoder_weights, scalar
from .presets import ModelConfig

NEG = -1e9


def _sinusoid(u: int, d: int, dtype=torch.float32,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """[U, D] sinusoidal position encoding (no parameters), made in f32."""
    pos = torch.arange(u, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.full_like(i, 10000.0), 2.0 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _ln(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * p["g"] + p["b"]


def _mask(keep: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Additive mask: 0 where ``keep``, NEG elsewhere, in ``like``'s dtype."""
    return torch.where(keep, scalar(0.0, like), scalar(NEG, like))


def _softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def _mha(q_in: torch.Tensor, kv_in: torch.Tensor, p: Dict[str, torch.Tensor],
         n_heads: int, mask: torch.Tensor) -> torch.Tensor:
    """Multi-head attention: q_in [B, U, D], kv_in [B, T, *], additive mask
    [B, U, T] or [U, T]. Returns [B, U, D]."""
    b, u, d = q_in.shape
    t = kv_in.shape[1]
    h = n_heads
    dh = d // h
    q = (q_in @ p["wq"]).reshape(b, u, h, dh)
    k = (kv_in @ p["wk"]).reshape(b, t, h, dh)
    v = (kv_in @ p["wv"]).reshape(b, t, h, dh)
    logits = torch.einsum("buhd,bthd->bhut", q, k)
    logits = logits / torch.sqrt(scalar(dh, logits))
    logits = logits + (mask[:, None] if mask.dim() == 3 else mask[None, None])
    att = _softmax(logits)
    out = torch.einsum("bhut,bthd->buhd", att, v).reshape(b, u, d)
    return out @ p["wo"]


def _params(**shapes) -> nn.ParameterDict:
    return nn.ParameterDict({name: nn.Parameter(torch.zeros(*shape))
                             for name, shape in shapes.items()})


class AEDDecoder(nn.Module):
    def __init__(self, d_enc: int, vocab_size: int, d: int, layers: int):
        super().__init__()
        self.embed = nn.Parameter(torch.zeros(vocab_size, d))
        self.layers = nn.ModuleList(nn.ModuleDict({
            "ln1": _params(g=(d,), b=(d,)),
            "self": _params(wq=(d, d), wk=(d, d), wv=(d, d), wo=(d, d)),
            "ln2": _params(g=(d,), b=(d,)),
            "cross": _params(wq=(d, d), wk=(d_enc, d), wv=(d_enc, d),
                             wo=(d, d)),
            "ln3": _params(g=(d,), b=(d,)),
            "ff": _params(w1=(d, 4 * d), b1=(4 * d,), w2=(4 * d, d),
                          b2=(d,)),
        }) for _ in range(layers))
        self.ln_out = _params(g=(d,), b=(d,))
        self.out = _params(w=(d, vocab_size), b=(vocab_size,))


def _ff(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    h = F.gelu(x @ p["w1"] + p["b1"], approximate="tanh")
    return h @ p["w2"] + p["b2"]


def _counts(toks: torch.Tensor, eos: int, max_len: int) -> torch.Tensor:
    """Tokens before the first EOS along the last axis (``max_len`` when
    there is none), int32."""
    is_tok = toks != eos
    first_eos = torch.argmin(is_tok.to(torch.uint8), dim=-1)
    return torch.where(is_tok.all(dim=-1), max_len, first_eos).to(
        torch.int32)


class AEDModel(EncoderModel):
    """``dec_layers``, ``dec_heads`` and ``d_dec`` are the reference's
    decoder hyperparameters (not in ``ModelConfig``); ``d_dec=0`` means
    ``min(d_enc, 512)``."""

    def __init__(self, config: ModelConfig, dec_layers: int = 2,
                 dec_heads: int = 4, d_dec: int = 0):
        super().__init__(config)
        self.dec_layers, self.dec_heads, self.d_dec = (dec_layers, dec_heads,
                                                       d_dec)
        self.decoder = AEDDecoder(config.d_enc, config.vocab_size, self.d,
                                  dec_layers)

    @property
    def d(self) -> int:
        return self.d_dec or min(self.config.d_enc, 512)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "AEDModel":
        """Seeded random init: the encoder's (``init_encoder_weights``),
        then the reference's decoder scales: each dense ``normal /
        sqrt(fan_in)``, the embedding's times ``sqrt(d)``, zero biases,
        unit LayerNorm gains."""
        init_encoder_weights(self.encoder, generator)

        def dense(w, scale=1.0):
            w.copy_(torch.randn(w.shape, generator=generator)
                    / w.shape[0] ** 0.5 * scale)

        for name, p in self.decoder.named_parameters():
            leaf = name.rpartition(".")[2]
            if name == "embed":
                dense(p, self.d ** 0.5)
            elif leaf == "g":
                p.fill_(1.0)
            elif leaf.startswith("w"):
                dense(p)
            else:
                p.zero_()
        return self

    # -- apply --------------------------------------------------------------
    def decoder_logits(self, dec_in: torch.Tensor, enc: torch.Tensor,
                       enc_lens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder forward: ``dec_in [B, U]`` token ids
        (position 0 is BOS = blank), ``enc [B, T, d_enc]`` -> logits
        [B, U, vocab]; causal over U, cross-attention masked to the valid
        encoder frames."""
        p = self.decoder
        b, u = dec_in.shape
        t = enc.shape[1]
        dev = dec_in.device
        x = p.embed[dec_in.long()] + _sinusoid(u, self.d, p.embed.dtype, dev)
        ar_u = torch.arange(u, device=dev)
        causal = _mask(ar_u[:, None] >= ar_u[None, :], x)
        enc_mask = _mask(torch.arange(t, device=dev)[None, None, :]
                         < enc_lens[:, None, None], x).expand(b, u, t)
        for lp in p.layers:
            h = _ln(x, lp["ln1"])
            x = x + _mha(h, h, lp["self"], self.dec_heads, causal)
            x = x + _mha(_ln(x, lp["ln2"]), enc, lp["cross"], self.dec_heads,
                         enc_mask)
            x = x + _ff(_ln(x, lp["ln3"]), lp["ff"])
        x = _ln(x, p.ln_out)
        return x @ p.out["w"] + p.out["b"]

    def loss(self, features: torch.Tensor, feat_lens: torch.Tensor,
             labels: torch.Tensor, label_lens: torch.Tensor) -> torch.Tensor:
        """Mean per-token teacher-forced cross-entropy: the targets are
        ``labels`` with EOS (= blank) at position ``label_lens``, the
        decoder's input ``[BOS, labels]``; the mean runs over the valid
        positions, EOS included."""
        blank = self.config.blank_id
        enc, enc_lens = self.encode(features, feat_lens)
        dev = enc.device
        labels = labels.to(dev).long()
        label_lens = label_lens.to(dev).long()
        b, u_lab = labels.shape
        dec_in = torch.cat([torch.full((b, 1), blank, dtype=torch.long,
                                       device=dev), labels], dim=1)
        pos = torch.arange(u_lab + 1, device=dev)[None, :]
        targets = torch.where(pos < label_lens[:, None],
                              F.pad(labels, (0, 1)), blank)  # EOS at len
        valid = (pos <= label_lens[:, None]).to(torch.float32)
        logp = torch.log_softmax(self.decoder_logits(dec_in, enc, enc_lens),
                                 dim=-1)
        nll = -torch.gather(logp, 2, targets[..., None])[..., 0]
        return (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)

    def decode_greedy(self, features: torch.Tensor, feat_lens: torch.Tensor,
                      *, max_len: int = 64
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward + greedy autoregressive decode, the full masked decoder
        re-run every step: (tokens [B, max_len] EOS-padded, counts [B])."""
        eos = self.config.blank_id
        enc, enc_lens = self.encode(features, feat_lens)
        b = enc.shape[0]
        buf = torch.full((b, max_len + 1), eos, dtype=torch.int32,
                         device=enc.device)                    # BOS at 0
        done = torch.zeros((b,), dtype=torch.bool, device=enc.device)
        for u in range(max_len):
            logits = self.decoder_logits(buf, enc, enc_lens)
            nxt = torch.argmax(logits[:, u], dim=-1).to(torch.int32)
            nxt = torch.where(done, eos, nxt)
            done = done | (nxt == eos)
            buf[:, u + 1] = nxt
        toks = buf[:, 1:]
        return toks, _counts(toks, eos, max_len)

    def sequence_scores(self, features: torch.Tensor, feat_lens: torch.Tensor,
                        tokens: torch.Tensor, counts: torch.Tensor
                        ) -> torch.Tensor:
        """Teacher-forced total log-prob of given sequences, including the
        EOS emission at position ``counts`` (what beam search maximizes)."""
        eos = self.config.blank_id
        enc, enc_lens = self.encode(features, feat_lens)
        b, u_lab = tokens.shape
        dev = tokens.device
        bos = torch.full((b, 1), eos, dtype=torch.int32, device=dev)
        dec_in = torch.cat([bos, tokens.to(torch.int32)], dim=1)
        pos = torch.arange(u_lab + 1, device=dev)[None, :]
        padded = F.pad(tokens.to(torch.int32), (0, 1))
        targets = torch.where(pos < counts[:, None], padded, eos).long()
        valid = (pos <= counts[:, None]).to(torch.float32)
        logp = torch.log_softmax(self.decoder_logits(dec_in, enc, enc_lens),
                                 dim=-1)
        lp = torch.gather(logp, 2, targets[..., None])[..., 0]
        return (lp * valid).sum(dim=1)

    def decode_beam(self, features: torch.Tensor, feat_lens: torch.Tensor,
                    *, width: int = 4, max_len: int = 64,
                    length_penalty: float = 0.0, return_all: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Batched beam search with optional length normalization.

        Returns (tokens [B, max_len], counts [B], scores [B]) of each lane's
        best hypothesis, or with ``return_all`` all K hypotheses best-first
        ([B, K, max_len], [B, K], [B, K]). ``scores`` are total log-probs
        including EOS; ``length_penalty`` alpha only ranks (score /
        len^alpha). Finished hypotheses persist with frozen scores: their
        next-token distribution is EOS at zero cost. Hypotheses cut at
        ``max_len`` are charged their EOS at the end."""
        eos = self.config.blank_id
        v = self.config.vocab_size
        enc, enc_lens = self.encode(features, feat_lens)
        b, dev = enc.shape[0], enc.device
        k = width
        u_max = max_len + 1
        enc_rep = enc.repeat_interleave(k, dim=0)           # [B*K, T, D]
        lens_rep = enc_lens.repeat_interleave(k, dim=0)
        f32 = torch.float32

        buf = torch.full((b, k, u_max), eos, dtype=torch.int32, device=dev)
        scores = torch.full((b, k), NEG, dtype=f32, device=dev)
        scores[:, 0] = 0.0              # hypothesis 0 is the live empty one
        done = torch.zeros((b, k), dtype=torch.bool, device=dev)
        eos_row = torch.full((v,), NEG, dtype=f32, device=dev)
        eos_row[eos:eos + 1].fill_(0.0)  # a fill: no host copy in a capture

        for u in range(max_len):
            logits = self.decoder_logits(buf.reshape(b * k, u_max), enc_rep,
                                         lens_rep)
            logp = torch.log_softmax(logits[:, u], dim=-1).reshape(b, k, v)
            logp = torch.where(done[..., None], eos_row, logp)
            cand = (scores[..., None] + logp).reshape(b, k * v)
            top, idx = topk_first(cand, k)
            parent = idx // v                                 # [B, K]
            token = (idx % v).to(torch.int32)
            buf = torch.gather(buf, 1, parent[..., None].expand(b, k, u_max))
            done = torch.gather(done, 1, parent)
            buf[:, :, u + 1] = torch.where(done, eos, token)
            done = done | (token == eos)
            scores = top
        tail = torch.log_softmax(
            self.decoder_logits(buf.reshape(b * k, u_max), enc_rep,
                                lens_rep)[:, max_len], dim=-1)[:, eos]
        scores = torch.where(done, scores, scores + tail.reshape(b, k))
        toks = buf[:, :, 1:]                                  # [B, K, L]
        counts = _counts(toks, eos, max_len)
        ranked = (scores / counts.clamp(min=1).to(f32) ** length_penalty
                  if length_penalty > 0 else scores)
        if return_all:
            order = torch.sort(-ranked, dim=1, stable=True).indices
            return (torch.gather(toks, 1, order[..., None].expand_as(toks)),
                    torch.gather(counts, 1, order),
                    torch.gather(scores, 1, order))
        best = torch.argmax(ranked, dim=1)
        rows = torch.arange(b, device=dev)
        return toks[rows, best], counts[rows, best], scores[rows, best]

    def decode_greedy_cached(self, features: torch.Tensor,
                             feat_lens: torch.Tensor, *, max_len: int = 64
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """KV-cached greedy decode, token-identical to :meth:`decode_greedy`
        (pre-LN makes position u's K/V depend only on tokens <= u): the
        self-attention K/V of every layer in static ``[L, B, U+1, H, Dh]``
        buffers written one position per step, the cross-attention K/V
        projected from the encoder once before the loop."""
        enc, enc_lens = self.encode(features, feat_lens)
        return self.greedy_cached_from_enc(enc, enc_lens, max_len=max_len)

    def greedy_cached_from_enc(self, enc: torch.Tensor,
                               enc_lens: torch.Tensor, *, max_len: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`decode_greedy_cached` from the encoder's output."""
        eos = self.config.blank_id
        p = self.decoder
        b, t = enc.shape[0], enc.shape[1]
        d, h = self.d, self.dec_heads
        dh = d // h
        u_max = max_len + 1
        dev, dt = enc.device, p.embed.dtype
        pe = _sinusoid(u_max, d, dt, dev)

        # cross-attention K/V: one projection per layer, reused every step
        cross_kv = [((enc @ lp["cross"]["wk"]).reshape(b, t, h, dh),
                     (enc @ lp["cross"]["wv"]).reshape(b, t, h, dh))
                    for lp in p.layers]
        enc_mask = None
        kc = torch.zeros((len(p.layers), b, u_max, h, dh), dtype=dt,
                         device=dev)
        vc = torch.zeros_like(kc)
        buf = torch.full((b, u_max), eos, dtype=torch.int32, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        ar_u = torch.arange(u_max, device=dev)

        for u in range(max_len):
            x = p.embed[buf[:, u].long()] + pe[u]                 # [B, D]
            pos_mask = None
            for li, lp in enumerate(p.layers):
                hh = _ln(x, lp["ln1"])
                q = (hh @ lp["self"]["wq"]).reshape(b, h, dh)
                kc[li, :, u] = (hh @ lp["self"]["wk"]).reshape(b, h, dh)
                vc[li, :, u] = (hh @ lp["self"]["wv"]).reshape(b, h, dh)
                logits = torch.einsum("bhd,bthd->bht", q, kc[li])
                logits = logits / torch.sqrt(scalar(dh, logits))
                if pos_mask is None:
                    pos_mask = _mask(ar_u <= u, logits)
                att = _softmax(logits + pos_mask[None, None, :])
                x = x + torch.einsum("bht,bthd->bhd", att, vc[li]
                                     ).reshape(b, d) @ lp["self"]["wo"]
                hh = _ln(x, lp["ln2"])
                q = (hh @ lp["cross"]["wq"]).reshape(b, h, dh)
                ck, cv = cross_kv[li]
                cl = torch.einsum("bhd,bthd->bht", q, ck)
                cl = cl / torch.sqrt(scalar(dh, cl))
                if enc_mask is None:
                    enc_mask = _mask(torch.arange(t, device=dev)[None, :]
                                     < enc_lens[:, None], cl)      # [B, T]
                catt = _softmax(cl + enc_mask[:, None, :])
                x = x + torch.einsum("bht,bthd->bhd", catt, cv
                                     ).reshape(b, d) @ lp["cross"]["wo"]
                x = x + _ff(_ln(x, lp["ln3"]), lp["ff"])
            x = _ln(x, p.ln_out)
            step_logits = x @ p.out["w"] + p.out["b"]
            nxt = torch.argmax(step_logits, dim=-1).to(torch.int32)
            nxt = torch.where(done, eos, nxt)
            done = done | (nxt == eos)
            buf[:, u + 1] = nxt
        toks = buf[:, 1:]
        return toks, _counts(toks, eos, max_len)
