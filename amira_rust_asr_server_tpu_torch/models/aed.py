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

The decoder's depth, heads and width are the config's ``dec_layers``,
``dec_heads`` and ``d_dec``. Its first input positions are the task prompt
``dec_prompt`` (:attr:`AEDModel.prompt`; by default the single BOS
``blank_id``, the reference's), and ``blank_id`` is its EOS. Every entry
takes the prompt as the decoder's prefix and returns tokens without it.
Every decode runs a fixed ``max_len`` loop of device ops with no host read
inside, so a CUDA graph captures it whole: :meth:`AEDModel.decode_greedy`
and :meth:`AEDModel.decode_beam` re-run the causally masked full decoder
every step, as the reference does; :meth:`AEDModel.decode_greedy_cached`
prefills the prompt's positions into static self-attention K/V buffers in
one pass, then writes one position per step, and projects the
cross-attention K/V once. Its loop runs in pieces of :data:`LOOP_CHUNK`
decisions on a :class:`CachedLoop` kept in place (:meth:`AEDModel.
greedy_open`, then :meth:`AEDModel.greedy_chunk`); each step reads its
position from the state on the device, so every chunk is the same piece of
work and a server may capture it as one graph, replayed until every real
lane has emitted EOS; the whole loop runs every chunk. Each of its steps'
attentions reads the cache and the cross K/V where the state holds them,
through ``ops/kernels/aed_attention.py`` ``decode_attention``: on CUDA one
launch of ``csrc/aed_attention.cu`` (sums in f32, one rounding), on the CPU
the einsum arithmetic above.
:meth:`AEDModel.loss` is the teacher-forced cross-entropy the family trains
on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.beam import topk_first
from ..ops.kernels.aed_attention import NEG, decode_attention
from .encoder import EncoderModel, init_encoder_weights, scalar
from .presets import ModelConfig

# decisions in each piece of the cached greedy loop: the opening makes the
# first N (the prompt's prefill and N - 1 steps), each chunk the next N. A
# loop served in pieces runs at most N - 1 decisions past its last live one,
# and the piece queued ahead of the flag's read.
LOOP_CHUNK = 8


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


@dataclasses.dataclass
class CachedLoop:
    """The state of the KV-cached greedy loop, read and written in place
    by its pieces, so that each piece can be a graph over the same buffers.
    ``cross`` and ``frame_mask`` hold up to :attr:`capacity` encoder
    frames; a state views ``t`` of them (:meth:`frames`), so buckets of one
    batch size can share one set. The positions hold whole chunks (R): a
    chunk past ``max_len`` writes none that a decision up to it reads."""

    cross: torch.Tensor       # flat: cross K, then V, each [L, B, t, H, Dh]
    frame_mask: torch.Tensor  # flat: [B, 1, 1, t] additive, valid frames
    real: torch.Tensor        # [B] bool: the lanes the flag watches
    k: torch.Tensor           # [L, B, P + R, H, Dh] self-attention K
    v: torch.Tensor           # and V
    pe: torch.Tensor          # [P + R, d] the positions' sinusoids
    buf: torch.Tensor         # [B, P + R] int32: prompt, then tokens
    done: torch.Tensor        # [B] bool: the lane has emitted EOS
    counts: torch.Tensor      # [B] int32: tokens before the first EOS
    live: torch.Tensor        # [1] bool: a real lane has not emitted EOS
    # [1] int64 (index_copy_'s index type): the position the next decision
    # feeds, P + u - 1 for decision u
    pos: torch.Tensor
    ar: torch.Tensor          # [P + max_len] int64: the positions attended
    prompt_len: int
    max_len: int
    t: int                    # encoder frames viewed

    @property
    def capacity(self) -> int:
        return self.frame_mask.numel() // self.buf.shape[0]

    @property
    def chunks(self) -> int:
        """The chunks after the opening that reach ``max_len``."""
        return (self.buf.shape[1] - self.prompt_len) // LOOP_CHUNK - 1

    @property
    def tokens(self) -> torch.Tensor:
        """[B, max_len] int32, EOS after each lane's last decision."""
        return self.buf[:, self.prompt_len:self.prompt_len + self.max_len]

    def frames(self, t: int) -> "CachedLoop":
        """This state's buffers, viewing ``t`` encoder frames."""
        if t > self.capacity:
            raise ValueError(f"{t} encoder frames exceed the loop state's "
                             f"{self.capacity}")
        return dataclasses.replace(self, t=t)

    def cross_kv(self, layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer ``layer``'s cross-attention K and V, contiguous [B, t, H,
        Dh] views."""
        n_layers, b, _, h, dh = self.k.shape
        kv = self.cross[:2 * n_layers * b * self.t * h * dh].view(
            2, n_layers, b, self.t, h, dh)
        return kv[0, layer], kv[1, layer]

    @property
    def enc_mask(self) -> torch.Tensor:
        b = self.buf.shape[0]
        return self.frame_mask[:b * self.t].view(b, 1, 1, self.t)


def port_config(config) -> ModelConfig:
    """``config`` as the port's :class:`ModelConfig`: another model config
    (the reference's, which keeps no decoder fields) gives its fields of
    the same names, and the decoder's take their defaults."""
    if isinstance(config, ModelConfig):
        return config
    return ModelConfig(**{f.name: getattr(config, f.name)
                          for f in dataclasses.fields(ModelConfig)
                          if hasattr(config, f.name)})


class AEDModel(EncoderModel):
    """The decoder's hyperparameters are the config's (``dec_layers``,
    ``dec_heads``, ``d_dec``: 0 means ``min(d_enc, 512)``, ``dec_prompt``)."""

    def __init__(self, config: ModelConfig):
        config = port_config(config)
        super().__init__(config)
        if self.d % config.dec_heads:
            raise ValueError("the decoder's width must be divisible by "
                             "dec_heads")
        self.decoder = AEDDecoder(config.d_enc, config.vocab_size, self.d,
                                  config.dec_layers)

    @property
    def d(self) -> int:
        return self.config.d_dec or min(self.config.d_enc, 512)

    @property
    def prompt(self) -> Tuple[int, ...]:
        """The decoder's first input ids: ``dec_prompt``, or the BOS
        ``(blank_id,)`` where it is empty."""
        return self.config.dec_prompt or (self.config.blank_id,)

    def _prompted(self, shape, device) -> torch.Tensor:
        """int32 ``[..., U]`` of EOS with the prompt at positions
        ``0..P-1``, each position a fill (no host copy, so a capture holds
        it)."""
        return self._prompt_into(torch.empty(shape, dtype=torch.int32,
                                             device=device))

    def _prompt_into(self, buf: torch.Tensor) -> torch.Tensor:
        """:meth:`_prompted` written into ``buf`` in place."""
        eos = self.config.blank_id
        buf.fill_(eos)
        for i, tok in enumerate(self.prompt):
            if tok != eos:
                buf[..., i].fill_(tok)
        return buf

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
        (positions ``0..P-1`` the prompt, :attr:`prompt`), ``enc [B, T,
        d_enc]`` -> logits [B, U, vocab]; causal over U, cross-attention
        masked to the valid encoder frames."""
        p = self.decoder
        b, u = dec_in.shape
        t = enc.shape[1]
        dev = dec_in.device
        x = p.embed[dec_in.long()] + _sinusoid(u, self.d, p.embed.dtype, dev)
        ar_u = torch.arange(u, device=dev)
        causal = _mask(ar_u[:, None] >= ar_u[None, :], x)
        enc_mask = _mask(torch.arange(t, device=dev)[None, None, :]
                         < enc_lens[:, None, None], x).expand(b, u, t)
        heads = self.config.dec_heads
        for lp in p.layers:
            h = _ln(x, lp["ln1"])
            x = x + _mha(h, h, lp["self"], heads, causal)
            x = x + _mha(_ln(x, lp["ln2"]), enc, lp["cross"], heads, enc_mask)
            x = x + _ff(_ln(x, lp["ln3"]), lp["ff"])
        x = _ln(x, p.ln_out)
        return x @ p.out["w"] + p.out["b"]

    def loss(self, features: torch.Tensor, feat_lens: torch.Tensor,
             labels: torch.Tensor, label_lens: torch.Tensor) -> torch.Tensor:
        """Mean per-token teacher-forced cross-entropy: the targets are
        ``labels`` with EOS (= blank) at position ``label_lens``, the
        decoder's input ``[prompt, labels]``; the mean runs over the valid
        positions, EOS included."""
        blank = self.config.blank_id
        enc, enc_lens = self.encode(features, feat_lens)
        dev = enc.device
        labels = labels.to(dev).long()
        label_lens = label_lens.to(dev).long()
        b, u_lab = labels.shape
        n_p = len(self.prompt)
        dec_in = torch.cat([self._prompted((b, n_p), dev).long(), labels],
                           dim=1)
        pos = torch.arange(u_lab + 1, device=dev)[None, :]
        targets = torch.where(pos < label_lens[:, None],
                              F.pad(labels, (0, 1)), blank)  # EOS at len
        valid = (pos <= label_lens[:, None]).to(torch.float32)
        logp = torch.log_softmax(
            self.decoder_logits(dec_in, enc, enc_lens)[:, n_p - 1:], dim=-1)
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
        n_p = len(self.prompt)
        buf = self._prompted((b, n_p + max_len), enc.device)
        done = torch.zeros((b,), dtype=torch.bool, device=enc.device)
        for u in range(max_len):
            logits = self.decoder_logits(buf, enc, enc_lens)
            nxt = torch.argmax(logits[:, n_p - 1 + u], dim=-1).to(
                torch.int32)
            nxt = torch.where(done, eos, nxt)
            done = done | (nxt == eos)
            buf[:, n_p + u] = nxt
        toks = buf[:, n_p:]
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
        n_p = len(self.prompt)
        dec_in = torch.cat([self._prompted((b, n_p), dev),
                            tokens.to(torch.int32)], dim=1)
        pos = torch.arange(u_lab + 1, device=dev)[None, :]
        padded = F.pad(tokens.to(torch.int32), (0, 1))
        targets = torch.where(pos < counts[:, None], padded, eos).long()
        valid = (pos <= counts[:, None]).to(torch.float32)
        logp = torch.log_softmax(
            self.decoder_logits(dec_in, enc, enc_lens)[:, n_p - 1:], dim=-1)
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
        n_p = len(self.prompt)
        u_max = n_p + max_len
        enc_rep = enc.repeat_interleave(k, dim=0)           # [B*K, T, D]
        lens_rep = enc_lens.repeat_interleave(k, dim=0)
        f32 = torch.float32

        buf = self._prompted((b, k, u_max), dev)
        scores = torch.full((b, k), NEG, dtype=f32, device=dev)
        scores[:, 0] = 0.0              # hypothesis 0 is the live empty one
        done = torch.zeros((b, k), dtype=torch.bool, device=dev)
        eos_row = torch.full((v,), NEG, dtype=f32, device=dev)
        eos_row[eos:eos + 1].fill_(0.0)  # a fill: no host copy in a capture

        for u in range(max_len):
            logits = self.decoder_logits(buf.reshape(b * k, u_max), enc_rep,
                                         lens_rep)
            logp = torch.log_softmax(logits[:, n_p - 1 + u], dim=-1).reshape(
                b, k, v)
            logp = torch.where(done[..., None], eos_row, logp)
            cand = (scores[..., None] + logp).reshape(b, k * v)
            top, idx = topk_first(cand, k)
            parent = idx // v                                 # [B, K]
            token = (idx % v).to(torch.int32)
            buf = torch.gather(buf, 1, parent[..., None].expand(b, k, u_max))
            done = torch.gather(done, 1, parent)
            buf[:, :, n_p + u] = torch.where(done, eos, token)
            done = done | (token == eos)
            scores = top
        last = self.decoder_logits(buf.reshape(b * k, u_max), enc_rep,
                                   lens_rep)[:, n_p - 1 + max_len]
        tail = torch.log_softmax(last, dim=-1)[:, eos]
        scores = torch.where(done, scores, scores + tail.reshape(b, k))
        toks = buf[:, :, n_p:]                                # [B, K, L]
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
        (pre-LN makes position u's K/V depend only on tokens <= u): see
        :meth:`greedy_cached_from_enc`."""
        enc, enc_lens = self.encode(features, feat_lens)
        return self.greedy_cached_from_enc(enc, enc_lens, max_len=max_len)

    def greedy_cached_from_enc(self, enc: torch.Tensor,
                               enc_lens: torch.Tensor, *, max_len: int,
                               return_logits: bool = False):
        """:meth:`decode_greedy_cached` from the encoder's output: (tokens
        [B, max_len] without the prompt, counts [B]), and with
        ``return_logits`` each decision's logits [B, max_len, vocab].

        The opening (:meth:`greedy_open`), then every chunk
        (:meth:`greedy_chunk`), on a fresh :class:`CachedLoop`: the
        ``max_len`` decisions whatever the lanes emit (and those of the
        last chunk past it, which change none of them)."""
        loop = self.cached_loop(enc.shape[0], enc.shape[1], max_len,
                                enc.device)
        kept: Optional[List[torch.Tensor]] = [] if return_logits else None
        self.greedy_open(enc, enc_lens, loop, kept)
        for _ in range(loop.chunks):
            self.greedy_chunk(loop, LOOP_CHUNK, kept)
        toks, counts = loop.tokens, loop.counts
        if return_logits:
            return toks, counts, torch.stack(kept[:max_len], dim=1)
        return toks, counts

    def cached_loop(self, b: int, frames: int, max_len: int,
                    device: torch.device) -> CachedLoop:
        """A zeroed :class:`CachedLoop` for ``b`` lanes of up to ``frames``
        encoder frames and ``max_len`` decisions (positions for whole
        chunks), in the decoder's dtype on ``device``."""
        p = self.decoder
        dt = p.embed.dtype
        n_layers, d, h = len(p.layers), self.d, self.config.dec_heads
        n_p = len(self.prompt)
        u_max = n_p + -(-max_len // LOOP_CHUNK) * LOOP_CHUNK

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=device)

        return CachedLoop(
            cross=zeros(2 * n_layers * b * frames * d),
            frame_mask=zeros(b * frames), real=zeros(b, dtype=torch.bool),
            k=zeros(n_layers, b, u_max, h, d // h),
            v=zeros(n_layers, b, u_max, h, d // h),
            # the positions past P + max_len feed no decision at or before
            # max_len: zeros, so the others are the sinusoids of P + max_len
            pe=torch.cat([_sinusoid(n_p + max_len, d, dt, device),
                          zeros(u_max - n_p - max_len, d)]),
            buf=self._prompted((b, u_max), device),
            done=zeros(b, dtype=torch.bool),
            counts=zeros(b, dtype=torch.int32),
            live=zeros(1, dtype=torch.bool), pos=zeros(1, dtype=torch.int64),
            ar=torch.arange(n_p + max_len, device=device),
            prompt_len=n_p, max_len=max_len, t=frames)

    def greedy_open(self, enc: torch.Tensor, enc_lens: torch.Tensor,
                    loop: CachedLoop,
                    kept: Optional[List[torch.Tensor]] = None,
                    real: Optional[torch.Tensor] = None) -> None:
        """The loop's opening on ``loop`` (whose state it resets): the
        cross-attention K/V projected from ``enc [B, t, d_enc]`` once, the
        valid frames' mask, then the first :data:`LOOP_CHUNK` decisions. The
        first is the prefill's: the prompt's P positions as one block, their
        self-attention K/V into the cache, the last one's logits deciding.
        ``kept`` collects each decision's logits; ``real [B]`` bool names
        the lanes whose EOS the flag waits for (by default every lane)."""
        p = self.decoder
        b, t = enc.shape[0], enc.shape[1]
        if (b, t) != (loop.buf.shape[0], loop.t):
            raise ValueError(f"the loop state holds {loop.buf.shape[0]} "
                             f"lanes of {loop.t} frames, not {b} of {t}")
        h = self.config.dec_heads
        dh = self.d // h
        for li, lp in enumerate(p.layers):
            ck, cv = loop.cross_kv(li)
            ck.copy_((enc @ lp["cross"]["wk"]).reshape(b, t, h, dh))
            cv.copy_((enc @ lp["cross"]["wv"]).reshape(b, t, h, dh))
        loop.enc_mask.copy_(_mask(torch.arange(t, device=enc.device)[None, :]
                                  < enc_lens[:, None], loop.pe)[:, None,
                                                                None, :])
        if real is None:
            loop.real.fill_(True)
        else:
            loop.real.copy_(real)
        loop.k.zero_()
        loop.v.zero_()
        self._prompt_into(loop.buf)
        loop.done.zero_()
        loop.pos.fill_(loop.prompt_len - 1)  # the prompt's last decides
        self._decide(loop, self._cached_block(
            loop, loop.ar[:loop.prompt_len]), kept)
        self.greedy_chunk(loop, LOOP_CHUNK - 1, kept)

    def greedy_chunk(self, loop: CachedLoop, steps: int,
                     kept: Optional[List[torch.Tensor]] = None) -> None:
        """``steps`` decisions of the loop on ``loop`` from its position
        (one position a step, each feeding the last decision's token and
        attending to the cache up to it), then its counts and its flag "a
        real lane is live". A lane that has emitted EOS takes EOS again, so
        steps past it change none of its tokens."""
        for _ in range(steps):
            self._decide(loop, self._cached_block(loop, loop.pos), kept)
        loop.counts.copy_(_counts(loop.tokens, self.config.blank_id,
                                  loop.max_len))
        loop.live.copy_((loop.real & ~loop.done).any().reshape(1))

    def _decide(self, loop: CachedLoop, logits: torch.Tensor,
                kept: Optional[List[torch.Tensor]]) -> None:
        """The next token of every lane from ``logits`` (EOS once a lane
        has emitted it), stored at the next position, which the position
        moves on to."""
        eos = self.config.blank_id
        if kept is not None:
            kept.append(logits)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(loop.done, eos, nxt)
        loop.done |= nxt == eos
        loop.pos.add_(1)
        loop.buf.index_copy_(1, loop.pos, nxt[:, None])

    def _cached_block(self, loop: CachedLoop, at: torch.Tensor
                      ) -> torch.Tensor:
        """Positions ``at`` ([n] int64 on the device) through the decoder,
        their K/V into the cache: the last position's logits [B, vocab].
        Positions and sinusoids follow the teacher-forced ``[prompt,
        tokens]`` of :meth:`decoder_logits`."""
        p = self.decoder
        b, n, u = loop.buf.shape[0], at.shape[0], loop.ar.shape[0]
        d, h = self.d, self.config.dec_heads
        dh = d // h
        x = (p.embed[loop.buf.index_select(1, at).long()]
             + loop.pe.index_select(0, at))
        for li, lp in enumerate(p.layers):
            hh = _ln(x, lp["ln1"])
            q = (hh @ lp["self"]["wq"]).reshape(b, n, h, dh)
            loop.k[li].index_copy_(1, at, (hh @ lp["self"]["wk"]).reshape(
                b, n, h, dh))
            loop.v[li].index_copy_(1, at, (hh @ lp["self"]["wv"]).reshape(
                b, n, h, dh))
            x = x + decode_attention(q, loop.k[li, :, :u], loop.v[li, :, :u],
                                     at=at) @ lp["self"]["wo"]
            hh = _ln(x, lp["ln2"])
            q = (hh @ lp["cross"]["wq"]).reshape(b, n, h, dh)
            ck, cv = loop.cross_kv(li)
            x = x + decode_attention(q, ck, cv, mask=loop.enc_mask
                                     ) @ lp["cross"]["wo"]
            x = x + _ff(_ln(x, lp["ln3"]), lp["ff"])
        x = _ln(x[:, -1], p.ln_out)
        return x @ p.out["w"] + p.out["b"]
