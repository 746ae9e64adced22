"""Wrapper of the whole-loop greedy decode CUDA kernel
(``csrc/decode_loop.cu``), and its plain PyTorch version.

:func:`greedy_loop` runs the whole label-looping decode for a batch of
lanes. For tensors on the CPU it takes :func:`greedy_loop_reference`, which
is ``ops.greedy.greedy_decode`` with a prediction net and joint that round
where the kernel rounds; for CUDA tensors it launches the kernel or raises.

Rounding points (those of the TPU kernel): the gate and joint products
accumulate in f32 with f32 biases; h, c and pred_out are stored in the
working type; the joint hidden vector is rounded to the working type before
the output matrix. In f32 this is exactly the model's own arithmetic.

The int8 branch (``int8_decode_weights``; the TPU kernel's ``quant=True``)
runs when the weights carry :func:`quantize_pred_lstm`'s output
(:meth:`DecodeWeights.with_int8_lstm`): each LSTM layer is W8A8,
``qdot(x) + qdot(h) + b`` with each half of the input quantized on its own
scale, and layer 1 reads layer 0's new h unrounded, as the TPU kernel does.
Its launches count in ``greedy_loop_int8.launches``.

The kernel runs one block per SM, each owning a slice of the columns
(:func:`slice_plan`); :meth:`DecodeWeights.block_slices` packs the weights
per block once (:func:`pack_columns`), the int8 halves' words zero-padded to
the int8 tensor cores' k-step (:func:`pad_words`). The step kernel
(``decode_step``) runs on the same grid with :meth:`JointWeights.block_slices`.

Captured CUDA graphs read these tables at fixed addresses, so new weights
reach them only in place: :meth:`DecodeWeights.refresh_` and
:meth:`JointWeights.refresh_` copy tables recomputed from the new weights
into the tensors that exist, the per-grid block slices made so far among
them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..greedy import GreedyResult, greedy_decode
from . import _build

INT8_KEYS = ("wx0", "wh0", "wx1", "wh1")  # the four int8 LSTM halves


def quant_scale(amax: torch.Tensor) -> torch.Tensor:
    """The symmetric int8 scale ``amax / 127 + 1e-12``, divided as IEEE
    division on every device: PyTorch multiplies a CUDA tensor by the
    reciprocal of a Python scalar divisor, an ulp off on some values."""
    return amax / torch.full_like(amax, 127.0) + 1e-12


def quantize_pred_lstm(lstm_w: Sequence[torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8 of the LSTM weights ``[in + P, 4P]``
    (port of ops/pallas/decode_loop.py ``quantize_pred_lstm``), split at the
    x/h boundary (E rows of layer 0, P rows of layer 1), each half with its
    own scales ``amax / 127 + 1e-12`` and clipped to +-127. Keys as the
    reference's: ``wx0_q``, ``sx0``, ``wh0_q``, ``sh0``, ... ."""
    out = {}
    for li, w in enumerate(lstm_w):
        w = w.detach().float()
        d_p = w.shape[1] // 4
        d_x = w.shape[0] - d_p
        for tag, part in (("x", w[:d_x]), ("h", w[d_x:])):
            s = quant_scale(part.abs().amax(dim=0))
            q = torch.clamp(torch.round(part / s[None, :]), -127, 127)
            out[f"w{tag}{li}_q"] = q.to(torch.int8).contiguous()
            out[f"s{tag}{li}"] = s.contiguous()
    return out


def pack_rows4(q: torch.Tensor) -> torch.Tensor:
    """int8 ``[K, N]`` -> int32 ``[K / 4, N]``: each word holds rows 4r ..
    4r + 3 of a column (lowest byte first), as the int8 tensor cores'
    ``mma.sync`` m16n8k32 fragments take them."""
    k, n = q.shape
    if k % 4:
        raise ValueError(f"the int8 decode kernels take rows in fours, got {k}")
    return (q.reshape(k // 4, 4, n).permute(0, 2, 1).contiguous()
            .view(torch.int32).reshape(k // 4, n))


def pad_words(words: torch.Tensor) -> torch.Tensor:
    """int32 words ``[K / 4, N]`` (:func:`pack_rows4`) with zero words
    appended to a multiple of 8: one k-step of the int8 tensor cores'
    ``mma.sync`` m16n8k32 (32 int8 rows). Zero words add nothing to the
    exact int32 sums."""
    pad = -words.shape[0] % 8
    return torch.cat([words, words.new_zeros((pad, words.shape[1]))]) \
        if pad else words


def slice_plan(d_pred: int, d_joint: int, vocab: int, max_blocks: int,
               tensor_cores: bool):
    """``(blocks, pb, jb, vb)``: the decode kernels' grid of at most
    ``max_blocks`` blocks, each owning ``pb`` hidden units (the four gate
    columns of each, in both LSTM layers), ``jb`` columns of pred_proj and
    ``vb`` of the joint's output matrix. With ``tensor_cores`` (bf16 weights,
    whose tile products run as mma.sync, or the int8 LSTM, whose gates do)
    every block's column counts are multiples of 8, the tiles' width;
    otherwise even, so the FMA products keep the most blocks busy."""
    align = 8 if tensor_cores else 2
    pb = -(-d_pred // max_blocks)
    if tensor_cores:  # 4 pb gate columns, a multiple of 8
        pb += pb & 1
    blocks = -(-d_pred // pb)

    def aligned(n):
        return -(-n // align) * align
    return (blocks, pb, aligned(-(-d_joint // blocks)),
            aligned(-(-vocab // blocks)))


def pack_columns(w: torch.Tensor, blocks: int, width: int,
                 groups: int = 1) -> torch.Tensor:
    """``[K, groups * N]`` -> ``[blocks, K, groups * width]``: block g gets
    columns ``q * N + g * width + u`` (``u < width``) of each of the
    ``groups`` column groups, zeros past N. A vector ``[groups * N]`` packs
    to ``[blocks, groups * width]``."""
    vec = w.dim() == 1
    if vec:
        w = w[None]
    k, n = w.shape[0], w.shape[1] // groups
    out = w.new_zeros((k, groups, blocks * width))
    out[:, :, :n] = w.reshape(k, groups, n)
    out = (out.reshape(k, groups, blocks, width).permute(2, 0, 1, 3)
           .reshape(blocks, k, groups * width).contiguous())
    return out[:, 0] if vec else out


def copy_into_(dst, src) -> None:
    """``src``'s values into ``dst``'s tensors in place, through dicts of
    them; a tensor that shares ``src``'s memory (both alias one parameter)
    is left as it is."""
    if isinstance(dst, dict):
        for key, value in dst.items():
            copy_into_(value, src[key])
    elif dst is not None and dst.data_ptr() != src.data_ptr():
        dst.copy_(src)


def refresh_tables_(old, new) -> None:
    """The fields of ``new`` (the same tables recomputed from new weights)
    copied into those of ``old``, and every grid's block slices ``old`` has
    made, from ``new``'s slices of the same grid. Call it in inference
    mode: the slices are made in it."""
    for f in dataclasses.fields(old):
        copy_into_(getattr(old, f.name), getattr(new, f.name))
    for key, slices in old.__dict__.get("_block_slices", {}).items():
        copy_into_(slices, new.block_slices(*key))


@dataclasses.dataclass
class JointWeights:
    """The joint's weights as the decode kernels read them: matrices in the
    working type, biases in f32. The step kernel (``decode_step``) reads
    these alone, so it serves any prediction-net depth."""

    wp: torch.Tensor      # [P, J]
    bp: torch.Tensor      # [J] f32
    wo: torch.Tensor      # [J, V]
    bo: torch.Tensor      # [V] f32

    def block_slices(self, blocks: int, jb: int, vb: int
                     ) -> Dict[str, torch.Tensor]:
        """pred_proj's and the output matrix's columns packed per block for
        the kernels' grid (:func:`slice_plan`), made once per grid and
        kept: ``wps``, ``bps``, ``wos``, ``bos``."""
        key = (blocks, jb, vb)
        cache = self.__dict__.setdefault("_block_slices", {})
        if key not in cache:
            cache[key] = {"wps": pack_columns(self.wp, blocks, jb),
                          "bps": pack_columns(self.bp, blocks, jb),
                          "wos": pack_columns(self.wo, blocks, vb),
                          "bos": pack_columns(self.bo, blocks, vb)}
        return cache[key]

    def step_scratch(self, n_bytes: int, rows: int) -> torch.Tensor:
        """The step kernel's scratch for ``rows`` rows, zeroed once and
        kept: each launch leaves it as it found it."""
        cache = self.__dict__.setdefault("_step_scratch", {})
        if rows not in cache:
            cache[rows] = torch.zeros((n_bytes,), dtype=torch.uint8,
                                      device=self.wo.device)
        return cache[rows]

    def refresh_(self, new: "JointWeights") -> None:
        """``new``'s tables (the same weights recomputed) copied into these
        in place, with the block slices made so far; the addresses do not
        change (:func:`refresh_tables_`)."""
        refresh_tables_(self, new)

    @classmethod
    def from_model(cls, model, dtype: torch.dtype) -> "JointWeights":
        joint = model.joint
        return cls(wp=joint.pred_proj.w.detach().to(dtype).contiguous(),
                   bp=joint.pred_proj.b.detach().float().contiguous(),
                   wo=joint.out.w.detach().to(dtype).contiguous(),
                   bo=joint.out.b.detach().float().contiguous())

    @property
    def dtype(self) -> torch.dtype:
        return self.wo.dtype


@dataclasses.dataclass
class DecodeWeights:
    """Prediction-net and joint weights as the loop reads them: matrices in
    the working type, biases in f32 (the reference's layouts)."""

    embed: torch.Tensor   # [V, E]
    w0: torch.Tensor      # [E + P, 4P]
    b0: torch.Tensor      # [4P] f32
    w1: torch.Tensor      # [2P, 4P]
    b1: torch.Tensor      # [4P] f32
    wp: torch.Tensor      # [P, J]
    bp: torch.Tensor      # [J] f32
    wo: torch.Tensor      # [J, V]
    bo: torch.Tensor      # [V] f32
    # int8 branch: quantize_pred_lstm's output, and its four halves packed
    # for the kernels (pack_rows4), keyed "wx0", "wh0", "wx1", "wh1"
    quant: Optional[Dict[str, torch.Tensor]] = None
    quant_words: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def from_model(cls, model, dtype: torch.dtype) -> "DecodeWeights":
        pred, joint = model.predictor, model.joint
        if len(pred.lstm) != 2:
            raise NotImplementedError(
                "the decode-loop kernel supports 2-layer prediction nets "
                f"only, got {len(pred.lstm)}")

        def mat(p):
            return p.detach().to(dtype).contiguous()

        def vec(p):
            return p.detach().float().contiguous()

        l0, l1 = pred.lstm
        return cls(embed=mat(pred.embed), w0=mat(l0.w), b0=vec(l0.b),
                   w1=mat(l1.w), b1=vec(l1.b), wp=mat(joint.pred_proj.w),
                   bp=vec(joint.pred_proj.b), wo=mat(joint.out.w),
                   bo=vec(joint.out.b))

    def with_int8_lstm(self) -> "DecodeWeights":
        """These weights with the LSTM quantized for the int8 branch, from
        the served (already cast) matrices, as the reference quantizes its
        cast params once at pipeline build."""
        q = quantize_pred_lstm([self.w0, self.w1])
        return dataclasses.replace(
            self, quant=q,
            quant_words={k: pack_rows4(q[f"{k}_q"]) for k in INT8_KEYS})

    def block_slices(self, blocks: int, pb: int, jb: int, vb: int
                     ) -> Dict[str, torch.Tensor]:
        """The weights packed per block for the decode kernel's grid
        (:func:`slice_plan`), made once per grid and kept; the joint's are
        :attr:`joint`'s own. The int8 layers' words hold each half padded by
        :func:`pad_words`, the x half's first."""
        key = (blocks, pb, jb, vb)
        cache = self.__dict__.setdefault("_block_slices", {})
        if key not in cache:
            gates = dict(blocks=blocks, width=pb, groups=4)
            out = {"w0s": pack_columns(self.w0, **gates),
                   "b0s": pack_columns(self.b0, **gates),
                   "w1s": pack_columns(self.w1, **gates),
                   "b1s": pack_columns(self.b1, **gates),
                   **self.joint.block_slices(blocks, jb, vb)}
            if self.quant is not None:
                w = {k: pad_words(v) for k, v in self.quant_words.items()}
                out["wq0s"] = pack_columns(torch.cat([w["wx0"], w["wh0"]]),
                                           **gates)
                out["wq1s"] = pack_columns(torch.cat([w["wx1"], w["wh1"]]),
                                           **gates)
                for name in ("sx0", "sh0", "sx1", "sh1"):
                    out[name + "s"] = pack_columns(self.quant[name], **gates)
            cache[key] = out
        return cache[key]

    def refresh_(self, new: "DecodeWeights") -> None:
        """``new``'s tables (the same weights recomputed, int8 halves
        included) copied into these in place: the fields, the block slices
        made so far and :attr:`joint`'s; the addresses do not change."""
        refresh_tables_(self, new)
        if "_joint" in self.__dict__:
            self.joint.refresh_(new.joint)

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    @property
    def joint(self) -> JointWeights:
        """The joint alone (made once, so its block slices are kept)."""
        if "_joint" not in self.__dict__:
            self.__dict__["_joint"] = JointWeights(wp=self.wp, bp=self.bp,
                                                   wo=self.wo, bo=self.bo)
        return self.__dict__["_joint"]

    def check(self, what: str, device: torch.device) -> None:
        """Raise unless every weight is what the kernel ``what`` reads."""
        v, e = self.embed.shape
        p = self.w0.shape[1] // 4
        j = self.wp.shape[1]
        for name, shape in (("embed", (v, e)), ("w0", (e + p, 4 * p)),
                            ("w1", (2 * p, 4 * p)), ("wp", (p, j)),
                            ("wo", (j, v))):
            check_tensor(what, name, getattr(self, name), self.dtype, shape,
                         device)
        for name, n in (("b0", 4 * p), ("b1", 4 * p), ("bp", j), ("bo", v)):
            check_tensor(what, name, getattr(self, name), torch.float32, (n,),
                         device)
        if self.quant is None:
            return
        for key, rows in (("wx0", e), ("wh0", p), ("wx1", p), ("wh1", p)):
            if rows % 4:
                raise ValueError(f"{what}: int8 LSTM halves need rows in "
                                 f"fours, got {rows}")
            check_tensor(what, key, self.quant_words[key], torch.int32,
                         (rows // 4, 4 * p), device)
            scale = "s" + key[1:]
            check_tensor(what, scale, self.quant[scale], torch.float32,
                         (4 * p,), device)


def _cell(gates, c):
    """The LSTM cell in f32 from the gate pre-activations: (h, c)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _qdot(x32, wq, ws):
    """The TPU kernels' ``_qdot``: per-row activation quant, the int8
    product summed exactly (float64), ``acc * (s * ws)``."""
    s = quant_scale(x32.abs().amax(dim=1, keepdim=True))
    acc = (torch.round(x32 / s).double() @ wq).float()
    return acc * (s * ws)


def kernel_fns(weights: DecodeWeights, blank_id: int):
    """``(pred_fn, joint_fn)`` that round where the decode kernels round:
    the plain versions of both loop kernels are their decode functions
    given these. With ``weights.quant`` the LSTM is the int8 branch's."""
    dt = weights.dtype
    w0, w1 = weights.w0.float(), weights.w1.float()
    embed = weights.embed
    q = weights.quant
    if q is not None:
        qw = {k: q[f"{k}_q"].double() for k in INT8_KEYS}

    def pred_fn(tokens, state):
        h, c = state
        x = torch.where((tokens != blank_id)[:, None], embed[tokens.long()],
                        torch.zeros((), dtype=dt, device=embed.device))
        if q is None:
            h0n, c0n = _cell(torch.cat([x, h[0]], dim=-1).float() @ w0
                             + weights.b0, c[0])
            # layer 1 reads layer 0's h in the working type
            h1n, c1n = _cell(torch.cat([h0n.to(dt), h[1]], dim=-1).float()
                             @ w1 + weights.b1, c[1])
        else:
            h0n, c0n = _cell(_qdot(x.float(), qw["wx0"], q["sx0"])
                             + _qdot(h[0].float(), qw["wh0"], q["sh0"])
                             + weights.b0, c[0])
            # layer 1 reads layer 0's h unrounded (f32)
            h1n, c1n = _cell(_qdot(h0n, qw["wx1"], q["sx1"])
                             + _qdot(h[1].float(), qw["wh1"], q["sh1"])
                             + weights.b1, c[1])
        h0n, h1n, c0n, c1n = (v.to(dt) for v in (h0n, h1n, c0n, c1n))
        return h1n, (torch.stack([h0n, h1n]), torch.stack([c0n, c1n]))

    return pred_fn, joint_fn(weights.joint)


def joint_fn(weights: JointWeights):
    """The joint as the decode kernels round it: f32 accumulation, the
    hidden vector rounded to the working type before the output matrix."""
    dt = weights.dtype
    wp, wo = weights.wp.float(), weights.wo.float()

    def fn(enc_rows, pred_rows):
        p = pred_rows.float() @ wp + weights.bp
        hidden = torch.relu(enc_rows.float() + p).to(dt)
        return hidden.float() @ wo + weights.bo

    return fn


def greedy_loop_reference(enc_pre, enc_lens, h0, c0, pred0, last0,
                          token_offset, weights: DecodeWeights, *,
                          blank_id: int, max_symbols: int, max_total: int,
                          lookahead: int = 8) -> GreedyResult:
    """Plain PyTorch version of the kernel (same arguments, same result)."""
    pred_fn, joint_fn = kernel_fns(weights, blank_id)
    return greedy_decode(
        pred_fn, joint_fn, enc_pre, enc_lens, (h0, c0), blank_id,
        max_symbols=max_symbols, max_total=max_total,
        lookahead=min(lookahead, enc_pre.shape[1]), init_pred_out=pred0,
        init_last_token=last0, token_offset=token_offset)


def check_tensor(what, name, x, dtype, shape, device):
    """Raise unless ``x`` is what the kernel ``what`` reads."""
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f"{what}: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}, got {x.dtype} {tuple(x.shape)} on "
            f"{x.device}{'' if x.is_contiguous() else ' (non-contiguous)'}")


SLICES = ("w0s", "b0s", "w1s", "b1s", "wps", "bps", "wos", "bos")
INT8_SLICES = ("wq0s", "sx0s", "sh0s", "wq1s", "sx1s", "sh1s")


def grid_plan(weights, device: torch.device) -> Tuple[int, int, int, int]:
    """The kernels' grid on ``device`` for :class:`DecodeWeights` or
    :class:`JointWeights`: one block per SM, :func:`slice_plan` on the
    tensor cores for bf16 weights and for the int8 LSTM (whose gates run on
    the int8 tensor cores)."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    d_pred, d_joint = weights.wp.shape
    return slice_plan(d_pred, d_joint, weights.bo.shape[0], n_sm,
                      tensor_cores=(weights.dtype == torch.bfloat16
                                    or getattr(weights, "quant", None)
                                    is not None))


def loop_grid(weights: DecodeWeights, device: torch.device
              ) -> Tuple[Tuple[int, int, int, int], List[int],
                         List[Optional[int]]]:
    """The grid of both loop kernels (greedy and beam) on ``device``
    (:func:`grid_plan`), and the addresses of its per-block slices, as
    ``(plan, slice pointers, int8 slice pointers)``; the int8 ones are
    ``None`` without ``weights.quant``."""
    plan = grid_plan(weights, device)
    sl = weights.block_slices(*plan)
    return (plan, [sl[k].data_ptr() for k in SLICES],
            [sl[k].data_ptr() if weights.quant is not None else None
             for k in INT8_SLICES])


def greedy_loop(enc_pre: torch.Tensor, enc_lens: torch.Tensor,
                h0: torch.Tensor, c0: torch.Tensor, pred0: torch.Tensor,
                last0: torch.Tensor, token_offset: torch.Tensor,
                weights: DecodeWeights, *, blank_id: int, max_symbols: int,
                max_total: int, lookahead: int = 8) -> GreedyResult:
    """The whole greedy decode of ``enc_pre [B, T', J]`` (the joint's
    precomputed encoder projection) from carried state ``h0, c0 [2, B, P]``,
    ``pred0 [B, P]``, ``last0 [B]``; one kernel launch on CUDA, in the int8
    branch when ``weights.quant`` is set."""
    dev = enc_pre.device
    if dev.type == "cpu":
        return greedy_loop_reference(
            enc_pre, enc_lens, h0, c0, pred0, last0, token_offset, weights,
            blank_id=blank_id, max_symbols=max_symbols, max_total=max_total,
            lookahead=lookahead)
    if dev.type != "cuda":
        raise RuntimeError(f"greedy_loop: unsupported device {dev}")
    dt = weights.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"greedy_loop: working type {dt} not supported")
    b, t_max, _ = enc_pre.shape
    v, d_embed = weights.embed.shape
    d_pred, d_joint = weights.wp.shape
    ints = [x.to(device=dev, dtype=torch.int32).contiguous()
            for x in (enc_lens, last0, token_offset)]
    for name, x in (("enc_lens", ints[0]), ("last0", ints[1]),
                    ("token_offset", ints[2])):
        check_tensor("greedy_loop", name, x, torch.int32, (b,), dev)
    for name, x, shape in (("enc_pre", enc_pre, (b, t_max, d_joint)),
                           ("h0", h0, (2, b, d_pred)),
                           ("c0", c0, (2, b, d_pred)),
                           ("pred0", pred0, (b, d_pred))):
        check_tensor("greedy_loop", name, x, dt, shape, dev)
    weights.check("greedy_loop", dev)

    def new(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    tokens = new((b, max_total), torch.int32)
    counts = new((b,), torch.int32)
    frames = new((b, max_total), torch.int32)
    confs = new((b, max_total), torch.float32)
    h_out, c_out = new((2, b, d_pred), dt), new((2, b, d_pred), dt)
    pred_out, last_out = new((b, d_pred), dt), new((b,), torch.int32)
    plan, slices, quant = loop_grid(weights, dev)
    f = min(lookahead, t_max)
    lib = _build.library()
    scratch = new((lib.amira_greedy_loop_scratch_bytes(
        b, d_pred, d_joint, f, plan[0]),), torch.uint8)
    err = lib.amira_greedy_loop(
        int(dt == torch.bfloat16), int(weights.quant is not None), b, t_max,
        d_joint, d_pred, d_embed, v, max_total, f, blank_id, max_symbols,
        *plan, enc_pre.data_ptr(), ints[0].data_ptr(), h0.data_ptr(),
        c0.data_ptr(), pred0.data_ptr(), ints[1].data_ptr(),
        ints[2].data_ptr(), weights.embed.data_ptr(), *slices,
        *quant, tokens.data_ptr(), counts.data_ptr(), frames.data_ptr(),
        confs.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
        pred_out.data_ptr(), last_out.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "amira_greedy_loop")
    _build.count_launch(greedy_loop if weights.quant is None
                        else greedy_loop_int8)
    return GreedyResult(tokens=tokens, counts=counts, frame_idx=frames,
                        confidence=confs, state=(h_out, c_out),
                        pred_out=pred_out, last_token=last_out)


greedy_loop.launches = 0
greedy_loop_int8 = _build.LaunchCount()  # launches of the int8 branch
