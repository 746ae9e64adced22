"""CPU tests of the AED family's files (``families/aed.py``,
``reference/aed.py``, ``roofline_aed.py``, ``readers_aed.py`` and the
cell ``canary-1b-flash.bulk32``): the cell's rehearsal is correct, and not
with one served token altered; the benchmark's reference gives the port's
test reference's logits on the same seeded weights, which the port's model
loads under its own names; the decode loop's counts against a hand count;
the readers with and without the port's ``aed`` counters."""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpubench import families, harness, roofline, roofline_aed, sut, weights
from gpubench import readers_aed
from gpubench.reference import aed

ROOT = Path(__file__).resolve().parents[2]
CELL = "canary-1b-flash.bulk32"
CONFIG = json.loads((ROOT / "gpubench/configs/canary-1b-flash.json")
                    .read_text())
FAMILY = families.of(CONFIG)
TINY_M = dict(CONFIG["model"], **harness.TINY_ENCODER, **FAMILY.TINY)


def _run(args, script, cwd=ROOT, timeout=600):
    """``script`` in a process of its own, on two threads: the rehearsal's
    200-step decode loops slow down many times over when its threads
    share the cores with other test processes'."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, str(script), *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


# runs harness.main with one served token of each transcript altered by
# the family's ``altered``
ALTERED_RUN = """import sys
sys.path.insert(0, ".")
from amira_rust_asr_server_tpu_torch.runtime.pipeline import AsrPipeline
from gpubench import families, harness
served = AsrPipeline._to_transcription
family = families.load("aed")


def one_altered(self, res, lane, *a):
    tr = served(self, res, lane, *a)
    if tr.tokens:
        cfg = self.model.config
        tr.tokens = family.altered(tr.tokens, {
            "vocab_size": cfg.vocab_size, "blank_id": cfg.blank_id})
    return tr


AsrPipeline._to_transcription = one_altered
sys.exit(harness.main(sys.argv[1:]))
"""


def test_the_cells_rehearsal_is_correct_and_not_with_a_token_altered(
        tmp_path):
    # a window of 8 s: a loaded host's CPU takes seconds a dispatch, and
    # the readers need dispatches that end inside the window
    args = ["--workload", CELL, "--seed", str(2 ** 31 + 123), "--seconds",
            "8", "--trace", "1", "--rehearse-cpu"]
    p = _run(args, ROOT / "gpubench/run.py")
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["checks"]["checked"]["value"] > 0
    # the stages are timed on a card only, and there is no device trace
    for name in ("aed_encode_ms.bulk", "aed_decode_ms.bulk",
                 "aed_loop_roofline.bulk", "aed_mfu.bulk"):
        assert name not in out["metrics"], name
    assert 0 < out["metrics"]["aed_live_share.bulk"]["value"] <= 100
    script = tmp_path / "altered_run.py"
    script.write_text(ALTERED_RUN)
    p = _run(args, script)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is False
    assert out["checks"]["widest_gap"]["value"] > \
        out["checks"]["widest_gap"]["limit"]


def test_the_layout_is_the_ports_state_dict():
    from amira_rust_asr_server_tpu_torch.models.aed import AEDModel
    m = CONFIG["model"]
    with torch.device("meta"):
        model = AEDModel(sut.model_config(m))
    have = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    specs = weights.param_specs(m, FAMILY)
    assert have == {n: s for n, s, _, _ in specs}
    enc = weights.encoder_specs(m)
    assert specs[:len(enc)] == enc
    assert weights.count(m, FAMILY) == CONFIG["params"] == \
        model.param_count()
    assert FAMILY.emission_bias(m) == ("decoder.out.b", 3)
    assert set(FAMILY.vocabulary(m)) == set(range(5248)) - {3}
    assert model.prompt == tuple(m["dec_prompt"])


def test_the_benchmarks_reference_gives_the_test_references_logits():
    """On the same seeded weights (the benchmark's draw, loaded strictly
    into the port's model too): ``reference/aed.py`` and the port's
    ``testing/aed_reference.py`` give the same logits, and so does the
    port's teacher-forced decoder."""
    from amira_rust_asr_server_tpu_torch.models.aed import AEDModel
    from amira_rust_asr_server_tpu_torch.testing import aed_reference
    m = TINY_M
    W = weights.make_weights(m, 2 ** 31 + 5, torch.device("cpu"),
                             torch.float32, 1.0, FAMILY)
    enc = torch.randn(17, m["d_enc"], generator=torch.Generator()
                      .manual_seed(3))
    ids = aed.prompt(m) + [5, 9, 9, 30, 1]
    got = aed.decoder_logits(ids, enc, W, m)
    want = aed_reference.decoder_logits(W, ids, enc, m["dec_heads"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    model = AEDModel(sut.model_config(m))
    model.load_state_dict(W, strict=True)
    with torch.inference_mode():
        port = model.decoder_logits(torch.tensor([ids]), enc[None],
                                    torch.tensor([17]))[0]
    np.testing.assert_allclose(port.numpy(), want.numpy(), atol=1e-5,
                               rtol=0)
    # the control reads on the same ids, in float8 operands
    fp8 = aed.decoder_logits(ids, enc, W, m, "fp8")
    assert fp8.shape == got.shape and not torch.equal(fp8, got)


def _reference_greedy(m, bias, x, max_len):
    """Weights of seed 7 with EOS's bias ``bias``, and the reference's own
    greedy tokens of ``x`` (padded to 1 s): (W, tokens, ended on EOS)."""
    from gpubench.reference import model as ref
    W = weights.make_weights(m, 7, torch.device("cpu"), torch.float32, bias,
                             FAMILY)
    feats, valid = ref.log_mel(torch.from_numpy(x), m["n_mels"], 16000,
                               True)
    enc, lens = ref.encoder(feats, valid, W, m)
    ids, toks = aed.prompt(m), []
    for _ in range(max_len):
        nxt = int(aed.decoder_logits(ids, enc[:lens], W, m)[-1].argmax())
        if nxt == m["blank_id"]:
            return W, toks, True
        toks.append(nxt)
        ids.append(nxt)
    return W, toks, False


def test_the_judge_reads_each_decision_and_eos_last():
    """The reference's own greedy tokens have no gap: EOS is judged after
    the last token, unless the decode spent ``max_len`` steps; the control
    reads on the same decisions; one altered token opens a gap."""
    m = TINY_M
    x = (0.2 * np.random.default_rng(4).standard_normal(12000)).astype(
        np.float32)
    W, toks, ended = _reference_greedy(m, -0.25, x, 12)
    assert ended and toks
    out = aed.judge_one(x, toks, W, m, 16000, max_len=12, control=True)
    assert out["gap"] == 0.0 and out["gap_sum"] == 0.0
    assert out["decisions"] == len(toks) + 1  # EOS judged last
    assert out["control_gap"] >= 0.0 and "control_gap_sum" in out
    W, toks, ended = _reference_greedy(m, -0.5, x, 12)
    assert not ended and len(toks) == 12
    spent = aed.judge_one(x, toks, W, m, 16000, max_len=12)
    assert spent["decisions"] == 12 and spent["gap"] == 0.0
    bad = aed.judge_one(x, FAMILY.altered(toks, m), W, m, 16000, max_len=12)
    assert bad["gap"] > 0.1


def test_the_loop_work_is_the_hand_count():
    """One layer, d 4, 10 outputs, d_enc 6, a prompt of 2; one lane of 3
    encoder frames that emitted 1 token, max_len 5: 2 live decisions (the
    token and EOS), so the prompt's 2 positions and 1 step."""
    m = {"d_dec": 4, "d_enc": 6, "vocab_size": 10, "dec_layers": 1,
         "dec_prompt": [7, 8]}
    ops, n_bytes = roofline_aed.loop_work(m, [(3, 1)], max_len=5)
    # operations: the cross K/V projection 2 x 2 x 3 x 6 x 4 = 288; three
    # positions of dense products 3 x 2 x 14 x 16 = 1344 and of
    # cross-attention 3 x 4 x 4 x 3 = 144; self-attention over 1 + 2 + 3
    # keys: 4 x 4 x 6 = 96; the output at 2 decisions: 2 x 2 x 4 x 10 = 160
    assert ops == {"bf16": 288.0 + 1344 + 144 + 96 + 160}
    # bytes (bf16): cross wk, wv 2 x 6 x 4; the encoder rows 3 x 6, the
    # cross K/V written 2 x 3 x 4 and read on 2 passes 2 x 2 x 3 x 4; self
    # K/V read (the prefill 2, the step at position 2: 3) and written (3)
    # 2 x 4 x (5 + 3); embedding rows 3 x 4; the weights on 2 passes:
    # 14 x 16 + 4 x 10, three norms and the feed-forward's biases 3 x 2 x 4
    # + 4 x 4 + 4, the last norm 2 x 4 and the output bias 10
    weights_pass = 14 * 16 + 4 * 10 + 3 * 2 * 4 + 4 * 4 + 4 + 2 * 4 + 10
    assert n_bytes == 2.0 * (2 * 6 * 4 + 3 * 6 + 2 * 3 * 4 + 2 * 2 * 3 * 4
                             + 2 * 4 * (5 + 3) + 3 * 4 + 2 * weights_pass)
    # a lane that spent the budget is live on every step; dead lanes and
    # padding add nothing
    assert roofline_aed.live_steps(200, 200) == 200
    assert roofline_aed.live_steps(0, 200) == 1


def test_the_encoder_count_has_no_joint_projection():
    m = dict(CONFIG["model"])
    t = 376
    with_joint = roofline.encoder_flops(dict(m, d_joint=640), 3001, t)
    assert roofline_aed.encoder_flops(m, 3001, t) == \
        with_joint - 2.0 * t * m["d_enc"] * 640


def _ctx(start, end, dispatches=(), trace=None):
    return {"t0": 0.0, "t1": 10.0, "m": CONFIG["model"],
            "counters": {"start": start, "end": end},
            "spans": SimpleNamespace(dispatches=list(dispatches)),
            "trace": trace, "records": []}


def test_the_readers_read_the_aed_counters_and_none_without_them():
    from gpubench.harness import load_reader
    zero = {"dispatches": 0, "lanes_total": 0, "steps_total": 0,
            "lane_steps_total": 0, "live_lane_steps_total": 0,
            "prompt_tokens_total": 0, "encode_device_s_total": 0.0,
            "decode_device_s_total": 0.0}
    end = {"dispatches": 2, "lanes_total": 3, "steps_total": 400,
           "lane_steps_total": 600, "live_lane_steps_total": 150,
           "prompt_tokens_total": 27, "encode_device_s_total": 0.08,
           "decode_device_s_total": 0.2}
    recs = [{"t0": 1.0, "t1": 1.2, "samples": [480000, 32000],
             "tokens": [100, 40], "enc": [376, 26]},
            {"t0": 2.0, "t1": 2.1, "samples": [160000], "tokens": [7],
             "enc": [126]},
            {"t0": 11.0, "t1": 11.1, "samples": [1], "tokens": [1],
             "enc": [1]}]  # after the window
    ctx = _ctx({"aed": zero}, {"aed": end}, recs,
               trace={"p0": 0.5, "p1": 2.5})
    read = {n: load_reader("layer_metrics", n)(ctx) for n in (
        "aed_encode_ms.bulk", "aed_decode_ms.bulk", "aed_live_share.bulk",
        "aed_loop_roofline.bulk", "aed_mfu.bulk")}
    assert read["aed_encode_ms.bulk"] == pytest.approx(40.0)
    assert read["aed_decode_ms.bulk"] == pytest.approx(100.0)
    assert read["aed_live_share.bulk"] == pytest.approx(25.0)
    need = sum(roofline_aed.bound_s(b, o) for o, b in (
        roofline_aed.loop_work(CONFIG["model"], [(376, 100), (26, 40)], 200),
        roofline_aed.loop_work(CONFIG["model"], [(126, 7)], 200)))
    assert read["aed_loop_roofline.bulk"] == pytest.approx(need / 0.2 * 100)
    flops = sum(roofline_aed.model_flops(CONFIG["model"], r, 200)
                for r in recs[:2])
    assert read["aed_mfu.bulk"] == pytest.approx(
        flops / 2.0 / roofline.PEAK_OPS["bf16"] * 100)
    assert readers_aed.max_len(ctx) == 200
    # a run on the CPU counts dispatches but times no stage on a card
    cpu = {"aed": dict(end, encode_device_s_total=0.0,
                       decode_device_s_total=0.0)}
    off = _ctx({"aed": zero}, cpu, recs)
    for n in ("aed_encode_ms.bulk", "aed_decode_ms.bulk",
              "aed_loop_roofline.bulk"):
        assert load_reader("layer_metrics", n)(off) is None, n
    assert load_reader("layer_metrics", "aed_live_share.bulk")(off) == \
        pytest.approx(25.0)
    # a port without the counters (the parent): every reader gives None
    bare = _ctx({"batcher": {}}, {"batcher": {}}, recs,
                trace={"p0": 0.5, "p1": 2.5})
    for n in read:
        assert load_reader("layer_metrics", n)(bare) is None, n
