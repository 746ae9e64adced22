"""The plain reference (``gpubench/reference``) against the port, on seeded
weights at the port's tiny widths on the CPU, in float32; the judge's path
search; the weights' layout against the port's model at full width; and,
on the card, the readings that the check's limits sit between, and a run
with the control in the program's place."""

import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import harness, sut, traffic, weights
from gpubench.reference import judge, model as ref

ROOT = Path(__file__).resolve().parents[2]


OFFLINE = "parakeet-0.6b-offline"


def _full(name: str) -> dict:
    """The configuration file; ``causal``: the same model made causal with
    left context 128 and served natively, for the stream path that a later
    cell will add."""
    cfg = json.loads((ROOT / f"gpubench/configs/{OFFLINE}.json").read_text())
    if name == "causal":
        cfg["model"].update(causal=True, att_context=[128, 0])
        cfg["serving"].update(streaming_mode="native",
                              native_chunk_frames=64, max_lanes=64,
                              max_concurrent_streams=64, native_norm="none")
    return cfg


def _config(name: str):
    cfg = _full(name)
    m = dict(cfg["model"], **harness.TINY)
    if m["causal"]:
        m["att_context"] = [8, 0]
    return cfg, m


def _system(name: str, seed: int = 3):
    cfg, m = _config(name)
    serving = dict(cfg["serving"], compute_dtype="float32",
                   batch_buckets=[1, 2])
    return sut.System(m, serving, seed, torch.device("cpu")), m


@pytest.mark.parametrize("name", [OFFLINE, "causal"])
def test_weight_layout_is_the_ports_state_dict(name):
    from amira_rust_asr_server_tpu_torch.models import Transducer
    cfg = _full(name)
    with torch.device("meta"):
        model = Transducer(sut.model_config(cfg["model"]))
    have = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {n: s for n, s, _, _ in weights.param_specs(cfg["model"])}
    assert have == want
    assert 580e6 < weights.count(cfg["model"]) < 620e6


def test_log_mel_and_encoder_match_the_port_offline():
    from amira_rust_asr_server_tpu_torch.ops.features import \
        log_mel_features
    system, m = _system(OFFLINE)
    W = ref.as_f32(weights.make_weights(m, 3, torch.device("cpu"),
                                        torch.float32))
    x = torch.as_tensor(traffic.stream_audio(5, 3.3, 1))
    n, nb = x.shape[0], system.bucket_len(x.shape[0])
    buf = torch.zeros(1, nb)
    buf[0, :n] = x
    feats, fl = log_mel_features(buf, torch.tensor([n]),
                                 n_mels=m["n_mels"])
    mine, valid = ref.log_mel(x, m["n_mels"], nb, True)
    assert valid == int(fl[0])
    assert torch.allclose(feats[0].T, mine, atol=2e-3)
    with torch.no_grad():
        enc, el = system.pipeline.model.encode(feats, fl)
    e_ref, lens = ref.encoder(feats[0].T.contiguous(), valid, W, m)
    assert lens == int(el[0])
    assert torch.allclose(enc[0, :lens], e_ref[:lens], atol=1e-4)


def test_causal_encoder_matches_the_ports_chunked_encoder():
    from amira_rust_asr_server_tpu_torch.ops.streaming import (
        encode_chunk, init_encoder_cache)
    system, m = _system("causal")
    W = ref.as_f32(weights.make_weights(m, 3, torch.device("cpu"),
                                        torch.float32))
    x = torch.as_tensor(traffic.stream_audio(5, 2.0, 2))
    feats, valid = ref.log_mel(x, m["n_mels"], None, False)
    e_ref, lens = ref.encoder(feats, valid, W, m)
    model = system.pipeline.model
    cache = init_encoder_cache(model.config, 1)
    chunk = 64
    pad = -(-valid // chunk) * chunk
    f = torch.zeros(1, m["n_mels"], pad)
    f[0, :, :valid] = feats.T
    outs = []
    with torch.no_grad():
        for i in range(0, pad, chunk):
            e, cache = encode_chunk(model.encoder, f[..., i:i + chunk],
                                    cache)
            outs.append(e[0])
    mine = torch.cat(outs)[:lens]
    assert torch.allclose(mine, e_ref[:lens], atol=1e-4)


def test_served_greedy_tokens_have_no_gap_in_float32():
    system, m = _system(OFFLINE, seed=4)
    spec = dict(traffic.load(ROOT / "gpubench/traffic/bulk32.json"), pool=4)
    system.warm(spec)
    system.bisect_blank_bias(spec)
    W = ref.as_f32(weights.make_weights(m, 4, torch.device("cpu"),
                                        torch.float32, system.blank_bias))
    total = 0
    for i in range(2):
        x = traffic.pool_audio(spec, 4, i)
        res = system.pipeline.decode_samples_batch([x])[0]
        toks = [int(t) for t in res.tokens[0, :int(res.counts[0])]]
        total += len(toks)
        out = judge.judge_one(x, toks, W, m, system.bucket_len(x.shape[0]),
                              True, system.config.max_total_tokens,
                              system.config.max_symbols_per_step,
                              control=True)
        assert out["gap"] == 0.0 and out["gap_sum"] == 0.0
    assert total > 0


def test_path_search_takes_forced_advances_and_the_budget():
    # 3 frames, 3 tokens: all three on frame 1 with max_symbols 3 (a
    # forced advance, no blank there), blanks elsewhere
    blank = np.full((3, 4), 5.0)
    emit = np.full((3, 3), 5.0)
    blank[0, 0] = 0.0
    emit[1, :] = 0.0
    blank[2, 3] = 0.0
    value, path = judge.widest_gap(blank, emit, max_symbols=3)
    assert value == 0.0
    assert path == [(0, 0, -1), (1, 0, 0), (1, 1, 1), (1, 2, 2),
                    (2, 3, -1)]
    # with a budget of 3 spent, the decode stops after its last token
    value, _ = judge.widest_gap(blank[:2], emit[:2], max_symbols=3,
                                budget_spent=True)
    assert value == 0.0
    # one wrong token costs its gap
    emit[1, 1] = 2.5
    assert judge.widest_gap(blank, emit, max_symbols=3)[0] == 2.5


CELL = "parakeet-0.6b-offline.bulk32"


@pytest.mark.card
def test_the_limits_sit_between_the_program_and_control_or_fault(card):
    """The calibration at the cell's size and load, a short window, three
    seeds: the program's mean gap under its limit and the float8
    control's over it; the program's widest gap under its limit and the
    least that one altered token gives over it."""
    check = json.loads((ROOT / f"gpubench/checks/{CELL}.json").read_text())
    p = subprocess.run(
        [sys.executable, "gpubench/calibrate.py", "--workload", CELL,
         "--seconds", "5", "--seeds", "2147483711,2147483712,2147483713",
         "--control", "3", "--fault", "3"], cwd=ROOT, capture_output=True,
        text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    rows = [json.loads(x) for x in p.stdout.splitlines() if '"seed"' in x]
    for r in rows:
        print(json.dumps({k: v for k, v in r.items() if k != "items"}))
    assert len(rows) == 3
    assert all(r["program"] <= check["max_mean_gap"] < r["control"]
               for r in rows)
    assert all(r["program_widest"] <= check["max_widest_gap"]
               < r["fault_least"] for r in rows)


@pytest.mark.card
def test_the_control_in_the_programs_place_is_not_correct(card,
                                                          monkeypatch):
    """A whole run of the cell (a short window) whose judged readings are
    the float8 control's, at the served decisions: the run's own
    comparison reads it as not correct."""
    judged = harness.judge_sample

    def control_in_place(*a, **kw):
        out = judged(*a, **dict(kw, control=True))
        for r in out:
            r["gap"], r["gap_sum"] = r["control_gap"], r["control_gap_sum"]
        return out

    monkeypatch.setattr(harness, "judge_sample", control_in_place)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = harness.main(["--workload", CELL, "--seed", "2147483721",
                           "--seconds", "5", "--trace", "0"])
    assert rc == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(json.dumps(out["checks"]))
    assert out["correct"] is False
    assert out["checks"]["mean_gap"]["value"] > \
        out["checks"]["mean_gap"]["limit"]
