"""The plain references against the port's CPU paths at small sizes, and
the traffic generator's determinism."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.reference import dnsmos as ref_dnsmos
from portbench.reference import hubert as ref_hubert
from portbench.systems import dnsmos, speechbertscore

ROOT = Path(__file__).resolve().parents[2]
#: a log-normal ragged mix: 256 lengths, median 3 s, 1-15 s, 8 pairs a call
LOGNORMAL = {"pairs_per_call": 8, "form": "list", "pool_calls": 32, "sample_rate": 16000, "snr_db": [-5.0, 25.0],
             "trace_calls": 16, "lengths": {"kind": "lognormal_quantiles", "median_s": 3.0, "sigma": 0.5,
                                            "min_s": 1.0, "max_s": 15.0, "layout_seed": 0}}
TINY_HUBERT = {
    "hidden_size": 32, "num_hidden_layers": 3, "num_attention_heads": 4, "intermediate_size": 64,
    "conv_dim": [16, 16], "conv_kernel": [10, 3], "conv_stride": [5, 2], "conv_bias": False,
    "feat_extract_norm": "group", "feat_proj_layer_norm": True, "num_conv_pos_embeddings": 8,
    "num_conv_pos_embedding_groups": 4, "conv_pos_batch_norm": True, "do_stable_layer_norm": False,
    "layer_norm_eps": 1e-5,
}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(4)


def _tiny_sbs_config():
    return {"model": TINY_HUBERT, "output_layer": 2, "metric_kwargs": {"precision": "highest"},
            "controls": {"act_bf16": {"act_dtype": "bfloat16"}}}


def test_hubert_reference_features_match_the_port_feature_encoder():
    from fast_speech_enhancement_metrics_tpu_torch.models.hubert import feature_encoder

    config = _tiny_sbs_config()
    weights = speechbertscore.make_weights(config, 6, torch.device("cpu"))
    metric = speechbertscore.build_metric(config, weights, torch.device("cpu"), None)
    clean, _ = traffic.synth_pairs(torch.Generator().manual_seed(2), (4000, 4000), 16000, (-5.0, 25.0))
    ref = speechbertscore.Reference(config, weights, torch.device("cpu"))
    with torch.inference_mode():
        got = feature_encoder(metric.encoder, clean)
    for row in range(2):
        want = ref.captured(clean[row])
        assert want.shape == got[row].shape
        assert torch.allclose(got[row], want, atol=2e-6 * float(want.abs().max()))


def test_hubert_reference_matches_the_port_cpu_path():
    from fast_speech_enhancement_metrics_tpu_torch.models.hubert import hubert_hidden_state

    config = _tiny_sbs_config()
    weights = speechbertscore.make_weights(config, 5, torch.device("cpu"))
    metric = speechbertscore.build_metric(config, weights, torch.device("cpu"), None)
    gen = torch.Generator().manual_seed(0)
    clean, noisy = traffic.synth_pairs(gen, (4000, 4000, 4000), 16000, (-5.0, 25.0))
    params = ref_hubert.on_device(weights, torch.device("cpu"))
    with torch.inference_mode():
        want = ref_hubert.hidden_state(params, TINY_HUBERT, torch.cat([clean, noisy]), 2)
        got = hubert_hidden_state(metric.encoder, torch.cat([clean, noisy]), output_layer=2, attention_impl="einsum")
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)
    ref = speechbertscore.Reference(config, weights, torch.device("cpu"))
    want_f1 = [s["SpeechBERTScore"] for s in ref.scores(clean.numpy(), noisy.numpy())]
    got_f1 = [s["SpeechBERTScore"] for s in metric(clean.numpy(), noisy.numpy())]
    assert np.allclose(got_f1, want_f1, atol=1e-5)
    assert max(want_f1) < 0.9999  # the pairs are told apart


def test_dnsmos_reference_matches_the_port_cpu_path():
    config = json.loads((ROOT / "portbench/configs/dnsmos-p835.json").read_text())
    path = dnsmos.make_weights(config, 0, torch.device("cpu"))
    metric = dnsmos.build_metric(config, path, torch.device("cpu"), None)
    gen = torch.Generator().manual_seed(1)
    lengths = (16000, 152000)  # tiled to 16 s (7 windows); 9.5 s (1 window)
    clean, noisy = traffic.synth_pairs(gen, lengths, 16000, (-5.0, 25.0))
    clips = [noisy[i, :n].numpy().copy() for i, n in enumerate(lengths)]
    got = metric([c[:1] * 0 + c for c in clips], clips)
    ref = dnsmos.Reference(config, path, torch.device("cpu"))
    want = ref.scores(None, clips)
    for g, w in zip(got, want):
        for key in ("SIG", "BAK", "OVRL"):
            assert g[key] == pytest.approx(w[key], abs=2e-5)


def test_dnsmos_reference_windows():
    """Every 9.01 s window that fits, at exact 1 s hops, after doubling."""
    assert ref_dnsmos.tile(torch.zeros(16000)).shape[0] == 256000
    assert ref_dnsmos.tile(torch.zeros(160160)).unfold(0, ref_dnsmos.WINDOW, ref_dnsmos.HOP).shape[0] == 2


def test_traffic_is_deterministic_per_seed():
    cell_traffic = dict(LOGNORMAL, pool_calls=3, pairs_per_call=2)
    cell_traffic["lengths"] = dict(LOGNORMAL["lengths"], median_s=0.5, min_s=0.2, max_s=1.0)
    a = traffic.make_pool(cell_traffic, 2**31 + 3, torch.device("cpu"))
    b = traffic.make_pool(cell_traffic, 2**31 + 3, torch.device("cpu"))
    c = traffic.make_pool(cell_traffic, 2**31 + 4, torch.device("cpu"))
    assert a.order == b.order
    for x, y in zip(a.calls, b.calls):
        assert x.lengths == y.lengths
        assert all(np.array_equal(u, v) for u, v in zip(x.denoised + x.clean, y.denoised + y.clean))
    # another seed: the same calls of the same lengths, other audio
    assert [x.lengths for x in a.calls] == [x.lengths for x in c.calls]
    assert not np.array_equal(a.calls[0].denoised[0], c.calls[0].denoised[0])
    for call in a.calls:
        assert all(d.dtype == np.float32 and d.ndim == 1 and len(d) == n for d, n in zip(call.denoised, call.lengths))
        assert all(0.0 < np.abs(s).max() <= 0.9 + 1e-6 for s in call.clean)


def test_ragged_lengths_are_the_same_for_every_seed_and_almost_never_repeat():
    t = LOGNORMAL
    calls = traffic.call_lengths(t)
    flat = [n for call in calls for n in call]
    assert len(calls) == t["pool_calls"] and all(len(c) == t["pairs_per_call"] for c in calls)
    assert 16000 <= min(flat) and max(flat) <= 15 * 16000
    assert len(set(flat)) > 0.95 * len(flat)
    assert 2.8 < float(np.median(flat)) / 16000 < 3.2


def test_listed_lengths_are_dealt_as_listed():
    listed = list(range(16000, 16000 + 256 * 7, 7))
    t = dict(LOGNORMAL, lengths={"kind": "listed", "samples": listed, "layout_seed": 0})
    calls = traffic.call_lengths(t)
    assert sorted(n for call in calls for n in call) == listed
    assert calls == traffic.call_lengths(t) and calls[0] != tuple(listed[:8])
    with pytest.raises(ValueError, match="listed lengths"):
        traffic.call_lengths(dict(t, pool_calls=31))
    fixed = json.loads((ROOT / "portbench/traffic/eval64x16s.json").read_text())
    assert traffic.call_lengths(fixed) == [(256000,) * 64] * fixed["pool_calls"]
