"""The port's spans and counters, at its layer boundaries.

A span is a ``torch.profiler.record_function`` range, opened only while a
``torch.profiler`` session records; otherwise ``span`` hands back one shared
no-op context, and the cost is one check of the profiler's state. No
switch, keyword or environment variable turns them on: an operator's own
``torch.profiler.profile(...)`` does (not in its warm-up steps). A span lands
in the profiler's trace as a ``user_annotation`` event on the clock of the
CUDA kernels and copies, so each device operation, and each idle gap, can be
put down to the span open on the host when it was launched.

Spans (every name starts with ``fsem.``), by layer, each with where it is
opened and the benchmark metric (``portbench/readers/``) that reads it:

* entry: ``fsem.entry``, ``base.py::BaseMetric.compute`` around
  ``prepare_inputs`` (coercion and both copies; ``entry_ms``);
  ``fsem.exit``, ``BaseMetric._to_host`` (the stack, the one device->host
  copy, the dicts; for operators: its host time holds the wait for the
  device's queued work, which that copy syncs on).
* metric graph: ``fsem.ragged_group``, each length group of
  ``BaseMetric.compute_ragged`` (for operators).
* model, SpeechBERTScore (``models/hubert.py``):
  ``fsem.hubert.conv_encoder``, the body of ``feature_encoder``
  (``conv_encoder_ms``); ``fsem.hubert.pos_conv``, ``hubert_hidden_state``
  from the feature projection through the encoder LayerNorm before layer 0
  (``pos_conv_ms``); ``fsem.hubert.layer``, each ``_encoder_layer`` call
  (``encoder_layers_ms``); ``fsem.hubert.relpos_attn``,
  each WavLM layer's gated relative-position attention: on the kernel route
  the ``relpos_attn`` launch (its gate logits come out of the QKV product
  before it), on the plain route the gate, the bias and the attention
  (``relpos_attn_ms``).
* model, DNSMOS (``models/dnsmos_net.py``): ``fsem.dnsmos.features``, the
  body of ``_log_power_features`` (``dnsmos_features_ms``);
  ``fsem.dnsmos.trunk``, the conv stack on the whole signal with pool 3 and
  conv 6 on its two phases, or ``dnsmos_net``'s stack
  (``dnsmos_trunk_ms``); ``fsem.dnsmos.edges``, both edge strips of
  ``dnsmos_net_windowed_exact`` through the stack (``dnsmos_edges_ms``).

Counters:

* ``counts["h2d_bytes"]`` (entry; ``h2d_mib_per_call``): bytes of the rows
  that ``base.py::BaseMetric.prepare_audio`` copies from the host to a CUDA
  device. Counted under the spans' gate, so it covers exactly the recorded
  calls.
* ``counts["relpos_bias_bytes"]`` (model; ``relpos_bias_mib_per_call``):
  bytes of WavLM's gated position bias built as a tensor, rows x heads x
  queries x keys, by the plain paths (``ops/relpos_attention.py``); the
  kernel route adds 0 for each layer, since the kernel builds none.
* ``launch_counts`` (kernels): launches per hand-written kernel, one added by
  ``ops/cuda_lib.py::launch`` for each launch that returns without error,
  under the name the wrapper gives; always on (``chip_smoke.py``, the card
  tests and ``benchmarking/`` read it, also as ``cuda_lib.launch_counts``).
"""

from __future__ import annotations

import collections
import contextlib

import torch

_OFF = contextlib.nullcontext()

#: counts taken while a profiler records, by name
counts: collections.Counter = collections.Counter()

#: launches per kernel; ``ops/cuda_lib.py::launch`` adds one for each
launch_counts: collections.Counter = collections.Counter()


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else a no-op context."""
    return torch.profiler.record_function(name) if torch.autograd._profiler_enabled() else _OFF


def count(name: str, n: int) -> None:
    """Add ``n`` to ``counts[name]`` while a profiler records."""
    if torch.autograd._profiler_enabled():
        counts[name] += n
