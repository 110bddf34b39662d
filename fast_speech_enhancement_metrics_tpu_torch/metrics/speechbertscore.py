"""SpeechBERTScore: semantic similarity of mHuBERT-147 embeddings.

Counterpart of the JAX package's ``metrics/speechbertscore.py``. Per pair,
the layer-8 hidden states of clean and denoised audio; the cosine
similarity matrix's row-max mean (precision), column-max mean (recall),
and their harmonic mean (F1). Clean and denoised ride one doubled batch
through the encoder (``models/hubert.py``), which runs only the layers
that matter; the F1 of the whole batch is one batched product.

On a CUDA device "auto" follows the JAX package's rule: clips of 1500
frames (30 s) and more, or chunks whose logits would pass 4 GB, take the
attention kernel A9 (``sdpa``; bf16 at the default precision, float32 at
``"highest"``), and past 40 000 frames A15 (``flash``); shorter clips at
the default precision run each post-LN layer on kernels A7 (attention
block) and A8 (FFN block), and ``precision="highest"`` the plain float32
tensor path. The kernels take heads of up to 128. Weights load from a
converted ``.npz`` (``utils/convert_hubert.py``); there is no hub download.
"""

from __future__ import annotations

from pathlib import Path

import torch

from fast_speech_enhancement_metrics_tpu_torch.base import BaseMetric
from fast_speech_enhancement_metrics_tpu_torch.models.hubert import (
    ATTENTION_IMPLS,
    MHUBERT_147_CONFIG,
    HubertConfig,
    HubertEncoder,
    from_jax_params,
    hubert_hidden_state,
)
from fast_speech_enhancement_metrics_tpu_torch.ops.attention_core import MAX_HEAD_DIM
from fast_speech_enhancement_metrics_tpu_torch.parallel.mesh import axis_size
from fast_speech_enhancement_metrics_tpu_torch.parallel.sharding import shard_params

DEFAULT_CHECKPOINT = Path(__file__).parent.parent / "checkpoints" / "mhubert147.npz"
#: past this many frames "auto" takes the flash kernel instead of sdpa
SDPA_MAX_FRAMES = 40000


class SpeechBERTScore(BaseMetric):
    higher_is_better = True
    EXPECTED_SAMPLING_RATE = 16000

    def __init__(
        self,
        sample_rate: int = 16000,
        checkpoint: str | Path | None = None,
        params=None,
        config: HubertConfig = MHUBERT_147_CONFIG,
        output_layer: int = 8,
        precision: str | None = "default",
        batch_chunk: int | None = None,
        attention_impl: str = "auto",
        host_chunk: int | None = None,
        act_dtype: torch.dtype | None = None,
        gelu: str = "auto",
        softmax: str = "auto",
        device: torch.device | str | None = None,
        **kw,
    ):
        """``params``: the JAX package's parameter pytree (numpy leaves, as
        ``init_params`` or ``load_params`` give) or a ``HubertEncoder``;
        without it the weights load from ``checkpoint`` (default
        ``checkpoints/mhubert147.npz`` in this package).
        ``precision="default"`` is the bf16 block-kernel class on the card,
        ``"highest"`` the float32 tensor path. ``attention_impl``: "einsum",
        "sdpa" / "sdpa_exp2" / "sdpa_exp2_bf16" (kernel A9), "flash" (A15),
        "block" (A7), "block_ffn" (A7 + A8), "layer_block" (A11, the whole
        layer; its softmax "exp2" or else "exact"), "block_int8" (A12, the
        int8 screening mode, then the plain FFN) or "auto". ``gelu="auto"`` is tanh at
        the default precision and erf at "highest"; ``softmax="auto"`` exp2
        and exact likewise. ``act_dtype=torch.bfloat16`` runs the encoder's
        activation stream in bf16. ``batch_chunk`` encodes the doubled batch
        in row chunks (the same scores). ``host_chunk`` is an alias of it,
        kept for the JAX package's signature, where it splits the jit graph
        on the host; it wins where both are given, and takes no mesh. Other
        keywords (``mesh``, ``dtype``) go to ``BaseMetric``; a mesh whose
        ``model`` axis is larger than 1 runs the encoder tensor-parallel
        over it (``params`` then the pytree, cut by
        ``parallel.shard_params``)."""
        super().__init__(sample_rate, device=device, **kw)
        for name, value, allowed in (
            ("precision", precision, (None, "default", "highest")),
            ("gelu", gelu, ("auto", "erf", "tanh")),
            ("softmax", softmax, ("auto", "exact", "exp2", "exp2_bf16")),
        ):
            if value not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {value!r}")
        if attention_impl != "auto" and attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention impl: {attention_impl!r}")
        self.output_layer = output_layer
        self.precision = precision
        self.act_dtype = act_dtype
        self.gelu = ("erf" if precision == "highest" else "tanh") if gelu == "auto" else gelu
        self.softmax = ("exact" if precision == "highest" else "exp2") if softmax == "auto" else softmax
        self.batch_chunk = batch_chunk
        self.attention_impl = attention_impl
        self.host_chunk = host_chunk
        if host_chunk is not None and self.mesh is not None:
            raise ValueError("host_chunk is a single-device execution plan; use batch_chunk with a mesh")
        if params is None:
            params = self._load_params(checkpoint)
        self._tp_group = None
        if self.mesh is not None and axis_size(self.mesh, "model") > 1:
            # Megatron tensor parallelism over the mesh's 'model' axis
            if isinstance(params, HubertEncoder):
                raise ValueError("tensor parallelism shards the parameter pytree: pass params as the "
                                 "JAX package's layout (init_params, load_params), not a HubertEncoder")
            params = shard_params(params, self.mesh, config)
            self._tp_group = self.mesh.get_group("model")
        encoder = params if isinstance(params, HubertEncoder) else from_jax_params(params, config)
        self.config = encoder.config
        self.encoder = encoder.to(self.device)

    @staticmethod
    def _load_params(checkpoint):
        from fast_speech_enhancement_metrics_tpu_torch.utils.convert_hubert import load_params

        path = Path(checkpoint) if checkpoint is not None else DEFAULT_CHECKPOINT
        if not path.exists():
            raise FileNotFoundError(
                f"HuBERT checkpoint not found: {path}. Convert the HF model once, on a "
                "machine that has it: load utter-project/mHuBERT-147 with transformers, "
                "then utils.convert_hubert.save_params(convert_hf_hubert(model.state_dict(), "
                f"config_from_hf(model.config)), '{DEFAULT_CHECKPOINT}'); or pass params=..."
            )
        return load_params(str(path))

    def _resolve_impl(self, num_samples: int, rows: int) -> str:
        """The attention path for (rows, num_samples) inputs. On a CUDA device,
        "auto" follows the JAX package: 1500 frames (30 s) and more, or one
        chunk's logits over 4 GB, take the long-audio kernel A9 ("sdpa") up
        to 40 000 frames and A15 ("flash") past that, at any precision;
        shorter clips at the default precision with a post-LN config and an
        even head count take the block kernels A7 + A8, except under tensor
        parallelism, whose sharded weights close the block routes: there
        they take "einsum", as the JAX package does under a mesh. The
        kernels take heads of up to 128: a wider head raises on the card,
        naming the limit."""
        impl = self.attention_impl
        on_cuda = self._on_cuda()
        if impl == "auto":
            if not on_cuda:
                return "einsum"
            frames = num_samples // 320
            heads = self.config.num_attention_heads
            logits_gb = rows * heads * frames * frames * 4 / 1e9
            if frames >= 1500 or logits_gb > 4.0:
                impl = "sdpa" if frames <= SDPA_MAX_FRAMES else "flash"
            elif (
                self.precision in (None, "default")
                and self._tp_group is None
                and not self.config.do_stable_layer_norm
                and heads % 2 == 0
            ):
                impl = "block_ffn"
            else:
                impl = "einsum"
        head_dim = self.config.hidden_size // self.config.num_attention_heads
        if impl != "einsum" and on_cuda and head_dim > MAX_HEAD_DIM:
            raise NotImplementedError(
                f"the attention kernels take heads of at most {MAX_HEAD_DIM}, this config's are "
                f"{head_dim}; attention_impl='einsum' scores it"
            )
        return impl

    @staticmethod
    def _f1_from_embeddings(clean_emb: torch.Tensor, denoised_emb: torch.Tensor) -> dict:
        norm_c = clean_emb / torch.linalg.norm(clean_emb, dim=2, keepdim=True)
        norm_d = denoised_emb / torch.linalg.norm(denoised_emb, dim=2, keepdim=True)
        sim = torch.bmm(norm_d, norm_c.transpose(1, 2))  # fp32, no TF32
        precision_score = torch.amax(sim, dim=2).mean(dim=1)
        recall = torch.amax(sim, dim=1).mean(dim=1)
        return {"SpeechBERTScore": 2.0 * precision_score * recall / (precision_score + recall)}

    def _encode(self, audio: torch.Tensor, impl: str) -> torch.Tensor:
        with torch.inference_mode():
            return hubert_hidden_state(
                self.encoder, audio, output_layer=self.output_layer, attention_impl=impl,
                act_dtype=self.act_dtype, gelu=self.gelu, softmax=self.softmax,
                precision=self.precision, tp_group=self._tp_group,
            )

    def _compute(self, clean, denoised):
        assert clean is not None
        batch = clean.shape[0]
        speech = torch.cat([clean, denoised], dim=0)
        n, samples = speech.shape
        chunk = self.host_chunk if self.host_chunk is not None else self.batch_chunk
        if chunk is None:
            # the conv encoder's first activation is (rows, T/5, 512): past
            # ~8 GB, split into the fewest equal row chunks that fit
            bytes_per = 2 if self.act_dtype is not None else 4
            fe_gb = n * (samples // 5) * 512 * bytes_per / 1e9
            if fe_gb > 8.0:
                per_chunk = -(-n // int(-(-fe_gb // 8.0)))
                chunk = max(8, -(-per_chunk // 8) * 8)
        impl = self._resolve_impl(samples, n if chunk is None else min(n, chunk))
        if chunk is not None and n > chunk and n % chunk:
            speech = torch.cat([speech, speech[: chunk - n % chunk]], dim=0)
        if chunk is not None and speech.shape[0] > chunk:
            emb = torch.cat([self._encode(speech[i:i + chunk], impl) for i in range(0, speech.shape[0], chunk)])[:n]
        else:
            emb = self._encode(speech, impl)[:n]
        return self._f1_from_embeddings(emb[:batch], emb[batch:])
