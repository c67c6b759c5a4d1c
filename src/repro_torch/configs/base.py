"""Config dataclasses for the PyTorch port: copies of
``src/repro/configs/base.py``.

The forecaster's config (the serving slice), the LLM side-workloads'
``ModelConfig`` with its sub-configs, and the input shapes (the dense-LM
inference slice).  The federated stage configs come with the training
slice.  Configs are frozen dataclasses, hashable and safe to share between
threads; fields, defaults, ``num_params`` and ``reduced()`` match the JAX
package's exactly.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config (GShard-style capacity routing)."""
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0          # DeepSeek-style always-on shared experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    group_size: int = 2048             # GShard dispatch group size (perf knob)


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block config."""
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    n_groups: int = 1                  # B/C projection groups


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block mix (arXiv:2405.04517)."""
    slstm_every: int = 8               # 7 mLSTM : 1 sLSTM
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3334
    mlstm_head_dim: int = 512          # qk head dim for matrix memory
    chunk_size: int = 256


@dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend (the one sanctioned carve-out).

    For VLM: ``input_specs`` provides pre-projector patch embeddings of shape
    (batch, n_media_tokens, embed_dim); the projector itself IS implemented.
    For audio: tokens come as (batch, n_codebooks, seq) EnCodec codes.
    """
    kind: str                          # "vlm" | "audio"
    embed_dim: int = 1024              # ViT/SigLIP output width (vlm)
    n_media_tokens: int = 1152         # anyres tiles x 576 patches (vlm, train_4k)
    n_codebooks: int = 4               # EnCodec codebooks (audio)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 0            # 0 = full causal attention
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    frontend: Optional[FrontendConfig] = None
    dense_layers: int = 0              # DeepSeek: first-k layers are dense FFN
    attn_every: int = 0                # zamba2: shared attention block period
    mtp: bool = False                  # DeepSeek multi-token-prediction head
    source: str = ""                   # citation for the config numbers

    # ------------------------------------------------------------------ helpers
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def uses_attention(self) -> bool:
        return self.arch_type not in ("ssm",) or self.attn_every > 0

    def num_params(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d
        if self.frontend is not None and self.frontend.kind == "audio":
            emb *= self.frontend.n_codebooks  # per-codebook embeddings + heads
        n = emb
        if not self.tie_embeddings:
            n += self.vocab_size * d
        per_attn = 0
        if self.mla is not None:
            m = self.mla
            per_attn = (d * m.q_lora_rank
                        + m.q_lora_rank * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                        + d * (m.kv_lora_rank + m.qk_rope_dim)
                        + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                        + self.n_heads * m.v_head_dim * d)
        elif self.uses_attention:
            per_attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                        + self.n_heads * hd * d)
        per_dense_ff = 3 * d * self.d_ff if self.d_ff else 0
        per_moe_ff = 0
        if self.moe is not None:
            e = self.moe
            per_moe_ff = ((e.n_experts + e.n_shared_experts) * 3 * d * e.d_ff_expert
                          + d * e.n_experts)
        per_ssm = 0
        if self.ssm is not None:
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            per_ssm = (d * (2 * d_in + 2 * s.n_groups * s.state_dim + nh)
                       + d_in * d + s.conv_width * (d_in + 2 * s.n_groups * s.state_dim))
        per_xlstm = 0
        if self.xlstm is not None:
            x = self.xlstm
            d_in_m = int(x.mlstm_proj_factor * d)
            per_xlstm = d * d_in_m * 2 + 3 * d_in_m * d_in_m // 4 + d_in_m * d  # approx
        # assemble per-layer
        n_layers = self.n_layers
        if self.arch_type == "moe":
            dense_l = self.dense_layers
            n += dense_l * (per_attn + per_dense_ff)
            n += (n_layers - dense_l) * (per_attn + per_moe_ff)
        elif self.arch_type == "ssm" and self.xlstm is not None:
            n_s = n_layers // self.xlstm.slstm_every
            n += (n_layers - n_s) * per_xlstm + n_s * per_xlstm  # same order
        elif self.arch_type in ("hybrid",):
            n += n_layers * per_ssm
            if self.attn_every:
                n += per_attn + per_dense_ff  # one shared block
        else:
            n += n_layers * (per_attn + per_dense_ff)
        return int(n)

    def active_params(self) -> int:
        """Active (per-token) parameters — MoE uses top_k + shared experts."""
        if self.moe is None:
            return self.num_params()
        e = self.moe
        full_moe = (e.n_experts + e.n_shared_experts) * 3 * self.d_model * e.d_ff_expert
        act_moe = (e.top_k + e.n_shared_experts) * 3 * self.d_model * e.d_ff_expert
        n_moe_layers = self.n_layers - self.dense_layers
        return int(self.num_params() - n_moe_layers * (full_moe - act_moe))

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family: 2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        hd = max(32, d // n_heads)
        kv = max(1, min(self.n_kv_heads, n_heads,
                        max(1, n_heads * self.n_kv_heads // self.n_heads)))
        kw = dict(
            name=self.name + "-reduced",
            n_layers=2,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            dense_layers=min(self.dense_layers, 1),
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff_expert=128, group_size=64,
                n_shared_experts=min(self.moe.n_shared_experts, 1))
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                  qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, state_dim=16, head_dim=32,
                                            chunk_size=32)
        if self.xlstm is not None:
            kw["xlstm"] = dataclasses.replace(self.xlstm, slstm_every=2,
                                              mlstm_head_dim=64, chunk_size=32)
        if self.frontend is not None:
            kw["frontend"] = dataclasses.replace(
                self.frontend, embed_dim=64,
                n_media_tokens=min(self.frontend.n_media_tokens, 16))
        return dataclasses.replace(self, **kw)




@dataclass(frozen=True)
class ForecasterConfig:
    """The paper's RNN demand-forecasting model (§3.2)."""
    cell: str = "lstm"                 # "lstm" | "gru"
    input_dim: int = 1
    hidden_dim: int = 64
    n_layers: int = 1
    lookback: int = 8                  # 2 h of 15-min steps (§4.2)
    horizon: int = 4                   # 1 h ahead (§4.2)

    def num_params(self) -> int:
        h, i = self.hidden_dim, self.input_dim
        gates = 4 if self.cell == "lstm" else 3
        n = 0
        for l in range(self.n_layers):
            inp = i if l == 0 else h
            n += gates * h * (inp + h + 1)
        n += h * self.horizon + self.horizon
        return n


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # "train" | "prefill" | "decode"


INPUT_SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4096, 256, "train"),
    InputShape("prefill_32k", 32768, 32, "prefill"),
    InputShape("decode_32k", 32768, 128, "decode"),
    InputShape("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in INPUT_SHAPES}
