"""Config dataclasses for the PyTorch port: copies of
``src/repro/configs/base.py``.

The forecaster's config, the federated pipeline's stage configs with the
``FLConfig`` facade and its eager validation, the LLM side-workloads'
``ModelConfig`` with its sub-configs, and the input shapes.  Configs are
frozen dataclasses, hashable and safe to share between threads; fields,
defaults, validation, ``num_params`` and ``reduced()`` match the JAX
package's exactly.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
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


# ---------------------------------------------------------------------------
# Federated pipeline stage configs.
#
# One federated round is an explicit pipeline of five typed stages
#
#     select -> local-update -> transform(deltas) -> aggregate -> server-update
#
# and each stage is configured by its own frozen dataclass below.  The valid
# names for every pluggable stage live HERE (not in the implementing core
# module) so the ``FLConfig`` facade can validate eagerly at construction
# without importing ``repro_torch.core`` (which imports this module); the core
# modules re-export them (``core/server_opt.py::SERVER_OPTS`` etc.).
# ---------------------------------------------------------------------------
SERVER_OPTS = ("fedavg", "fedavg_weighted", "fedprox", "fedadam", "fedyogi")
SAMPLING_STRATEGIES = ("uniform", "weighted", "round_robin")
AGGREGATORS = ("flat", "hierarchical")
LOSSES = ("mse", "ew_mse")
ASYNC_MODES = ("sync", "semi_sync")
STRAGGLER_DISTRIBUTIONS = ("deterministic", "lognormal", "heavy_tail")


def _check_choice(kind: str, value: str, valid: Tuple[str, ...]) -> None:
    if value not in valid:
        raise ValueError(f"unknown {kind} {value!r}; valid choices: "
                         f"{list(valid)}")


@dataclass(frozen=True)
class SamplingConfig:
    """Select stage: per-round client-selection scheme (``core/sampling.py``).

    ``seed`` parameterizes schedule-type samplers (round_robin's fixed
    ordering); rng-driven samplers draw from the per-call rng instead.
    """
    strategy: str = "uniform"          # uniform | weighted | round_robin
    seed: int = 0

    def __post_init__(self):
        _check_choice("sampling strategy", self.strategy, SAMPLING_STRATEGIES)


@dataclass(frozen=True)
class ClientOptConfig:
    """Local-update stage: E epochs of minibatch SGD (``core/client.py``)."""
    lr: float = 1e-2
    local_epochs: int = 1              # E
    batch_size: int = 64               # B
    loss: str = "ew_mse"               # "mse" | "ew_mse"
    beta: float = 2.0                  # EW-MSE beta (>1)
    prox_mu: float = 0.0               # FedProx proximal strength

    def __post_init__(self):
        _check_choice("loss", self.loss, LOSSES)


@dataclass(frozen=True)
class TransformConfig:
    """Transform stage: per-client delta transforms (``core/transforms.py``).

    Applied to each client's update ``w_i - w_global`` INSIDE the round body,
    before the aggregation collective, in the fixed order
    clip -> noise -> quantize.  All knobs default to off; the identity stack
    keeps the round bit-identical to the pre-transform engine.
    """
    clip_norm: float = 0.0             # C: per-client delta L2 bound (0 = off)
    noise_multiplier: float = 0.0      # Gaussian DP noise sigma/C (0 = off)
    quantize_bits: int = 0             # stochastic int quantize (0 = off)
    quantize_ring: bool = False        # shared-grid ring quantizer (the
    #                                  # secure-agg wire; forced on by masking)

    def __post_init__(self):
        if self.clip_norm < 0:
            raise ValueError(f"clip_norm must be >= 0, got {self.clip_norm}")
        if self.noise_multiplier < 0:
            raise ValueError("noise_multiplier must be >= 0, got "
                             f"{self.noise_multiplier}")
        if self.quantize_bits and not 2 <= self.quantize_bits <= 8:
            raise ValueError("quantize_bits must be 0 (off) or in [2, 8], "
                             f"got {self.quantize_bits}")
        if self.quantize_ring and not self.quantize_bits:
            raise ValueError("quantize_ring needs quantize_bits > 0 (the "
                             "ring IS the quantizer's integer grid)")

    @property
    def is_identity(self) -> bool:
        return (self.clip_norm == 0.0 and self.noise_multiplier == 0.0
                and self.quantize_bits == 0)


@dataclass(frozen=True)
class SecureAggConfig:
    """Secure-aggregation stage: pairwise masking (``core/secure_agg.py``).

    When ``enabled``, every client adds antisymmetric pairwise masks
    (``mask_ij = -mask_ji``, derived from the dispatch cohort's shared round
    key) to its WEIGHTED contribution before it leaves the device, so the
    honest-but-curious server sees per-client uploads whose masks cancel
    exactly in the aggregator sum.  The masks are full-strength on the
    uploaded quantity itself (never scaled by ``1/w_i``), so upload secrecy
    does not depend on the client's aggregation weight.  With the quantize
    stage on, masking runs in the quantizer's integer ring mod ``2^b``
    (uniform ring masks, exact wraparound cancellation, int``b``+scale
    wire); without it, ``mask_std`` is the Gaussian mask scale on the
    weighted float upload (see ``core/secure_agg.py`` and docs/privacy.md —
    ``mask_std`` is ignored in ring mode, where masks are uniform over the
    whole ring).  In semi-sync mode, enabling secure aggregation forces
    cohort-atomic folds (see :class:`AsyncConfig`).
    """
    enabled: bool = False
    mask_std: float = 1.0

    def __post_init__(self):
        if self.mask_std <= 0:
            raise ValueError(f"mask_std must be > 0, got {self.mask_std}")


@dataclass(frozen=True)
class PrivacyConfig:
    """(epsilon, delta) accounting for the DP transform stage
    (``core/privacy.py``).

    The accountant composes the per-round subsampled Gaussian mechanism
    (clip ``C`` + noise ``z*C`` from :class:`TransformConfig`, sampling rate
    ``m/N``) across rounds via RDP at integer orders and reports a running
    ``(epsilon, delta)``.  ``delta`` is the target failure probability;
    ``orders`` overrides the default integer RDP order grid (empty = the
    default ``core/privacy.py::DEFAULT_ORDERS``) — a library-level knob for
    direct ``privacy.make_accountant(tcfg, PrivacyConfig(...), q)`` users;
    the flat ``FLConfig`` facade surfaces only ``privacy_delta``.
    Accounting is only meaningful with BOTH clip and noise on — otherwise
    the accountant reports ``epsilon = inf`` (disabled).
    """
    delta: float = 1e-5
    orders: Tuple[int, ...] = ()

    def __post_init__(self):
        if not 0.0 < self.delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {self.delta}")
        if any(o < 2 for o in self.orders):
            raise ValueError("RDP orders must be >= 2, got "
                             f"{self.orders}")


@dataclass(frozen=True)
class AggregationConfig:
    """Aggregate stage: cross-client reduction topology (``core/aggregation.py``).

    ``flat`` is the one-psum cloud aggregation; ``hierarchical`` is the
    two-level edge->region->cloud reduction over a 2-D (region, clients)
    mesh.  ``n_regions=0`` lets the mesh builder pick (see
    ``aggregation.make_hierarchical_mesh``).
    """
    kind: str = "flat"                 # flat | hierarchical
    n_regions: int = 0                 # hierarchical: # of region groups

    def __post_init__(self):
        _check_choice("aggregation", self.kind, AGGREGATORS)
        if self.n_regions < 0:
            raise ValueError(f"n_regions must be >= 0, got {self.n_regions}")


@dataclass(frozen=True)
class LatencyConfig:
    """Simulated per-client round-trip time model (``core/latency.py``).

    A selected client's time-to-server is

        mult * (compute_s_per_window_epoch * n_windows * E
                + payload_bytes / uplink_bytes_per_s)

    — compute proportional to its local work (windows x epochs, the paper's
    Pi-4B regime where training dominates), uplink proportional to the
    post-quantize payload size.  ``mult`` is the pluggable straggler draw:
    ``deterministic`` is always 1 (zero jitter), ``lognormal`` is
    ``exp(jitter * N(0, 1))``, ``heavy_tail`` is ``1 + jitter * Pareto(1.5)``
    (rare but extreme stalls).  ``jitter=0`` makes every distribution
    deterministic.  Draws are a pure function of (seed, round, slot), so a
    simulated schedule replays exactly.

    The default constants are calibrated against the paper's measured
    70-100 s Pi-4B rounds (§5.5); the term-by-term derivation lives in the
    ``core/latency.py`` module docstring (and README): one year of 15-min
    readings => ~26.3k train windows per client, so 3.2 ms/(window*epoch)
    puts a jitter-free E=1 round at ~84 s compute + ~0.6 s uplink — mid-band
    of the measurement.
    """
    distribution: str = "deterministic"  # deterministic | lognormal | heavy_tail
    compute_s_per_window_epoch: float = 3.2e-3  # Pi-4B local SGD cost per
    #                                  # window*epoch (see core/latency.py)
    uplink_bytes_per_s: float = 1e6            # edge uplink bandwidth
    jitter: float = 0.5                        # straggler spread (0 = none)

    def __post_init__(self):
        _check_choice("straggler distribution", self.distribution,
                      STRAGGLER_DISTRIBUTIONS)
        if self.compute_s_per_window_epoch <= 0:
            raise ValueError("compute_s_per_window_epoch must be > 0, got "
                             f"{self.compute_s_per_window_epoch}")
        if self.uplink_bytes_per_s <= 0:
            raise ValueError("uplink_bytes_per_s must be > 0, got "
                             f"{self.uplink_bytes_per_s}")
        if self.jitter < 0:
            raise ValueError(f"jitter must be >= 0, got {self.jitter}")


@dataclass(frozen=True)
class ChurnConfig:
    """Client-churn / failure injection for the simulated event clock
    (``core/latency.py`` draws, ``core/async_engine.py`` recovery).

    Real edge fleets lose clients mid-round (the paper's Pi cluster, §5.5;
    arXiv:2201.11248, arXiv:2404.03320) — this stage makes dispatched work
    able to *never arrive* and membership able to change across rounds,
    with every draw a pure function of ``(seed, round, slot)`` so a faulty
    schedule replays bit-exactly.

    ``dropout_prob``
        Per-dispatch probability a client fails MID-UPLOAD: its update gets
        an infinite finish time and the server only learns about it via the
        dispatch timeout.  Requires ``mode="semi_sync"`` — a synchronous
        round that waits for a vanished client would simply never end.
    ``absent_prob``
        Per-round probability a member is unavailable for selection (device
        off / left the fleet / rejoined later) — join/leave membership
        churn, applied before the select stage.  Valid in every mode.
    ``timeout_rounds``
        Dispatch timeout, in rounds: work still unarrived
        ``timeout_rounds`` rounds after its (re)dispatch is declared
        abandoned.  The server cannot distinguish a crashed client from an
        extreme straggler, so timeouts abandon both.
    ``max_retries``
        Re-dispatch attempts for abandoned non-cohort work (the client
        re-uploads its retained transformed delta, charged a fresh uplink
        latency draw; the retry can itself drop out).  Under cohort-atomic
        folds (secure aggregation) abandoned members are not retried —
        the surviving cohort re-keys instead (``core/secure_agg.py``).
    """
    dropout_prob: float = 0.0          # P(dispatched upload never arrives)
    absent_prob: float = 0.0           # P(member unavailable in a round)
    timeout_rounds: int = 2            # rounds before unarrived work is
    #                                  # declared abandoned
    max_retries: int = 1               # re-dispatches per abandoned update

    def __post_init__(self):
        if not 0.0 <= self.dropout_prob < 1.0:
            raise ValueError("dropout_prob must be in [0, 1), got "
                             f"{self.dropout_prob}")
        if not 0.0 <= self.absent_prob < 1.0:
            raise ValueError("absent_prob must be in [0, 1), got "
                             f"{self.absent_prob}")
        if self.timeout_rounds < 1:
            raise ValueError("timeout_rounds must be >= 1, got "
                             f"{self.timeout_rounds}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0, got "
                             f"{self.max_retries}")

    @property
    def faulty(self) -> bool:
        """True when dispatched work can fail to arrive (dropouts on) —
        the engine only runs timeout/recovery bookkeeping then, so
        churn-off runs stay bit-identical to the fault-free engine."""
        return self.dropout_prob > 0.0


@dataclass(frozen=True)
class AsyncConfig:
    """Round-pacing stage: synchronous vs semi-synchronous buffered rounds
    (``core/async_engine.py``).

    ``sync`` is the paper's Alg. 1 — the server waits for every selected
    client, so the slowest straggler gates the round.  ``semi_sync``
    over-selects ``m' = ceil(over_select * m)`` clients, flushes the
    aggregate as soon as the first ``buffer_k`` pending updates arrive
    (simulated event clock, :class:`LatencyConfig`), and folds late arrivals
    into later rounds with staleness-discounted weights
    ``w_i * (1 + tau_i)^(-staleness_alpha)`` (tau = rounds late).

    The flush threshold is either ABSOLUTE (``buffer_k``) or RELATIVE
    (``buffer_frac``: ``ceil(frac * this round's dispatch size)``, resolved
    per round).  Prefer the fraction when round sizes vary — per-cluster
    memberships or holdouts shrink the in-flight set, and an absolute
    ``buffer_k`` at or above it silently waits for every straggler.  With
    both at 0 the server waits for all dispatched (bit-identical to sync
    under zero-jitter latency); setting both raises.

    ``cohort_atomic`` makes folds atomic per DISPATCH cohort: a round's
    updates enter the fold only once EVERY member of that dispatch set has
    arrived, so a whole cohort folds late together (all with the same
    staleness tau) instead of trickling in per arrival.  This is the fold
    granularity secure aggregation requires — pairwise masks cancel only
    over a complete cohort — and is forced on automatically when
    :class:`SecureAggConfig` is enabled.
    """
    mode: str = "sync"                 # sync | semi_sync
    over_select: float = 1.0           # m' = ceil(over_select * m) >= m
    buffer_k: int = 0                  # absolute flush threshold (0 = off)
    buffer_frac: float = 0.0           # relative threshold (0 = off)
    staleness_alpha: float = 0.5       # weight discount exponent (0 = none)
    cohort_atomic: bool = False        # fold whole dispatch cohorts only
    latency: LatencyConfig = field(default_factory=LatencyConfig)

    def __post_init__(self):
        _check_choice("async mode", self.mode, ASYNC_MODES)
        if self.over_select < 1.0:
            raise ValueError("over_select must be >= 1 (m' >= m), got "
                             f"{self.over_select}")
        if self.buffer_k < 0:
            raise ValueError(f"buffer_k must be >= 0, got {self.buffer_k}")
        if not 0.0 <= self.buffer_frac <= 1.0:
            raise ValueError("buffer_frac must be in [0, 1], got "
                             f"{self.buffer_frac}")
        if self.buffer_k and self.buffer_frac:
            raise ValueError("set buffer_k OR buffer_frac, not both "
                             f"(got {self.buffer_k} and {self.buffer_frac})")
        if self.staleness_alpha < 0:
            raise ValueError("staleness_alpha must be >= 0, got "
                             f"{self.staleness_alpha}")


@dataclass(frozen=True)
class ServerOptConfig:
    """Server-update stage: optimizer on the pseudo-gradient
    ``w_global - w_agg`` (``core/server_opt.py``)."""
    name: str = "fedavg"               # fedavg | fedavg_weighted | fedprox
    #                                  # | fedadam | fedyogi
    lr: float = 1.0
    momentum: float = 0.0              # >0 turns fedavg* into FedAvgM
    beta1: float = 0.9                 # fedadam / fedyogi first moment
    beta2: float = 0.99                # fedadam / fedyogi second moment
    eps: float = 1e-3                  # fedadam / fedyogi adaptivity floor

    def __post_init__(self):
        _check_choice("server_opt", self.name, SERVER_OPTS)


@dataclass(frozen=True)
class FLConfig:
    """Federated-learning schedule (paper Alg. 1 + §4): flat facade over the
    typed pipeline-stage configs.

    Construction is unchanged from the original flat config (every existing
    call site and default is preserved), but the engine consumes it through
    the typed views — ``.sampling_config``, ``.client_opt``, ``.transform``,
    ``.aggregation_config``, ``.server`` — one per pipeline stage
    (select -> local-update -> transform -> aggregate -> server-update).
    Validation is EAGER: a typo'd ``server_opt`` / ``sampling`` /
    ``aggregation`` or out-of-range transform knob raises ``ValueError`` at
    construction with the valid choices, instead of surfacing rounds-deep in
    training.  Defaults reproduce the paper exactly (uniform FedAvg, uniform
    sampling, identity transform, flat aggregation).
    """
    n_clients: int = 100               # N
    clients_per_round: int = 100       # M
    local_epochs: int = 1              # E
    batch_size: int = 64               # B
    rounds: int = 500                  # T
    lr: float = 1e-2
    loss: str = "ew_mse"               # "mse" | "ew_mse"
    beta: float = 2.0                  # EW-MSE beta (>1)
    n_clusters: int = 4                # K-means k (0 = no clustering)
    cluster_days: int = 273            # t_p: daily-average summary length
    seed: int = 0
    # ------------------------------------------------- round-engine knobs
    server_opt: str = "fedavg"         # fedavg | fedavg_weighted | fedprox
    #                                  # | fedadam | fedyogi
    server_lr: float = 1.0             # server step on the pseudo-gradient
    server_momentum: float = 0.0       # >0 turns fedavg* into FedAvgM
    server_beta1: float = 0.9          # fedadam / fedyogi first moment
    server_beta2: float = 0.99         # fedadam / fedyogi second moment
    server_eps: float = 1e-3           # fedadam / fedyogi adaptivity floor
    prox_mu: float = 0.0               # FedProx proximal strength (client side)
    sampling: str = "uniform"          # uniform | weighted | round_robin
    holdout_frac: float = 0.0          # fraction of clients held out of
    #                                  # training for unseen-client eval
    # --------------------------------------------- delta-transform stage
    dp_clip: float = 0.0               # per-client delta L2 clip C (0 = off)
    dp_noise: float = 0.0              # Gaussian noise multiplier (0 = off)
    quantize_bits: int = 0             # stochastic int quantize (0 = off)
    quantize_ring: bool = False        # shared-grid ring quantizer even
    #                                  # without masking (the clear
    #                                  # comparator of the secure-agg wire)
    # ------------------------------------------- secure-agg / DP accounting
    secure_agg: bool = False           # pairwise-masked uploads (masks cancel
    #                                  # in the aggregator sum)
    secure_mask_std: float = 1.0       # per-pair mask scale
    privacy_delta: float = 1e-5        # target delta for the (eps, delta)
    #                                  # accountant (needs dp_clip + dp_noise)
    # ------------------------------------------------- aggregation stage
    aggregation: str = "flat"          # flat | hierarchical
    n_regions: int = 0                 # hierarchical: # of regions (0 = auto)
    # ------------------------------------------------- round-pacing stage
    mode: str = "sync"                 # sync | semi_sync
    over_select: float = 1.0           # semi_sync: m' = ceil(over_select * m)
    buffer_k: int = 0                  # absolute flush threshold (0 = off)
    buffer_frac: float = 0.0           # relative flush threshold (0 = off;
    #                                  # both 0 = wait for all dispatched)
    staleness_alpha: float = 0.5       # late-update weight discount exponent
    cohort_atomic: bool = False        # fold whole dispatch cohorts only
    #                                  # (forced on by secure_agg)
    stragglers: str = "deterministic"  # latency distribution (see LatencyConfig)
    straggler_jitter: float = 0.5      # straggler spread (ignored when
    #                                  # stragglers="deterministic")
    # ------------------------------------------------- client-churn stage
    dropout_prob: float = 0.0          # P(dispatched upload never arrives);
    #                                  # semi_sync only (see ChurnConfig)
    absent_prob: float = 0.0           # P(member unavailable in a round)
    timeout_rounds: int = 2            # dispatch timeout (rounds) before
    #                                  # unarrived work is abandoned
    max_retries: int = 1               # re-dispatches per abandoned update

    def __post_init__(self):
        # materializing every typed stage view runs that stage's own
        # validation -> bad names/knobs fail here, at construction
        _ = (self.sampling_config, self.client_opt, self.transform,
             self.aggregation_config, self.server, self.async_config,
             self.secure, self.privacy, self.churn)
        if self.dropout_prob > 0.0 and self.mode != "semi_sync":
            raise ValueError(
                "dropout_prob > 0 requires mode='semi_sync': a synchronous "
                "round waits for every client, so a vanished upload would "
                "gate it forever (absent_prob works in any mode)")

    # ------------------------------------------------- typed stage views
    @property
    def sampling_config(self) -> SamplingConfig:
        return SamplingConfig(strategy=self.sampling, seed=self.seed)

    @property
    def client_opt(self) -> ClientOptConfig:
        return ClientOptConfig(lr=self.lr, local_epochs=self.local_epochs,
                               batch_size=self.batch_size, loss=self.loss,
                               beta=self.beta, prox_mu=self.prox_mu)

    @property
    def transform(self) -> TransformConfig:
        return TransformConfig(clip_norm=self.dp_clip,
                               noise_multiplier=self.dp_noise,
                               quantize_bits=self.quantize_bits,
                               quantize_ring=self.quantize_ring)

    @property
    def aggregation_config(self) -> AggregationConfig:
        return AggregationConfig(kind=self.aggregation,
                                 n_regions=self.n_regions)

    @property
    def async_config(self) -> AsyncConfig:
        # secure aggregation forces cohort-atomic folds: pairwise masks
        # cancel only over a complete dispatch cohort
        return AsyncConfig(mode=self.mode, over_select=self.over_select,
                           buffer_k=self.buffer_k,
                           buffer_frac=self.buffer_frac,
                           staleness_alpha=self.staleness_alpha,
                           cohort_atomic=self.cohort_atomic or
                           self.secure_agg,
                           latency=LatencyConfig(
                               distribution=self.stragglers,
                               jitter=self.straggler_jitter))

    @property
    def churn(self) -> ChurnConfig:
        return ChurnConfig(dropout_prob=self.dropout_prob,
                           absent_prob=self.absent_prob,
                           timeout_rounds=self.timeout_rounds,
                           max_retries=self.max_retries)

    @property
    def secure(self) -> SecureAggConfig:
        return SecureAggConfig(enabled=self.secure_agg,
                               mask_std=self.secure_mask_std)

    @property
    def privacy(self) -> PrivacyConfig:
        return PrivacyConfig(delta=self.privacy_delta)

    @property
    def server(self) -> ServerOptConfig:
        return ServerOptConfig(name=self.server_opt, lr=self.server_lr,
                               momentum=self.server_momentum,
                               beta1=self.server_beta1,
                               beta2=self.server_beta2, eps=self.server_eps)


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
