"""Config system: dataclasses describing models, CMoE conversion, meshes, runs.

Every assigned architecture is a `ModelConfig` built in `repro_torch/configs/<id>.py`
with two entry points:
  ``config()``        -- the full-size published configuration
  ``smoke_config()``  -- a reduced same-family configuration for CPU tests

Shapes (train_4k / prefill_32k / decode_32k / long_500k) are `ShapeConfig`s.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class MoEConfig:
    """Pretrained mixture-of-experts FFN block (llama4 / deepseek-v2 style)."""
    num_experts: int
    top_k: int
    d_expert: int                    # per-expert intermediate size
    num_shared: int = 0              # always-active shared experts
    d_shared: int = 0                # shared expert intermediate size (total)
    router_noise: float = 0.0
    capacity_factor: float = 1.25    # EP dispatch capacity
    balance_bias: bool = True        # aux-loss-free bias balancing
    moe_every: int = 1               # llama4: MoE every 2nd layer


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-v2)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD block."""
    state_size: int = 128
    num_heads: int = 0               # 0 -> derived: d_inner // head_dim
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper). Frontend is a stub:
    inputs are precomputed frame embeddings."""
    num_layers: int = 12
    num_frames: int = 1500           # whisper-small: 30s audio -> 1500 frames


@dataclass(frozen=True)
class VisionConfig:
    """VLM frontend stub: precomputed patch embeddings prepended to tokens."""
    num_patches: int = 256
    d_patch: int = 0                 # 0 -> d_model


@dataclass(frozen=True)
class CMoEConfig:
    """The paper's conversion configuration. SxAyEz notation:
    num_shared shared + top_k active routed out of num_experts total.

    ``top_k`` (and so the ``S{s}A{k}E{e}`` tag) names the DEFAULT
    activation tier, not a structural bound on the weights: one
    converted weight set serves any effective routed k in [1, top_k],
    because per-request k is routing DATA threaded through the stack
    (``serving.request.Request.tier`` -> ``Model.step(row_k=...)`` ->
    ``core.router.cmoe_gate(k_row=...)``). A request without a tier runs
    at top_k — what this config, the sparsity property, and the tag all
    describe."""
    num_experts: int = 8             # total experts N (shared + routed)
    num_shared: int = 3              # N_s
    top_k: int = 3                   # N_k active routed
    k_activation: int = 10           # K_a: ATopK width during profiling
    calib_tokens: int = 16384        # q: calibration tokens (8 x 2048)
    assignment: str = "auto"         # auto | jv | sinkhorn
    sinkhorn_iters: int = 100
    sinkhorn_tau: float = 0.05
    balance_gamma: float = 1e-3      # load-balance bias step
    learnable_scaling: bool = True

    @property
    def num_routed(self) -> int:
        return self.num_experts - self.num_shared

    @property
    def sparsity(self) -> float:
        """Fraction of FFN neurons NOT activated per token."""
        return 1.0 - (self.num_shared + self.top_k) / self.num_experts

    def tag(self) -> str:
        """Names the DEFAULT tier: A{top_k} is what tier-less requests
        run at; per-request tiers pick any k in [1, top_k] from the same
        weights."""
        return f"S{self.num_shared}A{self.top_k}E{self.num_experts}"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    activation: str = "swiglu"       # swiglu | geglu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # attention pattern
    sliding_window: int = 0          # 0 -> full attention
    local_global_ratio: int = 0      # gemma3: N local layers per 1 global
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0       # zamba2: shared attn block every k layers
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    # CMoE conversion applied to this model (None = original architecture)
    cmoe: Optional[CMoEConfig] = None
    dtype: str = "bfloat16"
    # notes for DESIGN/roofline
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode."""
        return self.family in ("ssm", "hybrid") or self.local_global_ratio > 0

    def with_cmoe(self, cmoe: CMoEConfig) -> "ModelConfig":
        return dataclasses.replace(self, cmoe=cmoe)

    def num_params(self) -> int:
        """Analytic parameter count (embeddings + blocks), matches init."""
        from repro_torch.models.model import count_params  # lazy, avoids cycle
        return count_params(self)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class MeshConfig:
    """Logical parallelism spec mapped onto the physical (pod, data, model) mesh."""
    multi_pod: bool = False
    # degrees are implied by the physical mesh: pod(2) x data(16) x model(16)
    # these knobs control how logical axes map on:
    fsdp_over_data: bool = True      # shard weights over data axis
    fsdp_over_pod: bool = True       # ... and over pod axis (multi-pod)
    seq_sharding: bool = True        # sequence-parallel residual stream
    expert_parallel: bool = True     # shard experts over model axis
    remat: str = "block"             # none | block | full


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 200
    learning_rate: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    microbatch: int = 0              # 0 -> no gradient accumulation
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    log_every: int = 10


def override(cfg: Any, **kw: Any) -> Any:
    """dataclasses.replace that tolerates nested 'a.b' keys."""
    direct = {k: v for k, v in kw.items() if "." not in k}
    nested: dict[str, dict[str, Any]] = {}
    for k, v in kw.items():
        if "." in k:
            head, rest = k.split(".", 1)
            nested.setdefault(head, {})[rest] = v
    for head, sub in nested.items():
        cur = getattr(cfg, head)
        direct[head] = override(cur, **sub)
    return dataclasses.replace(cfg, **direct)
