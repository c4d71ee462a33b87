"""Model configuration of the LM substrate: ``repro/configs/base.py``.

The port keeps its own copy of the reference's dataclasses (plain Python,
but the port imports nothing of the JAX package): ``ModelConfig``, its
MoE / MLA / SSM sub-configs, ``resolved_head_dim`` and ``reduced()``,
verbatim, and the dry run's shapes (``ShapeConfig``, ``SHAPES``,
``cell_applicable``), also verbatim.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

__all__ = ["MLAConfig", "MoEConfig", "ModelConfig", "SHAPES", "SSMConfig", "ShapeConfig",
           "cell_applicable"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    group_size: int = 1024        # dispatch group (tokens) for the scan
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention dims (arXiv:2405.04434)."""

    kv_lora: int = 512
    q_lora: int = 1536
    rope_dim: int = 64            # decoupled RoPE key dim
    nope_dim: int = 128           # per-head non-rope q/k dim
    v_dim: int = 128              # per-head value dim


@dataclass(frozen=True)
class SSMConfig:
    kind: str                     # "mamba2" | "xlstm"
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # mamba2 P dim
    chunk: int = 256
    slstm_every: int = 0          # xlstm: one sLSTM per this many mLSTM layers


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None   # default d_model // n_heads
    act: str = "swiglu"           # swiglu | geglu
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    attn_every: int = 0           # hybrid: shared attn block every k ssm layers
    enc_layers: int = 0           # enc-dec: encoder depth (n_layers = decoder)
    frontend: str | None = None   # "vit_stub" | "audio_stub"
    n_frontend_tokens: int = 256
    dense_layers: int = 0         # moe: leading dense-FFN layers (deepseek=1)
    sliding_window: int = 0       # >0: cap attention window (hybrid long-ctx)
    pad_heads_to: int = 1         # zero-pad q heads to a multiple (TP divisibility)
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (SSM state or windowed.)"""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D model FLOPs)."""
        d, v = self.d_model, self.vocab
        hd = self.resolved_head_dim
        emb = v * d * 2  # in + out embedding (untied)
        per_attn = (
            d * self.n_heads * hd
            + 2 * d * self.n_kv_heads * hd
            + self.n_heads * hd * d
        )
        if self.mla:
            m = self.mla
            per_attn = (
                d * m.q_lora
                + m.q_lora * self.n_heads * (m.nope_dim + m.rope_dim)
                + d * (m.kv_lora + m.rope_dim)
                + m.kv_lora * self.n_heads * (m.nope_dim + m.v_dim)
                + self.n_heads * m.v_dim * d
            )
        gates = 3 if self.act in ("swiglu", "geglu") else 2
        per_dense_ffn = gates * d * self.d_ff
        if self.ssm is not None and self.ssm.kind == "mamba2":
            di = self.ssm.expand * d
            per_ssm = d * (2 * di + 2 * self.ssm.d_state) + di * d + di
            n_ssm = self.n_layers
            n_attn_apps = 0 if self.attn_every == 0 else 1  # shared weights
            total = emb + n_ssm * per_ssm + n_attn_apps * (per_attn + per_dense_ffn)
            return int(total)
        if self.ssm is not None and self.ssm.kind == "xlstm":
            di = 2 * d
            per_m = d * 3 * di + di * d + 3 * di  # mlstm proj + gates-ish
            return int(emb + self.n_layers * per_m)
        if self.moe:
            mo = self.moe
            per_moe_ffn = (
                mo.n_experts * 3 * d * mo.d_ff_expert
                + mo.n_shared * 3 * d * max(mo.d_ff_shared, mo.d_ff_expert)
                + d * mo.n_experts
            )
            n_moe = self.n_layers - self.dense_layers
            total = (
                emb
                + self.n_layers * per_attn
                + self.dense_layers * per_dense_ffn
                + n_moe * per_moe_ffn
            )
            return int(total)
        n_blocks = self.n_layers + self.enc_layers
        return int(emb + n_blocks * (per_attn + per_dense_ffn))

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared experts only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        mo = self.moe
        per_moe_active = (mo.top_k + mo.n_shared) * 3 * d * mo.d_ff_expert
        per_moe_total = (
            mo.n_experts * 3 * d * mo.d_ff_expert
            + mo.n_shared * 3 * d * max(mo.d_ff_shared, mo.d_ff_expert)
        )
        n_moe = self.n_layers - self.dense_layers
        return int(self.param_count() - n_moe * (per_moe_total - per_moe_active))

    def reduced(self) -> "ModelConfig":
        """Smoke-test scale: same family/topology, tiny dims."""
        kw: dict = dict(
            n_layers=min(self.n_layers, 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=256,
            vocab=512,
            head_dim=32 if self.head_dim else None,
            enc_layers=min(self.enc_layers, 2),
            dense_layers=min(self.dense_layers, 1),
            n_frontend_tokens=8 if self.frontend else self.n_frontend_tokens,
            sliding_window=64 if self.sliding_window else 0,
            pad_heads_to=1,
            attn_every=2 if self.attn_every else 0,
        )
        if self.moe:
            kw["moe"] = replace(
                self.moe,
                n_experts=8,
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=64,
                d_ff_shared=64 if self.moe.n_shared else 0,
                group_size=64,
            )
        if self.mla:
            kw["mla"] = MLAConfig(kv_lora=32, q_lora=48, rope_dim=8, nope_dim=16, v_dim=16)
        if self.ssm:
            kw["ssm"] = replace(
                self.ssm, d_state=16, head_dim=16, chunk=32,
                slstm_every=4 if self.ssm.slstm_every else 0,
            )
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str        # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    def reduced(self) -> "ShapeConfig":
        return ShapeConfig(
            self.name, self.kind, min(self.seq_len, 64), min(self.global_batch, 2)
        )


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Which (arch x shape) cells run; mirrors DESIGN.md §Arch-applicability."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k decode is not sub-quadratic (skip per brief)"
    return True, ""
