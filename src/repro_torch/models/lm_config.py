"""LMConfig: one config dataclass covering all 10 registered language-model
architectures (the reference's `repro.models.lm_config`, field for field);
`adtype` and `pdtype` are torch dtypes."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class IRCMode:
    """IRC execution mode for parameter matmuls (the paper's technique as a
    first-class feature on any architecture)."""
    enabled: bool = False
    scheme: str = "ternary"            # ternary (proposed) | binary (baseline)
    bias_rows: int = 32
    accumulation: str = "single_shot"
    # which projections run through the crossbar sim at eval
    project_attn: bool = True
    project_mlp: bool = True


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # block family
    block: str = "attn"                # attn | hybrid (attn+ssm) | rwkv
    # attention pattern: per-layer window; None = global.
    attn_pattern: str = "global"       # global | alt_local_global | local_mostly
    window: int = 4096
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    qk_norm: bool = False

    # MLP / MoE
    act: str = "swiglu"                # swiglu | gelu
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_dense_prefix: int = 0            # leading dense layers (kimi-k2)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (hybrid) / RWKV
    ssm_state: int = 16
    ssm_conv: int = 4
    d_ff_rwkv_mult: float = 3.5

    # embeddings / positions
    pos: str = "rope"                  # rope | sinusoidal | none
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    embed_scale: bool = False          # gemma multiplies embeds by sqrt(d)

    # norms
    norm_eps: float = 1e-6
    post_norm: bool = False            # gemma2 sandwich norms
    norm_plus_one: bool = False        # gemma (1+gamma) RMSNorm

    # numerics
    dtype: str = "bfloat16"            # activation dtype
    param_dtype: str = "float32"

    # modality frontend stub (musicgen/chameleon): inputs are precomputed
    # token ids in the unified vocab; "embed" -> normal token embedding.
    frontend: str = "embed"

    irc: IRCMode = IRCMode()

    # ------------------------------------------------------------ helpers
    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def d_inner_ssm(self) -> int:
        # hybrid: SSM branch width matches the attention branch width
        return self.attn_dim

    def layer_is_global(self, layer: int) -> bool:
        if self.attn_pattern == "global":
            return True
        if self.attn_pattern == "alt_local_global":
            return layer % 2 == 1      # gemma2: local, global, local, ...
        if self.attn_pattern == "local_mostly":
            # hymba: global attention at first, middle, and last layer
            return layer in (0, self.n_layers // 2, self.n_layers - 1)
        raise ValueError(self.attn_pattern)

    def global_layer_flags(self) -> Tuple[bool, ...]:
        return tuple(self.layer_is_global(l) for l in range(self.n_layers))

    def supports_long_context(self) -> bool:
        """True if decode memory is sub-linear in context (SSM/hybrid/linear)."""
        return self.block in ("hybrid", "rwkv")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        n_attn = d * self.attn_dim + 2 * d * self.n_kv_heads * self.head_dim \
            + self.attn_dim * d
        if self.block == "rwkv":
            ffh = int(self.d_ff_rwkv_mult * d) if ff == 0 else ff
            per_layer = 4 * d * d + d * ffh + ffh * d + 10 * d
        elif self.block == "hybrid":
            di = self.d_inner_ssm
            ssm = d * 2 * di + di * d + di * (2 * self.ssm_state + 2) \
                + self.ssm_conv * di
            per_layer = n_attn + ssm + 3 * d * ff
        elif self.moe:
            moe_layers = self.n_layers - self.n_dense_prefix
            per_moe = n_attn + self.n_experts * 3 * d * ff + d * self.n_experts
            total_blocks = moe_layers * per_moe + self.n_dense_prefix * (
                n_attn + 3 * d * (ff * self.top_k))
            emb = v * d * (1 if self.tie_embeddings else 2)
            return total_blocks + emb + self.n_layers * 2 * d
        else:
            mlp = 3 * d * ff if self.act == "swiglu" else 2 * d * ff
            per_layer = n_attn + mlp
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + self.n_layers * 2 * d

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if not self.moe:
            return self.param_count()
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        n_attn = d * self.attn_dim + 2 * d * self.n_kv_heads * self.head_dim \
            + self.attn_dim * d
        per_moe = n_attn + self.top_k * 3 * d * ff + d * self.n_experts
        moe_layers = self.n_layers - self.n_dense_prefix
        dense_layers = self.n_dense_prefix * (n_attn + 3 * d * ff * self.top_k)
        emb = v * d * (1 if self.tie_embeddings else 2)
        return moe_layers * per_moe + dense_layers + emb


@dataclasses.dataclass(frozen=True)
class MLAConfig(LMConfig):
    """The DeepSeek-V3 block without q-LoRA or YaRN (Moonlight): multi-head
    latent attention, a dense SwiGLU prefix of `dense_d_ff`, then layers of
    `n_experts` routed experts of `d_ff` with `n_shared_experts` shared
    ones, routed by sigmoid scores with a selection-only correction bias.
    `head_dim` is the query/key head size (`qk_nope_head_dim` +
    `qk_rope_head_dim`); the cache holds `kv_lora_rank` +
    `qk_rope_head_dim` values a token and layer.  The inherited fields
    keep their meaning; `block` is "mla"."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    dense_d_ff: int = 0
    n_shared_experts: int = 0
    routed_scaling_factor: float = 1.0

    @property
    def latent_dim(self) -> int:
        """Cached values a token and layer: the latent and the rope key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    def _attn_params(self) -> int:
        d, H = self.d_model, self.n_heads
        return (d * H * self.head_dim + d * self.latent_dim
                + self.kv_lora_rank
                + self.kv_lora_rank * H * (self.qk_nope_head_dim
                                           + self.v_head_dim)
                + H * self.v_head_dim * d)

    def param_count(self) -> int:
        """Embedding, unembedding, every layer (norms, the correction
        bias included) and the final norm."""
        d, ff, E = self.d_model, self.d_ff, self.n_experts
        per = self._attn_params() + 2 * d
        moe = (E * 3 * d * ff + 3 * d * ff * self.n_shared_experts
               + d * E + E)
        n_moe = self.n_layers - self.n_dense_prefix
        return (self.n_layers * per + self.n_dense_prefix * 3 * d
                * self.dense_d_ff + n_moe * moe + 2 * self.vocab_size * d
                + d)

    def active_param_count(self) -> int:
        """Parameters a token uses: `top_k` routed experts of each MoE
        layer, everything else whole."""
        d, ff, E = self.d_model, self.d_ff, self.n_experts
        idle = (E - self.top_k) * 3 * d * ff
        return self.param_count() - (self.n_layers
                                     - self.n_dense_prefix) * idle
