"""Config system: architecture configs and reduced variants, a copy of
``repro.configs.base`` kept inside the port so it imports nothing of the
JAX package.

Each architecture of ``ARCH_IDS`` has one module in this package defining
``CONFIG`` (published hyper-parameters, source cited), and
``gpt3_family`` holds the paper's own models; ``reduced()``
produces the small CPU-test variant of the same family (≤2 layers,
d_model ≤ 256, small vocab).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False   # arctic: parallel dense MLP branch
    dense_ff: int = 0              # d_ff of the dense residual branch
    aux_loss_coef: float = 0.01
    capacity_factor: float = 1.25  # set to n_experts to disable dropping


@dataclass(frozen=True)
class DeepSeekMoEConfig(MoEConfig):
    """DeepSeekMoE's layer (arXiv:2401.06066; DeepSeek-V2's config keys):
    fine-grained routed experts of their own width beside always-on
    shared experts, after ``first_k_dense_replace`` dense layers of
    ``ModelConfig.d_ff``. ``n_experts`` and ``top_k`` are the router's
    width and experts per token; ``aux_loss_coef`` is the balance loss's
    alpha. The gates are the router's probabilities at the top k, not
    renormalised and not scaled, and the balance loss is per sequence:
    DeepSeek-V2-Lite's ``norm_topk_prob`` false, ``routed_scaling_factor``
    1 and ``seq_aux`` true, the only values the layer computes. A
    subclass, so that the ``MoEConfig`` of every other config (and its
    ``dataclasses.asdict``) stays as the reference's.

    The layer runs dropless (``ModelConfig.moe_impl="dropless"``) over
    the experts this chip holds, ``n_held_experts`` of them from
    ``first_held_expert`` (0: all), as one rank of expert parallelism
    holds them; the router still scores all ``n_experts``."""
    moe_intermediate_size: int = 0   # each routed and shared expert's width
    n_shared_experts: int = 0        # one SwiGLU of n x the expert width
    first_k_dense_replace: int = 0   # leading dense layers
    first_held_expert: int = 0
    n_held_experts: int = 0          # 0: every routed expert

    @property
    def held(self) -> range:
        """The routed experts this chip computes."""
        return range(self.first_held_expert, self.first_held_expert
                     + (self.n_held_experts or self.n_experts))


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style);
    ``q_lora_rank`` None: the query straight from the input (no
    ``wq_a``/``q_norm``/``wq_b``, one ``wq``), as DeepSeek-V2-Lite."""
    q_lora_rank: Optional[int] = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class YarnMLAConfig(MLAConfig):
    """MLA under the YaRN rotary scaling of DeepSeek-V2's released config
    (``rope_scaling`` of type "yarn", arXiv:2309.00071; the fields are its
    keys): the rotary frequencies blend from the plain ones to a
    ``factor``-fold slower set between the dims that the correction
    range of ``beta_fast`` and ``beta_slow`` rotations over
    ``original_max_position_embeddings`` names, and the softmax scale
    takes mscale(``mscale_all_dim``) squared. A subclass, so that the
    ``MLAConfig`` of every other config (and its ``dataclasses.asdict``)
    stays as the reference's."""
    factor: float = 1.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block hyper-parameters."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    chunk: int = 256
    conv_width: int = 4
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""               # citation per assignment
    head_dim: Optional[int] = None  # default d_model // n_heads

    # attention variants
    attn_kind: str = "gqa"         # gqa | mla | none
    qkv_bias: bool = False         # qwen1.5
    attn_softcap: Optional[float] = None    # gemma2: 50.0
    final_softcap: Optional[float] = None   # gemma2: 30.0
    window_size: Optional[int] = None       # sliding window for local layers
    global_every: int = 0          # gemma2: every 2nd layer is global

    mla: Optional[MLAConfig] = None
    mla_absorb: bool = False       # §Perf: absorbed-latent decode path
    moe: Optional[MoEConfig] = None
    moe_impl: str = "einsum"       # einsum (GShard baseline) | sorted (§Perf)
    moe_groups_override: int = 0   # §Perf: router group count (0 = dp size)
    ssm: Optional[SSMConfig] = None

    # hybrid (zamba2): shared attention block every `attn_every` ssm blocks
    attn_every: int = 0

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    n_enc_ctx: int = 1500          # encoder positions (audio frames)

    # modality frontend stub (vlm / audio): precomputed embeddings
    frontend: Optional[str] = None   # "vision" | "audio"
    n_frontend_tokens: int = 0       # vlm: patch tokens prepended

    tie_embeddings: bool = True
    gated_mlp: bool = True         # SwiGLU/GeGLU (3 mats) vs GELU (2 mats)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # which input shapes are valid for this arch (documented skips)
    skip_shapes: tuple = ()

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def param_count(self) -> int:
        """Analytic parameter count (matches init within ~1%)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        hd = self.resolved_head_dim
        total = V * d                         # embedding
        if not self.tie_embeddings:
            total += V * d
        for i in range(L):
            total += self._layer_params(i)
        if self.arch_type == "encdec":
            for _ in range(self.n_enc_layers):
                total += self._enc_layer_params()
        if self.frontend == "vision":
            total += d * d                    # projector stub
        total += d                            # final norm
        return total

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        if self.attn_kind == "mla":
            m = self.mla
            qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
            if m.q_lora_rank is None:
                p = d * self.n_heads * qk_dim
            else:
                p = (d * m.q_lora_rank
                     + m.q_lora_rank * self.n_heads * qk_dim)
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            p += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            p += self.n_heads * m.v_head_dim * d
            return p
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        b = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + b

    def _mlp_params(self, ff: int) -> int:
        return (3 if self.gated_mlp else 2) * self.d_model * ff

    def _ssm_params(self) -> int:
        s = self.ssm
        d = self.d_model
        d_inner = s.expand * d
        nheads = d_inner // s.head_dim
        conv_dim = d_inner + 2 * s.n_groups * s.d_state
        p = d * (2 * d_inner + 2 * s.n_groups * s.d_state + nheads)  # in_proj
        p += conv_dim * s.conv_width + conv_dim                      # conv + bias
        p += nheads * 2                                              # A_log, D
        p += nheads                                                  # dt_bias
        p += d_inner * d                                             # out_proj
        return p

    def _layer_params(self, i: int) -> int:
        d = self.d_model
        if self.arch_type == "ssm":
            return self._ssm_params() + d
        if self.arch_type == "hybrid":
            p = self._ssm_params() + d
            # shared attention block params are counted once (layer 0 owns them)
            if self.attn_every and i == 0:
                p += self._attn_params() + self._mlp_params(self.d_ff) + 2 * d
            if self.attn_every and (i + 1) % self.attn_every == 0:
                p += 2 * d                    # per-invocation norms
            return p
        p = self._attn_params() + 2 * d       # attn + 2 norms
        if isinstance(self.moe, DeepSeekMoEConfig):
            m = self.moe
            if i < m.first_k_dense_replace:
                return p + self._mlp_params(self.d_ff)
            ff = m.moe_intermediate_size
            return (p + len(m.held) * self._mlp_params(ff) + d * m.n_experts
                    + self._mlp_params(m.n_shared_experts * ff))
        if self.moe is not None:
            p += self.moe.n_experts * self._mlp_params(self.d_ff)
            p += d * self.moe.n_experts       # router
            if self.moe.dense_residual:
                p += self._mlp_params(self.moe.dense_ff or self.d_ff)
        else:
            p += self._mlp_params(self.d_ff)
        return p

    def _enc_layer_params(self) -> int:
        # encoder self-attn + mlp (+ the decoder's cross-attn accounted here)
        return self._attn_params() * 2 + self._mlp_params(self.d_ff) + 3 * self.d_model

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        if isinstance(self.moe, DeepSeekMoEConfig):
            m = self.moe
            dead = ((len(m.held) - m.top_k)
                    * self._mlp_params(m.moe_intermediate_size))
            return self.param_count() - (
                self.n_layers - m.first_k_dense_replace) * max(dead, 0)
        dead = (self.moe.n_experts - self.moe.top_k) * self._mlp_params(self.d_ff)
        return self.param_count() - self.n_layers * dead

    def checkpoint_bytes(self, bytes_per_param: int = 14) -> int:
        """Paper §2.1.3: mixed-precision Adam ⇒ ~14 B/param."""
        return self.param_count() * bytes_per_param


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "internvl2_26b", "gemma2_9b", "arctic_480b", "minicpm3_4b",
    "stablelm_1_6b", "qwen3_moe_235b", "whisper_small", "qwen1_5_4b",
    "mamba2_370m", "zamba2_2_7b",
]

# paper's own models (GPT-3 family, Table 2)
PAPER_ARCH_IDS = ["gpt3_0_7b", "gpt3_1_3b", "gpt3_2_7b", "gpt3_6_7b",
                  "gpt3_13b", "gpt3_1_8b_moe"]


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """CPU smoke-test variant of the same family: ≤2 layers, d_model≤512,
    ≤4 experts, small vocab."""
    changes = dict(
        n_layers=2,
        d_model=min(cfg.d_model, 256),
        vocab_size=min(cfg.vocab_size, 512),
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_enc_ctx=min(cfg.n_enc_ctx, 32),
        n_frontend_tokens=min(cfg.n_frontend_tokens, 16),
    )
    # keep head structure but shrink
    if cfg.attn_kind == "mla":
        changes.update(n_heads=4, n_kv_heads=4,
                       mla=MLAConfig(q_lora_rank=64 if cfg.mla.q_lora_rank
                                     else None, kv_lora_rank=32,
                                     qk_nope_head_dim=16, qk_rope_head_dim=8,
                                     v_head_dim=16))
    elif cfg.n_heads:
        nh = min(cfg.n_heads, 4)
        ratio = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
        changes.update(n_heads=nh, n_kv_heads=max(nh // min(ratio, nh), 1),
                       head_dim=64)
    if cfg.moe is not None:
        changes["moe"] = replace(cfg.moe, n_experts=4,
                                 top_k=min(cfg.moe.top_k, 2),
                                 dense_ff=min(cfg.moe.dense_ff, 256))
        if isinstance(cfg.moe, DeepSeekMoEConfig):
            changes["moe"] = replace(
                changes["moe"], first_held_expert=0, n_held_experts=0,
                moe_intermediate_size=min(cfg.moe.moe_intermediate_size,
                                          128))
    if cfg.ssm is not None:
        changes["ssm"] = replace(cfg.ssm, d_state=16, head_dim=32, chunk=16)
    if cfg.window_size:
        changes["window_size"] = 8
    if cfg.attn_every:
        changes["attn_every"] = 1
    return replace(cfg, **changes)
