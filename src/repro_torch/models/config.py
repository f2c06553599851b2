"""ModelConfig — one dataclass describing every assigned architecture (a
copy of ``repro/models/config.py``; ``jdtype`` is ``torch_dtype`` here).

`block` selects the layer stack:
  dense        : attention + MLP every layer
  moe          : attention + MoE-FFN every layer
  mamba1       : Mamba-1 blocks only (attention-free)
  mamba2_hybrid: Mamba-2 blocks with one *shared* attention+MLP block applied
                 every `hybrid_period` layers (Zamba2 pattern)
  encdec       : whisper-style encoder/decoder
`frontend` ('none' | 'vision_stub' | 'audio_stub') adds precomputed modality
embeddings supplied by input_specs() per the assignment.

One field is the port's own, at the end: ``mixer_rms_eps`` (Falcon-Mamba's
mixer norms, set by ``configs/falcon_mamba_7b.py``); the JAX package's
configs have no such norm, so a parity test pins it to None.

On one device ``fsdp``, ``seq_shard_activations`` and ``scan_layers``
change nothing; over a mesh ``fsdp`` and ``seq_shard_activations`` are
``make_rules``' knobs (``launch/steps.py``).  ``remat`` changes the
training backward's memory, not its values (the stacks checkpoint each
layer with ``torch.utils.checkpoint``).  The port keeps them all so that
every architecture module copies verbatim.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    block: str = "dense"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None          # default d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    act: str = "swiglu"                     # swiglu | geglu | gelu | relu2
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    rope_mode: str = "full"                 # full | partial | 2d | none
    rope_fraction: float = 1.0
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0              # gemma-style soft capping (0=off)
    pad_vocab: bool = True                  # pad embed/unembed to 256 so the
                                            # vocab dim shards on any mesh

    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (mamba1 / mamba2)
    ssm_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                        # 0 -> ceil(d_model / 16)
    mamba2_headdim: int = 64
    hybrid_period: int = 6                  # zamba2: shared block every N

    # enc-dec (whisper)
    enc_layers: int = 0
    dec_layers: int = 0
    n_audio_frames: int = 1500

    # VLM stub
    frontend: str = "none"
    n_vision_tokens: int = 256

    # numerics / execution
    dtype: str = "float32"                  # param/compute dtype
    scan_layers: bool = True
    unroll_scans: bool = False              # unroll inner scans (flash/ssm)
                                            # so HLO cost analysis is exact
    remat: bool = False
    seq_shard_activations: bool = False     # Megatron-SP residual stream
    attn_impl: str = "auto"                 # auto | dense | flash_jnp | pallas | cuda
    attn_block_kv: int = 1024               # flash KV block
    ssm_chunk: int = 128
    fsdp: bool = False                      # ZeRO-3 param sharding over data

    # port only (the JAX package's ModelConfig has no such field)
    mixer_rms_eps: Optional[float] = None   # mamba1: weightless RMS norm of
                                            # Delta's input, B and C after
                                            # x_proj (Falcon-Mamba); None: off

    # --- derived -----------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        if not self.pad_vocab:
            return self.vocab
        return -(-self.vocab // 256) * 256

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dtr(self) -> int:
        return self.dt_rank if self.dt_rank else -(-self.d_model // 16)

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.mamba2_headdim

    @property
    def torch_dtype(self) -> torch.dtype:
        """The param/compute dtype (the reference's ``jdtype``)."""
        return {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}[self.dtype]

    @property
    def is_attention_free(self) -> bool:
        return self.block == "mamba1"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence handling (SSM state or hybrid decode)."""
        return self.block in ("mamba1", "mamba2_hybrid")

    @property
    def n_hybrid_invocations(self) -> int:
        if self.block != "mamba2_hybrid":
            return 0
        return self.n_layers // self.hybrid_period

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, v = self.d_model, self.vocab
        n = v * d * (1 if self.tie_embeddings else 2)
        if self.block in ("dense", "moe"):
            attn = d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd \
                + self.n_heads * self.hd * d
            gates = 2 if self.act in ("swiglu", "geglu") else 1
            if self.block == "moe":
                ffn = self.n_experts * (gates * d * self.d_ff + self.d_ff * d) \
                    + d * self.n_experts
            else:
                ffn = gates * d * self.d_ff + self.d_ff * d
            n += self.n_layers * (attn + ffn)
        elif self.block == "mamba1":
            di, ns, r = self.d_inner, self.ssm_state, self.dtr
            per = d * 2 * di + di * self.d_conv + di * (r + 2 * ns) \
                + r * di + di * ns + di + di * d
            n += self.n_layers * per
        elif self.block == "mamba2_hybrid":
            di, ns = self.d_inner, self.ssm_state
            per = d * (2 * di + 2 * ns + self.n_ssm_heads) \
                + di * self.d_conv + self.n_ssm_heads * 2 + di * d
            shared = d * self.n_heads * self.hd * 2 \
                + 2 * d * self.n_kv_heads * self.hd \
                + 3 * d * self.d_ff
            n += self.n_layers * per + shared
        elif self.block == "encdec":
            attn = 4 * d * d
            ffn = 2 * d * self.d_ff
            n += self.enc_layers * (attn + ffn) \
                + self.dec_layers * (2 * attn + ffn)
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if self.block != "moe" or self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        gates = 2 if self.act in ("swiglu", "geglu") else 1
        ffn_all = self.n_experts * (gates * d * self.d_ff + self.d_ff * d)
        ffn_act = self.top_k * (gates * d * self.d_ff + self.d_ff * d)
        return self.param_count() - self.n_layers * (ffn_all - ffn_act)
