"""Configuration dataclasses, copied from the reference's
``src/repro/configs/base.py`` (the port keeps its own copy): the
language models' (``LMConfig`` with its ``MoEConfig`` and ``MLAConfig``),
the recommender's, the GNNs' and the paper's own BFS deployment's."""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0
    d_expert: int = 0            # per-expert FFN width
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Decoder-only LM (dense or MoE, GQA or MLA attention)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None            # default d_model // n_heads
    qkv_bias: bool = False               # qwen2-style
    rope_theta: float = 10000.0
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    norm_eps: float = 1e-6
    attn_chunk: int = 1024               # online-softmax KV chunk
    loss_chunk: int = 512                # chunked unembed+xent
    attn_window: int | None = None       # sliding window (500k extra only)
    dtype: str = "bfloat16"
    unroll: bool = False                 # the reference's scan unrolling
                                         # (its dry-run); the port's loops
                                         # are Python loops either way
    # --- perf levers (the reference's defaults = paper-faithful
    # baseline) -----------------------------------------------------------
    attn_q_block: int | None = None      # q-blocked triangular prefill
    remat: bool = True                   # activation checkpointing
    moe_shard_axis: str | None = None    # explicit expert-parallel
                                         # sharding constraints (the
                                         # port raises: ROADMAP item 11)
    moe_data_axes: str | None = None     # comma list, e.g. "data" or
                                         # "pod,data": token-row sharding
                                         # for the staged EP dispatch
    prefill_via_cache: bool = False      # legacy prefill path: attend
                                         # against the padded cache
                                         # instead of the streaming
                                         # fresh-context path

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def param_count(self) -> int:
        d, hd = self.d_model, self.head_dim
        if self.mla is not None:
            m = self.mla
            attn = (d * self.n_heads * (m.nope_head_dim + m.rope_head_dim)
                    + d * m.kv_lora_rank + d * m.rope_head_dim
                    + m.kv_lora_rank * self.n_heads *
                    (m.nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
        if self.moe is not None:
            e = self.moe
            ff = e.num_experts * 3 * d * e.d_expert + d * e.num_experts
            ff += 3 * d * (e.num_shared * e.d_expert)
        else:
            ff = 3 * d * self.d_ff
        return self.n_layers * (attn + ff) + 2 * d * self.vocab

    def active_param_count(self) -> int:
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        e = self.moe
        if self.mla is not None:
            m = self.mla
            attn = (d * self.n_heads * (m.nope_head_dim + m.rope_head_dim)
                    + d * m.kv_lora_rank + d * m.rope_head_dim
                    + m.kv_lora_rank * self.n_heads *
                    (m.nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        else:
            hd = self.head_dim
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
        ff_active = (e.top_k + e.num_shared) * 3 * d * e.d_expert \
            + d * e.num_experts
        return self.n_layers * (attn + ff_active) + 2 * d * self.vocab


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 10
    mlp_dims: Sequence[int] = (400, 400, 400)
    vocab_scale: float = 1.0             # scales the Criteo vocabularies
    dtype: str = "float32"
    table_dtype: str = "float32"         # or "bfloat16"


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: Literal["gatedgcn", "graphsage", "egnn", "gat"]
    n_layers: int
    d_hidden: int
    n_heads: int = 1
    d_feat: int = 128
    num_classes: int = 16
    sample_sizes: Sequence[int] = ()     # graphsage fanouts
    aggregator: str = "mean"
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class BFSConfig:
    """The paper's own workload as an arch (engine + dataset shape)."""

    name: str
    engine: str = "precursive"
    num_vertices: int = 1 << 20
    payload_cols: int = 8
    max_depth: int = 16
    frontier_cap: int = 1 << 16
    result_cap: int = 1 << 20
