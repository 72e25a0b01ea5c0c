"""Decoder-only LM: init / forward / loss / prefill / decode.

The port of ``src/repro/models/transformer.py``: all five LM
architectures (dense GQA: qwen2-0.5b, stablelm-1.6b/12b; MoE:
phi3.5-moe; MLA + MoE: deepseek-v2-lite) instantiate this one module
with different ``LMConfig``s.  Layer parameters keep the reference's
leading ``n_layers`` axis, so its ``init_lm`` tree crosses as it is
(``convert.lm_params_from_numpy``); the reference's ``lax.scan`` over
layers is a Python loop over that axis.  The token lookup goes through
``late_gather`` (the hand-written kernel on the card), then is cast to
``cfg.dtype``.

Port differences: ``KVCache.length`` is a Python int (the reference keeps
an int32 device scalar), which spares a host read each step; ``prefill``
and ``decode_step`` write into the cache's tensors in place and return a
``KVCache`` over the same tensors; a token in [-V, 0) counts from the
end once in both, and one outside [-V, V) gives a zero embedding row
where the reference's ``jnp.take`` fills NaN (``lm_batch`` never makes
one).

Training (:func:`make_train_step`) holds the parameters in float32 and
computes in ``cfg.dtype``, as the reference does.  With ``remat`` each
layer runs under ``torch.utils.checkpoint`` and is recomputed whole in
the backward, where the reference's ``jax.checkpoint(dots_saveable)``
keeps its matmul outputs (those would hold every attention chunk's
float32 scores); each ``loss_chunk`` of the cross-entropy is recomputed
in the backward too, so neither the (B, S, V) logits nor autograd's
copies of every chunk exist at once.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import LMConfig
from ..core.engine import resolve_device
from ..kernels.late_gather.ops import late_gather
from ..optim.tree import leaves, tree_map, unflatten, value_and_grad
from .layers import (dense_ffn, gqa_attention, init_dense_ffn, init_gqa,
                     init_mla, init_moe, mla_attention, moe_ffn, rmsnorm,
                     write_block)

__all__ = ["init_layer", "init_lm", "layer_params", "forward", "lm_loss",
           "KVCache", "init_cache", "prefill", "decode_step",
           "make_train_step"]

Params = Dict[str, Any]


def _dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(cfg: LMConfig, generator: torch.Generator, device) -> Params:
    """One layer's parameters (the reference's tree, shapes and scales) in
    float32, drawn from ``generator`` on ``device``."""
    attn = init_mla(cfg, generator, device) if cfg.mla is not None else \
        init_gqa(cfg, generator, device)
    ffn = init_moe(cfg, generator, device) if cfg.moe is not None else \
        init_dense_ffn(cfg.d_model, cfg.d_ff, generator, device)
    ones = torch.ones((cfg.d_model,), dtype=torch.float32, device=device)
    return {"attn": attn, "ffn": ffn, "ln1": ones, "ln2": ones.clone()}


def init_lm(cfg: LMConfig, generator: torch.Generator, device=None,
            dtype: torch.dtype | None = None) -> Params:
    """Random parameters with the reference's tree, shapes and scales,
    drawn in float32 from ``generator`` (which must live on ``device``;
    ``None``: the card) and held in ``dtype`` (``None``: float32).  The
    layers are drawn one at a time into stacks of leading axis
    ``n_layers``, each cast to ``dtype`` as it is drawn, so a model of
    16B parameters is built on an 80 GB card in bfloat16.  The forward
    casts every weight to ``cfg.dtype`` at use, so weights held in
    ``cfg.dtype`` give the same bits as float32-held ones."""
    device = resolve_device(device)
    dtype = dtype or torch.float32

    def held(t: torch.Tensor) -> torch.Tensor:
        return t.to(dtype)

    embed = held(torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                             device=device) * 0.02)
    layers = None
    for i in range(cfg.n_layers):
        layer = init_layer(cfg, generator, device)
        if layers is None:
            layers = tree_map(lambda t: torch.empty(
                (cfg.n_layers,) + tuple(t.shape), dtype=dtype,
                device=device), layer)
        tree_map(lambda stack, t: stack[i].copy_(t), layers, layer)
        del layer
    unembed = held(torch.randn((cfg.d_model, cfg.vocab),
                               generator=generator, device=device)
                   * cfg.d_model ** -0.5)
    return {"embed": embed, "layers": layers,
            "final_ln": held(torch.ones((cfg.d_model,), device=device)),
            "unembed": unembed}


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i`` of the stacked layer tree (views, no copy)."""
    return tree_map(lambda t: t[i], layers)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed(params: Params, tokens: torch.Tensor, cfg: LMConfig
           ) -> torch.Tensor:
    b, s = tokens.shape
    rows = late_gather(params["embed"],
                       tokens.reshape(-1).to(torch.int32).contiguous())
    return rows.reshape(b, s, cfg.d_model).to(_dtype(cfg))


def _layer_fwd(lp: Params, x: torch.Tensor, cfg: LMConfig,
               positions: torch.Tensor, cache=None):
    attn_fn = mla_attention if cfg.mla is not None else gqa_attention
    a, new_cache = attn_fn(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                           cfg, positions=positions, cache=cache)
    h = x + a
    z = rmsnorm(h, lp["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        f, aux = moe_ffn(lp["ffn"], z, cfg)
    else:
        f = dense_ffn(lp["ffn"], z)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return h + f, aux, new_cache


def _unstack(layers: Params, n: int) -> list:
    """The ``n`` layers of the stacked layer tree as trees of views, one
    ``unbind`` a leaf (whose gradient is one stack, not n scatters)."""
    cols = [t.unbind(0) for t in leaves(layers)]
    return [unflatten(layers, [c[i] for c in cols]) for i in range(n)]


def _recording(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def forward(params: Params, tokens: torch.Tensor, cfg: LMConfig, *,
            remat: bool | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> final hidden states (B, S, D) + total aux loss.
    ``remat`` (``None``: ``cfg.remat``) recomputes each layer in the
    backward (``torch.utils.checkpoint``), where autograd records; the
    values are the same either way."""
    remat = cfg.remat if remat is None else remat
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(s, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(lp, x):
        y, a, _ = _layer_fwd(lp, x, cfg, positions)
        return y, a

    for lp in _unstack(params["layers"], cfg.n_layers):
        if remat and _recording(x):
            x, a = checkpoint(body, lp, x, use_reentrant=False)
        else:
            x, a = body(lp, x)
        aux = aux + a
    return rmsnorm(x, params["final_ln"], cfg.norm_eps), aux


def _chunk_xent(hx: torch.Tensor, w: torch.Tensor, lx: torch.Tensor
                ) -> torch.Tensor:
    """Sum over one chunk of (B, ck) positions of logsumexp - gold logit,
    the logits float32 from ``hx @ w`` in ``hx``'s dtype."""
    logits = (hx @ w.to(hx.dtype)).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lx[..., None])[..., 0]
    return torch.sum(lse - gold)


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: LMConfig
            ) -> tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunked cross-entropy: the (B, S, V) logits tensor never fully
    materializes — the unembed + softmax runs per sequence chunk, and,
    where autograd records, again per chunk in the backward."""
    h, aux = forward(params, batch["tokens"], cfg)
    b, s, d = h.shape
    ck = min(cfg.loss_chunk, s)
    n = s // ck
    hc = h.reshape(b, n, ck, d)
    lc = batch["labels"].reshape(b, n, ck).long()
    w = params["unembed"]
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        args = (hc[:, i], w, lc[:, i])
        tot = tot + (checkpoint(_chunk_xent, *args, use_reentrant=False)
                     if _recording(h) else _chunk_xent(*args))
    xent = tot / (b * s)
    return xent + aux, {"xent": xent, "aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Position-addressed cache.  GQA: a=(L,B,Smax,Hkv,hd) keys, b=values.
    MLA: a=(L,B,Smax,kv_lora) latents, b=(L,B,Smax,rope_dim) rope keys.
    ``length`` is the number of positions written (a Python int)."""

    a: torch.Tensor
    b: torch.Tensor
    length: int


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device=None) -> KVCache:
    """An empty cache of ``max_len`` positions in ``dtype`` (``None``:
    ``cfg.dtype``) on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    dt = dtype or _dtype(cfg)
    if cfg.mla is not None:
        shape_a = (cfg.n_layers, batch, max_len, cfg.mla.kv_lora_rank)
        shape_b = (cfg.n_layers, batch, max_len, cfg.mla.rope_head_dim)
    else:
        shape_a = shape_b = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
                             cfg.head_dim)
    return KVCache(torch.zeros(shape_a, dtype=dt, device=device),
                   torch.zeros(shape_b, dtype=dt, device=device), 0)


def _block_fwd(params: Params, tokens: torch.Tensor, cfg: LMConfig,
               cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """Run a token block through all layers against the cache (prefill,
    block size S, and decode, block size 1).

    Prefill (S > 1) runs the STREAMING attention path (chunked
    online-softmax / q-blocked triangular, as the forward) and then
    writes the fresh K/V (or MLA latents) into the cache; under
    ``cfg.prefill_via_cache`` it attends against the padded cache
    instead, as a decode block does."""
    b, s = tokens.shape
    cur = cache.length
    x = _embed(params, tokens, cfg)
    positions = cur + torch.arange(s, device=x.device)
    streaming_prefill = s > 1 and not cfg.prefill_via_cache
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        ca, cb = cache.a[i], cache.b[i]
        if streaming_prefill:               # fresh-context attention
            x, _, (fa, fb) = _layer_fwd(lp, x, cfg, positions)
            write_block(ca, fa, cur)
            write_block(cb, fb, cur)
        else:
            x, _, _ = _layer_fwd(lp, x, cfg, positions, cache=(ca, cb, cur))
    h = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    logits = (h[:, -1] @ params["unembed"].to(_dtype(cfg))).to(torch.float32)
    return logits, KVCache(cache.a, cache.b, cur + s)


def prefill(params: Params, tokens: torch.Tensor, cfg: LMConfig,
            max_len: int | None = None) -> tuple[torch.Tensor, KVCache]:
    """tokens (B, S) -> (last-token logits (B, V) float32, filled cache of
    ``max_len`` positions, ``None``: S), on the tokens' device."""
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len or s, device=tokens.device)
    return _block_fwd(params, tokens, cfg, cache)


def decode_step(params: Params, tokens: torch.Tensor, cache: KVCache,
                cfg: LMConfig) -> tuple[torch.Tensor, KVCache]:
    """One new token per sequence: tokens (B,) + cache -> logits (B, V);
    the cache's tensors are written in place."""
    return _block_fwd(params, tokens[:, None], cfg, cache)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def make_train_step(cfg: LMConfig, optimizer):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``lm_loss``'s value and gradient (``batch`` holds
    ``tokens`` and ``labels``, (B, S) integers on the parameters'
    device), then one ``optimizer.update``; ``metrics`` holds ``loss``,
    ``grad_norm``, ``xent`` and ``aux``, detached tensors."""

    def step(params, opt_state, batch):
        (loss, parts), grads = value_and_grad(lm_loss, params, batch, cfg,
                                              has_aux=True)
        params, opt_state, gnorm = optimizer.update(params, grads, opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, **parts}

    return step
