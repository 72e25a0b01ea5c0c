"""Transformer building blocks: RMSNorm, RoPE, chunked (online-softmax)
attention for GQA and MLA, SwiGLU, and the positional MoE dispatch.

The port of ``src/repro/models/layers.py``.  Everything is a plain
function over a dict of tensors with the reference's keys and shapes;
the reference's per-use ``.astype(dt)`` casts stay, so weights held in
float32 or in the compute dtype give the same bits.  Attention, norms
and GEMMs are plain PyTorch, as they are plain ``jnp`` in the reference.

The MoE dispatch is built on the paper's positional discipline
(:func:`repro_torch.core.positions.sort_positions_by_key`): token
*positions* are sorted by expert id, activations are gathered once into
per-expert contiguous blocks and scattered back once.  Both gathers go
through ``late_gather`` (the hand-written kernel on the card): the
dispatch's empty slots hold the sentinel ``T`` and the combine's dropped
choices the sentinel ``E * cap``, each a zero row.

Port differences: a KV cache is written in place (the reference's
``dynamic_update_slice`` returns a new array); a block written past the
cache's end lands at ``Smax - s``, as ``dynamic_update_slice`` clamps it.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import LMConfig, MLAConfig, MoEConfig
from ..core.positions import sort_positions_by_key
from ..kernels.late_gather.ops import late_gather

__all__ = ["rmsnorm", "rope_angles", "apply_rope", "swiglu",
           "chunked_attention", "blocked_causal_attention", "init_gqa",
           "gqa_project_qkv", "gqa_attention", "init_mla", "mla_compress",
           "mla_attention", "init_dense_ffn", "dense_ffn", "init_moe",
           "moe_capacity", "MoERoute", "moe_route", "moe_ffn",
           "write_block"]

Params = Dict[str, Any]
NEG = -1e30                     # the mask's score, as the reference's
MASK_AT_ONCE = 1 << 22          # queries x keys under which attention
#                                 masks every chunk at once


def _normal(g: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float32)


def write_block(cache: torch.Tensor, block: torch.Tensor, start: int
                ) -> None:
    """Write ``block`` (B, s, ...) into ``cache`` (B, Smax, ...) along
    axis 1 at ``start``, in place, clamped as ``dynamic_update_slice``
    clamps it: a block that would run past the end lands at Smax - s."""
    s = block.shape[1]
    start = min(max(int(start), 0), cache.shape[1] - s)
    cache[:, start:start + s] = block.to(cache.dtype)


# ---------------------------------------------------------------------------
# norms / rope / basic ops
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(dt)


def rope_angles(positions: torch.Tensor, dim: int, theta: float
                ) -> torch.Tensor:
    """(..., ) int positions -> (..., dim//2) float32 angles."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    return positions.to(torch.float32)[..., None] * inv


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, n, d) with d even; positions: (..., S)."""
    d = x.shape[-1]
    ang = rope_angles(positions, d, theta)                 # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w1) * (x @ w3)
    return h @ w2


# ---------------------------------------------------------------------------
# chunked online-softmax attention
# ---------------------------------------------------------------------------

def _masked(q_pos: torch.Tensor, k_pos: torch.Tensor, kv_len: int,
            causal: bool, window: int | None) -> torch.Tensor:
    """(Sq or 1, C) bool: the (query, key) pairs attention leaves out."""
    valid = (k_pos < kv_len)[None, :]
    if causal:
        valid = valid & (q_pos[:, None] >= k_pos[None, :])
    if window is not None:
        valid = valid & (q_pos[:, None] - k_pos[None, :] < window)
    return ~valid


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk: int, q_start: int, kv_len: int,
                      window: int | None = None) -> torch.Tensor:
    """Online-softmax attention, a loop over KV chunks.

    q: (B, Hkv, G, Sq, dk) — query heads grouped over their KV head
    k: (B, Hkv, Skv, dk);  v: (B, Hkv, Skv, dv)
    q_start: absolute position of q[..., 0, :] (decode offset)
    kv_len: number of valid KV positions (the cache may be padded)

    Scores are float32 (q, k and v upcast), a masked score is -1e30, and
    the softmax's sum is floored at 1e-30, as in the reference.  K/V are
    padded to a multiple of ``chunk`` and upcast once; each chunk is a
    slice of them, so no chunk-major copy of the cache is made.  Peak
    memory is O(Sq * chunk) per head beside the float32 K/V.

    Where autograd records (grad on and q, k or v requiring it), each
    chunk's scores are computed out of place, and the running max is held
    as a constant: the output does not depend on it, so its gradient is
    zero and autograd keeps one float32 (Sq, chunk) tensor a chunk, the
    probabilities.  Otherwise the scores are updated in place, the same
    values with no copy."""
    b, hkv, g, sq, dk = q.shape
    skv = k.shape[2]
    dv = v.shape[-1]
    scale = dk ** -0.5
    pad = (-skv) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    n_chunks = (skv + pad) // chunk
    dev = q.device
    q32, k32, v32 = (t.to(torch.float32) for t in (q, k, v))
    q_pos = q_start + torch.arange(sq, device=dev)                # (Sq,)
    # a few queries (a decode step): every chunk's mask at once
    masked = _masked(q_pos, torch.arange(skv + pad, device=dev), kv_len,
                     causal, window) if sq * (skv + pad) <= MASK_AT_ONCE \
        else None
    m = torch.full((b, hkv, g, sq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=torch.float32, device=dev)
    recorded = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    for i in range(n_chunks):
        c0 = i * chunk
        s = torch.einsum("bhgqd,bhcd->bhgqc", q32, k32[:, :, c0:c0 + chunk])
        cut = masked[:, c0:c0 + chunk] if masked is not None else \
            _masked(q_pos, c0 + torch.arange(chunk, device=dev), kv_len,
                    causal, window)
        if recorded:
            s = (s * scale).masked_fill(cut, NEG)
            m_new = torch.maximum(m, s.detach().amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
        else:
            s.mul_(scale)
            s.masked_fill_(cut, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = s.sub_(m_new[..., None]).exp_()
        corr = torch.exp(m - m_new)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqc,bhcd->bhgqd", p, v32[:, :, c0:c0 + chunk])
        l = l * corr + p.sum(dim=-1)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def blocked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, q_block: int, chunk: int,
                             window: int | None = None) -> torch.Tensor:
    """Flash-structured self-attention: queries processed in blocks, each
    over only its causal KV *prefix* (no fully masked chunk above the
    diagonal), each block's online-softmax carry (q_block, dv)."""
    b, hkv, g, sq, dk = q.shape
    nqb = -(-sq // q_block)
    outs = []
    for i in range(nqb):
        q0, q1 = i * q_block, min((i + 1) * q_block, sq)
        kv_end = q1                                # causal prefix only
        outs.append(chunked_attention(
            q[:, :, :, q0:q1], k[:, :, :kv_end], v[:, :, :kv_end],
            causal=True, chunk=min(chunk, kv_end), q_start=q0,
            kv_len=kv_end, window=window))
    return torch.cat(outs, dim=3)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def init_gqa(cfg: LMConfig, g: torch.Generator, device) -> Params:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = d ** -0.5
    p = {
        "wq": _normal(g, (d, h * hd), device) * s,
        "wk": _normal(g, (d, hkv * hd), device) * s,
        "wv": _normal(g, (d, hkv * hd), device) * s,
        "wo": _normal(g, (h * hd, d), device) * s,
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            p[name] = torch.zeros((width,), dtype=torch.float32,
                                  device=device)
    return p


def gqa_project_qkv(p: Params, x: torch.Tensor, cfg: LMConfig,
                    positions: torch.Tensor):
    b, s, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(p: Params, x: torch.Tensor, cfg: LMConfig, *,
                  positions: torch.Tensor, cache=None):
    """Self-attention.  ``cache=None`` -> prefill over x itself, returning
    the fresh (k, v); ``cache=(k_cache, v_cache, cur_len)`` -> decode: the
    new block's K/V are written into the caches at ``cur_len`` (in place)
    and attention runs over the whole cache."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // hkv
    q, k, v = gqa_project_qkv(p, x, cfg, positions)
    if cache is not None:
        kc, vc, cur = cache                          # (B, Smax, Hkv, hd)
        write_block(kc, k, cur)
        write_block(vc, v, cur)
        k_full, v_full, kv_n, q_start = kc, vc, cur + s, cur
        new_cache = (kc, vc)
    else:
        k_full, v_full, kv_n, q_start = k, v, s, 0
        new_cache = (k, v)
    qg = q.reshape(b, s, hkv, g, hd).permute(0, 2, 3, 1, 4)
    kt = k_full.transpose(1, 2)
    vt = v_full.transpose(1, 2)
    if cache is None and cfg.attn_q_block is not None:
        out = blocked_causal_attention(qg, kt, vt, q_block=cfg.attn_q_block,
                                       chunk=cfg.attn_chunk,
                                       window=cfg.attn_window)
    else:
        out = chunked_attention(qg, kt, vt, causal=True,
                                chunk=cfg.attn_chunk, q_start=q_start,
                                kv_len=kv_n, window=cfg.attn_window)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h * hd)
    return out @ p["wo"].to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2 family)
# ---------------------------------------------------------------------------

def init_mla(cfg: LMConfig, g: torch.Generator, device) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    s = d ** -0.5
    r = m.kv_lora_rank ** -0.5
    return {
        "wq": _normal(g, (d, h * (m.nope_head_dim + m.rope_head_dim)),
                      device) * s,
        "w_dkv": _normal(g, (d, m.kv_lora_rank), device) * s,
        "w_kr": _normal(g, (d, m.rope_head_dim), device) * s,
        "w_uk": _normal(g, (m.kv_lora_rank, h * m.nope_head_dim),
                        device) * r,
        "w_uv": _normal(g, (m.kv_lora_rank, h * m.v_head_dim), device) * r,
        "wo": _normal(g, (h * m.v_head_dim, d), device) * s,
    }


def mla_compress(p: Params, x: torch.Tensor, cfg: LMConfig,
                 positions: torch.Tensor):
    """x -> (c_kv, k_rope): the ONLY tensors the MLA decode cache stores."""
    dt = x.dtype
    c = x @ p["w_dkv"].to(dt)                            # (B,S,kvr)
    kr = (x @ p["w_kr"].to(dt))[:, :, None, :]           # (B,S,1,dr)
    kr = apply_rope(kr, positions, cfg.rope_theta)[:, :, 0]
    return c, kr


def mla_attention(p: Params, x: torch.Tensor, cfg: LMConfig, *,
                  positions: torch.Tensor, cache=None):
    """MLA.  ``cache=None``: prefill, decompress the latents and run MHA.
    With ``cache=(c_cache, kr_cache, cur_len)`` the *absorbed* decode path:
    the new block's latents are written into the caches at ``cur_len`` (in
    place) and scores and values are computed in the latent (kv_lora)
    space — q folded through W_uk and the output through W_uv, so the
    cache stays (kv_lora + rope_dim) per position."""
    b, s, d = x.shape
    m: MLAConfig = cfg.mla
    h = cfg.n_heads
    dn, dr, dv, r = m.nope_head_dim, m.rope_head_dim, m.v_head_dim, \
        m.kv_lora_rank
    dt = x.dtype

    q = (x @ p["wq"].to(dt)).reshape(b, s, h, dn + dr)
    qn, qr = q[..., :dn], q[..., dn:]
    qr = apply_rope(qr, positions, cfg.rope_theta)

    c_new, kr_new = mla_compress(p, x, cfg, positions)

    if cache is None:
        # prefill: decompress and run standard MHA
        kn = (c_new @ p["w_uk"].to(dt)).reshape(b, s, h, dn)
        v = (c_new @ p["w_uv"].to(dt)).reshape(b, s, h, dv)
        kfull = torch.cat([kn, kr_new[:, :, None, :].expand(b, s, h, dr)],
                          dim=-1)
        qfull = torch.cat([qn, qr], dim=-1)
        qg = qfull.reshape(b, s, h, 1, dn + dr).permute(0, 2, 3, 1, 4)
        kt, vt = kfull.transpose(1, 2), v.transpose(1, 2)
        if cfg.attn_q_block is not None:
            out = blocked_causal_attention(
                qg, kt, vt, q_block=cfg.attn_q_block, chunk=cfg.attn_chunk,
                window=cfg.attn_window)
        else:
            out = chunked_attention(qg, kt, vt, causal=True,
                                    chunk=cfg.attn_chunk, q_start=0,
                                    kv_len=s, window=cfg.attn_window)
        out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h * dv)
        new_cache = (c_new, kr_new)
    else:
        # absorbed decode: scores in latent space against the c/kr cache
        cc, krc, cur = cache
        write_block(cc, c_new, cur)
        write_block(krc, kr_new, cur)
        kv_len = cur + s
        smax = cc.shape[1]
        w_uk = p["w_uk"].to(dt).reshape(r, h, dn)
        q_lat = torch.einsum("bshn,rhn->bshr", qn, w_uk)  # fold W_uk into q
        scale = (dn + dr) ** -0.5
        s_lat = torch.einsum("bshr,btr->bhst", q_lat, cc)
        s_rot = torch.einsum("bshd,btd->bhst", qr, krc)
        scores = (s_lat + s_rot).to(torch.float32) * scale
        t_pos = torch.arange(smax, device=x.device)
        q_pos = cur + torch.arange(s, device=x.device)
        mask = (t_pos[None, :] < kv_len) & (q_pos[:, None] >= t_pos[None, :])
        if cfg.attn_window is not None:
            mask = mask & (q_pos[:, None] - t_pos[None, :] < cfg.attn_window)
        scores = scores.masked_fill_(~mask, NEG)
        pattn = torch.softmax(scores, dim=-1).to(dt)
        o_lat = torch.einsum("bhst,btr->bshr", pattn, cc)   # latent output
        w_uv = p["w_uv"].to(dt).reshape(r, h, dv)
        out = torch.einsum("bshr,rhv->bshv", o_lat, w_uv).reshape(b, s,
                                                                  h * dv)
        new_cache = (cc, krc)

    return out @ p["wo"].to(dt), new_cache


# ---------------------------------------------------------------------------
# dense + MoE FFN
# ---------------------------------------------------------------------------

def init_dense_ffn(d: int, f: int, g: torch.Generator, device) -> Params:
    return {"w1": _normal(g, (d, f), device) * d ** -0.5,
            "w3": _normal(g, (d, f), device) * d ** -0.5,
            "w2": _normal(g, (f, d), device) * f ** -0.5}


def dense_ffn(p: Params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    return swiglu(x, p["w1"].to(dt), p["w3"].to(dt), p["w2"].to(dt))


def init_moe(cfg: LMConfig, g: torch.Generator, device) -> Params:
    e: MoEConfig = cfg.moe
    d, f = cfg.d_model, e.d_expert
    p = {
        "router": _normal(g, (d, e.num_experts), device) * d ** -0.5,
        "w1": _normal(g, (e.num_experts, d, f), device) * d ** -0.5,
        "w3": _normal(g, (e.num_experts, d, f), device) * d ** -0.5,
        "w2": _normal(g, (e.num_experts, f, d), device) * f ** -0.5,
    }
    if e.num_shared:
        p["shared"] = init_dense_ffn(d, e.num_shared * f, g, device)
    return p


def moe_capacity(e: MoEConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens: the reference's formula, rounded
    up to a multiple of 8, at least 8."""
    cap = int(e.capacity_factor * t * e.top_k / e.num_experts + 1)
    return max(8, -(-cap // 8) * 8)


class MoERoute(NamedTuple):
    """The positional routing of ``t`` tokens over ``n_e`` experts of
    ``cap`` slots each, ``k`` choices a token (T·k of them, sorted by
    expert)."""

    probs: torch.Tensor      # (T, E) float32 router softmax
    order: torch.Tensor      # (T·k,) int32 choice positions by expert
    counts: torch.Tensor     # (E,) int32 choices per expert, kept or not
    keep: torch.Tensor       # (T·k,) bool, the choice fits its expert
    slot: torch.Tensor       # (T·k,) int32 expert slot, E·cap if dropped
    token_of: torch.Tensor   # (T·k,) int32 the choice's token
    gate: torch.Tensor       # (T·k,) gate in the compute dtype
    dispatch: torch.Tensor   # (E·cap,) int32 the slot's token, T if empty
    cap: int


def _top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, a tie to the lower index (as
    ``jax.lax.top_k``): a stable descending sort, not ``torch.topk``."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return torch.gather(probs, -1, idx), idx


def moe_route(p: Params, xt: torch.Tensor, cfg: LMConfig) -> MoERoute:
    """Route the (T, D) tokens ``xt``: router softmax, top-k, positions
    sorted by expert (``sort_positions_by_key``), each choice's rank in
    its expert, its slot (kept while the rank is under ``cap``) and the
    slots' tokens."""
    e: MoEConfig = cfg.moe
    t = xt.shape[0]
    k, n_e = e.top_k, e.num_experts
    cap = moe_capacity(e, t)
    dt = xt.dtype
    dev = xt.device
    logits = (xt @ p["router"].to(dt)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = _top_k(probs, k)                    # (T, k)
    gates = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    flat_e = topi.reshape(t * k).to(torch.int32)
    order, counts = sort_positions_by_key(flat_e, n_e)     # paper primitive
    order_l = order.long()
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    sorted_e = flat_e[order_l]
    rank = torch.arange(t * k, dtype=torch.int32, device=dev) \
        - starts[sorted_e.long()]
    keep = rank < cap
    slot = torch.where(keep, sorted_e * cap + rank,
                       torch.full_like(rank, n_e * cap))
    token_of = torch.div(order, k, rounding_mode="floor").to(torch.int32)
    # slot E·cap is the spare of the dropped choices, cut off after
    dispatch = torch.full((n_e * cap + 1,), t, dtype=torch.int32,
                          device=dev)
    dispatch[slot.long()] = torch.where(keep, token_of,
                                        torch.full_like(token_of, t))
    gate = gates.reshape(t * k)[order_l].to(dt)
    return MoERoute(probs, order, counts, keep, slot, token_of, gate,
                    dispatch[:n_e * cap], cap)


def moe_ffn(p: Params, x: torch.Tensor, cfg: LMConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Positional top-k MoE.  Returns (output, aux_loss).

    Dispatch = the paper's positional discipline: positions sorted by
    expert, ONE ``late_gather`` into (E, cap, D) contiguous expert blocks
    (an empty slot's sentinel T gives a zero row), batched expert GEMMs,
    ONE ``late_gather`` of each choice's expert row (a dropped choice's
    sentinel E·cap gives a zero row) and ONE gate-weighted scatter-add
    back into the tokens.
    """
    if cfg.moe_shard_axis is not None:
        raise NotImplementedError(
            "moe_shard_axis: the staged expert-parallel dispatch needs a "
            "device mesh and comes with ROADMAP item 11 (multi-device)")
    e: MoEConfig = cfg.moe
    b, s, d = x.shape
    t = b * s
    n_e = e.num_experts
    dt = x.dtype

    xt = x.reshape(t, d).contiguous()
    route = moe_route(p, xt, cfg)
    cap = route.cap
    xg = late_gather(xt, route.dispatch).reshape(n_e, cap, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", xg, p["w1"].to(dt))) * \
        torch.einsum("ecd,edf->ecf", xg, p["w3"].to(dt))
    y = torch.einsum("ecf,efd->ecd", h, p["w2"].to(dt)).reshape(
        n_e * cap, d).contiguous()
    y_rows = late_gather(y, route.slot)
    zero = torch.zeros((), dtype=dt, device=x.device)
    rows = y_rows * torch.where(route.keep, route.gate, zero)[:, None]
    # row T is the spare of the dropped choices, cut off after
    dest = torch.where(route.keep, route.token_of,
                       torch.full_like(route.token_of, t)).long()
    out = torch.zeros((t + 1, d), dtype=dt, device=x.device).index_add_(
        0, dest, rows)[:t]

    if e.num_shared:
        out = out + dense_ffn(p["shared"], xt)

    # GShard/Switch load-balance auxiliary: every choice counts, kept or not
    frac = route.counts.to(torch.float32) / max(t * e.top_k, 1)
    pmean = route.probs.mean(dim=0)
    aux = n_e * torch.sum(frac * pmean) * e.router_aux_weight
    return out.reshape(b, s, d), aux
