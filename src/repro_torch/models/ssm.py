"""Mamba2 block (SSD, state-space duality; arXiv:2405.21060).

Counterpart of `repro.models.ssm`. The chunked SSD scan splits the sequence
into chunks of length Q: inside a chunk the output is a masked,
attention-like product; across chunks a small (B, H, P, N) f32 state is
carried by a loop over the chunks. Decode is the recurrent view: one state
update per token, plus the depthwise conv's rolling window of its last
W - 1 inputs (`SSMState.conv`).

The states' dtypes follow the JAX package: prefill returns them in the
COMPUTE dtype, whatever dtype the cache was made in; decode updates the
recurrent state in f32 and casts it back to the dtype it came in.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, conv_dim, W-1) rolling conv inputs
    ssm: torch.Tensor    # (B, H, P, N) recurrent state


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    n_heads = d_in // s.headdim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, n_heads, conv_dim


def init_mamba(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    s, d_in, n_heads, conv_dim = _dims(cfg)
    d = cfg.d_model
    in_dim = 2 * d_in + 2 * s.n_groups * s.d_state + n_heads  # z, xBC, dt
    u = torch.rand((n_heads,), generator=gen, dtype=torch.float32,
                   device=device)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    return {
        "in_proj": layers.truncated_normal(gen, (d, in_dim), d ** -0.5,
                                           device),
        "conv_w": layers.truncated_normal(gen, (s.conv_width, conv_dim),
                                          s.conv_width ** -0.5, device),
        "conv_b": torch.zeros((conv_dim,), dtype=torch.float32,
                              device=device),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),       # inverse softplus
        "a_log": torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32,
                                        device=device)),
        "d_skip": torch.ones((n_heads,), dtype=torch.float32, device=device),
        "norm": layers.init_rmsnorm(d_in, device),
        "out_proj": layers.truncated_normal(gen, (d_in, d), d_in ** -0.5,
                                            device),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., q) -> (..., q, q) lower-triangular segment sums:
    out[i, j] = sum(a[j+1 : i+1]) for i >= j, -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(q, device=a.device)
    return torch.where(i[:, None] >= i[None, :], d, float("-inf"))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. x (B, L, C); w (W, C). Returns
    (y (B, L, C), new conv state (B, C, W-1))."""
    width, length = w.shape[0], x.shape[1]
    xt = x.transpose(1, 2)                              # (B, C, L)
    if state is None:
        pad = torch.zeros(xt.shape[:2] + (width - 1,), dtype=xt.dtype,
                          device=xt.device)
    else:
        pad = state.to(xt.dtype)
    xp = torch.cat([pad, xt], dim=-1)                   # (B, C, L+W-1)
    wt = w.to(xt.dtype)
    y = xp[:, :, :length] * wt[0][None, :, None]
    for i in range(1, width):
        y = y + xp[:, :, i:i + length] * wt[i][None, :, None]
    y = y + b[None, :, None].to(xt.dtype)
    return y.transpose(1, 2), xp[:, :, -(width - 1):]


def ssd_chunked(x: torch.Tensor, a_dt: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. x (B, L, H, P); a_dt (B, L, H) (= dt * A, negative); b, c
    (B, L, G, N), broadcast over the heads of a group. Returns (y like x,
    the final (B, H, P, N) f32 state)."""
    bsz, length, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    reps = h // g
    nc = length // chunk
    if nc * chunk != length:
        raise ValueError(f"length {length} is not a multiple of {chunk}")
    f32 = torch.float32
    xb = x.reshape(bsz, nc, chunk, h, p)
    ab = a_dt.reshape(bsz, nc, chunk, h)
    bb = b.reshape(bsz, nc, chunk, g, n).repeat_interleave(reps, dim=3)
    cb = c.reshape(bsz, nc, chunk, g, n).repeat_interleave(reps, dim=3)

    a_cum = torch.cumsum(ab, dim=2)                     # (B, nc, Q, H) f32
    # Inside each chunk: the attention-like term.
    lmat = torch.exp(_segsum(ab.transpose(2, 3)))       # (B, nc, H, Q, Q)
    scores = torch.einsum("bcqhn,bcshn->bchqs", cb, bb)
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", scores.to(f32) * lmat,
                          xb.to(f32))
    # Each chunk's end state (f32: the recurrent state is precision-bound).
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)   # (B, nc, Q, H)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", bb.to(f32),
                          decay_states, xb.to(f32))
    # Across chunks: the small state, carried chunk by chunk.
    chunk_decay = torch.exp(a_cum[:, :, -1, :])         # (B, nc, H)
    s = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
         if initial_state is None else initial_state.to(f32))
    prev = []
    for i in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)              # (B, nc, H, P, N)
    # Earlier chunks' contribution, decayed to each position.
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", cb.to(f32), prev_states,
                         torch.exp(a_cum))
    y = (y_diag + y_off).to(x.dtype).reshape(bsz, length, h, p)
    return y, s


def mamba_block(params: dict, x: torch.Tensor, *, cfg: ModelConfig,
                state: Optional[SSMState] = None, norm_mean=None
                ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """The whole Mamba2 block. x (B, L, D) -> (y (B, L, D), state). L > 1
    is the chunked view (training, prefill; `state`, if given, seeds the
    recurrence); L == 1 is one recurrent decode step (from a zero state
    when none is given). `norm_mean` is the gated norm's mean of squares
    where `cfg` is one rank's share of the inner width
    (`layers.rmsnorm`'s `mean`)."""
    s, d_in, n_heads, conv_dim = _dims(cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    f32 = torch.float32
    bsz, length, _ = x.shape
    zxbcdt = x @ params["in_proj"].to(cdt)
    z, xbc, dt = torch.split(zxbcdt, [d_in, conv_dim, n_heads], dim=-1)
    dt = F.softplus(dt.to(f32) + params["dt_bias"])
    a = -torch.exp(params["a_log"])                     # (H,) negative
    ng = s.n_groups * s.d_state

    if length > 1:
        xbc, conv_state = _causal_conv(xbc, params["conv_w"],
                                       params["conv_b"],
                                       None if state is None else state.conv)
        xbc = F.silu(xbc.to(f32)).to(cdt)
        xs, b, c = torch.split(xbc, [d_in, ng, ng], dim=-1)
        xs = xs.reshape(bsz, length, n_heads, s.headdim)
        b = b.reshape(bsz, length, s.n_groups, s.d_state)
        c = c.reshape(bsz, length, s.n_groups, s.d_state)
        # Pad L to a chunk multiple; the padded steps carry dt = 0, so a
        # decay of 1 and no state injection: y[:, :L] and the final state
        # are exact.
        chunk = min(s.chunk, length)
        pad = (-length) % chunk
        if pad:
            xs, b, c = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xs, b, c))
            dt = F.pad(dt, (0, 0, 0, pad))
        a_dt = (dt * a[None, None, :]).to(f32)
        y, final = ssd_chunked(xs * dt.to(cdt)[..., None], a_dt, b, c, chunk,
                               initial_state=(None if state is None
                                              else state.ssm))
        if pad:
            y, xs = y[:, :length], xs[:, :length]
        y = y + xs * params["d_skip"].to(cdt)[None, None, :, None]
        y = layers.gated_rmsnorm(params["norm"], y.reshape(bsz, length, d_in),
                                 z, cfg.rms_eps, norm_mean)
        out = y @ params["out_proj"].to(cdt)
        return out, SSMState(conv=conv_state.to(cdt), ssm=final.to(cdt))

    # The recurrent single step (decode).
    if state is None:
        state = init_ssm_state(cfg, bsz, cdt, device=x.device)
    conv_in = torch.cat([state.conv.to(cdt), xbc[:, 0, :, None]],
                        dim=-1)                          # (B, C, W)
    conv_out = (torch.einsum("bcw,wc->bc", conv_in, params["conv_w"].to(cdt))
                + params["conv_b"].to(cdt))
    conv_out = F.silu(conv_out.to(f32)).to(cdt)
    xs, b, c = torch.split(conv_out, [d_in, ng, ng], dim=-1)
    xs = xs.reshape(bsz, n_heads, s.headdim)
    reps = n_heads // s.n_groups
    bh = b.reshape(bsz, s.n_groups, s.d_state).repeat_interleave(reps, dim=1)
    ch = c.reshape(bsz, s.n_groups, s.d_state).repeat_interleave(reps, dim=1)
    dt0 = dt[:, 0]                                      # (B, H) f32
    da = torch.exp(dt0 * a[None, :])
    # The state recurrence runs in f32, as the chunked view carries it.
    upd = torch.einsum("bhp,bhn->bhpn", xs.to(f32) * dt0[..., None],
                       bh.to(f32))
    new_ssm = state.ssm.to(f32) * da[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_ssm, ch.to(f32)).to(cdt)
    y = y + xs * params["d_skip"].to(cdt)[None, :, None]
    y = layers.gated_rmsnorm(params["norm"], y.reshape(bsz, 1, d_in), z,
                             cfg.rms_eps, norm_mean)
    out = y @ params["out_proj"].to(cdt)
    return out, SSMState(conv=conv_in[:, :, 1:],
                         ssm=new_ssm.to(state.ssm.dtype))


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, *,
                   device) -> SSMState:
    s, d_in, n_heads, conv_dim = _dims(cfg)
    return SSMState(
        conv=torch.zeros((batch, conv_dim, s.conv_width - 1), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, n_heads, s.headdim, s.d_state), dtype=dtype,
                        device=device))
