"""Selective state-space layers (``src/repro/models/ssm.py``).

- Mamba1 (falcon-mamba-7b): per-channel state. The prefill's recurrence
  runs on the ``mamba_scan`` kernel (``path="kernel"``), its plain version
  (``"plain"``) or the reference's chunked associative scan
  (``"reference"``).
- Mamba2 (zamba2): multi-head scalar-A SSD with the chunked dual form
  (intra-chunk quadratic + inter-chunk recurrence), plain PyTorch on every
  path (the JAX package has no kernel for it).

Both have a sequence path (prefill: outputs and the final state) and a
one-token decode path (the state update). Params are one layer's views of
the stacked leaves.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref as kref
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.models.params import ParamSpec


# ---------------------------------------------------------------- mamba1

def mamba1_specs(cfg: ArchConfig, n_layers: int) -> Dict[str, ParamSpec]:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    dtr = max(d // 16, 1)
    L = n_layers
    ax = ("layers",)
    return {
        "ln": ParamSpec((L, d), ax + ("embed",), init="ones",
                        dtype="float32"),
        "in_proj": ParamSpec((L, d, 2 * di), ax + ("embed", "ssm_inner")),
        "conv_w": ParamSpec((L, s.conv_width, di),
                            ax + ("conv", "ssm_inner")),
        "conv_b": ParamSpec((L, di), ax + ("ssm_inner",), init="zeros"),
        "x_proj": ParamSpec((L, di, dtr + 2 * s.state_dim),
                            ax + ("ssm_inner", None)),
        "dt_w": ParamSpec((L, dtr, di), ax + (None, "ssm_inner")),
        "dt_b": ParamSpec((L, di), ax + ("ssm_inner",), init="ssm_dt",
                          dtype="float32"),
        "A_log": ParamSpec((L, di, s.state_dim),
                           ax + ("ssm_inner", "ssm_state"), init="ssm_a",
                           dtype="float32"),
        "D": ParamSpec((L, di), ax + ("ssm_inner",), init="ones",
                       dtype="float32"),
        "out_proj": ParamSpec((L, di, d), ax + ("ssm_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """x: [B,S,C]; w: [cw,C]; depthwise causal conv. Returns (y, new_state)
    where the state holds the trailing cw-1 inputs."""
    cw = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(cw))
    new_state = xp[:, -(cw - 1):] if cw > 1 else state
    return F.silu(y + b), new_state


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a at the even and b at the odd positions of axis 1."""
    out = a.new_empty((a.shape[0], a.shape[1] + b.shape[1]) + a.shape[2:])
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _associative_scan(combine, elems: List[torch.Tensor]
                      ) -> List[torch.Tensor]:
    """Inclusive scan along axis 1 in the order of operations of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan the pairs,
    then fill in the even positions."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = _associative_scan(combine, combine([e[:, 0:-1:2] for e in elems],
                                             [e[:, 1::2] for e in elems]))
    rest = [e[:, 2::2] for e in elems]
    even = combine([e[:, :-1] for e in odd] if n % 2 == 0 else odd, rest)
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _selective_scan_chunk(a: torch.Tensor, bx: torch.Tensor,
                          h0: torch.Tensor):
    """Linear recurrence h_t = a_t * h_{t-1} + bx_t within one chunk via an
    associative scan. a, bx: [B, c, di, N]; h0: [B, di, N]."""
    def combine(left, right):
        (al, bl), (ar, br) = left, right
        return [al * ar, br + ar * bl]
    a_all, b_all = _associative_scan(combine, [a, bx])
    h = a_all * h0[:, None] + b_all                 # [B, c, di, N]
    return h, h[:, -1]


def _chunked(t: torch.Tensor, nchunks: int, chunk: int) -> torch.Tensor:
    """[B,S,...] -> [nchunks,B,c,...]; raises where the reference's reshape
    does (S not nchunks * c)."""
    return t.reshape(t.shape[0], nchunks, chunk, *t.shape[2:]).transpose(0,
                                                                         1)


def _chunk_scan(xi, dt, A, Bm, Cm, h0, chunk: int):
    """The reference's prefill scan: chunks of ``chunk`` steps, each an
    associative scan from the state the last one left. Returns (y [B,S,di]
    f32, h_last)."""
    b, S, di = xi.shape
    nchunks = max(S // chunk, 1)
    chunk = S // nchunks
    h = h0
    ys = []
    for dt_c, B_c, x_c, C_c in zip(*(_chunked(t, nchunks, chunk)
                                     for t in (dt, Bm, xi, Cm))):
        x_c = x_c.float()
        a = torch.exp(dt_c[..., None] * A)                      # [B,c,di,N]
        bx = (dt_c * x_c)[..., None] * B_c[:, :, None, :]       # [B,c,di,N]
        hs, h = _selective_scan_chunk(a, bx, h)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, C_c))
    return torch.stack(ys).transpose(0, 1).reshape(b, S, di), h


def mamba1_seq(cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
               h0: Optional[torch.Tensor] = None, conv0=None,
               chunk: int = 256, path: str = "reference"):
    """Full-sequence mamba1 mixer. x: [B,S,d] -> (y [B,S,d], (h [B,di,N]
    f32, conv_state [B,cw-1,di])). From a zero state (``h0`` None), the
    ``"kernel"`` and ``"plain"`` paths run the recurrence through
    ``mamba_scan`` or its plain version, one call over the whole sequence;
    otherwise the reference's chunked associative scan runs."""
    s = cfg.ssm
    b, S, d = x.shape
    di = s.expand * d
    n = s.state_dim
    dtr = max(d // 16, 1)
    xz = x @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]
    xi, conv_state = _causal_conv(xi, p["conv_w"], p["conv_b"], conv0)

    # one f32 copy of the [B,S,dtr+2N] projection; B and C are column views
    # of it (a row stride of dtr + 2N), which the kernel reads in place
    proj = (xi @ p["x_proj"]).float()
    dt = F.softplus(proj[..., :dtr].to(x.dtype) @ p["dt_w"]
                    + p["dt_b"]).float()                         # [B,S,di]
    Bm = proj[..., dtr:dtr + n]                                  # [B,S,N]
    Cm = proj[..., dtr + n:]                                     # [B,S,N]
    A = -torch.exp(p["A_log"])                                   # [di,N]

    if h0 is None and path in ("kernel", "plain"):
        scan = mamba_scan if path == "kernel" else kref.mamba_scan_ref
        y, h_last = scan(xi.float(), dt, A, Bm, Cm)
    else:
        if h0 is None:
            h0 = torch.zeros((b, di, n), dtype=torch.float32,
                             device=x.device)
        y, h_last = _chunk_scan(xi, dt, A, Bm, Cm, h0, chunk)
    y = y + xi.float() * p["D"]
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], (h_last, conv_state)


def mamba1_decode(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                  x: torch.Tensor, h: torch.Tensor, conv_state: torch.Tensor):
    """x: [B,1,d]; the single-step state update. Returns (y [B,1,d], (h,
    conv_state)), new tensors."""
    s = cfg.ssm
    b, _, d = x.shape
    di = s.expand * d
    n = s.state_dim
    dtr = max(d // 16, 1)
    xz = x @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]
    xi, conv_state = _causal_conv(xi, p["conv_w"], p["conv_b"], conv_state)
    proj = xi @ p["x_proj"]
    dt = F.softplus(proj[..., :dtr] @ p["dt_w"] + p["dt_b"]).float()
    Bm = proj[..., dtr:dtr + n].float()
    Cm = proj[..., dtr + n:].float()
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[:, 0, :, None] * A)                         # [B,di,N]
    bx = (dt[:, 0] * xi[:, 0].float())[..., None] * Bm[:, 0, None, :]
    h = a * h + bx
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None]
    y = y + xi.float() * p["D"]
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], (h, conv_state)


def mixer_seq(cfg: ArchConfig, p, x: torch.Tensor, chunk: int = 256,
              path: str = "reference"):
    """The family's mixer over a prompt from a zero state: mamba1 (whose
    scan takes ``path``) or mamba2, by ``cfg.ssm.version``."""
    if cfg.ssm.version == 1:
        return mamba1_seq(cfg, p, x, chunk=chunk, path=path)
    return mamba2_seq(cfg, p, x, chunk=chunk)


def mixer_decode(cfg: ArchConfig, p, x: torch.Tensor, h: torch.Tensor,
                 conv_state: torch.Tensor):
    """The family's one-token mixer step, by ``cfg.ssm.version``."""
    step = mamba1_decode if cfg.ssm.version == 1 else mamba2_decode
    return step(cfg, p, x, h, conv_state)


# ---------------------------------------------------------------- mamba2 (SSD)

def mamba2_specs(cfg: ArchConfig, n_layers: int) -> Dict[str, ParamSpec]:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    nh = di // s.head_dim
    n = s.state_dim
    L = n_layers
    ax = ("layers",)
    # in_proj packs [z, x, B, C, dt]
    proj_out = 2 * di + 2 * n + nh
    return {
        "ln": ParamSpec((L, d), ax + ("embed",), init="ones",
                        dtype="float32"),
        "in_proj": ParamSpec((L, d, proj_out), ax + ("embed", "ssm_inner")),
        "conv_w": ParamSpec((L, s.conv_width, di + 2 * n),
                            ax + ("conv", "ssm_inner")),
        "conv_b": ParamSpec((L, di + 2 * n), ax + ("ssm_inner",),
                            init="zeros"),
        "A_log": ParamSpec((L, nh), ax + (None,), init="ssm_a",
                           dtype="float32"),
        "dt_b": ParamSpec((L, nh), ax + (None,), init="ssm_dt",
                          dtype="float32"),
        "D": ParamSpec((L, nh), ax + (None,), init="ones", dtype="float32"),
        "gate_ln": ParamSpec((L, di), ax + ("ssm_inner",), init="ones",
                             dtype="float32"),
        "out_proj": ParamSpec((L, di, d), ax + ("ssm_inner", "embed")),
    }


def _ssd_chunk_dual(xh, Bc, Cc, dtc, A, h0, chunk: int):
    """SSD chunked dual form.

    xh: [B,S,H,P]; Bc,Cc: [B,S,N]; dtc: [B,S,H] (softplus'd); A: [H]
    (negative). Returns y [B,S,H,P] and the final state [B,H,P,N]. All
    float32."""
    b, S, H, P = xh.shape
    nchunks = max(S // chunk, 1)
    c = S // nchunks
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=xh.device))
    h = h0
    ys = []
    for x_c, B_c, C_c, dt_c in zip(*(_chunked(t, nchunks, c)
                                     for t in (xh, Bc, Cc, dtc))):
        da = dt_c * A                                            # [B,c,H]
        seg = torch.cumsum(da, dim=1)                            # [B,c,H]
        # intra-chunk: scores[i,j] = C_i.B_j * exp(seg_i - seg_j), j <= i
        gap = seg[:, :, None, :] - seg[:, None, :, :]            # [B,c,c,H]
        # the mask goes in before the exponential: above the diagonal gap is
        # positive and exp overflows to inf in f32 once a head's decay in
        # the chunk passes 88.7, and the backward of a select after it
        # multiplies the zero cotangent there by inf (NaN in the gradient of
        # dt and every layer below). The reference selects after exp; the
        # forward is the same either way.
        decay = torch.exp(gap.masked_fill(~mask[None, :, :, None],
                                          float("-inf")))
        cb = torch.einsum("bin,bjn->bij", C_c, B_c)              # [B,c,c]
        scores = cb[..., None] * decay                           # [B,c,c,H]
        xdt = x_c * dt_c[..., None]                              # [B,c,H,P]
        y = torch.einsum("bijh,bjhp->bihp", scores, xdt)
        # inter-chunk: contribution of the carried state
        y = y + torch.einsum("bin,bhpn,bih->bihp", C_c, h, torch.exp(seg))
        # new carried state
        last = seg[:, -1:, :]                                    # [B,1,H]
        w = torch.exp(last - seg)                                # [B,c,H]
        h = (h * torch.exp(last)[:, 0, :, None, None]
             + torch.einsum("bch,bchp,bcn->bhpn", w * dt_c, x_c, B_c))
        ys.append(y)
    return torch.stack(ys).transpose(0, 1).reshape(b, S, H, P), h


def _mamba2_project(cfg, p, x, conv0):
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    n = s.state_dim
    nh = di // s.head_dim
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv0)
    xi = xbc[..., :di]
    Bc = xbc[..., di:di + n].float()
    Cc = xbc[..., di + n:].float()
    dt = F.softplus(dt.float() + p["dt_b"])                      # [B,S,H]
    xh = xi.float().reshape(*xi.shape[:-1], nh, s.head_dim)
    return z, xi, xh, Bc, Cc, dt, conv_state


def _mamba2_out(cfg, p, y, xh, z, x_dtype):
    y = y + xh * p["D"][:, None]                         # D skip per head
    b, S = y.shape[:2]
    y = y.reshape(b, S, -1)
    # gated RMSNorm (mamba2 norm-before-out_proj), at a fixed eps of 1e-5
    y = y * F.silu(z.float())
    rms = torch.sqrt(torch.mean(y ** 2, dim=-1, keepdim=True) + 1e-5)
    y = (y / rms) * p["gate_ln"]
    return y.to(x_dtype) @ p["out_proj"]


def mamba2_seq(cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
               h0: Optional[torch.Tensor] = None, conv0=None,
               chunk: int = 256):
    """Full-sequence mamba2 mixer. x: [B,S,d] -> (y [B,S,d], (h [B,H,P,N]
    f32, conv_state [B,cw-1,di+2N]))."""
    s = cfg.ssm
    b, S, d = x.shape
    nh = s.expand * d // s.head_dim
    z, xi, xh, Bc, Cc, dt, conv_state = _mamba2_project(cfg, p, x, conv0)
    A = -torch.exp(p["A_log"])                                   # [H]
    if h0 is None:
        h0 = torch.zeros((b, nh, s.head_dim, s.state_dim),
                         dtype=torch.float32, device=x.device)
    y, h_last = _ssd_chunk_dual(xh, Bc, Cc, dt, A, h0, min(chunk, S))
    return _mamba2_out(cfg, p, y, xh, z, x.dtype), (h_last, conv_state)


def mamba2_decode(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                  x: torch.Tensor, h: torch.Tensor, conv_state: torch.Tensor):
    """x: [B,1,d]; the single-step state update."""
    z, xi, xh, Bc, Cc, dt, conv_state = _mamba2_project(cfg, p, x,
                                                        conv_state)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[:, 0] * A)                                  # [B,H]
    upd = torch.einsum("bh,bhp,bn->bhpn", dt[:, 0], xh[:, 0], Bc[:, 0])
    h = a[..., None, None] * h + upd
    y = torch.einsum("bhpn,bn->bhp", h, Cc[:, 0])[:, None]       # [B,1,H,P]
    return _mamba2_out(cfg, p, y, xh, z, x.dtype), (h, conv_state)
