"""Federated data hyper-cleaning (paper Problem (4) / Section 6.2).

UL variable x^m ∈ R^{n_train}: per-sample weights through σ(·) on client m.
The driver's x is the global [M, n_train] table (Problem (4)'s x is the
concatenation over clients; client m's loss touches row m only). LL
variable y = {w [feat, classes], b [classes]}: a shared linear classifier
with an L2 regulariser.

The LL is strongly convex, so y*(x) and the true hypergradient ∇F(x) can be
computed by direct solves: ``true_grad_norm`` reports the paper's
ε-stationarity metric E‖∇F(x̄)‖ exactly, and ``val_loss`` the validation
loss at y*(x̄).

Memory route of the exact diagnostic. y has D·C entries (D = feat + 1 with
the bias, C classes; 7,850 at MNIST width), and Newton needs the LL
Hessian over them. Autodiff over 7,850 directions would hold one
[60,000, 10] logits tangent per direction; instead :func:`ll_hessian`
assembles the Hessian of the weighted softmax cross-entropy in closed form,

    H = Σ_i c_i (x̃_i x̃_iᵀ) ⊗ (diag p_i − p_i p_iᵀ) + 2ν I,
    c_i = σ(x_i) / (n_train · M),  x̃_i = [a_i, 1],  p_i = softmax(x̃_iᵀ W),

streaming the samples in chunks: per chunk one [C, D, D] batched product
for the diagonal blocks and one [D·C, D·C] product of the chunk's rows
(√c_i x̃_i ⊗ p_i) with themselves, so the transient memory is a chunk's
rows, not a tangent per direction. The gradients and the mixed VJP stay on
``torch.func``; they are one [N, C] logits pass each.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.func import grad, vjp

from repro_torch import device as devices
from repro_torch.configs.paper_tasks import HyperCleanConfig
from repro_torch.core.bilevel import BilevelProblem, softmax_xent
from repro_torch.data.hyperclean import HyperCleanData, from_arrays

NEWTON_STEPS = 12
# elements of one chunk's [rows, D·C] block in ll_hessian (256 MB in f32)
HESSIAN_CHUNK_ELEMENTS = 1 << 26


def _xent_rows(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross-entropy, ``logsumexp - picked logit``."""
    lf = logits.float() if logits.dtype != torch.float64 else logits
    lse = torch.logsumexp(lf, dim=-1)
    iota = torch.arange(lf.shape[-1], dtype=labels.dtype, device=lf.device)
    picked = torch.where(iota == labels.unsqueeze(-1), lf,
                         torch.zeros((), dtype=lf.dtype, device=lf.device))
    return lse - picked.sum(dim=-1)


def build_hyperclean(cfg: HyperCleanConfig, device="cuda", seed: int = 0,
                     data: Optional[Dict] = None):
    """The task on ``device``: ``problem``, ``init_xy``, ``batch_fn``,
    ``data`` (stacked [M, ...]), ``cfg``, the exact diagnostics
    ``true_grad_norm(x̄, ȳ)`` and ``val_loss(x̄, ȳ)``, and the pieces they
    are built from (``g_full``, ``f_full``, ``ll_hessian``). ``data`` hands
    in a data set as arrays (the reference's ``all_clients()``); by default
    :class:`HyperCleanData` draws one from ``seed``, which also seeds the
    batches. The diagnostics compute in the dtype of the ``x̄`` they are
    given (float64 on the CPU for a witness)."""
    dev = devices.resolve(device)
    if data is None:
        data = HyperCleanData(cfg.n_clients, cfg.n_train_per_client,
                              cfg.n_val_per_client, cfg.feat_dim,
                              cfg.n_classes, cfg.corrupt_frac,
                              seed=seed).all_clients(dev)
    ds = from_arrays(data, dev)
    m_cl, n_tr = cfg.n_clients, cfg.n_train_per_client
    n_val, feat, n_cls = cfg.n_val_per_client, cfg.feat_dim, cfg.n_classes
    a_tr = ds["a_tr"].reshape(m_cl * n_tr, feat)
    b_tr = ds["b_tr"].reshape(-1)
    a_val = ds["a_val"].reshape(m_cl * n_val, feat)
    b_val = ds["b_val"].reshape(-1)

    def rows(batch, key, n):
        """Flat row numbers of client ``batch["client"]``'s samples
        ``batch[key]``: one index_select per tensor, which vmap batches
        over clients."""
        return (batch["client"].to(torch.int64) * n
                + batch[key].to(torch.int64))

    def g(xp, yp, batch):
        """Weighted train loss + strongly convex regulariser; ``xp`` is the
        global [M, n_train] weight table."""
        r = rows(batch, "idx", n_tr)
        wgt = torch.sigmoid(xp.reshape(-1).index_select(0, r))
        logits = a_tr.index_select(0, r) @ yp["w"] + yp["b"]
        per = _xent_rows(logits, b_tr.index_select(0, r))
        reg = cfg.nu * (torch.sum(yp["w"] ** 2) + torch.sum(yp["b"] ** 2))
        return torch.mean(wgt * per) + reg

    def f(xp, yp, batch):
        r = rows(batch, "vidx", n_val)
        return softmax_xent(a_val.index_select(0, r) @ yp["w"] + yp["b"],
                            b_val.index_select(0, r))

    problem = BilevelProblem(f=f, g=g)

    def init_xy(gen: torch.Generator):
        xp = torch.zeros(m_cl, n_tr, device=dev)
        w = 0.01 * torch.randn(feat, n_cls, generator=gen, device=dev)
        # keys in sorted order, the order every tree map of the port keeps
        # (torch.func compares the structures of primals and tangents)
        return xp, {"b": torch.zeros(n_cls, device=dev), "w": w}

    def batch_fn(client: int, step: int) -> Dict:
        K, bs = cfg.fed.neumann_k, cfg.batch
        g_ = devices.generator(dev, seed, 17, client, step)

        def draw(n, shape):
            return torch.randint(0, n, shape, generator=g_, device=dev)
        idx, vidx, i0 = draw(n_tr, (bs,)), draw(n_val, (bs,)), draw(n_tr,
                                                                    (bs,))
        gi = draw(n_tr, (K, bs))
        cid = torch.full((), client, dtype=torch.int32, device=dev)

        def mk(i):
            return {"client": cid, "idx": i, "vidx": vidx}

        return {"g": mk(idx), "g0": mk(i0), "f": mk(idx),
                "gi": {"client": cid.expand(K), "idx": gi,
                       "vidx": vidx.expand(K, bs)}}

    # ---------------- exact diagnostics (full batch, all clients) ---------

    d_aug = feat + 1
    cast = {}

    def full_data(dtype):
        """Bias-augmented features x̃ = [a, 1] and labels, train [M, n, D]
        and val, in ``dtype`` (cast once per dtype)."""
        if dtype not in cast:
            def aug(a):
                a = a.to(dtype)
                return torch.cat([a, torch.ones(a.shape[:-1] + (1,),
                                                dtype=dtype, device=dev)], -1)
            cast[dtype] = (aug(ds["a_tr"]), ds["b_tr"], aug(ds["a_val"]),
                           ds["b_val"])
        return cast[dtype]

    def flat_y(yp):
        return torch.cat([yp["w"].reshape(-1), yp["b"].reshape(-1)])

    def g_full(x_all, y_vec):
        """Global LL objective (mean over clients, full batches); ``y_vec``
        is [w; b] flattened, so ``y_vec.reshape(D, C)`` is the bias-
        augmented weight matrix."""
        xt, bt, _, _ = full_data(y_vec.dtype)
        per = _xent_rows(xt @ y_vec.reshape(d_aug, n_cls), bt)
        return (torch.mean(torch.sigmoid(x_all) * per, dim=1).sum() / m_cl
                + cfg.nu * torch.sum(y_vec ** 2))

    def f_full(y_vec):
        _, _, xv, bv = full_data(y_vec.dtype)
        return torch.mean(_xent_rows(xv @ y_vec.reshape(d_aug, n_cls), bv))

    def ll_hessian(x_all, y_vec, chunk_rows: Optional[int] = None):
        """∇²yy g_full in closed form (module docstring), over the samples
        in chunks of ``chunk_rows`` (default: HESSIAN_CHUNK_ELEMENTS over
        D·C)."""
        dtype = y_vec.dtype
        xt = full_data(dtype)[0].reshape(-1, d_aug)
        c = (torch.sigmoid(x_all.to(dtype)) / (n_tr * m_cl)).reshape(-1)
        wt = y_vec.reshape(d_aug, n_cls)
        dc = d_aug * n_cls
        step = chunk_rows or max(1, HESSIAN_CHUNK_ELEMENTS // dc)
        outer = torch.zeros(dc, dc, dtype=dtype, device=dev)
        diag = torch.zeros(n_cls, d_aug, d_aug, dtype=dtype, device=dev)
        for s in range(0, xt.shape[0], step):
            xc, cc = xt[s:s + step], c[s:s + step]
            p = torch.softmax(xc @ wt, dim=-1)
            # Σ_i c_i p_ik x̃_i x̃_iᵀ, one [D, D] block per class k
            diag += (cc[:, None] * p).t()[:, None, :] * xc.t()[None] @ xc
            z = (cc.sqrt()[:, None, None] * xc[:, :, None]
                 * p[:, None, :]).reshape(-1, dc)
            outer += z.t() @ z
        h = -outer.view(d_aug, n_cls, d_aug, n_cls)
        for k in range(n_cls):
            h[:, k, :, k] += diag[k]
        return (h.reshape(dc, dc)
                + 2.0 * cfg.nu * torch.eye(dc, dtype=dtype, device=dev))

    grad_g_y = grad(g_full, argnums=1)

    def solve_y_star(x_all, y0_vec):
        """Newton on the strongly convex LL."""
        y = y0_vec
        for _ in range(NEWTON_STEPS):
            y = y - torch.linalg.solve(ll_hessian(x_all, y),
                                       grad_g_y(x_all, y))
        return y

    def true_grad_norm(x_all, yp):
        """‖∇F(x̄)‖ = ‖(∇²xy g) λ‖ with λ = (∇²yy g)⁻¹ ∇y f at y*(x̄)
        (∇x f = 0 here)."""
        ys = solve_y_star(x_all, flat_y(yp).to(x_all.dtype))
        lam = torch.linalg.solve(ll_hessian(x_all, ys), grad(f_full)(ys))
        _, pull = vjp(lambda x: grad_g_y(x, ys), x_all)
        return torch.linalg.norm(pull(lam)[0])

    def val_loss(x_all, yp):
        return f_full(solve_y_star(x_all, flat_y(yp).to(x_all.dtype)))

    return dict(problem=problem, init_xy=init_xy, batch_fn=batch_fn,
                data=ds, cfg=cfg, true_grad_norm=true_grad_norm,
                val_loss=val_loss, g_full=g_full, f_full=f_full,
                ll_hessian=ll_hessian)
