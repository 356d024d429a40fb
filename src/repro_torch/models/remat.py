"""Per-layer rematerialisation of the training forward: the counterpart of
the reference's ``jax.checkpoint`` around each layer
(``src/repro/models/model.py`` ``_scan_layers``).

A layer run through :func:`remat_layer` keeps only its input and its
parameters for the backward, which runs the layer again and takes its
vector-Jacobian product there. ``torch.utils.checkpoint`` cannot serve:
its saved-tensor hooks are refused under ``torch.func.grad`` and
``torch.func.vjp``, through which every gradient of the port is taken. So
the layer is one ``torch.autograd.Function`` of the new style (the forward
takes no ``ctx``; ``setup_context`` saves the inputs) whose backward
recomputes the layer under ``torch.func.vjp``; ``generate_vmap_rule``
lets ``torch.func.vmap`` batch it (the hypergradient's Neumann features).
The recompute runs the same operations on the same inputs, so the values
and gradients are those of the layer called directly, bit for bit.

``torch.func.grad`` runs every backward with ``create_graph``, so a
backward that recomputed the layer from its saved inputs as they are would
have that recompute recorded, and kept, for each layer until the gradient
returns: no memory saved. The backward therefore recomputes from detached
inputs and cotangent, and is first-order only: a derivative taken of its
gradients (a Hessian through the layers in x, which the trainer never
takes; its second-order terms are in y, and its mixed term differentiates
the layers once) raises.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.func import vjp

Body = Callable[[torch.Tensor, Dict[str, torch.Tensor]], torch.Tensor]


class _Remat(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(body, keys, h, *vals):
        return body(h, dict(zip(keys, vals)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        body, keys, h, *vals = inputs
        ctx.body, ctx.keys = body, keys
        ctx.save_for_backward(h, *vals)

    @staticmethod
    def backward(ctx, g):
        body, keys = ctx.body, ctx.keys
        _, pullback = vjp(lambda h, *vals: body(h, dict(zip(keys, vals))),
                          *(t.detach() for t in ctx.saved_tensors))
        grads = _Once.apply(g, *pullback(g.detach()))
        return (None, None) + tuple(grads)


class _Once(torch.autograd.Function):
    """The layer's gradients as given, tied to the cotangent ``g`` so that
    a derivative taken of them reaches this backward, which raises."""
    generate_vmap_rule = True

    @staticmethod
    def forward(g, *grads):
        return tuple(t.view_as(t) for t in grads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *cotangents):
        raise RuntimeError("remat_layer's backward is differentiable once: "
                           "a derivative of its gradients is not supported")


def remat_layer(body: Body, h: torch.Tensor,
                p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``body(h, p)``, with its activations recomputed in the backward.
    The layer's parameter views ``p`` go in as the Function's inputs, so
    their gradients reach the stacked leaves they view. ``body`` may close
    over no tensor: under ``torch.func``'s transforms a tensor reached only
    through the closure is not one of the Function's inputs, and the
    transforms refuse it. A tensor the layer needs besides ``h`` and its
    params therefore rides in ``p`` under a key of its own (an encdec
    decoder layer's ``p["ck"]`` and ``p["cv"]``, its cross-attention's K
    and V of the encoder's output): it is then an input like the params,
    and its gradient flows back through it."""
    keys = tuple(p)
    return _Remat.apply(body, keys, h, *(p[k] for k in keys))
