"""Per-layer recomputation in training (``cfg.remat``).

The reference wraps each layer body in ``jax.checkpoint``: the forward pass
keeps only the layer's inputs, and the backward pass runs the layer again to
get its activations. :func:`checkpoint` does the same under the train
step's ``torch.func.vmap(torch.func.grad_and_value(...))``, where
``torch.utils.checkpoint`` fails (its non-reentrant form needs saved-tensor
hooks, which ``torch.func`` refuses, and its reentrant form has no
``setup_context``).

It is a ``torch.autograd.Function`` with ``setup_context`` and a generated
vmap rule. Its forward runs the layer without recording a graph and saves
only the input tensors; its backward recomputes the layer through
``torch.func.vjp`` and returns the cotangents of those inputs. The
recomputation runs the same operations on the same inputs, so the
gradients equal the plain layer's bit for bit wherever the layer's kernels
are deterministic.

``torch.func.grad`` runs its backward pass with ``create_graph=True``, so
everything the backward computes is recorded, the recomputed layer
included. The backward therefore returns its cotangents detached: each
layer's recomputed activations are freed once its cotangents are out, which
is what saves the memory (without it the peak does not move). The
recomputation itself still runs with grad enabled, as the plain layer's
backward does, so it takes the same kernels. The price: no second-order
gradient flows through a recomputed layer (the train step takes none).

The recomputation runs in a copy of the forward's context variables
(``contextvars``), the model-parallel state of ``launch.mesh`` among them:
on the card the autograd engine runs the backward on its device thread,
which does not inherit the caller's context, and a tensor-parallel layer
recomputed without it would skip its collectives.

With a telemetry sink active the recomputed forward of each layer is a
``model.remat.recompute`` span (:mod:`repro_torch.telemetry`); the layer's
backward that follows it is not.
"""
from __future__ import annotations

import contextvars
from typing import Any, Callable

import torch

from repro_torch import _tree, telemetry

__all__ = ["checkpoint"]


class _Checkpoint(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, treedef, *leaves):
        return fn(*_tree.unflatten(treedef, list(leaves)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, treedef, *leaves = inputs
        ctx.fn, ctx.treedef = fn, treedef
        ctx.context = contextvars.copy_context()
        ctx.save_for_backward(*leaves)

    @staticmethod
    def backward(ctx, *grads):
        fn, treedef = ctx.fn, ctx.treedef

        def flat_fn(*leaves):
            return fn(*_tree.unflatten(treedef, list(leaves)))

        def recompute(saved):
            with telemetry.get().span("model.remat.recompute"):
                _, vjp_fn = torch.func.vjp(flat_fn, *saved)
            return vjp_fn(grads if len(grads) > 1 else grads[0])

        cts = ctx.context.run(recompute, ctx.saved_tensors)
        return (None, None) + tuple(c.detach() for c in cts)


def checkpoint(fn: Callable[..., Any], *args: Any):
    """``fn(*args)``, keeping only ``args`` for the backward pass.

    ``args`` are tensors or trees of them (``None`` entries allowed); ``fn``
    returns a tensor or a tuple of tensors, and must read no tensor that
    needs a gradient other than through ``args``.
    """
    leaves, treedef = _tree.flatten(args)
    return _Checkpoint.apply(fn, treedef, *leaves)
