"""A gradient for a forward kernel: the kernel computes the values, the
plain version defines the gradient.

The reference trains through its XLA path and differentiates that; it
has no backward kernel (no ``custom_vjp`` anywhere in the JAX package).
The port's default ``Runtime`` runs its forward kernels, whose outputs
are written into fresh buffers outside autograd and so carry no
``grad_fn``.  :func:`kernel_with_plain_grad` closes that gap: the
forward is the kernel, and the backward recomputes the site's plain
version from the saved inputs under ``torch.enable_grad()`` and returns
that version's vector-Jacobian product.  The loss value still comes from
the kernel; the gradient is the plain version's by definition (backward
kernels are later work, ROADMAP item 17).

The forward is an argument, so a test on the CPU can pass the plain
version as the "kernel" and compare with plain autograd exactly.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


BACKWARD_ITEM = "ROADMAP.md item 17 (kernel redesigns and backward kernels)"


def needs_grad(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether autograd would record an op on these inputs."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """For a kernel with no gradient (one-token decode, which the
    reference does not differentiate either): raise rather than drop a
    gradient silently."""
    if needs_grad(tensors):
        raise NotImplementedError(
            f"{name} has no gradient in this port (nor in the reference); "
            f"a backward pass would come with {BACKWARD_ITEM}")


class _PlainGrad(torch.autograd.Function):
    """forward: ``kernel(*inputs)``; backward: the VJP of
    ``plain(*inputs)`` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        out = kernel(*inputs)
        ctx.multi = isinstance(out, tuple)
        return out

    @staticmethod
    def backward(ctx, *grad_out):
        inputs = ctx.saved_tensors
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[2:])
                  if need]
        detached = [t.detach().requires_grad_(i in wanted)
                    for i, t in enumerate(inputs)]
        with torch.enable_grad():
            out = ctx.plain(*detached)
        outs = out if ctx.multi else (out,)
        pairs = [(o, g) for o, g in zip(outs, grad_out)
                 if g is not None and o.requires_grad]
        grads = [None] * len(inputs)
        if pairs and wanted:
            got = torch.autograd.grad([o for o, _ in pairs],
                                      [detached[i] for i in wanted],
                                      [g for _, g in pairs],
                                      allow_unused=True)
            for i, g in zip(wanted, got):
                grads[i] = g
        return (None, None, *grads)


def kernel_with_plain_grad(kernel: Callable, plain: Callable,
                           *inputs: torch.Tensor):
    """``kernel(*inputs)``; when grad mode is on and an input requires a
    gradient, wrapped so that its backward is the plain version's.  Both
    callables take the tensors ``inputs`` positionally and return a
    tensor or a tuple of tensors of the same structure."""
    if not needs_grad(inputs):
        return kernel(*inputs)
    return _PlainGrad.apply(kernel, plain, *inputs)
