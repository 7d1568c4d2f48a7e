"""Plain PyTorch pieces shared by the model references: products in a chosen
precision, RMSNorm, rotary embeddings, causal attention, cross entropy,
uniform consensus matrices, and the decentralized step of eq. (3) with an
optimizer's reference, written out over a list of replicas.

Nothing here imports the program under test. Tensors are float32 unless a
name says otherwise; ``prec="fp8"`` rounds both operands of every product,
and the gradient each product's backward receives, to float8 e4m3 with a
per-tensor scale (the control: the step below bf16),
``prec="fp32"`` computes in float32 with TF32 off.
"""
from __future__ import annotations

import math

import numpy as np
import torch

FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448; the gradient passes straight through."""
    s = (x.detach().abs().amax().float() / FP8_MAX).clamp_min(1e-30)
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach()


class _Fp8Grad(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to float8 e4m3 under a
    per-tensor scale, so the backward products also take float8 operands."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return fp8(g)


def product(eq: str, a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    a, b = a.float(), b.float()
    if prec == "fp32":
        return torch.einsum(eq, a, b)
    if prec == "fp8":
        return _Fp8Grad.apply(torch.einsum(eq, fp8(a), fp8(b)))
    raise ValueError(f"unknown precision {prec!r}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, L, H, d) at positions 0..L-1, the halves
    layout: (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin)."""
    d, L = x.shape[-1], x.shape[1]
    inv = 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float32) / d))
    ang = torch.arange(L, device=x.device, dtype=torch.float32)[:, None] \
        * torch.from_numpy(inv.astype(np.float32)).to(x.device)[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, scale: float, prec: str) -> torch.Tensor:
    """q, k: (B, L, H, dk); v: (B, L, H, dv) -> (B, L, H, dv)."""
    L = q.shape[1]
    s = product("bqhd,bkhd->bhqk", q, k, prec) * scale
    mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return product("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v, prec)


def swiglu(x, w_gate, w_up, w_down, prec: str) -> torch.Tensor:
    h = torch.nn.functional.silu(product("...d,df->...f", x, w_gate, prec)) \
        * product("...d,df->...f", x, w_up, prec)
    return product("...f,fd->...d", h, w_down, prec)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of (B, L, V) logits against (B, L) labels."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


# -- the consensus of eq. (3) (A[i, j]: the weight worker j gives worker i) --

def uniform_over(heard: list[set[int]]) -> np.ndarray:
    """The consensus matrix in which worker j gives equal weights to the
    workers of ``heard[j]`` (itself among them)."""
    M = len(heard)
    A = np.zeros((M, M))
    for j, h in enumerate(heard):
        for i in h:
            A[i, j] = 1.0
    return A / A.sum(0, keepdims=True)


def train_steps(loss_fn, W: dict[str, torch.Tensor], matrix, batches, *, opt, opt_args: dict,
                prec: str, dtype: torch.dtype):
    """Eq. (3) over M replicas of ``W`` (the stored dtype ``dtype``), each
    step k: per-replica loss and gradient computed in ``prec`` from the
    replica upcast to float32, the gradient stored in ``dtype``; the
    optimizer reference ``opt`` turns each gradient into an update (its
    state per replica); w_j <- Σ_i A_k[i, j]·w_i + update_j, stored in
    ``dtype``, with A_k = ``matrix(k)``. ``batches``: one (M, B, L + 1)
    token tensor per step.

    Returns (mean loss over the replicas per step, first gradient's norm per
    tensor over the replicas, read from the optimizer's state after step
    one, norm per tensor of the change of every replica from ``W`` after
    the last step)."""
    M = int(batches[0].shape[0])
    P = [dict(W) for _ in range(M)]
    U = [{n: opt.init(t) for n, t in W.items()} for _ in range(M)]
    losses, g1 = [], None
    for k, batch in enumerate(batches):
        G, total = [], 0.0
        for j in range(M):
            p32 = {n: t.float().requires_grad_() for n, t in P[j].items()}
            loss = loss_fn(p32, batch[j], prec)
            grads = torch.autograd.grad(loss, list(p32.values()))
            G.append({n: g.to(dtype) for n, g in zip(p32, grads)})
            total += float(loss.detach())
            del p32, grads, loss
        losses.append(total / M)
        upd = [{} for _ in range(M)]
        for j in range(M):
            for n in W:
                U[j][n], upd[j][n] = opt.update(U[j][n], G[j][n], dtype, **opt_args)
        if k == 0:
            g1 = norms([opt.first_gradient(u) for u in U])
        del G
        Af = torch.tensor(matrix(k), dtype=torch.float32)
        if Af.shape != (M, M):
            raise ValueError(f"a consensus matrix of {tuple(Af.shape)} for {M} workers")
        new = [{} for _ in range(M)]
        for n in W:
            stack = torch.stack([P[i][n].float() for i in range(M)])
            mixed = torch.einsum("ij,i...->j...", Af.to(stack.device), stack)
            for j in range(M):
                new[j][n] = (mixed[j] + upd[j][n].float()).to(dtype)
            del stack, mixed
        P = new
    change = {n: math.sqrt(sum(float(torch.sum((P[j][n].float() - W[n].float()) ** 2))
                               for j in range(M))) for n in W}
    return losses, g1, change


def norms(trees: list[dict[str, torch.Tensor]]) -> dict[str, float]:
    """Norm of each named tensor over a list of replicas, in float32."""
    out = {}
    for n in trees[0]:
        out[n] = math.sqrt(sum(float(torch.sum(t[n].float() ** 2)) for t in trees))
    return out
