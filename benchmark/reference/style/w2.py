"""The W2 style term (crowsonkb ``StyleLossW2``), float64: the squared
distance of the tap's mean from the target's, over C, plus
(tr C_t + tr C - 2 tr (C_t^1/2 C C_t^1/2)^1/2) / C.

The target's square root is exact (``eigh``, |eigenvalue|). The square root
inside the term is the configuration's: the coupled Newton-Schulz chain of
``sqrtm_iters`` iterations on the Frobenius-normalized matrix, whose trace's
gradient is taken as ``Z / 2`` (``w2_grad: trace``). Twelve iterations are
2-8% short of the exact root at VGG's covariances, so an exact root would
not be the configuration.

``mm`` is the product of the statistics (plain, or rounded for a control:
``lowp.make_mm``).
"""

import torch


def _cov(mean, srm, eps):
    return srm - torch.outer(mean, mean) + eps * torch.eye(len(mean), dtype=mean.dtype,
                                                           device=mean.device)


def _sqrt_eigh(a):
    vals, vecs = torch.linalg.eigh(a)
    return (vecs * torch.sqrt(torch.abs(vals))) @ vecs.T


class TraceSqrtNS(torch.autograd.Function):
    """tr(A^1/2) by the coupled Newton-Schulz chain; gradient Z / 2."""

    @staticmethod
    def forward(ctx, a, iters, mm=torch.matmul):
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        norm = torch.linalg.matrix_norm(a)
        y, z = a / norm, eye
        for _ in range(iters):
            t = (3.0 * eye - mm(z, y)) / 2.0
            y, z = mm(y, t), mm(t, z)
        ctx.save_for_backward(z / torch.sqrt(norm))
        return torch.trace(y) * torch.sqrt(norm)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        return g * z / 2.0, None, None


def target(mean, srm, cfg):
    """The style image's (mean, covariance, covariance^1/2) at a tap."""
    cov = _cov(mean, srm, cfg["w2_eps"])
    return mean, cov, _sqrt_eigh(cov)


def term(mean, srm, tgt, cfg, mm=torch.matmul):
    cov = _cov(mean, srm, cfg["w2_eps"])
    t_mean, t_cov, t_sqrt = tgt
    tr_sqrt = TraceSqrtNS.apply(mm(mm(t_sqrt, cov), t_sqrt), cfg["sqrtm_iters"], mm)
    return (torch.mean((mean - t_mean) ** 2)
            + (torch.trace(t_cov) + torch.trace(cov) - 2.0 * tr_sqrt) / len(mean))


def flops(cfg):
    """Model FLOPs an iteration past the moments: the Newton-Schulz chains
    and the products C_t^1/2 C C_t^1/2 with their backward
    (``benchmark.counts``)."""
    from benchmark import counts

    return counts.ns_flops(cfg) + counts.w2_product_flops(cfg)
