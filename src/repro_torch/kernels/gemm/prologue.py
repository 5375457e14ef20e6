"""Declarative load-side prologues for the fused GEMM.

The port of the reference's :class:`Prologue` spec: a per-row normalisation
(rmsnorm / layernorm) applied to A in fp32 and rounded back to the input
type before the product, so the normed activation never has to be written
by a standalone norm pass. :meth:`Prologue.apply` is the plain torch
version, with the same math as ``models.common.rmsnorm`` / ``layernorm``;
:meth:`Prologue.transpose` is its backward, row-local, for both statistics
paths.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NORMS = ("none", "rmsnorm", "layernorm")

# eps defaults of models/common.{rmsnorm,layernorm}
_DEFAULT_EPS = {"rmsnorm": 1e-6, "layernorm": 1e-5}


@dataclasses.dataclass(frozen=True)
class Prologue:
    """A frozen, hashable A-operand prologue spec."""

    norm: str = "none"               # 'none' | 'rmsnorm' | 'layernorm'
    beta: bool = False               # layernorm bias row present
    precomputed_stats: bool = False  # caller streams (M, 1) stats
    eps: Optional[float] = None      # resolved per norm kind when None

    def __post_init__(self):
        if self.norm not in NORMS:
            raise ValueError(f"unknown norm {self.norm!r}; have {NORMS}")
        if self.norm == "none":
            if self.beta or self.precomputed_stats or self.eps is not None:
                raise ValueError("beta/precomputed_stats/eps are only "
                                 "meaningful with a norm")
        else:
            if self.beta and self.norm != "layernorm":
                raise ValueError("beta (bias row) only applies to layernorm")
            if self.eps is None:
                object.__setattr__(self, "eps", _DEFAULT_EPS[self.norm])

    @property
    def is_identity(self) -> bool:
        return self.norm == "none"

    def operand_names(self) -> tuple:
        names = []
        if self.norm != "none":
            names.append("gamma")
            if self.beta:
                names.append("beta")
            if self.precomputed_stats:
                if self.norm == "layernorm":
                    names.append("mean")
                names.append("rstd")
        return tuple(names)

    def compute_stats(self, x) -> dict:
        """(rows, 1) fp32 row statistics of ``x``."""
        if self.norm == "none":
            return {}
        xf = x.float()
        if self.norm == "rmsnorm":
            var = torch.mean(xf * xf, dim=-1, keepdim=True)
            return {"rstd": torch.rsqrt(var + self.eps)}
        mean = torch.mean(xf, dim=-1, keepdim=True)
        c = xf - mean
        var = torch.mean(c * c, dim=-1, keepdim=True)
        return {"mean": mean, "rstd": torch.rsqrt(var + self.eps)}

    def apply(self, x, *, gamma=None, beta=None, mean=None, rstd=None):
        """Normalise an fp32 array row-wise (stats over the last axis unless
        given). All operands fp32 and broadcastable."""
        if self.norm == "none":
            return x
        if self.norm == "rmsnorm":
            if rstd is None:
                var = torch.mean(x * x, dim=-1, keepdim=True)
                rstd = torch.rsqrt(var + self.eps)
            return x * rstd * gamma
        if mean is None:
            mean = torch.mean(x, dim=-1, keepdim=True)
        c = x - mean
        if rstd is None:
            var = torch.mean(c * c, dim=-1, keepdim=True)
            rstd = torch.rsqrt(var + self.eps)
        out = c * rstd * gamma
        if self.beta:
            out = out + beta
        return out

    def transpose(self, d_an, a, *, gamma=None, beta=None, mean=None,
                  rstd=None) -> dict:
        """The cotangent of the normed A with respect to the raw A and the
        norm parameters, row by row, on fp32 arrays.

        ``d_an`` (rows, K) is the cotangent of the normed activation (what
        the dA GEMM accumulates); ``a`` the raw A rows. Recompute path: the
        statistics are re-derived from ``a`` and their own dependence on A
        is transposed too, so rows must be whole. Precomputed path: the
        given ``mean``/``rstd`` are operands with cotangents of their own.
        Returns {'da'} plus, per spec, 'dgamma'/'dbeta' (1, K) sums over the
        rows and 'dmean'/'drstd' (rows, 1)."""
        if self.norm == "none":
            return {"da": d_an}
        out = {}
        if self.precomputed_stats:
            if self.norm == "rmsnorm":
                dahat = d_an * gamma
                out["da"] = dahat * rstd
                out["dgamma"] = torch.sum(d_an * a * rstd, dim=0, keepdim=True)
                out["drstd"] = torch.sum(dahat * a, dim=-1, keepdim=True)
                return out
            c = a - mean
            dahat = d_an * gamma
            out["da"] = dahat * rstd
            out["dgamma"] = torch.sum(d_an * c * rstd, dim=0, keepdim=True)
            if self.beta:
                out["dbeta"] = torch.sum(d_an, dim=0, keepdim=True)
            out["dmean"] = -torch.sum(dahat * rstd, dim=-1, keepdim=True)
            out["drstd"] = torch.sum(dahat * c, dim=-1, keepdim=True)
            return out
        if self.norm == "rmsnorm":
            var = torch.mean(a * a, dim=-1, keepdim=True)
            rstd = torch.rsqrt(var + self.eps)
            ahat = a * rstd
            dahat = d_an * gamma
            cterm = torch.mean(dahat * ahat, dim=-1, keepdim=True)
            out["da"] = rstd * (dahat - ahat * cterm)
            out["dgamma"] = torch.sum(d_an * ahat, dim=0, keepdim=True)
            return out
        mean = torch.mean(a, dim=-1, keepdim=True)
        c = a - mean
        var = torch.mean(c * c, dim=-1, keepdim=True)
        rstd = torch.rsqrt(var + self.eps)
        chat = c * rstd
        dchat = d_an * gamma
        out["da"] = rstd * (dchat - torch.mean(dchat, dim=-1, keepdim=True)
                            - chat * torch.mean(dchat * chat, dim=-1,
                                                keepdim=True))
        out["dgamma"] = torch.sum(d_an * chat, dim=0, keepdim=True)
        if self.beta:
            out["dbeta"] = torch.sum(d_an, dim=0, keepdim=True)
        return out

    def grad_names(self) -> tuple:
        """The transpose's extra outputs, matching operand_names():
        'dgamma'[, 'dbeta'][, 'dmean', 'drstd']."""
        return tuple("d" + n for n in self.operand_names())

    def describe(self) -> str:
        if self.is_identity:
            return "none"
        tag = self.norm
        if self.beta:
            tag += "+beta"
        if self.precomputed_stats:
            tag += "@rstd"
        return tag


PROLOGUE_NONE = Prologue()


def norm_prologue(kind: str, *, beta: bool = False) -> Prologue:
    """The prologue matching a config's ``norm`` field."""
    return Prologue(norm=kind, beta=beta)
