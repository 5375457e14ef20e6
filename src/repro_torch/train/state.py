"""Train state: {"params", "opt", "step"[, "ef"]}, the reference's layout.

The parameters are fp32 masters (``cfg.param_dtype``) that require grad;
the forward casts them to the compute type. With ``grad_compress`` the
state also holds ``"ef"``, the error-feedback residuals (fp32 zeros shaped
like the params). One device, no sharding.
"""
from __future__ import annotations

from repro_torch.models.common import tree_map
from repro_torch.optim import adamw_init, ef_init


def init_state(model, seed: int = 0, params=None, *,
               grad_compress: bool = False) -> dict:
    """Fresh state from ``model.init(seed)`` in the param type, or from a
    copy of ``params`` (a tree of tensors) when given."""
    if params is None:
        params = model.init(seed, dtype=model.cfg.param_dtype)
    else:
        params = tree_map(lambda t: t.detach().to(model.device).clone(),
                          params)
    params = tree_map(lambda t: t.requires_grad_(True), params)
    state = {"params": params, "opt": adamw_init(params), "step": 0}
    if grad_compress:
        state["ef"] = ef_init(params)
    return state
