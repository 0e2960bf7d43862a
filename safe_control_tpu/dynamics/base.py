"""Model interface shared by all dynamics modules.

Every model module in this package exposes the same pure-function surface
(the JAX analog of the reference's model-class interface, SURVEY.md §2.1):

- ``N_STATES``, ``N_CONTROLS``: static dims
- ``REL_DEG``: barrier relative degree (1 or 2)
- ``f(x, spec) -> (n,)``: continuous-time drift
- ``g(x, spec) -> (n, m)``: control matrix
- ``step(x, u, spec, dt) -> (n,)``: Euler (or RK4) integration incl. the
  model's state clamps (the reference's ``step`` side effects)
- ``nominal_input(x, goal, spec) -> (m,)``: PD waypoint-tracking law
- ``stop(x, spec) -> (m,)``: decelerate-to-rest input
- ``has_stopped(x, spec) -> bool scalar``
- ``rotate_to(x, theta_des, spec) -> (m,)``: in-place rotation input
- ``u_lb(spec) / u_ub(spec) -> (m,)``: input box for the QP/MPC solvers
- ``state_bounds(spec) -> (lb, ub) each (n,)``: state box (±inf where free)
- ``barrier_pos(x) -> (2,)``: the position the obstacle barrier acts on

States and controls are flat 1-D arrays; batching is done with ``vmap`` at
call sites, never inside the model.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict

import jax.numpy as jnp

from safe_control_tpu.core.types import angle_normalize  # re-export for models

__all__ = [
    "angle_normalize", "masked_apply", "register", "get_model",
    "MODEL_REGISTRY",
]

MODEL_REGISTRY: Dict[str, ModuleType] = {}


def register(name: str, module: ModuleType) -> None:
    MODEL_REGISTRY[name] = module


def get_model(name: str) -> ModuleType:
    try:
        return MODEL_REGISTRY[name]
    except KeyError as exc:
        raise ValueError(
            f"Unknown model '{name}'. Registered: {sorted(MODEL_REGISTRY)}"
        ) from exc


def euler(x, dx, dt):
    return x + dx * dt


def masked_apply(x, fn, lo: int, hi: int):
    """Apply an elementwise ``fn`` to ``x[lo:hi]`` as a branch-free select.

    Equivalent to ``x.at[lo:hi].set(fn(x)[lo:hi])`` but lowers to an
    iota-mask ``where`` (elementwise, fusible) instead of a scatter.  The
    mask is built from a COMPUTED iota, not a constant array (inside a
    ``lax.scan`` body a constant would become a hidden sub-jaxpr const).
    ``fn`` must be safe to evaluate on the whole vector (only the masked
    lanes are kept).
    """
    import jax as _jax

    n = x.shape[0]
    idx = _jax.lax.squeeze(
        _jax.lax.broadcasted_iota(jnp.int32, (1, n), 1), (0,)
    )
    return jnp.where((idx >= lo) & (idx < hi), fn(x), x)


def free_bounds(n: int):
    inf = jnp.inf
    return jnp.full((n,), -inf), jnp.full((n,), inf)
