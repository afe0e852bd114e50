"""AdamW (decoupled weight decay) on nested dicts of float32 tensors, in the
reference's arithmetic.

`torch.optim.AdamW` computes another function: it adds eps after dividing
sqrt(v) by sqrt(1 - b2^t), and decays p before the step.  Here the update
is p - lr * (mhat / (sqrt(vhat) + eps) + wd * p), with the bias
corrections 1 - b^t in float32, and the global norm sums the leaves in the
reference's order (`jax.tree.flatten`: sorted keys, depth first).
Parameter trees are plain dicts; a leaf is a tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """AdamW's constants (the reference's defaults)."""
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 1e-3      # paper's detector training setting
    grad_clip: float = 1.0


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves of a nested dict, sorted keys, depth first."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree: Tree, leaves) -> Tree:
    """`tree`'s structure with its leaves, in flatten order, taken from the
    iterable `leaves`."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(tree)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """`fn` over the leaves of `tree` and the same leaves of `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def adamw_init(params: Tree) -> Dict[str, Any]:
    """Zero moments in float32 and step 0 (an int32 scalar on the params'
    device)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in flatten order) of each leaf's sum of
    squares."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale every leaf by min(1, max_norm / max(norm, 1e-9)); returns the
    scaled tree and the norm before scaling."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(grads: Tree, state: Dict[str, Any], params: Tree,
                 lr: torch.Tensor, cfg: AdamWConfig = AdamWConfig()
                 ) -> Tuple[Tree, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, {"grad_norm"}).  Every leaf
    of `params` is updated, those with a zero gradient by the decay
    alone."""
    if cfg.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    step = state["step"] + 1
    t = step.float()
    c1 = 1.0 - torch.pow(t.new_tensor(cfg.b1), t)
    c2 = 1.0 - torch.pow(t.new_tensor(cfg.b2), t)

    def upd(g, m, v, p):
        g32 = g.float()
        m_new = cfg.b1 * m + (1 - cfg.b1) * g32
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        p32 = p.float()
        p_new = p32 - lr * (delta + cfg.weight_decay * p32)
        return p_new.to(p.dtype), m_new, v_new

    out = tree_map(upd, grads, state["m"], state["v"], params)
    return (_pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2),
                            "step": step}, {"grad_norm": gnorm})


def _pick(tree: Tree, i: int) -> Tree:
    """The i-th element of every tuple leaf."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
