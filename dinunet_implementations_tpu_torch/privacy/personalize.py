"""Personalized per-site heads: a partition of the parameters, the port of
the JAX package's ``privacy/personalize.py``.

``TrainConfig.personalize`` names head leaves by path substrings (e.g.
``("fc_out",)`` for MSANNet's classifier, ``("cls_fc3",)`` for the
ICA-LSTM's). A leaf is a head leaf when its "/"-joined JAX path (the
model's ``weights.LeafTable``, e.g. ``cls_fc3/kernel``) contains a pattern,
so a pattern picks the same leaves as in JAX whatever the port's
``state_dict`` name. Head leaves stay out of the aggregation entirely:

- ``TrainState.params`` keeps every leaf, but the head leaves freeze at
  their first value: the optimizer's aggregate carries exact zeros there
  (:func:`graft_shared`), so Adam's moments stay zero;
- each site's own head lives in ``TrainState.personal``: ``{"params":
  {name: [S, ...]}, "opt": the per-site optimizer state}`` (Adam's
  ``count`` is a ``[S]`` vector, since a dead site's row does not
  advance);
- the site forward runs on the site's own head, and the head gradient
  updates the site's row with the fit's optimizer, gated on the round's
  contribute mask (a dead site's head freezes);
- the engine aggregates the shared leaves only (:func:`strip_tree`);
- eval runs each site on its own head.

The trees here are the port's flat dicts keyed by ``state_dict`` name; a
"path" is the set of those names.
"""

from __future__ import annotations

import torch


def head_leaf_paths(params, patterns, table=None) -> frozenset:
    """The partition: the ``state_dict`` names of ``params`` whose JAX path
    (``table``, by default the params' own, ``weights.table_of``) contains
    any of ``patterns``. JAX's ``ValueError`` for a mask that matches
    nothing and for one that matches every leaf."""
    patterns = tuple(p for p in patterns if p)
    if not patterns:
        return frozenset()
    if table is None:
        from ..weights import table_of

        table = table_of(params)
    paths = {n: j for n, j, _ in table.params if n in params}
    hit = frozenset(n for n, j in paths.items() if any(pat in j for pat in patterns))
    if not hit:
        raise ValueError(f"personalize patterns {patterns} match no parameter leaf "
                         f"(have e.g. {sorted(paths.values())[:6]})")
    if len(hit) == len(paths):
        raise ValueError(f"personalize patterns {patterns} match EVERY parameter leaf — "
                         "nothing would be federated")
    return hit


def shared_leaf_index(table, head: frozenset) -> dict:
    """Each shared leaf's index among the SHARED leaves in JAX's
    ``jax.tree.flatten`` order: what JAX's engine keys a leaf by when it
    sees the shared subtree (powerSGD's first Q, the secure-aggregation
    pads)."""
    order = sorted((i, n) for n, i in table.leaf_index.items() if n not in head)
    return {n: k for k, (_, n) in enumerate(order)}


def strip_tree(tree: dict, paths: frozenset, keep_head: bool) -> dict:
    """The head leaves (``keep_head=True``) or the shared leaves
    (``keep_head=False``) of a params-keyed dict."""
    return {k: v for k, v in tree.items() if (k in paths) == keep_head}


def merge_head(full_tree: dict, head_subtree: dict) -> dict:
    """``full_tree`` with the head leaves of ``head_subtree`` swapped in."""
    return {**full_tree, **head_subtree}


def zero_head(full_tree: dict, paths: frozenset) -> dict:
    """``full_tree`` with its head leaves replaced by zeros: the form of
    the optimizer's aggregate, so the global head never moves."""
    return {k: torch.zeros_like(v) if k in paths else v for k, v in full_tree.items()}


def graft_shared(full_template: dict, shared_subtree: dict, paths: frozenset) -> dict:
    """A full tree from the engine's aggregate of the shared leaves: the
    shared leaves from ``shared_subtree`` (cast to the template's dtype),
    the head leaves zero, in the template's order."""
    return {k: torch.zeros_like(v) if k in paths else shared_subtree[k].to(v.dtype)
            for k, v in full_template.items()}


def personal_row_template(params: dict, paths: frozenset, optimizer) -> dict:
    """One site's fresh personal state: the head leaves of the global params
    (every site starts from the common model) and a fresh optimizer state
    over them."""
    head = strip_tree(params, paths, keep_head=True)
    return {"params": head, "opt": optimizer.init(head) if head else {}}


def _stack(tree, num_sites: int):
    if isinstance(tree, dict):
        return {k: _stack(v, num_sites) for k, v in tree.items()}
    return tree.unsqueeze(0).repeat(num_sites, *([1] * tree.dim())).contiguous()


def default_personal(num_sites: int, params: dict, paths: frozenset, optimizer) -> dict:
    """A fresh ``TrainState.personal``: :func:`personal_row_template` with
    every leaf stacked to ``[num_sites, ...]`` (Adam's ``count`` becomes a
    ``[num_sites]`` vector)."""
    return _stack(personal_row_template(params, paths, optimizer), num_sites)
