"""Weight bridge: the JAX package's ICA-LSTM variables as the port's
``state_dict``.

The input is the pair of nested dicts that the JAX model carries, with
numpy arrays (or anything ``numpy.asarray`` takes) as leaves. Flax kernels
are ``[in, out]`` and ``nn.Linear`` weights ``[out, in]``; the LSTM cells
keep the JAX layout and combine ``b_ih + b_hh`` as the JAX ``LSTMCell``
does. A tree with a missing or an extra leaf is rejected.
"""

from __future__ import annotations

import numpy as np
import torch

_DENSE = ("encoder", "cls_fc1", "cls_fc2", "cls_fc3")
_CELL = ("w_ih", "b_ih", "w_hh", "b_hh")


def _leaves(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def _expected(bidirectional: bool) -> tuple[set, set]:
    dirs = ("fwd", "rev") if bidirectional else ("fwd",)
    params = {f"{n}/{leaf}" for n in _DENSE for leaf in ("kernel", "bias")}
    params |= {f"lstm/{d}/{leaf}" for d in dirs for leaf in _CELL}
    params |= {"cls_bn/scale", "cls_bn/bias"}
    return params, {"cls_bn/mean", "cls_bn/var"}


def icalstm_params_from_jax(params, batch_stats, bidirectional: bool = True) -> dict:
    """``(params, batch_stats)`` of the JAX ``ICALstm`` → the port
    :class:`~.models.icalstm.ICALstm`'s ``state_dict`` (f32 CPU tensors)."""
    p, s = _leaves(params), _leaves(batch_stats)
    want_p, want_s = _expected(bidirectional)
    problems = []
    for what, have, want in (("params", p, want_p), ("batch_stats", s, want_s)):
        if set(have) - want:
            problems.append(f"{what} has extra leaves {sorted(set(have) - want)}")
        if want - set(have):
            problems.append(f"{what} is missing leaves {sorted(want - set(have))}")
    if problems:
        raise ValueError("not an ICALstm variable tree: " + "; ".join(problems))

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {}
    for n in _DENSE:
        sd[f"{n}.weight"] = t(p[f"{n}/kernel"].T)
        sd[f"{n}.bias"] = t(p[f"{n}/bias"])
    for d in ("fwd", "rev") if bidirectional else ("fwd",):
        q = f"lstm/{d}/"
        sd[f"lstm.{d}.w_ih"] = t(p[q + "w_ih"])
        sd[f"lstm.{d}.w_hh"] = t(p[q + "w_hh"])
        # summed in f32, as icalstm.py's b_ih + b_hh
        sd[f"lstm.{d}.b"] = t(p[q + "b_ih"]) + t(p[q + "b_hh"])
    sd["cls_bn.weight"] = t(p["cls_bn/scale"])
    sd["cls_bn.bias"] = t(p["cls_bn/bias"])
    sd["cls_bn.running_mean"] = t(s["cls_bn/mean"])
    sd["cls_bn.running_var"] = t(s["cls_bn/var"])
    return sd
