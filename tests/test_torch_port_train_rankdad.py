"""The port's rankDAD epochs against the JAX package's: the rankDAD cases
of ``test_torch_port_train.py`` (its helpers, tolerances and the
measurement behind ``DAD_AGG_SHARE``), in a file of their own so that
``pytest --dist loadfile`` can run them on another worker than the dSGD,
fused and powerSGD cases.

These cases hold the engine, not the LSTM kernel: JAX's epochs run its
LSTM's plain reference (``use_pallas=False``), as the JAX package's own
engine tests do; the LSTM kernel's parity is held by the dSGD and fused
cases, by ``test_torch_port_icalstm.py`` and ``test_torch_port_lstm_bwd.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train import (
    B,
    DAD,
    DAD_AGG_SHARE,
    HID,
    ICA,
    IN,
    RANKDAD_CASES,
    S,
    C,
    T,
    W,
    _check_epochs,
    _compare_at_share,
    _jax_setup,
    _sites,
)

from dinunet_implementations_tpu.data import api as jdata
from dinunet_implementations_tpu.data import batching as jbatching
from dinunet_implementations_tpu.engines import make_engine
from dinunet_implementations_tpu.models import icalstm as jm
from dinunet_implementations_tpu.trainer import steps as jsteps
from dinunet_implementations_tpu_torch.engines import make_rankdad
from dinunet_implementations_tpu_torch.weights import (
    leaf_table,
    params_from_jax,
    train_state_from_jax,
    train_state_to_jax,
)

# one intra-op thread: the suite runs in several worker processes on a few
# cores, and oversubscribed torch thread pools slow a CPU fit tens of times
torch.set_num_threads(1)


@pytest.mark.parametrize("case", list(RANKDAD_CASES))
def test_epochs_match_jax(case):
    _check_epochs(RANKDAD_CASES[case], use_pallas=False)


@pytest.mark.parametrize("pb", ["32", "16"])
def test_rankdad_engine_on_jax_gradients_is_inside_jax_spread(pb):
    """The measurement behind ``DAD_AGG_SHARE``: the first round's per-site
    gradients of the JAX model go through JAX's two power-iteration paths
    and through the port's engine; both JAX paths and the port stay within
    the share of each other, leaf by leaf."""
    from dinunet_implementations_tpu.parallel.mesh import SITE_AXIS

    sites = _sites()
    inv = jdata.stack_site_inventory(sites)
    plan = jbatching.plan_epoch_positions(sites, B, seed=0).positions[:, :1]
    state_j, _ = _jax_setup(pb, 1, 3, "rankDAD", False, False)
    task = jsteps.FederatedTask(jm.ICALstm(input_size=IN, hidden_size=HID, num_comps=C,
                                           window_size=W, num_cls=2, use_pallas=False,
                                           dropout_rate=0.0))
    task.init_variables(jax.random.PRNGKey(0), jnp.zeros((2, T, C, W)))
    xb, yb, wb = jax.vmap(jsteps._gather_batch, in_axes=(0, 0, 0, None))(
        jnp.asarray(inv.inputs), jnp.asarray(inv.labels), jnp.asarray(plan), None)

    def loss(p, x, y, w):
        logits, _ = task.apply(p, state_j.batch_stats, x, train=True, mask=w, mutable=True)
        return jsteps.cross_entropy(logits, y, w)

    grads = jax.vmap(jax.grad(loss), in_axes=(None, 0, 0, 0))(
        state_j.params, xb[:, 0], yb[:, 0], wb[:, 0])
    n = wb[:, 0].sum(1)
    stats = jax.tree.map(np.asarray, state_j.batch_stats)

    def jax_agg(fused):
        eng = make_engine("rankDAD", precision_bits=pb, fused_poweriter=fused, **DAD)
        agg, _ = jax.vmap(lambda g, st, w: eng.aggregate(g, st, w, SITE_AXIS, live=jnp.float32(1)),
                          axis_name=SITE_AXIS)(grads, state_j.engine_state, n)
        return jax.tree.map(lambda a: np.asarray(a[0]), agg)

    legacy, fused = jax_agg(False), jax_agg(True)
    state_t = train_state_from_jax(jax.tree.map(np.asarray, state_j), device="cpu")
    per_site = [params_from_jax(ICA, jax.tree.map(lambda a, s=s: np.asarray(a[s]), grads), stats)
                for s in range(S)]
    grads_t = {k: torch.stack([g[k] for g in per_site]) for k in state_t.params}
    engine = make_rankdad(precision_bits=pb, transposed=leaf_table(ICA).transposed, **DAD)
    agg_t, _ = engine.aggregate(grads_t, state_t.engine_state, torch.from_numpy(np.array(n)))
    port = train_state_to_jax(dataclasses.replace(state_t, params=agg_t))["params"]
    _compare_at_share(fused, legacy, DAD_AGG_SHARE[pb])
    _compare_at_share(port, legacy, DAD_AGG_SHARE[pb])
