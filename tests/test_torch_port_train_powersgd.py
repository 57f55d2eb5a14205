"""The port's powerSGD epochs against the JAX package's: the powerSGD cases
of ``test_torch_port_train.py`` (its helpers and tolerances), in a file of
their own so that ``pytest --dist loadfile`` can run them on another worker
than the dSGD, fused and rankDAD cases.

These cases hold the engine, not the LSTM kernel: JAX's epochs run its
LSTM's plain reference (``use_pallas=False``), as the JAX package's own
engine tests do, but for ``PALLAS_CASES``; the LSTM kernel's parity is held
by the dSGD and fused cases, by ``test_torch_port_icalstm.py`` and
``test_torch_port_lstm_bwd.py``.
"""

import pytest
import torch
from test_torch_port_train import POWERSGD_CASES, _check_epochs

# one intra-op thread: the suite runs in several worker processes on a few
# cores, and oversubscribed torch thread pools slow a CPU fit tens of times
torch.set_num_threads(1)

# the one case that keeps JAX's Pallas LSTM: with the bf16 wire, a payload
# value that straddles a bf16 rounding boundary moves powerSGD's subspace,
# so its later losses follow the last bits of the LSTM's gradients, and
# LOSS_TOL was set against JAX's kernel path (on JAX's plain LSTM the last
# epoch's losses part by 1.3e-3)
PALLAS_CASES = ("powerSGD-bf16",)


@pytest.mark.parametrize("case", list(POWERSGD_CASES))
def test_epochs_match_jax(case):
    _check_epochs(POWERSGD_CASES[case], use_pallas=case in PALLAS_CASES)
