"""``chip_smoke.py``'s phase 23 alone, the supervisor and the pod plane at
full width on the card: builds the kernels, then runs
``chip_smoke.pod_phase`` under a temporary directory (it makes a tree of
phase 21's shape and phase 14's FS tree there). Needs one CUDA card.

    python3 scripts/torch_pod_phase.py
"""

import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dinunet_implementations_tpu_torch.core.device import resolve_device  # noqa: E402
from dinunet_implementations_tpu_torch.ops import _build  # noqa: E402
from dinunet_implementations_tpu_torch.ops import bilstm_cuda as bc  # noqa: E402
from dinunet_implementations_tpu_torch.ops import lstm_cuda as lc  # noqa: E402
from dinunet_implementations_tpu_torch.ops import poweriter_cuda as pc  # noqa: E402


def main() -> int:
    resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.time()
    _build.build_all()
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="pod_") as root:
        rec = cs.pod_phase(torch, np, lc, pc, bc, smi, root)
    print(f"phase 23 passed in {rec['seconds']:.1f} s on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
