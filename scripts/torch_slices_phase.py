"""``chip_smoke.py``'s phase 25 alone, the slice tier over processes at
full width on the card: builds the kernels, makes a tree of phase 21's
shape, runs phase 24 (c)'s two unsliced gloo ranks for the checksum the
fused form is held to, then ``chip_smoke.slices_phase``. Needs one CUDA
card.

    python3 scripts/torch_slices_phase.py
"""

import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dinunet_implementations_tpu_torch.core.device import resolve_device  # noqa: E402
from dinunet_implementations_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.time()
    _build.build_all()
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="slices_") as root:
        tree = cs.daemon_tree(os.path.join(root, "live_tree"))
        t1 = time.monotonic()
        gloo = cs.mesh_gloo_two(torch, smi, tree, root)
        t2 = time.monotonic()
        cs.slices_phase(torch, smi, root, tree, gloo["ranks"][0]["params_sha256"])
        t3 = time.monotonic()
    print(f"phase 24 (c) {t2 - t1:.1f} s, phase 25 passed in {t3 - t2:.1f} s on {smi}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
